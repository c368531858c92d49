"""Cochain projector Pi: coarse <- fine, with Pi P = I.

Rebuild of reference src/amge/CochainProjector.{hpp,cpp}: per coarse entity a
"dof linear functional" F = (L^T M L)^{-1} (M L)^T where L is the local coarse
basis restricted to the entity's interior fine dofs and M the interior local
mass (CochainProjector.hpp:91-96, CochainProjector.cpp:53-145). The assembled
sparse projector follows the telescoping recursion

    Pi_{codim_base} = hat(Pi)_{codim_base}
    Pi_{codim-1}    = Pi_codim + hat(Pi)_{codim-1} (I - P Pi_codim)

(CochainProjector::ComputeProjector, CochainProjector.cpp:218-316).
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.ops import csr as C


class CochainProjector:
    def __init__(self, cdof, dofagg):
        self.cdof = cdof          # DofHandlerALG of the coarse level
        self.dofagg = dofagg      # fine DofAgglomeration of the form
        self.functionals = {}     # (codim, ient) -> (ncoarse_int x nfine_int)
        # codim -> list of (entity idxs, stacked F (m, nc, nf)) from the
        # group-level setup path; per-entity dict entries override these
        # (enrichment/repair re-creates individual functionals)
        self.grouped = {}
        self.matrix = None

    def add_functionals_group(self, codim, idxs, Lst, M_iist):
        """Group-level functional creation: Lst (m, nf, nc) coarse basis
        columns on interior fine dofs, M_iist (m, nf, nf) interior mass.
        One stacked LAPACK solve for the whole group."""
        idxs = np.asarray(idxs, dtype=np.int64)
        if Lst.shape[2] == 0 or idxs.size == 0:
            return
        ML = M_iist @ Lst
        G = np.einsum("bij,bik->bjk", Lst, ML)
        F = np.linalg.solve(G, ML.transpose(0, 2, 1))
        assert np.all(np.isfinite(F)), \
            f"singular local Gram matrix at codim {codim}"
        self.grouped.setdefault(codim, []).append((idxs, F))

    def create_dof_functional(self, codim, ient, local_projector, M_ii):
        """local_projector: (nfine_int x ncoarse_int) coarse basis columns on
        the entity's interior fine dofs; M_ii: interior local mass."""
        L = np.asarray(local_projector)
        if L.shape[1] == 0:
            self.functionals[(codim, ient)] = np.zeros((0, L.shape[0]))
            return
        ML = M_ii @ L
        G = L.T @ ML
        F = np.linalg.solve(G, ML.T)
        assert np.all(np.isfinite(F)), \
            f"singular local Gram matrix at codim {codim} entity {ient}"
        self.functionals[(codim, ient)] = F

    def create_dof_functionals(self, codim, Ls, M_iis):
        """Batch variant over ALL entities of a codim: one stacked LAPACK
        solve per shape group instead of one Python solve per entity."""
        groups = {}
        for i, L in enumerate(Ls):
            if L.shape[1] == 0:
                self.functionals[(codim, i)] = np.zeros((0, L.shape[0]))
                continue
            groups.setdefault(L.shape, []).append(i)
        for shape, idxs in groups.items():
            Lst = np.stack([Ls[i] for i in idxs])
            Mst = np.stack([M_iis[i] for i in idxs])
            ML = Mst @ Lst
            G = np.einsum("bij,bik->bjk", Lst, ML)
            F = np.linalg.solve(G, ML.transpose(0, 2, 1))
            assert np.all(np.isfinite(F)), \
                f"singular local Gram matrix at codim {codim}"
            for j, i in enumerate(idxs):
                self.functionals[(codim, i)] = F[j]

    # ------------------------------------------------------------------ #
    def _hat_pi(self, codim, nfine) -> sp.csr_matrix:
        from parelag_tpu_torch.ops import ragged as R
        b = C.coo_builder()
        n_ent = self.cdof.topo.num_entities(codim)
        override = np.zeros(n_ent, dtype=bool)
        for (cd, ient) in self.functionals:
            if cd == codim:
                override[ient] = True

        # group-level entries (uniform shapes): fully vectorized scatter
        o = self.cdof.interior_offsets.get(codim)
        u_cat, u_off = self.dofagg.ae_dofs_cat(codim)
        for idxs, Fst in self.grouped.get(codim, []):
            keep = ~override[idxs]
            ii = idxs[keep]
            if ii.size == 0:
                continue
            m, nc, nf = len(ii), Fst.shape[1], Fst.shape[2]
            rows = (o[ii][:, None]
                    + np.arange(nc, dtype=np.int64)).ravel()
            cols = u_cat[u_off[ii][:, None]
                         + np.arange(nf, dtype=np.int64)].ravel()
            b.add_blocks_var(
                rows, np.arange(m + 1, dtype=np.int64) * nc,
                cols, np.arange(m + 1, dtype=np.int64) * nf,
                Fst.ravel() if keep.all() else Fst[keep].ravel())
        # per-entity entries (0-form picks, enrichment overrides)
        rows_l, cols_l, vals_l = [], [], []
        for ient in np.nonzero(override)[0]:
            F = self.functionals.get((codim, int(ient)))
            if F is None or F.shape[0] == 0:
                continue
            rows_l.append(self.cdof.interior_dofs(codim, int(ient)))
            cols_l.append(self.dofagg.interior_dofs(codim, int(ient)))
            vals_l.append(F.reshape(-1))
        if rows_l:
            rcat, roff = R.lists_to_cat(rows_l)
            ccat, coff = R.lists_to_cat(cols_l)
            b.add_blocks_var(rcat, roff, ccat, coff,
                             np.concatenate(vals_l))
        return b.tocsr((self.cdof.ndofs, nfine))

    def compute_projector(self, P: sp.csr_matrix):
        nfine = P.shape[0]
        max_codim = self.cdof.max_codim
        Pi = self._hat_pi(max_codim, nfine)
        for codim in range(max_codim - 1, -1, -1):
            hat = self._hat_pi(codim, nfine)
            # Pi + hat (I - P Pi) regrouped as Pi + hat - (hat P) Pi: the
            # intermediate hat@P is (ncoarse x ncoarse) instead of the
            # (nfine x nfine) product P@Pi — at ~10^6 fine dofs the
            # nfine-sized SpGEMM + identity subtraction dominated setup
            Pi = (Pi + hat - (hat @ P) @ Pi).tocsr()
        self.matrix = Pi
        return Pi

    def project(self, v) -> np.ndarray:
        """Project fine (ndofs, k) multivector to coarse."""
        v = np.asarray(v)
        if self.matrix is None:
            raise RuntimeError("call compute_projector first")
        return self.matrix @ v
