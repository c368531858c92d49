"""Dof agglomeration: closure dofs of agglomerated entities, interior first.

Rebuild of reference src/amge/DOFAgglomeration.{hpp,cpp}: for one form and
every codim, the fine dofs contained in each agglomerated entity's closure,
ordered so that interior dofs come first (making interior extraction a
contiguous range — DOFAgglomeration.hpp:27-36). A dof's separator type is the
highest codim of agglomerated entity whose closure contains it
(DOFAgglomeration.cpp:70-85); a dof is interior to a codim-c agglomerate iff
its separator type equals c.
"""

import numpy as np

from parelag_tpu_torch.ops import csr as C


class DofAgglomeration:
    def __init__(self, topo, dof_handler):
        """topo: fine AgglomeratedTopology with AEntity_entity built
        (i.e. coarsen_local_partitioning has been called)."""
        self.topo = topo
        self.dof = dof_handler
        max_codim = dof_handler.max_codim
        self.max_codim = max_codim

        # closure dof pattern per codim
        closure = {}
        for c in range(max_codim + 1):
            closure[c] = C.bool_mult(
                topo.AEntity_entity[c], dof_handler.entity_dof_pattern(c))

        # separator type per dof
        septype = np.zeros(dof_handler.ndofs, dtype=np.int64)
        for c in range(1, max_codim + 1):
            septype[closure[c].indices] = c
        self.septype = septype

        # interior-first ordered dof lists + interior counts, built with one
        # global lexsort per codim (vectorized; the per-AE loop was a setup
        # hot spot)
        self._ae_dofs = {}
        self._ae_cat = {}
        self._n_interior = {}
        for c in range(max_codim + 1):
            M = closure[c]
            n_ae = M.shape[0]
            rows = np.repeat(np.arange(n_ae, dtype=np.int64),
                             np.diff(M.indptr))
            d = M.indices.astype(np.int64)
            st = septype[d]
            order = np.lexsort((d, st, rows))
            dcat = d[order]
            off = M.indptr.astype(np.int64)
            if c < max_codim:
                nint = np.bincount(rows, weights=(st == c),
                                   minlength=n_ae).astype(np.int64)
            else:
                nint = np.diff(off)
            self._ae_cat[c] = (dcat, off)
            self._ae_dofs[c] = None     # list view split lazily (np.split
            #                             of ~10^6 rows costs seconds)
            self._n_interior[c] = nint

    # ------------------------------------------------------------------ #
    def ae_dofs(self, codim):
        """List per AE: closure dof ids, interior first."""
        if self._ae_dofs[codim] is None:
            dcat, off = self._ae_cat[codim]
            self._ae_dofs[codim] = np.split(dcat, off[1:-1])
        return self._ae_dofs[codim]

    def ae_dofs_cat(self, codim):
        """(cat, off) flat layout of ae_dofs."""
        return self._ae_cat[codim]

    def n_interior(self, codim):
        return self._n_interior[codim]

    def interior_dofs(self, codim, iae):
        dcat, off = self._ae_cat[codim]
        return dcat[off[iae]:off[iae] + self._n_interior[codim][iae]]

    def bdr_dofs(self, codim, iae):
        dcat, off = self._ae_cat[codim]
        return dcat[off[iae] + self._n_interior[codim][iae]:off[iae + 1]]


def distribute_matrix(A, row_dofs, col_dofs) -> np.ndarray:
    """Dense restriction A[row_dofs][:, col_dofs] of a global sparse matrix
    (DistributeAgglomerateMatrix, DOFAgglomeration.cpp:606-645)."""
    return C.extract_submatrix(A, row_dofs, col_dofs)
