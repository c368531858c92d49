"""Arbitrary-order 3D de Rham sequence on TET meshes (feorder = p >= 0):
P_{p+1} -> ND_{p+1} -> RT_{p+1} -> P_p (the trimmed family; see
amge/tetfe_ho.py for the reference element).

The simplex twin of fespace3d_ho: global dof conventions are gid-derived
(edge direction tail=min gid -> head; face frame = the face's vertices in
ASCENDING gid order, axes e1 = g1-g0, e2 = g2-g0, frame normal e1 x e2).
Because the frame vertices are sorted, every frame edge runs in the global
direction automatically, so facet closure tables need no reversal flags.
Per-(element, face) transforms are the 6 S3 permutations acting on
Bernstein moment bases: pure permutations for H1 nodes, signed
permutations for RT flux moments, small-integer axis-mixing blocks for ND
tangential moments (applied as dense per-face blocks). All geometry is
affine, so codim-0 masses are metric contractions of constant reference
Grams. Reference parity: the order-generic tet collections of
DeRhamSequenceFE.cpp:83-310 on the testsuite's cube456-class meshes.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.amge.sequence import DeRhamSequence
from parelag_tpu_torch.amge.localmass import LocalMass
from parelag_tpu_torch.amge.dofhandler import DofHandlerBase
from parelag_tpu_torch.amge import tetfe
from parelag_tpu_torch.amge.tetfe_ho import (
    tet_ref, perm3_code, PERMS3, _bernstein, _bary2, _bary3,
    legendre_vals)
from parelag_tpu_torch.mesh.mesh import TET_FACES


class DofHandlerTetHO(DofHandlerBase):
    """Entity-major numbering: H1 [verts | edges | faces | cells],
    ND [edges | faces | cells], RT [faces | cells], L2 [cells]."""

    def __init__(self, form, mesh, ents, p, frame_tris):
        self.form = form
        self.mesh = mesh
        self.ents = ents
        self.p = p
        self.dim = 3
        self.max_codim = 3 - form
        R = tet_ref(p)
        self.R = R
        ne = mesh.num_elements
        ned, nfc, nv = ents.num_edges, ents.num_faces, mesh.num_vertices
        if form == 0:
            self.n_edge, self.n_face, self.n_int = R.nH1e, R.nH1f, R.nH1i
            self.off_e = nv
        elif form == 1:
            self.n_edge, self.n_face, self.n_int = R.nNDe, R.nNDf, R.nNDi
            self.off_e = 0
        elif form == 2:
            self.n_edge, self.n_face, self.n_int = 0, R.nRTf, R.nRTi
            self.off_e = 0
        else:
            self.n_edge, self.n_face, self.n_int = 0, 0, R.nL2
            self.off_e = 0
        self.off_f = self.off_e + ned * self.n_edge
        self.off_i = self.off_f + nfc * self.n_face
        self.ndofs = self.off_i + ne * self.n_int
        self.frame_tris = frame_tris
        self._tables = {}

    def edge_dofs(self):
        ned = self.ents.num_edges
        return (self.off_e + np.arange(ned)[:, None] * self.n_edge
                + np.arange(self.n_edge)[None, :])

    def face_dofs(self):
        nfc = self.ents.num_faces
        return (self.off_f + np.arange(nfc)[:, None] * self.n_face
                + np.arange(self.n_face)[None, :])

    def int_dofs(self):
        ne = self.mesh.num_elements
        return (self.off_i + np.arange(ne)[:, None] * self.n_int
                + np.arange(self.n_int)[None, :])

    def _frame_edges(self):
        """Frame edges of each face in order (g0g1), (g0g2), (g1g2) —
        all in global (ascending-gid) direction by construction."""
        if hasattr(self, "_fe_cache"):
            return self._fe_cache
        ft = self.frame_tris
        ends = np.stack([
            np.stack([ft[:, 0], ft[:, 1]], 1),
            np.stack([ft[:, 0], ft[:, 2]], 1),
            np.stack([ft[:, 1], ft[:, 2]], 1)], axis=1)    # (nf, 3, 2)
        nv = self.mesh.num_vertices
        gkeys = (self.ents.edges[:, 0].astype(np.int64) * nv
                 + self.ents.edges[:, 1])
        order = np.argsort(gkeys)
        keys = ends[..., 0].astype(np.int64) * nv + ends[..., 1]
        fe = order[np.searchsorted(gkeys[order], keys)]
        self._fe_cache = (ft, fe)
        return self._fe_cache

    def entity_dofs(self, codim):
        if codim in self._tables:
            return self._tables[codim]
        m, e, form = self.mesh, self.ents, self.form
        ne = m.num_elements
        if codim == 0:
            parts = []
            if form == 0:
                parts.append(m.elements)
            if form in (0, 1) and self.n_edge:
                parts.append(self.edge_dofs()[e.elem_edge].reshape(ne, -1))
            if form in (0, 1, 2) and self.n_face:
                parts.append(self.face_dofs()[e.elem_face].reshape(ne, -1))
            if self.n_int:
                parts.append(self.int_dofs())
            t = np.concatenate([np.asarray(x) for x in parts], axis=1)
        elif codim == 1:
            ft, fe = self._frame_edges()
            parts = []
            if form == 0:
                parts.append(ft)
                if self.n_edge:
                    parts.append(
                        self.edge_dofs()[fe].reshape(ft.shape[0], -1))
                if self.n_face:
                    parts.append(self.face_dofs())
            elif form == 1:
                parts.append(self.edge_dofs()[fe].reshape(ft.shape[0], -1))
                if self.n_face:
                    parts.append(self.face_dofs())
            elif form == 2:
                parts.append(self.face_dofs())
            else:
                raise ValueError("L2 has no facet dofs")
            t = np.concatenate([np.asarray(x) for x in parts], axis=1)
        elif codim == 2:
            if form == 0:
                t = np.concatenate([e.edges, self.edge_dofs()], axis=1)
            elif form == 1:
                t = self.edge_dofs()
            else:
                raise ValueError
        else:
            if form != 0:
                raise ValueError
            t = np.arange(m.num_vertices)[:, None]
        self._tables[codim] = np.asarray(t)
        return self._tables[codim]


class DeRhamSequenceTetFE_HO(DeRhamSequence):
    """Arbitrary-order tet de Rham sequence (feorder >= 0)."""

    def __init__(self, topo, mesh, feorder=1):
        assert mesh.dim == 3 and mesh.kind == "tet"
        super().__init__(topo, 4)
        self.kind = "tet"
        self.mesh = mesh
        self.ents = topo.entities
        self.feorder = feorder
        self.R = tet_ref(feorder)
        fv = np.asarray(self.ents.face_verts, dtype=np.int64)
        self.frame_tris = np.sort(fv, axis=1)
        # frame normal vs stored cycle: equal iff the sort is an even
        # permutation of the stored cycle
        codes = perm3_code(fv, self.frame_tris)
        par = np.array([1.0 if _even(PERMS3[c]) else -1.0
                        for c in codes])
        self.frame_vs_cycle = par
        for j in range(4):
            self.dof[j] = DofHandlerTetHO(j, mesh, self.ents, feorder,
                                          self.frame_tris)
        self._build_transforms()
        self._geometry()
        self._build_derivatives()
        self._assemble_local_mass()
        self.L2_const_rep = self._l2_dofs_of_one()

    # ------------------------------------------------------------------ #
    def _build_transforms(self):
        """Per-element transforms: (pi, sigma) arrays for the permutation
        parts + per-local-face dense block tables for ND."""
        R, e, m = self.R, self.ents, self.mesh
        ne = m.num_elements
        local_tris = m.elements[:, TET_FACES]              # (ne, 4, 3)
        self.face_codes = perm3_code(
            local_tris, self.frame_tris[e.elem_face])
        edge_fwd = e.elem_edge_sign > 0

        def build(nloc, edge_off, nblk_e, edge_ts, face_off, nblk_f,
                  face_ts_perm):
            pi = np.tile(np.arange(nloc, dtype=np.int64), (ne, 1))
            sg = np.ones((ne, nloc))
            if nblk_e:
                pr, sr = edge_ts
                for le in range(6):
                    o = edge_off + le * nblk_e
                    fwd = edge_fwd[:, le]
                    pi[:, o:o + nblk_e] = np.where(
                        fwd[:, None], np.arange(nblk_e) + o,
                        pr[None, :] + o)
                    sg[:, o:o + nblk_e] = np.where(
                        fwd[:, None], 1.0, sr[None, :])
            if nblk_f and face_ts_perm is not None:
                P6 = np.stack([t[0] for t in face_ts_perm])
                S6 = np.stack([t[1] for t in face_ts_perm])
                for lf in range(4):
                    o = face_off + lf * nblk_f
                    code = self.face_codes[:, lf]
                    pi[:, o:o + nblk_f] = P6[code] + o
                    sg[:, o:o + nblk_f] = S6[code]
            return pi, sg

        def sp_arrays(T):
            p = np.argmax(np.abs(T), axis=1)
            return p.astype(np.int64), T[np.arange(T.shape[0]), p]

        h1_rev = sp_arrays(R.T_h1_edge_rev) if R.nH1e else None
        nd_rev = sp_arrays(R.T_nd_edge_rev)
        h1_face = ([sp_arrays(T) for T in R.T_h1_3] if R.nH1f else None)
        rt_face = [sp_arrays(T) for T in R.T_rt3]

        self.S_h1 = build(R.nH1, 4, R.nH1e, h1_rev,
                          4 + 6 * R.nH1e, R.nH1f, h1_face)
        # ND: perm part covers edges; faces handled densely
        self.S_nd_perm = build(R.nND, 0, R.nNDe, nd_rev, 0, 0, None)
        self.nd_face_off = 6 * R.nNDe
        self.T_nd_stack = (np.stack(R.T_nd3) if R.nNDf
                           else np.zeros((6, 0, 0)))
        self.T_nd_stack_R = (np.stack(R.R_nd3) if R.nNDf
                             else np.zeros((6, 0, 0)))
        self.S_rt = build(R.nRT, 0, 0, None, 0, R.nRTf, rt_face)
        self.S_l2 = (np.tile(np.arange(R.nL2, dtype=np.int64), (ne, 1)),
                     np.ones((ne, R.nL2)))

    def _fold_rows(self, M, S, nd_faces=None):
        """Apply the row transform g = S l to (ne, nloc, X) blocks.
        nd_faces: None | "T" (dof transform) | "R" (dual transform T^{-T},
        for mass and derivative-column folding — the ND face blocks are
        not orthogonal)."""
        pi, sg = S
        out = np.take_along_axis(M, pi[:, :, None], axis=1) \
            * sg[:, :, None]
        if nd_faces and self.R.nNDf:
            blk = self.R.nNDf
            stack = (self.T_nd_stack if nd_faces == "T"
                     else self.T_nd_stack_R)
            for lf in range(4):
                o = self.nd_face_off + lf * blk
                Tb = stack[self.face_codes[:, lf]]
                out[:, o:o + blk, :] = np.einsum(
                    "eij,ejX->eiX", Tb, M[:, o:o + blk, :])
        return out

    def _fold_mass(self, M, S, nd_faces=None):
        # M_g = R M_l R^T with R = S^{-T} (orthogonal parts: R = S)
        f = "R" if nd_faces else None
        t = self._fold_rows(M, S, f)
        t = self._fold_rows(t.transpose(0, 2, 1), S, f)
        return t.transpose(0, 2, 1)

    def _S(self, form):
        return [self.S_h1, self.S_nd_perm, self.S_rt, self.S_l2][form]

    # ------------------------------------------------------------------ #
    def _geometry(self):
        m = self.mesh
        ec = m.vertices[m.elements]
        self._ec = ec
        J, det, Jinv = tetfe._tet_jac(ec)
        # signed det: cube456-class meshes carry negatively oriented tets;
        # Piola/density pullbacks use the SIGNED det (keeps D geometry-
        # independent), measures use |det|
        self.J, self.detJ, self.Jinv = J, det, Jinv
        self.absJ = np.abs(det)
        R = self.R
        lam = _bary3(R.q3)
        self.qphys = np.einsum("qi,nic->nqc", lam, ec)
        fc = m.vertices[self.frame_tris]                  # (nf, 3, 3)
        self.fE1 = fc[:, 1] - fc[:, 0]
        self.fE2 = fc[:, 2] - fc[:, 0]
        self.fN = np.cross(self.fE1, self.fE2)            # 2*area vector
        self.face_area = 0.5 * np.linalg.norm(self.fN, axis=1)
        self._fc = fc
        lam2 = _bary2(R.q2)
        self.fphys = np.einsum("qi,nic->nqc", lam2, fc)
        rc = m.vertices[self.ents.edges]
        self.edge_vec = rc[:, 1] - rc[:, 0]
        self.edge_len = np.linalg.norm(self.edge_vec, axis=1)
        self._rc = rc

    # ------------------------------------------------------------------ #
    def _build_derivatives(self):
        R = self.R
        ne = self.mesh.num_elements

        def fold_D(Dref, dof_out, dof_in, S_out, S_in, nd_out, nd_in):
            # Dg = S_out Dref S_in^{-1}: rows via T, columns via R = S^{-T}
            Dt = np.broadcast_to(Dref, (ne,) + Dref.shape).copy()
            Dt = self._fold_rows(Dt, S_out,
                                 nd_faces="T" if nd_out else None)
            Dt = self._fold_rows(Dt.transpose(0, 2, 1), S_in,
                                 nd_faces="R" if nd_in else None
                                 ).transpose(0, 2, 1)
            rows = np.asarray(dof_out.entity_dofs(0))
            cols = np.asarray(dof_in.entity_dofs(0))
            nout, nin = Dref.shape
            r = np.repeat(rows, nin, axis=1).ravel()
            c = np.tile(cols, (1, nout)).ravel()
            v = Dt.reshape(ne, -1).ravel()
            keep = np.abs(v) > 1e-12
            r, c, v = r[keep], c[keep], v[keep]
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
            first = np.ones(r.size, dtype=bool)
            if r.size > 1:
                first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            return sp.csr_matrix(
                (v[first], (r[first], c[first])),
                shape=(dof_out.ndofs, dof_in.ndofs))

        self.D[0] = fold_D(R.D0, self.dof[1], self.dof[0],
                           self.S_nd_perm, self.S_h1, True, False)
        self.D[1] = fold_D(R.D1, self.dof[2], self.dof[1],
                           self.S_rt, self.S_nd_perm, False, True)
        self.D[2] = fold_D(R.D2, self.dof[3], self.dof[2],
                           self.S_l2, self.S_rt, False, False)

    # ------------------------------------------------------------------ #
    def _assemble_local_mass(self, elem_coeffs=None):
        R = self.R
        coeff = elem_coeffs or {}
        detJ = self.detJ

        def cw(form):
            c = coeff.get(form)
            return None if c is None else np.asarray(c)

        # codim 0: affine metric contractions of constant reference Grams
        N = R.h1_eval(R.q3)                                # (nH1, nq)
        c0 = cw(0)
        absJ = self.absJ
        if c0 is None:
            G0 = np.einsum("iq,q,jq->ij", N, R.w3, N)
            M0 = absJ[:, None, None] * G0[None]
        else:
            M0 = np.einsum("iq,nq,jq->nij", N,
                           R.w3[None, :] * absJ[:, None] * c0, N,
                           optimize=True)
        self.M[(0, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(0), self._fold_mass(M0, self.S_h1))

        E = R.nd_eval(R.q3)                                # (nND, nq, 3)
        c1 = cw(1)
        if c1 is None:
            K = np.einsum("iqa,q,jqb->abij", E, R.w3, E)
            Gcov = np.einsum("nab,ncb->nac", self.Jinv, self.Jinv)
            M1 = np.einsum("nab,abij->nij", Gcov * absJ[:, None, None], K)
        else:
            phys = np.einsum("nba,iqb->niqa", self.Jinv, E)
            w = R.w3[None, :] * absJ[:, None] * c1
            M1 = np.einsum("niqa,nq,njqa->nij", phys, w, phys,
                           optimize=True)
        self.M[(0, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(0),
            self._fold_mass(M1, self.S_nd_perm, nd_faces=True))

        F = R.rt_eval(R.q3)
        c2 = cw(2)
        if c2 is None:
            K = np.einsum("iqa,q,jqb->abij", F, R.w3, F)
            Gpio = np.einsum("nba,nbc->nac", self.J, self.J)
            M2 = np.einsum("nab,abij->nij", Gpio / absJ[:, None, None], K)
        else:
            phys = np.einsum("nab,iqb->niqa", self.J, F) \
                / detJ[:, None, None, None]
            w = R.w3[None, :] * absJ[:, None] * c2
            M2 = np.einsum("niqa,nq,njqa->nij", phys, w, phys,
                           optimize=True)
        self.M[(0, 2)] = LocalMass.from_uniform(
            self.dof[2].entity_dofs(0), self._fold_mass(M2, self.S_rt))

        L = R.l2_eval(R.q3)
        c3 = cw(3)
        if c3 is None:
            GL = np.einsum("iq,q,jq->ij", L, R.w3, L)
            M3 = GL[None] / absJ[:, None, None]
        else:
            M3 = np.einsum("iq,nq,jq->nij", L,
                           R.w3[None, :] / absJ[:, None] * c3, L,
                           optimize=True)
        self.M[(0, 3)] = LocalMass.from_uniform(
            self.dof[3].entity_dofs(0), M3)

        self._assemble_trace_mass()

    def _assemble_trace_mass(self):
        R = self.R
        k = R.k
        area2 = 2.0 * self.face_area                       # |e1 x e2|

        # H1 face trace: P_k 2D in the frame layout; flat faces -> one
        # constant reference Gram scaled by |e1 x e2|
        NH = self._h1_face_basis()                         # (ndof, nq2)
        G = np.einsum("iq,q,jq->ij", NH, R.w2, NH)
        self.M[(1, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(1), area2[:, None, None] * G[None])

        # ND tangential trace: covariant 2D metric per face
        EN = self._nd_face_basis()                         # (ndof, nq2, 2)
        G2 = np.stack([
            np.stack([np.einsum("nc,nc->n", self.fE1, self.fE1),
                      np.einsum("nc,nc->n", self.fE1, self.fE2)], -1),
            np.stack([np.einsum("nc,nc->n", self.fE2, self.fE1),
                      np.einsum("nc,nc->n", self.fE2, self.fE2)], -1)],
            -2)
        G2inv = np.linalg.inv(G2)
        K = np.einsum("iqa,q,jqb->abij", EN, R.w2, EN)
        M = np.einsum("nab,abij->nij",
                      G2inv * area2[:, None, None], K)
        self.M[(1, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(1), M)

        # RT normal trace: flux densities (dual to Bernstein moments)
        B = _bernstein(R.b_face_rt, _bary2(R.q2))
        Gb = np.einsum("iq,q,jq->ij", B, R.w2, B)
        dual = np.linalg.inv(Gb) @ B                       # (nRTf, nq2)
        Gd = np.einsum("iq,q,jq->ij", dual, R.w2, dual)
        self.M[(1, 2)] = LocalMass.from_uniform(
            self.dof[2].entity_dofs(1),
            Gd[None] / area2[:, None, None])

        # codim 2 edges
        from parelag_tpu_torch.amge.fespace2d_ho import nodal_basis_1d
        nodes = np.concatenate([[0.0, 1.0],
                                np.arange(1, k) / k])
        N1 = nodal_basis_1d(nodes, R.gx)
        M1d = np.einsum("q,iq,jq->ij", R.gw, N1, N1)
        self.M[(2, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(2),
            self.edge_len[:, None, None] * M1d[None])
        tr = np.diag(2.0 * np.arange(R.nNDe) + 1.0)
        self.M[(2, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(2),
            tr[None] / self.edge_len[:, None, None])

        nv = self.mesh.num_vertices
        self.M[(3, 0)] = LocalMass.from_uniform(
            np.arange(nv)[:, None], np.ones((nv, 1, 1)))

    # ---------------- face trace bases (frame layout) ---------------- #
    def _h1_face_basis(self):
        """2D P_k nodal basis on the frame triangle in the facet layout
        [3 corners | 3 frame edges (k-1 nodes, ascending) | interior]."""
        R = self.R
        k = R.k
        if hasattr(self, "_h1f_cache"):
            return self._h1f_cache
        nodes = [np.array([0.0, 0.0]), np.array([1.0, 0.0]),
                 np.array([0.0, 1.0])]
        for (a, b) in ((np.array([0.0, 0.0]), np.array([1.0, 0.0])),
                       (np.array([0.0, 0.0]), np.array([0.0, 1.0])),
                       (np.array([1.0, 0.0]), np.array([0.0, 1.0]))):
            for t in range(1, k):
                nodes.append(a + (t / k) * (b - a))
        for b in range(1, k):
            for a in range(1, k - b):
                nodes.append(np.array([a / k, b / k]))
        nodes = np.array(nodes)
        alphas = [al for al in _multi2(k)]
        V = _bernstein(alphas, _bary2(nodes))
        C = np.linalg.inv(V)
        B = _bernstein(alphas, _bary2(R.q2))
        self._h1f_cache = C @ B
        return self._h1f_cache

    def _nd_face_basis(self):
        """Canonical 2D ND basis on the frame triangle, layout [3 frame
        edges x k moments (ascending directions) | face moments]."""
        R = self.R
        if hasattr(self, "_ndf_cache"):
            return self._ndf_cache
        k = R.k
        gx, gw = R.gx, R.gw
        q2, w2 = R.q2, R.w2
        # space R_k(2D) = (P_{k-1})^2 + S_k(2D), S_k = span{rot x * ptilde}
        low = [al for al in _multi2pow(k - 1)]
        hom = [al for al in _multi2pow(k - 1, exact=True)]

        def ev(pts):
            Ml = _mono2(low, pts)
            Mh = _mono2(hom, pts)
            nb = 2 * len(low) + len(hom)
            out = np.zeros((nb, pts.shape[0], 2))
            out[:len(low), :, 0] = Ml
            out[len(low):2 * len(low), :, 1] = Ml
            rot = np.stack([-pts[:, 1], pts[:, 0]], axis=1)
            for j in range(len(hom)):
                out[2 * len(low) + j] = Mh[j][:, None] * rot
            return out

        ndof = 3 * k + R.nNDf
        assert 2 * len(low) + len(hom) == ndof
        P1 = legendre_vals(k - 1, gx)
        Bnd = (_bernstein(R.b_face_nd, _bary2(q2))
               if R.b_face_nd else np.zeros((0, q2.shape[0])))
        edges = ((np.array([0.0, 0.0]), np.array([1.0, 0.0])),
                 (np.array([0.0, 0.0]), np.array([0.0, 1.0])),
                 (np.array([1.0, 0.0]), np.array([0.0, 1.0])))
        V = np.zeros((ndof, ndof))
        pos = 0
        for (a, b) in edges:
            pts = a[None, :] + gx[:, None] * (b - a)[None, :]
            vals = ev(pts)
            tang = np.einsum("mqc,c->mq", vals, b - a)
            for j in range(k):
                V[pos] = tang @ (gw * P1[j])
                pos += 1
        fvals = ev(q2)
        for comp in range(2):
            for bi in range(Bnd.shape[0]):
                V[pos] = fvals[:, :, comp] @ (w2 * Bnd[bi])
                pos += 1
        assert pos == ndof
        coeff = np.linalg.inv(V.T)
        self._ndf_cache = np.einsum("im,mqa->iqa", coeff, fvals)
        return self._ndf_cache

    # ------------------------------------------------------------------ #
    def replace_mass_integrator(self, form, coeff_fn):
        vals = np.asarray(coeff_fn(self.qphys))
        self._coeffs = getattr(self, "_coeffs", {})
        self._coeffs[form] = vals
        self._assemble_local_mass(self._coeffs)

    # ------------------------------------------------------------------ #
    # interpolation / targets
    # ------------------------------------------------------------------ #
    def h1_node_coords(self):
        R = self.R
        k = R.k
        m = self.mesh
        verts = m.vertices
        tn = np.arange(1, k) / k
        rc = self._rc
        edge_nodes = (rc[:, 0][:, None, :] + tn[None, :, None]
                      * self.edge_vec[:, None, :]).reshape(-1, 3)
        fnodes = []
        for b in range(1, k):
            for a in range(1, k - b):
                fnodes.append((a / k, b / k))
        if fnodes:
            st = np.array(fnodes)
            face_nodes = (self._fc[:, 0][:, None, :]
                          + st[None, :, 0, None] * self.fE1[:, None, :]
                          + st[None, :, 1, None] * self.fE2[:, None, :]
                          ).reshape(-1, 3)
        else:
            face_nodes = np.zeros((0, 3))
        inodes = []
        for c in range(1, k):
            for b in range(1, k - c):
                for a in range(1, k - b - c):
                    inodes.append((a / k, b / k, c / k))
        if inodes:
            ref = np.array(inodes)
            lam = _bary3(ref)
            int_nodes = np.einsum("qi,nic->nqc", lam,
                                  self._ec).reshape(-1, 3)
        else:
            int_nodes = np.zeros((0, 3))
        return np.concatenate([verts, edge_nodes, face_nodes, int_nodes],
                              axis=0)

    def interpolate_scalar_targets(self, jform, fns):
        R = self.R
        if jform == 0:
            pts = self.h1_node_coords()
            return (np.stack([np.asarray(f(pts)) for f in fns], axis=1)
                    if fns else np.zeros((pts.shape[0], 0)))
        assert jform == 3
        cols = []
        for f in fns:
            dens = np.asarray(f(self.qphys)) * self.detJ[:, None]
            cols.append(R.l2_dofs(dens).reshape(-1))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[3].ndofs, 0)))

    def interpolate_vector_targets(self, jform, fns):
        R = self.R
        k = R.k
        cols = []
        if jform == 1:
            rc = self._rc
            epts = (rc[:, 0][:, None, :]
                    + R.gx[None, :, None] * self.edge_vec[:, None, :])
            P1 = legendre_vals(k - 1, R.gx)
            Bnd = (_bernstein(R.b_face_nd, _bary2(R.q2))
                   if R.b_face_nd else np.zeros((0, R.q2.shape[0])))
            B3 = (_bernstein(R.b_int_nd, _bary3(R.q3))
                  if R.b_int_nd else np.zeros((0, R.q3.shape[0])))
            for f in fns:
                ve = np.asarray(f(epts))
                circ = np.einsum("eqc,ec->eq", ve, self.edge_vec)
                mom_e = np.einsum("eq,jq,q->ej", circ, P1, R.gw)
                vf = np.asarray(f(self.fphys))
                moms_f = []
                for axis in (self.fE1, self.fE2):
                    ut = np.einsum("fqc,fc->fq", vf, axis)
                    for bi in range(Bnd.shape[0]):
                        moms_f.append(
                            np.einsum("fq,q->f", ut * Bnd[bi], R.w2))
                mom_f = (np.stack(moms_f, axis=1) if moms_f
                         else np.zeros((vf.shape[0], 0)))
                vq = np.asarray(f(self.qphys))
                uhat = np.einsum("nab,nqa->nqb", self.J, vq)
                moms_i = []
                for comp in range(3):
                    for bi in range(B3.shape[0]):
                        moms_i.append(np.einsum(
                            "nq,q->n", uhat[:, :, comp] * B3[bi], R.w3))
                mom_i = (np.stack(moms_i, axis=1) if moms_i
                         else np.zeros((vq.shape[0], 0)))
                cols.append(np.concatenate(
                    [mom_e.reshape(-1), mom_f.reshape(-1),
                     mom_i.reshape(-1)]))
            return (np.stack(cols, axis=1) if fns
                    else np.zeros((self.dof[1].ndofs, 0)))
        assert jform == 2
        Brt = _bernstein(R.b_face_rt, _bary2(R.q2))
        B3 = (_bernstein(R.b_int_rt, _bary3(R.q3))
              if R.b_int_rt else np.zeros((0, R.q3.shape[0])))
        for f in fns:
            vf = np.asarray(f(self.fphys))
            flux = np.einsum("fqc,fc->fq", vf, self.fN)
            mom_f = np.stack(
                [np.einsum("fq,q->f", flux * Brt[bi], R.w2)
                 for bi in range(Brt.shape[0])], axis=1)
            vq = np.asarray(f(self.qphys))
            uhat = np.einsum("n,nab,nqb->nqa", self.detJ, self.Jinv, vq)
            moms_i = []
            for comp in range(3):
                for bi in range(B3.shape[0]):
                    moms_i.append(np.einsum(
                        "nq,q->n", uhat[:, :, comp] * B3[bi], R.w3))
            mom_i = (np.stack(moms_i, axis=1) if moms_i
                     else np.zeros((vq.shape[0], 0)))
            cols.append(np.concatenate(
                [mom_f.reshape(-1), mom_i.reshape(-1)]))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[2].ndofs, 0)))

    def set_upscaling_targets(self, order=0):
        from parelag_tpu_torch.amge.fespace import (
            _monomials3d, _vector_monomials3d)
        self.targets[0] = self.interpolate_scalar_targets(
            0, _monomials3d(order + 1))
        vec = _vector_monomials3d(order)
        self.targets[1] = self.interpolate_vector_targets(1, vec)
        self.targets[2] = self.interpolate_vector_targets(2, vec)
        self.targets[3] = self.interpolate_scalar_targets(
            3, _monomials3d(order))

    def _l2_dofs_of_one(self):
        return self.interpolate_scalar_targets(
            3, [lambda q: np.ones(q.shape[:-1])])[:, 0]

    def element_volumes(self):
        return self.absJ / 6.0

    def boundary_dofs(self, jform):
        from parelag_tpu_torch.mesh.entities import bdr_face_ids
        fids = bdr_face_ids(self.mesh, self.ents)
        ed = self.dof[jform].entity_dofs(1)
        out = np.zeros(self.dof[jform].ndofs, dtype=bool)
        out[ed[fids].reshape(-1)] = True
        return out

    def domain_lf_scalar(self, jform, fn):
        R = self.R
        f = np.asarray(fn(self.qphys))
        b = np.zeros(self.dof[jform].ndofs)
        if jform == 0:
            N = R.h1_eval(R.q3)
            vals = np.einsum("nq,iq->ni", R.w3[None, :]
                             * self.absJ[:, None] * f, N)
            pi, sg = self.S_h1
            vals = np.take_along_axis(vals, pi, axis=1) * sg
            np.add.at(b, self.dof[0].entity_dofs(0).ravel(), vals.ravel())
        elif jform == 3:
            vals = R.l2_dofs(f * self.detJ[:, None])
            b[self.dof[3].entity_dofs(0).ravel()] = vals.ravel()
        else:
            raise ValueError(jform)
        return b

    def compute_pv_traces(self, codim) -> np.ndarray:
        R = self.R
        jform = 3 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        coo = AE_e.tocoo()
        if codim == 0:
            one = self.L2_const_rep
            d = self.dof[3]
            ids = d.int_dofs()[coo.col]
            pv[ids.reshape(-1)] = np.repeat(
                coo.data, d.n_int) * one[ids.reshape(-1)]
        elif codim == 1:
            # constant flux density (per unit reference area) with total
            # flux = area: moments against ALL Bernstein tests
            B = _bernstein(R.b_face_rt, _bary2(R.q2))
            ints = B @ R.w2                        # (nRTf,), sum ref ints
            fdofs = self.dof[2].face_dofs()[coo.col]
            dens = (2.0 * self.face_area[coo.col]
                    * coo.data * self.frame_vs_cycle[coo.col])
            pv[fdofs.reshape(-1)] = (dens[:, None]
                                     * ints[None, :]).reshape(-1)
        elif codim == 2:
            e0 = self.dof[1].edge_dofs()[coo.col, 0]
            pv[e0] = coo.data * self.edge_len[coo.col]
        else:
            pv[AE_e.indices] = 1.0
        return pv

    def boundary_rhs_ho(self, form, attr_values):
        from parelag_tpu_torch.mesh.entities import bdr_face_ids
        R = self.R
        mesh, ents = self.mesh, self.ents
        b = np.zeros(self.dof[form].ndofs)
        fids = bdr_face_ids(mesh, ents)
        B0t = ents.B0.T.tocsr()
        battrs = np.asarray(mesh.bdr_attrib)
        for attr, val in attr_values.items():
            sel = np.where(battrs == attr)[0]
            if sel.size == 0:
                continue
            f = fids[sel]
            out_sign = B0t.data[B0t.indptr[f]]
            if form == 2:
                # int phi_i . n dA: dual flux densities integrate to
                # Ginv @ refints, scaled by the orientation
                Bq = _bernstein(R.b_face_rt, _bary2(R.q2))
                Gb = np.einsum("iq,q,jq->ij", Bq, R.w2, Bq)
                ints = np.linalg.solve(Gb, Bq @ R.w2)
                fd = self.dof[2].face_dofs()[f]
                w = val * out_sign * self.frame_vs_cycle[f]
                np.add.at(b, fd.reshape(-1),
                          (w[:, None] * ints[None, :]).reshape(-1))
                continue
            assert form == 0
            NH = self._h1_face_basis()
            vals = val * (2.0 * self.face_area[f])[:, None] \
                * (NH @ R.w2)[None, :]
            tab = self.dof[0].entity_dofs(1)[f]
            np.add.at(b, tab.ravel(), vals.ravel())
        return b


def _even(pi):
    inv = sum(1 for i in range(3) for j in range(i + 1, 3)
              if pi[i] > pi[j])
    return inv % 2 == 0


def _multi2(n):
    out = []
    for b in range(n + 1):
        for a in range(n + 1 - b):
            out.append((n - a - b, a, b))
    return out


def _multi2pow(max_deg, exact=False):
    degs = range(max_deg, max_deg + 1) if exact else range(max_deg + 1)
    out = []
    for total in degs:
        for a in range(total + 1):
            out.append((a, total - a))
    return out


def _mono2(powers, pts):
    out = np.empty((len(powers), pts.shape[0]))
    for i, (a, b) in enumerate(powers):
        out[i] = pts[:, 0] ** a * pts[:, 1] ** b
    return out
