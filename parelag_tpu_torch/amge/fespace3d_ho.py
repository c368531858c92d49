"""Arbitrary-order 3D de Rham sequence on hex meshes (feorder = p >= 0):
Q_{p+1} -> ND_p -> RT_p -> Q_p.

The 3D counterpart of fespace2d_ho (reference: order-generic local assembly
src/amge/DeRhamSequenceFE.cpp:83-310, order threading
DeRhamSequenceFE.hpp:58-310; every reference example exposes --feorder).
All reference-element data comes from amge.hexfe_ho; this module adds the
mesh-global structure:

* GLOBAL dof conventions (rank-independent, gid-derived):
    - edges: moments/nodes along the global direction tail=min gid -> head;
    - faces: moments/nodes in the face's intrinsic FRAME — origin at the
      min-gid corner, s-axis toward the smaller-gid cycle neighbor, t-axis
      toward the other; frame normal = s x t (NOT necessarily the stored
      B0 cycle normal — compute_pv_traces folds the relative sign).
* Per-(element, entity) transforms are SIGNED PERMUTATIONS (pi, sigma):
  global-layout values g_i = sigma_i * local-reference values l_{pi_i};
  folding them into the geometry-independent reference derivative matrices
  and the batched local mass matrices keeps D0/D1/D2 exact incidence-style
  operators (D @ D = 0 to machine precision at any order) with all
  geometry in M.

A copy of parelag_tpu/amge/fespace3d_ho.py with one edit: _metric_mass
contracts in one batched GEMM instead of nine broadcast products.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.amge.sequence import DeRhamSequence
from parelag_tpu_torch.amge.localmass import LocalMass
from parelag_tpu_torch.amge.dofhandler import DofHandlerBase
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.amge.hexfe_ho import ref3, dihedral_code, DIHEDRAL
from parelag_tpu_torch.amge.fespace2d_ho import (
    legendre_vals, nodal_basis_1d, nodal_dbasis_1d)
from parelag_tpu_torch.mesh.mesh import HEX_FACES
from parelag_tpu_torch.ops import csr as C


def _signed_perm_arrays(T):
    """Signed permutation matrix (g = T l) -> (pi, sigma) with
    g_i = sigma_i * l_{pi_i}."""
    pi = np.argmax(np.abs(T), axis=1)
    sigma = T[np.arange(T.shape[0]), pi]
    return pi.astype(np.int64), sigma


def _face_frames(ents):
    """Per global face: frame corner ids at positions
    (0,0),(1,0),(1,1),(0,1) — intrinsic (gid-derived), rank-independent."""
    cyc = np.asarray(ents.face_verts, dtype=np.int64)       # (nf, 4)
    o = np.argmin(cyc, axis=1)
    nf = cyc.shape[0]
    ar = np.arange(nf)
    nxt = cyc[ar, (o + 1) % 4]
    prv = cyc[ar, (o - 1) % 4]
    s_is_next = nxt < prv
    fq = np.empty((nf, 4), dtype=np.int64)
    fq[:, 0] = cyc[ar, o]
    fq[:, 1] = np.where(s_is_next, nxt, prv)
    fq[:, 3] = np.where(s_is_next, prv, nxt)
    fq[:, 2] = cyc[ar, (o + 2) % 4]
    # frame normal sign relative to the stored cycle normal: +1 when the
    # frame s-axis follows the cycle direction
    frame_vs_cycle = np.where(s_is_next, 1.0, -1.0)
    return fq, frame_vs_cycle


class DofHandler3DHO(DofHandlerBase):
    """Order-p dof handler for one 3D form. Global numbering entity-major:
    H1 [verts | (k-1)/edge | (k-1)^2/face | (k-1)^3/cell],
    ND [(p+1)/edge | 2p(p+1)/face | 3p^2(p+1)/cell],
    RT [(p+1)^2/face | 3p(p+1)^2/cell], L2 [(p+1)^3/cell]."""

    def __init__(self, form, mesh, ents, p, frame_quads):
        self.form = form
        self.mesh = mesh
        self.ents = ents
        self.p = p
        self.dim = 3
        self.max_codim = 3 - form
        R = ref3(p)
        self.R = R
        ne = mesh.num_elements
        ned, nfc, nv = ents.num_edges, ents.num_faces, mesh.num_vertices
        if form == 0:
            self.n_edge, self.n_face, self.n_int = \
                R.nH1e, R.nH1f, R.nH1i
            self.off_e = nv
        elif form == 1:
            self.n_edge, self.n_face, self.n_int = \
                R.nNDe, R.nNDf, R.nNDi
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
        self.frame_quads = frame_quads
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

    def entity_dofs(self, codim):
        """Closure-dof tables; layouts match the batched local matrices:
        codim 0 = element reference blocks with GLOBAL content per block;
        codim 1 = face frame layout; codim 2 = [tail, head, edge nodes]."""
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
            fq, fe, frev = self._frame_edges()
            parts = []
            if form == 0:
                parts.append(fq)                      # 4 frame corners
                if self.n_edge:
                    parts.append(
                        self.edge_dofs()[fe].reshape(fe.shape[0], -1))
                parts.append(self.face_dofs())
            elif form == 1:
                parts.append(self.edge_dofs()[fe].reshape(fe.shape[0], -1))
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

    def _frame_edges(self):
        """Per face: frame corners (nf,4), frame edge ids in order
        [bottom(+s,t=0), right(+t,s=1), top(+s,t=1), left(+t,s=0)]
        (nf,4), and per frame edge whether the GLOBAL edge direction
        opposes the +frame axis (nf,4)."""
        if hasattr(self, "_fe_cache"):
            return self._fe_cache
        fq = self.frame_quads
        ends = np.stack([
            np.stack([fq[:, 0], fq[:, 1]], 1),    # bottom: (0,0)->(1,0)
            np.stack([fq[:, 1], fq[:, 2]], 1),    # right:  (1,0)->(1,1)
            np.stack([fq[:, 3], fq[:, 2]], 1),    # top:    (0,1)->(1,1)
            np.stack([fq[:, 0], fq[:, 3]], 1),    # left:   (0,0)->(0,1)
        ], axis=1)                                # (nf, 4, 2)
        lo = np.minimum(ends[..., 0], ends[..., 1])
        hi = np.maximum(ends[..., 0], ends[..., 1])
        nv = self.mesh.num_vertices
        gkeys = (self.ents.edges[:, 0].astype(np.int64) * nv
                 + self.ents.edges[:, 1])
        order = np.argsort(gkeys)
        pos = np.searchsorted(gkeys[order], lo.astype(np.int64) * nv + hi)
        fe = order[pos]
        rev = ends[..., 0] != lo                  # frame dir opposes global
        self._fe_cache = (fq, fe, rev)
        return self._fe_cache


class DeRhamSequence3DFE_HO(DeRhamSequence):
    """Arbitrary-order 3D de Rham sequence on a hex mesh (feorder >= 0)."""

    def __init__(self, topo, mesh, feorder=1):
        assert mesh.dim == 3 and mesh.kind == "hex", \
            "high-order 3D sequences are built on hex meshes"
        super().__init__(topo, 4)
        self.kind = "hex"
        self.mesh = mesh
        self.ents = topo.entities
        self.feorder = feorder
        self.R = ref3(feorder)
        self.frame_quads, self.frame_vs_cycle = _face_frames(self.ents)
        for j in range(4):
            self.dof[j] = DofHandler3DHO(j, mesh, self.ents, feorder,
                                         self.frame_quads)
        self._build_transforms()
        self._geometry()
        self._build_derivatives()
        self._assemble_local_mass()
        self.L2_const_rep = self._l2_dofs_of_one()

    # ------------------------------------------------------------------ #
    # per-(element, entity) signed-permutation transforms
    # ------------------------------------------------------------------ #
    def _build_transforms(self):
        """(pi, sigma) per element per space X in {h1, nd, rt}:
        global-layout values = sigma * local-reference values[pi]."""
        R, e, m = self.R, self.ents, self.mesh
        ne = m.num_elements
        # dihedral code per (element, local face): frame = g(local)
        local_quads = m.elements[:, HEX_FACES]            # (ne, 6, 4)
        frame_of = self.frame_quads[e.elem_face]          # (ne, 6, 4)
        self.face_codes = dihedral_code(local_quads, frame_of)
        edge_fwd = e.elem_edge_sign > 0                   # (ne, 12)

        def build(nloc, blocks):
            pi = np.tile(np.arange(nloc, dtype=np.int64), (ne, 1))
            sg = np.ones((ne, nloc))
            for off, nblk, kind, ts in blocks:
                if nblk == 0:
                    continue
                if kind == "edge":
                    # ts = (pi_rev, sg_rev) for the reversal transform
                    pr, sr = ts
                    for le in range(12):
                        o = off + le * nblk
                        fwd = edge_fwd[:, le]
                        pi[:, o:o + nblk] = np.where(
                            fwd[:, None], np.arange(nblk) + o,
                            pr[None, :] + o)
                        sg[:, o:o + nblk] = np.where(
                            fwd[:, None], 1.0, sr[None, :])
                else:                                     # face
                    P8 = np.stack([t[0] for t in ts])     # (8, nblk)
                    S8 = np.stack([t[1] for t in ts])
                    for lf in range(6):
                        o = off + lf * nblk
                        code = self.face_codes[:, lf]
                        pi[:, o:o + nblk] = P8[code] + o
                        sg[:, o:o + nblk] = S8[code]
            return pi, sg

        h1_face_ts = [_signed_perm_arrays(T) for T in R.T_h1] \
            if R.nH1f else []
        nd_face_ts = [_signed_perm_arrays(T) for T in R.T_nd] \
            if R.nNDf else []
        rt_face_ts = [_signed_perm_arrays(T) for T in R.T_rt] \
            if R.nRTf else []
        h1_rev = _signed_perm_arrays(R.T_h1_edge_rev) if R.nH1e else None
        nd_rev = _signed_perm_arrays(R.T_nd_edge_rev)

        self.S_h1 = build(R.nH1, [
            (8, R.nH1e, "edge", h1_rev),
            (8 + 12 * R.nH1e, R.nH1f, "face", h1_face_ts)])
        self.S_nd = build(R.nND, [
            (0, R.nNDe, "edge", nd_rev),
            (12 * R.nNDe, R.nNDf, "face", nd_face_ts)])
        self.S_rt = build(R.nRT, [
            (0, R.nRTf, "face", rt_face_ts)])
        self.S_l2 = (np.tile(np.arange(R.nL2, dtype=np.int64), (ne, 1)),
                     np.ones((ne, R.nL2)))

    def _S(self, form):
        return [self.S_h1, self.S_nd, self.S_rt, self.S_l2][form]

    # ------------------------------------------------------------------ #
    def _geometry(self):
        R = self.R
        ec = self.mesh.vertices[self.mesh.elements]       # (ne, 8, 3)
        self._ec = ec
        self.J = hexfe._jacobians(ec, R.q3)               # (ne, nq, 3, 3)
        self.detJ = hexfe._det3(self.J)
        assert (self.detJ > 0).all(), "inverted hex elements"
        self.Jinv = hexfe._inv3(self.J, self.detJ)
        self.qphys = np.einsum(
            "iq,nic->nqc", hexfe._q1_shapes(R.q3).T, ec)
        # face frame geometry (bilinear from frame-ordered corners)
        fcoords = self.mesh.vertices[self.frame_quads]    # (nf, 4, 3)
        self._fcoords = fcoords
        self.fX, self.fF = hexfe._face_param(fcoords, R.q2)
        G2 = np.einsum("fqca,fqcb->fqab", self.fF, self.fF)
        self.fW = np.sqrt(hexfe._det2(G2))
        self.fG2inv = hexfe._inv2(G2)
        rc = self.mesh.vertices[self.ents.edges]
        self.edge_vec = rc[:, 1] - rc[:, 0]
        self.edge_len = np.linalg.norm(self.edge_vec, axis=1)
        self._rc = rc

    # ------------------------------------------------------------------ #
    # derivatives: folded reference matrices, first-writer dedup
    # ------------------------------------------------------------------ #
    def _fold_blocks(self, Dref, S_out, S_in):
        """(ne, nout, nin) element blocks S_out Dref S_in^T."""
        po, so = S_out
        pin, sin = S_in
        blk = Dref[po[:, :, None], pin[:, None, :]]
        return blk * so[:, :, None] * sin[:, None, :]

    def _assemble_D(self, Dref, dof_out, dof_in, S_out, S_in):
        blk = self._fold_blocks(Dref, S_out, S_in)
        rows = np.asarray(dof_out.entity_dofs(0))
        cols = np.asarray(dof_in.entity_dofs(0))
        ne, nout, nin = blk.shape
        r = np.repeat(rows, nin, axis=1).ravel()
        c = np.tile(cols, (1, nout)).ravel()
        v = blk.reshape(ne, -1).ravel()
        # drop exact-zero structure noise, then FIRST-writer dedup: shared
        # rows (edge/face dofs) receive identical contributions from every
        # adjacent element (exact signed perms of the same Dref)
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

    def _build_derivatives(self):
        R = self.R
        self.D[0] = self._assemble_D(R.D0, self.dof[1], self.dof[0],
                                     self.S_nd, self.S_h1)
        self.D[1] = self._assemble_D(R.D1, self.dof[2], self.dof[1],
                                     self.S_rt, self.S_nd)
        self.D[2] = self._assemble_D(R.D2, self.dof[3], self.dof[2],
                                     self.S_l2, self.S_rt)

    # ------------------------------------------------------------------ #
    # local mass matrices, 10 (codim, form) slots
    # ------------------------------------------------------------------ #
    def _metric_mass(self, E, G, w):
        """M[n,i,j] = sum_{q,a,b} w[n,q] G[n,q,a,b] E[i,q,a] E[j,q,b]
        as one batched GEMM over the flattened (q, b) axis:
        T[n,i,(q,b)] = sum_a E[i,q,a] w[n,q] G[n,q,a,b], then T @ E^T,
        in chunks of cells that bound T to ~2^24 entries."""
        ne = G.shape[0]
        ndof, nq = E.shape[0], E.shape[1]
        WG = w[:, :, None, None] * G                      # (ne, nq, 3, 3)
        Ef = E.reshape(ndof, nq * 3)
        M = np.empty((ne, ndof, ndof))
        step = max(1, (1 << 24) // max(ndof * nq * 3, 1))
        for s in range(0, ne, step):
            W = WG[s:s + step]
            T = sum(E[None, :, :, a, None] * W[:, None, :, a, :]
                    for a in range(3))                    # (n, ndof, nq, 3)
            M[s:s + step] = T.reshape(-1, ndof, nq * 3) @ Ef.T
        return M

    def _fold_mass(self, M, S):
        pi, sg = S
        Mf = M[np.arange(M.shape[0])[:, None, None],
               pi[:, :, None], pi[:, None, :]]
        return Mf * sg[:, :, None] * sg[:, None, :]

    def _assemble_local_mass(self, elem_coeffs=None):
        R = self.R
        coeff = elem_coeffs or {}
        w0 = R.w3[None, :] * self.detJ

        def cw(form):
            c = coeff.get(form)
            return 1.0 if c is None else np.asarray(c)

        # ---- codim 0 ---- #
        N = R.h1_eval(R.q3)                               # (nH1, nq)
        w = w0 * cw(0)
        M0 = np.einsum("iq,nq,jq->nij", N, w, N, optimize=True)
        self.M[(0, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(0), self._fold_mass(M0, self.S_h1))

        E = R.nd_eval(R.q3)                               # (nND, nq, 3)
        Gcov = np.einsum("nqab,nqcb->nqac", self.Jinv, self.Jinv)
        M1 = self._metric_mass(E, Gcov, w0 * cw(1))
        self.M[(0, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(0), self._fold_mass(M1, self.S_nd))

        F = R.rt_eval(R.q3)                               # (nRT, nq, 3)
        Gpio = np.einsum("nqba,nqbc->nqac", self.J, self.J) \
            / (self.detJ ** 2)[:, :, None, None]
        M2 = self._metric_mass(F, Gpio, w0 * cw(2))
        self.M[(0, 2)] = LocalMass.from_uniform(
            self.dof[2].entity_dofs(0), self._fold_mass(M2, self.S_rt))

        L = R.l2_eval(R.q3)                               # (nL2, nq)
        w = R.w3[None, :] / self.detJ * cw(3)
        M3 = np.einsum("iq,nq,jq->nij", L, w, L, optimize=True)
        self.M[(0, 3)] = LocalMass.from_uniform(
            self.dof[3].entity_dofs(0), M3)

        self._assemble_trace_mass()

    def _assemble_trace_mass(self):
        R = self.R
        p, k = R.p, R.k
        nf = self.ents.num_faces
        w2 = R.w2[None, :]

        # ---- codim 1: H1 surface mass in the frame layout ---- #
        NH = self._h1_face_basis()                        # (nf, ndof, nq2)
        wW = w2 * self.fW
        M = np.einsum("fiq,fq,fjq->fij", NH, wW, NH, optimize=True)
        self.M[(1, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(1), M)

        # ---- codim 1: ND tangential trace mass ---- #
        EN = self._nd_face_basis()                        # (ndof, nq2, 2)
        sgn = self._nd_face_signs()                       # (nf, ndof)
        t = np.einsum("iqb,fqab->fiqa", EN, self.fG2inv)
        M = np.einsum("fiqa,fq,jqa->fij", t, wW, EN, optimize=True)
        M = M * sgn[:, :, None] * sgn[:, None, :]
        self.M[(1, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(1), M)

        # ---- codim 1: RT normal trace mass ---- #
        Ps = legendre_vals(p, R.q2[:, 0])
        Pt = legendre_vals(p, R.q2[:, 1])
        dual = np.stack(
            [Ps[a] * Pt[b] * (2 * a + 1) * (2 * b + 1)
             for b in range(p + 1) for a in range(p + 1)], axis=0)
        M = np.einsum("iq,fq,jq->fij", dual, w2 / self.fW, dual,
                      optimize=True)
        self.M[(1, 2)] = LocalMass.from_uniform(
            self.dof[2].entity_dofs(1), M)

        # ---- codim 2: edge masses (straight edges) ---- #
        nodes = np.concatenate([[0.0, 1.0], R.nodes1d[1:-1]])
        N1 = nodal_basis_1d(nodes, R.gx)
        M1d = np.einsum("q,iq,jq->ij", R.gw, N1, N1)
        self.M[(2, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(2),
            self.edge_len[:, None, None] * M1d[None])
        tr = np.diag(2.0 * np.arange(p + 1) + 1.0)
        self.M[(2, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(2),
            tr[None] / self.edge_len[:, None, None])

        # ---- codim 3 ---- #
        nv = self.mesh.num_vertices
        self.M[(3, 0)] = LocalMass.from_uniform(
            np.arange(nv)[:, None], np.ones((nv, 1, 1)))

    # ---------------- face trace bases (frame layout) ---------------- #
    def _h1_face_basis(self):
        """Q_k 2D nodal basis values at q2 in the facet table layout
        [4 corners | 4 frame-edge blocks (global order) | interior],
        per face (direction flips per frame edge)."""
        R = self.R
        k = R.k
        _, _, rev = self.dof[0]._frame_edges()            # (nf, 4)
        N1s = nodal_basis_1d(R.nodes1d, R.q2[:, 0])       # (k+1, nq2)
        N1t = nodal_basis_1d(R.nodes1d, R.q2[:, 1])
        nf = rev.shape[0]
        ndof = 4 + 4 * (k - 1) + (k - 1) ** 2
        # (is, it) index per dof; edge-block indices flip with rev
        base_is = [0, k, k, 0]
        base_it = [0, 0, k, k]
        inner = np.arange(1, k)
        IS = np.empty((nf, ndof), dtype=np.int64)
        IT = np.empty((nf, ndof), dtype=np.int64)
        IS[:, :4] = base_is
        IT[:, :4] = base_it
        o = 4
        nbe = k - 1
        # bottom (+s, t=0), right (+t, s=1), top (+s, t=1), left (+t, s=0)
        edge_axis = [("s", 0), ("t", k), ("s", k), ("t", 0)]
        for eidx, (ax, fixed) in enumerate(edge_axis):
            idx_fwd = inner
            idx_rev = inner[::-1]
            var = np.where(rev[:, eidx][:, None], idx_rev[None, :],
                           idx_fwd[None, :])
            if ax == "s":
                IS[:, o:o + nbe] = var
                IT[:, o:o + nbe] = fixed
            else:
                IS[:, o:o + nbe] = fixed
                IT[:, o:o + nbe] = var
            o += nbe
        grid_s, grid_t = np.meshgrid(inner, inner, indexing="xy")
        IS[:, o:] = grid_s.reshape(-1)[None, :]
        IT[:, o:] = grid_t.reshape(-1)[None, :]
        return N1s[IS] * N1t[IT]                          # (nf, ndof, nq2)

    def _nd_face_basis(self):
        """Canonical 2D ND_p basis (space Q_{p,k} x Q_{k,p}) on the unit
        square at q2, layout [4 frame-edge moment blocks (+frame dirs) |
        face moments] -> (ndof, nq2, 2). Per-face edge-direction parities
        are applied separately (signed diagonal)."""
        R = self.R
        if hasattr(self, "_ndf_cache"):
            return self._ndf_cache
        p, k = R.p, R.k
        gx, gw = R.gx, R.gw
        q2, w2 = R.q2, R.w2
        P1 = legendre_vals(p, gx)
        Ps = legendre_vals(p, q2[:, 0])
        Pt = legendre_vals(p, q2[:, 1])
        monos = ([(0, i, j) for i in range(p + 1) for j in range(k + 1)]
                 + [(1, i, j) for i in range(k + 1) for j in range(p + 1)])
        ndof = len(monos)
        assert ndof == 4 * (p + 1) + 2 * p * (p + 1)
        PL = [legendre_vals(k, gx), legendre_vals(k, q2[:, 0]),
              legendre_vals(k, q2[:, 1])]

        def mono_vals(pts_s, pts_t):
            Pa = legendre_vals(k, pts_s)
            Pb = legendre_vals(k, pts_t)
            out = np.zeros((ndof, pts_s.size, 2))
            for m, (c, i, j) in enumerate(monos):
                out[m, :, c] = Pa[i] * Pb[j]
            return out

        # dof matrix: edges [bottom(+s,t=0), right(+t,s=1), top(+s,t=1),
        # left(+t,s=0)], each p+1 tangential moments; then face moments
        # (s-comp against Q_{p,p-1}, t against Q_{p-1,p})
        edge_pts = [
            (gx, np.zeros_like(gx), 0), (np.ones_like(gx), gx, 1),
            (gx, np.ones_like(gx), 0), (np.zeros_like(gx), gx, 1)]
        V = np.zeros((ndof, ndof))
        pos = 0
        for (es, et, comp) in edge_pts:
            vals = mono_vals(es, et)[:, :, comp]          # (ndof, nq1)
            for j in range(p + 1):
                V[pos] = vals @ (gw * P1[j])
                pos += 1
        fvals = mono_vals(q2[:, 0], q2[:, 1])
        for a in range(p + 1):
            for b in range(p):
                V[pos] = fvals[:, :, 0] @ (w2 * Ps[a] * Pt[b])
                pos += 1
        for a in range(p):
            for b in range(p + 1):
                V[pos] = fvals[:, :, 1] @ (w2 * Ps[a] * Pt[b])
                pos += 1
        assert pos == ndof
        coeff = np.linalg.inv(V.T)
        basis = np.einsum("im,mqa->iqa", coeff, fvals)
        self._ndf_cache = basis
        return basis

    def _nd_face_signs(self):
        """(nf, ndof) signs: edge-moment parity when the global edge
        direction opposes the +frame axis; +1 on face moments."""
        R = self.R
        p = R.p
        _, _, rev = self.dof[1]._frame_edges()
        nf = rev.shape[0]
        j = np.arange(p + 1)
        par = (-1.0) ** (j + 1)
        sgn = np.ones((nf, 4 * (p + 1) + R.nNDf))
        for eidx in range(4):
            o = eidx * (p + 1)
            sgn[:, o:o + p + 1] = np.where(
                rev[:, eidx][:, None], par[None, :], 1.0)
        return sgn

    # ------------------------------------------------------------------ #
    def replace_mass_integrator(self, form, coeff_fn):
        """Codim-0 coefficient replacement (DeRhamSequenceFE.hpp:101);
        trace masses keep unit coefficient like the reference examples."""
        vals = np.asarray(coeff_fn(self.qphys))
        self._coeffs = getattr(self, "_coeffs", {})
        self._coeffs[form] = vals
        self._assemble_local_mass(self._coeffs)

    # ------------------------------------------------------------------ #
    # interpolation / targets
    # ------------------------------------------------------------------ #
    def h1_node_coords(self):
        R = self.R
        m = self.mesh
        verts = m.vertices
        tn = R.nodes1d[1:-1]
        rc = self._rc
        edge_nodes = (rc[:, 0][:, None, :] + tn[None, :, None]
                      * self.edge_vec[:, None, :]).reshape(-1, 3)
        k = R.k
        if k > 1:
            fq2 = np.array([[R.nodes1d[i], R.nodes1d[j]]
                            for j in range(1, k) for i in range(1, k)])
            fX, _ = hexfe._face_param(self._fcoords, fq2)
            face_nodes = fX.reshape(-1, 3)
            iq = np.array([[R.nodes1d[i], R.nodes1d[j], R.nodes1d[l]]
                           for l in range(1, k) for j in range(1, k)
                           for i in range(1, k)])
            Ni = hexfe._q1_shapes(iq)
            int_nodes = np.einsum(
                "qi,nic->nqc", Ni, self._ec).reshape(-1, 3)
        else:
            face_nodes = np.zeros((0, 3))
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
            dens = np.asarray(f(self.qphys)) * self.detJ
            cols.append(R.l2_dofs(dens).reshape(-1))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[3].ndofs, 0)))

    def _edge_moment_pts(self):
        R = self.R
        rc = self._rc
        return (rc[:, 0][:, None, :]
                + R.gx[None, :, None] * self.edge_vec[:, None, :])

    def interpolate_vector_targets(self, jform, fns):
        R = self.R
        p = R.p
        cols = []
        Ps = legendre_vals(p, R.q2[:, 0])
        Pt = legendre_vals(p, R.q2[:, 1])
        if jform == 1:
            epts = self._edge_moment_pts()
            P1 = legendre_vals(p, R.gx)
            Fs, Ft = self.fF[..., 0], self.fF[..., 1]
            # interior: covariant pullback J^T u at q3
            q3tests = self._nd_int_tests()
            for f in fns:
                ve = np.asarray(f(epts))                  # (ned, nq1, 3)
                circ = np.einsum("eqc,ec->eq", ve, self.edge_vec)
                mom_e = np.einsum("eq,jq,q->ej", circ, P1, R.gw)
                vf = np.asarray(f(self.fX))               # (nf, nq2, 3)
                us = np.einsum("fqc,fqc->fq", vf, Fs)
                ut = np.einsum("fqc,fqc->fq", vf, Ft)
                mom_f = self._nd_face_moments(us, ut, Ps, Pt)
                vq = np.asarray(f(self.qphys))            # (ne, nq3, 3)
                uhat = np.einsum("nqab,nqa->nqb", self.J, vq)
                mom_i = np.einsum("nqa,iqa->ni", uhat, q3tests)
                cols.append(np.concatenate(
                    [mom_e.reshape(-1), mom_f.reshape(-1),
                     mom_i.reshape(-1)]))
            return (np.stack(cols, axis=1) if fns
                    else np.zeros((self.dof[1].ndofs, 0)))
        assert jform == 2
        nrm = np.cross(self.fF[..., 0], self.fF[..., 1])  # (nf, nq2, 3)
        q3tests = self._rt_int_tests()
        for f in fns:
            vf = np.asarray(f(self.fX))
            flux = np.einsum("fqc,fqc->fq", vf, nrm)
            mom_f = np.stack(
                [np.einsum("fq,q->f", flux * Ps[a] * Pt[b], R.w2)
                 for b in range(p + 1) for a in range(p + 1)], axis=1)
            vq = np.asarray(f(self.qphys))
            uhat = np.einsum("nq,nqab,nqb->nqa", self.detJ, self.Jinv, vq)
            mom_i = np.einsum("nqa,iqa->ni", uhat, q3tests)
            cols.append(np.concatenate(
                [mom_f.reshape(-1), mom_i.reshape(-1)]))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[2].ndofs, 0)))

    def _nd_face_moments(self, us, ut, Ps, Pt):
        R = self.R
        p = R.p
        moms = []
        for a in range(p + 1):
            for b in range(p):
                moms.append(np.einsum("fq,q->f", us * Ps[a] * Pt[b], R.w2))
        for a in range(p):
            for b in range(p + 1):
                moms.append(np.einsum("fq,q->f", ut * Ps[a] * Pt[b], R.w2))
        return (np.stack(moms, axis=1) if moms
                else np.zeros((us.shape[0], 0)))

    def _nd_int_tests(self):
        """(nNDi, nq3, 3) interior test fields x quadrature weights."""
        R = self.R
        p = R.p
        if hasattr(self, "_ndt_cache"):
            return self._ndt_cache
        P3 = [legendre_vals(p, R.q3[:, d]) for d in range(3)]
        tests = []
        for comp in range(3):
            degs = [p - 1, p - 1, p - 1]
            degs[comp] = p
            for lz in range(degs[2] + 1):
                for ly in range(degs[1] + 1):
                    for lx in range(degs[0] + 1):
                        t = np.zeros((R.q3.shape[0], 3))
                        t[:, comp] = (R.w3 * P3[0][lx] * P3[1][ly]
                                      * P3[2][lz])
                        tests.append(t)
        self._ndt_cache = (np.stack(tests, axis=0) if tests
                           else np.zeros((0, R.q3.shape[0], 3)))
        return self._ndt_cache

    def _rt_int_tests(self):
        R = self.R
        p = R.p
        if hasattr(self, "_rtt_cache"):
            return self._rtt_cache
        P3 = [legendre_vals(p, R.q3[:, d]) for d in range(3)]
        tests = []
        for comp in range(3):
            degs = [p, p, p]
            degs[comp] = p - 1
            for lz in range(degs[2] + 1):
                for ly in range(degs[1] + 1):
                    for lx in range(degs[0] + 1):
                        t = np.zeros((R.q3.shape[0], 3))
                        t[:, comp] = (R.w3 * P3[0][lx] * P3[1][ly]
                                      * P3[2][lz])
                        tests.append(t)
        self._rtt_cache = (np.stack(tests, axis=0) if tests
                           else np.zeros((0, R.q3.shape[0], 3)))
        return self._rtt_cache

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

    # ------------------------------------------------------------------ #
    def element_volumes(self):
        return (self.R.w3[None, :] * self.detJ).sum(axis=1)

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
            w = R.w3[None, :] * self.detJ
            N = R.h1_eval(R.q3)                           # (nH1, nq)
            vals = np.einsum("nq,iq->ni", w * f, N)
            pi, sg = self.S_h1
            # global dof value b_g = sum over elements of sigma * local:
            # functional transforms like the dofs (S orthogonal)
            vals = np.take_along_axis(vals, pi, axis=1) * sg
            np.add.at(b, self.dof[0].entity_dofs(0).ravel(), vals.ravel())
            # shared dofs were added once per adjacent element: the lf is
            # a sum of element integrals, so that is correct (no dedup)
        elif jform == 3:
            dens = f * self.detJ
            vals = R.l2_dofs(dens)
            b[self.dof[3].entity_dofs(0).ravel()] = vals.ravel()
        else:
            raise ValueError(jform)
        return b

    def boundary_rhs_ho(self, form, attr_values):
        """Natural-BC linear form (BoundaryLFIntegrator /
        VectorFEBoundaryFluxLFIntegrator analogs) at any order:
        form 0: sum_a v_a int_{bdr_a} phi_i dA over the Q_k surface basis;
        form 2: sum_a v_a int_{bdr_a} phi_i . n_out dA — only the constant
        flux moment is nonzero (Legendre orthogonality)."""
        from parelag_tpu_torch.mesh.entities import bdr_face_ids
        R = self.R
        mesh, ents = self.mesh, self.ents
        b = np.zeros(self.dof[form].ndofs)
        fids = bdr_face_ids(mesh, ents)
        B0t = ents.B0.T.tocsr()
        battrs = np.asarray(mesh.bdr_attrib)
        NH = None
        for attr, val in attr_values.items():
            sel = np.where(battrs == attr)[0]
            if sel.size == 0:
                continue
            f = fids[sel]
            out_sign = B0t.data[B0t.indptr[f]]
            if form == 2:
                f0 = self.dof[2].face_dofs()[f, 0]
                np.add.at(b, f0, val * out_sign
                          * self.frame_vs_cycle[f])
                continue
            assert form == 0
            if NH is None:
                NH = self._h1_face_basis()
            wW = R.w2[None, :] * self.fW[f]
            vals = val * np.einsum("fiq,fq->fi", NH[f], wW)
            tab = self.dof[0].entity_dofs(1)[f]
            np.add.at(b, tab.ravel(), vals.ravel())
        return b

    # ------------------------------------------------------------------ #
    # PV traces (computePVTraces analogs)
    # ------------------------------------------------------------------ #
    def compute_pv_traces(self, codim) -> np.ndarray:
        jform = 3 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        coo = AE_e.tocoo()
        if codim == 0:            # L2: dofs of the constant 1 per AE
            one = self.L2_const_rep
            d = self.dof[3]
            ids = d.int_dofs()[coo.col]
            pv[ids.reshape(-1)] = np.repeat(
                coo.data, d.n_int) * one[ids.reshape(-1)]
        elif codim == 1:          # Hdiv: constant-flux field, frame normal
            areas = (self.R.w2[None, :] * self.fW).sum(axis=1)
            f0 = self.dof[2].face_dofs()[coo.col, 0]
            # AE orientation data is relative to the stored B0 cycle;
            # fold the frame-vs-cycle sign
            pv[f0] = coo.data * self.frame_vs_cycle[coo.col] \
                * areas[coo.col]
        elif codim == 2:          # Hcurl: constant-circulation field
            e0 = self.dof[1].edge_dofs()[coo.col, 0]
            pv[e0] = coo.data * self.edge_len[coo.col]
        else:                     # H1 vertex picks
            pv[AE_e.indices] = 1.0
        return pv
