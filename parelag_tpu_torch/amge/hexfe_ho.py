"""Arbitrary-order reference machinery on the hexahedron (feorder = p >= 0).

The 3D extension of the fespace2d_ho exterior-calculus dof design
(reference: MFEM-order-generic local assembly in
src/amge/DeRhamSequenceFE.cpp:83-310 and the order parameter threading of
DeRhamSequenceFE.hpp:58-310). Spaces on the reference cube [0,1]^3:

  H1    = Q_k                                    k = p + 1 (nodal, GL pts)
  Hcurl = ND_p = Q_{p,k,k} x Q_{k,p,k} x Q_{k,k,p}   (tangential moments)
  Hdiv  = RT_p = Q_{k,p,p} x Q_{p,k,p} x Q_{p,p,k}   (flux moments)
  L2    = Q_p                                    (density moments)

All dofs are nodal values or Legendre moments over entities, so with the
form-appropriate pullbacks (composition / covariant / Piola / density) the
derivative matrices D0 (grad), D1 (curl), D2 (div) are GEOMETRY-INDEPENDENT
rational matrices — the higher-order generalization of the +-1 incidence
tables — and every global<->local orientation transform is a SIGNED
PERMUTATION: edge reversal with Legendre parity, and one of the 8 dihedral
face transforms. Geometry lives only in the (batched) mass matrices.

Local reference layouts (the element "reference frame"):
  H1 : [8 corners] [per local edge: k-1 nodes along the local edge
       direction] [per local face: (k-1)^2 nodes, s-fastest in the LOCAL
       face frame] [(k-1)^3 interior, x-fastest]
  ND : [per local edge: p+1 moments int u.t P_j(s) ds, local direction]
       [per local face: 2p(p+1) covariant tangential moments: s-component
       against Q_{p,p-1}(s,t), then t against Q_{p-1,p}] [interior
       3p^2(p+1): comp c against full degree p along c, p-1 transverse]
  RT : [per local face: (p+1)^2 flux moments against P_i(s)P_j(t), OUTWARD
       normal, i fastest] [interior 3p(p+1)^2: comp c against degree p-1
       along c, p transverse]
  L2 : [(p+1)^3 Legendre density moments, x-fastest]

The LOCAL face frame of local face f (HEX_FACES outward cycle v0..v3):
origin v0, s-axis v0->v1, t-axis v0->v3, so s x t = the outward normal.
Dof functionals are stored as one linear map L (ndof, npts, 3 or 1) over a
fixed concatenated quadrature point set, so applying all dofs to a batch of
fields is a single einsum.
"""

import numpy as np

from parelag_tpu_torch.mesh.mesh import HEX_EDGES, HEX_FACES
from parelag_tpu_torch.amge.hexfe import HEX_CORNERS
from parelag_tpu_torch.amge.fespace2d_ho import (
    gauss_points, lobatto_points, legendre_vals, nodal_basis_1d,
    nodal_dbasis_1d)


def legendre_dvals(p, x):
    """d/dx of shifted Legendre P_0..P_p on [0,1]: P'_n = P'_{n-2}
    + (2n-1) P_{n-1} (in t = 2x-1), times the chain factor 2."""
    P = legendre_vals(p, x)
    out = [np.zeros_like(P[0])]
    if p >= 1:
        out.append(2.0 * np.ones_like(P[0]))
    for n in range(2, p + 1):
        out.append(out[n - 2] + 2.0 * (2 * n - 1) * P[n - 1])
    return np.stack(out, axis=0)


# The 8 dihedral transforms of the unit square, encoded as x' = A x + b
# with A a signed permutation. index = swap*4 + fs*2 + ft (swap first,
# then flip each target axis).
def _dihedral_maps():
    maps = []
    for swap in (0, 1):
        for fs in (0, 1):
            for ft in (0, 1):
                A = np.array([[0.0, 1.0], [1.0, 0.0]]) if swap \
                    else np.eye(2)
                A = np.diag([1.0 - 2 * fs, 1.0 - 2 * ft]) @ A
                b = np.array([float(fs), float(ft)])
                maps.append((A, b))
    return maps


DIHEDRAL = _dihedral_maps()


def dihedral_code(local_quad, frame_quad):
    """Code g with frame_coords = g(local_coords): both args list the same
    4 vertex ids, at positions (0,0),(1,0),(1,1),(0,1) of their respective
    frames. Vectorized over leading dims: (..., 4) -> (...)."""
    lq = np.asarray(local_quad)
    fq = np.asarray(frame_quad)
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    pos = np.argmax(lq[..., :, None] == fq[..., None, :], axis=-1)
    if not np.all(np.take_along_axis(fq, pos, axis=-1) == lq):
        raise ValueError("faces do not share the same corner set")
    target = corners[pos]                     # (..., 4, 2) frame coords
    codes = np.full(lq.shape[:-1], -1, dtype=np.int64)
    for g, (A, b) in enumerate(DIHEDRAL):
        mapped = corners @ A.T + b
        hit = np.all(np.abs(target - mapped) < 1e-12, axis=(-2, -1))
        codes = np.where(hit, g, codes)
    assert np.all(codes >= 0), "no dihedral transform matches"
    return codes


def _round_signed_perm(T, tol=1e-9):
    """Snap a numerically computed signed permutation to exact +-1/0."""
    if T.size == 0:
        return T
    out = np.where(np.abs(T) > 0.5, np.sign(T), 0.0)
    assert np.abs(T - out).max() < tol, "transform is not a signed perm"
    assert (np.abs(out).sum(axis=1) == 1).all()
    assert (np.abs(out).sum(axis=0) == 1).all()
    return out


_REF3_CACHE = {}


class _Ref3:
    """All order-p reference data on the unit cube."""

    def __init__(self, p):
        self.p = p
        k = p + 1
        self.k = k
        nq1 = p + 3
        gx, gw = gauss_points(nq1)
        self.gx, self.gw = gx, gw
        self.nq1 = nq1
        QX, QY, QZ = np.meshgrid(gx, gx, gx, indexing="ij")
        self.q3 = np.stack([QX.ravel(), QY.ravel(), QZ.ravel()], axis=1)
        self.w3 = (gw[:, None, None] * gw[None, :, None]
                   * gw[None, None, :]).ravel()
        QS, QT = np.meshgrid(gx, gx, indexing="ij")
        self.q2 = np.stack([QS.ravel(), QT.ravel()], axis=1)
        self.w2 = np.outer(gw, gw).ravel()
        self.nodes1d = lobatto_points(k)

        # dof counts
        self.nH1e, self.nH1f, self.nH1i = k - 1, (k - 1) ** 2, (k - 1) ** 3
        self.nNDe, self.nNDf = p + 1, 2 * p * (p + 1)
        self.nNDi = 3 * p * p * (p + 1)
        self.nRTf, self.nRTi = (p + 1) ** 2, 3 * p * (p + 1) ** 2
        self.nL2 = (p + 1) ** 3
        self.nH1 = 8 + 12 * self.nH1e + 6 * self.nH1f + self.nH1i
        self.nND = 12 * self.nNDe + 6 * self.nNDf + self.nNDi
        self.nRT = 6 * self.nRTf + self.nRTi
        assert self.nND == 3 * (p + 1) * (p + 2) ** 2
        assert self.nRT == 3 * (p + 1) ** 2 * (p + 2)

        self._build_entity_frames()
        self._build_dof_maps()
        self._build_h1()
        self._build_nd()
        self._build_rt()
        self._build_l2()
        self._build_derivs()
        self._build_face_transforms()

    # ---------------- local entity frames ---------------- #
    def _build_entity_frames(self):
        self.edge_start = HEX_CORNERS[HEX_EDGES[:, 0]]
        self.edge_dir = (HEX_CORNERS[HEX_EDGES[:, 1]]
                         - HEX_CORNERS[HEX_EDGES[:, 0]])
        fc = HEX_CORNERS[HEX_FACES]                      # (6, 4, 3)
        self.face_origin = fc[:, 0]
        self.face_s = fc[:, 1] - fc[:, 0]
        self.face_t = fc[:, 3] - fc[:, 0]
        self.face_n = np.cross(self.face_s, self.face_t)

    def face_points(self, f, q2):
        q2 = np.asarray(q2)
        return (self.face_origin[f][None, :]
                + q2[:, 0:1] * self.face_s[f][None, :]
                + q2[:, 1:2] * self.face_t[f][None, :])

    def edge_points(self, e, x):
        return (self.edge_start[e][None, :]
                + np.asarray(x)[:, None] * self.edge_dir[e][None, :])

    # ---------------- dof functionals as one linear map ------------- #
    def _build_dof_maps(self):
        """Point set P (npts, 3) = [12 edges x nq1 | 6 faces x nq2 | q3]
        and linear maps nd_L (nND, npts, 3) / rt_L (nRT, npts, 3) with
        dof_i(u) = sum_{q,a} L[i,q,a] u(P_q)_a."""
        p = self.p
        gx, gw = self.gx, self.gw
        nq1, nq2, nq3 = gx.size, self.q2.shape[0], self.q3.shape[0]
        pts = ([self.edge_points(e, gx) for e in range(12)]
               + [self.face_points(f, self.q2) for f in range(6)]
               + [self.q3])
        self.dof_pts = np.concatenate(pts, axis=0)
        off_f = 12 * nq1
        off_v = off_f + 6 * nq2
        npts = self.dof_pts.shape[0]

        P1 = legendre_vals(p, gx)                        # (p+1, nq1)
        P2s = legendre_vals(p, self.q2[:, 0])
        P2t = legendre_vals(p, self.q2[:, 1])
        P3 = [legendre_vals(p, self.q3[:, d]) for d in range(3)]

        nd_L = np.zeros((self.nND, npts, 3))
        pos = 0
        for e in range(12):
            sl = slice(e * nq1, (e + 1) * nq1)
            for j in range(p + 1):
                nd_L[pos, sl, :] = (gw * P1[j])[:, None] \
                    * self.edge_dir[e][None, :]
                pos += 1
        # face tests (Monk Thm 6.5 via u x n): s-component against
        # Q_{p,p-1}(s,t) — full degree ALONG its own direction, reduced
        # transverse — t-component against Q_{p-1,p}
        for f in range(6):
            sl = slice(off_f + f * nq2, off_f + (f + 1) * nq2)
            for a in range(p + 1):
                for b in range(p):
                    nd_L[pos, sl, :] = (self.w2 * P2s[a] * P2t[b])[
                        :, None] * self.face_s[f][None, :]
                    pos += 1
            for a in range(p):
                for b in range(p + 1):
                    nd_L[pos, sl, :] = (self.w2 * P2s[a] * P2t[b])[
                        :, None] * self.face_t[f][None, :]
                    pos += 1
        for comp in range(3):
            degs = [p - 1, p - 1, p - 1]
            degs[comp] = p
            for lz in range(degs[2] + 1):
                for ly in range(degs[1] + 1):
                    for lx in range(degs[0] + 1):
                        nd_L[pos, off_v:, comp] = (
                            self.w3 * P3[0][lx] * P3[1][ly] * P3[2][lz])
                        pos += 1
        assert pos == self.nND
        self.nd_L = nd_L

        rt_L = np.zeros((self.nRT, npts, 3))
        pos = 0
        for f in range(6):
            sl = slice(off_f + f * nq2, off_f + (f + 1) * nq2)
            for b in range(p + 1):
                for a in range(p + 1):
                    rt_L[pos, sl, :] = (self.w2 * P2s[a] * P2t[b])[
                        :, None] * self.face_n[f][None, :]
                    pos += 1
        for comp in range(3):
            degs = [p, p, p]
            degs[comp] = p - 1
            for lz in range(degs[2] + 1):
                for ly in range(degs[1] + 1):
                    for lx in range(degs[0] + 1):
                        rt_L[pos, off_v:, comp] = (
                            self.w3 * P3[0][lx] * P3[1][ly] * P3[2][lz])
                        pos += 1
        assert pos == self.nRT
        self.rt_L = rt_L

    def nd_dofs(self, fields):
        """fields (..., npts, 3) -> (..., nND)."""
        return np.einsum("iqa,...qa->...i", self.nd_L, fields)

    def rt_dofs(self, fields):
        return np.einsum("iqa,...qa->...i", self.rt_L, fields)

    # ---------------- H1 ---------------- #
    def _build_h1(self):
        k = self.k
        nodes = self.nodes1d
        idx = [tuple(int(c) * k for c in corner) for corner in HEX_CORNERS]

        def node_index(xyz):
            return tuple(int(np.argmin(np.abs(nodes - c))) for c in xyz)

        for e in range(12):
            for t in nodes[1:-1]:
                idx.append(node_index(self.edge_points(e, [t])[0]))
        for f in range(6):
            for jt in range(1, k):
                for js in range(1, k):
                    idx.append(node_index(self.face_points(
                        f, np.array([[nodes[js], nodes[jt]]]))[0]))
        for iz in range(1, k):
            for iy in range(1, k):
                for ix in range(1, k):
                    idx.append((ix, iy, iz))
        assert len(idx) == self.nH1
        self.h1_idx = np.array(idx)
        self.h1_node_coords = self.nodes1d[self.h1_idx]      # (nH1, 3)

    def h1_eval(self, pts):
        """H1 basis values at pts -> (nH1, npts)."""
        N = [nodal_basis_1d(self.nodes1d, pts[:, d]) for d in range(3)]
        i = self.h1_idx
        return N[0][i[:, 0]] * N[1][i[:, 1]] * N[2][i[:, 2]]

    def h1_grad(self, pts):
        """Gradients -> (nH1, npts, 3)."""
        N = [nodal_basis_1d(self.nodes1d, pts[:, d]) for d in range(3)]
        dN = [nodal_dbasis_1d(self.nodes1d, pts[:, d]) for d in range(3)]
        i = self.h1_idx
        gx = dN[0][i[:, 0]] * N[1][i[:, 1]] * N[2][i[:, 2]]
        gy = N[0][i[:, 0]] * dN[1][i[:, 1]] * N[2][i[:, 2]]
        gz = N[0][i[:, 0]] * N[1][i[:, 1]] * dN[2][i[:, 2]]
        return np.stack([gx, gy, gz], axis=-1)

    # ---------------- Legendre-product vector fields --------------- #
    # (c, i, j, l) = component c, field e_c P_i(x) P_j(y) P_l(z): far
    # better conditioned than monomials, so the dof matrices invert to
    # near machine precision at any practical order.
    @staticmethod
    def _mono_vals(monos, pts):
        """(nmono, npts, 3) values of component Legendre-product fields."""
        pmax = max(max(i, j, l) for (_, i, j, l) in monos)
        P = [legendre_vals(pmax, pts[:, d]) for d in range(3)]
        out = np.zeros((len(monos), pts.shape[0], 3))
        for m, (c, i, j, l) in enumerate(monos):
            out[m, :, c] = P[0][i] * P[1][j] * P[2][l]
        return out

    @staticmethod
    def _mono_curls(monos, pts):
        pmax = max(max(i, j, l) for (_, i, j, l) in monos)
        P = [legendre_vals(pmax, pts[:, d]) for d in range(3)]
        dP = [legendre_dvals(pmax, pts[:, d]) for d in range(3)]
        out = np.zeros((len(monos), pts.shape[0], 3))
        for m, (c, i, j, l) in enumerate(monos):
            deg = (i, j, l)
            grad = np.stack(
                [(dP[0][i] if d == 0 else P[0][i])
                 * (dP[1][j] if d == 1 else P[1][j])
                 * (dP[2][l] if d == 2 else P[2][l]) for d in range(3)],
                axis=1)
            del deg
            e = np.zeros(3)
            e[c] = 1.0
            out[m] = np.cross(grad, e[None, :])
        return out

    @staticmethod
    def _mono_divs(monos, pts):
        pmax = max(max(i, j, l) for (_, i, j, l) in monos)
        P = [legendre_vals(pmax, pts[:, d]) for d in range(3)]
        dP = [legendre_dvals(pmax, pts[:, d]) for d in range(3)]
        out = np.zeros((len(monos), pts.shape[0]))
        for m, (c, i, j, l) in enumerate(monos):
            f = [P[0][i], P[1][j], P[2][l]]
            f[c] = [dP[0][i], dP[1][j], dP[2][l]][c]
            out[m] = f[0] * f[1] * f[2]
        return out

    # ---------------- ND ---------------- #
    def _build_nd(self):
        p, k = self.p, self.k
        self.nd_monos = (
            [(0, i, j, l) for i in range(p + 1)
             for j in range(k + 1) for l in range(k + 1)]
            + [(1, i, j, l) for i in range(k + 1)
               for j in range(p + 1) for l in range(k + 1)]
            + [(2, i, j, l) for i in range(k + 1)
               for j in range(k + 1) for l in range(p + 1)])
        assert len(self.nd_monos) == self.nND
        # V[m, i] = dof_i(mono_m); basis coeffs C with C @ V = I
        V = self.nd_dofs(self._mono_vals(self.nd_monos, self.dof_pts))
        self.nd_coeff = np.linalg.inv(V)         # (nND basis, nmono)

    def nd_eval(self, pts):
        vals = self._mono_vals(self.nd_monos, pts)
        return np.einsum("im,mqa->iqa", self.nd_coeff, vals)

    def nd_curl_eval(self, pts):
        curls = self._mono_curls(self.nd_monos, pts)
        return np.einsum("im,mqa->iqa", self.nd_coeff, curls)

    # ---------------- RT ---------------- #
    def _build_rt(self):
        p, k = self.p, self.k
        self.rt_monos = (
            [(0, i, j, l) for i in range(k + 1)
             for j in range(p + 1) for l in range(p + 1)]
            + [(1, i, j, l) for i in range(p + 1)
               for j in range(k + 1) for l in range(p + 1)]
            + [(2, i, j, l) for i in range(p + 1)
               for j in range(p + 1) for l in range(k + 1)])
        assert len(self.rt_monos) == self.nRT
        V = self.rt_dofs(self._mono_vals(self.rt_monos, self.dof_pts))
        self.rt_coeff = np.linalg.inv(V)

    def rt_eval(self, pts):
        vals = self._mono_vals(self.rt_monos, pts)
        return np.einsum("im,mqa->iqa", self.rt_coeff, vals)

    def rt_div_eval(self, pts):
        divs = self._mono_divs(self.rt_monos, pts)
        return np.einsum("im,mq->iq", self.rt_coeff, divs)

    # ---------------- L2 ---------------- #
    def _build_l2(self):
        p = self.p
        self.l2_triples = [(i, j, l) for l in range(p + 1)
                           for j in range(p + 1) for i in range(p + 1)]
        self.l2_norm2 = np.array(
            [1.0 / ((2 * i + 1) * (2 * j + 1) * (2 * l + 1))
             for (i, j, l) in self.l2_triples])

    def l2_dofs(self, dens):
        """Density values at q3 (..., nq3) -> moments (..., nL2)."""
        P3 = [legendre_vals(self.p, self.q3[:, d]) for d in range(3)]
        T = np.stack([P3[0][i] * P3[1][j] * P3[2][l]
                      for (i, j, l) in self.l2_triples], axis=0)
        return np.einsum("iq,...q->...i", T * self.w3[None, :], dens)

    def l2_eval(self, pts):
        """Dual L2 basis (densities) at pts -> (nL2, npts)."""
        P3 = [legendre_vals(self.p, pts[:, d]) for d in range(3)]
        return np.stack(
            [P3[0][i] * P3[1][j] * P3[2][l] / self.l2_norm2[m]
             for m, (i, j, l) in enumerate(self.l2_triples)], axis=0)

    # ---------------- derivative matrices ---------------- #
    def _build_derivs(self):
        # D0[nd, h1]: ND dofs of grad(H1 basis) — exact: grad Q_k in ND_p
        self.D0 = self.nd_dofs(self.h1_grad(self.dof_pts)).T
        # D1[rt, nd]: RT dofs of curl(ND basis)
        self.D1 = self.rt_dofs(self.nd_curl_eval(self.dof_pts)).T
        # D2[l2, rt]: L2 moments of div(RT basis)
        self.D2 = self.l2_dofs(self.rt_div_eval(self.q3)).T

    # ---------------- face dof transforms (8 dihedral codes) --------- #
    def _build_face_transforms(self):
        """T with m_frame = T @ m_local when frame = g(local) — exact
        signed permutations snapped from quadrature."""
        p = self.p
        q2, w2 = self.q2, self.w2
        Ps = legendre_vals(p, q2[:, 0])
        Pt = legendre_vals(p, q2[:, 1])
        nodes = self.nodes1d[1:-1]
        self.T_rt, self.T_nd, self.T_h1 = [], [], []
        rt_pairs = [(a, b) for b in range(p + 1) for a in range(p + 1)]
        nd_tests = ([(0, a, b) for a in range(p + 1) for b in range(p)]
                    + [(1, a, b) for a in range(p) for b in range(p + 1)])
        for (A, b0) in DIHEDRAL:
            det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
            g = q2 @ A.T + b0[None, :]
            Pgs = legendre_vals(p, g[:, 0])
            Pgt = legendre_vals(p, g[:, 1])

            # RT: scalar flux density; frame normal flips with det(A)
            T = np.zeros((self.nRTf, self.nRTf))
            for mi, (a2, b2) in enumerate(rt_pairs):
                dual = Ps[a2] * Pt[b2] * (2 * a2 + 1) * (2 * b2 + 1)
                for gi, (ai, bj) in enumerate(rt_pairs):
                    T[gi, mi] = det * np.sum(w2 * dual * Pgs[ai] * Pgt[bj])
            self.T_rt.append(_round_signed_perm(T))

            # ND: covariant components transform with A (orthogonal)
            T = np.zeros((self.nNDf, self.nNDf))
            for mi, (comp, a2, b2) in enumerate(nd_tests):
                dual = Ps[a2] * Pt[b2] * (2 * a2 + 1) * (2 * b2 + 1)
                u = np.zeros((q2.shape[0], 2))
                u[:, comp] = dual
                ug = u @ A.T
                for gi, (cg, ag, bg) in enumerate(nd_tests):
                    T[gi, mi] = np.sum(w2 * ug[:, cg] * Pgs[ag] * Pgt[bg])
            self.T_nd.append(_round_signed_perm(T))

            # H1 interior nodes: pure permutation of the (k-1)^2 GL grid
            nh = self.nH1f
            T = np.zeros((nh, nh))
            if nh:
                loc = np.array([[nodes[a], nodes[b]]
                                for b in range(self.k - 1)
                                for a in range(self.k - 1)])
                gp = loc @ A.T + b0[None, :]
                for gi in range(nh):
                    d = np.abs(loc - gp[gi][None, :]).sum(axis=1)
                    assert d.min() < 1e-12
                    T[gi, np.argmin(d)] = 1.0
            self.T_h1.append(T)

        j = np.arange(p + 1)
        self.T_nd_edge_rev = np.diag((-1.0) ** (j + 1))
        self.T_h1_edge_rev = np.eye(self.k - 1)[::-1].copy()


def ref3(p) -> _Ref3:
    if p not in _REF3_CACHE:
        _REF3_CACHE[p] = _Ref3(p)
    return _REF3_CACHE[p]
