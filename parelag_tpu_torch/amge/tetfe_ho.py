"""Arbitrary-order de Rham elements on tetrahedra (feorder = p >= 0).

The simplex counterpart of hexfe_ho/fespace3d_ho for the trimmed family
(reference: MFEM H1/ND/RT/L2 tet collections at any order,
DeRhamSequenceFE.cpp:83-310; the testsuite's golden meshes — cube456 —
are tet meshes):

  H1 = P_k Lagrange          k = p + 1
  ND = first-kind Nedelec R_k = (P_{k-1})^3 + S_k   (Monk Ch. 5)
  RT = RT_k = (P_{k-1})^3 + x Ptilde_{k-1}
  L2 = P_{k-1} discontinuous

Dofs are nodal values / moments against BERNSTEIN bases, which are
equivariant under barycentric permutations — so the S3 face transforms are
a pure permutation for H1 nodes, a signed permutation for RT flux moments
(sign = orientation parity of the vertex permutation), and a small-integer
block matrix for ND tangential moments (the frame axes mix under S3; the
test indices still permute). Edge transforms are the same Legendre-parity
reversals as on hexes. All derivative matrices are geometry-independent
reference matrices (the trimmed complex P_k -> R_k -> RT_k -> P_{k-1} is
exact), folded per element through the entity transforms; geometry lives
only in the (affine, closed-form) mass matrices.

Quadrature: collapsed (Duffy) Gauss rules — polynomials stay polynomial
under the Duffy map, so the tensor rules are exact at the orders used.
"""

import itertools

import numpy as np

from parelag_tpu_torch.mesh.mesh import TET_EDGES, TET_FACES
from parelag_tpu_torch.amge.fespace2d_ho import gauss_points, legendre_vals

TET_CORNERS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                        [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

# The 6 permutations of a triangle's vertices: frame[j] = local[PERMS3[c][j]]
PERMS3 = list(itertools.permutations((0, 1, 2)))


def perm3_code(local_tri, frame_tri):
    """Code c with frame_tri[j] == local_tri[PERMS3[c][j]], vectorized over
    leading dims: (..., 3) -> (...)."""
    lt = np.asarray(local_tri)
    ft = np.asarray(frame_tri)
    codes = np.full(lt.shape[:-1], -1, dtype=np.int64)
    for c, pi in enumerate(PERMS3):
        hit = np.all(ft == lt[..., list(pi)], axis=-1)
        codes = np.where(hit, c, codes)
    assert np.all(codes >= 0), "faces do not share a vertex set"
    return codes


def duffy_tet(n):
    """Collapsed Gauss rule on the reference tet: (pts (nq,3), w)."""
    g, gw = gauss_points(n)
    U, V, W = np.meshgrid(g, g, g, indexing="ij")
    WU, WV, WW = np.meshgrid(gw, gw, gw, indexing="ij")
    x = U
    y = V * (1 - U)
    z = W * (1 - U) * (1 - V)
    w = WU * WV * WW * (1 - U) ** 2 * (1 - V)
    return (np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1),
            w.ravel())


def duffy_tri(n):
    g, gw = gauss_points(n)
    U, V = np.meshgrid(g, g, indexing="ij")
    WU, WV = np.meshgrid(gw, gw, indexing="ij")
    x = U
    y = V * (1 - U)
    w = WU * WV * (1 - U)
    return np.stack([x.ravel(), y.ravel()], axis=1), w.ravel()


def _multiindices(dim, total):
    """All (dim+1)-tuples of non-negative ints summing to `total`,
    lexicographic."""
    out = []

    def rec(prefix, rem, slots):
        if slots == 1:
            out.append(tuple(prefix) + (rem,))
            return
        for a in range(rem + 1):
            rec(prefix + [a], rem - a, slots - 1)
    rec([], total, dim + 1)
    return out


def _bernstein(alphas, lam):
    """Bernstein basis values: alphas list of multiindices (|a| = n),
    lam (npts, dim+1) barycentrics -> (nb, npts)."""
    from math import factorial
    n = sum(alphas[0]) if alphas else 0
    out = np.empty((len(alphas), lam.shape[0]))
    for i, a in enumerate(alphas):
        c = factorial(n)
        for ai in a:
            c //= factorial(ai)
        v = float(c) * np.ones(lam.shape[0])
        for d, ai in enumerate(a):
            if ai:
                v = v * lam[:, d] ** ai
        out[i] = v
    return out


def _bary3(pts):
    return np.concatenate(
        [1 - pts.sum(axis=1, keepdims=True), pts], axis=1)


def _bary2(pts):
    return np.concatenate(
        [1 - pts.sum(axis=1, keepdims=True), pts], axis=1)


def _mono_powers(dim, max_deg, exact=False):
    degs = range(max_deg, max_deg + 1) if exact else range(max_deg + 1)
    out = []
    for total in degs:
        for a in _multiindices(dim - 1, total):
            out.append(a)
    return out


def _mono_eval(powers, pts):
    out = np.empty((len(powers), pts.shape[0]))
    for i, a in enumerate(powers):
        v = np.ones(pts.shape[0])
        for d, ai in enumerate(a):
            if ai:
                v = v * pts[:, d] ** ai
        out[i] = v
    return out


_TREF_CACHE = {}


class _TetRef:
    """Order-p reference data on the tet (k = p + 1 everywhere)."""

    def __init__(self, p):
        from math import comb
        self.p = p
        k = p + 1
        self.k = k
        nq1 = k + 4
        self.q3, self.w3 = duffy_tet(nq1)
        self.q2, self.w2 = duffy_tri(nq1)
        self.gx, self.gw = gauss_points(nq1)

        # entity frames
        self.edge_start = TET_CORNERS[TET_EDGES[:, 0]]
        self.edge_dir = (TET_CORNERS[TET_EDGES[:, 1]]
                         - TET_CORNERS[TET_EDGES[:, 0]])
        fc = TET_CORNERS[TET_FACES]
        self.face_origin = fc[:, 0]
        self.face_e1 = fc[:, 1] - fc[:, 0]
        self.face_e2 = fc[:, 2] - fc[:, 0]
        self.face_n = np.cross(self.face_e1, self.face_e2)  # outward x2A

        # dof counts
        self.nH1e = k - 1
        self.nH1f = comb(k - 1, 2)
        self.nH1i = comb(k - 1, 3)
        self.nNDe = k
        self.nNDf = 2 * comb(k, 2)
        self.nNDi = 3 * comb(k, 3)
        self.nRTf = comb(k + 1, 2)
        self.nRTi = 3 * comb(k + 1, 3)
        self.nL2 = comb(k + 2, 3)
        self.nH1 = 4 + 6 * self.nH1e + 4 * self.nH1f + self.nH1i
        self.nND = 6 * self.nNDe + 4 * self.nNDf + self.nNDi
        self.nRT = 4 * self.nRTf + self.nRTi
        assert self.nH1 == comb(k + 3, 3)
        assert self.nND == k * (k + 2) * (k + 3) // 2
        assert self.nRT == k * (k + 1) * (k + 3) // 2

        # test bases (Bernstein multiindices)
        self.b_face_rt = _multiindices(2, k - 1)       # P_{k-1}(f)
        self.b_face_nd = _multiindices(2, k - 2) if k >= 2 else []
        self.b_int_nd = _multiindices(3, k - 3) if k >= 3 else []
        self.b_int_rt = _multiindices(3, k - 2) if k >= 2 else []
        self.b_l2 = _multiindices(3, k - 1)
        assert len(self.b_l2) == self.nL2
        assert 2 * len(self.b_face_nd) == self.nNDf
        assert len(self.b_face_rt) == self.nRTf
        assert 3 * len(self.b_int_nd) == self.nNDi
        assert 3 * len(self.b_int_rt) == self.nRTi

        self._build_dof_maps()
        self._build_h1()
        self._build_spaces()
        self._build_derivs()
        self._build_face_transforms()

    # -------------------- dof functionals -------------------- #
    def _build_dof_maps(self):
        """Point set [6 edges x nq1 | 4 faces x nq2 | q3] + linear maps
        nd_L / rt_L with dof_i(u) = sum L[i,q,a] u(P_q)_a."""
        p, k = self.p, self.k
        gx, gw = self.gx, self.gw
        nq1, nq2 = gx.size, self.q2.shape[0]
        pts = [self.edge_start[e][None, :]
               + gx[:, None] * self.edge_dir[e][None, :]
               for e in range(6)]
        pts += [self.face_origin[f][None, :]
                + self.q2[:, 0:1] * self.face_e1[f][None, :]
                + self.q2[:, 1:2] * self.face_e2[f][None, :]
                for f in range(4)]
        pts += [self.q3]
        self.dof_pts = np.concatenate(pts, axis=0)
        off_f = 6 * nq1
        off_v = off_f + 4 * nq2
        npts = self.dof_pts.shape[0]
        P1 = legendre_vals(k - 1, gx)
        B2nd = (_bernstein(self.b_face_nd, _bary2(self.q2))
                if self.b_face_nd else np.zeros((0, nq2)))
        B2rt = _bernstein(self.b_face_rt, _bary2(self.q2))
        B3nd = (_bernstein(self.b_int_nd, _bary3(self.q3))
                if self.b_int_nd else np.zeros((0, self.q3.shape[0])))
        B3rt = (_bernstein(self.b_int_rt, _bary3(self.q3))
                if self.b_int_rt else np.zeros((0, self.q3.shape[0])))

        nd_L = np.zeros((self.nND, npts, 3))
        pos = 0
        for e in range(6):
            sl = slice(e * nq1, (e + 1) * nq1)
            for j in range(k):
                nd_L[pos, sl, :] = (gw * P1[j])[:, None] \
                    * self.edge_dir[e][None, :]
                pos += 1
        for f in range(4):
            sl = slice(off_f + f * nq2, off_f + (f + 1) * nq2)
            for comp, axis in ((0, self.face_e1), (1, self.face_e2)):
                for bi in range(B2nd.shape[0]):
                    nd_L[pos, sl, :] = (self.w2 * B2nd[bi])[:, None] \
                        * axis[f][None, :]
                    pos += 1
        for comp in range(3):
            for bi in range(B3nd.shape[0]):
                nd_L[pos, off_v:, comp] = self.w3 * B3nd[bi]
                pos += 1
        assert pos == self.nND
        self.nd_L = nd_L

        rt_L = np.zeros((self.nRT, npts, 3))
        pos = 0
        for f in range(4):
            sl = slice(off_f + f * nq2, off_f + (f + 1) * nq2)
            for bi in range(B2rt.shape[0]):
                rt_L[pos, sl, :] = (self.w2 * B2rt[bi])[:, None] \
                    * self.face_n[f][None, :]
                pos += 1
        for comp in range(3):
            for bi in range(B3rt.shape[0]):
                rt_L[pos, off_v:, comp] = self.w3 * B3rt[bi]
                pos += 1
        assert pos == self.nRT
        self.rt_L = rt_L

    def nd_dofs(self, fields):
        return np.einsum("iqa,...qa->...i", self.nd_L, fields)

    def rt_dofs(self, fields):
        return np.einsum("iqa,...qa->...i", self.rt_L, fields)

    def l2_dofs(self, dens):
        B = _bernstein(self.b_l2, _bary3(self.q3))
        return np.einsum("iq,...q->...i", B * self.w3[None, :], dens)

    # -------------------- H1 (P_k Lagrange) -------------------- #
    def _build_h1(self):
        k = self.k
        nodes = []                      # physical reference coords
        for c in TET_CORNERS:
            nodes.append(c)
        for e in range(6):
            for t in range(1, k):
                nodes.append(self.edge_start[e]
                             + (t / k) * self.edge_dir[e])
        for f in range(4):
            for b in range(1, k):
                for a in range(1, k - b):
                    nodes.append(self.face_origin[f]
                                 + (a / k) * self.face_e1[f]
                                 + (b / k) * self.face_e2[f])
        for c in range(1, k):
            for b in range(1, k - c):
                for a in range(1, k - b - c):
                    nodes.append(np.array([a / k, b / k, c / k]))
        assert len(nodes) == self.nH1
        self.h1_nodes = np.array(nodes)
        self.h1_alphas = _multiindices(3, k)
        # V[b, j] = B_b(node_j); nodal basis coeffs C with C @ V = I
        V = _bernstein(self.h1_alphas, _bary3(self.h1_nodes))
        self.h1_coeff = np.linalg.inv(V)       # (nH1, nbern)

    def h1_eval(self, pts):
        B = _bernstein(self.h1_alphas, _bary3(pts))
        return self.h1_coeff @ B

    def h1_grad(self, pts, eps=None):
        """Analytic Bernstein gradients via barycentric chain rule."""
        lam = _bary3(pts)
        # d lam / d x = [-1,-1,-1; e_x; e_y; e_z]
        dldx = np.array([[-1.0, -1.0, -1.0], [1, 0, 0],
                         [0, 1, 0], [0, 0, 1]])
        from math import factorial
        n = self.k
        nb = len(self.h1_alphas)
        G = np.zeros((nb, pts.shape[0], 4))
        for i, a in enumerate(self.h1_alphas):
            c = factorial(n)
            for ai in a:
                c //= factorial(ai)
            for d in range(4):
                if a[d] == 0:
                    continue
                v = float(c) * a[d] * np.ones(pts.shape[0])
                for dd, ai in enumerate(a):
                    e = ai - (1 if dd == d else 0)
                    if e:
                        v = v * lam[:, dd] ** e
                G[i, :, d] = v
        gB = np.einsum("iqd,da->iqa", G, dldx)
        return np.einsum("ib,bqa->iqa", self.h1_coeff, gB)

    # -------------------- ND / RT spaces -------------------- #
    def _s_space(self, k):
        """Basis of S_k = {q in (Ptilde_k)^3 : q . x = 0} as coefficient
        rows over the (hom-monomial, comp) generators."""
        hom = _mono_powers(3, k, exact=True)
        out_m = _mono_powers(3, k + 1, exact=True)
        pos = {a: i for i, a in enumerate(out_m)}
        Z = np.zeros((len(out_m), 3 * len(hom)))
        for i, a in enumerate(hom):
            for comp in range(3):
                b = list(a)
                b[comp] += 1
                Z[pos[tuple(b)], comp * len(hom) + i] = 1.0
        _, s, Vt = np.linalg.svd(Z)
        null = Vt[np.sum(s > 1e-10):]
        return hom, null                   # (n_s, 3*len(hom))

    def _space_fields(self, kind):
        """Return a callable pts -> (nbasis_space, npts, 3) evaluating the
        generating set of the ND/RT polynomial space."""
        k = self.k
        low = _mono_powers(3, k - 1)       # P_{k-1} powers
        if kind == "nd":
            hom, null = self._s_space(k)

            def ev(pts):
                Ml = _mono_eval(low, pts)
                out = np.zeros((3 * len(low) + null.shape[0],
                                pts.shape[0], 3))
                for comp in range(3):
                    out[comp * len(low):(comp + 1) * len(low), :, comp] \
                        = Ml
                Mh = _mono_eval(hom, pts)
                for j in range(null.shape[0]):
                    for comp in range(3):
                        c = null[j, comp * len(hom):(comp + 1) * len(hom)]
                        out[3 * len(low) + j, :, comp] = c @ Mh
                return out
            return ev, 3 * len(low) + null.shape[0]
        # RT: (P_{k-1})^3 + x Ptilde_{k-1}
        homm = _mono_powers(3, k - 1, exact=True)

        def ev(pts):
            Ml = _mono_eval(low, pts)
            Mh = _mono_eval(homm, pts)
            out = np.zeros((3 * len(low) + len(homm), pts.shape[0], 3))
            for comp in range(3):
                out[comp * len(low):(comp + 1) * len(low), :, comp] = Ml
            for j in range(len(homm)):
                out[3 * len(low) + j] = Mh[j][:, None] * pts
            return out
        return ev, 3 * len(low) + len(homm)

    def _build_spaces(self):
        ev, nb = self._space_fields("nd")
        assert nb == self.nND, (nb, self.nND)
        self._nd_ev = ev
        V = self.nd_dofs(ev(self.dof_pts))     # (nb, nND)
        self.nd_coeff = np.linalg.inv(V)
        ev, nb = self._space_fields("rt")
        assert nb == self.nRT, (nb, self.nRT)
        self._rt_ev = ev
        V = self.rt_dofs(ev(self.dof_pts))
        self.rt_coeff = np.linalg.inv(V)

    def nd_eval(self, pts):
        return np.einsum("im,mqa->iqa", self.nd_coeff, self._nd_ev(pts))

    def rt_eval(self, pts):
        return np.einsum("im,mqa->iqa", self.rt_coeff, self._rt_ev(pts))

    def l2_eval(self, pts):
        """Dual density basis: B Gram-inverse applied to Bernstein."""
        B = _bernstein(self.b_l2, _bary3(pts))
        if not hasattr(self, "_l2_gram_inv"):
            Bq = _bernstein(self.b_l2, _bary3(self.q3))
            G = np.einsum("iq,q,jq->ij", Bq, self.w3, Bq)
            self._l2_gram_inv = np.linalg.inv(G)
        return self._l2_gram_inv @ B

    def _build_derivs(self):
        # grad(H1) in ND dofs
        self.D0 = self.nd_dofs(self.h1_grad(self.dof_pts)).T
        # curl(ND) in RT dofs: differentiate the monomial generators
        # analytically by evaluating curls of the generating fields
        self.D1 = self.rt_dofs(self._nd_curls(self.dof_pts)).T
        # div(RT) in L2 moments
        self.D2 = self.l2_dofs(self._rt_divs(self.q3)).T

    def _nd_curls(self, pts):
        k = self.k
        low = _mono_powers(3, k - 1)
        hom, null = self._s_space(k)

        def curl_component_field(powers_list, coeffs, comp):
            """curl of sum_i coeffs[i] x^powers_i e_comp at pts."""
            out = np.zeros((pts.shape[0], 3))
            for cdx, a in zip(coeffs, powers_list):
                if cdx == 0.0:
                    continue
                grad = np.zeros((pts.shape[0], 3))
                for d in range(3):
                    if a[d] == 0:
                        continue
                    b = list(a)
                    b[d] -= 1
                    grad[:, d] = cdx * a[d] * _mono_eval(
                        [tuple(b)], pts)[0]
                e = np.zeros(3)
                e[comp] = 1.0
                out += np.cross(grad, e[None, :])
            return out

        nb = self.nND
        curls = np.zeros((nb, pts.shape[0], 3))
        for comp in range(3):
            for i, a in enumerate(low):
                c = np.zeros(len(low))
                c[i] = 1.0
                curls[comp * len(low) + i] = curl_component_field(
                    low, c, comp)
        for j in range(null.shape[0]):
            acc = np.zeros((pts.shape[0], 3))
            for comp in range(3):
                acc += curl_component_field(
                    hom, null[j, comp * len(hom):(comp + 1) * len(hom)],
                    comp)
            curls[3 * len(low) + j] = acc
        return np.einsum("im,mqa->iqa", self.nd_coeff, curls)

    def _rt_divs(self, pts):
        k = self.k
        low = _mono_powers(3, k - 1)
        homm = _mono_powers(3, k - 1, exact=True)
        nb = self.nRT
        divs = np.zeros((nb, pts.shape[0]))
        for comp in range(3):
            for i, a in enumerate(low):
                if a[comp] == 0:
                    continue
                b = list(a)
                b[comp] -= 1
                divs[comp * len(low) + i] = a[comp] * _mono_eval(
                    [tuple(b)], pts)[0]
        # div(x m) = (3 + deg) m for homogeneous m of degree k-1
        Mh = _mono_eval(homm, pts)
        for j, a in enumerate(homm):
            divs[3 * len(low) + j] = (3.0 + sum(a)) * Mh[j]
        return np.einsum("im,mq->iq", self.rt_coeff, divs)

    # -------------------- face transforms (S3) -------------------- #
    def _build_face_transforms(self):
        """For each of the 6 vertex permutations pi (frame[j] =
        local[pi[j]]): T with m_frame = T @ m_local."""
        k = self.k
        q2, w2 = self.q2, self.w2
        lam_l = _bary2(q2)                       # local barycentrics
        B2rt_l = _bernstein(self.b_face_rt, lam_l)
        B2nd_l = (_bernstein(self.b_face_nd, lam_l)
                  if self.b_face_nd else np.zeros((0, q2.shape[0])))
        self.T_rt3, self.T_nd3, self.T_h1_3 = [], [], []
        # local face frame: origin w0, axes e1 = w1-w0, e2 = w2-w0 in
        # BARYCENTRIC terms; frame vertices (w_{pi[0]}, w_{pi[1]},
        # w_{pi[2]})
        for pi in PERMS3:
            # barycentric coords wrt frame ordering: nu_j = lam_{pi[j]}
            nu = lam_l[:, list(pi)]
            # frame coords (xi', eta') with lam_frame = (1-xi'-eta', ...)
            B2rt_f = _bernstein(self.b_face_rt, nu)
            # orientation parity: normal flips for odd permutations
            sgn = 1.0 if _parity(pi) else -1.0
            # RT: m_f_i = sgn * int dens * B_i(nu); dens via local dual
            Gl = np.einsum("iq,q,jq->ij", B2rt_l, w2, B2rt_l)
            X = np.einsum("iq,q,jq->ij", B2rt_f, w2, B2rt_l)
            T = sgn * X @ np.linalg.inv(Gl)
            self.T_rt3.append(_snap(T))

            if self.b_face_nd:
                # ND: covariant components along frame axes; frame axes
                # e1' = w_{pi1}-w_{pi0}, e2' = w_{pi2}-w_{pi0} expand in
                # local axes e1 = w1-w0, e2 = w2-w0 via vertex positions
                pos = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
                C = np.stack([pos[pi[1]] - pos[pi[0]],
                              pos[pi[2]] - pos[pi[0]]])   # (2 frame, 2 loc)
                B2nd_f = _bernstein(self.b_face_nd, nu)
                Gl2 = np.einsum("iq,q,jq->ij", B2nd_l, w2, B2nd_l)
                X2 = np.einsum("iq,q,jq->ij", B2nd_f, w2, B2nd_l)
                Tb = X2 @ np.linalg.inv(Gl2)      # test re-expansion
                nf = len(self.b_face_nd)
                T = np.zeros((2 * nf, 2 * nf))
                for i2 in range(2):
                    for j2 in range(2):
                        T[i2 * nf:(i2 + 1) * nf, j2 * nf:(j2 + 1) * nf] \
                            = C[i2, j2] * Tb
                self.T_nd3.append(_snap(T))
            else:
                self.T_nd3.append(np.zeros((0, 0)))

            # H1 face nodes: lattice permutation
            nh = self.nH1f
            T = np.zeros((nh, nh))
            if nh:
                loc = []
                for b in range(1, k):
                    for a in range(1, k - b):
                        loc.append((k - a - b, a, b))    # barycentric * k
                loc = np.array(loc)
                for gi, ab in enumerate(loc):
                    img = ab[list(pi)]               # frame barycentrics
                    d = np.abs(loc - img[None, :]).sum(axis=1)
                    assert d.min() == 0
                    T[gi, np.argmin(d)] = 1.0
            self.T_h1_3.append(T)

        # the ND face transforms are NOT orthogonal (the frame axes mix
        # with an integer matrix C): mass folding and derivative COLUMN
        # folding need R = T^{-T} (the dual-basis transform), while dof
        # (row) transforms use T itself
        self.R_nd3 = [np.linalg.inv(T).T if T.size else T
                      for T in self.T_nd3]
        self.R_nd3 = [_snap(R) for R in self.R_nd3]
        j = np.arange(self.nNDe)
        self.T_nd_edge_rev = np.diag((-1.0) ** (j + 1))
        self.T_h1_edge_rev = np.eye(self.nH1e)[::-1].copy()


def _parity(pi):
    """True for even permutations."""
    inv = sum(1 for i in range(3) for j in range(i + 1, 3)
              if pi[i] > pi[j])
    return inv % 2 == 0


def _snap(T, tol=1e-9):
    """Snap near-integer/half-integer entries (the S3 transforms are exact
    small rationals) to kill fp noise."""
    if T.size == 0:
        return T
    R = np.round(T * 2.0) / 2.0
    return R if np.abs(T - R).max() < tol else T


def tet_ref(p) -> _TetRef:
    if p not in _TREF_CACHE:
        _TREF_CACHE[p] = _TetRef(p)
    return _TREF_CACHE[p]
