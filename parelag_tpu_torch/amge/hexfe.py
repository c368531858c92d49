"""Lowest-order de Rham finite elements on hexahedra: batched local matrices.

Replaces the reference's per-element MFEM integrator loops
(DeRhamSequenceFE::assembleLocalMass, DeRhamSequenceFE.cpp:97-310; custom
trace integrators in src/amge/bilinIntegrators.cpp) with closed-form batched
quadrature over all elements at once. Every function takes stacked geometry
arrays and returns stacked local matrices — the natural TPU layout (these are
jnp-compatible pure functions; the setup phase runs them on host, and they
vmap onto device unchanged).

Global dof conventions (self-consistent; chosen so all orientation signs fold
into the local matrices):
  * H1  (Q1): dof = vertex value.
  * ND0      : dof = circulation along the edge in global direction
               (tail=min vertex id -> head=max).
  * RT0      : dof = flux through the face in its stored canonical normal.
  * L2  (Q0): dof = cell value (constant).

Trace masses on entities of higher codim match the reference's integrators:
tangential mass on faces for ND (ND_3D_FacetMassIntegrator), 1/length per
edge for ND, 1/area per face for RT (VolumetricFEMassIntegrator semantics:
integral of 1/W over the reference entity), surface/edge/point masses for H1.
"""

import numpy as np

# 2-point Gauss on [0,1]
_G2 = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
_W2 = np.array([0.5, 0.5])

# tensorized 2x2x2 rule
_Q3 = np.array([[x, y, z] for x in _G2 for y in _G2 for z in _G2])
_QW3 = np.array([wx * wy * wz for wx in _W2 for wy in _W2 for wz in _W2])
_Q2 = np.array([[x, y] for x in _G2 for y in _G2])
_QW2 = np.array([wx * wy for wx in _W2 for wy in _W2])

# local corner coordinates of the reference hex in MFEM vertex order
HEX_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)

# local edges/faces (must match mesh.mesh.HEX_EDGES / HEX_FACES)
from parelag_tpu_torch.mesh.mesh import HEX_EDGES, HEX_FACES  # noqa: E402


def _q1_shapes(p):
    """Q1 shape values at points p (nq,3) -> (nq, 8)."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cx, cy, cz = HEX_CORNERS[:, 0], HEX_CORNERS[:, 1], HEX_CORNERS[:, 2]
    return ((cx * x + (1 - cx) * (1 - x))
            * (cy * y + (1 - cy) * (1 - y))
            * (cz * z + (1 - cz) * (1 - z)))


def _q1_dshapes(p):
    """Q1 shape gradients at points p -> (nq, 8, 3)."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cx, cy, cz = HEX_CORNERS[:, 0], HEX_CORNERS[:, 1], HEX_CORNERS[:, 2]
    fx = cx * x + (1 - cx) * (1 - x)
    fy = cy * y + (1 - cy) * (1 - y)
    fz = cz * z + (1 - cz) * (1 - z)
    dx = (2 * cx - 1) * fy * fz
    dy = fx * (2 * cy - 1) * fz
    dz = fx * fy * (2 * cz - 1)
    return np.stack([dx, dy, dz], axis=-1)


def _jacobians(coords, p):
    """coords (ne,8,3); returns J (ne,nq,3,3) with J[a,b] = dX_a/dxhat_b."""
    d = _q1_dshapes(p)                      # (nq, 8, 3)
    # J[n,q,c,d] = sum_i coords[n,i,c] d[q,i,d] -> one big GEMM
    nq = p.shape[0]
    out = (coords.transpose(0, 2, 1).reshape(-1, 8)
           @ d.transpose(1, 0, 2).reshape(8, nq * 3))
    return out.reshape(-1, 3, nq, 3).transpose(0, 2, 1, 3)


def _det3(J):
    """Closed-form determinant of stacked 3x3 (LAPACK-free)."""
    return (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2]
                            - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2]
                              - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1]
                              - J[..., 1, 1] * J[..., 2, 0]))


def _inv3(J, det=None):
    """Closed-form inverse of stacked 3x3 via the adjugate."""
    if det is None:
        det = _det3(J)
    out = np.empty_like(J)
    out[..., 0, 0] = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    out[..., 0, 1] = J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2]
    out[..., 0, 2] = J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]
    out[..., 1, 0] = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    out[..., 1, 1] = J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0]
    out[..., 1, 2] = J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]
    out[..., 2, 0] = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    out[..., 2, 1] = J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1]
    out[..., 2, 2] = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    return out / det[..., None, None]


def _det2(G):
    """Closed-form determinant of stacked 2x2."""
    return G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]


def _inv2(G):
    """Closed-form inverse of stacked 2x2."""
    det = _det2(G)
    out = np.empty_like(G)
    out[..., 0, 0] = G[..., 1, 1]
    out[..., 1, 1] = G[..., 0, 0]
    out[..., 0, 1] = -G[..., 0, 1]
    out[..., 1, 0] = -G[..., 1, 0]
    return out / det[..., None, None]


_Q1D_KERNEL = None


def _q1_dshape_kernel():
    """Module-cached Q1 gradient table (stable id for _metric_mass)."""
    global _Q1D_KERNEL
    if _Q1D_KERNEL is None:
        _Q1D_KERNEL = _q1_dshapes(_Q3)
    return _Q1D_KERNEL


_METRIC_KERNELS = {}


def _metric_mass(wG, E):
    """M[n,i,j] = sum_{q,a,b} wG[n,q,a,b] E[q,i,a] E[q,j,b] as ONE flat
    GEMM (n, q*d*d) @ (q*d*d, k*k) against the cached constant kernel —
    batched tiny matmuls are BLAS-call-bound, this is a single dgemm."""
    q, k, d = E.shape
    key = (id(E), E.shape)
    hit = _METRIC_KERNELS.get(key)
    if hit is None:
        K = np.einsum("qia,qjb->qabij", E, E).reshape(q * d * d, k * k)
        # pin E in the cache entry: keeps its id() from ever being reused
        # by a different array while the kernel is cached
        _METRIC_KERNELS[key] = (E, K)
    else:
        K = hit[1]
    n = wG.shape[0]
    return (wG.reshape(n, q * d * d) @ K).reshape(n, k, k)


def _nd0_ref_shapes(p):
    """Reference ND0 hex shapes at p -> (nq, 12, 3), circulation-normalized
    along the LOCAL edge directions of HEX_EDGES."""
    nq = p.shape[0]
    out = np.zeros((nq, 12, 3))
    x, y, z = p[:, 0], p[:, 1], p[:, 2]

    def psi(t, a):
        return t if a == 1 else 1 - t

    for le, (va, vb) in enumerate(HEX_EDGES):
        ca, cb = HEX_CORNERS[va], HEX_CORNERS[vb]
        direction = np.argmax(np.abs(cb - ca))
        sign = 1.0 if (cb - ca)[direction] > 0 else -1.0
        others = [ax for ax in range(3) if ax != direction]
        val = sign * np.ones(nq)
        for ax in others:
            val = val * psi(p[:, ax], int(ca[ax]))
        out[:, le, direction] = val
    return out


def _nd0_ref_curls(p):
    """Reference curls of ND0 shapes -> (nq, 12, 3)."""
    nq = p.shape[0]
    out = np.zeros((nq, 12, 3))
    for le, (va, vb) in enumerate(HEX_EDGES):
        ca, cb = HEX_CORNERS[va], HEX_CORNERS[vb]
        d = int(np.argmax(np.abs(cb - ca)))
        sign = 1.0 if (cb - ca)[d] > 0 else -1.0
        o1, o2 = [ax for ax in range(3) if ax != d]
        a1, a2 = int(ca[o1]), int(ca[o2])
        # shape = sign * psi_{a1}(x_{o1}) psi_{a2}(x_{o2}) e_d
        # curl(f e_d) = grad f x e_d
        dpsi1 = (2 * a1 - 1) * np.ones(nq) * (
            p[:, o2] if a2 == 1 else 1 - p[:, o2])
        dpsi2 = (p[:, o1] if a1 == 1 else 1 - p[:, o1]) * (
            2 * a2 - 1) * np.ones(nq)
        grad = np.zeros((nq, 3))
        grad[:, o1] = sign * dpsi1
        grad[:, o2] = sign * dpsi2
        e_d = np.zeros(3)
        e_d[d] = 1.0
        out[:, le, :] = np.cross(grad, e_d[None, :])
    return out


def _rt0_ref_shapes(p):
    """Reference RT0 hex shapes at p -> (nq, 6, 3), unit OUTWARD flux through
    the local face of HEX_FACES order (bottom,front,right,back,left,top)."""
    nq = p.shape[0]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zero = np.zeros(nq)
    shapes = [
        np.stack([zero, zero, z - 1], axis=1),   # bottom z=0, outward -z
        np.stack([zero, y - 1, zero], axis=1),   # front  y=0
        np.stack([x, zero, zero], axis=1),       # right  x=1
        np.stack([zero, y, zero], axis=1),       # back   y=1
        np.stack([x - 1, zero, zero], axis=1),   # left   x=0
        np.stack([zero, zero, z], axis=1),       # top    z=1
    ]
    return np.stack(shapes, axis=1)


def elem_geom(coords):
    """Shared element geometry: (J, detJ_signed) at the volume rule —
    compute once, pass to every hex_* mass kernel via geom=."""
    J = _jacobians(coords, _Q3)
    return J, _det3(J)


def face_geom(coords4):
    """Shared face geometry: the bilinear tangent frame F at the surface
    rule — compute once, pass to every face_* kernel via F=."""
    return _face_frames(coords4, _Q2)


_H1_KERNEL = None


def hex_h1_mass(coords, coeff=None, geom=None):
    """(ne,8,3) vertex coords -> (ne,8,8) Q1 mass matrices.
    coeff: optional (ne, nq) coefficient values at quadrature points.
    M_n = sum_q w_nq (N_q x N_q): ONE flat GEMM (ne, nq) @ (nq, 64)
    against the constant shape-outer-product kernel (the batched
    per-element 8x8x8 matmul form dispatched ne tiny BLAS calls)."""
    global _H1_KERNEL
    J, detJ_s = geom if geom is not None else elem_geom(coords)
    detJ = np.abs(detJ_s)                             # (ne, nq)
    if _H1_KERNEL is None:
        N = _q1_shapes(_Q3)                             # (nq, 8)
        _H1_KERNEL = np.einsum("qi,qj->qij", N, N).reshape(-1, 64)
    w = _QW3[None, :] * detJ
    if coeff is not None:
        w = w * coeff
    return (w @ _H1_KERNEL).reshape(-1, 8, 8)


def hex_h1_stiffness(coords, coeff=None):
    """(ne,8,8) Q1 stiffness matrices (for reference/testing)."""
    J = _jacobians(coords, _Q3)
    detJ = np.abs(_det3(J))
    Jinv = _inv3(J)
    d = _q1_dshapes(_Q3)                                # (nq,8,3)
    G = np.einsum("nqab,nqcb->nqac", Jinv, Jinv)
    w = _QW3[None, :] * detJ
    if coeff is not None:
        w = w * coeff
    return _metric_mass(G * w[:, :, None, None], _q1_dshape_kernel())


def _quad_mass(w, phys):
    """M_n[i,j] = sum_{q,a} w[n,q] phys[n,q,i,a] phys[n,q,j,a] via batched
    GEMM: flatten (q,a) into one contraction axis."""
    n, q, i, a = phys.shape
    A = phys.transpose(0, 2, 1, 3).reshape(n, i, q * a)
    B = (phys * w[:, :, None, None]).transpose(0, 2, 1, 3).reshape(
        n, i, q * a)
    return A @ B.transpose(0, 2, 1)


_ND0_E = None
_RT0_F = None


def hex_nd_mass(coords, edge_signs, coeff=None, geom=None):
    """(ne,12,12) ND0 mass, global-circulation dofs (edge_signs (ne,12))."""
    global _ND0_E
    J, detJ_s = geom if geom is not None else elem_geom(coords)
    detJ = np.abs(detJ_s)
    Jinv = _inv3(J, detJ_s)                              # (ne,nq,3,3)
    if _ND0_E is None:
        _ND0_E = _nd0_ref_shapes(_Q3)                    # (nq,12,3)
    # covariant: u = J^{-T} E; phys phys^T = E (Jinv Jinv^T) E^T, so the
    # mass is a metric contraction against the constant E-kernel
    G = np.einsum("nqab,nqcb->nqac", Jinv, Jinv)
    w = _QW3[None, :] * detJ
    if coeff is not None:
        w = w * coeff
    M = _metric_mass(G * w[:, :, None, None], _ND0_E)
    return M * edge_signs[:, :, None] * edge_signs[:, None, :]


def hex_rt_mass(coords, face_signs, coeff=None, geom=None):
    """(ne,6,6) RT0 mass, global-flux dofs (face_signs (ne,6))."""
    global _RT0_F
    J, detJ_s = geom if geom is not None else elem_geom(coords)
    detJ = np.abs(detJ_s)
    if _RT0_F is None:
        _RT0_F = _rt0_ref_shapes(_Q3)                    # (nq,6,3)
    # contravariant Piola: u = J F / det J; phys phys^T = F (J^T J) F^T/det^2
    G = np.einsum("nqba,nqbc->nqac", J, J)
    w = _QW3[None, :] * detJ / (detJ_s * detJ_s)
    if coeff is not None:
        w = w * coeff
    M = _metric_mass(G * w[:, :, None, None], _RT0_F)
    return M * face_signs[:, :, None] * face_signs[:, None, :]


def hex_l2_mass(coords, coeff=None, geom=None):
    """(ne,1,1) cell-value mass = cell volume (weighted)."""
    J, detJ_s = geom if geom is not None else elem_geom(coords)
    detJ = np.abs(detJ_s)
    w = _QW3[None, :] * detJ
    if coeff is not None:
        w = w * coeff
    return w.sum(axis=1)[:, None, None]


def hex_volumes(coords):
    J = _jacobians(coords, _Q3)
    return (np.abs(_det3(J)) * _QW3[None, :]).sum(axis=1)


# ---------------------------------------------------------------------- #
# face (codim 1) geometry + trace masses
# ---------------------------------------------------------------------- #
def _face_frames(coords4, p2):
    """Tangent frames F (nf,nq,3,2) of bilinear quads — the mass kernels
    need only F; computing X alongside doubled the face-geometry cost."""
    s, t = p2[:, 0][None, :, None], p2[:, 1][None, :, None]
    v0 = coords4[:, 0][:, None, :]
    v1 = coords4[:, 1][:, None, :]
    v2 = coords4[:, 2][:, None, :]
    v3 = coords4[:, 3][:, None, :]
    dXds = -(1 - t) * v0 + (1 - t) * v1 + t * v2 - t * v3
    dXdt = -(1 - s) * v0 - s * v1 + s * v2 + (1 - s) * v3
    return np.stack([dXds, dXdt], axis=-1)


def _face_param(coords4, p2):
    """Bilinear quad X(s,t); returns (X (nf,nq,3), F (nf,nq,3,2))."""
    s, t = p2[:, 0][None, :, None], p2[:, 1][None, :, None]
    v0 = coords4[:, 0][:, None, :]
    v1 = coords4[:, 1][:, None, :]
    v2 = coords4[:, 2][:, None, :]
    v3 = coords4[:, 3][:, None, :]
    X = ((1 - s) * (1 - t) * v0 + s * (1 - t) * v1
         + s * t * v2 + (1 - s) * t * v3)
    return X, _face_frames(coords4, p2)


def face_areas(coords4):
    """(nf,) areas of bilinear quad faces (coords in cycle order)."""
    F = _face_frames(coords4, _Q2)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    W = np.sqrt(_det2(G))
    return (W * _QW2[None, :]).sum(axis=1)


_FH1_KERNEL = None


def face_h1_mass(coords4, F=None):
    """(nf,4,4) Q1 surface mass on quad faces, dofs in cycle-vertex order.
    One flat GEMM (nf, nq) @ (nq, 16) against the constant kernel."""
    global _FH1_KERNEL
    if _FH1_KERNEL is None:
        s, t = _Q2[:, 0], _Q2[:, 1]
        N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t, (1 - s) * t],
                     axis=1)
        _FH1_KERNEL = np.einsum("qi,qj->qij", N, N).reshape(-1, 16)
    if F is None:
        F = face_geom(coords4)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    W = np.sqrt(_det2(G))
    w = _QW2[None, :] * W
    return (w @ _FH1_KERNEL).reshape(-1, 4, 4)


_NDF_KERNEL = None


def face_nd_mass(coords4, edge_signs, F=None):
    """(nf,4,4) tangential-trace ND mass on quad faces; dofs = global
    circulations of the 4 cycle edges (edge_signs (nf,4) = cycle-vs-global).

    2D reference ND0 on the unit square, circulation +1 along the CYCLE
    direction of edges (v0v1, v1v2, v2v3, v3v0). Computed as ONE flat GEMM
    (nf, q*2*2) @ (q*2*2, 16) against the constant E x E kernel — batched
    tiny matmuls were allocation-bound at scale."""
    global _NDF_KERNEL
    s, t = _Q2[:, 0], _Q2[:, 1]
    nq = s.size
    if _NDF_KERNEL is None:
        Ehat = np.zeros((nq, 4, 2))
        Ehat[:, 0, 0] = 1 - t
        Ehat[:, 1, 1] = s
        Ehat[:, 2, 0] = -t
        Ehat[:, 3, 1] = -(1 - s)
        _NDF_KERNEL = np.einsum(
            "qib,qjc->qbcij", Ehat, Ehat).reshape(nq * 4, 16)
    if F is None:
        F = face_geom(coords4)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    Ginv = _inv2(G)
    W = np.sqrt(_det2(G))
    WG = Ginv * (_QW2[None, :] * W)[:, :, None, None]
    nf = coords4.shape[0]
    M = (WG.reshape(nf, nq * 4) @ _NDF_KERNEL).reshape(nf, 4, 4)
    return M * edge_signs[:, :, None] * edge_signs[:, None, :]


def face_rt_trace_mass(coords4, F=None):
    """(nf,1,1) normal-trace mass: integral over reference of 1/W
    (= 1/area for planar faces), flux-dof convention."""
    if F is None:
        F = face_geom(coords4)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    W = np.sqrt(_det2(G))
    return ((_QW2[None, :] / W).sum(axis=1))[:, None, None]


def edge_lengths(coords2):
    return np.linalg.norm(coords2[:, 1] - coords2[:, 0], axis=1)


def edge_h1_mass(coords2):
    """(nr,2,2) 1D mass on straight edges, dofs (tail, head)."""
    L = edge_lengths(coords2)
    base = np.array([[1 / 3, 1 / 6], [1 / 6, 1 / 3]])
    return L[:, None, None] * base[None, :, :]


def edge_nd_trace_mass(coords2):
    """(nr,1,1) tangential-trace mass = 1/length (circulation dofs)."""
    return (1.0 / edge_lengths(coords2))[:, None, None]


def hex_elasticity_stiffness(coords, lam=1.0, mu=1.0):
    """(ne, 24, 24) Q1 vector-elasticity element matrices
    K = int lam div(u) div(v) + 2 mu eps(u):eps(v)
    (mfem ElasticityIntegrator), dof order byNODES: (a * 8 + i) for
    displacement component a and vertex i."""
    J = _jacobians(coords, _Q3)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    d = _q1_dshapes(_Q3)
    g = np.einsum("nqba,qib->nqia", Jinv, d)       # (ne, nq, 8, 3)
    w = _QW3[None, :] * detJ
    # div-div term: lam * g_ia g_jb
    Kdiv = lam * np.einsum("nq,nqia,nqjb->naibj", w, g, g)
    # 2 mu eps:eps = mu * (g_ib g_ja + delta_ab grad.grad)
    Kshear = mu * np.einsum("nq,nqib,nqja->naibj", w, g, g)
    gdotg = np.einsum("nq,nqic,nqjc->nij", w, g, g)
    ne = coords.shape[0]
    K = Kdiv + Kshear
    for a in range(3):
        K[:, a, :, a, :] += mu * gdotg
    return K.reshape(ne, 24, 24)
