"""Lowest-order de Rham finite elements on tetrahedra: batched local
matrices (the tet counterpart of hexfe.py; reference: MFEM P1/ND0/RT0/P0
collections used by DeRhamSequence3D_FE on tet meshes).

Same global dof conventions as hexfe: H1 vertex values, ND0 circulations
along global edge direction (min->max vertex id), RT0 fluxes through the
stored canonical face normal, L2 cell values. All geometry is affine, so
low-order quadrature is exact.
"""

import numpy as np

from parelag_tpu_torch.mesh.mesh import TET_EDGES, TET_FACES

# 4-point degree-2 rule on the reference tet (barycentric)
_A = (5.0 - np.sqrt(5.0)) / 20.0
_B = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
_TQ = np.array([
    [_A, _A, _A], [_B, _A, _A], [_A, _B, _A], [_A, _A, _B]])
_TW = np.full(4, 1.0 / 24.0)          # weights sum to ref volume 1/6

# 3-point degree-2 rule on the reference triangle
_SQ = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
_SW = np.full(3, 1.0 / 6.0)           # sum = ref area 1/2


def _tet_jac(coords):
    """coords (ne,4,3) -> J (ne,3,3), detJ (ne,), Jinv (ne,3,3)."""
    v0 = coords[:, 0]
    J = np.stack([coords[:, 1] - v0, coords[:, 2] - v0,
                  coords[:, 3] - v0], axis=-1)
    det = np.linalg.det(J)
    return J, det, np.linalg.inv(J)


def tet_volumes(coords):
    _, det, _ = _tet_jac(coords)
    return np.abs(det) / 6.0


def tet_h1_mass(coords, coeff=None):
    """(ne,4,4) P1 mass; exact closed form vol/20 (1 + I) when coeff is
    None, quadrature otherwise."""
    vol = tet_volumes(coords)
    if coeff is None:
        base = (np.ones((4, 4)) + np.eye(4)) / 20.0
        return vol[:, None, None] * base[None]
    lam = np.concatenate([1 - _TQ.sum(axis=1, keepdims=True), _TQ], axis=1)
    _, det, _ = _tet_jac(coords)
    w = _TW[None, :] * np.abs(det)[:, None] * coeff
    return np.einsum("nq,qi,qj->nij", w, lam, lam)


def _grad_lambda(coords):
    """Barycentric gradients (ne, 4, 3): grad lam_k constant per tet."""
    _, _, Jinv = _tet_jac(coords)
    # lambda_k = (J^{-1}(x - v0))_k for k=1..3, so grad lambda_k is the
    # k-th ROW of J^{-1}
    g123 = Jinv
    g0 = -g123.sum(axis=1, keepdims=True)
    return np.concatenate([g0, g123], axis=1)


def tet_h1_stiffness(coords, coeff=None):
    g = _grad_lambda(coords)
    vol = tet_volumes(coords)
    w = vol if coeff is None else vol * coeff.mean(axis=1)
    return np.einsum("n,nia,nja->nij", w, g, g)


def tet_nd_mass(coords, edge_signs, coeff=None):
    """(ne,6,6) ND0 (Whitney edge) mass, global-circulation dofs.
    W_(a,b) = lam_a grad lam_b - lam_b grad lam_a (circulation 1 along
    local a->b)."""
    ne = coords.shape[0]
    g = _grad_lambda(coords)                      # (ne,4,3)
    lam = np.concatenate(
        [1 - _TQ.sum(axis=1, keepdims=True), _TQ], axis=1)   # (nq,4)
    _, det, _ = _tet_jac(coords)
    W = np.empty((ne, _TQ.shape[0], 6, 3))
    for le, (a, b) in enumerate(TET_EDGES):
        W[:, :, le, :] = (lam[None, :, a, None] * g[:, None, b, :]
                          - lam[None, :, b, None] * g[:, None, a, :])
    w = _TW[None, :] * np.abs(det)[:, None]
    if coeff is not None:
        w = w * coeff
    M = np.einsum("nq,nqia,nqja->nij", w, W, W)
    return M * edge_signs[:, :, None] * edge_signs[:, None, :]


def tet_rt_mass(coords, face_signs, coeff=None):
    """(ne,4,4) RT0 mass, global-flux dofs. phi_f = (x - v_opp)/(3V) has
    unit outward flux through local face f and zero through the others."""
    ne = coords.shape[0]
    vol = tet_volumes(coords)
    # physical quadrature points
    v0 = coords[:, 0]
    J, det, _ = _tet_jac(coords)
    X = v0[:, None, :] + np.einsum("nab,qb->nqa", J, _TQ)
    opp = np.array([0, 1, 2, 3])   # TET_FACES[f] omits vertex f
    # TET_FACES: (1,2,3)->opp 0, (0,3,2)->1, (0,1,3)->2, (0,2,1)->3
    phi = np.empty((ne, _TQ.shape[0], 4, 3))
    for f in range(4):
        phi[:, :, f, :] = (X - coords[:, opp[f]][:, None, :]) / (
            3.0 * vol[:, None, None])
    w = _TW[None, :] * np.abs(det)[:, None]
    if coeff is not None:
        w = w * coeff
    M = np.einsum("nq,nqia,nqja->nij", w, phi, phi)
    return M * face_signs[:, :, None] * face_signs[:, None, :]


def tet_l2_mass(coords, coeff=None):
    vol = tet_volumes(coords)
    if coeff is not None:
        _, det, _ = _tet_jac(coords)
        w = _TW[None, :] * np.abs(det)[:, None] * coeff
        return w.sum(axis=1)[:, None, None]
    return vol[:, None, None]


# ---------------------------------------------------------------------- #
# triangular faces (codim 1)
# ---------------------------------------------------------------------- #
def _tri_geom(coords3):
    """coords3 (nf,3,3) cycle order -> (F (nf,3,2), G, W(nf,), area)."""
    a, b, c = coords3[:, 0], coords3[:, 1], coords3[:, 2]
    F = np.stack([b - a, c - a], axis=-1)
    G = np.einsum("fai,faj->fij", F, F)
    W = np.sqrt(np.maximum(np.linalg.det(G), 0.0))
    return F, G, W


def tri_areas(coords3):
    _, _, W = _tri_geom(coords3)
    return 0.5 * W


def tri_h1_mass(coords3):
    """(nf,3,3) P1 surface mass = area/12 (1 + I)."""
    area = tri_areas(coords3)
    base = (np.ones((3, 3)) + np.eye(3)) / 12.0
    return area[:, None, None] * base[None]


def tri_nd_mass(coords3, edge_signs):
    """(nf,3,3) tangential-trace ND mass on triangles; dofs = global
    circulations of the 3 cycle edges (a->b, b->c, c->a)."""
    F, G, W = _tri_geom(coords3)
    Ginv = np.linalg.inv(G)
    # 2D Whitney: lam = (1-s-t, s, t); grads: (-1,-1),(1,0),(0,1)
    glam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    lam = np.concatenate(
        [1 - _SQ.sum(axis=1, keepdims=True), _SQ], axis=1)   # (nq,3)
    cyc_edges = [(0, 1), (1, 2), (2, 0)]
    nq = _SQ.shape[0]
    E = np.empty((nq, 3, 2))
    for k, (a, b) in enumerate(cyc_edges):
        E[:, k, :] = lam[:, a, None] * glam[None, b] \
            - lam[:, b, None] * glam[None, a]
    w = _SW[None, :] * W[:, None]
    M = np.einsum("fq,qia,fab,qjb->fij", w, E, Ginv, E)
    return M * edge_signs[:, :, None] * edge_signs[:, None, :]


def tri_rt_trace_mass(coords3):
    """(nf,1,1) normal-trace mass = 1/area (flux dofs)."""
    return (1.0 / tri_areas(coords3))[:, None, None]
