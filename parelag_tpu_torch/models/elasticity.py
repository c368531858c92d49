"""Linear-elasticity upscaling via vector H1 (ElasticityUpscaling0Form).

Reference: examples/ElasticityUpscaling0Form.cpp — the elasticity system
(lam div u div v + 2 mu eps(u):eps(v)) on the vector H1 space (byNODES
ordering) is upscaled with the SCALAR H1 AMGe interpolator applied per
displacement component: P_vec = blockdiag(P0, P0, P0)
(ElasticityUpscaling0Form.cpp:457-530 builds the BlockMatrix of H1 Ps).
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.models.upscaling import (
    build_hierarchy, mark_dofs_on_bndr, eliminate_rowcols, solve_spd,
    UpscalingResult)
from parelag_tpu_torch.amge import hexfe


def assemble_elasticity(seq_fe, lam=1.0, mu=1.0) -> sp.csr_matrix:
    """Global vector-H1 elasticity stiffness (byNODES: [ux..., uy..., uz])."""
    mesh = seq_fe.mesh
    coords = mesh.vertices[mesh.elements]
    K = hexfe.hex_elasticity_stiffness(coords, lam, mu)
    nv = mesh.num_vertices
    rows, cols, vals = [], [], []
    for a in range(3):
        for b in range(3):
            blk = K[:, a * 8:(a + 1) * 8, b * 8:(b + 1) * 8]
            r = np.repeat(mesh.elements, 8, axis=1).reshape(-1)
            c = np.tile(mesh.elements, (1, 8)).reshape(-1)
            rows.append(a * nv + r)
            cols.append(b * nv + c)
            vals.append(blk.reshape(-1))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * nv, 3 * nv))
    return A.tocsr()


def vector_interp(P):
    """blockdiag(P, P, P) for byNODES vector fields."""
    return sp.block_diag([P, P, P], format="csr")


def elasticity_upscaling(nref_parallel=1, lam=1.0, mu=1.0, svd_tol=1e-9,
                         upscaling_order=0, solver="direct",
                         body_force=(0.0, 0.0, -1.0)) -> UpscalingResult:
    """Clamped-bottom cube under a body force; multilevel upscaling errors
    in the vector mass and energy norms."""
    mesh, topos, seqs = build_hierarchy(
        nref_parallel, svd_tol=svd_tol, upscaling_order=upscaling_order)
    n_levels = len(seqs)
    fe = seqs[0]
    nv = mesh.num_vertices

    A0 = assemble_elasticity(fe, lam, mu)
    f = np.asarray(body_force)
    bcomp = fe.domain_lf_scalar(0, lambda p: np.ones(p.shape[:-1]))
    b0 = np.concatenate([f[a] * bcomp for a in range(3)])
    # clamp the bottom (attr 1)
    m_scalar = mark_dofs_on_bndr(fe, 0, {1})
    marker = np.concatenate([m_scalar] * 3)

    Pl = [vector_interp(seqs[i].P[0]) for i in range(n_levels - 1)]
    M_scalar = [s.compute_mass_operator(0) for s in seqs]
    Ml = [sp.block_diag([M, M, M], format="csr") for M in M_scalar]

    A_levels = [None] * n_levels
    b_levels = [None] * n_levels
    markers = [marker]
    A, b = eliminate_rowcols(A0, b0.copy(), marker, np.zeros(A0.shape[0]))
    A_levels[0], b_levels[0] = A, b
    for i in range(n_levels - 1):
        A_levels[i + 1] = (Pl[i].T @ A_levels[i] @ Pl[i]).tocsr()
        b_levels[i + 1] = Pl[i].T @ b_levels[i]

    sols, u_l2, u_en, u_norm, ndofs = [], [], [], [], []
    for k in range(n_levels):
        Ak = A_levels[k]
        # fix exact-zero rows from eliminated components
        rowsum = np.asarray(np.abs(Ak).sum(axis=1)).ravel()
        zero = np.where(rowsum < 1e-14)[0]
        if zero.size:
            Ak = (Ak + sp.csr_matrix(
                (np.ones(zero.size), (zero, zero)), shape=Ak.shape)).tocsr()
        x = solve_spd(Ak, b_levels[k], solver)
        sols.append(x)
        ndofs.append(Ak.shape[0])
        h = x
        for j in range(k, 0, -1):
            h = Pl[j - 1] @ h
        u_norm.append(float(np.sqrt(abs(h @ (Ml[0] @ h)))))
        if k > 0:
            d = h - sols_f
            u_l2.append(float(np.sqrt(abs(d @ (Ml[0] @ d)))))
            u_en.append(float(np.sqrt(abs(d @ (A_levels[0] @ d))))
                        )
        else:
            sols_f = x
    return UpscalingResult(u_l2[::-1], u_en[::-1], u_norm, ndofs)
