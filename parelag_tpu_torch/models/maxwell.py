"""Maxwell (H(curl)) upscaling and AMGe-Hiptmair solve.

Rebuild of reference examples/UpscalingMaxwell.cpp: definite Maxwell
    (1/mu curl E, curl W) + (sigma E, W) = (RHS, W)
with essential tangential BC from the manufactured solution
E = (sin(k y), sin(k z), sin(k x)) on all boundary attributes, discontinuous
cherry-picked conductivity sigma in [1e-3, 1e3]
(UpscalingMaxwell.cpp:87-163), multilevel Hcurl upscaling and
Hiptmair-smoothed AMGe V-cycle solves.

A copy of parelag_tpu/models/maxwell.py; upscaling_maxwell takes
device= (None: the card, RuntimeError without one): with
use_amge_solver the fine level's Hiptmair AMGe hierarchy and its PCG
run there.
"""

import numpy as np

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.models.upscaling import (
    build_hierarchy, mark_dofs_on_bndr, eliminate_rowcols, solve_spd,
    UpscalingResult)

MU = 4.0 * np.pi * 1e-2
KAPPA = np.pi


def E_exact(p):
    out = np.zeros(p.shape)
    out[..., 0] = np.sin(KAPPA * p[..., 1])
    out[..., 1] = np.sin(KAPPA * p[..., 2])
    out[..., 2] = np.sin(KAPPA * p[..., 0])
    return out


def _fh(v):
    p, a, b, x0 = 9.0, 1e-9, np.pi / 8.0, 0.4
    return np.exp(p * np.sin(np.exp(v) / (np.arctan(a * (v - x0) + b))))


def sigma(p):
    return _fh(p[..., 0]) + _fh(p[..., 1]) + _fh(p[..., 2])


def rhs_exact(p):
    s = sigma(p)
    out = np.zeros(p.shape)
    f = (MU * s + KAPPA ** 2) / MU
    out[..., 0] = np.sin(KAPPA * p[..., 1]) * f
    out[..., 1] = np.sin(KAPPA * p[..., 2]) * f
    out[..., 2] = np.sin(KAPPA * p[..., 0]) * f
    return out


def upscaling_maxwell(nref_parallel=2, svd_tol=1e-9, upscaling_order=0,
                      solver="direct", smoother="hiptmair",
                      use_amge_solver=False,
                      device=None) -> UpscalingResult:
    device = resolve_device(device)
    mesh, topos, seqs = build_hierarchy(
        nref_parallel, svd_tol=svd_tol, upscaling_order=upscaling_order,
        coeff_hooks={1: sigma, 2: lambda p: np.full(p.shape[:-1], 1.0 / MU)})
    n_levels = len(seqs)
    form = 1

    Ml = [s.compute_mass_operator(1) for s in seqs]
    Wl = [s.compute_mass_operator(2) for s in seqs]
    Dl = [s.D[1] for s in seqs]
    Pl = [seqs[i].P[1] for i in range(n_levels - 1)]

    fe = seqs[0]
    b0 = fe.domain_lf_vector(1, rhs_exact)
    # essential data: interpolate E_exact circulations on boundary edges
    ess_all = fe.interpolate_vector_targets(1, [E_exact])[:, 0]
    bdr = fe.boundary_dofs(1)
    lift0 = np.where(bdr, ess_all, 0.0)

    rhs = [b0]
    ess_data = [lift0]
    for i in range(n_levels - 1):
        rhs.append(Pl[i].T @ rhs[i])
        ess_data.append(seqs[i].Pi[1].matrix @ ess_data[i])

    ess_attrs = {1, 2, 3, 4, 5, 6}
    sols, u_l2, u_en, u_norm, ndofs = [], [], [], [], []
    for k in range(n_levels):
        A = (Ml[k] + Dl[k].T @ Wl[k] @ Dl[k]).tocsr()
        marker = mark_dofs_on_bndr(seqs[k], form, ess_attrs)
        A2, b = eliminate_rowcols(A, rhs[k].copy(), marker, ess_data[k])
        if use_amge_solver and k == 0:
            from parelag_tpu_torch.solvers.amge_solver import (
                build_amge_hierarchy, amge_pcg_solve)
            H, _, _ = build_amge_hierarchy(seqs, 1, A2, smoother=smoother,
                                           device=device)
            x, info = amge_pcg_solve(H, H.levels[0].A, b, rtol=1e-8,
                                     device=device)
        else:
            x = solve_spd(A2, b, solver)
        sols.append(x)
        ndofs.append(A.shape[0])
        h = x
        for j in range(k, 0, -1):
            h = Pl[j - 1] @ h
        u_norm.append(float(np.sqrt(x @ (Ml[k] @ x))))
        if k > 0:
            d = h - sols[0]
            du = Dl[0] @ d
            u_l2.append(float(np.sqrt(d @ (Ml[0] @ d))))
            u_en.append(float(np.sqrt(du @ (Wl[0] @ du))))
    return UpscalingResult(u_l2[::-1], u_en[::-1], u_norm, ndofs)
