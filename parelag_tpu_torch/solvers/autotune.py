"""Cycle-shape autotuning (PyTorch): measure a small grid of multigrid
cycle configurations (V vs W(mu), smoother family, sweep counts) on the
device and pick the fastest time-to-tolerance.

Counterpart of parelag_tpu/solvers/autotune.py (the reference leaves
the cycle type and relaxation to its XML solver library,
ParELAG_Hierarchy.hpp:114 "mu" and ParELAG_HypreSmootherFactory.cpp:
73-84).  The transfers and operators are fixed once; each candidate
builds its own hierarchy, and only the winner's is kept.  Solves are
timed with CUDA events on the card and with the host clock on the CPU
(the JAX version forces host reads, since its stack's
block_until_ready did not wait).

    best, table = tune_cycle(A_levels, P_levels, b, device=dev)
    H = best["hierarchy"]
"""

import time

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops.device_sparse import as_torch_dtype
from parelag_tpu_torch.solvers import smoothers as sm
from parelag_tpu_torch.solvers.cg import pcg
from parelag_tpu_torch.solvers.hierarchy import build_hierarchy

DEFAULT_GRID = (
    dict(mu=1, smoother="l1jacobi", sweeps=1),
    dict(mu=1, smoother="l1jacobi", sweeps=2),
    dict(mu=1, smoother="chebyshev", degree=2),
    dict(mu=1, smoother="chebyshev", degree=3),
    dict(mu=2, smoother="l1jacobi", sweeps=1),
    dict(mu=2, smoother="chebyshev", degree=2),
)


def _factory(cfg, device=None):
    if cfg["smoother"] == "l1jacobi":
        return lambda A, l: sm.make_l1_jacobi(
            A, sweeps=cfg.get("sweeps", 1), device=device)
    if cfg["smoother"] == "chebyshev":
        return lambda A, l: sm.make_chebyshev(
            A, degree=cfg.get("degree", 3), device=device)
    raise ValueError(cfg["smoother"])


def _seconds(fn, device):
    """Wall seconds of fn(): CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def tune_cycle(A_levels, P_levels, b, candidates=DEFAULT_GRID, rtol=1e-5,
               dtype=np.float32, matrix_format="auto", maxiter=200,
               precond_dtype=None, repeats=3, device=None):
    """Time PCG-to-rtol for each cycle candidate on `device` (None: the
    card); return (best, table).  Rows carry cfg, iters, solve_s (the
    least of `repeats` timed solves), rel_res (host f64) and converged
    (iters < maxiter and ||b - A x|| <= 10 rtol ||b||); the winner, the
    fastest converged row (None if none converged), also keeps its
    built `hierarchy`.  precond_dtype casts the preconditioner (e.g.
    torch.bfloat16, the flagship's).  b: host rhs of A_levels[0]."""
    device = resolve_device(device)
    A0 = A_levels[0]
    bt = torch.as_tensor(np.asarray(b).astype(dtype)).to(device)
    nrm0 = float(np.linalg.norm(np.asarray(b)))
    table = []
    for cfg in candidates:
        H = build_hierarchy(
            [a.astype(dtype) for a in A_levels],
            [p.astype(dtype) for p in P_levels],
            _factory(cfg, device), mu=cfg.get("mu", 1), dtype=dtype,
            matrix_format=matrix_format, device=device)
        Hp = H.cast(precond_dtype) if precond_dtype is not None else H
        pdt = (as_torch_dtype(precond_dtype) if precond_dtype is not None
               else None)

        def precond(r, Hp=Hp):
            if pdt is not None:
                return Hp.apply(r.to(pdt)).to(r.dtype)
            return Hp.apply(r)

        def solve(H=H, precond=precond):
            return pcg(H.levels[0].A.matvec, bt, precond=precond,
                       rtol=rtol, atol=0.0, maxiter=maxiter)

        x, (it, _) = solve()
        niter = int(it)
        res = float(np.linalg.norm(
            np.asarray(b) - A0 @ x.double().cpu().numpy()))
        converged = niter < maxiter and res <= 10 * rtol * max(nrm0, 1e-30)
        dt = min(_seconds(solve, device) for _ in range(max(1, repeats)))
        table.append(dict(cfg=cfg, iters=niter, solve_s=dt,
                          rel_res=res / max(nrm0, 1e-30),
                          converged=converged, hierarchy=H))
    ok = [row for row in table if row.get("converged")]
    best = min(ok, key=lambda r: r["solve_s"]) if ok else None
    for row in table:                     # only the winner keeps its H
        if row is not best:
            del row["hierarchy"]
    return best, table
