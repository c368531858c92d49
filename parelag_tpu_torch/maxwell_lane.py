"""The Maxwell lane on the card: a curl-curl + mass H(curl) system,
solved by f32 PCG preconditioned with a 2-level AMGe V-cycle whose
smoother is Hiptmair's (reference UpscalingMaxwell / MultigridTest1Form;
Hiptmair smoothing is the reference's 1-form default,
Create1FormParameterList.hpp:85-101).

Counterpart of bench.py::lane_maxwell, structured branch only: the
structured engine builds the whole de Rham chain of the nx^3 grid of
[0,1]^3 (fine level in f64), A = M1 + D1^T M2 D1 with every boundary edge
eliminated, a random right-hand side from RandomState(0), the H(curl)
prolongator of the first coarsening, and one potential derivative D0 per
level for the Hiptmair smoother (whose D, D^T and auxiliary operator are
ELL matrices: hopper_kernels.ell_spmv on the card).  The f32 solve is
followed by the lane's f64 restart loop: the host f64 residual is solved
again until the true relative residual meets RTOL or stops falling (the
f32 floor, reported as rel_res_floor).

    from parelag_tpu_torch import maxwell_lane
    record, _ = maxwell_lane.lane_maxwell(24)              # on the card
    record, _ = maxwell_lane.lane_maxwell(4, device="cpu")
"""

import time

import numpy as np
import torch

from parelag_tpu_torch import flagship, resolve_device
from parelag_tpu_torch.amge import structured as stc
from parelag_tpu_torch.models.upscaling import eliminate_rowcols
from parelag_tpu_torch.ops import hopper_kernels
from parelag_tpu_torch.solvers.cg import compile_pcg, pcg
from parelag_tpu_torch.solvers.hierarchy import build_hierarchy, rap
from parelag_tpu_torch.solvers.smoothers import make_hiptmair

#: PCG stop (r.z <= RTOL^2 r0.z0) and cap, and the f64 restart rounds
RTOL, MAXITER, RESTARTS = 1e-6, 200, 3
#: timed solves of lane_maxwell (the median is reported)
REPEATS = 3


def build_maxwell(nx, device=None):
    """The lane's host operators from the structured chain (run on
    `device`, None: the card).  Returns (A, b, A_levels, P_levels, D0):
    A (f64) and b after the boundary elimination, A_levels = [A in f32,
    P^T A P], P_levels = [P] (H(curl), f64), D0 = the two levels'
    potential derivatives (f64), all host scipy CSR / numpy."""
    shape = (nx, nx, nx)
    rng = np.random.RandomState(0)
    lvl0 = stc.fine_level(shape, dtype=torch.float64, device=device)
    levels, outs = stc.coarsen_chain(lvl0, 2)
    M = stc.global_mass(levels[0], 1).astype(np.float64)
    W = stc.global_mass(levels[0], 2).astype(np.float64)
    D = stc.global_derivative(levels[0], 1).astype(np.float64)
    A = (M + D.T @ W @ D).tocsr()
    b = rng.randn(A.shape[0])
    marker = stc.boundary_entity_marker(shape, 1)
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    P = stc.materialize_P(outs[0], levels[0].shape, 1).astype(np.float64)
    A_levels = [A.astype(np.float32)]
    A_levels.append(rap(A_levels[0], P))
    D0 = [stc.global_derivative(levels[l], 0).astype(np.float64)
          for l in range(2)]
    return A, b, A_levels, [P], D0


def build_solver(A_levels, P_levels, D0, device=None):
    """The lane's f32 hierarchy on `device` (None: the card): operators
    in the "auto" format (BCSR on the card, ELL on the CPU), Hiptmair
    smoothing with f32 D/D^T/A_aux, dense coarse inverse."""
    device = resolve_device(device)
    return build_hierarchy(
        A_levels, P_levels,
        lambda A_l, l: make_hiptmair(A_l, D0[l], dtype=np.float32,
                                     device=device),
        dtype=np.float32, device=device)


def solve(H, b):
    """f32 PCG on H's fine operator preconditioned by one V-cycle of H,
    at the lane's RTOL/MAXITER; the loop runs in Python.  Returns (x,
    (iterations, r.z))."""
    return pcg(H.levels[0].A.matvec, b, precond=H.apply, rtol=RTOL,
               atol=0.0, maxiter=MAXITER)


def compile_solve(H, b_like):
    """solve compiled for b_like's shape (solvers/cg.compile_pcg): on the
    card one CUDA graph with the loop on the device.  Returns solve(b)
    -> (x, (iterations, r.z)), a CompiledPcg."""
    return compile_pcg(H.levels[0].A.matvec, b_like, precond=H.apply,
                       rtol=RTOL, atol=0.0, maxiter=MAXITER)


def solve_refined(H, A, b, solver=None):
    """The lane's solve: one f32 PCG from b, then up to RESTARTS f32
    solves of the host f64 residual while the true relative residual is
    above RTOL and still falls; each through `solver` (a compile_solve
    of H; None: solve, the Python loop).  Returns (x in f64, iterations
    of the first solve, iterations in all, true relative residual)."""
    device = next(H.buffers()).device
    A64 = A.astype(np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    run = solver or (lambda v: solve(H, v))

    def dev_solve(v):
        y, (it, _) = run(torch.as_tensor(v.astype(np.float32)).to(device))
        return y.double().cpu().numpy(), int(it)

    x, first = dev_solve(b64)
    niter = first
    nb = max(float(np.linalg.norm(b64)), 1e-30)
    for _ in range(RESTARTS):
        r = b64 - A64 @ x
        rel = float(np.linalg.norm(r)) / nb
        if rel <= RTOL:
            break
        dx, it2 = dev_solve(r)
        if not np.isfinite(dx).all():
            break
        x2 = x + dx
        if float(np.linalg.norm(b64 - A64 @ x2)) / nb >= rel:
            break                        # f32 floor reached
        x = x2
        niter += it2
    return x, first, niter, float(np.linalg.norm(b64 - A64 @ x)) / nb


def lane_maxwell(nx, device=None):
    """The Maxwell record (bench.py::lane_maxwell's fields plus
    first_iters, the level shapes and formats, and `kernels`, the
    hand-kernel launches of the timed solves).  The f32 solve is
    compiled once (compile_solve: on the card one CUDA graph) and runs
    the restarts too; solve_s is the median of REPEATS solves of b
    through it: CUDA events on the card, the host clock on the CPU
    (timer says which), beside the Python loop's (flagship.loop_record's
    fields).  value counts the iterations of that timed solve
    (first_iters), not the restarts' that `iters` adds.
    Returns (record, (A_levels, P_levels, D0, b))."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        hopper_kernels.load()        # build the kernels outside setup_s
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    A, b, A_levels, P_levels, D0 = build_maxwell(nx, device)
    H = build_solver(A_levels, P_levels, D0, device)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    bt = torch.as_tensor(np.asarray(b, dtype=np.float32)).to(device)
    compiled = compile_solve(H, bt)
    x, first, niter, rel = solve_refined(H, A, b, compiled)
    loop = flagship.loop_record(lambda v: solve(H, v), compiled, bt)
    solve_s = loop["solve_s"]
    n = A.shape[0]
    lvl0 = H.levels[0]
    out = dict(metric="maxwell_hiptmair_amge_pcg", ndofs=n, iters=niter,
               first_iters=first, rel_res=rel, setup_s=setup_s,
               setup_backend="structured", **loop,
               value=n * first / solve_s,
               unit="dof_iter_per_s",
               timer="cuda_events" if on_card else "host_clock",
               level_shapes=[int(a.shape[0]) for a in A_levels],
               formats=[type(l.A).__name__ for l in H.levels],
               transfers=[type(lvl0.P).__name__, type(lvl0.R).__name__],
               hiptmair=[type(lvl0.pre.D).__name__,
                         type(lvl0.pre.Dt).__name__,
                         type(lvl0.pre.A_aux).__name__])
    if rel > RTOL:
        # the declared rtol is out of f32's reach: the floor, reported
        out["rel_res_floor"] = rel
    return out, (A_levels, P_levels, D0, b)
