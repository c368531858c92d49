"""The H1 flagship on the card: structured AMGe setup, bf16 V-cycle
preconditioned f32 PCG, checked on the host.

Counterpart of bench.py's flagship lane (`_structured_chain`,
`_build_h1_structured`, `_host_vcycle_pcg`/`_host_vcycle_prepare`,
`lane_h1`).  The problem is H1 (Poisson + mass) on an nx^3 hex grid of
[0,1]^3: surface load -1 on z=0, zero Dirichlet on the x and y walls.
The host pieces (boundary elimination, the Galerkin propagation of the
elimination term, the f64 scipy anchor) are copies of the JAX bench's
host code; `eliminate_rowcols` is models/upscaling.py's.
Each timed solve is compiled once (compile_solve: on the card one CUDA
graph with the loop test on the device, as bench.py jits its solve) and
timed beside the same solve's Python loop (loop_record).
With n_rhs set, lane_h1 adds the multi-RHS record of bench.py (block
PCG on n_rhs right-hand sides through the same hierarchy); with
cycle_cfg it runs that cycle (lane_autotune's winner, as bench.py feeds
its autotune lane's winner to the flagship).

    from parelag_tpu_torch import flagship
    record, _ = flagship.lane_h1(96)              # on the card
    record, _ = flagship.lane_h1(96, n_rhs=16)    # + record["multirhs"]
    at = flagship.lane_autotune(32)
    record, _ = flagship.lane_h1(96, cycle_cfg=at["best_structured_cfg"])
"""

import time

import numpy as np
import torch

from parelag_tpu_torch import resolve_device, synchronize
from parelag_tpu_torch.amge import structured as stc
from parelag_tpu_torch.models.upscaling import eliminate_rowcols
from parelag_tpu_torch.ops import graph_loop, hopper_kernels
from parelag_tpu_torch.solvers.autotune import _factory, tune_cycle
from parelag_tpu_torch.solvers.cg import compile_pcg, pcg
from parelag_tpu_torch.solvers.hierarchy import build_hierarchy

#: the flagship cycle: V(2,2) with l1-Jacobi smoothing
CYCLE = dict(mu=1, smoother="l1jacobi", sweeps=2)
#: PCG stop (r.z <= RTOL^2 r0.z0, as bench.py's lane) and its cap
RTOL, MAXITER = 1e-5, 100
#: timed solves of lane_h1 (the median is reported)
REPEATS = 3


def n_levels(nx, min_coarse=256):
    """Levels of the 2x2x2 chain on an nx^3 grid: coarsen while every
    axis is even and >= 4 and the coarse grid keeps >= min_coarse
    cells."""
    nlev, s = 1, (nx, nx, nx)
    while (all(x % 2 == 0 and x >= 4 for x in s)
           and np.prod([x // 2 for x in s]) >= min_coarse):
        s = tuple(x // 2 for x in s)
        nlev += 1
    return nlev


def structured_chain(nx, min_coarse=256, dtype=np.float32, device=None):
    """The structured coarsening chain of the flagship grid, on
    `device` (None: the card) with direct batched solves."""
    lvl0 = stc.fine_level((nx, nx, nx), dtype=dtype, device=device)
    return stc.coarsen_chain(lvl0, n_levels(nx, min_coarse))


def build_h1_structured(nx, min_coarse=256, dtype=np.float32,
                        device=None):
    """Flagship H1 operators via the structured engine (run on `device`,
    None: the card): per-level operators assemble from per-cell blocks
    (fine level: one analytic broadcast block) and the boundary
    elimination propagates as a Galerkin-corrected sparse term.  Returns
    (A_levels, P_levels, b) as host scipy CSR / numpy."""
    shape = (nx, nx, nx)
    levels, outs = structured_chain(nx, min_coarse, dtype, device)

    nv = (nx + 1) ** 3
    A0 = stc.assemble_global(
        stc.h1_uniform_cell_block(shape, dtype=dtype),
        stc.cell_verts(shape), nv)
    A_struct = [A0] + [stc.h1_stiffness(lvl).astype(dtype)
                       for lvl in levels[1:]]
    P_levels = [stc.materialize_P(out, lvl.shape, 0).tocsr()
                .astype(dtype)
                for lvl, out in zip(levels, outs)]

    # grid-index numbering == structured numbering: surface load -1 on
    # z=0, zero Dirichlet on the x/y walls
    n = nx + 1
    iz, iy, ix = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")          # C-ravel: x fastest
    marker = ((ix == 0) | (ix == nx)
              | (iy == 0) | (iy == nx)).ravel()
    h2 = (1.0 / nx) ** 2
    nadj = (np.where((ix == 0) | (ix == nx), 1, 2)
            * np.where((iy == 0) | (iy == nx), 1, 2))
    b = np.where(iz == 0, -h2 / 4.0 * nadj, 0.0).ravel().astype(dtype)

    Ae, be = eliminate_rowcols(A0.tocsr(), b, marker,
                               np.zeros(nv, dtype=dtype))
    A_levels = [Ae.astype(dtype)]
    C = (Ae - A0).tocsr()
    C.eliminate_zeros()
    for l, P in enumerate(P_levels):
        C = (P.T @ C @ P).tocsr()
        A_levels.append((A_struct[l + 1] + C).tocsr())
    return A_levels, P_levels, be


def host_vcycle_prepare(A_levels):
    dinvs = []
    for A in A_levels:
        d = np.asarray(np.abs(A).sum(axis=1)).ravel()
        dinvs.append(1.0 / np.where(d > 0, d, 1.0))
    coarse_inv = np.linalg.inv(A_levels[-1].toarray())
    return dinvs, coarse_inv


def host_vcycle_pcg(A_levels, P_levels, b, rtol, maxiter=100, sweeps=2,
                    prepared=None):
    """The CPU anchor: the same V(2,2)-cycle preconditioned CG with scipy
    CSR matvecs and numpy vectors (stops on ||r|| <= rtol ||b||).  Pass
    prepared=host_vcycle_prepare(A_levels) to keep the smoother and
    coarse factorization out of a timed region."""
    if prepared is None:
        prepared = host_vcycle_prepare(A_levels)
    dinvs, coarse_inv = prepared

    def smooth(l, bb, x):
        for _ in range(sweeps):
            x = x + dinvs[l] * (bb - A_levels[l] @ x)
        return x

    def cycle(l, bb):
        if l == len(A_levels) - 1:
            return coarse_inv @ bb
        x = smooth(l, bb, np.zeros_like(bb))
        r = bb - A_levels[l] @ x
        x = x + P_levels[l] @ cycle(l + 1, P_levels[l].T @ r)
        return smooth(l, bb, x)

    x = np.zeros_like(b)
    r = b.copy()
    z = cycle(0, r)
    p = z
    rz = r @ z
    nrm0 = np.linalg.norm(b)
    it = 0
    while it < maxiter:
        Ap = A_levels[0] @ p
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if np.linalg.norm(r) <= rtol * nrm0:
            break
        z = cycle(0, r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it + 1


def build_solver(A_levels, P_levels, device=None, cycle_cfg=None):
    """The flagship's device hierarchy in f32 (device None: the card):
    DIA operators (<= 48 offsets, else BCSR), bf16 transfers, the cycle
    cycle_cfg (None: CYCLE, l1-Jacobi V(2,2)).  Returns (H, Hb) with Hb
    = H cast to bf16 (the preconditioner; its coarse inverse stays
    f32)."""
    device = resolve_device(device)
    cfg = cycle_cfg or CYCLE
    H = build_hierarchy(A_levels, P_levels, _factory(cfg, device),
                        mu=cfg.get("mu", 1), dtype=np.float32,
                        matrix_format="dia", transfer_dtype=torch.bfloat16,
                        device=device)
    return H, H.cast(torch.bfloat16)


def _precond(Hb):
    def precond(r):
        return Hb.apply(r.to(torch.bfloat16)).to(torch.float32)
    return precond


def solve(H, Hb, b):
    """f32 PCG on H's fine operator, preconditioned by one bf16 V-cycle
    of Hb; b (n,) or (n, s) (block PCG, column-wise dots).  The loop
    runs in Python (solvers/cg.pcg).  Returns (x, (iterations, r.z))."""
    return pcg(H.levels[0].A.matvec, b, precond=_precond(Hb), rtol=RTOL,
               atol=0.0, maxiter=MAXITER)


def compile_solve(H, Hb, b_like):
    """solve compiled for b_like's shape (solvers/cg.compile_pcg): on the
    card one CUDA graph with the loop on the device, the same
    iterations and x as solve.  Returns solve(b) -> (x, (iterations,
    r.z)), a CompiledPcg."""
    return compile_pcg(H.levels[0].A.matvec, b_like, precond=_precond(Hb),
                       rtol=RTOL, atol=0.0, maxiter=MAXITER)


def timed_solves(solve, b, repeats=REPEATS):
    """`repeats` solves of b timed with CUDA events on the card and the
    host clock on the CPU: (seconds per solve, iterations per solve,
    hand-kernel launches during them: hopper_kernels.LAUNCHES's keys and
    pcg_loop_test)."""
    before = graph_loop.snapshot()
    times, iters = [], []
    for _ in range(repeats):
        if b.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, (it, _) = solve(b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            _, (it, _) = solve(b)
            times.append(time.perf_counter() - t0)
        iters.append(int(it))
    return times, iters, graph_loop.delta(graph_loop.snapshot(), before)


def _ported(launches):
    """The launches of the ports of the TPU kernels alone (the records'
    `kernels`)."""
    return {k: launches[k] for k in hopper_kernels.LAUNCHES}


def _x_rel(x, xp):
    """max over columns of ||x - xp|| / ||xp||, in f64."""
    x, xp = x.double(), xp.double()
    num = torch.linalg.norm((x - xp).reshape(x.shape[0], -1), dim=0)
    den = torch.linalg.norm(xp.reshape(x.shape[0], -1), dim=0)
    return float((num / den.clamp(min=1e-300)).max())


def loop_record(python_solve, solve, b, repeats=REPEATS):
    """A lane's timed solves of b through its compiled solve (`solve`: a
    CompiledPcg, or a function running the one in its `compiled`
    attribute) beside the same solve's Python loop (`python_solve`), as
    bench.py times a jitted solve after its first call.  Fields: loop ("device": one CUDA graph; "plain": the
    CPU program), compile_s (capture and instantiate), graph_nodes,
    loop_iters (a warm solve's iterations), solve_s (median) /
    solve_s_all / timed_iters / kernels of the compiled solve,
    loop_tests (pcg_loop_test launches), python_loop_iters /
    python_loop_s (median) / python_loop_s_all / python_loop_kernels,
    python_loop_x_rel (the largest column's relative difference of the
    two warm x); on the card also body_launches (the counted launches of
    one captured body), body_kernel_nodes and body_own_kernel_nodes (its
    kernel nodes, all and the hand-written kernels')."""
    x, (it, _) = solve(b)
    xp, (itp, _) = python_solve(b)
    times, iters, launches = timed_solves(solve, b, repeats)
    ptimes, _, plaunches = timed_solves(python_solve, b, repeats)
    compiled = getattr(solve, "compiled", solve)
    prog = compiled.program
    rec = dict(loop="plain" if prog is None else "device",
               compile_s=compiled.compile_s,
               graph_nodes=compiled.graph_nodes, loop_iters=int(it),
               solve_s=float(np.median(times)), solve_s_all=times,
               timed_iters=iters, kernels=_ported(launches),
               loop_tests=launches["pcg_loop_test"],
               python_loop_s=float(np.median(ptimes)),
               python_loop_s_all=ptimes, python_loop_iters=int(itp),
               python_loop_kernels=_ported(plaunches),
               python_loop_x_rel=_x_rel(x, xp))
    if prog is not None:
        rec.update(body_launches=sum(prog.body.values()),
                   body_kernel_nodes=prog.body_nodes[1],
                   body_own_kernel_nodes=prog.body_nodes[2])
    return rec


def multirhs_record(H, Hb, A0, n_rhs):
    """The multi-RHS record of bench.py's lane_h1 (bench.py:582-614) on
    the hierarchy of the 1-RHS solve: block PCG on B =
    RandomState(0).randn(ndofs, n_rhs) in f32 compiled once
    (compile_solve), one warm solve checked column by column in host f64
    (rel_res_max), column 0 solved alone on the card for comparison
    (col0_rel_diff), then REPEATS timed replays (median) beside the
    Python loop (loop_record)."""
    device = next(H.buffers()).device
    ndofs = A0.shape[0]
    B = np.random.RandomState(0).randn(ndofs, n_rhs).astype(np.float32)
    Bt = torch.as_tensor(B).to(device)
    compiled = compile_solve(H, Hb, Bt)
    X, (it, _) = compiled(Bt)
    niter = int(it)
    Xh = X.double().cpu().numpy()
    B64 = B.astype(np.float64)
    rel = (np.linalg.norm(B64 - A0.astype(np.float64) @ Xh, axis=0)
           / np.linalg.norm(B64, axis=0))
    x0, (it0, _) = solve(H, Hb, Bt[:, 0].contiguous())
    x0h = x0.double().cpu().numpy()
    col0 = float(np.linalg.norm(Xh[:, 0] - x0h) / np.linalg.norm(x0h))
    loop = loop_record(lambda v: solve(H, Hb, v), compiled, Bt)
    solve_s = loop["solve_s"]
    return dict(n_rhs=n_rhs, iters=niter, converged=niter < MAXITER,
                **loop, value=ndofs * niter * n_rhs / solve_s,
                unit="dof_iter_per_s",
                rel_res_max=float(rel.max()), rel_res_cols=rel.tolist(),
                col0_iters=int(it0), col0_rel_diff=col0)


def lane_h1(nx, device=None, n_rhs=None, min_coarse=256, cycle_cfg=None,
            levels=None):
    """The flagship record on the card: setup (structured chain + device
    hierarchy), the solve compiled once (compile_solve: one CUDA graph),
    one warm f32 PCG solve checked in host f64, REPEATS replays timed
    with CUDA events (median) beside the same solve's Python loop
    (loop_record's fields), and the host f64 scipy anchor on the same
    matrices.  `kernels` holds the hand-kernel launches of the timed
    solves (init + body x iterations of the graph).  With n_rhs, the
    record's "multirhs" entry is multirhs_record on the same hierarchy.
    cycle_cfg: the cycle (a DEFAULT_GRID row of solvers/autotune, None:
    CYCLE); the host anchor smooths with its sweeps (a Chebyshev
    degree stands in for them), as bench.py::lane_h1 sets them.
    levels: the (A_levels, P_levels, b) an earlier lane_h1 of the same
    grid returned, reused instead of built (setup_s then counts the
    device hierarchy alone).  Returns (record, (A_levels, P_levels, b));
    refuses to run without a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("lane_h1 measures the card and needs a CUDA "
                           f"device, not {device}")
    dtype = np.float32
    cfg = cycle_cfg or CYCLE
    sweeps = int(cfg.get("sweeps", cfg.get("degree", 2)))
    hopper_kernels.load()            # build the kernels outside setup_s
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    A_levels, P_levels, b = levels or build_h1_structured(
        nx, min_coarse, dtype, device)
    H, Hb = build_solver(A_levels, P_levels, device, cfg)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    ndofs = A_levels[0].shape[0]

    bt = torch.as_tensor(b.astype(dtype)).to(device)
    compiled = compile_solve(H, Hb, bt)
    x, (it, _) = compiled(bt)
    niter = int(it)
    xh = x.double().cpu().numpy()
    b64 = b.astype(np.float64)
    rel = float(np.linalg.norm(b64 - A_levels[0].astype(np.float64) @ xh)
                / np.linalg.norm(b64))

    loop = loop_record(lambda v: solve(H, Hb, v), compiled, bt)
    solve_s = loop["solve_s"]

    out = dict(metric="h1_amge_vcycle_pcg_throughput", ndofs=ndofs,
               cycle_cfg=dict(cfg), sweeps=sweeps,
               setup_reused=levels is not None,
               levels=len(H.levels),
               level_shapes=[int(a.shape[0]) for a in A_levels],
               formats=[type(l.A).__name__ for l in H.levels],
               transfers=[type(l.P).__name__ for l in H.levels
                          if l.P is not None],
               setup_s=setup_s, iters=niter, converged=niter < MAXITER,
               rel_res=rel, **loop, dof_iter_per_s=ndofs * niter / solve_s)
    if rel > RTOL:
        # the f32 solve's floor, reported beside the value
        out["rel_res_floor"] = rel

    Ah = [a.astype(np.float64) for a in A_levels]
    Ph = [p.astype(np.float64) for p in P_levels]
    prepared = host_vcycle_prepare(Ah)
    t0 = time.perf_counter()
    _, ith = host_vcycle_pcg(Ah, Ph, b64, rtol=RTOL, maxiter=MAXITER,
                             sweeps=sweeps, prepared=prepared)
    host_dt = time.perf_counter() - t0
    out.update(host_iters=ith, host_solve_s=host_dt,
               host_dof_iter_per_s=ndofs * ith / host_dt)
    out["vs_baseline"] = out["dof_iter_per_s"] / out["host_dof_iter_per_s"]
    if n_rhs:
        out["multirhs"] = multirhs_record(H, Hb, A_levels[0], n_rhs)
    return out, (A_levels, P_levels, b)


def lane_autotune(nx=32, device=None, repeats=3):
    """The cycle autotune record (bench.py::lane_autotune): tune_cycle's
    DEFAULT_GRID on three H1 hierarchies of the nx^3 grid on `device`
    (None: the card) --
      * the structured 2x2x2 chain (build_h1_structured, the flagship's
        setup) with DIA operators and the bf16 preconditioner;
      * the generic engine's 2x2x2 and 4x4x4 chains
        (generic_lane.build_h1 with pass 2 on `device`, min_coarse 64,
        operators from build_amge_hierarchy), DIA operators in f32;
    a factor set the grid does not divide, or that leaves one level, is
    skipped.  The record keeps the JAX lane's fields: grid (every row:
    granularity, cfg, iters, solve_s, converged), setup_s and tune_s per
    granularity, best_structured_cfg (the flagship's cycle), best_cfg
    and best_granularity (fastest over all), iters, solve_s and value
    (dof*iter/s of the winner); solve_s is timed with CUDA events on the
    card and the host clock on the CPU."""
    from parelag_tpu_torch import generic_lane
    from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()
    out = dict(metric="h1_amge_cycle_autotune", grid=[], setup_s={},
               tune_s={})
    best_all = None

    def record(gran, table, best, ndofs, setup_s, tune_s):
        nonlocal best_all
        out["setup_s"][gran] = setup_s
        out["tune_s"][gran] = tune_s
        out["grid"] += [dict(granularity=gran, cfg=r["cfg"],
                             iters=r["iters"], solve_s=r["solve_s"],
                             rel_res=r["rel_res"],
                             converged=r["converged"]) for r in table]
        if best and (best_all is None
                     or best["solve_s"] < best_all["solve_s"]):
            best_all = dict(best, granularity=gran, ndofs=ndofs)

    t0 = time.perf_counter()
    A_l, P_l, b_s = build_h1_structured(nx, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    best, table = tune_cycle(A_l, P_l, b_s, rtol=RTOL, dtype=np.float32,
                             matrix_format="dia",
                             precond_dtype=torch.bfloat16,
                             repeats=repeats, device=device)
    record("structured-2x2x2", table, best, A_l[0].shape[0], setup_s,
           time.perf_counter() - t0)
    if best:
        out["best_structured_cfg"] = best["cfg"]
    for factors in ((2, 2, 2), (4, 4, 4)):
        if generic_lane.n_levels(nx, 64, factors) < 2:
            continue
        t0 = time.perf_counter()
        topo = generic_lane.build_topologies(nx, 64, factors)
        seqs, A, b, _ = generic_lane.build_h1(nx, "device", device, 64,
                                              topo)
        _, A_levels, P_levels = build_amge_hierarchy(
            seqs, 0, A.astype(np.float32), dtype=np.float32,
            matrix_format="dia", device=device)
        synchronize(device)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        best, table = tune_cycle(A_levels, P_levels, b, rtol=RTOL,
                                 dtype=np.float32, matrix_format="dia",
                                 repeats=repeats, device=device)
        out["ndofs"] = A.shape[0]
        record("x".join(map(str, factors)), table, best, A.shape[0],
               setup_s, time.perf_counter() - t0)
    if best_all:
        out.update(best_cfg=best_all["cfg"],
                   best_granularity=best_all["granularity"],
                   iters=best_all["iters"], solve_s=best_all["solve_s"],
                   value=best_all["ndofs"] * best_all["iters"]
                   / best_all["solve_s"],
                   unit="dof_iter_per_s", device=str(device))
    return out
