"""Device-time profile of the port's main paths on the card.

    python -m parelag_tpu_torch.kernel_profile       # 96^3, 24^3, 64^3
    python -m parelag_tpu_torch.kernel_profile --loop device,python
    python -m parelag_tpu_torch.kernel_profile --nx 32 --nx-maxwell 8 \
        --nx-generic 16
    python -m parelag_tpu_torch.kernel_profile --memory-only
    python -m parelag_tpu_torch.kernel_profile --tune-rows 128,256,512
    python -m parelag_tpu_torch.kernel_profile --ablate fill
    python -m parelag_tpu_torch.kernel_profile --ell-slots 1,2,4
    python -m parelag_tpu_torch.kernel_profile --darcy 64
    python -m parelag_tpu_torch.kernel_profile --library 5
    python -m parelag_tpu_torch.kernel_profile --spe10 30,55,21
    python -m parelag_tpu_torch.kernel_profile --ho 16 [--loop python]
    python -m parelag_tpu_torch.kernel_profile --formats
    python -m parelag_tpu_torch.kernel_profile --dist 8 [--dist-ny 4,32]
    python -m parelag_tpu_torch.kernel_profile --dist 8 --dist-mp
    python -m parelag_tpu_torch.kernel_profile --dia [--dia-variants]
        [--ablate compute|fill] [--dia-darcy 64]

Builds the H1 flagship hierarchy (flagship.build_h1_structured +
build_solver) and the Maxwell hierarchy (maxwell_lane), recording for
each build its wall time, the card's peak memory during it
(torch.cuda.max_memory_allocated after reset_peak_memory_stats) and the
bytes of the hierarchies' buffers ({"memory": ...} rows; --memory-only
stops there, and uses only the lanes' build functions, so it also runs
against an older checkout of the package).  Then the generic lane's
chain and f32 hierarchy (generic_lane.build_h1 with pass 2 on the card,
build_amge_hierarchy: a memory row too), and it traces with
torch.profiler (CPU and CUDA activities):

  * solves: REPS solves each of the 1-RHS flagship PCG, the 16-RHS block
    PCG, the Maxwell PCG and the generic AMGe PCG, after one warm-up
    solve, each compiled once as one CUDA graph and replayed (--loop
    device, the default: solvers/cg.compile_pcg through the lanes'
    compile_solve and compile_amge_pcg; compile_s and graph_nodes in the
    row) or with the loop in Python (--loop python, solvers/cg.pcg;
    --loop device,python gives both rows): wall time per
    solve (CUDA events, median, no profiler attached; wall_ms_profiled
    is the traced solves' host time), device busy time (the sum of the
    CUDA kernels', copies' and fills' device time in the trace), the
    idle share 1 - busy / wall, and device time by kernel;
  * kernels: LAUNCHES back-to-back calls of each hand-written kernel on
    the level-0 operators of those hierarchies (the main paths' largest
    shapes), of the multi-RHS DIA pair on level 1 too, and of bcsr_spmv
    / ell_spmv on every operator of the generic path's hierarchy in the
    format the path gives it (hierarchy.level_operators): device
    microseconds per launch; for every variant with a matrix operand
    (DIA, BCSR, ELL) also library_device_us, the device time of one
    torch.sparse_csr_tensor product on the same matrix and x, summed
    over all device work of that call (null where the library takes no
    mixed dtypes, or computes no fused sweep); the multi-RHS DIA rows
    carry their staging plan (hopper_kernels.dia_stage_plan), the ELL
    rows their launch plan (hopper_kernels.ell_launch_plan).  Every
    kernel row also has host_us_per_call, the host's time to enqueue one
    call of the wrapper (perf_counter over HOST_CALLS back-to-back calls
    with no synchronize inside), and library_host_us_per_call the same
    for the library call;
  * the launch floor: device and host microseconds of a one-element
    torch op (add_ on one f32) under the same profiler, the least a
    launch costs the card and the host;
  * --tune-rows R1,R2,...: the level-0 multi-RHS DIA variants again with
    the plan's row tile forced to each R (the shared-memory target
    raised to the kernels' limit, so R is not cut), one row per R;
  * --ell-slots S1,S2,...: the ELL variants again with the plan's
    slots a lane (hopper_kernels.ELL_SLOTS) set to each S, one row per
    S (the lanes a row follow from it);
  * --ablate compute|fill: builds the kernels with -DDIA_STAGE_ABLATE
    (csrc/dia.cu) so the staged DIA kernels, multi-RHS and 1-RHS, skip
    their sums (compute) or their copies into shared memory (fill), and
    times only the multi-RHS pair's level-0 variants (with --dia: the
    --dia rows): the split of their time between the two phases.  Those
    builds compute wrong results.

--darcy-block NREF times, alone, the kernel of every operator of the
blocked Darcy GMRES's f64 hierarchy (darcy_lane.lane_darcy_block) with
its library call and bound.

--library NREF profiles the XML solver library's scalar compositions on
the example chain at NREF refinements (library_lane.lane_library without
the Darcy chain): a solve row for each composition's solve() (f64, its
host plane included) and a kernel row, with bound_us, for each f64
operator of library_lane.kernel_operators (BCSR A0, P0, R0 of the form-0
AMGe hierarchy; ELL Hiptmair D0 and A_aux0 and the Krylov A0 of PCG +
AMS).

--spe10 NX,NY,NZ times the kernel of every operator of every level's f32
SA hierarchy of the generic SPE10 lane (darcy_lane.lane_spe10), with its
library call and bound.

--ho NX profiles the high-order lane at NX^3, p = 2 (ho_lane: the
setup with pass 2 on the card, then a memory row for its f32 hierarchy
and bf16 cast): a solve row for the f32 PCG with the bf16 V-cycle (as
one CUDA graph, or with --loop python the Python loop; wall
against device busy, the idle share, device time by hand kernel and by
torch kernel), and kernel rows for A0 (f32 ELL; bf16 ELL with bf16 and
with f32 x) and the bf16 BCSR P0 / R0 (bf16 and f32 x), each with
bound_us counted from the nonzeros and bound_slots_us from the format as
stored (the ELL table's padded slots).

--formats builds the A levels of every lane that builds a hierarchy
through solvers/hierarchy.build_hierarchy, at the smoke's sizes (h1
96^3, the autotune's generic chains at 32^3, Maxwell 24^3, generic
64^3, the darcy_hyb SA levels at 64^3, the SPE10 SA levels, the
library's hierarchies at nref 5 with its 32^3 Darcy chain, ho_p2 at 16^3
with and without RCM) on the card, and prints one row a level: the
format the build gave A, its rows, stored nonzeros, row width k (ELL
slots, the longest BCSR row, DIA offsets), dtype and, for ELL and BCSR,
the JAX package's 8 x 128 tile count of its nonzeros (the inputs of
hierarchy.a_format).  It uses only the lanes' build functions, so it
also runs against an older checkout (PYTHONPATH=old python
/path/to/kernel_profile.py --formats): the formats before and after a
change of the format rule, in one call.

--dist N profiles the dist lane (parallel/dist_bench) with N ranks as
the batch axis on the card at each ny_per_rank of --dist-ny (default
4,32: bench.py's shape and the weak-scaled one): a setup row (host
setup seconds, dofs per level), a solve row for one rank-batched
L-level V-cycle PCG step from the state after the init step (wall
against device busy, the idle share, device time by hand kernel and by
torch kernel), and kernel rows, with bound_us and the library call, for
ell_spmv on every operator the step applies
(dist_bench.level_operators).

--dia times only the 1-RHS DIA kernels, dia_spmv and dia_jacobi_sweep:
on every DIA level of the flagship's f32 hierarchy and its bf16 cast at
--nx (96: A0, A1, A2) and on the DIA part of the darcy_hyb outer
operator at --dia-darcy (64; 0: none), x, b and dw from a fixed seed,
each row with device us per launch, library_device_us (the SpMV's CSR
product), bound_us (the nonzeros, the offsets and each vector once) and
the launch plan (hopper_kernels.dia_row_plan; "one thread a row" in an
older checkout, which it also runs against: PYTHONPATH=old python
kernel_profile.py --dia, for the parent and the change in one call).
--dia-variants adds rows with each plan choice forced (DIA_VARIANTS:
the table staged or read from device memory, one or two rows a thread, x
from device memory); with --ablate compute|fill (above) the rows time
the pair without its sums or its copies into shared memory: the split
of their time (wrong results).

--darcy NX profiles the hybridized Darcy multiplier solve at NX^3 instead
(darcy_lane.build_darcy_hyb, HybridHdivL2._device_setup on the card: a
memory row): a solve row for the inner f32 PCG (rtol 1e-6, the first
refinement pass) and one for the whole refined _device_solve (rtol 1e-8,
its f64 host passes included); kernel rows for dia_spmv on the DIA part
of the outer operator and for bcsr_spmv / ell_spmv on every SA level's
A, P and R in the format the path gives them; op rows (device us per
call of all the torch work of one call) for the COO remainder
(index_add_), the facet block inverse and one V-cycle.  Every darcy row
carries bound_us, the least time of its function on the card: bytes (the
matrix's nonzeros with int32 indices, each vector read or written once)
over 3.35 TB/s or operations over 67 TFLOP/s, the larger.

The profiler can drop device events: every trace (trace()) expects the
events of one traced call alone times the calls, retakes a short trace
and marks a row whose last try stayed short (short_trace,
library_short_trace).

Prints one JSON object per line: the card (nvidia-smi name and power
limit, torch and CUDA versions), then {"memory": ...}, {"solve": ...}
and {"kernel": ...} rows as they are taken; --out FILE also gets each
row as it is printed, and a run that fails ends it with {"failed":
traceback}.  Needs a card; it imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import time
import traceback

import numpy as np
import torch

from parelag_tpu_torch import device as pick_device, flagship, maxwell_lane
from parelag_tpu_torch.ops import build, hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import (
    BcsrMatrix, DiaMatrix, EllMatrix, from_scipy)

REPS, LAUNCHES, N_RHS = 3, 20, 16
# H100 SXM peaks (NVIDIA data sheet, 700 W): device-memory bytes/s and
# FP32 FLOP/s outside the tensor cores, as chip_smoke.py's
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
PEAK_FLOPS_F64 = 34e12      # FP64 outside the tensor cores (data sheet)
HOST_CALLS = 200            # enqueues timed for host_us_per_call
MIXED_NOTE = "torch's CSR product takes one dtype for the matrix and x"
# --ablate: the phase the staged DIA kernels leave out, as csrc/dia.cu's
# DIA_STAGE_ABLATE
ABLATE = {"compute": 1, "fill": 2}
#: the hand kernel behind the product of each format that has one
KERNEL_OF = {BcsrMatrix: "bcsr_spmv", EllMatrix: "ell_spmv"}
SWEEP_NOTE = ("no single PyTorch call computes a fused Jacobi sweep "
              "x + dw * (b - A x)")

#: kernel-name fragment of each hand-written kernel (csrc/*.cu)
KERNEL_NAMES = {
    "dia_spmv_staged_kernel": "dia_spmv_multirhs",
    "dia_jacobi_staged_kernel": "dia_jacobi_sweep_multirhs",
    "dia_spmv_row_kernel": "dia_spmv",
    "dia_jacobi_row_kernel": "dia_jacobi_sweep",
    # the one-thread-a-row kernels of older checkouts (--dia beside one:
    # PYTHONPATH=old python kernel_profile.py --dia)
    "dia_spmv_kernel": "dia_spmv",
    "dia_jacobi_kernel": "dia_jacobi_sweep",
    "bcsr_row_spmm_kernel": "bcsr_spmv_multirhs",
    "bcsr_row_spmv_kernel": "bcsr_spmv",
    "ell_spmv_kernel": "ell_spmv",
    "pcg_loop_test_kernel": "pcg_loop_test",
}


def _label(name):
    for frag, label in KERNEL_NAMES.items():
        if frag in name:
            return label
    return "torch: " + name[:60]


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def _profile(fn, reps):
    """fn() reps times under torch.profiler: (host wall s per call,
    {label: [device us, count]} summed over the reps)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        slot = by.setdefault(_label(e.key), [0.0, 0])
        slot[0] += e.self_device_time_total
        slot[1] += e.count
    return wall, by


def trace(fn, reps, attempts=3):
    """Run fn() reps times under torch.profiler; returns (host wall s
    per call, device busy us per call, {label: [device us, count] per
    call}, info).  The profiler has been seen to drop device events (one
    launch in 20, all 20 of one kernel, every event of a trace), so the
    expected device events of the reps calls are taken from one traced
    call alone (hand kernels, library calls and torch ops alike) times
    reps, and never fewer than the hand-kernel launches the wrappers
    counted; a trace short of them is taken again, up to `attempts`
    times.  info holds traced_events, expected_events, traced_launches,
    launches and short_trace, true when the last try is still short."""
    for _ in range(attempts):
        # every call does some device work: a single-call trace without
        # any event dropped them all
        _, one = _profile(fn, 1)
        per_call = sum(v[1] for v in one.values())
        if per_call:
            break
    for _ in range(attempts):
        before = sum(hk.LAUNCHES.values())
        wall, by = _profile(fn, reps)
        launched = sum(hk.LAUNCHES.values()) - before
        events = sum(v[1] for v in by.values())
        seen = sum(v[1] for k, v in by.items() if k in hk.LAUNCHES)
        expected = max(per_call * reps, launched)
        short = not events or events < expected or seen < launched
        if not short:
            break
    busy = sum(v[0] for v in by.values()) / reps
    per = {k: [v[0] / reps, v[1] / reps] for k, v in by.items()}
    return wall, busy, per, dict(
        traced_events=events, expected_events=expected,
        traced_launches=seen, launches=launched, short_trace=short)


def _wall_s(fn, reps):
    """Median wall time of fn() in s, CUDA events around each call, with
    no profiler attached (the profiler slows the host side)."""
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / 1e3)
    return float(np.median(ts))


def _solve_row(name, fn):
    fn()                                      # warm-up
    wall = _wall_s(fn, REPS)
    wall_prof, busy, by, info = trace(fn, REPS)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])
    # busy is short by the dropped events where short_trace is set
    return dict(solve=name, wall_ms=wall * 1e3,
                wall_ms_profiled=wall_prof * 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / (wall * 1e3), **info,
                by_kernel={k: dict(device_ms=v[0] / 1e3, launches=v[1])
                           for k, v in top})


def _loops(spec):
    loops = spec.split(",")
    if not loops or set(loops) - {"device", "python"}:
        raise SystemExit(f"--loop {spec}: device and/or python")
    return loops


def _loop_solve_row(name, loop, python_solve, compile_solve, b):
    """_solve_row of one solve of b with its loop in Python (loop
    "python": python_solve()) or as one CUDA graph (loop "device": the
    compiled solve compile_solve() returns, compiled before the row and
    replayed in it), with the loop and, for "device", compile_s and
    graph_nodes."""
    if loop == "python":
        return dict(_solve_row(name, python_solve), loop=loop)
    solve = compile_solve()
    compiled = getattr(solve, "compiled", solve)    # a CompiledPcg
    return dict(_solve_row(name, lambda: solve(b)), loop=loop,
                compile_s=compiled.compile_s,
                graph_nodes=compiled.graph_nodes)


def _library_csr(M):
    """torch.sparse_csr_tensor of a BcsrMatrix, EllMatrix or DiaMatrix
    on its device (int64 indices, as the smoke's library operand; the
    nonzeros sorted through a COO tensor, in f32 for bf16 values, values
    in M's dtype)."""
    if isinstance(M, BcsrMatrix):
        return torch.sparse_csr_tensor(M.row_ptr.long(), M.col_idx.long(),
                                       M.values, M.shape)
    if isinstance(M, EllMatrix):
        n, k = M.values.shape
        rows = torch.arange(n, device=M.values.device).repeat_interleave(k)
        cols, vals = M.indices.reshape(-1).long(), M.values.reshape(-1)
    else:
        assert isinstance(M, DiaMatrix)
        n, m = M.shape
        i = torch.arange(n, device=M.data.device)
        j = torch.cat([i + o for o in M.offs])
        rows = i.repeat(len(M.offs))
        vals = M.data[:, :n].reshape(-1)
        inside = (j >= 0) & (j < m)
        rows, cols, vals = rows[inside], j[inside], vals[inside]
    keep = vals != 0
    vals = vals[keep]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]),
        vals.float() if vals.dtype == torch.bfloat16 else vals,
        M.shape).coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                   csr.values().to(M.dtype), M.shape)


def _plan_row(M, s, sweep=False):
    """The staging plan of the multi-RHS DIA kernels on M with s
    columns, as a row field."""
    p = hk.dia_stage_plan(M.offs, s, M.dtype, sweep)
    return dict(rows=p.rows, cols=p.cols, windows=len(p.windows),
                window_rows=[p.rows + hi - lo for lo, hi in p.windows],
                smem_bytes=p.smem_bytes)


def _buffer_bytes(*modules):
    """Bytes of the modules' buffers, a tensor shared between them (the
    coarse inverse of H and its bf16 cast) counted once."""
    seen = {}
    for mod in modules:
        for b in mod.buffers():
            seen[b.data_ptr()] = b.numel() * b.element_size()
    return sum(seen.values())


def _format_bytes(H, cls):
    return sum(b.numel() * b.element_size() for m in H.modules()
               if isinstance(m, cls) for b in m.buffers(recurse=False))


def _memory_row(lane, build, dev):
    """Wall time, card peak memory and hierarchy bytes of build()."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    hs = [h for h in out if isinstance(h, torch.nn.Module)]
    row = dict(memory=lane, build_s=secs, allocated_before=before,
               peak_allocated=torch.cuda.max_memory_allocated(dev),
               allocated_after=torch.cuda.memory_allocated(dev),
               hierarchy_bytes=_buffer_bytes(*hs),
               bcsr_bytes=sum(_format_bytes(h, BcsrMatrix) for h in hs))
    return row, out


def _host_us(fn):
    """Host microseconds to enqueue one fn(): perf_counter around
    HOST_CALLS back-to-back calls with no synchronize inside (the card
    drains them after), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def _timed_row(name, variant, M, v):
    """Device us per launch of the kernel behind fn (M @ v, or M() where
    v is None), with the library call's device time where M is a
    matrix, and the host us to enqueue each."""
    fn = M if v is None else (lambda: M @ v)
    fn()
    _, _, by, info = trace(fn, LAUNCHES)
    us, count = by.get(name, [0.0, 0])
    if count <= 0:
        raise RuntimeError(f"{name}[{variant}]: no launch of the kernel "
                           f"in the trace ({info['launches']} counted)")
    # per launch over the launches the trace holds
    row = dict(kernel=name, variant=variant,
               device_us_per_launch=us / count, **info,
               host_us_per_call=_host_us(fn))
    if v is None:
        row["library_device_us"] = None
        row["library_note"] = SWEEP_NOTE
    elif M.dtype == v.dtype:
        csr = _library_csr(M)
        lib = (lambda: csr @ v)
        lib()
        _, lib_us, _, lib_info = trace(lib, LAUNCHES)
        row["library_device_us"] = lib_us
        row["library_short_trace"] = lib_info["short_trace"]
        row["library_host_us_per_call"] = _host_us(lib)
    else:
        row["library_device_us"] = None
        row["library_note"] = MIXED_NOTE
    if isinstance(M, EllMatrix):
        row["plan"] = hk.ell_launch_plan(*M.values.shape)._asdict()
    return row


def _launch_floor_row(dev):
    """Device and host us of a one-element torch op: the least one
    launch costs the card (device time under the profiler) and the host
    (enqueue time).  A trace that lost every event has no device time
    (null), and is marked short."""
    t = torch.zeros(1, device=dev)
    fn = (lambda: t.add_(1))
    fn()
    _, busy, _, info = trace(fn, LAUNCHES)
    events = info["traced_events"]
    return dict(launch_floor="add_ on a one-element f32 tensor",
                device_us_per_launch=(busy * LAUNCHES / events if events
                                      else None),
                traced_events=events,
                expected_events=info["expected_events"],
                short_trace=info["short_trace"],
                host_us_per_call=_host_us(fn))


def _multirhs_dia_cases(H, Hb, level, X, tag):
    """The multi-RHS DIA SpMV (f32, bf16) and bf16 sweep on one level."""
    A, Ab = H.levels[level].A, Hb.levels[level].A
    dw = Hb.levels[level].pre.dinv
    Xb = X.to(torch.bfloat16)
    return [
        ("dia_spmv_multirhs", f"{tag} f32 s={N_RHS}", A, X,
         _plan_row(A, N_RHS)),
        ("dia_spmv_multirhs", f"{tag} bf16 s={N_RHS}", Ab, Xb,
         _plan_row(Ab, N_RHS)),
        ("dia_jacobi_sweep_multirhs", f"{tag} bf16 s={N_RHS}",
         lambda: hk.dia_jacobi_sweep_multirhs(Ab.data, Ab.offs, Xb, Xb, dw),
         None, _plan_row(Ab, N_RHS, sweep=True)),
    ]


def _generic_cases(Hg, dev):
    """bcsr_spmv / ell_spmv on every operator of the generic path's f32
    hierarchy in the format the path gives it
    (hierarchy.level_operators), each with an x from a fixed seed."""
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    rng = np.random.RandomState(3)
    return [(KERNEL_OF[type(M)], f"generic {label} f32", M,
             torch.as_tensor(rng.randn(M.shape[1]).astype(np.float32)
                             ).to(dev))
            for label, M in level_operators(Hg) if type(M) in KERNEL_OF]


def _kernel_rows(H, Hb, P0, Hm, Hg, dev):
    rng = np.random.RandomState(0)
    A = H.levels[0].A
    Ab = Hb.levels[0].A
    n = A.shape[0]
    x = torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
    X = torch.as_tensor(rng.randn(n, N_RHS).astype(np.float32)).to(dev)
    X1 = torch.as_tensor(rng.randn(H.levels[1].A.shape[0], N_RHS)
                         .astype(np.float32)).to(dev)
    dw = Hb.levels[0].pre.dinv
    xb = x.to(torch.bfloat16)
    Pb, Rb = Hb.levels[0].P, Hb.levels[0].R
    nc = Pb.shape[1]
    ec = torch.as_tensor(rng.randn(nc).astype(np.float32)).to(dev)
    Ec = torch.as_tensor(rng.randn(nc, N_RHS).astype(np.float32)).to(dev)
    Am, Pm, Rm = Hm.levels[0].A, Hm.levels[0].P, Hm.levels[0].R
    xe = {M: torch.as_tensor(rng.randn(M.shape[1]).astype(np.float32)
                             ).to(dev)
          for M in (Am, Pm, Rm)}
    ecb, Ecb = ec.to(torch.bfloat16), Ec.to(torch.bfloat16)
    # (kernel, variant, matrix, x[, plan]): a matrix and x of one dtype
    # also time the library's CSR product
    cases = [
        ("dia_spmv", "A0 f32", A, x),
        ("dia_spmv", "A0 bf16", Ab, xb),
        ("dia_jacobi_sweep", "A0 bf16",
         lambda: hk.dia_jacobi_sweep(Ab.data, Ab.offs, xb, xb, dw), None),
        *_multirhs_dia_cases(H, Hb, 0, X, "A0"),
        *_multirhs_dia_cases(H, Hb, 1, X1, "A1"),
        ("bcsr_spmv", "P0 bf16 values, bf16 x", Pb, ecb),
        ("bcsr_spmv", "P0 bf16 values, f32 x", Pb, ec),
        ("bcsr_spmv", "R0 bf16", Rb, xb),
        ("bcsr_spmv", "Maxwell A0 f32", Am, xe[Am]),
        ("bcsr_spmv", "Maxwell P0 f32", Pm, xe[Pm]),
        ("bcsr_spmv", "Maxwell R0 f32", Rm, xe[Rm]),
        ("bcsr_spmv_multirhs", f"P0 bf16 values, bf16 X s={N_RHS}", Pb,
         Ecb),
        ("bcsr_spmv_multirhs", f"P0 bf16 values, f32 X s={N_RHS}", Pb, Ec),
        ("bcsr_spmv_multirhs", f"R0 bf16 s={N_RHS}", Rb, X.to(torch.bfloat16)),
        *_ell_cases(P0, Hm, dev),
        *_generic_cases(Hg, dev),
    ]
    rows = []
    for name, variant, M, v, *plan in cases:
        rows.append(_timed_row(name, variant, M, v))
        if plan:
            rows[-1]["plan"] = plan[0]
    return rows


def _ell_cases(P0, Hm, dev):
    """ell_spmv on Hiptmair's level-0 ELL operators of the Maxwell
    hierarchy and on the flagship's P0 as ELL, each with an x from a
    fixed seed."""
    hip = Hm.levels[0].pre
    rng = np.random.RandomState(2)
    mats = [("Maxwell A_aux", hip.A_aux), ("Maxwell D0", hip.D),
            ("Maxwell D0^T", hip.Dt),
            ("flagship P0 as ELL", from_scipy(P0, dtype=np.float32,
                                              device=dev))]
    return [("ell_spmv", f"{label} f32", M,
             torch.as_tensor(rng.randn(M.shape[1]).astype(np.float32)
                             ).to(dev))
            for label, M in mats]


def _bound_us(nbytes, flops, peak_flops=PEAK_FLOPS):
    return max(nbytes / PEAK_BYTES, flops / peak_flops) * 1e6


def _nnz(M):
    """Stored nonzeros of a BcsrMatrix, EllMatrix, DiaMatrix or
    CooMatrix (padding and explicit zeros not counted)."""
    vals = {BcsrMatrix: "values", EllMatrix: "values",
            DiaMatrix: "data"}.get(type(M), "vals")
    return int((getattr(M, vals) != 0).sum())


def _sparse_bytes(M, item=4):
    """The least a product y = M x reads and writes: the nonzeros'
    values with int32 column indices and row pointers (DIA: the values
    and the offsets), x once and y once."""
    n, m = M.shape
    if isinstance(M, DiaMatrix):
        return _nnz(M) * item + 4 * len(M.offs) + (n + m) * item
    return _nnz(M) * (item + 4) + 4 * (n + 1) + (n + m) * item


def _op_row(op, variant, fn, nbytes, flops, library=None, note=None):
    """Device us of all the device work of one fn() (a torch op or a
    composite), with its bound, the host us to enqueue it and the library
    call's device time where one PyTorch call computes the same."""
    fn()
    _, busy, by, info = trace(fn, LAUNCHES)
    row = dict(op=op, variant=variant, device_us_per_call=busy,
               bound_us=_bound_us(nbytes, flops), bytes=nbytes, flops=flops,
               **info, host_us_per_call=_host_us(fn),
               by_kernel={k: dict(device_us=v[0], launches=v[1])
                          for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1][0])})
    if library is None:
        row.update(library_device_us=None, library_note=note)
    else:
        library()
        _, lib_us, _, lib_info = trace(library, LAUNCHES)
        row.update(library_device_us=lib_us,
                   library_short_trace=lib_info["short_trace"])
    return row


def _coo_csr(C):
    """torch.sparse_csr_tensor of a CooMatrix (duplicates summed)."""
    csr = torch.sparse_coo_tensor(
        torch.stack([C.rows.long(), C.cols.long()]), C.vals,
        C.shape).coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                   csr.values(), C.shape)


def _darcy(nx, dev, emit):
    """The --darcy rows (see the module docstring)."""
    from parelag_tpu_torch import darcy_lane
    from parelag_tpu_torch.solvers.cg import pcg
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    hk.load()
    hyb, Hs, gf = darcy_lane.build_darcy_hyb(nx)
    mem, (perm, Hd, Hier, npad, _, _) = _memory_row(
        f"darcy_hyb {nx}^3", lambda: hyb._device_setup(Hs, dev), dev)
    emit(mem)
    n = Hs.shape[0]
    rfull = np.zeros(npad)
    rfull[:n] = gf
    b = torch.as_tensor(rfull[perm].astype(np.float32)).to(dev)
    emit(_solve_row(
        f"darcy_hyb {nx}^3 inner f32 PCG (rtol 1e-6)",
        lambda: pcg(Hd.matvec, b, precond=Hier.cycle, rtol=1e-6, atol=0.0,
                    maxiter=2000)))
    emit(_solve_row(
        f"darcy_hyb {nx}^3 _device_solve (refined to rtol "
        f"{darcy_lane.RTOL:g})",
        lambda: hyb._device_solve(Hs, gf, rtol=darcy_lane.RTOL,
                                  device=dev)))
    rng = np.random.RandomState(4)

    def vec(m):
        return torch.as_tensor(rng.randn(m).astype(np.float32)).to(dev)

    x = vec(npad)
    D, R = Hd.dia, Hd.ell
    row = _timed_row("dia_spmv", f"Hd DIA part f32 nd={len(D.offs)} "
                     f"n={npad}", D, x)
    row.update(bound_us=_bound_us(_sparse_bytes(D), 2 * _nnz(D)),
               nnz=_nnz(D))
    emit(row)
    csr = _coo_csr(R)
    emit(_op_row("coo remainder", f"Hd COO part nnz={_nnz(R)} n={npad}",
                 lambda: R @ x, _nnz(R) * 12 + 2 * npad * 4, 2 * _nnz(R),
                 library=lambda: csr @ x))
    binv = Hier.levels[0].pre.binv
    nb = sum(T.numel() * T.element_size() for T in binv.tensors)
    emit(_op_row("block inverse", f"sizes {binv.sizes} n={npad}",
                 lambda: binv @ x, nb + 2 * npad * 4,
                 sum(T.numel() * 2 for T in binv.tensors),
                 note="the op is torch's elementwise product (1 x 1 "
                 "blocks) or einsum: no other library call"))
    for label, M in level_operators(Hier):
        name = KERNEL_OF.get(type(M))
        if name is None:
            continue
        row = _timed_row(name, f"SA {label} f32 {M.shape[0]}x{M.shape[1]} "
                         f"nnz={_nnz(M)}", M, vec(M.shape[1]))
        row.update(bound_us=_bound_us(_sparse_bytes(M), 2 * _nnz(M)),
                   nnz=_nnz(M), max_row=(
                       int(M.row_ptr.diff().max()) if name == "bcsr_spmv"
                       else int(M.values.shape[1])))
        emit(row)
    emit(_op_row("V-cycle", f"{len(Hier.levels)} levels n={npad}",
                 lambda: Hier.cycle(x), 0, 0,
                 note="a composite of the rows above and torch ops"))


# --dia-variants: the 1-RHS DIA plan's choices forced one at a time
DIA_VARIANTS = {
    "table staged": {"ROW_TABLE_STAGED": True},
    "table direct": {"ROW_TABLE_STAGED": False, "ROW_MIN_TILES": 0},
    "RT=1": {"ROW_ROWS": 1},
    "RT=2": {"ROW_ROWS": 2, "ROW_MIN_TILES": 0},
    "x via L1/L2": {"staged": False},
}


def _dia_variant(name):
    """Patch hopper_kernels for one --dia-variants entry; returns the undo
    function.  The plan is rebuilt for each (its cache cleared)."""
    saved = {}
    plan = hk.dia_row_plan
    for key, value in DIA_VARIANTS[name].items():
        if key == "staged":
            saved["dia_row_plan"] = plan
            hk.dia_row_plan = (lambda *a: plan(*a)._replace(staged=False,
                                                            center=-1))
            continue
        saved[key] = getattr(hk, key)
        setattr(hk, key, dict.fromkeys(saved[key], value)
                if isinstance(saved[key], dict) else value)
    plan.cache_clear()

    def undo():
        for key, value in saved.items():
            setattr(hk, key, value)
        plan.cache_clear()
    return undo


def _dia(args, dev, emit):
    """The --dia rows (see the module docstring)."""
    from parelag_tpu_torch import darcy_lane
    hk.load()
    A_levels, P_levels, _ = flagship.build_h1_structured(args.nx, device=dev)
    H, Hb = flagship.build_solver(A_levels, P_levels, dev)
    cases = [(f"A{l} {tag}", Hx.levels[l].A)
             for l in range(len(H.levels))
             for Hx, tag in ((H, "f32"), (Hb, "bf16"))
             if isinstance(Hx.levels[l].A, DiaMatrix)]
    if args.dia_darcy:
        hyb, Hs, _ = darcy_lane.build_darcy_hyb(args.dia_darcy)
        _, Hd, _, _, _, _ = hyb._device_setup(Hs, dev)
        cases.append(("darcy Hd DIA part f32", Hd.dia))
    new = hasattr(hk, "dia_row_plan")
    variants = ["plan"] + (list(DIA_VARIANTS) if args.dia_variants and new
                           else [])
    rng = np.random.RandomState(5)
    for label, M in cases:
        n = M.shape[0]
        x, b = (torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
                .to(M.dtype) for _ in range(2))
        dw = torch.as_tensor(rng.rand(n).astype(np.float32)).to(dev).to(
            M.dtype)
        item, nnz = x.element_size(), _nnz(M)
        for variant in variants:
            undo = _dia_variant(variant) if variant != "plan" else None
            try:
                for kernel, fn, v, extra, flops in (
                        ("dia_spmv", M, x, 0, 2 * nnz),
                        ("dia_jacobi_sweep", lambda: hk.dia_jacobi_sweep(
                            M.data, M.offs, x, b, dw), None, 2 * n * item,
                         2 * nnz + 3 * n)):
                    row = _timed_row(kernel, f"{label} n={n} nd="
                                     f"{len(M.offs)} {variant}", fn, v)
                    row.update(
                        bound_us=_bound_us(_sparse_bytes(M, item) + extra,
                                           flops),
                        nnz=nnz, format_bytes=M.data.numel() * item,
                        variant_of_plan=variant, ablate=args.ablate,
                        plan=(hk.dia_row_plan(
                            M.offs, n, n, M.dtype,
                            kernel == "dia_jacobi_sweep").tag()
                            if new else "one thread a row"))
                    emit(row)
            finally:
                if undo:
                    undo()


def _darcy_block(nref, dev, emit):
    """The --darcy-block rows: the kernel of every operator a cycle of
    the blocked Darcy GMRES's f64 hierarchy (darcy_lane.lane_darcy_block)
    applies, in the format the path gives it, with its bound."""
    from parelag_tpu_torch import darcy_lane
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    hk.load()
    _, (H, _) = darcy_lane.lane_darcy_block(nref, dev)
    for row in _operator_rows("block", level_operators(H), dev,
                              np.random.RandomState(5)):
        emit(row)


def _operator_rows(path, mats, dev, rng):
    """Kernel rows (device us per launch, library device us, bound_us)
    of bcsr_spmv / ell_spmv on each (label, operator) of a path, in the
    format and dtype the path gave it."""
    rows = []
    for label, M in mats:
        name = KERNEL_OF.get(type(M))
        if name is None:
            continue
        v = torch.as_tensor(rng.randn(M.shape[1])).to(M.dtype).to(dev)
        row = _timed_row(name, f"{path} {label} {M.dtype} "
                         f"{M.shape[0]}x{M.shape[1]} nnz={_nnz(M)}", M, v)
        row.update(bound_us=_bound_us(
            _sparse_bytes(M, v.element_size()), 2 * _nnz(M),
            PEAK_FLOPS_F64 if M.dtype == torch.float64 else PEAK_FLOPS),
            nnz=_nnz(M))
        rows.append(row)
    return rows


def _library(nref, dev, emit):
    """The --library rows (see the module docstring)."""
    from parelag_tpu_torch import library_lane
    hk.load()
    rec, solvers, solves = library_lane.lane_library(nref, dev,
                                                     darcy_nref=0)
    emit(dict(library={k: v for k, v in rec.items()
                       if k != "compositions"}))
    for name, c in rec["compositions"].items():
        emit(dict(composition=name, **c))
        b = solves[name][0]
        emit(_solve_row(f"library {name} nref {nref} (n={c['n']}, f64)",
                        lambda s=solvers[name], b=b: s.solve(b)))
    for row in _operator_rows("library",
                              library_lane.kernel_operators(solvers), dev,
                              np.random.RandomState(6)):
        emit(row)


def _spe10(cells, dev, emit):
    """The --spe10 rows (see the module docstring)."""
    from parelag_tpu_torch import darcy_lane
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    hk.load()
    _, out = darcy_lane.lane_spe10(cells, dev)
    rng = np.random.RandomState(7)
    for l, (H, Hd) in enumerate(zip(out["device_hierarchies"],
                                    out["device_operators"])):
        if hasattr(Hd, "dia"):
            D = Hd.dia
            x = torch.as_tensor(rng.randn(D.shape[1]).astype(np.float32)
                                ).to(dev)
            row = _timed_row("dia_spmv", f"spe10 L{l} Hd DIA part f32 "
                             f"nd={len(D.offs)} n={D.shape[0]}", D, x)
            row.update(bound_us=_bound_us(_sparse_bytes(D), 2 * _nnz(D)),
                       nnz=_nnz(D))
            emit(row)
        if H is not None:
            for row in _operator_rows(f"spe10 L{l} SA", level_operators(H),
                                      dev, rng):
                emit(row)


def _ho(nx, dev, emit, loop="device"):
    """The --ho rows (see the module docstring)."""
    from parelag_tpu_torch import ho_lane
    hk.load()
    seqs, A, b, split = ho_lane.build_ho(nx, ho_lane.P, dev)
    emit(dict(ho_setup=f"{nx}^3 p={ho_lane.P}", ndofs=A.shape[0],
              nnz=A.nnz, **split))
    mem, (H, Hb, _, _) = _memory_row(
        f"ho_p{ho_lane.P} {nx}^3",
        lambda: ho_lane.build_solver(seqs, A, dev), dev)
    emit(mem)
    bt = torch.as_tensor(b.astype(np.float32)).to(dev)
    for lp in _loops(loop):
        emit(_loop_solve_row(
            f"ho_p{ho_lane.P} {nx}^3 f32 PCG, bf16 V(2,2)", lp,
            lambda: ho_lane.solve(H, Hb, bt),
            lambda: ho_lane.compile_solve(H, Hb, bt), bt))
    rng = np.random.RandomState(8)
    bf16, f32 = torch.bfloat16, torch.float32
    lvl, lvlb = H.levels[0], Hb.levels[0]
    for label, M, xdts in (("A0", lvl.A, (f32,)), ("A0", lvlb.A, (bf16, f32)),
                           ("P0", lvlb.P, (bf16, f32)),
                           ("R0", lvlb.R, (bf16, f32))):
        name = KERNEL_OF[type(M)]
        n, m = M.shape
        nnz = _nnz(M)
        stored = sum(t.numel() * t.element_size() for t in M.buffers())
        for xdt in xdts:
            v = torch.as_tensor(rng.randn(m).astype(np.float32)).to(xdt)
            v = v.to(dev)
            io = m * v.element_size() + n * torch.empty(
                (), dtype=torch.promote_types(M.dtype, xdt)).element_size()
            row = _timed_row(name, f"ho {label} {M.dtype} values {xdt} x "
                             f"{n}x{m} nnz={nnz}", M, v)
            row.update(
                nnz=nnz, stored_bytes=stored,
                bound_us=_bound_us(nnz * (M.values.element_size() + 4)
                                   + 4 * (n + 1) + io, 2 * nnz),
                bound_slots_us=(stored + io) / PEAK_BYTES * 1e6)
            emit(row)


def _format_rows(lane, H):
    """One row a level of H: the format of A, rows, stored nonzeros, row
    width k, dtype and tile count (the inputs of the A-format rule)."""
    import scipy.sparse as sp
    from parelag_tpu_torch.ops.device_sparse import bcsr_stats
    rows = []
    for l, lvl in enumerate(H.levels):
        A = lvl.A
        tiles = None
        if isinstance(A, BcsrMatrix):
            k = int(A.row_ptr.diff().max())
            tiles = A.nbr * A.kb
        elif isinstance(A, EllMatrix):
            n, k = A.values.shape
            vals = A.values.reshape(-1).cpu().double().numpy()
            keep = vals != 0
            M = sp.csr_matrix((vals[keep], (np.repeat(np.arange(n), k)[keep],
                                            A.indices.reshape(-1).cpu()
                                            .numpy()[keep])), shape=A.shape)
            nbr, kb, _ = bcsr_stats(M)
            tiles = nbr * kb
        elif isinstance(A, DiaMatrix):
            k = len(A.offs)
        else:
            k = None
        rows.append(dict(formats=lane, level=l, format=type(A).__name__,
                         n=int(A.shape[0]), nnz=_nnz(A), k=k, tiles=tiles,
                         dtype=str(A.dtype),
                         coarsest=lvl.coarse_inv is not None))
    return rows


def _formats(dev, emit):
    """The --formats rows (see the module docstring)."""
    from parelag_tpu_torch import darcy_lane, generic_lane, ho_lane
    from parelag_tpu_torch import library_lane
    from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
    hk.load()

    def report(lane, H):
        for row in _format_rows(lane, H):
            emit(row)

    A_l, P_l, _ = flagship.build_h1_structured(96, device=dev)
    report("h1 96", flagship.build_solver(A_l, P_l, dev)[0])
    del A_l, P_l
    for factors in ((2, 2, 2), (4, 4, 4)):
        topo = generic_lane.build_topologies(32, 64, factors)
        seqs, A, _, _ = generic_lane.build_h1(32, "device", dev, 64, topo)
        H, _, _ = build_amge_hierarchy(
            seqs, 0, A.astype(np.float32), dtype=np.float32,
            matrix_format="dia", device=dev)
        report(f"autotune generic {factors} 32", H)
    _, _, MA, MP, MD0 = maxwell_lane.build_maxwell(24, dev)
    report("maxwell 24", maxwell_lane.build_solver(MA, MP, MD0, dev))
    seqs, A, _, _ = generic_lane.build_h1(64, "device", dev)
    H, _, _ = build_amge_hierarchy(
        seqs, 0, A.astype(np.float32), sweeps=generic_lane.SWEEPS,
        dtype=np.float32, device=dev)
    report("generic 64", H)
    del seqs, A, H
    hyb, Hs, _ = darcy_lane.build_darcy_hyb(64)
    report("darcy_hyb SA 64", hyb._device_setup(Hs, dev)[2])
    del hyb, Hs
    _, out = darcy_lane.lane_spe10(darcy_lane.SPE10_CELLS, dev)
    for l, H in enumerate(out["device_hierarchies"]):
        if H is not None:
            report(f"spe10 L{l} SA", H)
    del out
    _, solvers, _ = library_lane.lane_library(library_lane.LIB_NREF, dev)
    for name, s in solvers.items():
        H = library_lane.hierarchy_of(s)
        if H is not None:
            report(f"library {name}", H)
    del solvers
    seqs, A, _, _ = ho_lane.build_ho(ho_lane.NX, ho_lane.P, dev)
    report("ho 16", ho_lane.build_solver(seqs, A, dev)[0])
    report("ho 16 rcm", ho_lane.build_solver(seqs, A, dev,
                                             reorder="rcm")[0])


def _dist(n, nys, dev, emit):
    """The --dist rows (see the module docstring)."""
    from parelag_tpu_torch.parallel import dist_bench
    from parelag_tpu_torch.parallel.sharding import (
        distributed_mg_l_step, make_dd_mesh)
    hk.load()
    mesh = make_dd_mesh(n, dev)
    for ny in nys:
        t0 = time.perf_counter()
        _, hier, b = dist_bench.build(n, ny)
        emit(dict(dist_setup=f"{n} ranks ny_per_rank={ny}",
                  setup_s=time.perf_counter() - t0,
                  level_ndofs=[int(s.ndofs) for s in hier.systems]))
        levels, cinv, g2v = hier.device_args(mesh)
        step = distributed_mg_l_step(mesh, hier)(levels)
        st = dist_bench.steps_from_zero(hier, b, mesh)(0)
        emit(_solve_row(f"dist {n} ranks ny_per_rank={ny} one L-level "
                        f"step ({hier.systems[0].ndofs} dofs, f32)",
                        lambda: step(levels, cinv, g2v, *st)))
        for row in _operator_rows(f"dist ny={ny}",
                                  dist_bench.level_operators(levels), dev,
                                  np.random.RandomState(9)):
            emit(row)


#: (processes, ny_per_rank) of --dist-mp: the smoke's dist_mp runs, and
#: the processes of its f64 solve case
DIST_MP = ((2, 4), (2, 32), (4, 4))
MP_WORLD = 2


def _dist_mp(n, dev, emit):
    """The --dist-mp rows: ell_spmv on each process's own rows of the
    dist lane at every DIST_MP entry (a RankMesh of that world and rank:
    _level reads only the mesh's rank range, no process group) and on
    each process's f64 tables of mp_worker's solve case, as the smoke's
    dist_operators builds them."""
    from parelag_tpu_torch.parallel import dist_bench, mp_worker
    from parelag_tpu_torch.parallel.sharding import RankMesh
    hk.load()
    rng = np.random.RandomState(10)
    hiers = {}
    for world, ny in DIST_MP:
        if ny not in hiers:
            hiers[ny] = dist_bench.build(n, ny)[1]
        for rank in range(world):
            mesh = RankMesh(n, dev, world=world, rank=rank)
            levels = hiers[ny].device_args(mesh)[0]
            for row in _operator_rows(
                    f"dist_mp {world}p ny={ny} process {rank}",
                    dist_bench.level_operators(levels), dev, rng):
                emit(row)
    solve_hier = mp_worker.solve_problem()[0]
    for rank in range(MP_WORLD):
        mesh = RankMesh(mp_worker.RANKS, dev, world=MP_WORLD, rank=rank)
        for row in _operator_rows(
                f"dist_mp solve {MP_WORLD}p process {rank}",
                dist_bench.level_operators(solve_hier.device_args(mesh)[0]),
                dev, rng):
            emit(row)


def _tune_ell(P0, Hm, dev, slots):
    """The ELL variants with hopper_kernels.ELL_SLOTS set to each S in
    slots; the setting and the plan cache are restored after."""
    saved = hk.ELL_SLOTS
    rows = []
    try:
        for s in slots:
            hk.ELL_SLOTS = s
            hk.ell_launch_plan.cache_clear()
            for name, variant, M, v in _ell_cases(P0, Hm, dev):
                rows.append(_timed_row(name, f"{variant} ELL_SLOTS={s}", M,
                                       v))
                rows[-1]["ell_slots"] = s
    finally:
        hk.ELL_SLOTS = saved
        hk.ell_launch_plan.cache_clear()
    return rows


def _tune_rows(H, Hb, dev, tiles):
    """The level-0 multi-RHS DIA variants with the plan's row tile forced
    to each R in tiles; the plan cache and settings are restored
    after."""
    X = torch.as_tensor(np.random.RandomState(1).randn(
        H.levels[0].A.shape[0], N_RHS).astype(np.float32)).to(dev)
    saved = dict(hk.STAGE_ROWS), hk.STAGE_TARGET_BYTES
    rows = []
    try:
        hk.STAGE_TARGET_BYTES = hk.STAGE_MAX_BYTES
        for R in tiles:
            hk.STAGE_ROWS.update({torch.float32: R, torch.bfloat16: R})
            hk.dia_stage_plan.cache_clear()
            for name, variant, M, v, plan in _multirhs_dia_cases(
                    H, Hb, 0, X, "A0"):
                row = _timed_row(name, f"{variant} R={R}", M, v)
                row.update(stage_rows=R, plan=plan)
                rows.append(row)
    finally:
        hk.STAGE_ROWS.update(saved[0])
        hk.STAGE_TARGET_BYTES = saved[1]
        hk.dia_stage_plan.cache_clear()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--nx-maxwell", type=int, default=24)
    ap.add_argument("--nx-generic", type=int, default=64)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--memory-only", action="store_true",
                    help="stop after the two builds' memory rows")
    ap.add_argument("--tune-rows", default=None,
                    help="comma-separated row tiles R to time the level-0 "
                    "multi-RHS DIA variants at")
    ap.add_argument("--ell-slots", default=None,
                    help="comma-separated slots a lane to time the ELL "
                    "variants at")
    ap.add_argument("--darcy", type=int, default=0,
                    help="profile only the hybridized Darcy multiplier "
                    "solve at this grid (e.g. 64)")
    ap.add_argument("--darcy-block", type=int, default=0,
                    help="profile only the kernels of the blocked Darcy "
                    "GMRES's hierarchy at these refinements (e.g. 3)")
    ap.add_argument("--library", type=int, default=0,
                    help="profile only the XML solver library's scalar "
                    "compositions at these refinements (e.g. 5)")
    ap.add_argument("--spe10", default=None,
                    help="profile only the kernels of the generic SPE10 "
                    "lane's SA hierarchies at these cells (e.g. 30,55,21)")
    ap.add_argument("--ho", type=int, default=0,
                    help="profile only the high-order lane at this grid "
                    "(e.g. 16)")
    ap.add_argument("--dist", type=int, default=0,
                    help="profile only the dist lane's step with this many "
                    "ranks (e.g. 8)")
    ap.add_argument("--dist-ny", default="4,32",
                    help="comma-separated ny_per_rank of the --dist rows")
    ap.add_argument("--loop", default="device",
                    help="the solve rows of the default profile and --ho, "
                    "comma-separated: each solve compiled once as one CUDA "
                    "graph with the loop on the card (device), and/or "
                    "with the Python loop (python)")
    ap.add_argument("--dist-mp", action="store_true",
                    help="with --dist N: ell_spmv rows on each process's "
                    "own tables of the dist_mp runs instead")
    ap.add_argument("--formats", action="store_true",
                    help="print only the A format of every level of every "
                    "lane's hierarchy")
    ap.add_argument("--dia", action="store_true",
                    help="time only the 1-RHS DIA kernels on the flagship's "
                    "DIA levels and the darcy DIA part")
    ap.add_argument("--dia-darcy", type=int, default=64,
                    help="the darcy_hyb grid of the --dia rows (0: none)")
    ap.add_argument("--dia-variants", action="store_true",
                    help="with --dia, also time each plan choice forced")
    ap.add_argument("--ablate", choices=sorted(ABLATE), default=None,
                    help="time the level-0 multi-RHS DIA variants (with "
                    "--dia: the --dia rows) with one phase of the staged "
                    "kernels left out")
    args = ap.parse_args(argv)
    emit = _emitter(args.out)
    try:
        _run(args, emit)
    except BaseException:
        # the rows taken so far and the failure stay in the log
        emit(dict(failed=traceback.format_exc()))
        raise


def _run(args, emit):
    dev = pick_device()
    if args.ablate:
        # a build of its own: the flags are part of the library's hash
        build.NVCC_FLAGS += (f"-DDIA_STAGE_ABLATE={ABLATE[args.ablate]}",)
    if args.dia:
        _dia(args, dev, emit)
        return
    if args.darcy:
        _darcy(args.darcy, dev, emit)
        return
    if args.darcy_block:
        _darcy_block(args.darcy_block, dev, emit)
        return
    if args.library:
        _library(args.library, dev, emit)
        return
    if args.spe10:
        _spe10(tuple(int(c) for c in args.spe10.split(",")), dev, emit)
        return
    if args.ho:
        _ho(args.ho, dev, emit, args.loop)
        return
    if args.formats:
        _formats(dev, emit)
        return
    if args.dist and args.dist_mp:
        _dist_mp(args.dist, dev, emit)
        return
    if args.dist:
        _dist(args.dist, [int(v) for v in args.dist_ny.split(",")], dev,
              emit)
        return

    def build_h1():
        A_levels, P_levels, b = flagship.build_h1_structured(args.nx,
                                                             device=dev)
        return (A_levels, P_levels, b) + tuple(
            flagship.build_solver(A_levels, P_levels, dev))

    def build_mx():
        A, bm, MA, MP, MD0 = maxwell_lane.build_maxwell(args.nx_maxwell,
                                                        dev)
        return (bm, MA, MP, MD0,
                maxwell_lane.build_solver(MA, MP, MD0, dev))

    mem_h1, (A_levels, P_levels, b, H, Hb) = _memory_row(
        f"h1 {args.nx}^3", build_h1, dev)
    emit(mem_h1)
    mem_mx, (bm, MA, MP, MD0, Hm) = _memory_row(
        f"maxwell {args.nx_maxwell}^3", build_mx, dev)
    emit(mem_mx)
    if args.memory_only:
        return
    hk.load()
    if args.ablate:
        X = torch.as_tensor(np.random.RandomState(0).randn(
            A_levels[0].shape[0], N_RHS).astype(np.float32)).to(dev)
        for name, variant, M, v, plan in _multirhs_dia_cases(H, Hb, 0, X,
                                                             "A0"):
            row = _timed_row(name, f"{variant} ablate={args.ablate}", M, v)
            row.update(plan=plan, ablate=args.ablate)
            emit(row)
        return

    # imported here: --memory-only also runs against older checkouts
    from parelag_tpu_torch import generic_lane
    from parelag_tpu_torch.solvers.amge_solver import (
        build_amge_hierarchy, compile_amge_pcg)
    from parelag_tpu_torch.solvers.cg import pcg

    def build_generic():
        seqs, A, bg, _ = generic_lane.build_h1(args.nx_generic, "device",
                                               dev)
        Hg, _, _ = build_amge_hierarchy(
            seqs, 0, A.astype(np.float32), sweeps=generic_lane.SWEEPS,
            dtype=np.float32, device=dev)
        return bg, Hg

    mem_g, (bg, Hg) = _memory_row(
        f"generic {args.nx_generic}^3", build_generic, dev)
    emit(mem_g)
    bt = torch.as_tensor(b.astype(np.float32)).to(dev)
    B = torch.as_tensor(np.random.RandomState(0).randn(
        A_levels[0].shape[0], N_RHS).astype(np.float32)).to(dev)
    bmt = torch.as_tensor(bm.astype(np.float32)).to(dev)
    bgt = torch.as_tensor(bg.astype(np.float32)).to(dev)
    cases = [
        (f"h1 {args.nx}^3 1 RHS", lambda: flagship.solve(H, Hb, bt),
         lambda: flagship.compile_solve(H, Hb, bt), bt),
        (f"h1 {args.nx}^3 {N_RHS} RHS", lambda: flagship.solve(H, Hb, B),
         lambda: flagship.compile_solve(H, Hb, B), B),
        (f"maxwell {args.nx_maxwell}^3", lambda: maxwell_lane.solve(Hm, bmt),
         lambda: maxwell_lane.compile_solve(Hm, bmt), bmt),
        (f"generic {args.nx_generic}^3",
         lambda: pcg(Hg.levels[0].A.matvec, bgt, precond=Hg.apply,
                     rtol=generic_lane.RTOL, atol=0.0,
                     maxiter=generic_lane.MAXITER),
         lambda: compile_amge_pcg(Hg, Hg.levels[0].A, bgt,
                                  rtol=generic_lane.RTOL, atol=0.0,
                                  maxiter=generic_lane.MAXITER), bgt)]
    for name, python_solve, compile_solve, v in cases:
        for loop in _loops(args.loop):
            emit(_loop_solve_row(name, loop, python_solve, compile_solve,
                                 v))
    emit(_launch_floor_row(dev))
    for row in _kernel_rows(H, Hb, P_levels[0], Hm, Hg, dev):
        emit(row)
    if args.ell_slots:
        for row in _tune_ell(P_levels[0], Hm, dev,
                             [int(s) for s in args.ell_slots.split(",")]):
            emit(row)
    if args.tune_rows:
        for row in _tune_rows(H, Hb, dev,
                              [int(r) for r in args.tune_rows.split(",")]):
            emit(row)


def _emitter(out):
    """emit(row): print the row as a JSON line and append it to `out`
    (started with the card line), so that a run that fails keeps every
    row taken before the failure."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        open(out, "w").close()

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    emit(dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda))
    return emit


if __name__ == "__main__":
    main()
