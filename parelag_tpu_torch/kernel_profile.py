"""Device-time profile of the port's main paths on the card.

    python -m parelag_tpu_torch.kernel_profile            # 96^3, 24^3
    python -m parelag_tpu_torch.kernel_profile --nx 32 --nx-maxwell 8

Builds the H1 flagship hierarchy (flagship.build_h1_structured +
build_solver) and the Maxwell hierarchy (maxwell_lane), then traces with
torch.profiler (CPU and CUDA activities):

  * solves: REPS solves each of the 1-RHS flagship PCG, the 16-RHS block
    PCG and the Maxwell PCG, after one warm-up solve: wall time per
    solve (CUDA events, median, no profiler attached; wall_ms_profiled
    is the traced solves' host time), device busy time (the sum of the
    CUDA kernels', copies' and fills' device time in the trace), the
    idle share 1 - busy / wall, and device time by kernel;
  * kernels: LAUNCHES back-to-back calls of each hand-written kernel on
    the level-0 operators of those hierarchies (the main paths' largest
    shapes): device microseconds per launch.

Prints one JSON object per line: the card (nvidia-smi name and power
limit, torch and CUDA versions), then {"solve": ...} and {"kernel": ...}
rows; --out FILE also writes them there.  Needs a card; it imports
nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from parelag_tpu_torch import device as pick_device, flagship, maxwell_lane
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import from_scipy

REPS, LAUNCHES, N_RHS = 3, 20, 16

#: kernel-name fragment of each hand-written kernel (csrc/*.cu)
KERNEL_NAMES = {
    "dia_spmv_mr_kernel": "dia_spmv_multirhs",
    "dia_jacobi_mr_kernel": "dia_jacobi_sweep_multirhs",
    "dia_spmv_kernel": "dia_spmv",
    "dia_jacobi_kernel": "dia_jacobi_sweep",
    "bcsr_spmm_kernel": "bcsr_spmv_multirhs",
    "bcsr_spmv_kernel": "bcsr_spmv",
    "ell_spmv_kernel": "ell_spmv",
}


def _label(name):
    for frag, label in KERNEL_NAMES.items():
        if frag in name:
            return label
    return "torch: " + name[:60]


def trace(fn, reps):
    """Run fn() reps times under torch.profiler; returns (host wall s
    per call, device busy us per call, {label: [device us, count]})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
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
        slot[0] += e.self_device_time_total / reps
        slot[1] += e.count / reps
    busy = sum(v[0] for v in by.values())
    return wall, busy, by


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
    wall_prof, busy, by = trace(fn, REPS)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])
    return dict(solve=name, wall_ms=wall * 1e3,
                wall_ms_profiled=wall_prof * 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / (wall * 1e3),
                by_kernel={k: dict(device_ms=v[0] / 1e3, launches=v[1])
                           for k, v in top})


def _kernel_rows(H, Hb, P0, Hm, dev):
    rng = np.random.RandomState(0)
    A = H.levels[0].A
    Ab = Hb.levels[0].A
    n = A.shape[0]
    x = torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
    X = torch.as_tensor(rng.randn(n, N_RHS).astype(np.float32)).to(dev)
    dw = Hb.levels[0].pre.dinv
    xb, Xb = x.to(torch.bfloat16), X.to(torch.bfloat16)
    Pb, Rb = Hb.levels[0].P, Hb.levels[0].R
    nc = Pb.shape[1]
    ec = torch.as_tensor(rng.randn(nc).astype(np.float32)).to(dev)
    Ec = torch.as_tensor(rng.randn(nc, N_RHS).astype(np.float32)).to(dev)
    hip = Hm.levels[0].pre
    Am, Pm, Rm = Hm.levels[0].A, Hm.levels[0].P, Hm.levels[0].R
    E0 = from_scipy(P0, dtype=np.float32, device=dev)
    xe = {M: torch.as_tensor(rng.randn(M.shape[1]).astype(np.float32)
                             ).to(dev)
          for M in (hip.A_aux, hip.D, hip.Dt, E0, Am, Pm, Rm)}
    cases = [
        ("dia_spmv", "A0 f32", lambda: A @ x),
        ("dia_spmv", "A0 bf16", lambda: Ab @ xb),
        ("dia_jacobi_sweep", "A0 bf16",
         lambda: hk.dia_jacobi_sweep(Ab.data, Ab.offs, xb, xb, dw)),
        ("dia_spmv_multirhs", f"A0 f32 s={N_RHS}", lambda: A @ X),
        ("dia_spmv_multirhs", f"A0 bf16 s={N_RHS}", lambda: Ab @ Xb),
        ("dia_jacobi_sweep_multirhs", f"A0 bf16 s={N_RHS}",
         lambda: hk.dia_jacobi_sweep_multirhs(Ab.data, Ab.offs, Xb, Xb,
                                              dw)),
        ("bcsr_spmv", "P0 bf16 tiles, bf16 x", lambda: Pb @ ec.to(
            torch.bfloat16)),
        ("bcsr_spmv", "P0 bf16 tiles, f32 x", lambda: Pb @ ec),
        ("bcsr_spmv", "R0 bf16", lambda: Rb @ xb),
        ("bcsr_spmv", "Maxwell A0 f32", lambda: Am @ xe[Am]),
        ("bcsr_spmv", "Maxwell P0 f32", lambda: Pm @ xe[Pm]),
        ("bcsr_spmv", "Maxwell R0 f32", lambda: Rm @ xe[Rm]),
        ("bcsr_spmv_multirhs", f"P0 bf16 tiles, bf16 X s={N_RHS}",
         lambda: Pb @ Ec.to(torch.bfloat16)),
        ("bcsr_spmv_multirhs", f"P0 bf16 tiles, f32 X s={N_RHS}",
         lambda: Pb @ Ec),
        ("ell_spmv", "Maxwell A_aux f32", lambda: hip.A_aux @ xe[hip.A_aux]),
        ("ell_spmv", "Maxwell D0 f32", lambda: hip.D @ xe[hip.D]),
        ("ell_spmv", "Maxwell D0^T f32", lambda: hip.Dt @ xe[hip.Dt]),
        ("ell_spmv", "flagship P0 as ELL f32", lambda: E0 @ xe[E0]),
    ]
    rows = []
    for name, variant, fn in cases:
        fn()
        _, _, by = trace(fn, LAUNCHES)
        us, count = by.get(name, [0.0, 0])
        if count < 1:
            raise RuntimeError(f"{name}[{variant}]: the kernel did not run")
        rows.append(dict(kernel=name, variant=variant,
                         device_us_per_launch=us / count))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--nx-maxwell", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    dev = pick_device()
    hk.load()
    A_levels, P_levels, b = flagship.build_h1_structured(args.nx,
                                                         device=dev)
    H, Hb = flagship.build_solver(A_levels, P_levels, dev)
    A, bm, MA, MP, MD0 = maxwell_lane.build_maxwell(args.nx_maxwell, dev)
    Hm = maxwell_lane.build_solver(MA, MP, MD0, dev)
    bt = torch.as_tensor(b.astype(np.float32)).to(dev)
    B = torch.as_tensor(np.random.RandomState(0).randn(
        A_levels[0].shape[0], N_RHS).astype(np.float32)).to(dev)
    bmt = torch.as_tensor(bm.astype(np.float32)).to(dev)
    rows = [
        _solve_row(f"h1 {args.nx}^3 1 RHS",
                   lambda: flagship.solve(H, Hb, bt)),
        _solve_row(f"h1 {args.nx}^3 {N_RHS} RHS",
                   lambda: flagship.solve(H, Hb, B)),
        _solve_row(f"maxwell {args.nx_maxwell}^3",
                   lambda: maxwell_lane.solve(Hm, bmt)),
    ]
    rows += _kernel_rows(H, Hb, P_levels[0], Hm, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [json.dumps(r) for r in [dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda)] + rows]
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
