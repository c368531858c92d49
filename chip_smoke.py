"""Smoke run of the PyTorch/H100 port (parelag_tpu_torch) on one card.

    python3 chip_smoke.py       # the 96^3 flagship, 912,673 dofs

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the time to build the hand-written kernels from
   parelag_tpu_torch/csrc.
2. Main path: the H1 flagship, flagship.lane_h1 (structured AMGe setup
   on the card, bf16 V(2,2)-cycle preconditioned f32 PCG, host f64
   check and host scipy anchor).  Every launch counter is set to 0 just
   before and read just after; each of the three kernels must have run.
   Then the same slice at 16^3 on the card and on the CPU must agree.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the main path's shapes — the fine DIA operator in f32 and in
   bf16, one fused Jacobi sweep, and P0/R0 as bf16 BCSR — with the max
   relative error, its limit and both times (CUDA events, median).
4. Prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failed check exits non-zero before the result lines; without a card
the script raises and prints no result.  It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from parelag_tpu_torch import device as pick_device, flagship
from parelag_tpu_torch.ops import build, hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import (
    l1_row_weights, to_bcsr, to_dia)

# error limits, max |kernel - plain| / max |plain|: f32 outputs differ
# only in summation order; bf16 outputs round to 2^-8 relative
REL_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
NX = 96                 # the flagship grid: 96^3 cells, 97^3 dofs
ITER_SLACK = 2          # PCG iterations vs the host f64 anchor
BATCHES, PER_BATCH = 5, 20   # timed batches of back-to-back launches

SOURCES = {
    "dia_spmv": ("parelag_tpu_torch/csrc/dia.cu",
                 "parelag_tpu/ops/pallas_kernels.py:215"),
    "dia_jacobi_sweep": ("parelag_tpu_torch/csrc/dia.cu",
                         "parelag_tpu/ops/pallas_kernels.py:266"),
    "bcsr_spmv": ("parelag_tpu_torch/csrc/bcsr.cu",
                  "parelag_tpu/ops/pallas_kernels.py:119"),
}


def _ms(fn):
    """Per-call time of fn() in ms: CUDA events around PER_BATCH
    back-to-back calls, median over BATCHES (one warm-up call first).
    Back to back, the host enqueues the next launch while the card runs
    the current one, so a kernel longer than its launch is timed by the
    card."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(BATCHES):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(PER_BATCH):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / PER_BATCH)
    return float(np.median(ts))


def _compare(name, variant, kernel, plain):
    yk = kernel()
    yp = plain()
    torch.cuda.synchronize()
    if yk.dtype != yp.dtype or yk.shape != yp.shape:
        raise SystemExit(f"FAIL {name}[{variant}]: kernel gave "
                         f"{yk.dtype}{tuple(yk.shape)}, plain "
                         f"{yp.dtype}{tuple(yp.shape)}")
    d = (yk.double() - yp.double()).abs().max().item()
    ref = yp.double().abs().max().item()
    rel = d / max(ref, 1e-300)
    limit = REL_LIMIT[yk.dtype]
    row = dict(variant=variant, max_abs_err=d, max_rel_err=rel,
               limit=limit, ms=_ms(kernel), plain_ms=_ms(plain))
    print(f"  {name}[{variant}] max_rel_err={rel:.3e} (limit {limit:g}) "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms")
    if not (np.isfinite(rel) and rel <= limit):
        raise SystemExit(f"FAIL {name}[{variant}]: max_rel_err {rel} > "
                         f"{limit}")
    return row


def kernel_phase(A0, P0, dev):
    """Each kernel against its plain version at the main path's shapes,
    on random vectors from a fixed seed."""
    rng = np.random.RandomState(0)
    n = A0.shape[0]
    rows = {k: [] for k in SOURCES}
    dw = (1.0 / l1_row_weights(A0)).astype(np.float32)
    vecs = [torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
            for _ in range(2)]
    dwt = torch.as_tensor(dw).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        D = to_dia(A0, dt, dev)
        tag = "f32" if dt == torch.float32 else "bf16"
        x, b = (v.to(dt) for v in vecs)
        d = dwt.to(dt)
        rows["dia_spmv"].append(_compare(
            "dia_spmv", f"A0 {tag} nd={len(D.offs)} n={n}",
            lambda: hk.dia_spmv(D.data, D.offs, x, n),
            lambda: hk.dia_spmv_plain(D.data, D.offs, x, n)))
        rows["dia_jacobi_sweep"].append(_compare(
            "dia_jacobi_sweep", f"A0 {tag} one sweep n={n}",
            lambda: hk.dia_jacobi_sweep(D.data, D.offs, x, b, d),
            lambda: hk.dia_jacobi_sweep_plain(D.data, D.offs, x, b, d)))
        del D
    for label, M in (("P0", P0), ("R0", P0.T.tocsr())):
        B = to_bcsr(M, torch.bfloat16, device=dev)
        xs = torch.as_tensor(rng.randn(M.shape[1]).astype(np.float32)
                             ).to(dev)
        pairs = [(torch.bfloat16, "bf16 x")]
        if label == "P0":
            pairs.append((torch.float32, "f32 x"))
        for xdt, xtag in pairs:
            x = xs.to(xdt)
            nbr, kb = B.col_blocks.shape
            rows["bcsr_spmv"].append(_compare(
                "bcsr_spmv", f"{label} bf16 tiles {xtag} {M.shape[0]}x"
                f"{M.shape[1]} nbr={nbr} kb={kb}",
                lambda: hk.bcsr_spmv(B.col_blocks, B.tiles, x, M.shape[0]),
                lambda: hk.bcsr_spmv_plain(B.col_blocks, B.tiles, x,
                                           M.shape[0])))
        del B
    return rows


def small_check(dev):
    """The slice at 16^3 (3 levels) on the card against the same slice on
    the CPU (plain versions): operators within f32 rounding (1e-5),
    iterations within one, solutions within the bf16 preconditioner's
    reach of each other (1e-3 of |x|, both solved to rtol 1e-5)."""
    runs = []
    for d in (torch.device("cpu"), dev):
        A, P, b = flagship.build_h1_structured(16, 64, device=d)
        H, Hb = flagship.build_solver(A, P, d)
        bt = torch.as_tensor(b.astype(np.float32)).to(d)
        x, (it, _) = flagship.solve(H, Hb, bt)
        runs.append((A, P, x.double().cpu().numpy(), it))
    (Ac, Pc, xc, itc), (Ag, Pg, xg, itg) = runs
    op = max(abs(a - c).max() / abs(c).max()
             for a, c in zip(Ag + Pg, Ac + Pc))
    dx = np.linalg.norm(xg - xc) / np.linalg.norm(xc)
    print(f"small check 16^3: operators max rel diff {op:.3e} (limit "
          f"1e-5), iters card {itg} cpu {itc}, |dx|/|x| {dx:.3e} "
          f"(limit 1e-3)")
    if not (op <= 1e-5 and abs(itg - itc) <= 1 and dx <= 1e-3):
        raise SystemExit("FAIL small check: card and CPU disagree")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    dev = pick_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    hk.load()
    print(f"kernel build {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.2f} s, built="
          f"{build.BUILD_INFO['built']}) -> {build.BUILD_INFO['path']}")

    # ---- main path ---------------------------------------------------
    hk.reset_launches()
    rec, (A_levels, P_levels, _) = flagship.lane_h1(NX, dev)
    launches = dict(hk.LAUNCHES)
    print("main path: " + json.dumps(rec))
    print(f"  ndofs={rec['ndofs']} levels={rec['levels']} "
          f"shapes={rec['level_shapes']} formats={rec['formats']} "
          f"transfers={rec['transfers']}")
    print(f"  setup_s={rec['setup_s']:.3f} iters={rec['iters']} "
          f"rel_res={rec['rel_res']:.3e}"
          + (f" rel_res_floor={rec['rel_res_floor']:.3e}"
             if "rel_res_floor" in rec else "")
          + f" solve_s={rec['solve_s']:.5f} "
          f"dof_iter_per_s={rec['dof_iter_per_s']:.4e}")
    print(f"  host anchor: iters={rec['host_iters']} "
          f"solve_s={rec['host_solve_s']:.3f} vs_baseline="
          f"{rec['vs_baseline']:.2f}")
    print(f"  launches in main path: {launches}; in the timed solves: "
          f"{rec['kernels']}")

    fails = []
    nv = (NX + 1) ** 3
    if rec["ndofs"] != nv:
        fails.append(f"ndofs {rec['ndofs']} != {nv}")
    if rec["levels"] != flagship.n_levels(NX):
        fails.append(f"levels {rec['levels']}")
    if not rec["converged"]:
        fails.append(f"PCG did not meet the r.z stop in {rec['iters']}")
    if abs(rec["iters"] - rec["host_iters"]) > ITER_SLACK:
        fails.append(f"iters {rec['iters']} vs host {rec['host_iters']}")
    if not (np.isfinite(rec["rel_res"]) and rec["rel_res"] <= 1e-4):
        # the converged rule of solvers/autotune.tune_cycle: 10 * rtol
        fails.append(f"rel_res {rec['rel_res']} > 1e-4")
    for k in SOURCES:
        if launches[k] <= 0 or rec["kernels"][k] <= 0:
            fails.append(f"kernel {k} never launched on the main path")
    if fails:
        raise SystemExit("FAIL main path: " + "; ".join(fails))
    small_check(dev)

    # ---- kernel phase ------------------------------------------------
    print("kernel phase (kernel vs plain on the card):")
    rows = kernel_phase(A_levels[0], P_levels[0], dev)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(v["max_abs_err"] for v in r),
            max_rel_err=max(v["max_rel_err"] for v in r),
            ms=r[0]["ms"], plain_ms=r[0]["plain_ms"], variants=r))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
