"""Smoke run of the PyTorch/H100 port (parelag_tpu_torch) on one card.

    python3 chip_smoke.py       # the cycle autotune, the 96^3 flagship
                                # (1 and 16 RHS, then its winner), 24^3
                                # Maxwell, the generic engine, entry(),
                                # the hybridized Darcy lanes, the
                                # XML solver library at 64^3, the
                                # structured spectral SPE10 lanes,
                                # the high-order ho_p2 lane at 16^3
                                # (and with RCM), the structured
                                # engine's heterogeneous and Darcy
                                # chains, the dist lane (8 ranks on
                                # the card, in one process and in 2
                                # and 4), a hierarchy checkpointed and
                                # resumed

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the time to build the hand-written kernels from
   parelag_tpu_torch/csrc (one nvcc per source, in parallel), and
   whether the port's native host library (the repo's
   native/parelag_kernels.cpp, built with g++ beside them) loaded: the
   run fails if it did not.
2. Main paths, each driven with every launch counter set to 0 just
   before and read just after; each kernel of a path must have run:
   0. the cycle autotune, flagship.lane_autotune(NX_AUTOTUNE):
      tune_cycle's grid (l1-Jacobi and Chebyshev, V and W) on the
      structured 2x2x2 hierarchy (bf16 preconditioner) and the generic
      2x2x2 and 4x4x4 ones; every candidate's iterations within one of,
      and its converged flag equal to, the same lane on this machine's
      CPU;
   a. the H1 flagship, flagship.lane_h1(96, n_rhs=16): structured AMGe
      setup on the card, bf16 l1-Jacobi V(2,2)-cycle preconditioned f32
      PCG checked in host f64 against the host scipy anchor, then block
      PCG on 16 right-hand sides through the same hierarchy (every
      column's host f64 residual, column 0 against its 1-RHS solve);
      then the flagship on the autotune's winner, lane_h1(96,
      cycle_cfg=..., levels=...) on the same levels (not built again):
      rel_res <= 1e-4 and iterations within ITER_SLACK of the host
      anchor with the cycle's sweeps (the winner is a measurement and
      may change from run to run, so the fused sweep kernels are held
      to the V(2,2) run);
   b. the Maxwell lane, maxwell_lane.lane_maxwell(24): Hiptmair-smoothed
      2-level AMGe PCG on a curl-curl + mass H(curl) system, with the
      f64 restart loop;
   c. the generic engine, generic_lane.lane_generic(NX_GENERIC): mesh,
      topology chain, fine DeRhamSequenceFE and coarsen() with pass 2's
      batched local solves on the card, the f32 AMGe hierarchy (BCSR on
      the card) and PCG, within one iteration of the host f64 anchor on
      the same matrices;
   d. the hybridized Darcy multiplier solve,
      darcy_lane.lane_darcy_hybridized(NX_DARCY): SA-AMG PCG in f32 on the
      card (DIA + COO outer operator, ELL and BCSR SA levels) inside f64
      host refinement to a true relative residual <= 1e-6 (rtol 1e-8),
      its SA levels equal to and its iterations at most DARCY_ITER_SLACK
      above the same f32 branch run on the CPU (darcy_anchor);
   e. SPE10, darcy_lane.lane_spe10(SPE10_CELLS): spectral 2-level
      upscaling with every level's multiplier solve on the card (each
      within rtol in host f64); the fine dofs equal the JAX package's CPU
      run's, and every level's dofs, u_l2_rel and the fine u agree with
      the same lane on this machine's CPU (see check_spe10);
   f. the blocked Darcy AMGe GMRES, darcy_lane.lane_darcy_block
      (BLOCK_NREF): f64 ELL levels, within 1e-8 of a direct solve;
   f2. the XML solver library, library_lane.lane_library(LIB_NREF): the
      example chain at 64^3 (6 levels, pass 2 on the card) and the
      compositions PCG + AMGe (L1 Gauss-Seidel), PCG + AMS and PCG + ADS
      on it, GMRES + blocked AMGe and Hybridization + CG_PCG-AMG on the
      32^3 Darcy chain, all f64 through solvers/library.SolverLibrary:
      every composition executed on the device (no host fallback), a
      true relative residual <= LIB_RES_LIMIT, each scalar
      composition's iterations within max(2 n_16, n_16 + 15) of the
      same lane at 16^3 on the card (which must agree with the CPU:
      iterations within one, x within LIB_X_LIMIT), and
      multigrid_test_form(form, nref=2) on the card gives the JAX
      package's 4 / 7 / 9 iterations;
   g. the structured spectral SPE10 setup,
      spectral_lane.lane_spe10_structured(SPS_CELLS) in f64 on the card:
      the same lane on this machine's CPU gives the same dims and
      per-entity counts, u_l2_rel within SPS_U_L2_LIMIT, and both the
      f64 spot oracle within SPOT_LIMIT;
   h. the same lane on the full SPE10 grid (60, 220, 85): the JAX host
      f64 anchor's ndofs_u and coarse_u (a difference passes only where
      entities sit within NEAR_REL of a keep threshold, each printed),
      the spot oracle, setup_s and stage seconds beside the anchor's;
   i. the multilevel chain, spectral_lane.lane_spe10_ml(ML_CELLS): dims
      per level as on the CPU, stage residuals and the spot oracle in
      their limits, u_l2_rel within ML_U_L2_LIMIT of the CPU's.
   (g-i run no hand kernel: their stages are batched torch.linalg.)
   j. the high-order lane, ho_lane.lane_ho(NX_HO, p=HO_P): the order-2
      de Rham sequence on 16^3 (117,649 H1 dofs), one 2x2x2 coarsening
      with pass 2 on the card, the f32 hierarchy (A0 in BCSR since
      hierarchy.a_format keeps no ELL table of 3.45 slots a nonzero, BCSR
      transfers) and f32 PCG with its bf16 cast as the preconditioner:
      iterations within ITER_SLACK of the host f64 anchor, rel_res <=
      1e-4, A0 a BcsrMatrix in f32 and bf16, no ell_spmv and more
      bcsr_spmv launches than the transfers and f32 matvecs account for
      (check_ho); then the lane at 4^3 on the card and on the CPU (equal
      coarse dims, iterations within one);
   k. RCM, ho_lane.build_solver(..., reorder="rcm") on the same
      matrices: iterations within one of the unpermuted solve, x within
      RCM_X_LIMIT relative, the formats per level printed;
   l. the structured engine's remaining forms: the heterogeneous chain
      fine_level((64,)*3, coeff=...) -> coarsen_chain(3) on the card
      (a log-uniform coefficient per coarsest agglomerate, seed 7),
      materialize_P for all four forms, and its Galerkin and commutation
      residuals on the host <= A4_LIMIT; coarsen_darcy at 96^3 against
      coarsen_structured(jform_start=2) within 1e-12 (no hand kernel).
   m. the distributed plane, parallel.dist_bench.distributed_solve_bench
      (DIST_RANKS, ny_per_rank, DIST_STEPS) at bench.py's dist lane shape
      (ny_per_rank 4: grid 16 x 32 x 20, 11,781 dofs, 4 levels) and
      weak-scaled to ny_per_rank 32 (16 x 256 x 20, 91,749 dofs): the
      distributed setup on the host, then the f32 L-level V-cycle PCG
      step with the 8 ranks as a batch axis on the card (every local
      product in ell_spmv), timed by CUDA events: setup_s, step_s, value
      and the steps' launches printed beside the card; x after the steps
      as close to the same steps on the CPU as twice f32's own error
      there (check_dist), and entry.dryrun_multichip(8) on the card.
   n. the dist lane across processes, parallel.mp_worker.launch on the
      card (backend_for's backend: gloo when the processes share the
      card; each process holds its own ranks and sets them up from its
      own patches): 2 processes at
      ny_per_rank 4 and 32, 4 at 4, each timed as in m; every process's
      level dofs and level tables (sha256) equal to m's one-process
      lane, ell_spmv launched in its timed steps, x after the steps as
      close to m's card run as twice f32's own error there (check_dist);
      then the f64 solve case (the JAX package's tests/_mp_worker.py) in
      2 processes: error against spsolve below 1e-10, equal digests and
      level tables equal to mp_worker.solve_problem's here, and the setup
      case (tests/_mp_setup_worker.py): the assembled
      operators within 1e-13 (A) and 1e-14 (P) of the one-process setup.
      The launches are the processes' own (each counts from 0).
   o. checkpoint: the 96^3 flagship hierarchy of a (DIA A, bf16 BCSR P /
      R, dense coarse inverse; with its bf16 cast) through
      utils/checkpoint.save_pytree and load_pytree onto the card, its
      PCG against the hierarchy it was saved from: equal iterations, x
      within CKPT_X_LIMIT (the same kernels on the same bytes: equal is
      expected); then the generic chain of c through save_transfers /
      load_transfers, build_hierarchy on the card and PCG: iterations
      within one of c's; the files' bytes and the save, load and solve
      seconds printed.
   Then each slice at a small size on the card and on the CPU (plain
   versions) must agree: the flagship at 16^3, Maxwell at 6^3, the
   generic engine at 8^3 (the host backend on the CPU against the device
   backend on the card: equal coarse dimensions, P within 5e-5, the f32
   hierarchy's operators within 1e-5), entry.entry() (rel 1e-5), the
   hybridized solve at 8^3 (f32 refined on the card against f64 on the
   CPU: x within 1e-6) and spe10_darcy at (8, 8, 4) (u_l2_rel within
   1e-6, u within 1e-6 of its largest entry).
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the main paths' shapes (the flagship's DIA levels A0, A1 and
   A2 in f32 and bf16 for the 1-RHS DIA pair, each row tagged with its
   launch plan, hopper_kernels.dia_row_plan; the generic, SA and block
   hierarchies: every operator their cycles apply, in the format the
   path gave it), with the max relative error and its
   limit, and the times (CUDA events, median) of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (library_ms: a torch.sparse_csr_tensor product, used nowhere in
   the port); bound_ms is the least time the card could take for the
   function, from the bytes and operations this run's data needs (see
   _compare); format_bytes is what the kernel's own format streams,
   padding included.
   The ho rows hold the high-order lane's A0 (f32 BCSR, the PCG
   matvec; bf16 BCSR with bf16 and f32 x, the cycle's two pairs), the
   same A0 as the 343-slot ELL table it was before (f32; bf16 with bf16
   and f32 x: the bf16 ELL pairs stay held against their plain version)
   and its bf16 BCSR P0 / R0, each with bound_slots_ms beside bound_ms:
   the stored format's stream (format_bytes) over the memory rate.
   The SPE10 rows include every level's SA hierarchy of the generic
   SPE10 lane (e), BCSR transfers included, and dia_spmv on the DIA part
   of each level's outer operator, tagged with its plan (f32, at the
   f32 limit); the library rows are f64
   (library_lane.kernel_operators: every operator of the form-0 AMGe
   hierarchy, BCSR transfers included, and the form-1 Hiptmair D0,
   A_aux0 and Krylov A0 in ELL), held at 1e-12.  The dist rows are
   ell_spmv on every flat table the dist paths launch it on: every
   level's A in the halo form and P's rows (dist_bench.level_operators)
   of m's lane at both sizes, of each process of n (its own ranks' rows,
   whose row counts change the launch plan) and of n's f64 solve case
   (dist_operators).
4. Prints each phase's seconds, {"kernels": [...]} and, last,
   {"ok": true, "device": {...}}.

Any failed check exits non-zero before the result lines; without a card
the script raises and prints no result.  It imports nothing of JAX.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from parelag_tpu_torch import (
    darcy_lane, device as pick_device, entry, flagship, generic_lane,
    ho_lane, kernel_profile, library_lane, maxwell_lane, spectral_lane)
from parelag_tpu_torch.amge import structured as stc
from parelag_tpu_torch.amge import structured_spectral as sps
from parelag_tpu_torch.models.multigrid import multigrid_test_form
from parelag_tpu_torch.parallel import dist_bench, mp_worker
from parelag_tpu_torch.parallel.sharding import (
    RankMesh, backend_for, make_dd_mesh)
from parelag_tpu_torch.ops import build, graph_loop, hopper_kernels as hk, native
from parelag_tpu_torch.solvers.amge_solver import (
    amge_pcg_solve, build_amge_hierarchy)
from parelag_tpu_torch.ops.device_sparse import (
    from_scipy, l1_row_weights, to_bcsr, to_dia)
from parelag_tpu_torch.solvers.hierarchy import (
    build_hierarchy, level_operators, rap)
from parelag_tpu_torch.solvers.smoothers import aux_operator, make_l1_jacobi
from parelag_tpu_torch.utils import checkpoint

# error limits, max |kernel - plain| / max |plain|: f32 outputs differ
# only in summation order; bf16 outputs round to 2^-8 relative
REL_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
             torch.float64: 1e-12}
NX = 96                 # the flagship grid: 96^3 cells, 97^3 dofs
N_RHS = 16              # right-hand sides of the block solve (bench.py)
NX_MAXWELL = 24         # bench.py's Maxwell size: 45,000 edge dofs
NX_GENERIC = 64         # bench.py's setup lane size: 274,625 H1 dofs
NX_DARCY = 64           # darcy_hyb: 774,144 free multipliers (padded
                        # to 2^20), the generic lane's cell count
SPE10_CELLS = darcy_lane.SPE10_CELLS    # bench.py's generic SPE10 lane
# the JAX package's spe10_darcy at SPE10_CELLS (spectral, first solver
# "device"), a CPU run under numpy 2.0.2: dofs and multipliers per level
# (the fine ones hold anywhere), u_l2_rel
SPE10_NDOFS, SPE10_NMULT = [142035, 30392], [107385, 24027]
SPE10_U_L2_REL = 0.11437877903714824
# SPE10, card against the CPU: u_l2_rel, and the fine u of its largest
# entry (the CPU's f64 one-pass solve stops on r.z at a true residual
# near 1e-7)
SPE10_L2_LIMIT, SPE10_U_LIMIT = 1e-8, 1e-6
DARCY_ITER_SLACK = 3    # darcy_hyb iterations above the CPU anchor
BLOCK_NREF = darcy_lane.BLOCK_NREF      # 16^3 cells, 4 levels
ITER_SLACK = 2          # PCG iterations vs the host f64 anchor
NX_AUTOTUNE = 32        # bench.py's autotune size in its full run
SPS_CELLS = spectral_lane.CELLS          # (30, 55, 21)
SPS_FULL = spectral_lane.FULL            # (60, 220, 85)
# the JAX package's host f64 anchor of the structured engine on the full
# grid (.bench_anchors.json, same field, factors and parameters)
SPS_FULL_NDOFS_U, SPS_FULL_COARSE_U = 3_403_000, 424_582
ML_CELLS = spectral_lane.ML_CELLS        # (32, 32, 16)
# card against the CPU: u_l2_rel relative (structured, multilevel), and
# the f64 spot oracle's limit (the engine's own for f64)
SPS_U_L2_LIMIT, ML_U_L2_LIMIT, SPOT_LIMIT = 1e-8, 1e-6, 1e-8
BATCHES, PER_BATCH = 5, 20   # timed batches of back-to-back launches
# H100 SXM peaks (NVIDIA data sheet, 700 W): device-memory bytes/s and
# FP32 FLOP/s outside the tensor cores (the kernels' f32 FMAs); FP64
# FLOP/s outside the tensor cores for the f64 rows
PEAK_BYTES, PEAK_FLOPS, PEAK_FLOPS_F64 = 3.35e12, 67e12, 34e12
LIB_NREF = library_lane.LIB_NREF        # 64^3 cells, 6 levels
LIB_SMALL_NREF = 3                      # card against CPU: 16^3 cells
LIB_RES_LIMIT = 1e-6    # true f64 relative residual at rtol 1e-8
LIB_X_LIMIT = 1e-8      # card against CPU: x relative
# multigrid_test_form(form, nref=2): the JAX package's golden PCG
# iterations (tests/test_solvers.py)
MG_GOLDEN_ITERS = {0: 4, 1: 7, 2: 9}
NX_HO, HO_P = ho_lane.NX, ho_lane.P     # bench.py's ho_p2: 16^3, p = 2
NX_HO_SMALL = 4         # card against CPU: 2,197 H1 dofs
RCM_X_LIMIT = 1e-4      # RCM against the unpermuted solve: x relative
A4_SHAPE, A4_LEVELS = (64, 64, 64), 3   # the heterogeneous chain
A4_DARCY_SHAPE = (96, 96, 96)           # coarsen_darcy, the flagship grid
A4_LIMIT = 1e-11        # Galerkin and commutation residuals (f64)
A4_DARCY_LIMIT = 1e-12  # coarsen_darcy against the full chain's stages
# the dist lane (parallel/dist_bench): bench.py's 8 ranks at its
# ny_per_rank = 4 (11,781 dofs), then weak-scaled to 32 (91,749 dofs)
DIST_RANKS, DIST_NY, DIST_STEPS = 8, (4, 32), 20
# the same lane across processes: (processes, ny_per_rank)
DIST_MP = ((2, 4), (2, 32), (4, 4))
MP_WORLD = 2            # the processes of the mp solve and setup cases
MP_SOLVE_LIMIT = 1e-10  # tests/_mp_worker.py's bound against spsolve
MP_A_LIMIT, MP_P_LIMIT = 1e-13, 1e-14   # tests/_mp_setup_worker.py's
CKPT_X_LIMIT = 1e-6     # the resumed flagship solve's x, relative
LOOP_X_LIMIT = 1e-6     # a device program's x against its Python loop's,
                        # relative (the same kernels in the same order:
                        # bitwise is expected)

# name -> (source, the TPU kernel it replaces (file:line), main path)
SOURCES = {
    "dia_spmv": ("parelag_tpu_torch/csrc/dia.cu",
                 "parelag_tpu/ops/pallas_kernels.py:215", "h1"),
    "dia_jacobi_sweep": ("parelag_tpu_torch/csrc/dia.cu",
                         "parelag_tpu/ops/pallas_kernels.py:266", "h1"),
    "bcsr_spmv": ("parelag_tpu_torch/csrc/bcsr.cu",
                  "parelag_tpu/ops/pallas_kernels.py:119", "h1"),
    "dia_spmv_multirhs": ("parelag_tpu_torch/csrc/dia.cu",
                          "parelag_tpu/ops/pallas_kernels.py:328", "h1"),
    "dia_jacobi_sweep_multirhs": ("parelag_tpu_torch/csrc/dia.cu",
                                  "parelag_tpu/ops/pallas_kernels.py:400",
                                  "h1"),
    # no Pallas kernel: the JAX package left the (m, s) BCSR product to
    # an XLA einsum (BcsrMatrix.matvec)
    "bcsr_spmv_multirhs": ("parelag_tpu_torch/csrc/bcsr.cu",
                           "parelag_tpu/ops/device_sparse.py:118", "h1"),
    "ell_spmv": ("parelag_tpu_torch/csrc/ell.cu",
                 "parelag_tpu/ops/pallas_kernels.py:43", "maxwell"),
    # no Pallas kernel: the `cond` of pcg's lax.while_loop, which XLA
    # evaluates on the device (the port's graph loop test)
    "pcg_loop_test": ("parelag_tpu_torch/csrc/loop.cu",
                      "parelag_tpu/solvers/cg.py:36", "h1"),
}
# the kernel-phase variant each kernel's {"kernels"} entry reports (the
# first, except where the main path runs the second: the bf16 sweeps of
# the cycle)
PRIMARY = {"dia_jacobi_sweep": 1, "dia_jacobi_sweep_multirhs": 1}
ONE_RHS = ("dia_spmv", "dia_jacobi_sweep", "bcsr_spmv")
MULTI_RHS = ("dia_spmv_multirhs", "dia_jacobi_sweep_multirhs",
             "bcsr_spmv_multirhs")
_TAG = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}
JACOBI_NOTE = ("no single PyTorch call computes a fused Jacobi sweep "
               "x + dw * (b - A x)")


def _ms(fn, per_batch=PER_BATCH, batches=BATCHES):
    """Per-call time of fn() in ms: CUDA events around per_batch
    back-to-back calls, median over batches (one warm-up call first).
    Back to back, the host enqueues the next launch while the card runs
    the current one, so a kernel longer than its launch is timed by the
    card."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_batch):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / per_batch)
    return float(np.median(ts))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _csr_bytes(M, itemsize):
    """The least an unstructured SpMV reads of M: its nonzeros' values
    with int32 CSR column indices and row pointers."""
    return int(M.count_nonzero()) * (itemsize + 4) + (M.shape[0] + 1) * 4


def _csr(M, dtype, dev):
    """The PyTorch library operand of M: torch.sparse_csr_tensor."""
    M = sp.csr_matrix(M)
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr.astype(np.int64)),
        torch.as_tensor(M.indices.astype(np.int64)),
        torch.as_tensor(M.data).to(dtype), M.shape).to(dev)


def _compare(name, variant, kernel, plain, nbytes, flops, format_bytes,
             library=None, library_note=None):
    """Kernel against its plain version on the same inputs, both timed,
    with the library call (or the reason there is none) and the bound:
    max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS).  nbytes is what the
    function needs, each input read once and each output written once,
    the matrix counted by its nonzeros (a format's padding is not work);
    flops is 2 per nonzero per column (plus the sweep's update)."""
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
    peak = PEAK_FLOPS_F64 if yk.dtype == torch.float64 else PEAK_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    row = dict(variant=variant, max_abs_err=d, max_rel_err=rel,
               limit=limit, ms=_ms(kernel), plain_ms=_ms(plain),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, format_bytes=format_bytes, flops=flops,
               library_ms=None if library is None else _ms(library))
    if library is None:
        row["library_note"] = library_note
    else:
        yl = library()
        torch.cuda.synchronize()
        row["library_rel_err"] = ((yl.double() - yp.double()).abs().max()
                                  .item() / max(ref, 1e-300))
    lib = ("-" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    print(f"  {name}[{variant}] max_rel_err={rel:.3e} (limit {limit:g}) "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"library {lib} ms  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})")
    if not (np.isfinite(rel) and rel <= limit):
        raise SystemExit(f"FAIL {name}[{variant}]: max_rel_err {rel} > "
                         f"{limit}")
    return row


def _plan_tag(D, sweep):
    """The staging plan of the multi-RHS DIA kernels on D at N_RHS
    columns: row tile, column slice, windows, shared bytes a block."""
    p = hk.dia_stage_plan(D.offs, N_RHS, D.dtype, sweep)
    return (f"R={p.rows} C={p.cols} windows={len(p.windows)} "
            f"smem={p.smem_bytes}")


def _row_tag(D, sweep):
    """The launch plan of the 1-RHS DIA kernels on D: rows a thread,
    threads, tiles, what a tile stages, shared bytes."""
    n, m = D.shape
    return hk.dia_row_plan(D.offs, n, m, D.dtype, sweep).tag()


def _dia_rows(rows, A_levels, dev, rng):
    """The DIA kernels on the flagship's DIA levels, f32 and bf16: the
    1-RHS pair on A0, A1 and A2 (the cycle's levels; A0 first), the
    N_RHS-column pair on A0.  The function needs the nonzeros and the
    offsets (the stencil holds the structure)."""
    for level, A in enumerate(A_levels[:3]):
        _dia_level_rows(rows, level, A, dev, rng)


def _dia_level_rows(rows, level, A, dev, rng):
    n, nnz = A.shape[0], int(A.count_nonzero())
    dw = torch.as_tensor((1.0 / l1_row_weights(A)).astype(np.float32))
    v1 = [torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
          for _ in range(2)]
    vs = [torch.as_tensor(rng.randn(n, N_RHS).astype(np.float32)).to(dev)
          for _ in range(2)] if level == 0 else None
    for dt in (torch.float32, torch.bfloat16):
        D = to_dia(A, dt, dev)
        nd, tag = len(D.offs), _TAG[dt]
        csr = _csr(A, dt, dev)
        d = dw.to(dev).to(dt)
        x, b = (v.to(dt) for v in v1)
        mat = nnz * x.element_size() + 4 * nd
        fl1 = 2 * nnz
        rows["dia_spmv"].append(_compare(
            "dia_spmv", f"A{level} {tag} nd={nd} n={n} "
            f"{_row_tag(D, False)}",
            lambda: hk.dia_spmv(D.data, D.offs, x, n),
            lambda: hk.dia_spmv_plain(D.data, D.offs, x, n),
            mat + _nbytes(x, x), fl1, _nbytes(D.data, x, x),
            lambda: csr @ x))
        rows["dia_jacobi_sweep"].append(_compare(
            "dia_jacobi_sweep", f"A{level} {tag} one sweep n={n} "
            f"{_row_tag(D, True)}",
            lambda: hk.dia_jacobi_sweep(D.data, D.offs, x, b, d),
            lambda: hk.dia_jacobi_sweep_plain(D.data, D.offs, x, b, d),
            mat + _nbytes(x, b, d, x), fl1 + 3 * n,
            _nbytes(D.data, x, b, d, x), library_note=JACOBI_NOTE))
        if vs is None:
            del D, csr
            continue
        X, B = (v.to(dt) for v in vs)
        fls = 2 * nnz * N_RHS
        ps, pj = (_plan_tag(D, sweep) for sweep in (False, True))
        rows["dia_spmv_multirhs"].append(_compare(
            "dia_spmv_multirhs", f"A0 {tag} nd={nd} n={n} s={N_RHS} {ps}",
            lambda: hk.dia_spmv_multirhs(D.data, D.offs, X, n),
            lambda: hk.dia_spmv_plain(D.data, D.offs, X, n),
            mat + _nbytes(X, X), fls, _nbytes(D.data, X, X),
            lambda: csr @ X))
        rows["dia_jacobi_sweep_multirhs"].append(_compare(
            "dia_jacobi_sweep_multirhs",
            f"A0 {tag} one sweep n={n} s={N_RHS} {pj}",
            lambda: hk.dia_jacobi_sweep_multirhs(D.data, D.offs, X, B, d),
            lambda: hk.dia_jacobi_sweep_plain(D.data, D.offs, X, B, d),
            mat + _nbytes(X, B, d, X), fls + 3 * n * N_RHS,
            _nbytes(D.data, X, B, d, X), library_note=JACOBI_NOTE))
        del D, csr


def _bcsr_rows(rows, cases, dev, rng):
    """bcsr_spmv on each (label, M, values dtype, x dtypes, multi) case,
    and bcsr_spmv_multirhs with N_RHS columns where multi is set.  The
    BcsrMatrix streams its nonzeros and row pointers (format_bytes), so
    format_bytes and the bound's bytes differ only by explicit zeros."""
    for label, M, tdt, xdts, multi in cases:
        B = to_bcsr(M, tdt, device=dev)
        n, m = M.shape
        csr = _csr(M, tdt, dev)
        nnz = int(M.count_nonzero())
        mat = _csr_bytes(M, B.values.element_size())
        fmt = _nbytes(B.row_ptr, B.col_idx, B.values)
        args = (B.row_ptr, B.col_idx, B.values)
        xs = torch.as_tensor(rng.randn(m).astype(np.float32)).to(dev)
        Xs = torch.as_tensor(rng.randn(m, N_RHS).astype(np.float32)
                             ).to(dev)
        for xdt in xdts:
            x, X = xs.to(xdt), Xs.to(xdt)
            y_bytes = n * torch.empty((), dtype=torch.promote_types(
                tdt, xdt)).element_size()
            tag = (f"{label} {_TAG[tdt]} values {_TAG[xdt]} x {n}x{m} "
                   f"nnz={nnz} group={B.group}")
            same = xdt == tdt    # the library call takes one dtype
            note = "torch's CSR product takes one dtype for M and x"
            rows["bcsr_spmv"].append(_compare(
                "bcsr_spmv", tag,
                lambda: hk.bcsr_spmv(*args, x, n),
                lambda: hk.bcsr_spmv_plain(*args, x, n),
                mat + _nbytes(x) + y_bytes, 2 * nnz,
                fmt + _nbytes(x) + y_bytes,
                (lambda: csr @ x) if same else None,
                None if same else note))
            if not multi:
                continue
            rows["bcsr_spmv_multirhs"].append(_compare(
                "bcsr_spmv_multirhs", f"{tag} s={N_RHS}",
                lambda: hk.bcsr_spmv_multirhs(*args, X, n),
                lambda: hk.bcsr_spmv_plain(*args, X, n),
                mat + _nbytes(X) + y_bytes * N_RHS, 2 * nnz * N_RHS,
                fmt + _nbytes(X) + y_bytes * N_RHS,
                (lambda: csr @ X) if same else None,
                None if same else note))
        del B, csr


def _ell_rows(rows, mats, dev, rng):
    """The ELL kernel in f32 on the Maxwell lane's matrices and on the
    flagship's P0 as ELL (long enough to time above launch overhead),
    each variant with its launch plan (hopper_kernels.ell_launch_plan)."""
    dt = torch.float32
    for label, M in mats:
        tag = _TAG[dt]
        E = from_scipy(M, dtype=dt, device=dev)
        n, k = E.values.shape
        csr = _csr(M, dt, dev)
        x = torch.as_tensor(rng.randn(M.shape[1])).to(dt).to(dev)
        item = x.element_size()
        rows["ell_spmv"].append(_compare(
            "ell_spmv", f"{label} {tag} {n}x{M.shape[1]} k={k} "
            f"{hk.ell_launch_plan(n, k).tag()}",
            lambda: hk.ell_spmv(E.indices, E.values, x),
            lambda: hk.ell_spmv_plain(E.indices, E.values, x),
            _csr_bytes(M, item) + _nbytes(x) + n * item,
            2 * int(M.count_nonzero()),
            _nbytes(E.indices, E.values, x) + n * item, lambda: csr @ x))
        del E, csr


def _darcy_dia_rows(rows, Hd, dev, rng, label="darcy Hd"):
    """dia_spmv on the DIA part of a darcy path's outer operator Hd (a
    DiaEllMatrix: f32, its offsets and rows, as the path gives them)."""
    D = Hd.dia
    n, nd = D.shape[0], len(D.offs)
    csr = kernel_profile._library_csr(D)
    nnz = int(csr.values().count_nonzero())
    x = torch.as_tensor(rng.randn(n).astype(np.float32)).to(dev)
    rows["dia_spmv"].append(_compare(
        "dia_spmv", f"{label} DIA part f32 nd={nd} n={n} nnz={nnz} "
        f"{_row_tag(D, False)}",
        lambda: hk.dia_spmv(D.data, D.offs, x, n),
        lambda: hk.dia_spmv_plain(D.data, D.offs, x, n),
        nnz * 4 + 4 * nd + _nbytes(x, x), 2 * nnz, _nbytes(D.data, x, x),
        lambda: csr @ x))


def _op_rows(rows, path, mats, dev, rng):
    """bcsr_spmv / ell_spmv on each (label, operator) of a path (e.g.
    every operator a cycle of its hierarchy applies,
    hierarchy.level_operators), each the path's own tensors on the card
    in the format the path gave it; a format with no hand kernel
    (TileCoo: torch ops) has no row."""
    for label, M in mats:
        name = kernel_profile.KERNEL_OF.get(type(M))
        if name is None:
            continue
        n, m = M.shape
        x = torch.as_tensor(rng.randn(m)).to(M.dtype).to(dev)
        item, nnz = x.element_size(), kernel_profile._nnz(M)
        csr = kernel_profile._library_csr(M)
        if name == "bcsr_spmv":
            args = (M.row_ptr, M.col_idx, M.values)
            tag = f"group={M.group}"
            kernel = (lambda: hk.bcsr_spmv(*args, x, n))
            plain = (lambda: hk.bcsr_spmv_plain(*args, x, n))
        else:
            args = (M.indices, M.values)
            k = M.values.shape[1]
            tag = f"k={k} {hk.ell_launch_plan(n, k).tag()}"
            kernel = (lambda: hk.ell_spmv(*args, x))
            plain = (lambda: hk.ell_spmv_plain(*args, x))
        rows[name].append(_compare(
            name, f"{path} {label} {_TAG[M.dtype]} {n}x{m} nnz={nnz} {tag}",
            kernel, plain, nnz * (item + 4) + (n + 1) * 4 + _nbytes(x)
            + n * item, 2 * nnz, _nbytes(*args, x) + n * item,
            lambda: csr @ x))
        del csr


def _ho_rows(rows, H, Hb, A0, dev, rng):
    """The high-order lane's operators as its solve applies them: A0 in
    f32 BCSR (the PCG matvec) and in bf16 BCSR with bf16 and with f32 x
    (the cycle's two pairs), P0 and R0 in bf16 BCSR with bf16 and f32 x;
    and the host A0 as the 343-slot ELL table the path held before
    hierarchy.a_format sent it to BCSR, f32 and bf16 (bf16 and f32 x):
    the bf16 ELL pairs stay held against their plain version.  bound_ms
    counts the nonzeros (values, int32 columns and row pointers), x and
    y; bound_slots_ms the stream of the format as stored (format_bytes:
    the ELL table's 343 slots a row, padding included) over the memory
    rate."""
    bf16, f32 = torch.bfloat16, torch.float32
    lvl, lvlb = H.levels[0], Hb.levels[0]
    E = from_scipy(A0.astype(np.float32), dtype=np.float32, device=dev)
    Eb = copy.deepcopy(E).to(bf16)
    for label, M, xdts in (("A0", lvl.A, (f32,)), ("A0", lvlb.A, (bf16, f32)),
                           ("A0 as ELL", E, (f32,)),
                           ("A0 as ELL", Eb, (bf16, f32)),
                           ("P0", lvlb.P, (bf16, f32)),
                           ("R0", lvlb.R, (bf16, f32))):
        name = kernel_profile.KERNEL_OF[type(M)]
        n, m = M.shape
        nnz = kernel_profile._nnz(M)
        csr = kernel_profile._library_csr(M)
        if name == "ell_spmv":
            args = (M.indices, M.values)
            k = M.values.shape[1]
            tag = f"k={k} {hk.ell_launch_plan(n, k).tag()}"
        else:
            args = (M.row_ptr, M.col_idx, M.values)
            tag = f"group={M.group}"
        for xdt in xdts:
            x = torch.as_tensor(rng.randn(m).astype(np.float32)).to(xdt)
            x = x.to(dev)
            y_bytes = n * torch.empty((), dtype=torch.promote_types(
                M.dtype, xdt)).element_size()
            if name == "ell_spmv":
                kernel = (lambda: hk.ell_spmv(*args, x))
                plain = (lambda: hk.ell_spmv_plain(*args, x))
            else:
                kernel = (lambda: hk.bcsr_spmv(*args, x, n))
                plain = (lambda: hk.bcsr_spmv_plain(*args, x, n))
            same = xdt == M.dtype      # the library call takes one dtype
            fmt = _nbytes(*args, x) + y_bytes
            row = _compare(
                name, f"ho {label} {_TAG[M.dtype]} values {_TAG[xdt]} x "
                f"{n}x{m} nnz={nnz} {tag}", kernel, plain,
                nnz * (M.values.element_size() + 4) + (n + 1) * 4
                + _nbytes(x) + y_bytes, 2 * nnz, fmt,
                (lambda: csr @ x) if same else None,
                None if same else kernel_profile.MIXED_NOTE)
            row["bound_slots_ms"] = fmt / PEAK_BYTES * 1e3
            print(f"    bound by the stored format {row['bound_slots_ms']:.4f}"
                  f" ms ({fmt} bytes)")
            rows[name].append(row)
        del csr


LOOP_TEST_NOTE = ("no single PyTorch call computes any(nom > tol2) & "
                  "(it < maxiter)")


def _loop_test_rows(rows, dev, rng):
    """pcg_loop_test against loop_test_plain at the device programs'
    shapes (one column in f32, as the 1-RHS solves; N_RHS in f32, as the
    block solve; one in f64, as the multigrid drivers), on cases that
    hit each branch (r.z above, at and below its bound, a NaN, the
    counter one step from maxiter): the counter and the flag must agree
    exactly.  ms times one launch with step 0 (in place, no change);
    the bound counts nom and tol2 read, the counter read and written
    and the flag written."""
    maxiter = 100
    for s, dt in ((1, torch.float32), (N_RHS, torch.float32),
                  (1, torch.float64)):
        err = 0.0
        for case in range(8):
            tol2 = torch.as_tensor(rng.rand(s) + 0.1).to(dt)
            nom = tol2 * torch.as_tensor(rng.choice([0.5, 1.0, 2.0], s)
                                         ).to(dt)
            if case == 1:
                nom = tol2.clone()
            if case == 2:
                nom[-1] = float("nan")
            it0 = maxiter - 1 if case in (3, 4) else int(rng.randint(0, 50))
            step = case % 2
            out = []
            for on in ("cpu", dev):
                it = torch.tensor(it0, dtype=torch.int32, device=on)
                go = torch.zeros((), dtype=torch.bool, device=on)
                graph_loop.pcg_loop_test(nom.to(on), tol2.to(on), it,
                                         maxiter, step, go)
                out.append((int(it), bool(go)))
            err = max(err, abs(out[0][0] - out[1][0])
                      + abs(int(out[0][1]) - int(out[1][1])))
        nom, tol2 = nom.to(dev), tol2.to(dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        go = torch.zeros((), dtype=torch.bool, device=dev)
        nbytes = _nbytes(nom, tol2) + 2 * 4 + 1
        row = dict(variant=f"s={s} {_TAG[dt]}", max_abs_err=err,
                   max_rel_err=err, limit=0.0,
                   ms=_ms(lambda: graph_loop.pcg_loop_test(
                       nom, tol2, it, maxiter, 0, go)),
                   plain_ms=_ms(lambda: graph_loop.loop_test_plain(
                       nom, tol2, it, maxiter)),
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   bytes=nbytes, format_bytes=nbytes, flops=s,
                   library_ms=None, library_note=LOOP_TEST_NOTE)
        print(f"  pcg_loop_test[{row['variant']}] mismatches={err:g} "
              f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
              f"  bound {row['bound_ms']:.3g} ms (bytes)")
        if err:
            raise SystemExit(f"FAIL pcg_loop_test[{row['variant']}]: the "
                             "counter or the flag differs from plain")
        rows["pcg_loop_test"].append(row)


def kernel_phase(h1_A, P0, maxwell, generic, darcy, spe10, library, ho,
                 dist, dev):
    """Each kernel against its plain version at the main paths' shapes,
    on random inputs from a fixed seed.  h1_A: the flagship's host
    operators (the DIA rows, _dia_rows).  maxwell: the lane's (A_levels,
    P_levels, D0): its level-0 operator and transfers in f32 BCSR, as
    the lane's hierarchy holds them, and Hiptmair's level-0 ELL
    matrices.  generic: the generic lane's f32 hierarchy.  darcy: (the
    darcy_hyb path's outer DiaEllMatrix, its SA-AMG hierarchy, the block
    lane's f64 hierarchy): dia_spmv on the DIA part.  spe10: (the SA
    hierarchy, the outer operator) of every level of the SPE10 lane:
    dia_spmv on each outer operator's DIA part too.  Each hierarchy
    gives a row for every operator its cycle applies, in the format the
    path gave it (_op_rows): ELL on the generic A0, the SA A0, A1 and P0
    and every block level, BCSR on the rest, whose uneven rows (~100-600
    nonzeros on the SA coarse levels) reach the kernels' tail
    handling.  library: the library lane's f64 operators
    (library_lane.kernel_operators).  ho: the high-order lane's (H, Hb,
    host A0) (_ho_rows).  dist: every table of the dist paths, the
    one-process lane's and each process's (dist_operators), as
    _op_rows."""
    rng = np.random.RandomState(0)
    rows = {k: [] for k in SOURCES}
    _dia_rows(rows, h1_A, dev, rng)
    Hd, H_sa, H_block = darcy
    _darcy_dia_rows(rows, Hd, dev, rng)
    A_levels, P_levels, D0 = maxwell
    bf16, f32 = torch.bfloat16, torch.float32
    _bcsr_rows(rows, [
        ("P0", P0, bf16, (bf16, f32), True),
        ("R0", P0.T.tocsr(), bf16, (bf16,), True),
        ("Maxwell A0", A_levels[0], f32, (f32,), False),
        ("Maxwell P0", P_levels[0], f32, (f32,), False),
        ("Maxwell R0", P_levels[0].T.tocsr(), f32, (f32,), False)],
        dev, rng)
    aux = aux_operator(A_levels[0].astype(np.float32),
                       D0[0].astype(np.float32))
    _ell_rows(rows, [("Maxwell A_aux", aux),
                     ("Maxwell D0", D0[0]),
                     ("Maxwell D0^T", D0[0].T.tocsr()),
                     ("flagship P0", P0)], dev, rng)
    _op_rows(rows, "generic", level_operators(generic), dev, rng)
    _op_rows(rows, "darcy SA", level_operators(H_sa), dev, rng)
    _op_rows(rows, "darcy block", level_operators(H_block), dev, rng)
    for l, (H, Hd) in enumerate(spe10):
        if hasattr(Hd, "dia"):
            _darcy_dia_rows(rows, Hd, dev, rng, f"spe10 L{l} Hd")
        _op_rows(rows, f"spe10 L{l} SA", level_operators(H), dev, rng)
    _op_rows(rows, "library", library, dev, rng)
    _ho_rows(rows, *ho, dev, rng)
    _op_rows(rows, "dist", dist, dev, rng)
    _loop_test_rows(rows, dev, rng)
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


def small_check_maxwell(dev):
    """The Maxwell slice at 6^3 on the card against the CPU: host
    operators from the f64 chains within 1e-10, first-solve iterations
    within one, solutions within 1e-4 of |x| (both refined to a true
    relative residual of 1e-6 in f32)."""
    runs = []
    for d in (torch.device("cpu"), dev):
        A, b, A_levels, P_levels, D0 = maxwell_lane.build_maxwell(6, d)
        H = maxwell_lane.build_solver(A_levels, P_levels, D0, d)
        x, first, niter, rel = maxwell_lane.solve_refined(H, A, b)
        runs.append((A_levels + P_levels + D0, x, first, rel))
    (Mc, xc, itc, relc), (Mg, xg, itg, relg) = runs
    op = max(abs(a - c).max() / abs(c).max() for a, c in zip(Mg, Mc))
    dx = np.linalg.norm(xg - xc) / np.linalg.norm(xc)
    print(f"small check Maxwell 6^3: operators max rel diff {op:.3e} "
          f"(limit 1e-10), first iters card {itg} cpu {itc}, rel_res card "
          f"{relg:.3e} cpu {relc:.3e}, |dx|/|x| {dx:.3e} (limit 1e-4)")
    if not (op <= 1e-10 and abs(itg - itc) <= 1 and dx <= 1e-4
            and max(relg, relc) <= maxwell_lane.RTOL):
        raise SystemExit("FAIL small check Maxwell: card and CPU disagree")


def _path(name, fn):
    """Drive one main path with every launch counter at 0 just before;
    returns (its result, the launches read just after)."""
    hk.reset_launches()
    graph_loop.reset_launches()
    out = fn()
    launches = graph_loop.snapshot()
    print(f"  launches on the {name} path: {launches}")
    return out, launches


def check_h1(rec, launches):
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
    mr = rec["multirhs"]
    if mr["n_rhs"] != N_RHS or not mr["converged"]:
        fails.append(f"block PCG did not converge in {mr['iters']}")
    if not (np.isfinite(mr["rel_res_max"]) and mr["rel_res_max"] <= 1e-4):
        fails.append(f"block PCG column rel_res {mr['rel_res_max']} > 1e-4")
    if not mr["col0_rel_diff"] <= 1e-3:
        # both solved to rtol 1e-5 through the bf16 preconditioner
        fails.append(f"block column 0 vs its 1-RHS solve "
                     f"{mr['col0_rel_diff']} > 1e-3")
    for k in ONE_RHS:
        if launches[k] <= 0 or rec["kernels"][k] <= 0:
            fails.append(f"kernel {k} never launched on the 1-RHS path")
    for k in MULTI_RHS:
        if launches[k] <= 0 or mr["kernels"][k] <= 0:
            fails.append(f"kernel {k} never launched in the block solves")
    if fails:
        raise SystemExit("FAIL h1 path: " + "; ".join(fails))


def check_h1_tuned(rec, launches):
    """The flagship on the autotune's cycle: converged, rel_res <= 1e-4,
    iterations within ITER_SLACK of the host anchor, the fine DIA SpMV
    and the BCSR transfers launched (the smoother's kernels depend on
    the cycle)."""
    fails = []
    if not rec["setup_reused"]:
        fails.append("the levels were built again")
    if not rec["converged"]:
        fails.append(f"PCG did not meet the r.z stop in {rec['iters']}")
    if abs(rec["iters"] - rec["host_iters"]) > ITER_SLACK:
        fails.append(f"iters {rec['iters']} vs host {rec['host_iters']}")
    if not (np.isfinite(rec["rel_res"]) and rec["rel_res"] <= 1e-4):
        fails.append(f"rel_res {rec['rel_res']} > 1e-4")
    for k in ("dia_spmv", "bcsr_spmv"):
        if launches[k] <= 0 or rec["kernels"][k] <= 0:
            fails.append(f"kernel {k} never launched")
    if fails:
        raise SystemExit("FAIL h1_autotuned path: " + "; ".join(fails))


def check_maxwell(rec, launches):
    fails = []
    if rec["ndofs"] != 3 * NX_MAXWELL * (NX_MAXWELL + 1) ** 2:
        fails.append(f"ndofs {rec['ndofs']}")
    if rec["first_iters"] >= maxwell_lane.MAXITER:
        fails.append(f"first PCG solve hit maxiter {rec['first_iters']}")
    rel = rec["rel_res"]
    if not (np.isfinite(rel) and (rel <= maxwell_lane.RTOL
                                  or "rel_res_floor" in rec)):
        fails.append(f"rel_res {rel} above the rtol with no floor")
    if launches["ell_spmv"] <= 0 or rec["kernels"]["ell_spmv"] <= 0:
        fails.append("kernel ell_spmv never launched on the Maxwell path")
    if fails:
        raise SystemExit("FAIL Maxwell path: " + "; ".join(fails))


def check_generic(rec, launches):
    fails = []
    if rec["ndofs"] != (NX_GENERIC + 1) ** 3:
        fails.append(f"ndofs {rec['ndofs']}")
    levels = generic_lane.n_levels(NX_GENERIC)
    if rec["levels"] != levels or len(rec["dims"]) != levels:
        fails.append(f"levels {rec['levels']}, dims {rec['dims']}")
    if not rec["converged"]:
        fails.append(f"PCG did not meet the r.z stop in {rec['iters']}")
    if rec["iters"] > rec["host_iters"] + 1:
        fails.append(f"iters {rec['iters']} > host anchor "
                     f"{rec['host_iters']} + 1")
    if not (np.isfinite(rec["rel_res"])
            and rec["rel_res"] <= 10 * rec["rtol"]):
        # the converged rule of solvers/autotune.tune_cycle: 10 * rtol
        fails.append(f"rel_res {rec['rel_res']} > 10 * {rec['rtol']}")
    if launches["bcsr_spmv"] <= 0 or rec["kernels"]["bcsr_spmv"] <= 0:
        fails.append("kernel bcsr_spmv never launched on the generic path")
    if fails:
        raise SystemExit("FAIL generic path: " + "; ".join(fails))


def _rel(a, b):
    return float(abs(a - b).max() / max(abs(b).max(), 1e-300))


def small_check_generic(dev):
    """The generic engine at 8^3 over 3 levels: the host backend on the
    CPU against the device backend on the card (equal coarse dimensions
    of every level and form, P of every form within 5e-5, the contract
    of the JAX package's tests/test_bench_pipeline.py), then the f32
    hierarchy of each chain on its device: every level's A, P and R
    applied to one random vector, card against CPU within 1e-5 of the
    largest entry."""
    n, mc = 8, 8
    cpu = torch.device("cpu")
    topo = generic_lane.build_topologies(n, mc)
    sh, Ah, _, _ = generic_lane.build_h1(n, "host", cpu, mc, topo)
    sd, Ad, _, _ = generic_lane.build_h1(n, "device", dev, mc, topo)
    miss = generic_lane.first_dim_mismatch(sh, sd)
    dP = max(abs(sp.csr_matrix(a.P[j]) - b.P[j]).max()
             for a, b in zip(sh[:-1], sd[:-1]) for j in range(4))
    print(f"small check generic 8^3: dims host "
          f"{generic_lane.coarse_dims(sh)} device "
          f"{generic_lane.coarse_dims(sd)}, first mismatch (level, form, "
          f"(codim, entity)) {miss}, P max abs diff {dP:.3e} (limit 5e-5)")
    if miss is not None or not dP < 5e-5:
        raise SystemExit("FAIL small check generic: device backend "
                         "disagrees with the host backend")
    ys = []
    for seqs, A, d in ((sh, Ah, cpu), (sd, Ad, dev)):
        H, _, _ = build_amge_hierarchy(seqs, 0, A.astype(np.float32),
                                       sweeps=2, dtype=np.float32, device=d)
        out = []
        for l in H.levels:
            for M in (l.A, l.P, l.R):
                if M is None:
                    continue
                x = torch.as_tensor(np.random.RandomState(M.shape[1]).randn(
                    M.shape[1]).astype(np.float32)).to(d)
                out.append((M @ x).double().cpu().numpy())
        ys.append(out)
    op = max(_rel(a, c) for a, c in zip(ys[1], ys[0]))
    print(f"  f32 hierarchy operators card vs CPU: max rel diff {op:.3e} "
          f"(limit 1e-5) over {len(ys[0])} operators")
    if not op <= 1e-5:
        raise SystemExit("FAIL small check generic: hierarchy operators")


def darcy_anchor(hyb, Hs, gf):
    """The darcy_hyb path's anchor: the same refined solve on the same
    system in the card's branch (f32 PCG inside f64 host refinement) on
    the CPU, through the kernels' plain versions; its last_device."""
    t0 = time.perf_counter()
    hyb._device_solve(Hs, gf, rtol=darcy_lane.RTOL, device="cpu",
                      dtype=np.float32)
    ref = dict(hyb.last_device)
    print(f"  CPU anchor (f32 branch, plain versions): {ref['iters']} iters"
          f" / {ref['passes']} passes, rel_res {ref['rel_res']:.3e}, SA "
          f"levels {ref['sa_level_sizes']} ({time.perf_counter() - t0:.1f}"
          " s)")
    return ref


def check_darcy(rec, launches, ref):
    """rel_res <= 1e-6 in host f64 after refinement; the SA level sizes
    equal the CPU anchor's (host setup) and the iterations at most
    DARCY_ITER_SLACK above its: a kernel that is wrong inside the V-cycle
    costs iterations before it costs the residual."""
    fails = []
    if rec["n_mult"] != 774144 or rec["npad"] != 1 << 20:
        fails.append(f"n_mult {rec['n_mult']} npad {rec['npad']}")
    if not (np.isfinite(rec["rel_res"]) and rec["rel_res"] <= 1e-6):
        fails.append(f"rel_res {rec['rel_res']} > 1e-6 after "
                     f"{rec['passes']} refinement passes")
    if rec["sa_level_sizes"] != ref["sa_level_sizes"]:
        fails.append(f"SA levels {rec['sa_level_sizes']} vs the CPU "
                     f"anchor's {ref['sa_level_sizes']}")
    if rec["iters"] > ref["iters"] + DARCY_ITER_SLACK:
        fails.append(f"iters {rec['iters']} > CPU anchor {ref['iters']} + "
                     f"{DARCY_ITER_SLACK}")
    for k in ("dia_spmv", "bcsr_spmv", "ell_spmv"):
        if launches[k] <= 0 or rec["kernels"][k] <= 0:
            fails.append(f"kernel {k} never launched in the timed solve")
    if fails:
        raise SystemExit("FAIL darcy_hyb path: " + "; ".join(fails))


def check_spe10(rec, out, ref, out_ref, launches):
    """The fine level's dofs and multipliers equal the JAX package's
    (they do not depend on the partition).  Against the port's own run
    on this machine's CPU, whose graph partition is the card run's:
    every level's dofs and multipliers equal, u_l2_rel within
    SPE10_L2_LIMIT, the fine u within SPE10_U_LIMIT of its largest
    entry.  (The partitioner's unstable np.argsort orders tied part
    sizes by the numpy build, so the JAX run's coarse numbers hold only
    under its numpy.)  Every level's device solve meets rtol in host
    f64."""
    fails = []
    if rec["ndofs"][0] != SPE10_NDOFS[0] or \
            rec["n_mult"][0] != SPE10_NMULT[0]:
        fails.append(f"fine ndofs {rec['ndofs']} multipliers "
                     f"{rec['n_mult']} vs the JAX package's")
    if rec["ndofs"] != ref["ndofs"] or rec["n_mult"] != ref["n_mult"]:
        fails.append(f"ndofs {rec['ndofs']} mult {rec['n_mult']} vs the "
                     f"CPU run's {ref['ndofs']} {ref['n_mult']}")
    dl = abs(rec["u_l2_rel"] - ref["u_l2_rel"])
    du = (_rel(out["u"][0], out_ref["u"][0])
          if len(out["u"][0]) == len(out_ref["u"][0]) else np.inf)
    print(f"  ndofs {rec['ndofs']} mult {rec['n_mult']}; u_l2_rel "
          f"{rec['u_l2_rel']:.10f}, CPU {ref['u_l2_rel']:.10f} (|diff| "
          f"{dl:.3e}, limit {SPE10_L2_LIMIT:g}), fine |du| {du:.3e} (limit "
          f"{SPE10_U_LIMIT:g}); JAX package on its CPU: ndofs "
          f"{SPE10_NDOFS}, u_l2_rel {SPE10_U_L2_REL:.10f}")
    if not dl <= SPE10_L2_LIMIT:
        fails.append(f"u_l2_rel {rec['u_l2_rel']} vs the CPU run's "
                     f"{ref['u_l2_rel']}")
    if not du <= SPE10_U_LIMIT:
        fails.append(f"fine u differs from the CPU run's by {du}")
    if any(d is None or not d["rel_res"] <= darcy_lane.RTOL
           for d in rec["device_solves"]):
        fails.append("a level's device solve missing or above rtol: "
                     f"{[d and d['rel_res'] for d in rec['device_solves']]}")
    if launches["bcsr_spmv"] <= 0 or rec["kernels"]["bcsr_spmv"] <= 0:
        fails.append("kernel bcsr_spmv never launched on the SPE10 path")
    if fails:
        raise SystemExit("FAIL spe10 path: " + "; ".join(fails))


def _row_key(r):
    return (r["granularity"], json.dumps(r["cfg"], sort_keys=True))


def check_autotune(rec, ref, launches):
    """Every candidate's iterations within one of, and converged equal
    to, the same lane on the CPU; the DIA and BCSR kernels ran."""
    fails = []
    cpu = {_row_key(r): r for r in ref["grid"]}
    if len(cpu) != len(rec["grid"]):
        fails.append(f"{len(rec['grid'])} rows against the CPU's "
                     f"{len(cpu)}")
    for r in rec["grid"]:
        c = cpu.get(_row_key(r))
        print(f"  {r['granularity']:16s} {json.dumps(r['cfg']):52s} iters "
              f"{r['iters']} (CPU {c and c['iters']}) converged "
              f"{r['converged']} (CPU {c and c['converged']}) solve_s "
              f"{r['solve_s']:.5f}")
        if c is None or abs(r["iters"] - c["iters"]) > 1 \
                or r["converged"] != c["converged"]:
            fails.append(f"{_row_key(r)}: {r['iters']}/{r['converged']} "
                         f"vs the CPU's {c and (c['iters'], c['converged'])}")
    if "best_structured_cfg" not in rec:
        fails.append("no structured candidate converged")
    for k in ("dia_spmv", "dia_jacobi_sweep", "bcsr_spmv"):
        if launches[k] <= 0:
            fails.append(f"kernel {k} never launched on the autotune path")
    if fails:
        raise SystemExit("FAIL autotune path: " + "; ".join(fails))


def check_sps(rec, out, ref, out_ref):
    """spe10_structured on the card against the same lane on the CPU."""
    fails = []
    for k in ("ndofs_u", "coarse_u", "coarse_p"):
        if rec[k] != ref[k]:
            fails.append(f"{k} {rec[k]} vs the CPU's {ref[k]}")
    for k in ("n_facet_dofs", "n_ae_u_dofs", "n_ae_p_dofs"):
        a, b = getattr(out, k), getattr(out_ref, k)
        if a.shape != b.shape or (a != b).any():
            bad = (np.flatnonzero(a != b)[:10].tolist()
                   if a.shape == b.shape else "shape")
            fails.append(f"{k} differs from the CPU's at {bad}")
    dl = abs(rec["u_l2_rel"] - ref["u_l2_rel"]) / ref["u_l2_rel"]
    print(f"  dims u {rec['ndofs_u']} -> {rec['coarse_u']}, p -> "
          f"{rec['coarse_p']} (CPU {ref['coarse_u']}, {ref['coarse_p']}); "
          f"u_l2_rel card {rec['u_l2_rel']:.12f} CPU {ref['u_l2_rel']:.12f}"
          f" (rel diff {dl:.3e}, limit {SPS_U_L2_LIMIT:g}); ext_spot_err "
          f"card {rec['ext_spot_err']:.3e} CPU {ref['ext_spot_err']:.3e} "
          f"(limit {SPOT_LIMIT:g})")
    if not dl <= SPS_U_L2_LIMIT:
        fails.append(f"u_l2_rel {rec['u_l2_rel']} vs {ref['u_l2_rel']}")
    if not max(rec["ext_spot_err"], ref["ext_spot_err"]) < SPOT_LIMIT:
        fails.append("ext_spot_err above its limit")
    if fails:
        raise SystemExit("FAIL spe10_structured path: " + "; ".join(fails))


def check_sps_full(rec, out):
    """The full grid against the JAX host f64 anchor's dims."""
    fails = []
    near = {k: v for k, v in out.near_threshold.items() if v}
    print(f"  ndofs_u {rec['ndofs_u']} (anchor {SPS_FULL_NDOFS_U}), "
          f"coarse_u {rec['coarse_u']} (anchor {SPS_FULL_COARSE_U}), "
          f"coarse_p {rec['coarse_p']}; least keep margins "
          f"{out.min_margin}; entities within {sps.NEAR_REL:g} of a "
          f"threshold: {near or 'none'}")
    if rec["ndofs_u"] != SPS_FULL_NDOFS_U:
        fails.append(f"ndofs_u {rec['ndofs_u']}")
    if rec["coarse_u"] != SPS_FULL_COARSE_U and not near:
        fails.append(f"coarse_u {rec['coarse_u']} != the anchor's "
                     f"{SPS_FULL_COARSE_U}, and no entity sits within "
                     f"{sps.NEAR_REL:g} of a keep threshold")
    if not rec["ext_spot_err"] < SPOT_LIMIT:
        fails.append(f"ext_spot_err {rec['ext_spot_err']}")
    if fails:
        raise SystemExit("FAIL spe10_structured full grid: "
                         + "; ".join(fails))


def check_ml(rec, ref):
    """spe10_ml on the card against the same lane on the CPU."""
    fails = []
    for k in ("ndofs_u", "coarse_u", "coarse_p"):
        if rec[k] != ref[k]:
            fails.append(f"{k} {rec[k]} vs the CPU's {ref[k]}")
    dl = abs(rec["u_l2_rel"] - ref["u_l2_rel"]) / ref["u_l2_rel"]
    print(f"  coarse_u {rec['coarse_u']} coarse_p {rec['coarse_p']} (CPU "
          f"{ref['coarse_u']} {ref['coarse_p']}); ns_res {rec['ns_res']:.3e}"
          f" (limit {sps._GUARD_TOL:g}); ext_spot_err "
          f"{rec['ext_spot_err']:.3e} (limit {SPOT_LIMIT:g}); u_l2_rel card "
          f"{rec['u_l2_rel']:.10f} CPU {ref['u_l2_rel']:.10f} (rel diff "
          f"{dl:.3e}, limit {ML_U_L2_LIMIT:g})")
    if not rec["ns_res"] < sps._GUARD_TOL:
        fails.append(f"ns_res {rec['ns_res']}")
    if not rec["ext_spot_err"] < SPOT_LIMIT:
        fails.append(f"ext_spot_err {rec['ext_spot_err']}")
    if not dl <= ML_U_L2_LIMIT:
        fails.append(f"u_l2_rel {rec['u_l2_rel']} vs {ref['u_l2_rel']}")
    if fails:
        raise SystemExit("FAIL spe10_ml path: " + "; ".join(fails))


def check_block(rec, launches):
    if not (rec["err_vs_direct"] < 1e-8 and launches["ell_spmv"] > 0
            and rec["kernels"]["ell_spmv"] > 0):
        raise SystemExit(f"FAIL darcy block path: err_vs_direct "
                         f"{rec['err_vs_direct']}, ell_spmv launches "
                         f"{launches['ell_spmv']}")


def small_check_darcy(dev):
    """The hybridized solve at 8^3 (f32 with f64 refinement on the card,
    f64 on the CPU): both meet rtol 1e-8 in host f64 and x agrees within
    1e-6 of its largest entry; then spe10_darcy at (8, 8, 4) (spectral,
    the device multiplier solve on each side): equal ndofs, u_l2_rel
    within 1e-6, the fine u within 1e-6 of its largest entry."""
    hyb, H, g = darcy_lane.build_darcy_hyb(8)
    xs = []
    for d in ("cpu", dev):
        x = hyb._device_solve(H, g, rtol=darcy_lane.RTOL, device=d)
        xs.append((x, dict(hyb.last_device),
                   np.linalg.norm(g - H @ x) / np.linalg.norm(g)))
    (xc, ic, rc), (xg, ig, rg) = xs
    dx = _rel(xg, xc)
    print(f"small check darcy_hyb 8^3: card {ig['dtype']} {ig['iters']} "
          f"iters / {ig['passes']} passes rel_res {rg:.3e}; cpu "
          f"{ic['dtype']} {ic['iters']} iters rel_res {rc:.3e}; |dx| "
          f"{dx:.3e} (limit 1e-6)")
    if not (max(rg, rc) <= 1e-7 and rg <= darcy_lane.RTOL and dx <= 1e-6):
        raise SystemExit("FAIL small check darcy: card and CPU disagree")
    outs = [darcy_lane.lane_spe10((8, 8, 4), d)[1] for d in ("cpu", dev)]
    (oc, og) = outs
    du = _rel(og["u"][0], oc["u"][0])
    dl = abs(og["u_l2_rel"] - oc["u_l2_rel"])
    print(f"small check spe10 (8, 8, 4): ndofs {og['ndofs']} / "
          f"{oc['ndofs']}, u_l2_rel card {og['u_l2_rel']:.10f} cpu "
          f"{oc['u_l2_rel']:.10f} (limit 1e-6), |du| {du:.3e} (limit "
          f"1e-6)")
    if not (og["ndofs"] == oc["ndofs"] and dl <= 1e-6 and du <= 1e-6):
        raise SystemExit("FAIL small check spe10: card and CPU disagree")


def _print_library(rec):
    for name, c in rec["compositions"].items():
        print(f"  {name} (form {c['form']}, n={c['n']}): executed_on "
              f"{c['executed_on']} iters {c['iters']} rel_res "
              f"{c['rel_res']:.3e} setup_s {c['setup_s']:.3f} solve_s "
              f"{c['solve_s']:.5f} formats {c['formats']} transfers "
              f"{c['transfers']} kernels {c['kernels']}")


def small_check_library(dev):
    """The library lane with both chains at LIB_SMALL_NREF (16^3 cells)
    on the card against the same lane on the CPU: every composition on
    the device on both, iterations within one, x within LIB_X_LIMIT
    relative; then multigrid_test_form(form, nref=2) on the card gives
    the JAX package's golden iterations.  Returns the card's iterations
    by composition (n_16 of the level-independence bound)."""
    (rg, _, sg), (rc, _, sc) = (
        library_lane.lane_library(LIB_SMALL_NREF, d, LIB_SMALL_NREF)
        for d in (dev, torch.device("cpu")))
    fails = []
    for name, cg in rg["compositions"].items():
        cc = rc["compositions"][name]
        dx = _rel(sg[name][1], sc[name][1])
        print(f"  small check library 16^3 {name}: iters card {cg['iters']}"
              f" cpu {cc['iters']}, executed_on {cg['executed_on']} / "
              f"{cc['executed_on']}, rel_res card {cg['rel_res']:.3e}, "
              f"|dx|/|x| {dx:.3e} (limit {LIB_X_LIMIT:g})")
        if not (cg["executed_on"] == cc["executed_on"] == "device"
                and abs(cg["iters"] - cc["iters"]) <= 1
                and dx <= LIB_X_LIMIT):
            fails.append(name)
    for form, gold in MG_GOLDEN_ITERS.items():
        r = multigrid_test_form(form, nref=2, device=dev)
        print(f"  multigrid_test_form({form}, nref=2) on the card: iters "
              f"{r.iterations} (golden {gold}) conv {r.conv_factor:.4f} "
              f"final_residual {r.final_residual:.3e}")
        if r.iterations != gold:
            fails.append(f"multigrid form {form}")
    if fails:
        raise SystemExit("FAIL small check library: " + "; ".join(fails))
    return {k: c["iters"] for k, c in rg["compositions"].items()}


def check_library(rec, launches, n16):
    """Every composition ran on the device with a true f64 relative
    residual <= LIB_RES_LIMIT; each scalar composition's iterations stay
    within max(2 n_16, n_16 + 15) of its 16^3 count (the JAX package's
    level-independence bound, tests/test_device_library.py); bcsr_spmv
    and ell_spmv launched."""
    fails = []
    for name, c in rec["compositions"].items():
        if c["executed_on"] != "device":
            fails.append(f"{name} ran on {c['executed_on']}")
        if not c["rel_res"] <= LIB_RES_LIMIT:
            fails.append(f"{name} rel_res {c['rel_res']:.3e}")
        if name in library_lane.SCALAR:
            n = n16[name]
            limit = max(2 * n, n + 15)
            print(f"  {name}: iters {c['iters']} at nref {rec['nref']}, "
                  f"{n} at 16^3 (limit {limit})")
            if c["iters"] > limit:
                fails.append(f"{name} iters {c['iters']} > {limit}")
    for k in ("bcsr_spmv", "ell_spmv"):
        if launches[k] <= 0:
            fails.append(f"{k} not launched")
    if fails:
        raise SystemExit("FAIL library path: " + "; ".join(fails))


def check_ho(rec, launches, Hb):
    """The ho_p2 record: 117,649 dofs at 16^3, p = 2, converged within
    ITER_SLACK iterations of the host f64 anchor, rel_res <= 1e-4, A0 a
    BCSR matrix in f32 (the PCG matvec) and in the bf16 cast the cycle
    applies (hierarchy.a_format: its 343-slot ELL table would hold 3.45
    slots a nonzero), BCSR transfers, no ell_spmv in the timed solves,
    and more bcsr_spmv launches there than the transfers (one R0 and one
    P0 a cycle, a cycle an iteration and one to start) and the f32
    matvecs account for: the bf16 cycle applied A0."""
    fails = []
    nv = (HO_P * NX_HO + NX_HO + 1) ** 3
    if rec["ndofs"] != nv:
        fails.append(f"ndofs {rec['ndofs']} != {nv}")
    if not rec["converged"]:
        fails.append(f"PCG did not meet the r.z stop in {rec['iters']}")
    if abs(rec["iters"] - rec["host_iters"]) > ITER_SLACK:
        fails.append(f"iters {rec['iters']} vs host {rec['host_iters']}")
    if not (np.isfinite(rec["rel_res"]) and rec["rel_res"] <= 1e-4):
        fails.append(f"rel_res {rec['rel_res']} > 1e-4")
    A0b = Hb.levels[0].A
    if rec["formats"][0] != "BcsrMatrix":
        fails.append(f"the f32 A0 is {rec['formats'][0]}, not BcsrMatrix")
    if type(A0b).__name__ != "BcsrMatrix" or A0b.dtype != torch.bfloat16:
        fails.append(f"the cycle's A0 is {type(A0b).__name__} "
                     f"{A0b.dtype}, not a bf16 BcsrMatrix")
    if set(rec["transfers"]) != {"BcsrMatrix"}:
        fails.append(f"transfers {rec['transfers']}")
    cycles = sum(it + 1 for it in rec["timed_iters"])
    if rec["kernels"]["ell_spmv"] != 0:
        fails.append(f"ell_spmv {rec['kernels']['ell_spmv']} launches in "
                     "the timed solves: A0 did not leave ELL")
    if rec["kernels"]["bcsr_spmv"] <= 3 * cycles:
        fails.append(f"bcsr_spmv {rec['kernels']['bcsr_spmv']} launches in "
                     f"the timed solves, no more than their {2 * cycles} "
                     f"transfers and {cycles} f32 matvecs: the bf16 cycle "
                     "did not apply A0")
    if launches["bcsr_spmv"] <= 0 or rec["kernels"]["bcsr_spmv"] <= 0:
        fails.append("kernel bcsr_spmv never launched on the ho path")
    if fails:
        raise SystemExit("FAIL ho path: " + "; ".join(fails))


def check_device_loop(solves):
    """The device programs of the main paths' PCG solves (compile_pcg:
    one CUDA graph, the loop test on the card) against the same solves'
    Python loops, from the lanes' records (flagship.loop_record): per
    solve (name, record, the launches of its path) the same iterations
    warm and in every timed solve, x within LOOP_X_LIMIT, the same hand
    kernels launched in the timed solves, pcg_loop_test launched once a
    test (iterations + 1 a solve) and on the path, and the captured
    body's kernel nodes of the hand-written kernels equal to its counted
    launches (cudaGraphGetNodes), all its kernel nodes at least as
    many."""
    fails, out = [], []
    for name, rec, launches in solves:
        it, itp = rec["loop_iters"], rec["python_loop_iters"]
        row = dict(solve=name, loop=rec["loop"], iters=it,
                   python_loop_iters=itp, timed_iters=rec["timed_iters"],
                   x_rel=rec["python_loop_x_rel"],
                   wall_ms=rec["solve_s"] * 1e3,
                   python_loop_wall_ms=rec["python_loop_s"] * 1e3,
                   wall_ms_all=[t * 1e3 for t in rec["solve_s_all"]],
                   python_loop_wall_ms_all=[
                       t * 1e3 for t in rec["python_loop_s_all"]],
                   compile_s=rec["compile_s"],
                   graph_nodes=rec["graph_nodes"],
                   body_launches=rec.get("body_launches"),
                   body_kernel_nodes=rec.get("body_kernel_nodes"),
                   body_own_kernel_nodes=rec.get("body_own_kernel_nodes"),
                   loop_tests=rec["loop_tests"], kernels=rec["kernels"])
        out.append(row)
        print(f"  {name}: iterations {it} (Python loop {itp}; timed "
              f"{rec['timed_iters']}), x rel diff {row['x_rel']:.3e}, "
              f"wall {row['wall_ms']:.3f} ms (Python loop "
              f"{row['python_loop_wall_ms']:.3f} ms), compile_s "
              f"{row['compile_s']:.4f}, graph_nodes {row['graph_nodes']} "
              f"(body: {row['body_own_kernel_nodes']} hand-kernel nodes of "
              f"{row['body_kernel_nodes']}, {row['body_launches']} counted "
              f"launches), kernels {rec['kernels']}")
        bad = []
        if rec["loop"] != "device":
            bad.append(f"loop {rec['loop']}")
        if it != itp or set(rec["timed_iters"]) != {it}:
            bad.append(f"iterations {it} / timed {rec['timed_iters']} vs "
                       f"the Python loop's {itp}")
        if not row["x_rel"] <= LOOP_X_LIMIT:
            bad.append(f"x differs by {row['x_rel']} > {LOOP_X_LIMIT}")
        if rec["kernels"] != rec["python_loop_kernels"]:
            bad.append(f"kernels {rec['kernels']} vs the Python loop's "
                       f"{rec['python_loop_kernels']}")
        tests = sum(i + 1 for i in rec["timed_iters"])
        if rec["loop_tests"] != tests:
            bad.append(f"pcg_loop_test {rec['loop_tests']} launches, not "
                       f"{tests}")
        if launches["pcg_loop_test"] <= 0:
            bad.append("pcg_loop_test never launched on the path")
        if (rec["body_own_kernel_nodes"] != rec["body_launches"]
                or rec["body_kernel_nodes"] < rec["body_launches"]):
            bad.append(f"the body's kernel nodes {rec['body_kernel_nodes']}"
                       f" (hand-written {rec['body_own_kernel_nodes']}) vs "
                       f"{rec['body_launches']} counted launches")
        fails += [f"{name}: {b}" for b in bad]
    print("  device_loop: " + json.dumps(out))
    if fails:
        raise SystemExit("FAIL device_loop: " + "; ".join(fails))


def small_check_ho(dev):
    """lane_ho at NX_HO_SMALL^3, p = 2, on the card and on the CPU: equal
    coarse dims, iterations within one, both rel_res <= 1e-4."""
    recs = [ho_lane.lane_ho(NX_HO_SMALL, HO_P, d)[0] for d in ("cpu", dev)]
    (rc, rg) = recs
    print(f"small check ho {NX_HO_SMALL}^3 p={HO_P}: dims card {rg['dims']}"
          f" cpu {rc['dims']}, iters card {rg['iters']} cpu {rc['iters']},"
          f" rel_res card {rg['rel_res']:.3e} cpu {rc['rel_res']:.3e}")
    if not (rg["dims"] == rc["dims"] and abs(rg["iters"] - rc["iters"]) <= 1
            and max(rg["rel_res"], rc["rel_res"]) <= 1e-4):
        raise SystemExit("FAIL small check ho: card and CPU disagree")


def check_rcm(it, it_ref, dx, rel):
    print(f"  rcm: iters {it} (unpermuted {it_ref}), |x - x_ref|/|x_ref| "
          f"{dx:.3e} (limit {RCM_X_LIMIT:g}), rel_res {rel:.3e}")
    if not (abs(it - it_ref) <= 1 and dx <= RCM_X_LIMIT and rel <= 1e-4):
        raise SystemExit("FAIL rcm: the reordered solve disagrees")


def _sp_rel(A, B):
    D = sp.csr_matrix(A - B)
    den = max(np.abs(sp.csr_matrix(B).data).max(initial=0.0), 1e-300)
    return float(np.abs(D.data).max(initial=0.0) / den)


def a4_coeff(shape, cshape, seed=7):
    """tests/test_structured.py's heterogeneous regime: a log-uniform
    coefficient 10^U(-2, 2) (numpy default_rng(seed)), constant on each
    coarse cell of cshape (agglomerate-resolved, so the chain keeps its
    static structure down to cshape)."""
    rng = np.random.default_rng(seed)
    f = tuple(s // c for s, c in zip(shape, cshape))
    per_ae = 10.0 ** rng.uniform(-2, 2, size=int(np.prod(cshape)))
    k, j, i = np.meshgrid(*(np.arange(s) for s in shape[::-1]),
                          indexing="ij")
    ae = ((k // f[2]) * cshape[1] + j // f[1]) * cshape[0] + i // f[0]
    return per_ae[ae.ravel()]


def structured_a4(dev):
    """Phase l: the heterogeneous chain on the card with its Galerkin and
    commutation residuals on the host, and coarsen_darcy against the
    full chain's L2/Hdiv stages at A4_DARCY_SHAPE."""
    t0 = time.perf_counter()
    cshape = tuple(s >> (A4_LEVELS - 1) for s in A4_SHAPE)
    lvl0 = stc.fine_level(A4_SHAPE, coeff=a4_coeff(A4_SHAPE, cshape),
                          device=dev)
    levels, outs = stc.coarsen_chain(lvl0, A4_LEVELS)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    gal = com = 0.0
    for lvl, out, coarse in zip(levels, outs, levels[1:]):
        P = [stc.materialize_P(out, lvl.shape, j) for j in range(4)]
        for j in range(4):
            gal = max(gal, _sp_rel((P[j].T @ stc.global_mass(lvl, j)
                                    @ P[j]).tocsr(),
                                   stc.global_mass(coarse, j)))
        for j in range(3):
            lhs = (stc.global_derivative(lvl, j) @ P[j]).tocsr()
            rhs = (P[j + 1] @ stc.global_derivative(coarse, j)).tocsr()
            com = max(com, _sp_rel(rhs, lhs))
    print(f"  heterogeneous chain {A4_SHAPE} x {A4_LEVELS} levels on the "
          f"card {chain_s:.2f} s: Galerkin {gal:.3e}, commutation "
          f"{com:.3e} (limit {A4_LIMIT:g}), trace sv "
          f"{max(o.max_rel_sv for o in outs):.3e}")
    del levels, outs, lvl0
    lvl0 = stc.fine_level(A4_DARCY_SHAPE, device=dev)
    t0 = time.perf_counter()
    cd, od = stc.coarsen_darcy(lvl0)
    torch.cuda.synchronize()
    darcy_s = time.perf_counter() - t0
    cs, os_ = stc.coarsen_structured(lvl0, jform_start=2)
    dd = max([_rel(getattr(od, f).double().cpu().numpy(),
                   getattr(os_, f).double().cpu().numpy())
              for f in ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c")]
             + [_rel(getattr(cd, f).double().cpu().numpy(),
                     getattr(cs, f).double().cpu().numpy())
                for f in ("m03", "m12", "m02", "d2", "t3", "t2")])
    P2, P3 = stc.materialize_P_darcy(od, A4_DARCY_SHAPE)
    print(f"  coarsen_darcy {A4_DARCY_SHAPE} on the card {darcy_s:.2f} s: "
          f"against coarsen_structured(jform_start=2) {dd:.3e} (limit "
          f"{A4_DARCY_LIMIT:g}); P2 {P2.shape} P3 {P3.shape}")
    if not (gal <= A4_LIMIT and com <= A4_LIMIT and dd <= A4_DARCY_LIMIT):
        raise SystemExit("FAIL structured_a4")
    return dict(chain_s=chain_s, galerkin=gal, commutation=com,
                darcy_s=darcy_s, darcy_diff=dd)


def dist_path(dev):
    """dist_bench.distributed_solve_bench at every DIST_NY: [(record,
    (hier, b, x))]."""
    return [dist_bench.distributed_solve_bench(DIST_RANKS, ny, DIST_STEPS,
                                               dev) for ny in DIST_NY]


def check_dist(runs, launches, smi):
    """Each dist run: 17 (8 ny + 1) 21 dofs on 4 levels, finite rel_res
    below the zero guess's, ell_spmv launched in the timed steps, and x
    as close to the same f32 steps on the CPU (the port's plain versions
    on the same hierarchy) as twice f32's own error there: the CPU's f32
    x against the same steps in f64 arithmetic on the same f32 tables
    (two f32 runs each that far from the f64 one lie within twice it;
    the gap is 1.4e-5 at ny_per_rank 4 and 8.2e-4 at 32 on the CPU,
    where the f32 iteration loses more); then
    dryrun_multichip(DIST_RANKS) on the card.  Returns {ny_per_rank:
    gap}."""
    fails, gaps = [], {}
    cpu = make_dd_mesh(DIST_RANKS, "cpu")
    for rec, (hier, b, x) in runs:
        ny = rec["ny_per_rank"]
        xs = [hier.systems[0].to_global(dist_bench.steps_from_zero(
            h, b, cpu)(DIST_STEPS)[0].double().numpy())
            for h in (hier, dist_bench.cast(hier, np.float64))]
        xc, x64 = xs
        gap = float(np.linalg.norm(xc - x64) / np.linalg.norm(x64))
        gaps[ny] = gap
        dx = float(np.linalg.norm(x - xc) / np.linalg.norm(xc))
        print(f"  dist {DIST_RANKS} ranks ny_per_rank={ny} ({smi}): ndofs "
              f"{rec['ndofs']} levels {rec['level_ndofs']} setup_s "
              f"{rec['setup_s']:.2f} step_s {rec['step_s']:.6f} value "
              f"{rec['value']:.4e} {rec['unit']} rel_res {rec['rel_res']:.3e}"
              f" after {DIST_STEPS} steps, kernels {rec['kernels']}; card "
              f"vs CPU |dx|/|x| {dx:.3e} (limit 2 x the CPU's f32 vs f64 "
              f"{gap:.3e})")
        nv = 17 * (8 * ny + 1) * 21
        if rec["ndofs"] != nv or rec["levels"] != 4:
            fails.append(f"ny {ny}: ndofs {rec['ndofs']} levels "
                         f"{rec['levels']} (need {nv}, 4)")
        if not (np.isfinite(rec["rel_res"]) and rec["rel_res"] < 1):
            fails.append(f"ny {ny}: rel_res {rec['rel_res']}")
        if rec["kernels"]["ell_spmv"] <= 0:
            fails.append(f"ny {ny}: no ell_spmv in the timed steps")
        if not dx <= 2 * gap:
            fails.append(f"ny {ny}: card vs CPU {dx} > 2 x {gap}")
    if launches["ell_spmv"] <= 0:
        fails.append("kernel ell_spmv never launched on the dist path")
    entry.dryrun_multichip(DIST_RANKS)
    torch.cuda.synchronize()
    print(f"  dryrun_multichip({DIST_RANKS}) ok")
    if fails:
        raise SystemExit("FAIL dist path: " + "; ".join(fails))
    return gaps


def dist_operators(runs, solve_hier, dev):
    """Every table the dist paths launch ell_spmv on, as (label,
    EllMatrix) (dist_bench.level_operators): the one-process lane's at
    each DIST_NY; at each DIST_MP each process's own ranks' rows (a
    RankMesh of that world and rank: _level reads only the mesh's rank
    range, so no group is needed; check_dist_mp holds the processes'
    tables byte-equal to the one-process hierarchy these come from); and
    each process's f64 tables of the mp solve case (solve_hier,
    mp_worker.solve_problem's)."""
    hiers = {rec["ny_per_rank"]: hier for rec, (hier, _, _) in runs}
    meshes = [(f"1p ny{ny}", hier, make_dd_mesh(DIST_RANKS, dev))
              for ny, hier in hiers.items()]
    meshes += [(f"{world}p ny{ny} process {rank}", hiers[ny],
                RankMesh(DIST_RANKS, dev, world=world, rank=rank))
               for world, ny in DIST_MP for rank in range(world)]
    meshes += [(f"solve {MP_WORLD}p process {rank}", solve_hier,
                RankMesh(mp_worker.RANKS, dev, world=MP_WORLD, rank=rank))
               for rank in range(MP_WORLD)]
    return [(f"{tag} {label}", M) for tag, hier, mesh in meshes
            for label, M in dist_bench.level_operators(
                hier.device_args(mesh)[0])]


def dist_mp_path(dev, tmp):
    """mp_worker.launch of the dist case at every DIST_MP (x written
    under tmp), then the solve and setup cases in 2 processes:
    ({(world, ny): (records, x)}, solve records, setup records)."""
    runs = {}
    for world, ny in DIST_MP:
        x_out = f"{tmp}/x_{world}_{ny}.npy"
        recs = mp_worker.launch(world, "dist", ny, dev, DIST_STEPS, x_out,
                                timeout=400)
        runs[(world, ny)] = (recs, np.load(x_out))
    return (runs,
            mp_worker.launch(MP_WORLD, "solve", device=dev, timeout=200),
            mp_worker.launch(MP_WORLD, "setup", device=dev, timeout=200))


def mp_launches(records):
    """The kernel launches of every process of every run, summed (each
    process counts its own from 0)."""
    return {k: sum(r["launches"].get(k, 0) for r in records)
            for k in graph_loop.snapshot()}


def check_dist_mp(out, ref, solve_tables, smi):
    """The processes' dist runs against the one-process lane (ref: ny ->
    (level_ndofs, table digest, x, gap)), on the backend backend_for
    picks for this host; the solve case against its bound and its tables
    against solve_tables (the digest of mp_worker.solve_problem's
    hierarchy in this process), the setup case against its bounds.  A
    process's failure or timeout already raised in mp_worker.launch."""
    runs, solve, setup = out
    fails = []
    for (world, ny), (recs, x) in runs.items():
        ndofs, digest, x1, gap = ref[ny]
        dx = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
        for r in recs:
            comm = ", ".join(f"{k} {v['calls']} in {v['s']:.4f} s"
                             for k, v in r["comm"].items())
            print(f"  dist_mp {world} processes ny_per_rank={ny} process "
                  f"{r['rank']} ({smi}): backend {r['backend']} staged "
                  f"{r['staged']} setup_s {r['setup_s']:.2f} step_s "
                  f"{r['step_s']:.6f} value {r['value']:.4e} {r['unit']} "
                  f"collectives {r['comm_s_per_step'] * 1e3:.3f} ms a "
                  f"step, share {r['comm_share']:.3f} ({comm}), device busy "
                  f"{r['device_busy_s_per_step'] * 1e3:.4f} ms a step (idle "
                  f"{r['idle_share']:.3f}; top ms "
                  + ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                              r["device_top_ms_per_step"].items())
                  + f"; hand-kernel launches traced "
                  f"{r['traced_launches']} of {r['launches_profiled']}), "
                  f"rel_res {r['rel_res']:.3e}, timed kernels "
                  f"{r['kernels']}")
            backend = backend_for(r["device"], torch.cuda.device_count(),
                                  world)
            if (r["world"], r["backend"], r["imports_jax"]) != (
                    world, backend, []):
                fails.append(f"{world}/{ny}: {r['world']} "
                             f"{r['backend']} {r['imports_jax']}")
            if r["level_ndofs"] != ndofs or r["digest"] != digest:
                fails.append(f"{world}/{ny} process {r['rank']}: levels "
                             f"{r['level_ndofs']} (one process {ndofs}) "
                             f"or the tables differ")
            if r["kernels"]["ell_spmv"] <= 0:
                fails.append(f"{world}/{ny} process {r['rank']}: no "
                             "ell_spmv in the timed steps")
        same = all(r["digest"] == digest for r in recs)
        print(f"  dist_mp {world} processes ny_per_rank={ny}: tables equal "
              f"the one-process lane's: {same}; x vs the one-process card "
              f"run |dx|/|x| {dx:.3e} (limit 2 x {gap:.3e})")
        if not dx <= 2 * gap:
            fails.append(f"{world}/{ny}: x {dx} > 2 x {gap}")
    for r in solve:
        print(f"  mp solve process {r['rank']}: err {r['err']:.3e} (limit "
              f"{MP_SOLVE_LIMIT:g}) digest {r['digest']:.12e} solve_s "
              f"{r['solve_s']:.3f} ell_spmv {r['launches']['ell_spmv']}")
        if not r["err"] < MP_SOLVE_LIMIT or r["launches"]["ell_spmv"] <= 0:
            fails.append(f"solve process {r['rank']}: err {r['err']}")
        if r["tables"] != solve_tables:
            fails.append(f"solve process {r['rank']}: its tables differ "
                         "from solve_problem's here")
    if len({r["digest"] for r in solve}) != 1:
        fails.append("solve: the processes' digests differ")
    for r in setup:
        print(f"  mp setup process {r['rank']}: ndofs {r['ndofs']} (one "
              f"process {r['ref_ndofs']}) A_err {r['A_err']} P_err "
              f"{r['P_err']}")
        if not (r["ndofs"] == r["ref_ndofs"] and all(r["P_pattern"])
                and max(r["A_err"]) < MP_A_LIMIT
                and max(r["P_err"]) < MP_P_LIMIT):
            fails.append(f"setup process {r['rank']}")
    if fails:
        raise SystemExit("FAIL dist_mp path: " + "; ".join(fails))


def checkpoint_path(dev, h1_levels, gen, gen_iters, tmp):
    """The flagship hierarchy (flagship.build_solver on the h1 path's
    levels) saved and loaded onto the card, solved against the original;
    the generic chain's transfers saved, loaded and solved.  Fails on
    any check (see the module docstring, o)."""
    from torch import nn
    fails = []
    A_levels, P_levels, b = h1_levels
    H, Hb = flagship.build_solver(A_levels, P_levels, dev)
    bt = torch.as_tensor(b.astype(np.float32)).to(dev)
    path = f"{tmp}/flagship.pt"
    t0 = time.perf_counter()
    checkpoint.save_pytree(nn.ModuleList([H, Hb]), path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    H2, Hb2 = checkpoint.load_pytree(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x0, (it0, _) = flagship.solve(H, Hb, bt)
    before = dict(hk.LAUNCHES)
    x1, (it1, _) = flagship.solve(H2, Hb2, bt)
    resumed = {k: hk.LAUNCHES[k] - before[k] for k in ONE_RHS}
    dx = float((x1 - x0).abs().max() / x0.abs().max())
    fresh_s, resumed_s = (_ms(lambda h=h: flagship.solve(*h, bt), 1, 3) / 1e3
                          for h in ((H, Hb), (H2, Hb2)))
    print(f"  flagship {NX}^3: file {os.path.getsize(path)} bytes, save_s "
          f"{save_s:.3f} load_s {load_s:.3f}; iters fresh {int(it0)} "
          f"resumed {int(it1)}, max |dx|/max |x| {dx:.3e} (limit "
          f"{CKPT_X_LIMIT:g}), solve_s fresh {fresh_s:.5f} resumed "
          f"{resumed_s:.5f}, the resumed solve's launches {resumed}")
    if int(it1) != int(it0) or not dx <= CKPT_X_LIMIT:
        fails.append(f"flagship: iters {int(it1)} vs {int(it0)}, dx {dx}")
    if min(resumed.values()) <= 0:
        fails.append(f"flagship: a kernel did not run resumed {resumed}")
    A_gen, _, b_gen, _, seqs = gen
    path = f"{tmp}/transfers.npz"
    t0 = time.perf_counter()
    checkpoint.save_transfers(seqs, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.load_transfers(path)
    load_s = time.perf_counter() - t0
    Ps = [lev["P"][0] for lev in back[:-1]]
    t0 = time.perf_counter()
    levels = [A_gen[0]]
    for P in Ps:
        levels.append(rap(levels[-1], P))
    Hg = build_hierarchy(levels, Ps, lambda A, l: make_l1_jacobi(
        sp.csr_matrix(A).astype(np.float32), sweeps=generic_lane.SWEEPS,
        device=dev), dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    before = dict(hk.LAUNCHES)
    x, (it, _) = amge_pcg_solve(Hg, Hg.levels[0].A, b_gen.astype(
        np.float32), rtol=generic_lane.RTOL, atol=0.0,
        maxiter=generic_lane.MAXITER, device=dev)
    launched = {k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES}
    rel = float(np.linalg.norm(b_gen - A_gen[0].astype(np.float64) @ x)
                / np.linalg.norm(b_gen))
    print(f"  generic {NX_GENERIC}^3 transfers: file {os.path.getsize(path)}"
          f" bytes, save_s {save_s:.3f} load_s {load_s:.3f}, hierarchy "
          f"build_s {build_s:.3f}; iters {int(it)} (the generic lane "
          f"{gen_iters}) rel_res {rel:.3e}, launches {launched}")
    if abs(int(it) - gen_iters) > 1:
        fails.append(f"generic: iters {int(it)} vs {gen_iters}")
    if launched["bcsr_spmv"] + launched["ell_spmv"] <= 0:
        fails.append("generic: no kernel launched")
    if fails:
        raise SystemExit("FAIL checkpoint path: " + "; ".join(fails))


def check_entry(dev):
    """entry.entry() on the card against the same call on the CPU."""
    fn, args = entry.entry()
    y = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(y.shape))
    fc, ac = entry.entry(device="cpu")
    yc = fc(*ac).double().numpy()
    rel = _rel(y.double().cpu().numpy(), yc)
    print(f"  entry card vs CPU: max rel diff {rel:.3e} (limit 1e-5)")
    if tuple(y.shape) != (125,) or not rel <= 1e-5:
        raise SystemExit("FAIL entry: card and CPU disagree")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    t_start = time.perf_counter()
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
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
    # the host library's g++ build runs beside the kernels' nvcc builds
    host_lib = threading.Thread(target=native.available)
    host_lib.start()
    hk.load()
    host_lib.join()
    print(f"kernel build {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.2f} s, built="
          f"{build.BUILD_INFO['built']}) -> {build.BUILD_INFO['path']}")
    print(f"native: loaded={native.available()} "
          f"({native._LIB._name if native.available() else 'not loaded'})")
    if not native.available():
        raise SystemExit("FAIL native: the host library did not load")

    phase_s = {}

    def phase(name, t0):
        phase_s[name] = time.perf_counter() - t0
        print(f"  phase {name}: {phase_s[name]:.1f} s")

    # ---- main paths ----------------------------------------------------
    t0 = time.perf_counter()
    print(f"main path autotune (flagship.lane_autotune({NX_AUTOTUNE})):")
    at, l_at = _path("autotune",
                     lambda: flagship.lane_autotune(NX_AUTOTUNE, dev))
    print("  record: " + json.dumps(at))
    at_ref = flagship.lane_autotune(NX_AUTOTUNE, "cpu", repeats=1)
    check_autotune(at, at_ref, l_at)
    cycle_cfg = at.get("best_structured_cfg") or at.get("best_cfg")
    print(f"  winner: best_structured_cfg {at.get('best_structured_cfg')} "
          f"best_cfg {at.get('best_cfg')} ({at.get('best_granularity')})")
    phase("autotune", t0)

    t0 = time.perf_counter()
    print("main path h1 (flagship.lane_h1, 1 and 16 RHS):")
    (rec, h1_levels), l_h1 = _path(
        "h1", lambda: flagship.lane_h1(NX, dev, n_rhs=N_RHS))
    A_levels, P_levels, h1_b = h1_levels
    mr = rec["multirhs"]
    print("  record: " + json.dumps(rec))
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
    print(f"  block PCG s={mr['n_rhs']}: iters={mr['iters']} "
          f"rel_res_max={mr['rel_res_max']:.3e} solve_s={mr['solve_s']:.5f}"
          f" value={mr['value']:.4e} col0 vs 1-RHS "
          f"{mr['col0_rel_diff']:.3e} ({mr['col0_iters']} iters)")
    check_h1(rec, l_h1)
    loop_solves = [(f"h1 {NX}^3 1 RHS", rec, l_h1),
                   (f"h1 {NX}^3 {N_RHS} RHS", mr, l_h1)]
    phase("h1", t0)

    t0 = time.perf_counter()
    print(f"main path h1_autotuned (flagship.lane_h1 on the autotune's "
          f"winner, the same levels): cycle_cfg {json.dumps(cycle_cfg)}")
    trec, l_h1t = _path("h1_autotuned", lambda: flagship.lane_h1(
        NX, dev, cycle_cfg=cycle_cfg, levels=h1_levels)[0])
    print("  record: " + json.dumps(trec))
    print(f"  cycle_cfg {json.dumps(trec['cycle_cfg'])}: iters "
          f"{trec['iters']} (host anchor, sweeps {trec['sweeps']}: "
          f"{trec['host_iters']}) rel_res {trec['rel_res']:.3e} solve_s "
          f"{trec['solve_s']:.5f} (V(2,2) above: {rec['solve_s']:.5f}) "
          f"dof_iter_per_s {trec['dof_iter_per_s']:.4e}")
    check_h1_tuned(trec, l_h1t)
    loop_solves.append((f"h1 {NX}^3 1 RHS, autotuned cycle", trec, l_h1t))
    del h1_levels
    phase("h1_autotuned", t0)

    t0 = time.perf_counter()
    print(f"main path maxwell (maxwell_lane.lane_maxwell({NX_MAXWELL})):")
    (mrec, (MA, MP, MD0, _)), l_mx = _path(
        "maxwell", lambda: maxwell_lane.lane_maxwell(NX_MAXWELL, dev))
    print("  record: " + json.dumps(mrec))
    check_maxwell(mrec, l_mx)
    loop_solves.append((f"maxwell {NX_MAXWELL}^3", mrec, l_mx))
    phase("maxwell", t0)

    t0 = time.perf_counter()
    print(f"main path generic (generic_lane.lane_generic({NX_GENERIC}), "
          "pass 2 on the card):")
    (grec, gen), l_gen = _path(
        "generic", lambda: generic_lane.lane_generic(NX_GENERIC,
                                                     ("device",), dev))
    H_gen = gen[3]
    print("  record: " + json.dumps(grec))
    print(f"  ndofs={grec['ndofs']} levels={grec['levels']} "
          f"formats={grec['formats']} transfers={grec['transfers']}")
    for l, d in enumerate(grec["dims"]):
        print(f"  level {l} dims (forms 0-3): {d}")
    print(f"  setup: topology_s={grec['topology_s']:.3f} fe_s="
          f"{grec['device_fe_s']:.3f} coarsen_s="
          f"{[round(t, 3) for t in grec['device_coarsen_s']]} ext pass2 "
          f"solve {grec['device_timers']['coarsen: ext pass2 solve']:.3f} s"
          f" hierarchy_s={grec['hierarchy_s']:.3f}")
    print(f"  iters={grec['iters']} (host anchor {grec['host_iters']}) "
          f"rel_res={grec['rel_res']:.3e} (rtol {grec['rtol']:g}) "
          f"solve_s={grec['solve_s']:.5f} "
          f"dof_iter_per_s={grec['dof_iter_per_s']:.4e} "
          f"kernels={grec['kernels']}")
    check_generic(grec, l_gen)
    loop_solves.append((f"generic {NX_GENERIC}^3", grec, l_gen))
    phase("generic", t0)

    t0 = time.perf_counter()
    print(f"main path checkpoint (utils/checkpoint: the {NX}^3 flagship "
          f"hierarchy and the {NX_GENERIC}^3 generic chain's transfers, "
          "resumed on the card):")
    with tempfile.TemporaryDirectory() as tmp:
        _, l_ck = _path("checkpoint", lambda: checkpoint_path(
            dev, (A_levels, P_levels, h1_b), gen, grec["iters"], tmp))
    del gen, h1_b
    phase("checkpoint", t0)

    t0 = time.perf_counter()
    print(f"main path darcy_hyb (darcy_lane.lane_darcy_hybridized("
          f"{NX_DARCY})):")
    (drec, (dhyb, Hs, gf, _, darcy_Hd, darcy_H)), l_dh = _path(
        "darcy_hyb", lambda: darcy_lane.lane_darcy_hybridized(NX_DARCY,
                                                              dev))
    print("  record: " + json.dumps(drec))
    print(f"  n_mult={drec['n_mult']} npad={drec['npad']} "
          f"format={drec['format']} ({drec['dia_offsets']} DIA offsets) "
          f"SA levels {drec['sa_level_sizes']} {drec['sa_formats']} "
          f"transfers {drec['sa_transfers']}")
    print(f"  setup_s={drec['setup_s']:.3f} amg_setup_s="
          f"{drec['amg_setup_s']:.3f} iters={drec['iters']} passes="
          f"{drec['passes']} rel_res={drec['rel_res']:.3e} solve_s="
          f"{drec['solve_s']:.5f} value={drec['value']:.4e} "
          f"kernels={drec['kernels']}")
    check_darcy(drec, l_dh, darcy_anchor(dhyb, Hs, gf))
    del dhyb, Hs, gf
    phase("darcy_hyb", t0)

    t0 = time.perf_counter()
    print(f"main path spe10 (darcy_lane.lane_spe10({SPE10_CELLS})):")
    (srec, sout), l_sp = _path(
        "spe10", lambda: darcy_lane.lane_spe10(SPE10_CELLS, dev))
    print("  record: " + json.dumps(srec))
    t0 = time.perf_counter()
    sref, sout_ref = darcy_lane.lane_spe10(SPE10_CELLS, "cpu")
    print(f"  the same lane on the CPU: {time.perf_counter() - t0:.1f} s")
    check_spe10(srec, sout, sref, sout_ref, l_sp)
    spe10_H = [(H, Hd) for H, Hd in zip(sout["device_hierarchies"],
                                        sout["device_operators"])
               if H is not None]
    print(f"  SA transfers per level: "
          f"{[d['sa_transfers'] for d in srec['device_solves']]}")
    del sout, sout_ref
    phase("spe10", t0)

    t0 = time.perf_counter()
    print(f"main path darcy block (darcy_lane.lane_darcy_block("
          f"{BLOCK_NREF})):")
    (brec, (block_H, _)), l_bk = _path(
        "darcy_block", lambda: darcy_lane.lane_darcy_block(BLOCK_NREF, dev))
    print("  record: " + json.dumps(brec))
    check_block(brec, l_bk)
    phase("darcy_block", t0)

    t0 = time.perf_counter()
    print(f"main path library (library_lane.lane_library({LIB_NREF}), "
          "f64):")
    (librec, lib_solvers, _), l_lib = _path(
        "library", lambda: library_lane.lane_library(LIB_NREF, dev))
    print("  record: " + json.dumps(librec))
    print(f"  chain_s {librec['chain_s']:.2f} dims {librec['dims']} darcy "
          f"chain_s {librec['darcy_chain_s']:.2f}")
    _print_library(librec)
    lib_n16 = small_check_library(dev)
    check_library(librec, l_lib, lib_n16)
    lib_ops = library_lane.kernel_operators(lib_solvers)
    del lib_solvers
    phase("library", t0)

    t0 = time.perf_counter()
    print(f"main path spe10_structured (spectral_lane."
          f"lane_spe10_structured({SPS_CELLS}), f64):")
    field, coeff = spectral_lane.spe10_coeff(SPS_CELLS)
    fine = spectral_lane.fine_darcy(SPS_CELLS, coeff, field.sizes)
    print(f"  fine Darcy solve for u_l2_rel (host): "
          f"{time.perf_counter() - t0:.1f} s")
    (xrec, xout), l_sx = _path(
        "spe10_structured", lambda: spectral_lane.lane_spe10_structured(
            SPS_CELLS, device=dev, u_l2=True, fine=fine))
    print("  record: " + json.dumps(xrec))
    t1 = time.perf_counter()
    xref, xout_ref = spectral_lane.lane_spe10_structured(
        SPS_CELLS, device="cpu", u_l2=True, fine=fine)
    print(f"  the same lane on the CPU: setup_s {xref['setup_s']:.2f}, "
          f"{time.perf_counter() - t1:.1f} s in all")
    check_sps(xrec, xout, xref, xout_ref)
    del fine, xout, xout_ref
    phase("spe10_structured", t0)

    t0 = time.perf_counter()
    print(f"main path spe10_structured full grid (spectral_lane."
          f"lane_spe10_structured({SPS_FULL}), f64):")
    (frec, fout), l_sf = _path(
        "spe10_full", lambda: spectral_lane.lane_spe10_structured(
            SPS_FULL, device=dev))
    print("  record: " + json.dumps(frec))
    print(f"  setup_s {frec['setup_s']:.2f} (stages "
          + ", ".join(f"{k} {v:.2f}" for k, v in frec["stage_s"].items())
          + f"); the JAX host f64 anchor {frec['host_anchor_setup_s']:.1f} s"
          f" ({frec['host_anchor_kind']}, {frec['host_anchor_measured_utc']}"
          f", a host CPU time); peak card memory "
          f"{frec['peak_mem_bytes'] / 1e9:.2f} GB")
    check_sps_full(frec, fout)
    del fout
    phase("spe10_full", t0)

    t0 = time.perf_counter()
    print(f"main path spe10_ml (spectral_lane.lane_spe10_ml({ML_CELLS}), "
          "f64):")
    field, coeff = spectral_lane.spe10_coeff(ML_CELLS)
    fine = spectral_lane.fine_darcy(ML_CELLS, coeff, field.sizes)
    (lrec, _), l_ml = _path(
        "spe10_ml", lambda: spectral_lane.lane_spe10_ml(
            ML_CELLS, device=dev, fine=fine))
    print("  record: " + json.dumps(lrec))
    lref, _ = spectral_lane.lane_spe10_ml(ML_CELLS, device="cpu", fine=fine)
    check_ml(lrec, lref)
    del fine
    phase("spe10_ml", t0)

    t0 = time.perf_counter()
    print(f"main path ho (ho_lane.lane_ho({NX_HO}, p={HO_P}), pass 2 on the "
          "card):")
    (horec, (ho_seqs, ho_A, ho_b, ho_H, ho_Hb, ho_x)), l_ho = _path(
        "ho", lambda: ho_lane.lane_ho(NX_HO, HO_P, dev))
    print("  record: " + json.dumps(horec))
    print(f"  ndofs={horec['ndofs']} dims={horec['dims']} level_nnz="
          f"{horec['level_nnz']} formats={horec['formats']} transfers="
          f"{horec['transfers']}")
    print(f"  setup_s={horec['setup_s']:.2f} (topo {horec['topo_s']:.2f}, "
          f"fe {horec['fe_s']:.2f}, coarsen {horec['coarsen_s']:.2f} with "
          f"pass 2 {horec['coarsen_timers']['coarsen: ext pass2 solve']:.2f}"
          f", hierarchy {horec['hierarchy_s']:.2f}) iters={horec['iters']} "
          f"(host anchor {horec['host_iters']}) rel_res="
          f"{horec['rel_res']:.3e} solve_s={horec['solve_s']:.5f} "
          f"value={horec['value']:.4e} kernels={horec['kernels']}")
    check_ho(horec, l_ho, ho_Hb)
    small_check_ho(dev)
    loop_solves.append((f"ho_p{HO_P} {NX_HO}^3", horec, l_ho))
    phase("ho", t0)

    t0 = time.perf_counter()
    print("device_loop (each timed PCG solve above as one CUDA graph, the "
          "loop test on the card, beside its Python loop):")
    check_device_loop(loop_solves)
    phase("device_loop", t0)

    t0 = time.perf_counter()
    print("main path rcm (ho_lane.build_solver(..., reorder='rcm') on the "
          "ho matrices):")

    def rcm_solve():
        Hr, Hbr, _, _ = ho_lane.build_solver(ho_seqs, ho_A, dev,
                                             reorder="rcm")
        bt = torch.as_tensor(ho_b.astype(np.float32)).to(dev)
        xr, (it, _) = ho_lane.solve(Hr, Hbr, bt)
        return Hr, xr, int(it)

    (Hr, xr, it_r), l_rcm = _path("rcm", rcm_solve)
    tiles = [(l.A.nbr, l.A.kb) for l in Hr.levels if hasattr(l.A, "kb")]
    print(f"  formats {[type(l.A).__name__ for l in Hr.levels]} (BCSR tile "
          f"counts nbr, kb {tiles}); unpermuted {horec['formats']}")
    check_rcm(it_r, horec["iters"],
              float((xr - ho_x).norm() / ho_x.norm()),
              ho_lane.rel_res(ho_A, ho_b, xr))
    if l_rcm["ell_spmv"] + l_rcm["bcsr_spmv"] <= 0:
        raise SystemExit("FAIL rcm: no kernel launched")
    del Hr, xr, ho_seqs, ho_b, ho_x
    phase("rcm", t0)

    t0 = time.perf_counter()
    print(f"main path structured_a4 (fine_level({A4_SHAPE}, coeff=...), "
          f"coarsen_chain, materialize_P, coarsen_darcy {A4_DARCY_SHAPE}):")
    _, l_a4 = _path("structured_a4", lambda: structured_a4(dev))
    phase("structured_a4", t0)

    t0 = time.perf_counter()
    print(f"main path dist (parallel.dist_bench.distributed_solve_bench("
          f"{DIST_RANKS}, ny_per_rank in {DIST_NY}), the ranks as a batch "
          "axis on the card):")
    dist_runs, l_dist = _path("dist", lambda: dist_path(dev))
    for rec, _ in dist_runs:
        print("  record: " + json.dumps(rec))
    gaps = check_dist(dist_runs, l_dist, smi)
    solve_hier = mp_worker.solve_problem()[0]
    dist_ops = dist_operators(dist_runs, solve_hier, dev)
    dist_ref = {rec["ny_per_rank"]: (rec["level_ndofs"],
                                     dist_bench.table_digest(hier), x,
                                     gaps[rec["ny_per_rank"]])
                for rec, (hier, _, x) in dist_runs}
    del dist_runs
    phase("dist", t0)

    t0 = time.perf_counter()
    print(f"main path dist_mp (parallel.mp_worker.launch: the dist lane in "
          f"(processes, ny_per_rank) {DIST_MP}, then the solve and setup "
          "cases in 2 processes, all on the card):")
    with tempfile.TemporaryDirectory() as tmp:
        dist_mp, _ = _path("dist_mp", lambda: dist_mp_path(dev, tmp))
    l_dmp = mp_launches([r for recs, _ in dist_mp[0].values() for r in recs]
                        + dist_mp[1] + dist_mp[2])
    print(f"  launches in the processes of the dist_mp path: {l_dmp}")
    check_dist_mp(dist_mp, dist_ref, dist_bench.table_digest(solve_hier), smi)
    del dist_mp, dist_ref, solve_hier
    phase("dist_mp", t0)

    t0 = time.perf_counter()
    small_check(dev)
    small_check_maxwell(dev)
    small_check_generic(dev)
    check_entry(dev)
    small_check_darcy(dev)
    phase("small checks", t0)

    # ---- kernel phase ------------------------------------------------
    t0 = time.perf_counter()
    print("kernel phase (kernel vs plain on the card):")
    rows = kernel_phase(A_levels, P_levels[0], (MA, MP, MD0), H_gen,
                        (darcy_Hd, darcy_H, block_H), spe10_H, lib_ops,
                        (ho_H, ho_Hb, ho_A), dist_ops, dev)
    if l_sp["dia_spmv"] and not any(r["variant"].startswith("spe10")
                                    for r in rows["dia_spmv"]):
        raise SystemExit("FAIL kernels: the SPE10 path launched dia_spmv "
                         "on no operator held against its plain version")
    phase("kernels", t0)
    kernels = []
    for name, (src, replaces, path) in SOURCES.items():
        r = rows[name]
        head = r[PRIMARY.get(name, 0)]
        by_path = {"autotune": l_at[name], "h1": l_h1[name],
                   "h1_autotuned": l_h1t[name],
                   "maxwell": l_mx[name], "generic": l_gen[name],
                   "darcy_hyb": l_dh[name], "spe10": l_sp[name],
                   "darcy_block": l_bk[name], "library": l_lib[name],
                   "spe10_structured": l_sx[name],
                   "spe10_full": l_sf[name], "spe10_ml": l_ml[name],
                   "ho": l_ho[name], "rcm": l_rcm[name],
                   "structured_a4": l_a4[name], "dist": l_dist[name],
                   "dist_mp": l_dmp[name], "checkpoint": l_ck[name]}
        kernels.append(dict(
            name=name, path=path, route="cuda", source=src,
            replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            generic_variants=[v["variant"] for v in r
                              if v["variant"].startswith("generic")],
            darcy_variants=[v["variant"] for v in r
                            if v["variant"].startswith("darcy")],
            spe10_variants=[v["variant"] for v in r
                            if v["variant"].startswith("spe10")],
            library_variants=[v["variant"] for v in r
                              if v["variant"].startswith("library")],
            ho_variants=[v["variant"] for v in r
                         if v["variant"].startswith("ho")],
            dist_variants=[v["variant"] for v in r
                           if v["variant"].startswith("dist")],
            max_abs_err=max(v["max_abs_err"] for v in r),
            max_rel_err=max(v["max_rel_err"] for v in r),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            format_bytes=head["format_bytes"],
            library_ms=head["library_ms"], variants=r))
    print(f"phase seconds {json.dumps(phase_s)}")
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
