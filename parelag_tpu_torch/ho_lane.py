"""The high-order lane on the card: the port's counterpart of
bench.py::lane_ho (the ho_p2 record).

    python -m parelag_tpu_torch.ho_lane --nx 16 --p 2 [--device cpu]
                                        [--out F]

An nx^3 hex grid of [0,1]^3 -> agglomerated topology with one 2x2x2
cartesian coarsening -> the order-p de Rham sequence
(amge/fespace3d_ho.DeRhamSequence3DFE_HO: Q_{p+1} -> ND_p -> RT_p ->
Q_p) with order-0 upscaling targets -> one coarsen() with pass 2's
batched local solves on the device.  Then the H1 system A = M0 + D0^T M1
D0 with b = RandomState(0).randn and every boundary dof eliminated,
build_amge_hierarchy in f32 (l1-Jacobi V(2,2), "dia" asked for A: the
high-order operator has far more than 48 diagonals, so A0 takes the
BCSR size rule and, where that fails, ELL; bf16 transfers), and f32 PCG
(rtol 1e-5, maxiter 200) preconditioned by the hierarchy cast to bf16.
The solve is checked in host f64 and held against the same V(2,2) PCG
in host f64 scipy on the same matrices (flagship.host_vcycle_pcg).
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from parelag_tpu_torch import flagship, resolve_device, synchronize
from parelag_tpu_torch.amge.fespace3d_ho import DeRhamSequence3DFE_HO
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.models.upscaling import (
    eliminate_rowcols, mark_dofs_on_bndr)
from parelag_tpu_torch.ops import hopper_kernels
from parelag_tpu_torch.partitioning.partitioners import cartesian_partition
from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
from parelag_tpu_torch.solvers.cg import compile_pcg, pcg
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.utils.timing import TimeManager

#: bench.py's full-run size and order (bench.py:1464)
NX, P = 16, 2
#: bench.py::lane_ho's cycle, stop rule and cap
SWEEPS, RTOL, MAXITER = 2, 1e-5, 200
#: timed solves (the median is reported)
REPEATS = 3


def build_ho(nx, p, device=None):
    """The lane's setup on an nx^3 grid at order p, pass 2 of coarsen()
    on `device` (None: the card).  Returns (seqs, A, b, split): seqs =
    [fine, coarse] sequences, A and b the boundary-eliminated f64 H1
    system, split the seconds of topo_s, fe_s (fine space + targets) and
    coarsen_s, and timers (the coarsening's stage timers)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    mesh = hex_grid_mesh(nx, nx, nx)
    topo = AgglomeratedTopology.from_mesh(mesh)
    topo.coarsen_local_partitioning(
        cartesian_partition((nx, nx, nx), (2, 2, 2)))
    t1 = time.perf_counter()
    seq = DeRhamSequence3DFE_HO(topo, mesh, p)
    seq.set_upscaling_targets(0)
    t2 = time.perf_counter()
    seq.solve_backend = "device"
    seq.solve_device = device
    TimeManager.clear()
    seqs = [seq, seq.coarsen()]
    synchronize(device)
    t3 = time.perf_counter()
    split = dict(topo_s=t1 - t0, fe_s=t2 - t1, coarsen_s=t3 - t2,
                 timers=TimeManager.elapsed())

    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    D = seq.D[0]
    A = (M + D.T @ W @ D).tocsr()
    b = np.random.RandomState(0).randn(A.shape[0])
    marker = mark_dofs_on_bndr(seq, 0, {1, 2, 3, 4, 5, 6})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return seqs, A, b, split


def build_solver(seqs, A, device=None, reorder=None):
    """The lane's f32 hierarchy on `device` (None: the card) and its bf16
    cast, the preconditioner (its coarse inverse stays f32).  reorder:
    None or "rcm" (build_amge_hierarchy).  Returns (H, Hb, A_levels,
    P_levels)."""
    H, A_levels, P_levels = build_amge_hierarchy(
        seqs, 0, A.astype(np.float32), smoother="l1jacobi", sweeps=SWEEPS,
        dtype=np.float32, matrix_format="dia",
        transfer_dtype=torch.bfloat16, reorder=reorder,
        device=resolve_device(device))
    return H, H.cast(torch.bfloat16), A_levels, P_levels


def _precond(Hb):
    def precond(r):
        return Hb.apply(r.to(torch.bfloat16)).to(torch.float32)
    return precond


def solve(H, Hb, b):
    """f32 PCG on H's fine operator preconditioned by one bf16 V-cycle of
    Hb, the loop in Python; b an f32 tensor in the original numbering (a
    reordered H solves in its permuted space).  Returns (x, (iterations,
    r.z))."""
    if H.perm is not None:
        b = b[H.perm]
    x, info = pcg(H.levels[0].A.matvec, b, precond=_precond(Hb),
                  rtol=RTOL, atol=0.0, maxiter=MAXITER)
    if H.iperm is not None:
        x = x[H.iperm]
    return x, info


def compile_solve(H, Hb, b_like):
    """solve compiled for b_like's shape (solvers/cg.compile_pcg; on the
    card one CUDA graph with the loop on the device); a reordered H's
    permutations of b and x stay outside the graph.  Returns solve(b) ->
    (x, (iterations, r.z)) with the CompiledPcg as solve.compiled."""
    compiled = compile_pcg(H.levels[0].A.matvec, b_like,
                           precond=_precond(Hb), rtol=RTOL, atol=0.0,
                           maxiter=MAXITER)

    def run(b):
        if H.perm is not None:
            b = b[H.perm]
        x, info = compiled(b)
        if H.iperm is not None:
            x = x[H.iperm]
        return x, info

    run.compiled = compiled
    return run


def rel_res(A, b, x):
    """||b - A x|| / ||b|| in host f64."""
    b64 = np.asarray(b, dtype=np.float64)
    x64 = x.double().cpu().numpy()
    return float(np.linalg.norm(b64 - A @ x64) / np.linalg.norm(b64))


def lane_ho(nx=NX, p=P, device=None):
    """The ho_p{p} record: the setup split, the solve compiled once
    (compile_solve), one warm solve checked in host f64 (rel_res,
    rel_res_floor above RTOL as bench.py records it), REPEATS timed
    solves beside the Python loop's (flagship.loop_record: median
    solve_s, value = ndofs * iters / solve_s), formats / transfers /
    level_shapes per level, `kernels` (the hand-kernel launches of the
    timed solves) and the host f64 anchor on the same matrices.  Returns (record, (seqs, A, b, H, Hb,
    x)); device None: the card."""
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()        # build the kernels outside setup_s
        torch.cuda.synchronize(device)
    seqs, A, b, split = build_ho(nx, p, device)
    t0 = time.perf_counter()
    H, Hb, A_levels, P_levels = build_solver(seqs, A, device)
    synchronize(device)
    hierarchy_s = time.perf_counter() - t0
    setup_s = split["topo_s"] + split["fe_s"] + split["coarsen_s"] \
        + hierarchy_s
    ndofs = A.shape[0]

    bt = torch.as_tensor(b.astype(np.float32)).to(device)
    run = compile_solve(H, Hb, bt)
    x, (it, _) = run(bt)
    niter = int(it)
    rel = rel_res(A, b, x)
    loop = flagship.loop_record(lambda v: solve(H, Hb, v), run, bt)
    solve_s = loop["solve_s"]

    Ah = [a.astype(np.float64) for a in A_levels]
    Ph = [q.astype(np.float64) for q in P_levels]
    prepared = flagship.host_vcycle_prepare(Ah)
    t0 = time.perf_counter()
    _, host_iters = flagship.host_vcycle_pcg(
        Ah, Ph, np.asarray(b, dtype=np.float64), rtol=RTOL,
        maxiter=MAXITER, sweeps=SWEEPS, prepared=prepared)
    host_dt = time.perf_counter() - t0

    out = dict(metric=f"ho_p{p}_h1_amge_vcycle_pcg", nx=nx, p=p,
               ndofs=ndofs, device=str(device),
               dims=[[int(s.dof[j].ndofs) for j in range(s.nforms)]
                     for s in seqs],
               iters=niter, converged=niter < MAXITER, rtol=RTOL,
               rel_res=rel, setup_s=setup_s, topo_s=split["topo_s"],
               fe_s=split["fe_s"], coarsen_s=split["coarsen_s"],
               coarsen_timers=split["timers"], hierarchy_s=hierarchy_s,
               **loop, value=ndofs * niter / solve_s,
               unit="dof_iter_per_s",
               timer="cuda_events" if device.type == "cuda"
               else "host_clock",
               level_shapes=[int(a.shape[0]) for a in A_levels],
               level_nnz=[int(a.nnz) for a in A_levels],
               formats=[type(l.A).__name__ for l in H.levels],
               transfers=[type(l.P).__name__ for l in H.levels
                          if l.P is not None],
               host_iters=host_iters,
               host_solve_s=host_dt)
    if rel > RTOL:
        # the f32 solve's floor in true f64 terms, as bench.py records it
        out["rel_res_floor"] = rel
    return out, (seqs, A, b, H, Hb, x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--p", type=int, default=P)
    ap.add_argument("--device", default=None,
                    help="cpu runs the lane on the CPU (default: the card)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    head = dict(torch=torch.__version__, cuda=torch.version.cuda)
    if device.type == "cuda":
        head["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    rec, _ = lane_ho(args.nx, args.p, device)
    lines = [json.dumps(head), json.dumps(rec)]
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
