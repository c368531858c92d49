"""The generic AMGe engine on the card: the H1 problem of the JAX bench's
generic branch (bench.py::_build_h1) with the setup split of its setup
lane (bench.py::lane_setup, generic backends), then the AMGe solve.

    python -m parelag_tpu_torch.generic_lane --nx 64
    python -m parelag_tpu_torch.generic_lane --nx 64 --backends host,device

Mesh -> agglomerated topology chain (2x2x2 cartesian agglomerates while
every axis keeps >= 4 cells and the coarse grid >= min_coarse cells,
lane_setup's rule) -> fine DeRhamSequenceFE in f64 -> coarsen() down the
chain for all four forms, every level's pass-2 local solves on the
backend ('device': one batched f64 LU per shape group on the card,
ops/batched._device_solve; 'host': the native/LAPACK stack).  Then the
H1 operator M0 + D0^T M1 D0 with load -1 on attribute 1 and Dirichlet on
attributes 2-5, build_amge_hierarchy in f32 (l1-Jacobi V(2,2), 'auto'
format: BCSR on the card), and f32 PCG with the flagship's stop rule,
checked in host f64 against the host scipy V-cycle PCG anchor
(flagship.host_vcycle_pcg) on the same matrices.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from parelag_tpu_torch import flagship, resolve_device
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.models.upscaling import (
    boundary_rhs, eliminate_rowcols, mark_dofs_on_bndr)
from parelag_tpu_torch.ops import hopper_kernels
from parelag_tpu_torch.partitioning.partitioners import cartesian_partition
from parelag_tpu_torch.solvers.amge_solver import (
    build_amge_hierarchy, compile_amge_pcg)
from parelag_tpu_torch.solvers.cg import pcg
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.utils.timing import TimeManager

#: lane_setup's grid (bench.py:1461) and its coarsening floor (cells)
NX, MIN_COARSE = 64, 256
#: the flagship's cycle, stop rule and cap
SWEEPS, RTOL, MAXITER = flagship.CYCLE["sweeps"], flagship.RTOL, \
    flagship.MAXITER
#: timed solves (the median is reported)
REPEATS = 3


def n_levels(nx, min_coarse=MIN_COARSE, factors=(2, 2, 2)):
    """Levels of the chain on an nx^3 grid (bench.py::_build_h1's loop):
    coarsen by `factors` while every axis divides and keeps >= 2 * f
    cells and the coarse grid >= min_coarse cells."""
    nlev, shape = 1, (nx,) * 3
    while (all(s % f == 0 and s >= 2 * f for s, f in zip(shape, factors))
           and np.prod([s // f for s, f in zip(shape, factors)])
           >= min_coarse):
        nlev, shape = nlev + 1, tuple(s // f for s, f in zip(shape,
                                                             factors))
    return nlev


def build_topologies(nx, min_coarse=MIN_COARSE, factors=(2, 2, 2)):
    """(mesh, [fine topology, coarser ...]) of the nx^3 hex grid of
    [0,1]^3, `factors` cartesian agglomerates a level,
    n_levels(nx, min_coarse, factors) topologies."""
    mesh = hex_grid_mesh(nx, nx, nx)
    topos = [AgglomeratedTopology.from_mesh(mesh)]
    shape = (nx,) * 3
    for _ in range(n_levels(nx, min_coarse, factors) - 1):
        part = cartesian_partition(shape, tuple(factors))
        topos.append(topos[-1].coarsen_local_partitioning(part))
        shape = tuple(s // f for s, f in zip(shape, factors))
    return mesh, topos


def build_h1(nx, backend, device=None, min_coarse=MIN_COARSE,
             topology=None):
    """The generic engine's H1 chain in f64 with pass 2 on `backend`
    ('host' or 'device', the latter on `device`, None: the card) at every
    level.  topology=(mesh, topos) from build_topologies reuses a chain.
    Returns (seqs, A, b, split): split holds fe_s (fine level + targets),
    coarsen_s (seconds per coarsen() call) and timers (the setup's stage
    timers, utils/timing.TimeManager, cleared first)."""
    device = resolve_device(device)
    mesh, topos = topology or build_topologies(nx, min_coarse)
    TimeManager.clear()
    t0 = time.perf_counter()
    seq = DeRhamSequenceFE(topos[0], mesh)
    seq.jform_start = 0
    seq.set_upscaling_targets(0)
    fe_s = time.perf_counter() - t0
    seqs, coarsen_s = [seq], []
    for _ in topos[1:]:
        # every level on the backend (lane_setup sets it on the finest
        # sequence only: coarse sequences start at 'auto', the host)
        seqs[-1].solve_backend = backend
        seqs[-1].solve_device = device
        t0 = time.perf_counter()
        seqs.append(seqs[-1].coarsen())
        coarsen_s.append(time.perf_counter() - t0)
    split = dict(fe_s=fe_s, coarsen_s=coarsen_s,
                 timers=TimeManager.elapsed())

    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    D = seq.D[0]
    A = (M + D.T @ W @ D).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return seqs, A, b, split


def coarse_dims(seqs):
    """[[ndofs of form 0..3] per level]."""
    return [[int(s.dof[j].ndofs) for j in range(s.nforms)] for s in seqs]


def first_dim_mismatch(seqs_a, seqs_b):
    """The first coarse-dimension mismatch of two chains, level by level
    and form by form: (level, form, (codim, entity)) with the first
    coarse entity whose dof count differs, or None when all agree."""
    for l in range(1, min(len(seqs_a), len(seqs_b))):
        for j in range(seqs_a[l].nforms):
            da, db = seqs_a[l].dof[j], seqs_b[l].dof[j]
            if da.ndofs == db.ndofs:
                continue
            for c in sorted(da.n_ranget):
                bad = np.flatnonzero(da.n_ranget[c] + da.n_null[c]
                                     != db.n_ranget[c] + db.n_null[c])
                if bad.size:
                    return (l, j, (c, int(bad[0])))
            return (l, j, None)
    return None


def lane_generic(nx=NX, backends=("device",), device=None,
                 min_coarse=MIN_COARSE):
    """The generic record: the topology chain, then per backend the
    setup split ({backend}_fe_s, _coarsen_s, _setup_s, _dof_per_s,
    _timers, _dims), then on the last backend's chain the f32 hierarchy
    and PCG compiled once (compile_amge_pcg: on the card one CUDA graph):
    one warm solve checked in host f64 (rel_res), REPEATS timed solves
    beside the Python loop's (flagship.loop_record; CUDA events on the
    card, the host clock on the CPU; the median is solve_s), `kernels` =
    the hand-kernel launches of the timed solves, and the host f64
    anchor on the same matrices.  Returns
    (record, (A_levels, P_levels, b, H, seqs)), H the f32 hierarchy the
    solve ran, seqs its DeRhamSequence chain; device None: the card."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        hopper_kernels.load()        # build the kernels outside setup
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    topology = build_topologies(nx, min_coarse)
    out = dict(metric="h1_amge_generic", cells=nx ** 3,
               levels=len(topology[1]),
               topology_s=time.perf_counter() - t0)
    for backend in backends:
        seqs, A, b, split = build_h1(nx, backend, device, min_coarse,
                                     topology)
        setup_s = split["fe_s"] + sum(split["coarsen_s"])
        out.update({f"{backend}_fe_s": split["fe_s"],
                    f"{backend}_coarsen_s": split["coarsen_s"],
                    f"{backend}_setup_s": setup_s,
                    f"{backend}_dof_per_s": A.shape[0] / setup_s,
                    f"{backend}_timers": split["timers"],
                    f"{backend}_dims": coarse_dims(seqs)})
    out["dims"] = coarse_dims(seqs)
    out["dims_agree"] = all(out[f"{k}_dims"] == out["dims"]
                            for k in backends)
    ndofs = A.shape[0]

    t0 = time.perf_counter()
    H, A_levels, P_levels = build_amge_hierarchy(
        seqs, 0, A.astype(np.float32), smoother="l1jacobi", sweeps=SWEEPS,
        dtype=np.float32, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    out["hierarchy_s"] = time.perf_counter() - t0

    bt = torch.as_tensor(b.astype(np.float32)).to(device)
    A0 = H.levels[0].A
    solve = compile_amge_pcg(H, A0, bt, rtol=RTOL, atol=0.0,
                             maxiter=MAXITER)
    x, (it, _) = solve(bt)
    niter = int(it)
    b64 = np.asarray(b, dtype=np.float64)
    rel = float(np.linalg.norm(b64 - A @ x.astype(np.float64))
                / np.linalg.norm(b64))

    def python_solve(v):
        return pcg(A0.matvec, v, precond=H.apply, rtol=RTOL, atol=0.0,
                   maxiter=MAXITER)

    loop = flagship.loop_record(python_solve, solve.compiled, bt)
    solve_s = loop["solve_s"]

    Ah = [a.astype(np.float64) for a in A_levels]
    Ph = [p.astype(np.float64) for p in P_levels]
    prepared = flagship.host_vcycle_prepare(Ah)
    t0 = time.perf_counter()
    _, ith = flagship.host_vcycle_pcg(Ah, Ph, b64, rtol=RTOL,
                                      maxiter=MAXITER, sweeps=SWEEPS,
                                      prepared=prepared)
    host_dt = time.perf_counter() - t0

    out.update(
        ndofs=ndofs, level_shapes=[int(a.shape[0]) for a in A_levels],
        formats=[type(l.A).__name__ for l in H.levels],
        transfers=[type(l.P).__name__ for l in H.levels
                   if l.P is not None],
        iters=niter, converged=niter < MAXITER, rtol=RTOL, rel_res=rel,
        **loop, dof_iter_per_s=ndofs * niter / solve_s,
        timer="cuda_events" if on_card else "host_clock",
        host_iters=ith, host_solve_s=host_dt,
        host_dof_iter_per_s=ndofs * ith / host_dt)
    out["vs_baseline"] = out["dof_iter_per_s"] / out["host_dof_iter_per_s"]
    return out, (A_levels, P_levels, b, H, seqs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--backends", default="device",
                    help="comma-separated pass-2 backends (host, device); "
                    "the solve runs on the last one's chain")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec, _ = lane_generic(args.nx, tuple(args.backends.split(",")), device)
    lines = [json.dumps(dict(card=smi, torch=torch.__version__,
                             cuda=torch.version.cuda)), json.dumps(rec)]
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
