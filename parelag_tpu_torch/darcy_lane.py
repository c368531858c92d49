"""The hybridized mixed Darcy path on the card: the JAX bench's darcy_hyb
lane (bench.py::lane_darcy_hybridized), its generic SPE10 lane
(bench.py::lane_spe10) and the blocked Darcy AMGe GMRES
(solvers/block.py, the MultigridTestDarcy composition).

    python -m parelag_tpu_torch.darcy_lane --nx 64 --spe10 30,55,21
    python -m parelag_tpu_torch.darcy_lane --nx 32 --spe10 none --out F

darcy_hyb: the unit-source mixed Darcy problem on an nx^3 hex grid of
[0,1]^3 (natural pressure BC), hybridized by HybridHdivL2 (batched
per-element elimination on the host), the multiplier system rescaled
and solved by _device_solve: SA-AMG V-cycle with the facet block-Jacobi
fine smoother, f32 PCG on the card (at rtol 1e-8: inner rtol 1e-6, up to
4 f64 host refinement passes).  spe10: models.spe10.spe10_darcy on the
synthetic SPE10-like field (seed 0), 2 levels, coarsening factor 64,
spectral coarse spaces, the multiplier solve of every level on the card
("device") and by the host facet-block PCG ("cg") on the same
hierarchy.  block: build_darcy_amge_hierarchy (ELL levels) and
darcy_gmres_solve on build_darcy_hierarchy's chain, against a sparse
direct solve.

Each lane prints one JSON line with the JAX bench's fields (darcy_hyb:
n_mult, iters, rel_res in f64 on the host, setup_s, amg_setup_s,
sa_level_sizes, solve_s, value in dof_iter_per_s; spe10: ndofs,
u_l2_rel, device_solve_s, host_solve_s) and the port's own: `kernels`,
the hand-kernel launches of one timed solve (of the whole lane for
spe10), each level's format and the refinement passes.  Times on the
card are CUDA events around the solve, median of REPEATS; on the CPU
the host clock.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelag_tpu_torch import resolve_device, synchronize
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge.hybridization import HybridHdivL2
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.models.darcy import build_darcy_hierarchy
from parelag_tpu_torch.models.spe10 import spe10_darcy, synthetic_spe10_field
from parelag_tpu_torch.ops import hopper_kernels
from parelag_tpu_torch.solvers.block import (
    build_darcy_amge_hierarchy, darcy_gmres_solve)
from parelag_tpu_torch.topology.topology import AgglomeratedTopology

#: the card's darcy_hyb grid (262,144 cells, the generic lane's count),
#: the JAX bench's SPE10 cells, the multiplier rtol of both JAX lanes
NX, SPE10_CELLS, RTOL = 64, (30, 55, 21), 1e-8
#: build_darcy_hierarchy refinements of the block lane, its GMRES rtol
BLOCK_NREF, BLOCK_RTOL = 3, 1e-8
#: timed solves (the median is reported)
REPEATS = 3


def _timed(fn, device):
    """(result, seconds, launches) of one call: CUDA events on the card,
    the host clock on the CPU; launches = the hand kernels it ran."""
    before = dict(hopper_kernels.LAUNCHES)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
    return out, dt, {k: hopper_kernels.LAUNCHES[k] - before[k]
                     for k in hopper_kernels.LAUNCHES}


def build_darcy_hyb(nx):
    """The hybridized system of bench.py::lane_darcy_hybridized at nx^3:
    (hyb, Hs, gf), Hs the rescaled free multiplier system and gf its
    right-hand side (host f64)."""
    mesh = hex_grid_mesh(nx, nx, nx)
    topo = AgglomeratedTopology.from_mesh(mesh)
    seq = DeRhamSequenceFE(topo, mesh)
    seq.jform_start = 2
    hyb = HybridHdivL2(seq)
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    rhs_u = np.zeros(seq.dof[2].ndofs)
    g, _ = hyb.rhs_transform(rhs_u, vols)
    keep = ~hyb.ess_mult
    Hff = hyb.hybrid_system[keep][:, keep].tocsr()
    d = hyb.rescaling[keep]
    d = np.where(np.abs(d) > 0, d, 1.0)
    Hs = (sp.diags(d) @ Hff @ sp.diags(d)).tocsr()
    return hyb, Hs, d * g[keep]


def lane_darcy_hybridized(nx=NX, device=None):
    """The darcy_hyb record on `device` (None: the card): setup_s (mesh
    to hybridized system), amg_setup_s (_device_setup: pad, facet
    blocks, SA setup, device hierarchy), one warm solve checked in host
    f64 (rel_res), REPEATS timed solves.  Returns (record, (hyb, Hs,
    gf, x, Hd, Hier)): Hd the outer operator and Hier the SA-AMG
    hierarchy on `device` that the solves ran."""
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()        # build the kernels outside setup
    t0 = time.perf_counter()
    hyb, Hs, gf = build_darcy_hyb(nx)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, Hd, Hier, *_ = hyb._device_setup(Hs, device)
    synchronize(device)
    amg_setup_s = time.perf_counter() - t0

    def solve():
        return hyb._device_solve(Hs, gf, rtol=RTOL, device=device)

    x = solve()
    info = dict(hyb.last_device)
    times, kernels = [], None
    for _ in range(REPEATS):
        _, dt, kernels = _timed(solve, device)
        times.append(dt)
    solve_s = float(np.median(times))
    n = Hs.shape[0]
    return dict(
        metric="darcy_hybridized_multiplier_pcg", n_mult=n, cells=nx ** 3,
        iters=info["iters"], passes=info["passes"],
        rel_res=info["rel_res"], rtol=RTOL,
        setup_s=setup_s, amg_setup_s=amg_setup_s,
        sa_level_sizes=info["sa_level_sizes"], npad=info["npad"],
        dtype=info["dtype"], format=info["format"],
        dia_offsets=info["dia_offsets"], sa_formats=info["sa_formats"],
        sa_transfers=info["sa_transfers"], solve_s=solve_s,
        solve_s_all=times, value=n * info["iters"] / solve_s,
        unit="dof_iter_per_s", kernels=kernels,
        timer="cuda_events" if device.type == "cuda" else "host_clock",
        device=str(device)), (hyb, Hs, gf, x, Hd, Hier)


def lane_spe10(cells=SPE10_CELLS, device=None, spectral=True):
    """The SPE10 record (bench.py::lane_spe10) on `device` (None: the
    card): spe10_darcy with mult_solver=("device", "cg"), the device
    solve's solution reported; ndofs and multipliers per level, the
    device and host multiplier solve times (setup included, as the JAX
    lane times them), each level's device solve (iterations, passes,
    formats) and the hand-kernel launches of the whole lane.  Returns
    (record, spe10_darcy's output)."""
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()
    field = synthetic_spe10_field(cells, seed=0)
    before = dict(hopper_kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = spe10_darcy(field=field, cells=cells, n_levels=2,
                      coarsening_factor=64, spectral=spectral,
                      mult_solver=("device", "cg"), device=device)
    total_s = time.perf_counter() - t0
    kernels = {k: hopper_kernels.LAUNCHES[k] - before[k]
               for k in hopper_kernels.LAUNCHES}
    dsolve = float(sum(out["solve_s_by"]["device"]))
    hsolve = float(sum(out["solve_s_by"]["cg"]))
    return dict(
        metric="spe10_darcy_hybridized", cells=list(cells),
        ndofs=[int(v) for v in out["ndofs"]],
        n_mult=[int(v) for v in out["iters"]], u_l2_rel=out["u_l2_rel"],
        total_s=total_s, setup_s=total_s - dsolve - hsolve,
        device_solve_s=dsolve, host_solve_s=hsolve,
        device_solve_s_by_level=out["solve_s_by"]["device"],
        host_solve_s_by_level=out["solve_s_by"]["cg"],
        device_solves=out["device_solves"], value=out["ndofs"][0] / dsolve,
        unit="dof_per_s", winner="device" if dsolve <= hsolve else "host",
        kernels=kernels, timer="host_clock", device=str(device)), out


def lane_darcy_block(nref=BLOCK_NREF, device=None):
    """The blocked Darcy AMGe GMRES on `device` (None: the card):
    build_darcy_hierarchy(nref, derefine partition, no aggressive level),
    build_darcy_amge_hierarchy(sweeps=3, omega=0.6) in f64, and
    darcy_gmres_solve at BLOCK_RTOL against a sparse direct solve (the
    JAX package's tests/test_block_mg.py composition).  Returns (record,
    (H, A_levels))."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    mesh, _, seqs = build_darcy_hierarchy(
        nref_parallel=nref, partition="derefine", aggressive_levels=0)
    H, A_levels, n0s = build_darcy_amge_hierarchy(
        seqs, sweeps=3, omega=0.6, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    b = np.concatenate([np.zeros(n0s[0]), vols])
    (x, (cycles, res)), dt, kernels = _timed(
        lambda: darcy_gmres_solve(H, A_levels[0], b, rtol=BLOCK_RTOL),
        device)
    xref = spla.spsolve(A_levels[0].tocsc(), b)
    return dict(
        metric="darcy_block_amge_gmres", nref=nref, cells=mesh.num_elements,
        level_sizes=[int(a.shape[0]) for a in A_levels], cycles=cycles,
        res=res, rel_res=float(np.linalg.norm(b - A_levels[0] @ x)
                               / np.linalg.norm(b)),
        err_vs_direct=float(np.abs(x - xref).max()), setup_s=setup_s,
        solve_s=dt, formats=[type(l.A).__name__ for l in H.levels],
        kernels=kernels, device=str(device)), (H, A_levels)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=NX,
                    help="darcy_hyb grid (0: skip the lane)")
    ap.add_argument("--spe10", default=",".join(map(str, SPE10_CELLS)),
                    help="SPE10 cells nx,ny,nz, or 'none'")
    ap.add_argument("--block-nref", type=int, default=BLOCK_NREF,
                    help="block lane refinements (0: skip the lane)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--device", default=None,
                    help="torch device of the lanes (default: the card; "
                    "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] \
        if device.type == "cuda" else None
    # numpy too: the SPE10 partition's order of ties follows its build
    lines = [json.dumps(dict(card=smi, device=str(device),
                             torch=torch.__version__,
                             cuda=torch.version.cuda,
                             numpy=np.__version__))]
    if args.nx:
        lines.append(json.dumps(lane_darcy_hybridized(args.nx, device)[0]))
        print(lines[-1], flush=True)
    if args.spe10 != "none":
        cells = tuple(int(c) for c in args.spe10.split(","))
        lines.append(json.dumps(lane_spe10(cells, device)[0]))
        print(lines[-1], flush=True)
    if args.block_nref:
        lines.append(json.dumps(lane_darcy_block(args.block_nref,
                                                 device)[0]))
        print(lines[-1], flush=True)
    print(lines[0])
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
