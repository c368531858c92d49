"""Distributed-solve bench lane on the card: times the rank-batched
L-level V-cycle PCG step (parallel.sharding.distributed_mg_l_step).

    python -m parelag_tpu_torch.parallel.dist_bench 8     # JAX lane's shape
    python -m parelag_tpu_torch.parallel.dist_bench 8 --ny-per-rank 32
    python -m parelag_tpu_torch.parallel.dist_bench 4 --ny-per-rank 4 \
        --steps 5 --device cpu

Counterpart of parelag_tpu/parallel/dist_bench.py (bench.py's `dist`
lane), which runs the sharded step on a virtual 8-device CPU mesh.  Here
the ranks are the leading batch axis of one tensor on one device, so the
same setup -- grid (16, ny_per_rank * n, 20), three nested
cartesian_partitions down to one agglomerate a rank, the patch operator
M + D^T W D, the f32 hierarchy from the distributed setup and its rhs --
runs on the card with every local product in the hand ell_spmv kernel.
The steps are timed with CUDA events (the host clock on the CPU); the
record adds to the JAX lane's fields the timed steps' own kernel
launches and the relative residual of x after them in host f64.

Reference analog: the weak-scaling drivers examples/3DHdivWeakScaling.cpp
(timing tables over MPI ranks).
"""

import argparse
import hashlib
import json
import time

import numpy as np
import scipy.sparse as sp
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import hopper_kernels

WARMUP = 3       # steps run (and discarded) before the timed run


def problem(n_devices, ny_per_rank=4):
    """The lane's problem: (mesh, partitions, rank_of_elem, patch_A,
    rhs_fn): the grid (16, ny_per_rank * n, 20), three nested
    cartesian_partitions down to one agglomerate a rank, the patch
    operator M + D^T W D and the patch load vector."""
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.parallel.dist_hierarchy import compose_partitions
    from parelag_tpu_torch.partitioning.partitioners import (
        cartesian_partition)

    n = n_devices
    grid = (16, ny_per_rank * n, 20)
    m = hex_grid_mesh(*grid)
    partitions = [
        cartesian_partition(grid, (2, 2, 2)),
        cartesian_partition((8, ny_per_rank * n // 2, 10), (2, 2, 2)),
        cartesian_partition((4, ny_per_rank * n // 4, 5),
                            (4, ny_per_rank * n // 4 // n, 5)),
    ]
    rank_of_elem = compose_partitions(partitions)[-1]

    def patch_A(p):
        s = p.seqs[0]
        M = s.compute_mass_operator(0)
        W = s.compute_mass_operator(1)
        return (M + s.D[0].T @ W @ s.D[0]).tocsr()

    def rhs_fn(p):
        return p.seqs[0].domain_lf_scalar(0, lambda q: q[..., 0])

    return m, partitions, rank_of_elem, patch_A, rhs_fn


def build(n_devices, ny_per_rank=4, dtype=np.float32):
    """The lane's host setup: (setup, hier, b).  setup is the distributed
    operator setup (dist_hierarchy.DistMLSetup), hier its
    DistributedHierarchy in dtype, b the fine rhs (host f64)."""
    from parelag_tpu_torch.parallel.dist_hierarchy import (
        distributed_coarsen_multilevel, distributed_operator_setup,
        build_hierarchy_from_setup, distributed_rhs)

    m, partitions, rank_of_elem, patch_A, rhs_fn = problem(n_devices,
                                                           ny_per_rank)
    patches, gents = distributed_coarsen_multilevel(
        m, rank_of_elem, partitions, n_devices, upscaling_order=0)
    setup = distributed_operator_setup(
        patches, gents, 0, patch_A, rank_of_elem)
    hier = build_hierarchy_from_setup(setup, n_devices, dtype=dtype)
    return setup, hier, distributed_rhs(setup, patches, rhs_fn)


def fine_operator(setup):
    """The fine operator assembled from every rank's owned rows (host
    f64; the check's, never the solve's)."""
    rows, cols, vals = (np.concatenate([t[i] for t in setup.A_rows[0]])
                        for i in range(3))
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(setup.ndofs[0],) * 2).tocsr()


def cast(hier, dtype):
    """A copy of hier with every floating table in dtype (the same
    rounded values, e.g. an f32 hierarchy's tables run in f64
    arithmetic)."""
    from dataclasses import replace
    return replace(
        hier, systems=[replace(s, values=s.values.astype(dtype),
                               row_mask=s.row_mask.astype(dtype),
                               dinv=s.dinv.astype(dtype))
                       for s in hier.systems],
        P_rows=[(Pi, Pv.astype(dtype)) for Pi, Pv in hier.P_rows],
        coarse_inv=hier.coarse_inv.astype(dtype))


def table_digest(hier):
    """sha256 of every host table of a DistributedHierarchy (each
    level's blocks and halo plan, P's rows, the coarse inverse), in
    order: equal digests mean byte-equal tables."""
    h = hashlib.sha256()
    arrays = [hier.coarse_inv, *hier.owners]
    for s, p in zip(hier.systems, hier.plans):
        arrays += [s.indices, s.values, s.row_mask, s.dinv,
                   p.indices_ext, *p.send_slots]
    for Pi, Pv in hier.P_rows:
        arrays += [Pi, Pv]
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def level_operators(levels):
    """The operators the rank-batched step applies, as (label,
    EllMatrix): every level's A above the coarsest in the halo form (all
    ranks' rows over the flat extended vectors) and P's rows over the
    gathered coarse vector (levels from DistributedHierarchy.device_args;
    the coarsest applies its dense inverse)."""
    return [(f"{name}{l}", lv[name]) for l, lv in enumerate(levels[:-1])
            for name in ("A", "P")]


def steps_from_zero(hier, b, mesh):
    """run(k, between=None): the L-level step bound to hier's tables on
    mesh, run from x = 0: the state (x, r, z, d) after the init step (d =
    0: z becomes the V-cycle of b), between() and k PCG steps; the
    vectors are the blocks of the ranks this process holds."""
    from parelag_tpu_torch.parallel.sharding import (
        distributed_mg_l_step, shard_blocks)
    levels_args, cinv, g2v = hier.device_args(mesh)
    step = distributed_mg_l_step(mesh, hier)(levels_args)
    s0 = hier.systems[0]
    bb = shard_blocks(mesh, s0.to_local(b.astype(s0.values.dtype)))

    def one(st):
        return step(levels_args, cinv, g2v, *st)

    def run(k, between=None):
        st = one((torch.zeros_like(bb), bb, bb, torch.zeros_like(bb)))
        if between:
            between()
        for _ in range(k):
            st = one(st)
        return st

    return run


def time_steps(hier, b, mesh, steps):
    """`steps` L-level PCG steps from x = 0 timed after WARMUP discarded
    ones, with CUDA events on the card (the host clock on the CPU).
    Returns (x, step_s, kernels, comm): x the global solution after the
    timed steps (host f64, on every process), kernels the timed steps'
    hand-kernel launches, comm the timed steps' collectives (verb ->
    (calls, host seconds); empty in one process)."""
    run = steps_from_zero(hier, b, mesh)
    run(WARMUP)
    cuda = mesh.device.type == "cuda"
    marks = {}

    def start():
        if cuda:
            torch.cuda.synchronize(mesh.device)
            marks["t"] = torch.cuda.Event(enable_timing=True)
            marks["t"].record()
        else:
            marks["t"] = time.perf_counter()
        marks["launches"] = dict(hopper_kernels.LAUNCHES)
        mesh.comm.clear()

    st = run(steps, between=start)
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        dt = marks["t"].elapsed_time(end) / 1e3 / steps
    else:
        dt = (time.perf_counter() - marks["t"]) / steps
    kernels = {k: hopper_kernels.LAUNCHES[k] - marks["launches"][k]
               for k in hopper_kernels.LAUNCHES}
    comm = dict(mesh.comm)
    from parelag_tpu_torch.parallel.sharding import gather_global
    x = hier.systems[0].to_global(gather_global(st[0], mesh)).astype(
        np.float64)
    return x, dt, kernels, comm


def distributed_solve_bench(n_devices=8, ny_per_rank=4, steps=20,
                            device=None):
    """The dist lane on `device` (None: the card): the host setup, then
    `steps` L-level PCG steps timed after WARMUP discarded ones.
    Returns (record, (hier, b, x)): x the global solution after the
    timed steps (host f64)."""
    from parelag_tpu_torch.parallel.sharding import make_dd_mesh
    device = resolve_device(device)
    mesh = make_dd_mesh(n_devices, device)
    if device.type == "cuda":
        hopper_kernels.load()
    t0 = time.perf_counter()
    setup, hier, b = build(n_devices, ny_per_rank)
    setup_s = time.perf_counter() - t0
    x, dt, kernels, _ = time_steps(hier, b, mesh, steps)
    return record(setup, b, x, n_devices=n_devices,
                  ny_per_rank=ny_per_rank, setup_s=setup_s, step_s=dt,
                  steps=steps, kernels=kernels, device=device), (hier, b, x)


def record(setup, b, x, *, n_devices, ny_per_rank, setup_s, step_s,
           steps, kernels, device):
    """The lane's record: the run's fields with the dofs, levels, value =
    fine dofs / step_s, the timer and rel_res of x in host f64."""
    A = fine_operator(setup)
    rel = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    ndofs = int(setup.ndofs[0])
    return dict(lane="dist", metric="distributed_mg_step",
                n_devices=n_devices, ny_per_rank=ny_per_rank, ndofs=ndofs,
                levels=len(setup.ndofs),
                level_ndofs=list(map(int, setup.ndofs)),
                setup_s=setup_s, step_s=step_s, value=ndofs / step_s,
                unit="dof_per_s", steps=steps, rel_res=rel,
                kernels=kernels,
                timer="cuda_events" if device.type == "cuda"
                else "host_clock", device=str(device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--ny-per-rank", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rec, _ = distributed_solve_bench(args.n_devices, args.ny_per_rank,
                                     args.steps, args.device)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
