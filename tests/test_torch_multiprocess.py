"""Multi-process ranks of the port (parallel.sharding in a
torch.distributed group, parallel/mp_worker.py) on the CPU: gloo
processes joined through a file:// store, each holding its own ranks.
The counterpart of tests/test_multiprocess.py, which holds the JAX
package's two processes (and is marked slow); here every launch runs
under its own 120 s timeout.

Tolerances: the f64 solve within 1e-10 of spsolve (the JAX worker's
bound), of the JAX one-process distributed_mg_l_pcg on conftest's 8
virtual devices (test_torch_parallel.py's TOL) and, since only the
dots' and restriction's partial sums move between processes, within
1e-12 of the port's one-process run; the per-process setup against the
one-process setup at the JAX setup worker's 1e-13 (A) and 1e-14 (P);
GhostMap and shard_setup at test_torch_parallel.py's 1e-12; the dist
lane's level tables byte for byte, and its f32 x within twice f32's own
error (the CPU's f32 x against f64 arithmetic on the same tables) of the
one-process steps."""

import argparse

import numpy as np
import pytest
import torch

from parelag_tpu.amge.fespace import DeRhamSequenceFE as JSeq
from parelag_tpu.mesh.mesh import hex_grid_mesh as jmesh
from parelag_tpu.parallel import sharding as J
from parelag_tpu.partitioning.partitioners import cartesian_partition
from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
from parelag_tpu_torch.parallel import dist_bench, mp_worker
from parelag_tpu_torch.parallel.sharding import make_dd_mesh

torch.set_num_threads(1)

TIMEOUT = 120
STEPS = 5
NY = 4     # the smallest ny_per_rank the dist lane's partition takes at 8
           # ranks (its coarsest partition has ny_per_rank // 4 blocks)


def _jax_solve():
    """tests/_mp_worker.py's solve in one JAX process on the 8 virtual
    devices."""
    m = jmesh(8, 8, 4)
    topo = JTopo.from_mesh(m)
    topo.coarsen_local_partitioning(cartesian_partition((8, 8, 4),
                                                        (2, 2, 2)))
    topo.coarser.coarsen_local_partitioning(
        cartesian_partition((4, 4, 2), (2, 2, 2)))
    seqs = [JSeq(topo, m)]
    seqs[0].set_upscaling_targets(0)
    seqs.append(seqs[0].coarsen())
    seqs.append(seqs[1].coarsen())
    s = seqs[0]
    A0 = (s.compute_mass_operator(0) + s.D[0].T
          @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
    P_levels = [seqs[0].P[0].tocsr(), seqs[1].P[0].tocsr()]
    A_levels = [A0]
    for P in P_levels:
        A_levels.append((P.T @ A_levels[-1] @ P).tocsr())
    owner = J.dof_partition(s.dof[0].entity_dof_pattern(0),
                            cartesian_partition((8, 8, 4), (4, 4, 2)))
    hier = J.build_distributed_hierarchy(A_levels, P_levels, owner, 8)
    b = np.random.RandomState(7).randn(A0.shape[0])
    return J.distributed_mg_l_pcg(hier, b, J.make_dd_mesh(), iters=30,
                                  dtype=np.float64)


@pytest.fixture(scope="module")
def one_process():
    """The solve case in this process: the port's ranks as one tensor
    (x and the level tables' digest), and the JAX package's shard_map
    run."""
    rec, x = mp_worker.case_solve(argparse.Namespace(),
                                  make_dd_mesh(mp_worker.RANKS, "cpu"))
    return x, _jax_solve(), rec["tables"]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _common(recs, world):
    assert [r["rank"] for r in recs] == list(range(world))
    for r in recs:
        assert (r["world"], r["backend"], r["staged"], r["imports_jax"]) \
            == (world, "gloo", [], [])


@pytest.mark.parametrize("world", [2, 4])
def test_solve_across_processes(world, one_process, tmp_path):
    x_out = tmp_path / "x.npy"
    recs = mp_worker.launch(world, "solve", device="cpu", x_out=x_out,
                            timeout=TIMEOUT)
    _common(recs, world)
    assert all(r["err"] < 1e-10 for r in recs), recs
    assert len({r["digest"] for r in recs}) == 1
    x = np.load(x_out)
    x1, xj, tables = one_process
    assert {r["tables"] for r in recs} == {tables}
    assert _rel(x, x1) <= 1e-12
    assert _rel(x, xj) <= 1e-10
    # 3 levels: 12 all_gathers (9 halos, 2 prolongations, the coarsest
    # level's), 3 all_reduces and 2 reduce_scatters a step, 31 steps
    # (the init step and 30), and the final gather of x
    calls = {k: v[0] for k, v in recs[0]["comm"].items()}
    assert calls == {"all_gather": 12 * 31 + 1, "all_reduce": 3 * 31,
                     "reduce_scatter": 2 * 31}


def test_setup_across_processes():
    recs = mp_worker.launch(2, "setup", device="cpu", timeout=TIMEOUT)
    _common(recs, 2)
    for r in recs:
        assert r["levels"] == 3 and r["ndofs"] == r["ref_ndofs"]
        assert max(r["A_err"]) < 1e-13 and max(r["P_err"]) < 1e-14
        assert all(r["P_pattern"])
    assert len({r["digest"] for r in recs}) == 1


def test_ghost_map_and_shard_setup_across_processes():
    recs = mp_worker.launch(2, "ghost", device="cpu", timeout=TIMEOUT)
    _common(recs, 2)
    for r in recs:
        assert r["n_batches"] == mp_worker.GHOST_RANKS // 2
        assert max(r["distribute_err"], r["assemble_err"], r["svd_err"],
                   r["solve_err"]) <= 1e-12, r


def test_dist_steps_across_processes(tmp_path):
    """The dist lane's 5 steps in 2 processes, each setting up its own
    ranks: the one-process lane's tables, byte for byte, and its x."""
    x_out = tmp_path / "x.npy"
    recs = mp_worker.launch(2, "dist", ny_per_rank=NY, device="cpu",
                            steps=STEPS, x_out=x_out, timeout=TIMEOUT)
    _common(recs, 2)
    setup, hier, b = dist_bench.build(mp_worker.RANKS, NY)
    mesh = make_dd_mesh(mp_worker.RANKS, "cpu")
    x1 = dist_bench.time_steps(hier, b, mesh, STEPS)[0]
    x64 = dist_bench.time_steps(dist_bench.cast(hier, np.float64), b, mesh,
                                STEPS)[0]
    gap = np.linalg.norm(x1 - x64) / np.linalg.norm(x64)
    x = np.load(x_out)
    assert np.linalg.norm(x - x1) / np.linalg.norm(x1) <= 2 * gap
    for r in recs:
        assert r["digest"] == dist_bench.table_digest(hier)
        assert r["level_ndofs"] == list(map(int, setup.ndofs))
        assert r["steps"] == STEPS and np.isfinite(r["rel_res"])
        # 4 levels: 13 halo gathers (the CG matvec and 4 a smoothed
        # level), 3 prolongations and the coarsest level's, 3 dots and 3
        # restrictions a step; the timed steps only
        assert {k: v["calls"] for k, v in r["comm"].items()} == {
            "all_gather": 17 * STEPS, "all_reduce": 3 * STEPS,
            "reduce_scatter": 3 * STEPS}
        assert 0 < r["comm_share"] <= 1
