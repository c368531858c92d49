"""The port's distributed plane (parelag_tpu_torch/parallel/) against the
JAX package on the CPU: the host plans equal JAX's exactly, and the
rank-batched device steps (the ranks as a batch axis of one tensor)
give JAX's shard_map solves on the 8-device CPU mesh within 1e-10 (f64)
on the inputs of tests/test_parallel.py, and the direct solve at that
file's own bounds.  Also GhostMap, the rank-batched setup solves
(tests/test_dist_coarsen.py's case), the rank mesh and its multi-process
rule, and the copied host functions of sharding / shard_setup."""

import inspect
import re

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from parelag_tpu.amge.fespace import DeRhamSequenceFE
from parelag_tpu.mesh.mesh import hex_grid_mesh
from parelag_tpu.models.upscaling import (
    boundary_rhs, eliminate_rowcols, mark_dofs_on_bndr)
from parelag_tpu.parallel import ghost as jghost
from parelag_tpu.parallel import shard_setup as jsetup
from parelag_tpu.parallel import sharding as J
from parelag_tpu.partitioning.partitioners import (
    cartesian_partition, refined_mesh_partition)
from parelag_tpu.solvers.hierarchy import rap
from parelag_tpu.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.parallel import ghost as tghost
from parelag_tpu_torch.parallel import shard_setup as tsetup
from parelag_tpu_torch.parallel import sharding as T

torch.set_num_threads(1)

# f64 solves: the port's and JAX's products and dots differ in summation
# order only
TOL = 1e-10


def _h1(m, seq):
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    return eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))


@pytest.fixture(scope="module")
def poisson():
    """tests/test_parallel.py's 4^3 problem on 8 ranks."""
    m = hex_grid_mesh(4, 4, 4)
    seq = DeRhamSequenceFE(AgglomeratedTopology.from_mesh(m), m)
    A, b = _h1(m, seq)
    owner = J.dof_partition(seq.dof[0].entity_dof_pattern(0),
                            cartesian_partition((4, 4, 4), (2, 2, 2)))
    return A, b, owner


@pytest.fixture(scope="module")
def two_level():
    """tests/test_parallel.py's two-level case (4^3 refined from 2^3)."""
    m = hex_grid_mesh(2, 2, 2).uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(m)
    topo.coarsen_local_partitioning(refined_mesh_partition(64, 8))
    seq = DeRhamSequenceFE(topo, m)
    seq.set_upscaling_targets(0)
    seq.coarsen()
    A, b = _h1(m, seq)
    P = seq.P[0]
    owner = J.dof_partition(seq.dof[0].entity_dof_pattern(0),
                            cartesian_partition((4, 4, 4), (2, 2, 2)))
    return A, b, P, rap(A, P), owner


@pytest.fixture(scope="module")
def three_level():
    """tests/test_parallel.py's 3-level case (8^3) and both packages'
    DistributedHierarchy of it."""
    m = hex_grid_mesh(2, 2, 2).uniform_refinement().uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(m)
    t1 = topo.coarsen_local_partitioning(refined_mesh_partition(512, 64))
    t1.coarsen_local_partitioning(refined_mesh_partition(64, 8))
    seq = DeRhamSequenceFE(topo, m)
    seq.set_upscaling_targets(0)
    s1 = seq.coarsen()
    s1.coarsen()
    A, b = _h1(m, seq)
    A1 = rap(A, seq.P[0])
    A2 = rap(A1, s1.P[0])
    owner = J.dof_partition(seq.dof[0].entity_dof_pattern(0),
                            cartesian_partition((8, 8, 8), (4, 4, 4)))
    args = ([A, A1, A2], [seq.P[0], s1.P[0]], owner, 8)
    return (A, b, J.build_distributed_hierarchy(*args),
            T.build_distributed_hierarchy(*args))


def _same(a, b):
    """Dataclass fields (arrays, lists and tuples of them) equal."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_plans_equal_jax(poisson, three_level):
    """DistributedSystem, HaloPlan and DistributedHierarchy: the port's
    host arrays are JAX's, entry for entry."""
    A, _, owner = poisson
    sj = J.distribute_system(A, owner, 8, dtype=np.float64)
    st = T.distribute_system(A, owner, 8, dtype=np.float64)
    _same(sj, st)
    _same(J.build_halo_plan(sj), T.build_halo_plan(st))
    _, _, hj, ht = three_level
    _same(hj, ht)


@pytest.mark.parametrize("name", [
    "DistributedSystem", "owner_layout", "dof_partition",
    "distribute_system", "HaloPlan", "build_halo_plan", "distribute_rect",
    "coarse_owner_from_P", "build_distributed_hierarchy"])
def test_copied_host_function_equals_its_source(name):
    """sharding's numpy host half is the JAX package's, unchanged."""
    assert inspect.getsource(getattr(T, name)) == inspect.getsource(
        getattr(J, name))


def test_copied_pad_rank_batches_equals_its_source():
    assert inspect.getsource(tsetup.pad_rank_batches) == \
        inspect.getsource(jsetup.pad_rank_batches)


def test_halo_and_allgather_products_match_jax(poisson):
    """One product over every rank: the halo form (the ghost gather then
    the local product over [own | ghosts]) and the all-gather form equal
    JAX's ppermute product and scipy's."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    A, _, owner = poisson
    sj = J.distribute_system(A, owner, 8, dtype=np.float64)
    plan = J.build_halo_plan(sj)
    mesh = J.make_dd_mesh(8)

    @partial(J.shard_map, mesh=mesh,
             in_specs=(P("dd"), P("dd"), P("dd"),
                       tuple(P("dd") for _ in plan.offsets), P("dd")),
             out_specs=P("dd"))
    def spmv(vals, idx_ext, mask, sends, x):
        return J._halo_spmv_local(vals, idx_ext, mask, sends,
                                  plan.offsets, 8, x)

    x = np.random.RandomState(3).rand(A.shape[0])
    xl = sj.to_local(x)
    yj = sj.to_global(np.asarray(spmv(
        sj.values, plan.indices_ext, sj.row_mask,
        tuple(plan.send_slots), xl)))
    tm = T.make_dd_mesh(8, "cpu")
    st = T.distribute_system(A, owner, 8, dtype=np.float64)
    xt = torch.as_tensor(xl)
    halo = T._halo_spmv(T._level(st, tm, T.build_halo_plan(st)), xt)
    full = T._spmv(T._level(st, tm), xt)
    for y in (halo, full):
        yt = st.to_global(y.numpy())
        assert np.abs(yt - yj).max() <= 1e-12
        assert np.abs(yt - A @ x).max() <= 1e-12


def test_distributed_pcg_matches_jax(poisson):
    A, b, owner = poisson
    sj = J.distribute_system(A, owner, 8, dtype=np.float64)
    st = T.distribute_system(A, owner, 8, dtype=np.float64)
    xj = J.distributed_pcg(sj, b, J.make_dd_mesh(8), iters=80,
                           dtype=np.float64)
    xt = T.distributed_pcg(st, b, T.make_dd_mesh(8, "cpu"), iters=80,
                           dtype=np.float64)
    assert np.abs(xt - xj).max() <= TOL
    assert np.abs(xt - spla.spsolve(A.tocsc(), b)).max() < 1e-10


@pytest.mark.parametrize("halo", [False, True])
def test_distributed_mg_pcg_matches_jax(two_level, halo):
    """The two-level MG-PCG, all-gather and halo forms."""
    A, b, P, Ac, owner = two_level
    sj = J.distribute_system(A, owner, 8, dtype=np.float64)
    st = T.distribute_system(A, owner, 8, dtype=np.float64)
    xj = J.distributed_mg_pcg(sj, P, Ac, b, J.make_dd_mesh(8), iters=15,
                              halo=halo)
    xt = T.distributed_mg_pcg(st, P, Ac, b, T.make_dd_mesh(8, "cpu"),
                              iters=15, halo=halo)
    assert np.abs(xt - xj).max() <= TOL
    assert np.abs(xt - spla.spsolve(A.tocsc(), b)).max() < 1e-12


def test_distributed_mg_l_pcg_matches_jax(three_level):
    A, b, hj, ht = three_level
    xj = J.distributed_mg_l_pcg(hj, b, J.make_dd_mesh(8), iters=25)
    xt = T.distributed_mg_l_pcg(ht, b, T.make_dd_mesh(8, "cpu"), iters=25)
    xref = spla.spsolve(A.tocsc(), b)
    assert np.abs(xt - xj).max() <= TOL
    assert np.abs(xt - xref).max() < 1e-11 * max(1.0, np.abs(xref).max())


def test_step_reads_nothing_on_the_host(three_level):
    """The CG scalars of a step stay 0-d tensors: the step never turns a
    device value into a Python number."""
    _, b, _, ht = three_level
    mesh = T.make_dd_mesh(8, "cpu")
    levels, cinv, g2v = ht.device_args(mesh)
    step = T.distributed_mg_l_step(mesh, ht)(levels)
    bb = torch.as_tensor(ht.systems[0].to_local(b))
    state = (torch.zeros_like(bb), bb, bb, torch.zeros_like(bb))
    calls = []
    real = torch.Tensor.item

    def spy(t):
        calls.append(t)
        return real(t)
    try:
        torch.Tensor.item = spy
        out = step(levels, cinv, g2v, *state)
    finally:
        torch.Tensor.item = real
    assert not calls and all(o.shape == bb.shape for o in out)


def _facet_case():
    """tests/test_ghost.py's facet exchange: 4^3 hexes on 4 ranks."""
    m = hex_grid_mesh(4, 4, 4)
    topo = AgglomeratedTopology.from_mesh(m)
    rank_of_elem = cartesian_partition((4, 4, 4), (2, 2, 4))
    B0 = topo.B[0].tocsr()
    owner = np.full(B0.shape[1], 4, dtype=np.int64)
    coo = B0.tocoo()
    np.minimum.at(owner, coo.col, rank_of_elem[coo.row])
    reads = [np.unique(B0[rank_of_elem == r].indices) for r in range(4)]
    return owner, reads


def test_ghost_map_host_and_device():
    """GhostMap: the port's plan and host verbs are JAX's; its device
    verbs on the rank mesh give the host's, padded slots discarded."""
    owner, reads = _facet_case()
    gj = jghost.GhostMap.build(owner, reads)
    gt = tghost.GhostMap.build(owner, reads)
    _same(gj, gt)
    rng = np.random.RandomState(1)
    vals = rng.randn(owner.size)
    contribs = [rng.randn(g.size) for g in gt.ghosts]
    for a, b in zip(gt.distribute(vals), gj.distribute(vals)):
        assert np.array_equal(a, b)
    ref = gt.assemble(vals, contribs)
    assert np.array_equal(ref, gj.assemble(vals, contribs))
    gvirt, dist_fn, asm_fn = gt.device_fns(T.make_dd_mesh(4, "cpu"))
    blocks = torch.as_tensor(gt.to_blocks(vals))
    ghost = dist_fn(blocks, gvirt).numpy()
    mask = gt.ghost_mask()
    for r, g in enumerate(gt.ghosts):
        assert np.array_equal(ghost[r, :g.size], vals[g])
    assert np.all(ghost[~mask] == 0)
    cpad = np.zeros(ghost.shape)
    for r, c in enumerate(contribs):
        cpad[r, :c.size] = c
    # a nonzero in a padded slot must not reach any entity
    cpad[~mask] = 1e3
    out = asm_fn(blocks, torch.as_tensor(cpad), gvirt).numpy()
    assert np.abs(gt.from_blocks(out) - ref).max() <= 1e-12


def test_rank_batched_setup_solves():
    """tests/test_dist_coarsen.py's setup batches: the rank-batched SVDs
    and saddle solves (one stacked torch.linalg call) match host
    LAPACK."""
    mesh = T.make_dd_mesh(8, "cpu")
    rng = np.random.RandomState(0)
    batches = [rng.randn(3 + r, 12, 4) for r in range(4)]
    out = tsetup.sharded_batched_svd(batches, mesh)
    for r, per_rank in enumerate(out):
        assert len(per_rank) == batches[r].shape[0]
        for i, (U, s) in enumerate(per_rank):
            Uh, sh, _ = np.linalg.svd(batches[r][i], full_matrices=False)
            assert np.allclose(s, sh, atol=1e-10)
            assert np.allclose(np.abs(U.T @ Uh), np.eye(4), atol=1e-8)
    As = [rng.randn(2 + r, 6, 6) + 6 * np.eye(6) for r in range(4)]
    Bs = [rng.randn(A.shape[0], 6, 3) for A in As]
    Xs = tsetup.sharded_solve_groups(As, Bs, mesh)
    for A, B, X in zip(As, Bs, Xs):
        assert np.allclose(X, np.linalg.solve(A, B), atol=1e-10)


def test_rank_mesh_and_the_multiprocess_guard(monkeypatch):
    """make_dd_mesh is the rank axis on one device: without the process
    variables it is one process; a WORLD_SIZE above 1 with one of them
    missing raises naming it (the run never quietly becomes one
    process); a rank count that the process count does not divide is
    refused."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    mesh = T.make_dd_mesh(8, "cpu")
    assert (mesh.ndev, mesh.axis_names, mesh.device.type) == (
        8, ("dd",), "cpu")
    assert (mesh.world, mesh.rank, mesh.n_own, mesh.own) == (
        1, 0, 8, slice(0, 8))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        T.make_dd_mesh(2, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(T.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(T.dist, "get_rank", lambda group: 1)
    with pytest.raises(ValueError, match="divide"):
        T.make_dd_mesh(3, "cpu", group=object())
    mesh = T.make_dd_mesh(8, "cpu", group=object())
    assert (mesh.world, mesh.rank, mesh.n_own, mesh.own) == (
        2, 1, 4, slice(4, 8))
    # NCCL only with a card a process
    assert [T.backend_for(d, c, p) for d, c, p in (
        ("cpu", 0, 2), ("cuda", 1, 2), ("cuda", 1, 4), ("cuda", 4, 4),
        ("cuda", 4, 2))] == ["gloo", "gloo", "gloo", "nccl", "nccl"]
