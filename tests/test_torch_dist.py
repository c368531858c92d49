"""The port's distributed setup pipeline, the dist lane, the weak-scaling
drivers and dryrun_multichip against the JAX package on the CPU.

The copied host modules (parallel/{patch,dist_partition,dist_topology,
dist_sequence,dist_coarsen,dist_hierarchy}.py, byte-checked in
tests/test_torch_generic.py) give JAX's outputs entry for entry on
tests/test_dist_hierarchy.py's 3-level setup and on one small case each;
the rank-batched L-level step of the dist lane's f32 setup matches JAX's
shard_map step; weak_scaling_driver reproduces the reference's goldens as
tests/test_weak_scaling.py asserts them."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from parelag_tpu.mesh.mesh import hex_grid_mesh as jmesh
from parelag_tpu.parallel import dist_hierarchy as JH
from parelag_tpu.parallel import sharding as J
from parelag_tpu.partitioning.partitioners import cartesian_partition
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh as tmesh
from parelag_tpu_torch.parallel import dist_bench
from parelag_tpu_torch.parallel import dist_hierarchy as TH
from parelag_tpu_torch.parallel import sharding as T

torch.set_num_threads(1)

N_RANKS = 4


def _patch_A(p):
    s = p.seqs[0]
    M = s.compute_mass_operator(0)
    W = s.compute_mass_operator(1)
    return (M + s.D[0].T @ W @ s.D[0]).tocsr()


def _partitions():
    """tests/test_dist_hierarchy.py's setup: 8 x 8 x 4 hexes, 3 levels, 4
    ranks whose corner ranks are not vertex-adjacent."""
    partitions = [cartesian_partition((8, 8, 4), (2, 2, 2)),
                  cartesian_partition((4, 4, 2), (1, 2, 2))]
    ae2_rank = cartesian_partition((4, 2, 1), (1, 2, 1))
    return partitions, ae2_rank[JH.compose_partitions(partitions)[-1]]


@pytest.fixture(scope="module")
def setups():
    """The distributed operator setup of both packages."""
    partitions, rank_of_elem = _partitions()
    out = {}
    for name, H, mesh in (("jax", JH, jmesh(8, 8, 4)),
                          ("port", TH, tmesh(8, 8, 4))):
        patches, gents = H.distributed_coarsen_multilevel(
            mesh, rank_of_elem, partitions, N_RANKS, upscaling_order=0)
        out[name] = (patches, H.distributed_operator_setup(
            patches, gents, 0, _patch_A, rank_of_elem))
    return out


def _same(a, b):
    """Dataclass fields (arrays, lists, tuples and dicts of them): indices
    equal,
    values within 1e-12 of the largest (the two packages' FE assembly
    rounds differently in the last bits)."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            assert np.abs(a - b).max(initial=0) <= 1e-12 * max(
                np.abs(b).max(initial=0), 1e-300)
        else:
            assert np.array_equal(a, b)


def test_distributed_setup_equals_jax(setups):
    """Per-level dof counts and owners, owned operator rows, published P
    and numberings, and the DistributedHierarchy built from them."""
    (_, sj), (_, st) = setups["jax"], setups["port"]
    _same(sj, st)
    _same(JH.build_hierarchy_from_setup(sj, N_RANKS),
          TH.build_hierarchy_from_setup(st, N_RANKS))


def test_three_level_solve_from_setup_matches_jax(setups):
    """tests/test_dist_hierarchy.py's flagship case: the L-level PCG run
    straight off the distributed setup (f64, 25 iterations)."""
    (_, sj), (_, st) = setups["jax"], setups["port"]
    b = np.random.RandomState(3).randn(st.ndofs[0])
    xj = J.distributed_mg_l_pcg(JH.build_hierarchy_from_setup(sj, N_RANKS),
                                b, J.make_dd_mesh(N_RANKS), iters=25)
    xt = T.distributed_mg_l_pcg(TH.build_hierarchy_from_setup(st, N_RANKS),
                                b, T.make_dd_mesh(N_RANKS, "cpu"), iters=25)
    xref = spla.spsolve(dist_bench.fine_operator(st).tocsc(), b)
    assert np.abs(xt - xj).max() <= 1e-10
    assert np.abs(xt - xref).max() < 1e-10 * max(np.abs(xref).max(), 1.0)


def test_distributed_rhs_equals_jax(setups):
    (pj, sj), (pt, st) = setups["jax"], setups["port"]

    def b_fn(p):
        return p.seqs[0].domain_lf_scalar(0, lambda q: q[..., 0] + q[..., 1])

    assert np.array_equal(JH.distributed_rhs(sj, pj, b_fn),
                          TH.distributed_rhs(st, pt, b_fn))


def _jax_lane(n, dtype):
    """The JAX dist lane's setup at n ranks (parelag_tpu/parallel/
    dist_bench.py's body) in dtype: (hierarchy, rhs)."""
    grid = (16, 4 * n, 20)
    partitions = [cartesian_partition(grid, (2, 2, 2)),
                  cartesian_partition((8, 2 * n, 10), (2, 2, 2)),
                  cartesian_partition((4, n, 5), (4, 1, 5))]
    rank_of_elem = JH.compose_partitions(partitions)[-1]
    patches, gents = JH.distributed_coarsen_multilevel(
        jmesh(*grid), rank_of_elem, partitions, n, upscaling_order=0)
    setup = JH.distributed_operator_setup(patches, gents, 0, _patch_A,
                                          rank_of_elem)
    hier = JH.build_hierarchy_from_setup(setup, n, dtype=dtype)
    b = JH.distributed_rhs(
        setup, patches,
        lambda p: p.seqs[0].domain_lf_scalar(0, lambda q: q[..., 0]))
    return hier, b


@pytest.mark.parametrize("n", [2, 4])
def test_dist_lane_step_matches_jax(n):
    """The dist lane's setup at n ranks: the port's hierarchy and rhs
    equal JAX's; the init step and one L-level PCG step from x = 0 give
    JAX's (x, r, z, d) within 1e-10 in f64, and in f32, the lane's dtype,
    x within 1e-5 of its largest entry (the step's f32 dots over ~6k-12k
    entries sum in another order, and r = r - alpha A d cancels ~5x, so
    r, z and d differ by up to ~1e-3 of their own size there)."""
    import jax
    jm = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("dd",))
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        hj, bj = _jax_lane(n, dtype)
        _, ht, bt = dist_bench.build(n, 4, dtype)
        _same(hj, ht)
        assert np.array_equal(bj, bt)
        levels, cinv, g2v = hj.device_args()
        step = jax.jit(J.distributed_mg_l_step(jm, hj)(levels))
        b0 = hj.systems[0].to_local(bj.astype(dtype))
        st = (np.zeros_like(b0), b0, b0, np.zeros_like(b0))
        for _ in range(2):
            st = step(levels, cinv, g2v, *st)
        out = dist_bench.steps_from_zero(ht, bt, T.make_dd_mesh(n, "cpu"))(1)
        for i, (a, b) in enumerate(zip(out, st)):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype == dtype
            if dtype == np.float64 or i == 0:
                assert np.abs(a.numpy() - b).max() <= tol * np.abs(b).max()


def test_dist_bench_record_on_cpu():
    """distributed_solve_bench at 2 ranks on the CPU: the JAX lane's
    fields, the steps' launches (none: plain versions) and rel_res."""
    rec, (hier, b, x) = dist_bench.distributed_solve_bench(
        2, 4, steps=4, device="cpu")
    assert {"lane", "metric", "n_devices", "ndofs", "levels", "setup_s",
            "step_s", "value", "unit", "kernels", "rel_res"} <= set(rec)
    assert (rec["lane"], rec["ndofs"], rec["levels"]) == (
        "dist", 17 * 9 * 21, 4)
    assert sum(rec["kernels"].values()) == 0
    assert 0 < rec["rel_res"] < 1 and rec["value"] > 0
    assert x.shape == (rec["ndofs"],) and np.isfinite(x).all()


def test_dryrun_multichip_on_cpu():
    from parelag_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("form,gold_l2,gold_en,rtol", [
    (2, (3.4325e-01, 1.2642e-01), (2.9404e-01, 1.3420e-01), 5e-5),
    (1, (1.6197e-01, 3.0947e-02), (7.0872e-01, 2.3455e-01), 3e-4),
])
def test_weak_scaling_reference_goldens(form, gold_l2, gold_en, rtol):
    """tests/test_weak_scaling.py's golden check on the port's copy:
    Hdiv digit for digit, Hcurl to ~1e-4 (the reference solves by ADS
    PCG at rtol 1e-6)."""
    from parelag_tpu_torch.models.weak_scaling import weak_scaling_driver
    r = weak_scaling_driver(form, nref_parallel=2)
    for got, want in zip(r.u_l2_errors, gold_l2):
        assert abs(got - want) <= rtol * want, (got, want)
    for got, want in zip(r.u_energy_errors, gold_en):
        assert abs(got - want) <= rtol * want, (got, want)


@pytest.mark.parametrize("form", [1, 2])
def test_weak_scaling_driver_equals_jax(form):
    """The straight-cube driver of the port and of JAX, digit for digit
    (tests/test_weak_scaling.py's middle-level goldens)."""
    from parelag_tpu.models.weak_scaling import weak_scaling_driver as jws
    from parelag_tpu_torch.models.weak_scaling import (
        weak_scaling_driver as tws)
    kw = dict(nref_parallel=2, deform=False, targets_form_start=0)
    rj, rt = jws(form, **kw), tws(form, **kw)
    assert [f"{v:.4e}" for v in rt.u_l2_errors] == \
        [f"{v:.4e}" for v in rj.u_l2_errors]
    assert [f"{v:.4e}" for v in rt.u_energy_errors] == \
        [f"{v:.4e}" for v in rj.u_energy_errors]


def test_distributed_weak_scaling_matches_jax():
    """distributed_weak_scaling((1, 2, 4)) on the rank mesh: JAX's dofs,
    3 levels, rel_res < 1e-8 at every rank count."""
    from parelag_tpu.models.weak_scaling import (
        distributed_weak_scaling as jdws)
    from parelag_tpu_torch.models.weak_scaling import (
        distributed_weak_scaling as tdws)
    res = tdws(n_ranks_list=(1, 2, 4), device="cpu")
    ref = jdws(n_ranks_list=(1, 2, 4))
    assert [r["n_ranks"] for r in res] == [1, 2, 4]
    assert [r["ndofs"] for r in res] == [r["ndofs"] for r in ref]
    for r, q in zip(res, ref):
        assert r["levels"] == 3 and r["rel_res"] < 1e-8, r
        assert abs(r["rel_res"] - q["rel_res"]) <= 1e-12


def test_dist_partition_equals_jax():
    """parmetis_kway on tests/test_dist_partition.py's grid graph."""
    from parelag_tpu.parallel import dist_partition as jdp
    from parelag_tpu.topology.topology import AgglomeratedTopology
    from parelag_tpu_torch.parallel import dist_partition as tdp
    topo = AgglomeratedTopology.from_mesh(jmesh(12, 12, 6))
    A = topo.local_element_element().astype(float)
    A.setdiag(0)
    A.eliminate_zeros()
    rank_of = cartesian_partition((12, 12, 6), (6, 6, 6)) % 4
    parts = [M.parmetis_kway(M.make_vertex_shards(A, rank_of, 4), 8,
                             seed=0) for M in (jdp, tdp)]
    assert np.array_equal(*parts)


def test_dist_topology_equals_jax():
    """distributed_coarsen_facets on tests/test_dist_topology.py's 2-rank
    4^3 case: the same facet agglomerates, elements and stats."""
    from parelag_tpu.parallel import dist_topology as jdt
    from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
    from parelag_tpu_torch.parallel import dist_topology as tdt
    from parelag_tpu_torch.topology.topology import (
        AgglomeratedTopology as TTopo)
    ranks = cartesian_partition((4, 4, 4), (4, 4, 2))
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    out = []
    for M, Topo, mesh in ((jdt, JTopo, jmesh), (tdt, TTopo, tmesh)):
        topo = Topo.from_mesh(mesh(4, 4, 4))
        shards, _ = M.make_shards(topo, ranks, part.copy(), 2)
        out.append(M.distributed_coarsen_facets(shards, 2))
    (fj, ej, sj), (ft, et, st) = out
    assert (fj != ft).nnz == 0 and (ej != et).nnz == 0 and sj == st


def test_dist_sequence_equals_jax():
    """distributed_facet_traces on tests/test_dist_sequence.py's 2-rank
    4^3 case: the same per-facet trace blocks."""
    from parelag_tpu.amge.fespace import DeRhamSequenceFE as JSeq
    from parelag_tpu.parallel import dist_sequence as jds
    from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE as TSeq
    from parelag_tpu_torch.parallel import dist_sequence as tds
    from parelag_tpu_torch.topology.topology import (
        AgglomeratedTopology as TTopo)
    ranks = cartesian_partition((4, 4, 4), (4, 4, 2))
    part = cartesian_partition((4, 4, 4), (2, 2, 2))
    out = []
    for M, Topo, Seq, mesh in ((jds, JTopo, JSeq, jmesh),
                               (tds, TTopo, TSeq, tmesh)):
        m = mesh(4, 4, 4)
        topo = Topo.from_mesh(m)
        topo.coarsen_local_partitioning(part.copy())
        seq = Seq(topo, m)
        seq.set_upscaling_targets(0)
        seq.agglomerate_dofs()
        seq.svd_tol = 1e-9
        fc_AF = topo.AEntity_entity[1].T.tocsr()
        out.append(M.distributed_facet_traces(seq, 2, fc_AF, ranks, 2,
                                              svd_tol=1e-9))
    (rj, sj), (rt, st) = out
    assert sj == st and len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert (a.facet, a.owner) == (b.facet, b.owner)
        assert np.array_equal(a.dofs, b.dofs)
        assert np.abs(a.p_block - b.p_block).max() <= 1e-12
