"""The port's generic AMGe engine (mesh -> topology -> DeRhamSequenceFE
-> coarsen) and the AMGe solver on top of it, against the JAX package on
the CPU at 8^3 and below.

Tolerances: the copied host modules must give the same tables exactly
(integer and sign tables, B matrices); the fine masses and derivatives
agree within 1e-12 relative and the coarsened P, D, Pi and coarse masses
within 1e-10 (f64; the same numpy/native code, run again).  The port's
'device' backend (an f64 LU, here through torch on the CPU) keeps the
coarse dimensions of every level and form and P within 5e-5 of the JAX
host backend, the contract of tests/test_bench_pipeline.py:57-88.  The
f64 hierarchy's levels agree within 1e-12; one f32 V-cycle within 1e-5
relative; PCG within one iteration; entry() within 1e-5 relative."""

import os
import re

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import __graft_entry__ as jentry
from parelag_tpu.amge.fespace import DeRhamSequenceFE as JSeq
from parelag_tpu.mesh.mesh import hex_grid_mesh as jmesh
from parelag_tpu.models.upscaling import (
    boundary_rhs as jrhs, eliminate_rowcols as jelim,
    mark_dofs_on_bndr as jmark)
from parelag_tpu.partitioning import partitioners as jpart
from parelag_tpu.solvers.amge_solver import (
    amge_pcg_solve as jpcg_solve, build_amge_hierarchy as jbuild)
from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
from parelag_tpu_torch import convert, entry, generic_lane
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE as TSeq
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh as tmesh
from parelag_tpu_torch.models import upscaling as tup
from parelag_tpu_torch.ops import native
from parelag_tpu_torch.partitioning import partitioners as tpart
from parelag_tpu_torch.solvers import amge_solver
from parelag_tpu_torch.topology.topology import AgglomeratedTopology as TTopo

torch.set_num_threads(1)

ENTITY_FIELDS = ("edges", "face_verts", "face_sorted", "elem_edge",
                 "elem_edge_sign", "elem_face", "elem_face_sign",
                 "face_edge", "face_edge_sign", "B0", "B1", "B2")


def _rel(a, b):
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    b = b.toarray() if sp.issparse(b) else np.asarray(b)
    return np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(initial=0.0),
                                                1e-300)


def _same(a, b):
    if sp.issparse(a) or sp.issparse(b):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        return a.shape == b.shape and (a != b).nnz == 0
    return np.array_equal(np.asarray(a), np.asarray(b))


def _mesh(which, mk):
    if which == "4^3":
        return mk(4, 4, 4)
    return mk(2, 2, 2).uniform_refinement()       # 2^3 refined once


def _partition(which, part, ne):
    if which == "4^3":
        return part.cartesian_partition((4, 4, 4), (2, 2, 2))
    return part.refined_mesh_partition(ne, ne // 8)


def _chain(side, n, levels, backend="host"):
    """The sequence chain of the n^3 grid over `levels` levels (2x2x2
    agglomerates), pass 2 on `backend` at every level."""
    mk, Topo, Seq, part = ((jmesh, JTopo, JSeq, jpart) if side == "jax"
                           else (tmesh, TTopo, TSeq, tpart))
    mesh = mk(n, n, n)
    topo = Topo.from_mesh(mesh)
    t, s = topo, n
    for _ in range(levels - 1):
        t = t.coarsen_local_partitioning(part.cartesian_partition(
            (s, s, s), (2, 2, 2)))
        s //= 2
    seqs = [Seq(topo, mesh)]
    seqs[0].set_upscaling_targets(0)
    for _ in range(levels - 1):
        seqs[-1].solve_backend = backend
        if side == "port":
            seqs[-1].solve_device = "cpu"
        seqs.append(seqs[-1].coarsen())
    return mesh, seqs


def _h1(side, mesh, seq, dtype=np.float64):
    rhs, mark, elim = ((jrhs, jmark, jelim) if side == "jax"
                       else (tup.boundary_rhs, tup.mark_dofs_on_bndr,
                             tup.eliminate_rowcols))
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = rhs(seq, 0, {1: -1.0})
    A, b = elim(A, b, mark(seq, 0, {2, 3, 4, 5}), np.zeros(A.shape[0]))
    return A.astype(dtype), b.astype(dtype)


@pytest.fixture(scope="module")
def chains8():
    """The 8^3 chain over 3 levels, JAX and port, host backend."""
    return {side: _chain(side, 8, 3) for side in ("jax", "port")}


@pytest.mark.parametrize("which", ["4^3", "2^3 refined"])
def test_topology_tables_equal(which):
    mj, mt = _mesh(which, jmesh), _mesh(which, tmesh)
    assert _same(mj.vertices, mt.vertices) and _same(mj.elements,
                                                     mt.elements)
    tj, tt = JTopo.from_mesh(mj), TTopo.from_mesh(mt)
    for f in ENTITY_FIELDS:
        assert _same(getattr(tj.entities, f), getattr(tt.entities, f)), f
    for Bj, Bt in zip(tj.B, tt.B):
        assert _same(Bj, Bt)
    assert _same(tj.facet_bdr_attribute, tt.facet_bdr_attribute)
    ne = mj.num_elements
    pj, pt = _partition(which, jpart, ne), _partition(which, tpart, ne)
    assert _same(pj, pt)
    cj, ct = (tj.coarsen_local_partitioning(pj),
              tt.coarsen_local_partitioning(pt))
    for Bj, Bt in zip(cj.B, ct.B):
        assert _same(Bj, Bt)
    for Aj, At in zip(tj.AEntity_entity, tt.AEntity_entity):
        assert _same(Aj, At)
    assert _same(cj.facet_bdr_attribute, ct.facet_bdr_attribute)


def test_fine_sequence_matches_jax(chains8):
    (_, sj), (_, st) = chains8["jax"], chains8["port"]
    for j in range(4):
        assert _rel(st[0].compute_mass_operator(j),
                    sj[0].compute_mass_operator(j)) <= 1e-12, j
    for j in range(3):
        assert _rel(st[0].D[j], sj[0].D[j]) <= 1e-12, j


def _check_coarsening(sj, st, tol):
    for l in range(len(sj) - 1):
        for j in range(4):
            assert sj[l].P[j].shape == st[l].P[j].shape, (l, j)
            assert _rel(st[l].P[j], sj[l].P[j]) <= tol, ("P", l, j)
            assert _rel(st[l].Pi[j].matrix, sj[l].Pi[j].matrix) <= tol, \
                ("Pi", l, j)
            assert _rel(st[l + 1].compute_mass_operator(j),
                        sj[l + 1].compute_mass_operator(j)) <= tol, \
                ("M", l + 1, j)
        for j in range(3):
            assert _rel(st[l + 1].D[j], sj[l + 1].D[j]) <= tol, ("D", l, j)


def test_coarsen_host_4_matches_jax():
    _, sj = _chain("jax", 4, 2)
    _, st = _chain("port", 4, 2)
    _check_coarsening(sj, st, 1e-10)


def test_coarsen_host_8_three_levels_matches_jax(chains8):
    _check_coarsening(chains8["jax"][1], chains8["port"][1], 1e-10)


@pytest.mark.parametrize("n, levels", [(4, 2), (8, 3)])
def test_device_backend_matches_jax_host(n, levels):
    _, sj = _chain("jax", n, levels, "host")
    _, st = _chain("port", n, levels, "device")
    assert generic_lane.first_dim_mismatch(sj, st) is None
    for l in range(levels - 1):
        for j in range(4):
            assert sj[l].P[j].shape == st[l].P[j].shape
            d = abs(sp.csr_matrix(sj[l].P[j]) - st[l].P[j]).max()
            assert d < 5e-5, (l, j, d)


def test_build_amge_hierarchy_levels_match_jax(chains8):
    (mj, sj), (mt, st) = chains8["jax"], chains8["port"]
    Aj, _ = _h1("jax", mj, sj[0])
    At, _ = _h1("port", mt, st[0])
    Hj, Aj_l, Pj_l = jbuild(sj, 0, Aj, sweeps=2)
    Ht, At_l, Pt_l = amge_solver.build_amge_hierarchy(st, 0, At, sweeps=2,
                                                      device="cpu")
    assert len(At_l) == len(Aj_l) == 3
    for a, b in zip(At_l, Aj_l):
        assert _rel(a, b) <= 1e-12
    Hc = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    for lt, lc in zip(Ht.levels, Hc.levels):
        assert type(lt.A).__name__ == type(lc.A).__name__ == "EllMatrix"
        e = torch.eye(lt.A.shape[1], dtype=torch.float64)
        assert _rel(lt.A @ e, lc.A @ e) <= 1e-12


@pytest.fixture(scope="module")
def f32_solvers(chains8):
    (mj, sj), (mt, st) = chains8["jax"], chains8["port"]
    Aj, bj = _h1("jax", mj, sj[0], np.float32)
    At, bt = _h1("port", mt, st[0], np.float32)
    Hj, _, _ = jbuild(sj, 0, Aj, sweeps=2, dtype=np.float32)
    Ht, _, _ = amge_solver.build_amge_hierarchy(st, 0, At, sweeps=2,
                                                dtype=np.float32,
                                                device="cpu")
    return Hj, bj, Ht, bt


def test_vcycle_f32_matches_jax(f32_solvers):
    """The port's cycle and the converted JAX hierarchy's cycle against
    the JAX cycle on the same b."""
    Hj, bj, Ht, bt = f32_solvers
    yj = np.asarray(Hj.apply(jax.numpy.asarray(bj)))
    yt = Ht.apply(torch.as_tensor(bt)).numpy()
    Hc = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    yc = Hc.apply(torch.as_tensor(bj)).numpy()
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    assert _rel(yt, yj) <= 1e-5
    assert _rel(yc, yj) <= 1e-5


def test_amge_pcg_iterations_match_jax(f32_solvers):
    Hj, bj, Ht, bt = f32_solvers
    # in x64 mode the JAX cycle promotes to f64 at the coarse levels
    # (their l1 weights come from f64 RAP products), which its PCG loop
    # carries only from an f64 b
    xj, (itj, _) = jpcg_solve(Hj, Hj.levels[0].A, bj.astype(np.float64),
                              rtol=1e-6)
    xt, (itt, _) = amge_solver.amge_pcg_solve(Ht, Ht.levels[0].A, bt,
                                              rtol=1e-6, device="cpu")
    assert abs(int(itt) - int(itj)) <= 1, (itt, itj)
    assert _rel(xt, np.asarray(xj)) <= 1e-4


def test_amge_solver_refuses_what_is_not_ported(chains8):
    """RCM is ported; what the JAX package refuses (RCM with Hiptmair,
    whose auxiliary derivative is not permuted) and an unknown reorder
    still raise."""
    _, st = chains8["port"]
    I = sp.identity(st[0].dof[0].ndofs, format="csr")
    with pytest.raises(ValueError, match="not permuted"):
        amge_solver.build_amge_hierarchy(st, 1, I, smoother="hiptmair",
                                         device="cpu", reorder="rcm")
    with pytest.raises(ValueError, match="reorder"):
        amge_solver.build_amge_hierarchy(st, 0, I, device="cpu",
                                         reorder="amd")


def test_entry_matches_jax():
    fn_t, args_t = entry.entry(device="cpu")
    yt = fn_t(*args_t).numpy()
    fn_j, args_j = jentry.entry()
    yj = np.asarray(jax.jit(fn_j)(*args_j))
    assert yt.shape == yj.shape == (125,)
    assert _rel(yt, yj) <= 1e-5


def test_lane_generic_on_the_cpu():
    """The lane's record at 8^3 over 3 levels with both backends: equal
    coarse dimensions, the H1 dims of the JAX bench's _build_h1, and the
    solve within one iteration of the host anchor at its rtol."""
    import bench
    rec, (A_levels, P_levels, b, _, _) = generic_lane.lane_generic(
        8, ("host", "device"), device="cpu", min_coarse=8)
    seqs_j, Aj, bj = bench._build_h1(8, min_coarse=8, setup_dtype=None)
    assert rec["dims_agree"] and rec["levels"] == 3
    assert [d[0] for d in rec["dims"]] == [s.dof[0].ndofs for s in seqs_j]
    assert rec["ndofs"] == 729 and _rel(A_levels[0], Aj) <= 1e-6
    assert _rel(b, bj) <= 1e-12
    assert rec["converged"] and abs(rec["iters"] - rec["host_iters"]) <= 1
    assert rec["rel_res"] <= 10 * rec["rtol"]
    assert rec["formats"] == ["EllMatrix"] * 3
    assert set(rec["device_timers"]) >= {"coarsen: ext pass2 solve"}
    assert rec["timer"] == "host_clock"


def test_native_library_builds_and_matches_numpy():
    """The port builds the unedited native/parelag_kernels.cpp into its
    own _build/ and agrees with its numpy path on the fine masses."""
    assert native.available()
    assert "parelag_tpu_torch/_build/" in native._LIB._name
    mesh = tmesh(4, 3, 5)
    seq_n = TSeq(TTopo.from_mesh(mesh), mesh)
    avail = native.available
    native.available = lambda: False
    try:
        seq_p = TSeq(TTopo.from_mesh(mesh), mesh)
    finally:
        native.available = avail
    for key in seq_p.M:
        bn, bp = seq_n.M[key]._cat[2], seq_p.M[key]._cat[2]
        assert np.abs(bn - bp).max() < 1e-13 * max(1.0, np.abs(bp).max())


VERBATIM = ["utils/errors.py", "ops/ragged.py", "ops/csr.py", "mesh/mesh.py",
            "mesh/entities.py", "topology/betti.py", "topology/topology.py",
            "partitioning/partitioners.py", "amge/dofhandler.py",
            "amge/dofagg.py", "amge/localmass.py", "amge/cochain.py",
            "amge/hexfe.py", "amge/tetfe.py", "amge/fespace.py",
            "models/spectral.py", "utils/params.py",
            "models/electric_potential.py", "models/elasticity.py",
            "models/embedded.py", "models/logical_demo.py",
            "topology/coloring.py", "mesh/vtk.py", "amge/fespace2d.py",
            "amge/fespace2d_ho.py", "amge/hexfe_ho.py", "amge/tetfe_ho.py",
            "amge/fespace3d_tet_ho.py", "parallel/patch.py",
            "parallel/dist_partition.py", "parallel/dist_topology.py",
            "parallel/dist_sequence.py", "parallel/dist_coarsen.py",
            "parallel/dist_hierarchy.py"]


def _rewritten(text):
    """A JAX-package source with its imports pointed at the port."""
    return re.sub(r"(?m)^(\s*)from parelag_tpu\.", r"\1from parelag_tpu_torch.",
                  text)


@pytest.mark.parametrize("path", VERBATIM)
def test_copied_module_equals_its_source(path):
    """The host modules are copies: byte for byte the JAX package's once
    its import lines name the port."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "parelag_tpu", path)) as f:
        src = f.read()
    with open(os.path.join(root, "parelag_tpu_torch", path)) as f:
        assert f.read() == _rewritten(src)


@pytest.mark.parametrize("name", ["mark_dofs_on_bndr", "boundary_rhs",
                                  "eliminate_rowcols", "UpscalingResult",
                                  "solve_spd"])
def test_copied_upscaling_helper_equals_its_source(name):
    import inspect
    from parelag_tpu.models import upscaling as jup
    assert inspect.getsource(getattr(tup, name)) == _rewritten(
        inspect.getsource(getattr(jup, name)))


def test_ml_hiptmair_cycle_matches_jax():
    """build_ml_hiptmair on the H(curl) form of the 4^3 chain (f64): the
    same level operators and one cycle within 1e-10."""
    from parelag_tpu.solvers.amge_solver import build_ml_hiptmair as jml
    out = []
    for side in ("jax", "port"):
        _, seqs = _chain(side, 4, 2)
        s = seqs[0]
        A = (s.compute_mass_operator(1)
             + s.D[1].T @ s.compute_mass_operator(2) @ s.D[1]).tocsr()
        if side == "jax":
            H, A_l, _ = jml(seqs, 1, A)
        else:
            H, A_l, _ = amge_solver.build_ml_hiptmair(seqs, 1, A,
                                                      device="cpu")
        out.append((H, A_l))
    (Hj, Aj), (Ht, At) = out
    for a, b in zip(At, Aj):
        assert _rel(a, b) <= 1e-12
    b = np.random.RandomState(0).randn(Aj[0].shape[0])
    yj = np.asarray(Hj.apply(jax.numpy.asarray(b)))
    yt = Ht.apply(torch.as_tensor(b)).numpy()
    assert _rel(yt, yj) <= 1e-10
