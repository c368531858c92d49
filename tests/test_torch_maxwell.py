"""Parity of the port's Maxwell lane with the JAX package on the CPU: the
ELL plain version against ell_spmv_pallas in interpret mode (f32, 1e-5
relative); the structured Maxwell pieces at shape (4, 4, 4) in f64
(1e-12); the Hiptmair smoother and the lane's hierarchy after convert
(f64, 1e-10); and maxwell_lane.lane_maxwell(4) against
bench.lane_maxwell(4), which runs the structured branch in f32 (x64 off):
first solve within one iteration, the total within two, both under the
lane's rtol of 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bench
from parelag_tpu.amge import structured as jst
from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.ops.pallas_kernels import ell_spmv_pallas
from parelag_tpu.solvers import hierarchy as jh
from parelag_tpu.solvers import smoothers as jsm
from parelag_tpu.solvers.cg import pcg as jpcg
from parelag_tpu_torch import convert
from parelag_tpu_torch import maxwell_lane as ml
from parelag_tpu_torch.amge import structured as tst
from parelag_tpu_torch.ops import device_sparse as tds
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.solvers import hierarchy as th
from parelag_tpu_torch.solvers import smoothers as tsm

torch.set_num_threads(1)

SHAPE = (4, 4, 4)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _sprel(A, B):
    D = (A - B).tocsr()
    return (np.abs(D.data).max() if D.nnz else 0.0) / np.abs(B.data).max()


@pytest.mark.parametrize("shape", [(512, 300), (768, 45)])
def test_ell_plain_matches_pallas_interpret(shape):
    """Rows a multiple of the Pallas tile (256), as the kernel needs."""
    rng = np.random.RandomState(shape[1])
    A = sp.random(*shape, density=0.05, random_state=rng, format="csr")
    A = (A + sp.eye(*shape)).tocsr().astype(np.float32)
    Ej = jds.from_scipy(A, dtype=np.float32)
    x = rng.randn(shape[1]).astype(np.float32)
    yj = np.asarray(ell_spmv_pallas(Ej.indices, Ej.values, jnp.asarray(x),
                                    interpret=True))
    Et = tds.from_scipy(A, dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(Et.indices.numpy(), np.asarray(Ej.indices))
    yt = Et @ torch.as_tensor(x)
    assert yt.dtype == torch.float32
    assert _rel(_np(yt), yj) < 1e-5
    assert _rel(_np(hk.ell_spmv(Et.indices, Et.values, torch.as_tensor(x))),
                yj) < 1e-5


def test_ell_2d_matches_jax():
    rng = np.random.RandomState(1)
    A = sp.random(300, 200, density=0.05, random_state=rng, format="csr")
    X = rng.randn(200, 7)
    yj = np.asarray(jds.from_scipy(A, dtype=np.float64) @ jnp.asarray(X))
    yt = tds.from_scipy(A, dtype=np.float64, device="cpu") @ \
        torch.as_tensor(X)
    assert yt.shape == (300, 7) and _rel(_np(yt), yj) < 1e-12


@pytest.fixture(scope="module")
def chains():
    jl, jo = jst.coarsen_chain(jst.fine_level(SHAPE), 2, jform_start=0)
    tl, to = tst.coarsen_chain(tst.fine_level(SHAPE, device="cpu"), 2)
    return (jl, jo), (tl, to)


@pytest.mark.parametrize("piece", [
    "global_mass_1", "global_mass_2", "global_derivative_0",
    "global_derivative_1", "materialize_P_1"])
def test_maxwell_pieces_match_jax(chains, piece):
    (jl, jo), (tl, to) = chains
    name, form = piece.rsplit("_", 1)
    form = int(form)
    for l in range(2 if name != "materialize_P" else 1):
        if name == "materialize_P":
            Mj = jst.materialize_P(jo[l], jl[l].shape, form)
            Mt = tst.materialize_P(to[l], tl[l].shape, form)
        else:
            Mj = getattr(jst, name)(jl[l], form)
            Mt = getattr(tst, name)(tl[l], form)
        assert Mt.shape == Mj.shape and Mt.nnz == Mj.nnz, (piece, l)
        assert _sprel(Mt, Mj) < 1e-12, (piece, l)


@pytest.mark.parametrize("jform", [0, 1, 2])
def test_boundary_entity_marker_matches_jax(jform):
    for shape in (SHAPE, (3, 5, 2)):
        np.testing.assert_array_equal(
            tst.boundary_entity_marker(shape, jform),
            jst.boundary_entity_marker(shape, jform))


@pytest.fixture(scope="module")
def maxwell4():
    """The lane's host matrices at 4^3 (port) and the JAX hierarchy built
    from them in f64, with the Hiptmair smoother on level 0."""
    A, b, A_levels, P_levels, D0 = ml.build_maxwell(4, device="cpu")
    A64 = [a.astype(np.float64) for a in A_levels]
    Hj = jh.build_hierarchy(A64, P_levels,
                            lambda A_l, l: jsm.make_hiptmair(A_l, D0[l]),
                            dtype=np.float64)
    return A, b, A64, P_levels, D0, Hj


def test_build_maxwell_shapes(maxwell4):
    A, b, A64, P_levels, D0, _ = maxwell4
    assert A.shape == (300, 300) and b.shape == (300,)
    assert [a.shape[0] for a in A64] == [300, 54]
    assert P_levels[0].shape == (300, 54)
    assert [d.shape for d in D0] == [(300, 125), (54, 27)]
    # the eliminated boundary edges are identity-like rows of A
    marker = tst.boundary_entity_marker(SHAPE, 1)
    assert abs(A[marker][:, ~marker]).max() == 0.0


def test_hiptmair_apply_matches_jax(maxwell4):
    A, b, A64, P_levels, D0, Hj = maxwell4
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    smj, smt = Hj.levels[0].pre, Ht.levels[0].pre
    assert type(smt).__name__ == "HiptmairSmoother"
    assert type(smt.D).__name__ == "EllMatrix"
    rng = np.random.RandomState(2)
    bb, x0 = rng.randn(300), rng.randn(300)
    yj = np.asarray(smj.apply(Hj.levels[0].A, jnp.asarray(bb),
                              jnp.asarray(x0)))
    yt = smt.apply(Ht.levels[0].A, torch.as_tensor(bb), torch.as_tensor(x0))
    assert _rel(_np(yt), yj) < 1e-10
    # the port's own make_hiptmair builds the same smoother
    own = tsm.make_hiptmair(A64[0], D0[0], device="cpu")
    assert _rel(_np(own.apply(Ht.levels[0].A, torch.as_tensor(bb),
                              torch.as_tensor(x0))), yj) < 1e-10
    # and the whole 2-level cycle agrees
    r = rng.randn(300)
    assert _rel(_np(Ht.apply(torch.as_tensor(r))),
                np.asarray(Hj.apply(jnp.asarray(r)))) < 1e-10
    Hp = th.build_hierarchy(
        A64, P_levels, lambda A_l, l: tsm.make_hiptmair(A_l, D0[l],
                                                        device="cpu"),
        dtype=np.float64, device="cpu")
    assert _rel(_np(Hp.apply(torch.as_tensor(r))),
                np.asarray(Hj.apply(jnp.asarray(r)))) < 1e-10


def test_lane_maxwell_matches_jax_bench(maxwell4):
    A, b, A64, P_levels, D0, _ = maxwell4
    rec, _ = ml.lane_maxwell(4, device="cpu")
    with jax.enable_x64(False):
        rj = bench.lane_maxwell(4)
        # the JAX lane's first f32 solve, on the same host matrices
        Hj32 = jh.build_hierarchy(
            [A.astype(np.float32), A64[1]], P_levels,
            lambda A_l, l: jsm.make_hiptmair(A_l, D0[l]), dtype=np.float32)
        _, (itj, _) = jax.jit(lambda bb: jpcg(
            lambda v: Hj32.levels[0].A @ v, bb, precond=Hj32.apply,
            rtol=1e-6, atol=0.0, maxiter=200))(
                jnp.asarray(b.astype(np.float32)))
    assert rec["ndofs"] == rj["ndofs"] == 300
    assert rec["level_shapes"] == [300, 54]
    assert abs(rec["first_iters"] - int(itj)) <= 1, (rec, int(itj))
    assert abs(rec["iters"] - rj["iters"]) <= 2, (rec, rj)
    assert rec["rel_res"] < 1e-6 and rj["rel_res"] < 1e-6
    assert "rel_res_floor" not in rec
    assert rec["timer"] == "host_clock"
    assert set(rec["kernels"].values()) == {0}
