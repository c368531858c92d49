"""The port's flagship slice against the JAX bench on the CPU, at
nx=16, min_coarse=64 (3 levels: 17^3 / 9^3 / 5^3): the same A_levels,
P_levels and b (1e-10 relative in f64), and the f32 PCG with the bf16
V-cycle preconditioner within one iteration of the JAX lane's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bench
from parelag_tpu.models.upscaling import eliminate_rowcols
from parelag_tpu.solvers.autotune import _factory as jfactory
from parelag_tpu.solvers.cg import pcg as jpcg
from parelag_tpu.solvers.hierarchy import build_hierarchy as jbuild
from parelag_tpu_torch import flagship as fl

torch.set_num_threads(1)

NX, MIN_COARSE = 16, 64


def _sprel(A, B):
    D = (A - B).tocsr()
    return (np.abs(D.data).max() if D.nnz else 0.0) / np.abs(B.data).max()


def test_operators_match_jax_bench_f64():
    Aj, Pj, bj = bench._build_h1_structured(NX, MIN_COARSE,
                                            dtype=np.float64)
    At, Pt, bt = fl.build_h1_structured(NX, MIN_COARSE, dtype=np.float64,
                                        device="cpu")
    assert [a.shape for a in At] == [(17 ** 3,) * 2, (9 ** 3,) * 2,
                                     (5 ** 3,) * 2]
    assert [a.shape for a in At] == [a.shape for a in Aj]
    for a, b in zip(At, Aj):
        assert _sprel(a, b) < 1e-10
    for p, q in zip(Pt, Pj):
        assert p.shape == q.shape and _sprel(p, q) < 1e-10
    assert np.abs(bt - bj).max() <= 1e-10 * np.abs(bj).max()


def test_pcg_iterations_match_jax_lane_f32():
    """The flagship's f32 build, its bf16-cast hierarchy and the r.z
    stop at rtol 1e-5: iterations within +-1 of the JAX lane's, and the
    host-checked residual at the f32 floor."""
    Aj, Pj, bj = bench._build_h1_structured(NX, MIN_COARSE)
    Hj = jbuild(Aj, Pj, jfactory(fl.CYCLE), mu=1, dtype=np.float32,
                matrix_format="dia", transfer_dtype=jnp.bfloat16)
    Hjb = Hj.cast(jnp.bfloat16)

    @jax.jit
    def jsolve(bb):
        def precond(r):
            return Hjb.apply(r.astype(jnp.bfloat16)).astype(jnp.float32)
        return jpcg(lambda v: Hj.levels[0].A @ v, bb, precond=precond,
                    rtol=1e-5, atol=0.0, maxiter=100)

    _, (itj, _) = jsolve(jnp.asarray(bj.astype(np.float32)))

    At, Pt, bt = fl.build_h1_structured(NX, MIN_COARSE, device="cpu")
    H, Hb = fl.build_solver(At, Pt, "cpu")
    assert [type(l.A).__name__ for l in H.levels] == ["DiaMatrix"] * 3
    assert Hb.levels[-1].coarse_inv.dtype == torch.float32
    x, (it, _) = fl.solve(H, Hb, torch.as_tensor(bt.astype(np.float32)))
    assert 0 < it < 100
    assert abs(it - int(itj)) <= 1
    xh = x.double().numpy()
    b64 = bt.astype(np.float64)
    rel = np.linalg.norm(b64 - At[0].astype(np.float64) @ xh) / \
        np.linalg.norm(b64)
    assert rel < 1e-4


def test_host_anchor_matches_bench():
    At, Pt, bt = fl.build_h1_structured(8, min_coarse=8,
                                        dtype=np.float64, device="cpu")
    xj, itj = bench._host_vcycle_pcg(At, Pt, bt, rtol=1e-8)
    xt, itt = fl.host_vcycle_pcg(At, Pt, bt, rtol=1e-8)
    assert itt == itj
    np.testing.assert_array_equal(xt, xj)


def test_eliminate_rowcols_and_levels():
    rng = np.random.RandomState(0)
    A = sp.random(40, 40, density=0.2, random_state=rng)
    A = (A + A.T + 10 * sp.identity(40)).tocsr()
    b = rng.randn(40)
    marker = rng.rand(40) < 0.3
    vals = rng.randn(40)
    Aj, bj = eliminate_rowcols(A, b, marker, vals)
    At, bt = fl.eliminate_rowcols(A, b, marker, vals)
    assert abs(At - Aj).max() == 0.0
    np.testing.assert_array_equal(bt, bj)
    assert fl.n_levels(96) == 4            # 97^3 / 49^3 / 25^3 / 13^3
    assert fl.n_levels(NX, MIN_COARSE) == 3


def test_lane_h1_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        fl.lane_h1(8, "cpu")
