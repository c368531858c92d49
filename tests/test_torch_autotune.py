"""Parity of the port's Chebyshev smoother and cycle autotune with the
JAX package on the CPU (solvers/smoothers.py, solvers/autotune.py), and
the flagship's cycle_cfg and autotune lane on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.solvers import autotune as jat
from parelag_tpu.solvers import smoothers as jsm
from parelag_tpu_torch import flagship
from parelag_tpu_torch.ops import device_sparse as tds
from parelag_tpu_torch.solvers import autotune as tat
from parelag_tpu_torch.solvers import smoothers as tsm

torch.set_num_threads(1)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _operator(n=9):
    """A 27-point-like SPD operator on an n^3 grid (DIA-friendly)."""
    T = sp.diags([4 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    I = sp.identity(n)
    return (sp.kron(sp.kron(T, T), I) + sp.kron(sp.kron(I, T), T)
            + sp.kron(sp.kron(T, I), T)).tocsr()


@pytest.fixture(scope="module")
def structured():
    """The flagship's structured hierarchy at 8^3 (3 levels), host
    matrices in f32 as build_h1_structured returns them."""
    return flagship.build_h1_structured(8, min_coarse=8, device="cpu")


def test_estimate_lmax_is_the_jax_power_iteration():
    A = _operator()
    d = 1.0 / A.diagonal()
    assert tsm.estimate_lmax(A, d) == jsm.estimate_lmax(A, d)
    assert tsm.estimate_lmax(A, d, iters=7, seed=3) == \
        jsm.estimate_lmax(A, d, iters=7, seed=3)


@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_chebyshev_apply_matches_jax(degree, fmt):
    """make_chebyshev's coefficients, and one apply on 1 and 3 columns,
    within 1e-12 in f64 (DIA: the dia_spmv residuals of the port)."""
    A = _operator()
    sj = jsm.make_chebyshev(A, degree=degree)
    st = tsm.make_chebyshev(A, degree=degree, device="cpu")
    assert st.coeffs == sj.coeffs
    assert _rel(st.dinv.numpy(), np.asarray(sj.dinv)) == 0.0
    if fmt == "dia":
        Aj = jds.to_dia(A, dtype=np.float64)
        At = tds.to_dia(A, dtype=np.float64, device="cpu")
    else:
        Aj = jds.from_scipy(A, dtype=np.float64)
        At = tds.from_scipy(A, dtype=np.float64, device="cpu")
    rng = np.random.RandomState(degree)
    for shape in ((A.shape[0],), (A.shape[0], 3)):
        b, x = rng.randn(*shape), rng.randn(*shape)
        yt = st.apply(At, torch.as_tensor(b), torch.as_tensor(x))
        yj = sj.apply(Aj, jnp.asarray(b), jnp.asarray(x))
        assert _rel(yt.numpy(), yj) <= 1e-12


def test_chebyshev_factory_and_cast(structured):
    """The 'chebyshev' branch of _factory and Hierarchy.cast: the bf16
    copy casts dinv like l1-Jacobi's weights; the cycle keeps mu."""
    A_levels, P_levels, _ = structured
    cfg = dict(mu=2, smoother="chebyshev", degree=2)
    H, Hb = flagship.build_solver(A_levels, P_levels, "cpu", cfg)
    assert H.mu == Hb.mu == 2
    pre = [l.pre for l in Hb.levels if l.pre is not None]
    assert pre and all(isinstance(s, tsm.ChebyshevSmoother) for s in pre)
    assert all(s.dinv.dtype == torch.bfloat16 and s.coeffs[2] == 2
               for s in pre)
    assert H.levels[0].pre.dinv.dtype == torch.float32
    with pytest.raises(ValueError, match="gauss_seidel"):
        tat._factory(dict(smoother="gauss_seidel"), "cpu")


@pytest.mark.parametrize("precond", [None, "bf16"])
def test_tune_cycle_rows_match_jax(structured, precond):
    """tune_cycle's DEFAULT_GRID on the 8^3 structured hierarchy (DIA
    operators, f32): every row's iterations and converged flag equal
    the JAX package's; the winner is not compared (its times are the
    machine's).  With the bf16 preconditioner the port sums its DIA
    products in f32 (ROADMAP divergences), so iterations may differ by
    one there."""
    A_levels, P_levels, b = structured
    kw = dict(rtol=1e-5, dtype=np.float32, matrix_format="dia")
    bj, tj = jat.tune_cycle(A_levels, P_levels, b, repeats=1,
                            precond_dtype=jnp.bfloat16 if precond else None,
                            **kw)
    bt, tt = tat.tune_cycle(A_levels, P_levels, b, repeats=1,
                            precond_dtype=torch.bfloat16 if precond else None,
                            device="cpu", **kw)
    slack = 1 if precond else 0
    assert [r["cfg"] for r in tt] == [r["cfg"] for r in tj]
    for rt, rj in zip(tt, tj):
        assert abs(rt["iters"] - rj["iters"]) <= slack, (rt, rj)
        assert rt["converged"] == rj["converged"], (rt, rj)
        assert rt["iters"] > 1 and rt["converged"]
    assert bt is not None and "hierarchy" in bt
    assert sum("hierarchy" in r for r in tt) == 1


def test_lane_autotune_on_the_cpu():
    """lane_autotune(16): the structured and the two generic
    granularities' rows (every DEFAULT_GRID cfg each) and the JAX
    record's fields."""
    rec = flagship.lane_autotune(16, device="cpu", repeats=1)
    grans = [r["granularity"] for r in rec["grid"]]
    assert grans == (["structured-2x2x2"] * 6 + ["2x2x2"] * 6
                     + ["4x4x4"] * 6)
    for k in ("best_structured_cfg", "best_cfg", "best_granularity",
              "iters", "solve_s", "value", "setup_s", "tune_s"):
        assert k in rec, k
    assert rec["best_cfg"] in list(tat.DEFAULT_GRID)
    assert all(r["converged"] for r in rec["grid"])
