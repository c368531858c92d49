"""Parity of the port's multi-RHS path with the JAX package on the CPU:
the plain versions of the multi-RHS DIA kernels against the Pallas
kernels in interpret mode (f32, 1e-5 relative), the 2-D BCSR and TileCoo
products against the JAX formats (f64, 1e-12), and Hierarchy.apply and
block PCG on the 8^3 flagship hierarchy with s = 4 against the JAX ones
(f64: 1e-10 for the cycle, the same iteration count and 1e-8 for PCG).
Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.ops.pallas_kernels import (
    dia_jacobi_sweep_multirhs_pallas, dia_spmv_multirhs_pallas,
    dia_xpad_len)
from parelag_tpu.solvers import hierarchy as jh
from parelag_tpu.solvers.autotune import _factory as jfactory
from parelag_tpu.solvers.cg import pcg as jpcg
from parelag_tpu_torch import convert
from parelag_tpu_torch import flagship as fl
from parelag_tpu_torch.ops import device_sparse as tds
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.solvers import hierarchy as th
from parelag_tpu_torch.solvers.autotune import _factory as tfactory
from parelag_tpu_torch.solvers.cg import pcg as tpcg

torch.set_num_threads(1)

S = 4          # right-hand sides of the hierarchy and PCG checks


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _banded(n):
    """The operator of tests/test_pallas.py: 5 diagonals 0, +-1, +-30."""
    return sp.diags([6.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                     -0.5 * np.ones(n - 30), -0.5 * np.ones(n - 30)],
                    [0, 1, -1, 30, -30]).tocsr().astype(np.float32)


@pytest.mark.parametrize("s", [1, 3, 16])
def test_dia_spmv_multirhs_plain_matches_pallas_interpret(s):
    n = 9000
    A = _banded(n)
    Aj = jds.to_dia(A, dtype=np.float32)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    X = np.random.RandomState(s).randn(n, s).astype(np.float32)
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    xpadT = jnp.zeros((s, xlen), jnp.float32).at[:, lo:lo + n].set(X.T)
    yj = np.asarray(dia_spmv_multirhs_pallas(
        Aj.data, Aj.offs, xpadT, lo, n, interpret=True))[:, :n].T
    At = tds.to_dia(A, dtype=np.float32, device="cpu")
    yt = At @ torch.as_tensor(X)
    assert yt.shape == (n, s) and yt.dtype == torch.float32
    assert _rel(_np(yt), yj) < 1e-5
    assert _rel(_np(hk.dia_spmv_multirhs(At.data, At.offs,
                                         torch.as_tensor(X), n)), yj) < 1e-5


@pytest.mark.parametrize("s", [2, 16])
def test_dia_jacobi_multirhs_plain_matches_pallas_interpret(s):
    n = 9000
    A = _banded(n)
    Aj = jds.to_dia(A, dtype=np.float32)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    rng = np.random.RandomState(s)
    B = rng.randn(n, s).astype(np.float32)
    X0 = rng.randn(n, s).astype(np.float32)
    dinv = (1.0 / np.asarray(np.abs(A).sum(axis=1)).ravel()
            ).astype(np.float32)
    bpadT = jnp.zeros((s, npad), jnp.float32).at[:, :n].set(B.T)
    dpad = jnp.zeros(npad, jnp.float32).at[:n].set(dinv)
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    xpT = jnp.zeros((s, xlen), jnp.float32).at[:, lo:lo + n].set(X0.T)
    xj = np.asarray(dia_jacobi_sweep_multirhs_pallas(
        Aj.data, Aj.offs, xpT, bpadT, dpad, lo, n,
        interpret=True))[:, :n].T
    At = tds.to_dia(A, dtype=np.float32, device="cpu")
    Xt = At.jacobi_sweeps(torch.as_tensor(B), torch.as_tensor(X0),
                          torch.as_tensor(dinv), 1)
    assert Xt.shape == (n, s) and Xt.dtype == torch.float32
    assert _rel(_np(Xt), xj) < 1e-5


def test_dia_multirhs_generic_cases():
    """Above MAX_RHS the fused sweep returns None (JAX's rule: the
    smoother takes its generic path) while the plain matvec still runs;
    a bf16 table with an f32 block promotes to f32, as JAX's shift loop
    does."""
    n = 2000
    A = _banded(n)
    At = tds.to_dia(A, dtype=np.float32, device="cpu")
    X = torch.as_tensor(np.random.RandomState(5).randn(n, 65)
                        .astype(np.float32))
    assert At.jacobi_sweeps(X, X, torch.ones(n), 1) is None
    assert _rel(_np(At @ X), A.astype(np.float64) @ _np(X)) < 1e-6
    Ab = tds.to_dia(A, dtype=torch.bfloat16, device="cpu")
    Y = Ab @ X[:, :3]
    assert Y.dtype == torch.float32
    assert _rel(_np(Y), A.astype(np.float64) @ _np(X[:, :3])) < 1e-2


def _random_transfer(rng, n, m):
    rows = np.repeat(np.arange(n), 3)
    cols = (rows * m // n + rng.randint(-40, 40, size=rows.size)) % m
    return sp.csr_matrix((rng.randn(rows.size), (rows, cols)),
                         shape=(n, m))


@pytest.mark.parametrize("s", [1, 5, 16])
def test_bcsr_and_tilecoo_2d_match_jax(s):
    rng = np.random.RandomState(s)
    A = _random_transfer(rng, 500, 900)
    X = rng.randn(900, s)
    for jm, tm in ((jds.to_bcsr(A, dtype=np.float64),
                    tds.to_bcsr(A, dtype=np.float64, device="cpu")),
                   (jds.to_tilecoo(A, dtype=np.float64),
                    tds.to_tilecoo(A, dtype=np.float64, device="cpu"))):
        yt = tm @ torch.as_tensor(X)
        assert yt.shape == (500, s)
        assert _rel(_np(yt), np.asarray(jm.matvec(jnp.asarray(X)))) < 1e-12
    Bt = tds.to_bcsr(A, dtype=np.float64, device="cpu")
    assert _rel(_np(hk.bcsr_spmv_multirhs(Bt.row_ptr, Bt.col_idx, Bt.values,
                                          torch.as_tensor(X), 500)),
                A @ X) < 1e-12
    # bf16 tiles with an f32 block (the cycle's P @ ec): f32 result
    Bb = tds.to_bcsr(A, dtype=torch.bfloat16, device="cpu")
    yb = Bb @ torch.as_tensor(X.astype(np.float32))
    assert yb.dtype == torch.float32 and _rel(_np(yb), A @ X) < 1e-2


@pytest.fixture(scope="module")
def flagship8():
    """The 8^3 flagship hierarchy (3 levels, DIA operators) in f64,
    built by JAX and by the port from the same scipy matrices."""
    A_levels, P_levels, _ = fl.build_h1_structured(
        8, min_coarse=8, dtype=np.float64, device="cpu")
    Hj = jh.build_hierarchy(A_levels, P_levels, jfactory(fl.CYCLE),
                            dtype=np.float64, matrix_format="dia")
    Ht = th.build_hierarchy(A_levels, P_levels, tfactory(fl.CYCLE, "cpu"),
                            dtype=np.float64, matrix_format="dia",
                            device="cpu")
    Hc = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    return A_levels, Hj, Ht, Hc


def test_hierarchy_apply_multirhs_matches_jax(flagship8):
    A_levels, Hj, Ht, Hc = flagship8
    assert len(Ht.levels) == 3
    assert [type(l.A).__name__ for l in Ht.levels] == ["DiaMatrix"] * 3
    X = np.random.RandomState(6).randn(A_levels[0].shape[0], S)
    yj = np.asarray(Hj.apply(jnp.asarray(X)))
    for H in (Ht, Hc):
        yt = H.apply(torch.as_tensor(X))
        assert yt.shape == X.shape
        assert _rel(_np(yt), yj) < 1e-10
    # each column of the block cycle is the 1-RHS cycle of that column
    y1 = Ht.apply(torch.as_tensor(X[:, 2].copy()))
    assert _rel(_np(y1), yj[:, 2]) < 1e-10


def test_block_pcg_matches_jax(flagship8):
    A_levels, Hj, Ht, _ = flagship8
    B = np.random.RandomState(7).randn(A_levels[0].shape[0], S)
    Xj, (itj, _) = jax.jit(lambda bb: jpcg(
        lambda v: Hj.levels[0].A @ v, bb, precond=Hj.apply, rtol=1e-8,
        atol=0.0, maxiter=50))(jnp.asarray(B))
    Xt, (itt, nom) = tpcg(Ht.levels[0].A.matvec, torch.as_tensor(B),
                          precond=Ht.apply, rtol=1e-8, atol=0.0,
                          maxiter=50)
    assert nom.shape == (S,)
    assert itt == int(itj) and itt < 50
    assert _rel(_np(Xt), np.asarray(Xj)) < 1e-8
    assert _rel(A_levels[0] @ _np(Xt), B) < 1e-6


def test_bf16_block_cycle_keeps_dtypes(flagship8):
    """The flagship's bf16 preconditioner on a block: bf16 in, bf16 out,
    the f32 coarse inverse and bf16 ELL transfers mixed as in the 1-RHS
    cycle, and within bf16 rounding of the f64 block cycle."""
    A_levels, Hj, Ht, _ = flagship8
    Hb = Ht.cast(torch.bfloat16)
    X = np.random.RandomState(8).randn(A_levels[0].shape[0], S)
    yb = Hb.apply(torch.as_tensor(X).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16 and yb.shape == X.shape
    assert _rel(_np(yb), np.asarray(Hj.apply(jnp.asarray(X)))) < 3e-2
