"""Parity of the port's device formats and plain kernel versions with the
JAX package on the CPU: each plain version against the Pallas kernel in
interpret mode (DIA SpMV, fused Jacobi sweep) or, for BCSR, which has no
interpret mode, against BcsrMatrix.matvec and the einsum reference of
tests/test_pallas.py.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.ops.pallas_kernels import (
    dia_jacobi_sweep_pallas, dia_spmv_pallas, dia_xpad_len)
from parelag_tpu_torch import convert
from parelag_tpu_torch.ops import device_sparse as tds
from parelag_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(1)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _banded(n, dtype):
    """The operator of tests/test_pallas.py: 5 diagonals 0, +-1, +-30."""
    return sp.diags([6.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                     -0.5 * np.ones(n - 30), -0.5 * np.ones(n - 30)],
                    [0, 1, -1, 30, -30]).tocsr().astype(dtype)


# tolerance per table dtype: f32 sums in the same order (f32 rounding of
# the sum only); bf16 — the Pallas kernel sums in bf16 and the port in
# f32, so a few bf16 roundings (2^-8 each) separate them
_TOL = {np.float32: 1e-6, jnp.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_spmv_plain_matches_pallas_interpret(dtype):
    n = 9000
    A = _banded(n, np.float32)
    Aj = jds.to_dia(A, dtype=dtype)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    xpad = jnp.zeros(xlen, dtype).at[lo:lo + n].set(x.astype(dtype))
    yj = np.asarray(dia_spmv_pallas(Aj.data, Aj.offs, xpad, lo, n,
                                    interpret=True)[:n], dtype=np.float64)
    tdt = tds.as_torch_dtype(dtype)
    At = tds.to_dia(A, dtype=tdt, device="cpu")
    assert At.offs == Aj.offs
    yt = At @ torch.as_tensor(x).to(tdt)
    assert yt.dtype == tdt
    assert _rel(_np(yt), yj) < _TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_jacobi_sweep_plain_matches_pallas_interpret(dtype):
    n = 9000
    A = _banded(n, np.float32)
    Aj = jds.to_dia(A, dtype=dtype)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    rng = np.random.RandomState(0)
    b = rng.randn(n).astype(np.float32)
    x0 = rng.randn(n).astype(np.float32)
    dinv = (1.0 / np.asarray(np.abs(A).sum(axis=1)).ravel()
            ).astype(np.float32)
    bpad = jnp.zeros(npad, dtype).at[:n].set(b.astype(dtype))
    dpad = jnp.zeros(npad, dtype).at[:n].set(dinv.astype(dtype))
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    xpad = jnp.zeros(xlen, dtype).at[lo:lo + n].set(x0.astype(dtype))
    xj = np.asarray(dia_jacobi_sweep_pallas(
        Aj.data, Aj.offs, xpad, bpad, dpad, lo, n, interpret=True)[:n],
        dtype=np.float64)
    tdt = tds.as_torch_dtype(dtype)
    At = tds.to_dia(A, dtype=tdt, device="cpu")
    xt = At.jacobi_sweeps(torch.as_tensor(b).to(tdt),
                          torch.as_tensor(x0).to(tdt),
                          torch.as_tensor(dinv), 1)
    assert xt.dtype == tdt
    assert _rel(_np(xt), xj) < _TOL[dtype]


def test_dia_rectangular_matches_scipy():
    """Wide/narrow operators (offsets past the row span) on the plain
    path, f64 (1e-12: same products, different summation order)."""
    rng = np.random.RandomState(3)
    for n, m in ((300, 420), (420, 300)):
        A = sp.random(n, m, density=0.02, random_state=rng, format="csr")
        D = tds.to_dia(A, dtype=np.float64, device="cpu")
        x = rng.randn(m)
        assert _rel(_np(D @ torch.as_tensor(x)), A @ x) < 1e-12
        assert D.offs == tuple(int(o) for o in jds.to_dia(A).offs)
        assert tds.dia_n_offsets(A) == jds.dia_n_offsets(A)


def test_dia_table_matches_jax():
    A = _banded(5000, np.float32)
    Aj = jds.to_dia(A, dtype=np.float32)
    At = tds.to_dia(A, dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(_np(At.data),
                                  np.asarray(Aj.data)[:, :5000])
    np.testing.assert_allclose(tds.l1_row_weights(A),
                               jds.l1_row_weights(A))


def _random_transfer(rng, n, m):
    """A thin P-like operator: 2-4 entries per row, spread columns."""
    rows = np.repeat(np.arange(n), 3)
    cols = (rows * m // n + rng.randint(-40, 40, size=rows.size)) % m
    return sp.csr_matrix((rng.randn(rows.size), (rows, cols)),
                         shape=(n, m))


def _tile_nonzeros(Bj):
    """The nonzeros of a JAX BcsrMatrix's tiles in (row, column) order:
    (row_ptr, col_idx, values) as numpy."""
    tiles = np.asarray(Bj.tiles)
    rb, k, r, c = np.nonzero(tiles)
    rows = rb * 8 + r
    cols = np.asarray(Bj.col_blocks)[rb, k].astype(np.int64) * 128 + c
    order = np.lexsort((cols, rows))
    counts = np.bincount(rows, minlength=Bj.shape[0])
    return (np.concatenate([[0], np.cumsum(counts)]), cols[order],
            tiles[rb, k, r, c][order])


def _assert_buffers(Bt, row_ptr, col_idx, values):
    np.testing.assert_array_equal(Bt.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(Bt.col_idx.numpy(), col_idx)
    np.testing.assert_array_equal(_np(Bt.values), values)
    assert Bt.row_ptr.dtype == Bt.col_idx.dtype == torch.int32


@pytest.mark.parametrize("shape", [(300, 700), (1000, 129)])
def test_bcsr_plain_matches_jax_matvec(shape):
    """The port's compact buffers hold exactly the nonzeros of the JAX
    tiles, in row order, and no tiles."""
    rng = np.random.RandomState(1)
    A = _random_transfer(rng, *shape)
    Bj = jds.to_bcsr(A, dtype=np.float64)
    Bt = tds.to_bcsr(A, dtype=np.float64, device="cpu")
    _assert_buffers(Bt, *_tile_nonzeros(Bj))
    assert not hasattr(Bt, "tiles")
    assert {n for n, _ in Bt.named_buffers()} == {"row_ptr", "col_idx",
                                                   "values"}
    assert (Bt.shape, Bt.padded) == (Bj.shape, Bj.padded)
    assert (Bt.nbr, Bt.kb) == tuple(Bj.col_blocks.shape)
    assert tds.bcsr_stats(A) == jds.bcsr_stats(A)
    x = rng.randn(shape[1])
    yj = np.asarray(Bj.matvec(jnp.asarray(x)))
    assert _rel(_np(Bt @ torch.as_tensor(x)), yj) < 1e-12
    # bf16 values with an f32 x (the cycle's P @ ec mix): f32 result,
    # within 2^-8 of the JAX product on bf16 tiles (the same bf16 values,
    # summed in another order) and within bf16 rounding of A @ x
    Btb = tds.to_bcsr(A, dtype=torch.bfloat16, device="cpu")
    xf = x.astype(np.float32)
    yb = Btb @ torch.as_tensor(xf)
    assert yb.dtype == torch.float32
    yjb = np.asarray(jds.to_bcsr(A, dtype=jnp.bfloat16).matvec(
        jnp.asarray(xf)))
    assert _rel(_np(yb), yjb) < 2.0 ** -8
    assert _rel(_np(yb), A @ x) < 1e-2


def test_bcsr_plain_matches_einsum_reference():
    """The reference of tests/test_pallas.py:52 on random tiles and
    column blocks (a block may repeat within a row block), through the
    tiles constructor, f64 (1e-12)."""
    rng = np.random.RandomState(0)
    cb = rng.randint(0, 4, size=(16, 3)).astype(np.int32)
    tiles = rng.randn(16, 3, 8, 128)
    x = rng.randn(4 * 128)
    ref = np.einsum("nkrc,nkc->nr", tiles,
                    x.reshape(4, 128)[cb]).reshape(-1)
    B = tds.BcsrMatrix.from_tiles(torch.as_tensor(cb),
                                  torch.as_tensor(tiles), (128, 512),
                                  (128, 512))
    # the nonzeros of the tiles, a repeated block's columns counted once
    assert B.values.numel() == sum(len({int(b) for b in row}) * 128
                                   for row in cb) * 8
    y = hk.bcsr_spmv(B.row_ptr, B.col_idx, B.values, torch.as_tensor(x),
                     16 * 8)
    assert _rel(_np(y), ref) < 1e-12
    assert _rel(_np(B @ torch.as_tensor(x)), ref) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bcsr_convert_matches_to_bcsr(dtype):
    """convert._matrix of a JAX BcsrMatrix gives the buffers and the
    product of to_bcsr on the same scipy matrix."""
    rng = np.random.RandomState(5)
    A = _random_transfer(rng, 450, 1000)
    Bj = jax.tree_util.tree_map(np.asarray, jds.to_bcsr(A, dtype=dtype))
    Bc = convert._matrix(Bj, "cpu")
    Bt = tds.to_bcsr(A, dtype=dtype, device="cpu")
    _assert_buffers(Bc, Bt.row_ptr.numpy(), Bt.col_idx.numpy(),
                    _np(Bt.values))
    assert (Bc.shape, Bc.padded, Bc.nbr, Bc.kb, Bc.group) == \
        (Bt.shape, Bt.padded, Bt.nbr, Bt.kb, Bt.group)
    x = torch.as_tensor(rng.randn(1000).astype(dtype))
    np.testing.assert_array_equal(_np(Bc @ x), _np(Bt @ x))


@pytest.mark.parametrize("per_row,group", [(0, 2), (1, 2), (3, 4),
                                           (26, 16), (30, 16), (200, 16)])
def test_bcsr_group_width(per_row, group):
    """Lanes per row of the 1-RHS kernel: the power of two that covers
    the mean nonzeros per row, from 2 up to 16."""
    n, m = 40, 600
    rng = np.random.RandomState(per_row)
    cols = np.stack([rng.choice(m, per_row, replace=False)
                     for _ in range(n)]).ravel()
    A = sp.csr_matrix((np.ones(n * per_row),
                       (np.repeat(np.arange(n), per_row), cols)),
                      shape=(n, m))
    B = tds.to_bcsr(A, dtype=np.float64, device="cpu")
    assert B.values.numel() == n * per_row
    assert hk.group_width(n * per_row, n) == B.group == group


def test_tilecoo_and_ell_match_jax():
    rng = np.random.RandomState(2)
    A = _random_transfer(rng, 500, 900)
    x = rng.randn(900)
    for jm, tm in ((jds.to_tilecoo(A, dtype=np.float64),
                    tds.to_tilecoo(A, dtype=np.float64, device="cpu")),
                   (jds.from_scipy(A, dtype=np.float64),
                    tds.from_scipy(A, dtype=np.float64, device="cpu"))):
        assert _rel(_np(tm @ torch.as_tensor(x)),
                    np.asarray(jm @ jnp.asarray(x))) < 1e-12
    T = tds.to_tilecoo(A, dtype=torch.bfloat16, device="cpu")
    assert T.dtype == torch.bfloat16
    assert (T @ torch.as_tensor(x).to(torch.bfloat16)).dtype == \
        torch.bfloat16


def test_formats_cast_floating_buffers_only():
    A = _random_transfer(np.random.RandomState(4), 64, 300)
    for M in (tds.to_bcsr(A, device="cpu"), tds.to_tilecoo(A, device="cpu"),
              tds.from_scipy(A, device="cpu"), tds.to_dia(A, device="cpu")):
        Mb = M.to(torch.bfloat16)
        assert Mb.dtype == torch.bfloat16
        for name, buf in Mb.named_buffers():
            if name in ("col_blocks", "row_blocks", "indices", "row_ptr",
                        "col_idx"):
                assert buf.dtype == torch.int32
