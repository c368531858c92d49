"""The plan and index math of the 1-RHS DIA kernels (csrc/dia.cu
dia_spmv_row_kernel, dia_jacobi_row_kernel), on the CPU.
hopper_kernels.dia_row_plan decides every layout the kernels take (T
threads a block, a row each; the tile's table rows and x windows staged
in shared memory, or x read from global memory), so these tests hold the
plan to its numbers on the flagship grids and to its invariants on
random offsets, and emulate the kernels block by block from the plan in
numpy: each table row staged in 16-byte chunks from the boundary at or
below its entry for the tile's first row (zeros past the table's end),
the windows staged in 16-byte chunks with zeros outside [0, m), and the
sums in offset order in f32 (f64 for f64), each entry found at its
row's 16-byte shift.  The tensors may start anywhere on their element
size: the emulation places each one `lead` elements past a 16-byte
boundary, with NaN before and after it, and stages from the boundary.  The emulation is held against the plain versions
(f32 and bf16 within 1e-6 relative in f32: the same products in the same
order; f64 within 1e-12) and against the Pallas kernels in interpret
mode (f32 1e-6, bf16 1e-2: see PALLAS_TOL).  Inputs come from numpy
seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.ops.pallas_kernels import (
    dia_jacobi_sweep_pallas, dia_spmv_pallas, dia_xpad_len)
from parelag_tpu_torch import darcy_lane
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import to_dia

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
SIZES = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6, torch.float64: 1e-12}
# against the Pallas kernels: f32 1e-6; a bf16 table and x within 1e-2
# of the Pallas kernels run in f32 on their widened values (the same
# function; only the output's bf16 rounding differs), and within 3e-2 of
# the Pallas kernels in bf16, which also round every partial sum to bf16
# (tests/test_torch_device_sparse.py's bf16 limit)
PALLAS_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
PALLAS_BF16_SUM_TOL = 3e-2
# the 29 offsets of the darcy_hyb path's DIA part at 16^3
# (HybridHdivL2._device_setup on the permuted multiplier system)
DARCY16_OFFS = (-736, -735, -734, -731, -688, -48, -47, -46, -43, -5, -4,
                -3, -2, -1, 0, 1, 2, 3, 4, 5, 43, 46, 47, 48, 688, 731, 734,
                735, 736)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _grid_offs(k):
    """The 27 offsets of a 27-point stencil on a k^3 grid of points."""
    return tuple(sorted(a * k * k + b * k + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


def _grid27(k):
    t = sp.diags([np.ones(k - 1), np.ones(k), np.ones(k - 1)], [-1, 0, 1])
    A = sp.kron(sp.kron(t, t), t).tocsr()
    A.data = np.random.RandomState(k).rand(A.nnz) + 0.5
    return A


def _diags(offs, n, m=None, seed=0):
    """An n x m operator with full diagonals at `offs` and a dominant
    diagonal 0 (where it is one of them)."""
    m = n if m is None else m
    rng = np.random.RandomState(seed)
    A = sp.diags([rng.rand(max(0, min(n, m - o) - max(0, -o))) - 0.5
                  for o in offs], offs, shape=(n, m)).tocsr()
    if 0 in offs:
        A.setdiag(len(offs) + 1.0)
    return A


def _spread(nd, spread, n, m=None):
    rng = np.random.RandomState(nd)
    offs = sorted(rng.choice(np.arange(-spread, spread), nd,
                             replace=False).tolist())
    return _diags(tuple(offs), n, m, nd)


CASES = {
    "grid9": lambda: _grid27(9),                      # 729 rows
    "grid17": lambda: _grid27(17),                    # 4,913: odd n
    "darcy16": lambda: _diags(DARCY16_OFFS, 11_520),
    "offs64": lambda: _spread(64, 3_000, 20_001),
    "tall": lambda: _diags((-30, -1, 0, 1, 30), 9_000, 5_000),
    "wide": lambda: _diags((-30, -1, 0, 1, 30, 7_000), 5_000, 9_001),
    "small": lambda: _diags((-2, -1, 0, 1, 2), 37),   # under one tile
    "tiny": lambda: _diags((-1, 0, 1), 3),            # n < V
}


def test_darcy_offsets_are_the_paths():
    """DARCY16_OFFS are the offsets the darcy_hyb path at 16^3 gives
    the DIA part of its outer operator."""
    hyb, Hs, _ = darcy_lane.build_darcy_hyb(16)
    assert Hs.shape[0] == 11_520
    _, Hd, _, _, _, _ = hyb._device_setup(Hs, "cpu")
    assert Hd.dia.offs == DARCY16_OFFS


# (points per side, dtype) -> (RT, T, blocks, window lengths, smem
# bytes of the SpMV): the flagship's DIA levels 97^3, 49^3 and 25^3.  RT
# (2 for f32 and bf16) halves while 256-thread tiles would number under
# 132; the
# table rows staged for bf16 (27 of RT T + V elements); one window per
# z-plane, RT T + 2 (k + 1) + V - 1 rows (room for x's lead) rounded out
# to V
GRID_PLANS = {
    (97, torch.float32): (2, 256, 1_783, (712, 716, 716), 8_576),
    (97, torch.bfloat16): (2, 256, 1_783, (720, 728, 728), 32_432),
    (97, torch.float64): (1, 256, 3_566, (454, 454, 454), 10_896),
    (49, torch.float32): (2, 256, 230, (616, 620, 620), 7_424),
    (49, torch.bfloat16): (2, 256, 230, (624, 632, 632), 31_856),
    (25, torch.float32): (1, 256, 62, (312, 316, 316), 31_856),
    (25, torch.bfloat16): (1, 256, 62, (320, 328, 328), 16_208),
}


@pytest.mark.parametrize("k,dtype", list(GRID_PLANS))
def test_row_plan_on_the_flagship_grids(k, dtype):
    RT, T, blocks, lens, smem = GRID_PLANS[(k, dtype)]
    n = k ** 3
    offs = _grid_offs(k)
    p = hk.dia_row_plan(offs, n, n, dtype)
    V = 16 // SIZES[dtype]
    span = k * k + k + 1
    assert (p.vec, p.rows, p.threads, p.blocks, p.lens) == (
        V, RT, T, blocks, lens)
    assert p.tstride == RT * T + V and p.staged
    assert p.windows == ((-span, -span + 2 * (k + 1)), (-(k + 1), k + 1),
                         (span - 2 * (k + 1), span))
    assert p.lo == tuple(lo // V * V for lo, _ in p.windows)
    assert p.base == (0, lens[0], lens[0] + lens[1])
    assert p.table_bytes == 27 * (RT * T + V) * SIZES[dtype]
    # f32 stages its table only on a grid under 132 tiles
    assert p.tstaged == (dtype == torch.bfloat16 or k == 25)
    assert p.smem_bytes == smem == (p.table_bytes * p.tstaged
                                    + sum(lens) * SIZES[dtype])
    # the centre of the middle window: x[i] at t + its base - lo
    assert p.xo[13] == p.center == lens[0] - p.lo[1]
    # the sweep also stages the tile's b and dw, R + V elements each
    ps = hk.dia_row_plan(offs, n, n, dtype, True)
    assert ps.vec_bytes == 2 * (RT * T + V) * SIZES[dtype]
    assert ps.smem_bytes == smem + ps.vec_bytes
    assert f"RT={RT} T={T}" in p.tag() and "staged K=3" in p.tag()


def _random_offs(rng):
    nd = rng.randint(1, hk.DIA_MAX_OFFS + 1)
    spread = rng.choice([100, 3_000, 200_000])
    return tuple(sorted(rng.choice(np.arange(-spread, spread), nd,
                                   replace=False).tolist()))


def _check_plan(p, offs, n, m, dtype, sweep):
    """The invariants csrc/dia.cu's row_launch checks, and more."""
    item = SIZES[dtype]
    V = 16 // item
    assert p.vec == V and p.offs == offs
    R = p.rows * p.threads
    assert p.tstaged == (hk.ROW_TABLE_STAGED[dtype] or -(-n // (
        hk.ROW_THREADS * hk.ROW_ROWS[dtype])) < hk.ROW_MIN_TILES)
    assert 1 <= p.rows <= hk.ROW_ROWS[dtype]
    if p.rows < hk.ROW_ROWS[dtype]:
        # halved for the grid, or for the least tile's table rows
        least = len(offs) * (2 * p.rows * hk.ROW_MIN_THREADS + V) * item
        assert (-(-n // (2 * p.rows * hk.ROW_THREADS)) < hk.ROW_MIN_TILES
                or p.tstaged and least > hk.ROW_SMEM_BYTES)
    assert hk.ROW_MIN_THREADS <= p.threads <= hk.ROW_THREADS
    assert p.threads % 32 == 0 and p.blocks == -(-n // R)
    assert p.tstride == R + V
    assert p.table_bytes == len(offs) * p.tstride * item
    assert p.vec_bytes == (2 * (R + V) * item if sweep else 0)
    wins = p.windows
    assert wins == hk.stage_windows(offs, R)
    # every offset lies in exactly one window
    for o in offs:
        assert sum(lo <= o <= hi for lo, hi in wins) == 1
    assert all(lo % V == 0 and 0 <= w - lo < V
               for lo, (w, _) in zip(p.lo, wins))
    assert all(ln % V == 0 and ln >= R + hi - lo + V - 1
               for ln, lo, (_, hi) in zip(p.lens, p.lo, wins))
    assert list(p.base) == [sum(p.lens[:k]) for k in range(len(wins))]
    assert p.stage_bytes == sum(p.lens) * item
    fits = (p.table_bytes * p.tstaged + p.stage_bytes + p.vec_bytes
            <= hk.ROW_SMEM_BYTES)
    assert p.staged == (m > 0 and fits)
    if p.threads < hk.ROW_THREADS:
        # T halved only for shared memory
        big = hk._row_layout(offs, 2 * R, V, item)
        assert (big[4] * p.tstaged + (big[5] if m > 0 else 0)
                + (2 * (2 * R + V) * item if sweep else 0)
                > hk.ROW_SMEM_BYTES)
    assert p.smem_bytes <= max(hk.ROW_SMEM_BYTES, p.table_bytes * p.tstaged
                               + p.vec_bytes) <= 232_448
    for o, xo in zip(offs, p.xo):
        k = next(k for k, (lo, hi) in enumerate(wins) if lo <= o <= hi)
        assert xo == p.base[k] + o - p.lo[k]
        # every thread's x stays in its window at any lead of x
        assert p.base[k] <= xo and xo + R + V - 1 <= p.base[k] + p.lens[k]
    k0 = [k for k, (lo, hi) in enumerate(wins) if lo <= 0 <= hi]
    assert p.center == (p.base[k0[0]] - p.lo[k0[0]] if p.staged and k0
                        else -1)


@pytest.mark.parametrize("seed", range(6))
def test_row_plan_windows_partition_the_offsets(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        offs = _random_offs(rng)
        dtype = DTYPES[rng.randint(3)]
        n = int(rng.choice([1, 7, 5_000, 912_673]))
        m = int(rng.choice([0, n, 2 * n + 1]))
        for sweep in (False, True):
            _check_plan(hk.dia_row_plan(offs, n, m, dtype, sweep), offs, n,
                        m, dtype, sweep)


def test_row_plan_is_cached_and_from_shapes():
    """One plan per (offsets, n, m, dtype): the same object again, made
    from hashable shapes alone (no tensor argument)."""
    offs = _grid_offs(97)
    p = hk.dia_row_plan(offs, 912_673, 912_673, torch.bfloat16, False)
    hits = hk.dia_row_plan.cache_info().hits
    assert hk.dia_row_plan(offs, 912_673, 912_673, torch.bfloat16,
                           False) is p
    assert hk.dia_row_plan.cache_info().hits == hits + 1
    assert hk._row_plan(torch.empty(0, dtype=torch.bfloat16), list(offs),
                        912_673, 912_673) is p
    assert hk.dia_row_plan(offs, 912_673, 912_672, torch.bfloat16) is not p


def test_row_struct_mirrors_the_plan():
    offs = _grid_offs(97)
    p = hk.dia_row_plan(offs, 97 ** 3, 97 ** 3, torch.float32)
    c = hk._row_arg(p)
    assert (c.threads, c.rows, c.tstride, c.tstaged, c.staged, c.center,
            c.nwin, c.xlen) == (256, 2, 516, 0, 1, 812, 3, 712 + 2 * 716)
    assert list(c.off[:27]) == list(offs)
    assert list(c.xo[:27]) == list(p.xo)
    assert list(c.lo[:3]) == list(p.lo)
    assert list(c.len[:3]) == [712, 716, 716]
    assert list(c.base[:3]) == [0, 712, 1_428]
    # bf16 (the table staged), 64 offsets 10,000 apart: at 2 rows a
    # thread and T = 64, 64 windows of 128 + 7 rows rounded to 136 and 64
    # table rows of 136 elements, 34.8 KB
    spread = tuple(range(0, 640_000, 10_000))
    q = hk.dia_row_plan(spread, 10 ** 6, 10 ** 6, torch.bfloat16)
    assert (q.rows, q.threads, len(q.windows)) == (2, 64, 64) and q.staged
    assert (q.table_bytes, q.stage_bytes) == (64 * 136 * 2, 64 * 136 * 2)
    assert hk._row_arg(q).staged == 1 and hk._row_arg(q).tstaged == 1


def test_row_plan_reads_x_from_global_where_windows_do_not_fit(
        monkeypatch):
    """At T = 32 the 64 spread windows and table rows take 18,432 bytes:
    under a 10,000-byte budget only the table is staged."""
    monkeypatch.setattr(hk, "ROW_SMEM_BYTES", 10_000)
    hk.dia_row_plan.cache_clear()
    try:
        q = hk.dia_row_plan(tuple(range(0, 640_000, 10_000)), 10 ** 6,
                            10 ** 6, torch.bfloat16)
        assert (q.rows, q.threads) == (2, 32) and not q.staged
        assert q.smem_bytes == q.table_bytes == 64 * 72 * 2
        assert "via L1/L2" in q.tag() and hk._row_arg(q).staged == 0
    finally:
        hk.dia_row_plan.cache_clear()


def _placed(a, lead, V):
    """a in a buffer `lead` elements past a 16-byte boundary (element
    0), NaN before and after it: (buffer, lo, hi), a at [lo, hi)."""
    buf = np.full(lead + a.size + 2 * V, np.nan, a.dtype)
    buf[lead:lead + a.size] = a
    return buf, lead, lead + a.size


def _stage(buf, lo, hi, g0, length, V):
    """The kernels' stage_chunk over `length` elements of buf from g0 (a
    multiple of V): 16-byte chunks that read only [lo, hi) and give
    zeros outside it."""
    out = np.zeros(length, buf.dtype)
    for e in range(0, length, V):
        g = g0 + e
        if g + V <= lo or g >= hi:
            continue                      # all zeros, nothing read
        j = np.arange(max(g, lo), min(g + V, hi))
        out[j - g0] = buf[j]
    return out


def _emulate(p, table, item, x, n, b=None, dw=None, lead=(0, 0, 0, 0)):
    """The 1-RHS kernels' work from the plan alone, block by block and,
    inside a block, for all its threads at once.  table (nd, ld) with
    ld >= n, x (m,), b and dw (n,), all in the accumulator dtype; `item`
    is the table's own item size; `lead` the elements between a 16-byte
    boundary and the start of the table, x, b and dw.  Per block: stage
    each table row's tstride elements from the V-element boundary at or
    below its entry for the tile's row b (zeros past the table's end),
    the windows (zeros outside [0, m)) and, for the sweep, R + V rows of
    b and dw, all from the boundary at or below each tensor's own
    position, then sum, for each row below n, the staged entry at the
    row's 16-byte shift times the staged x at x's lead (or x read with a
    bounds test) in offset order.  Returns y."""
    nd, ld = table.shape
    V = 16 // item
    assert p.vec == V
    ta, xa, ba, wa = lead
    flat, tlo, thi = _placed(table.reshape(-1), ta, V)
    xm, xlo, xhi = _placed(x, xa, V)
    R, m = p.rows * p.threads, x.size
    y = np.full(n, np.nan, x.dtype)
    t = np.arange(R)                      # the tile's rows, any thread
    for blk in range(p.blocks):
        b0 = blk * R
        ts = np.stack([_stage(flat, tlo, thi, (ta + d * ld + b0) // V * V,
                              p.tstride, V) for d in range(nd)])
        if p.staged:
            xs = np.concatenate([_stage(xm, xlo, xhi, b0 + lo, ln, V)
                                 for lo, ln in zip(p.lo, p.lens)])
        live = t[b0 + t < n]
        i = b0 + live
        acc = np.zeros(live.size, x.dtype)
        for d in range(nd):
            sh = (ta + d * ld) % V
            # the staged entry at the row's shift, or the table's own
            c = ts[d, sh + live] if p.tstaged else flat[ta + d * ld + i]
            if p.staged:
                xv = xs[live + p.xo[d] + xa]
            else:
                j = i + p.offs[d]
                ok = (j >= 0) & (j < m)
                xv = np.where(ok, x[np.clip(j, 0, max(m - 1, 0))]
                              if m else 0, 0).astype(x.dtype)
            acc += c * xv
        if b is not None:
            bs = _stage(*_placed(b, ba, V), b0, R + V, V)
            ws = _stage(*_placed(dw, wa, V), b0, R + V, V)
            xi = (xs[live + p.center + xa] if p.staged and p.center >= 0
                  else x[i])
            acc = xi + ws[live + wa] * (bs[live + ba] - acc)
        y[i] = acc
    assert not np.isnan(y).any()              # every row once, finite
    return y


def _np(t, acc):
    return t.to(acc).numpy()


def _inputs(A, dtype, seed):
    n, m = A.shape
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(m)).to(dtype)
    b = torch.as_tensor(rng.randn(n)).to(dtype)
    dw = torch.as_tensor(rng.rand(n)).to(dtype)
    return x, b, dw


@pytest.fixture(params=["staged", "global", "staged-rt2", "global-rt2"])
def x_route(request, monkeypatch):
    """The plan's own choice, the same plan with x read from global
    memory, and each with 2 rows a thread (no least grid)."""
    if request.param.endswith("rt2"):
        monkeypatch.setattr(hk, "ROW_MIN_TILES", 1)
        monkeypatch.setattr(hk, "ROW_ROWS", dict.fromkeys(hk.ROW_ROWS, 2))
    if request.param.startswith("global"):
        plan = hk.dia_row_plan
        monkeypatch.setattr(hk, "dia_row_plan",
                            lambda *a: plan(*a)._replace(staged=False))
        monkeypatch.setattr(hk.dia_row_plan, "cache_clear",
                            plan.cache_clear, raising=False)
    hk.dia_row_plan.cache_clear()
    yield request.param
    hk.dia_row_plan.cache_clear()


@pytest.fixture(params=["own", "direct"])
def table_route(request, monkeypatch):
    """Each dtype's own table staging (bf16 staged, f32 and f64 read from
    device memory, all staged on these small grids), or every table read
    from device memory (no least grid)."""
    if request.param == "direct":
        monkeypatch.setattr(hk, "ROW_TABLE_STAGED",
                            dict.fromkeys(hk.ROW_TABLE_STAGED, False))
        monkeypatch.setattr(hk, "ROW_MIN_TILES", 0)
    hk.dia_row_plan.cache_clear()
    yield request.param
    hk.dia_row_plan.cache_clear()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_row_kernels_match_plain(case, dtype, table_route,
                                          x_route):
    """On the table as to_dia gives it (ld = n) and widened to ld = n + 3
    and to n + 2V + 1 (every row's 16-byte shift differs), the latter two
    with every tensor off the 16-byte boundary."""
    A = CASES[case]()
    n, m = A.shape
    D = to_dia(A, dtype, "cpu")
    acc = hk.acc_dtype(dtype)
    item = SIZES[dtype]
    V = 16 // item
    x, b, dw = _inputs(A, dtype, n)
    xa, ba, dwa = (_np(t, acc) for t in (x, b, dw))
    p = hk.dia_row_plan(D.offs, n, m, dtype)
    assert p.tstaged == (hk.ROW_TABLE_STAGED[dtype] or -(-n // (
        hk.ROW_THREADS * hk.ROW_ROWS[dtype])) < hk.ROW_MIN_TILES)
    # staged unless the windows do not fit
    assert p.staged == (x_route.startswith("staged")
                        and p.smem_bytes + p.stage_bytes * (not p.staged)
                        <= hk.ROW_SMEM_BYTES)
    if x_route.endswith("rt2"):
        assert p.rows == 2
    yp = _np(hk.dia_spmv_plain(D.data, D.offs, x, n), acc)
    wp = (_np(hk.dia_jacobi_sweep_plain(D.data, D.offs, x, b, dw), acc)
          if n == m else None)
    # each with the table, x, b and dw at their own leads past a 16-byte
    # boundary (a row of a Krylov basis, say)
    for extra, lead in ((0, (0, 0, 0, 0)), (3, (1, V - 1, 2, 1)),
                        (2 * V + 1, (V - 1, 1, V - 1, V // 2))):
        lead = tuple(e % V for e in lead)
        wide = torch.zeros((len(D.offs), n + extra), dtype=dtype)
        wide[:, :n] = D.data
        tab = _np(wide, acc)
        y = _np(torch.as_tensor(_emulate(p, tab, item, xa, n, lead=lead))
                .to(dtype), acc)
        assert _rel(y, yp) <= TOL[dtype]
        if wp is not None:
            ps = hk.dia_row_plan(D.offs, n, m, dtype, True)
            w = _emulate(ps, tab, item, xa, n, ba, dwa, lead)
            w = _np(torch.as_tensor(w).to(dtype), acc)
            assert _rel(w, wp) <= TOL[dtype]


def _pallas(A, jdt, x, b=None, dw=None):
    """dia_spmv_pallas (or, with b and dw, dia_jacobi_sweep_pallas) in
    interpret mode on the JAX table of A in dtype jdt, padded as the JAX
    DiaMatrix pads it."""
    n, m = A.shape
    Aj = jds.to_dia(A, dtype=jdt)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    xpad = jnp.zeros(xlen, jdt).at[lo:lo + m].set(x.astype(jdt))
    if b is None:
        y = dia_spmv_pallas(Aj.data, Aj.offs, xpad, lo, n, interpret=True)
    else:
        bpad = jnp.zeros(npad, jdt).at[:n].set(b.astype(jdt))
        dpad = jnp.zeros(npad, jdt).at[:n].set(dw.astype(jdt))
        y = dia_jacobi_sweep_pallas(Aj.data, Aj.offs, xpad, bpad, dpad, lo,
                                    n, interpret=True)
    return np.asarray(y[:n], dtype=np.float64)


def _rounded(A, dtype):
    """A with its values rounded to dtype (as to_dia rounds them)."""
    B = A.copy().astype(np.float64)
    B.data = torch.as_tensor(B.data).to(dtype).double().numpy()
    return B


@pytest.mark.parametrize("case", ["grid9", "grid17", "darcy16", "offs64",
                                  "tall", "small"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_row_kernels_match_pallas_interpret(case, dtype):
    """The Pallas kernels take m <= n (the JAX DiaMatrix's own rule), so
    the wide case is held against the plain version only.  bf16: against
    the f32 Pallas kernels on the bf16-rounded table and vectors, and
    against the bf16 Pallas kernels (PALLAS_BF16_SUM_TOL)."""
    A = CASES[case]()
    n, m = A.shape
    D = to_dia(A, dtype, "cpu")
    acc = hk.acc_dtype(dtype)
    x, b, dw = _inputs(A, dtype, 7)
    xa, ba, dwa = (_np(t, torch.float32) for t in (x, b, dw))
    p = hk.dia_row_plan(D.offs, n, m, dtype)
    tab = _np(D.data, acc)
    refs = [(_rounded(A, dtype), np.float32, PALLAS_TOL[dtype])]
    if dtype == torch.bfloat16:
        refs.append((A, jnp.bfloat16, PALLAS_BF16_SUM_TOL))
    y = _emulate(p, tab, SIZES[dtype], xa, n)
    y = _np(torch.as_tensor(y).to(dtype), acc)
    w = None
    if n == m:
        ps = hk.dia_row_plan(D.offs, n, m, dtype, True)
        w = _emulate(ps, tab, SIZES[dtype], xa, n, ba, dwa)
        w = _np(torch.as_tensor(w).to(dtype), acc)
    for Aj, jdt, tol in refs:
        assert _rel(y, _pallas(Aj, jdt, xa)) <= tol
        if w is not None:
            assert _rel(w, _pallas(Aj, jdt, xa, ba, dwa)) <= tol
