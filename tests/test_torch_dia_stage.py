"""The staging plan of the multi-RHS DIA kernels (csrc/dia.cu), on the
CPU: hopper_kernels.dia_stage_plan decides every layout the kernels take
(row tile R, column slice C, the offset windows staged in shared memory
and their shared bytes), so these tests hold the plan to its numbers on
the flagship grids and to its invariants on random offsets, and emulate
the kernels tile by tile from the plan in numpy (the staged table rows
from their 16-byte boundaries, the windows) against the plain
versions (f32 and bf16 within 1e-6 relative in f32, f64 within 1e-12:
the emulation sums in the kernels' and the plain versions' order) and
against the Pallas kernels in interpret mode (1e-5 relative).  Inputs
come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.ops.pallas_kernels import (
    dia_jacobi_sweep_multirhs_pallas, dia_spmv_multirhs_pallas,
    dia_xpad_len)
from parelag_tpu_torch import flagship as fl
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import to_dia

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
SIZES = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}


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


def _banded(n, m=None):
    """The operator of tests/test_pallas.py (0, +-1, +-30), n x m."""
    m = n if m is None else m
    offs = [0, 1, -1, 30, -30]
    A = sp.diags([1.0] * 5, offs, shape=(n, m)).tocsr()
    A.data = np.random.RandomState(n + m).rand(A.nnz) - 0.5
    A.setdiag(6.0)
    return A.astype(np.float32)


def test_flagship_operator_has_the_grid_offsets():
    """The port's 8^3 flagship operator is the 27-point stencil on 9^3
    points, the pattern the plan numbers below take at 97^3."""
    A_levels, _, _ = fl.build_h1_structured(8, min_coarse=8,
                                            dtype=np.float64, device="cpu")
    assert to_dia(A_levels[0], np.float64, "cpu").offs == _grid_offs(9)


# (points per side, dtype) -> (R, window rows, shared bytes) at s = 16:
# the flagship's DIA levels 97^3, 49^3 and 25^3; R is 256 or 512 rounded
# down to whole blocks of 3 rows of 16 bytes, and the bytes hold the
# three windows and the 27 table rows of R + 16 bytes
GRID_PLANS = {
    (97, torch.float32): (252, 448, 113_664),
    (97, torch.bfloat16): (504, 700, 94_848),
    (49, torch.float32): (252, 352, 95_232),
    (49, torch.bfloat16): (504, 604, 85_632),
    (25, torch.float32): (252, 304, 86_016),
    (25, torch.bfloat16): (504, 556, 81_024),
}


@pytest.mark.parametrize("k,dtype", list(GRID_PLANS))
def test_plan_on_the_flagship_grids(k, dtype):
    R, rows, nbytes = GRID_PLANS[(k, dtype)]
    offs = _grid_offs(k)
    span = k * k + k + 1
    p = hk.dia_stage_plan(offs, 16, dtype)
    assert (p.rows, p.cols, p.smem_bytes) == (R, 16, nbytes)
    assert p.tstride == R + 16 // SIZES[dtype]
    # one window per z-plane, each R + 2 (k + 1) rows, k^2 apart: a march
    assert p.period == k * k
    assert p.windows == ((-span, -span + 2 * (k + 1)),
                         (-(k + 1), k + 1),
                         (span - 2 * (k + 1), span))
    assert [R + hi - lo for lo, hi in p.windows] == [rows] * 3
    assert p.base == (0, rows, 2 * rows)
    assert p.window_of == tuple([0] * 9 + [1] * 9 + [2] * 9)
    assert p.sh[0] == 0 and p.sh[13] == rows + k + 1
    assert p.sh[26] == 3 * rows - R
    assert nbytes == (3 * rows * 16 + 27 * p.tstride) * SIZES[dtype]
    assert nbytes <= hk.STAGE_TARGET_BYTES
    assert p.center is None
    # the nine stencil lines, one run of three offsets each
    assert p.runs == tuple((3 * j, 3) for j in range(9))
    ps = hk.dia_stage_plan(offs, 16, dtype, sweep=True)
    assert ps.center == p.sh[13] and ps.windows == p.windows


def _random_offs(rng):
    nd = rng.randint(1, hk.DIA_STAGE_MAX_OFFS + 1)
    spread = rng.choice([100, 3_000, 200_000])
    return tuple(sorted(rng.choice(np.arange(-spread, spread), nd,
                                   replace=False).tolist()))


def _check_plan(p, offs, s, dtype, sweep):
    need = sorted(set(offs) | ({0} if sweep else set()))
    wins = p.windows
    # sorted, disjoint, each ended by offsets and at least R apart
    assert all(lo <= hi for lo, hi in wins)
    assert all(wins[k][1] + p.rows <= wins[k + 1][0]
               for k in range(len(wins) - 1))
    assert all(lo in need and hi in need for lo, hi in wins)
    # every offset lies in exactly one window, the one window_of names
    for d, o in enumerate(offs):
        inside = [k for k, (lo, hi) in enumerate(wins) if lo <= o <= hi]
        assert inside == [p.window_of[d]]
        lo = wins[p.window_of[d]][0]
        assert p.sh[d] == p.base[p.window_of[d]] + o - lo
    lens = [p.rows + hi - lo for lo, hi in wins]
    assert list(p.base) == [sum(lens[:k]) for k in range(len(wins))]
    assert p.tstride == p.rows + 16 // SIZES[dtype]
    assert p.smem_bytes == (sum(lens) * p.cols
                            + len(offs) * p.tstride) * SIZES[dtype]
    if sweep:
        k0 = next(k for k, (lo, hi) in enumerate(wins) if lo <= 0 <= hi)
        assert p.center == p.base[k0] - wins[k0][0]
    # a march: K >= 2 windows, equally long, equally spaced by the period
    # runs: in order, covering every offset once, at most STAGE_RUN long,
    # consecutive staged rows inside, and none that could grow
    assert [d for d0, n in p.runs for d in range(d0, d0 + n)] == \
        list(range(len(offs)))
    for j, (d0, n) in enumerate(p.runs):
        assert 1 <= n <= hk.STAGE_RUN
        assert all(p.sh[d] == p.sh[d0] + d - d0 for d in range(d0, d0 + n))
        if j + 1 < len(p.runs) and n < hk.STAGE_RUN:
            assert p.sh[d0 + n] != p.sh[d0 + n - 1] + 1
    march = len(wins) >= 2 and len(set(lens)) == 1 and all(
        wins[k][0] - wins[0][0] == k * (wins[1][0] - wins[0][0])
        for k in range(len(wins)))
    assert p.period == (wins[1][0] - wins[0][0] if march else 0)


@pytest.mark.parametrize("seed", range(5))
def test_plan_windows_partition_the_offsets(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        offs = _random_offs(rng)
        for sweep in (False, True):
            dtype = DTYPES[rng.randint(3)]
            s = int(rng.randint(1, hk.MAX_RHS + 1))
            _check_plan(hk.dia_stage_plan(offs, s, dtype, sweep), offs, s,
                        dtype, sweep)


@pytest.mark.parametrize("s", [1, 3, 16, 37, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(s, dtype):
    """For nd <= 48 random offsets the windows stay under the plan's
    target; C keeps 16-byte slices where s allows and takes all s columns
    where a row of X fits 64 bytes and R alone can make room."""
    rng = np.random.RandomState(s)
    item = SIZES[dtype]
    w16 = 16 // item
    unit = hk.STAGE_ROW_BLOCK * w16
    r_min = -(-hk.STAGE_MIN_ROWS // unit) * unit
    for _ in range(30):
        offs = _random_offs(rng)
        p = hk.dia_stage_plan(offs, s, dtype, sweep=True)
        _check_plan(p, offs, s, dtype, True)
        assert p.smem_bytes <= hk.STAGE_TARGET_BYTES
        assert r_min <= p.rows <= hk.STAGE_ROWS[dtype]
        assert p.rows % unit == 0
        assert 1 <= p.cols <= s
        if s % w16 == 0:
            assert p.cols % w16 == 0
        # the bytes at the least R with all s columns
        least = (len(set(offs) | {0}) * r_min * s
                 + len(offs) * (r_min + w16)) * item
        if s * item <= 64 and least <= hk.STAGE_TARGET_BYTES:
            assert p.cols == s


def test_stage_struct_mirrors_the_plan():
    offs = _grid_offs(97)
    p = hk.dia_stage_plan(offs, 16, torch.bfloat16, sweep=True)
    c = hk._stage_arg(p)
    assert (c.rows, c.cols, c.nwin, c.sweep, c.tstride, c.period,
            c.nrun) == (504, 16, 3, 1, 512, 9409, 9)
    assert list(c.run_d0[:9]) == list(range(0, 27, 3))
    assert list(c.run_len[:9]) == [3] * 9
    assert list(c.lo[:3]) == [lo for lo, _ in p.windows]
    assert list(c.len[:3]) == [700] * 3
    assert list(c.base[:3]) == list(p.base)
    # the sweep's X[i] rides as entry nd
    assert list(c.sh[:28]) == list(p.sh) + [p.center] == \
        list(p.sh) + [p.sh[13]]
    assert list(c.wof[:28]) == list(p.window_of) + [1]


def _work(p, n, s):
    """The kernels' work list, in order: (q0, tile row b, valid rows,
    plane) for each (slice, tile in the plane, plane), plane fastest; a
    plan without a march has one plane of all the tiles."""
    R, P = p.rows, p.period
    per_plane = -(-(P if P else n) // R)
    planes = -(-n // P) if P else 1
    for q0 in range(0, s, p.cols):
        for xt in range(per_plane):
            for plane in range(planes):
                b = xt * R + plane * P
                valid = min(R, P - xt * R if P else R, n - b)
                yield q0, b, valid, plane


def _emulate(p, table, item, X, n, B=None, dw=None, blocks=5):
    """The staged kernels' work from the plan alone, the list split into
    `blocks` runs as the persistent grid splits it.  Per tile: stage each
    table row's tstride elements from the V-element boundary at or below
    its entry for row b (V = 16 bytes of the table's items; zeros past the
    table's end) and the windows (zeros outside [0, m)) into their ring
    slots, all K at a run's first tile and a plane's first, else only the
    top one into the slot the bottom one leaves (the march); then, run by
    run, sum the staged coefficient times the staged X row (the run's
    first row plus the offset's place in the run) of each offset in
    offset order, the coefficient found by the kernels' 16-byte shift;
    with B and dw the sweep, X[i] from its staged row.  table (nd, ld) with ld >= n,
    in the accumulator dtype; `item` is the table's own item size.
    Returns Y and the staged elements of a full slice."""
    nd, ld = table.shape
    flat = table.reshape(-1)
    V = 16 // item
    m, s = X.shape
    R, K = p.rows, len(p.windows)
    lens = [R + hi - lo for lo, hi in p.windows]
    full = sum(lens) * p.cols + nd * p.tstride
    Y = np.full((n, s), np.nan, X.dtype)
    work = list(_work(p, n, s))
    cuts = [len(work) * j // blocks for j in range(blocks + 1)]
    xs, rot = None, 0
    for j in range(blocks):
        for w in range(cuts[j], cuts[j + 1]):
            q0, b, valid, plane = work[w]
            cw = min(p.cols, s - q0)
            fresh = w == cuts[j] or plane == 0 or p.period == 0
            rot = 0 if fresh else (rot + 1) % K
            if fresh:
                xs = np.full((sum(lens), cw), np.nan, X.dtype)
            for k in (range(K) if fresh else [K - 1]):
                lo = p.windows[k][0]
                g = b + lo + np.arange(lens[k])
                ok = (g >= 0) & (g < m)
                rows = np.zeros((lens[k], cw), X.dtype)
                rows[ok] = X[g[ok], q0:q0 + cw]
                slot = p.base[(k + rot) % K]
                xs[slot:slot + lens[k]] = rows
            ts = np.zeros((nd, p.tstride), X.dtype)
            for d in range(nd):
                a = (d * ld + b) // V * V
                run = flat[a:a + p.tstride]
                ts[d, :run.size] = run

            def row_of(sh, k):
                return sh - p.base[k] + p.base[(k + rot) % K]

            r = np.arange(max(valid, 0))
            i = b + r
            acc = np.zeros((r.size, cw), X.dtype)
            for d0, length in p.runs:
                first = row_of(p.sh[d0], p.window_of[d0])
                for j in range(length):
                    d = d0 + j
                    shift = (b + d * ld) % V
                    acc += ts[d, shift + r, None] * xs[r + first + j]
            if B is not None:
                k0 = next(k for k, (lo, hi) in enumerate(p.windows)
                          if lo <= 0 <= hi)
                acc = xs[r + row_of(p.center, k0)] + dw[i, None] * (
                    B[i, q0:q0 + cw] - acc)
            Y[i, q0:q0 + cw] = acc
    assert not np.isnan(Y).any()              # every row once
    return Y, full


def _as_np(t, acc):
    return t.to(acc).numpy()


CASES = {
    "banded": lambda: _banded(9_000),                 # 1 window at R=256
    "tall": lambda: _banded(9_000, 5_000),
    "wide": lambda: _banded(5_000, 9_001),
    "grid": lambda: _grid27(13),                      # 2,197 rows
    "grid33": lambda: _grid27(33),                    # a march at R=256
}
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6, torch.float64: 1e-12}


def _emulation_vs_plain(A, dtype, s, seed):
    """Emulated kernels against the plain versions, on the table as
    to_dia gives it (ld = n) and widened to ld = n + 3 (every row's
    16-byte shift differs)."""
    n, m = A.shape
    D = to_dia(A, dtype, "cpu")
    acc = hk.acc_dtype(dtype)
    item = SIZES[dtype]
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.randn(m, s)).to(dtype)
    B = torch.as_tensor(rng.randn(n, s)).to(dtype)
    dw = torch.as_tensor(rng.rand(n)).to(dtype)
    Xa, Ba, dwa = (_as_np(t, acc) for t in (X, B, dw))
    wide = torch.zeros((len(D.offs), n + 3), dtype=dtype)
    wide[:, :n] = D.data
    p = hk.dia_stage_plan(D.offs, s, dtype)
    ps = hk.dia_stage_plan(D.offs, s, dtype, sweep=True)
    yp = hk.dia_spmv_plain(D.data, D.offs, X, n).to(acc)
    wp = (hk.dia_jacobi_sweep_plain(D.data, D.offs, X, B, dw).to(acc)
          if n == m else None)
    for table in (D.data, wide):
        tab = _as_np(table, acc)
        Y, full = _emulate(p, tab, item, Xa, n)
        assert full * item == p.smem_bytes
        assert _rel(torch.as_tensor(Y).to(dtype).to(acc), yp) <= TOL[dtype]
        if wp is not None:
            W, _ = _emulate(ps, tab, item, Xa, n, Ba, dwa)
            assert _rel(torch.as_tensor(W).to(dtype).to(acc), wp) \
                <= TOL[dtype]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_kernels_match_plain(case, dtype):
    """n not a multiple of R (boundary tiles), m != n both ways, and
    s = 37 (slices of 19 columns and one of 18 in f32 and f64)."""
    for s in (3, 37):
        _emulation_vs_plain(CASES[case](), dtype, s, s)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_small_tiles(case, monkeypatch):
    """R = 12, one block of 3 rows of 16 bytes: several windows per tile
    (the banded operator's +-30 offsets no longer join the middle one)
    and hundreds of tiles."""
    monkeypatch.setitem(hk.STAGE_ROWS, torch.float32, 12)
    monkeypatch.setattr(hk, "STAGE_MIN_ROWS", 12)
    hk.dia_stage_plan.cache_clear()
    try:
        p = hk.dia_stage_plan(to_dia(CASES[case](), np.float32,
                                     "cpu").offs, 16, torch.float32)
        assert p.rows == 12 and len(p.windows) >= 3
        _emulation_vs_plain(CASES[case](), torch.float32, 16, 1)
    finally:
        hk.dia_stage_plan.cache_clear()


def _pallas_inputs(A, s, rng):
    n = A.shape[0]
    Aj = jds.to_dia(A, dtype=np.float32)
    lo, _ = Aj.span
    npad = Aj.data.shape[1]
    xlen = dia_xpad_len(npad, lo, Aj.offs, Aj._TILE)
    X = rng.randn(n, s).astype(np.float32)
    xpT = jnp.zeros((s, xlen), jnp.float32).at[:, lo:lo + n].set(X.T)
    return Aj, lo, npad, X, xpT


@pytest.mark.parametrize("s", [3, 16])
def test_emulated_kernels_match_pallas_interpret(s):
    """The banded operator of tests/test_pallas.py (9,000 rows: 35 full
    tiles of R = 256 and one of 40 rows)."""
    A = _banded(9_000)
    n = A.shape[0]
    rng = np.random.RandomState(s)
    Aj, lo, npad, X, xpT = _pallas_inputs(A, s, rng)
    D = to_dia(A, np.float32, "cpu")
    tab = D.data.numpy()
    yj = np.asarray(dia_spmv_multirhs_pallas(
        Aj.data, Aj.offs, xpT, lo, n, interpret=True))[:, :n].T
    Y, _ = _emulate(hk.dia_stage_plan(D.offs, s, torch.float32), tab, 4, X,
                    n)
    assert _rel(Y, yj) < 1e-5
    B = rng.randn(n, s).astype(np.float32)
    dw = (1.0 / np.asarray(np.abs(A).sum(axis=1)).ravel()
          ).astype(np.float32)
    bpT = jnp.zeros((s, npad), jnp.float32).at[:, :n].set(B.T)
    dpad = jnp.zeros(npad, jnp.float32).at[:n].set(dw)
    wj = np.asarray(dia_jacobi_sweep_multirhs_pallas(
        Aj.data, Aj.offs, xpT, bpT, dpad, lo, n, interpret=True))[:, :n].T
    W, _ = _emulate(hk.dia_stage_plan(D.offs, s, torch.float32, sweep=True),
                    tab, 4, X, n, B, dw)
    assert _rel(W, wj) < 1e-5
