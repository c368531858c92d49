"""Card-only checks of the hand-written CUDA kernels: each kernel against
its plain PyTorch version on the card, and the flagship slice end to end
at a small size.  They skip without a CUDA device.  This file imports
neither jax nor parelag_tpu, so it runs on the card's machine without
the repo's JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import to_bcsr, to_dia

# max |kernel - plain| / max |plain|: f32/f64 differ in summation order
# only; bf16 outputs round to 2^-8
LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(yk, yp):
    assert yk.dtype == yp.dtype and yk.shape == yp.shape
    d = (yk.double() - yp.double()).abs().max().item()
    return d / max(yp.double().abs().max().item(), 1e-300)


def _stencil(n):
    """27-point-like banded operator with offsets past both ends."""
    offs = [o1 + o2 for o1 in (-900, 0, 900) for o2 in (-30, -1, 0, 1, 30)]
    return sp.diags([np.random.RandomState(len(offs)).rand(n - abs(o))
                     for o in offs], offs).tocsr()


def _diags(offs, n, m=None):
    """An n x m operator with full random diagonals at `offs`."""
    m = n if m is None else m
    rng = np.random.RandomState(len(offs) + n)
    return sp.diags([rng.rand(max(0, min(n, m - o) - max(0, -o))) - 0.5
                     for o in offs], offs, shape=(n, m)).tocsr()


# the 1-RHS DIA kernels' edge cases: (operator, extra table columns, so
# ld = n + extra).  n odd, n = 0 (no launch), n below 16 bytes of rows
# (V = 8 bf16, 4 f32, 2 f64), ld > n (every row's 16-byte shift moves),
# n != m both ways, and the flagship's 27-point stencil
ROW_CASES = {
    "stencil": (lambda: _stencil(100_003), 0),
    "grid33": (lambda: _grid27(33), 0),
    "zero": (lambda: sp.csr_matrix((0, 0)), 0),
    "n_below_v": (lambda: _diags((-1, 0, 1), 3), 0),
    "ld_above_n": (lambda: _stencil(50_001), 5),
    "tall": (lambda: _banded_rect(41_000, 30_001), 0),
    "wide": (lambda: _banded_rect(30_001, 41_000), 0),
}


def _widened(D, extra):
    if not extra:
        return D.data
    nd, ld = D.data.shape
    wide = torch.zeros((nd, ld + extra), dtype=D.dtype,
                       device=D.data.device)
    wide[:, :ld] = D.data
    return wide


@pytest.fixture(params=["plan", "rt2", "flipped"])
def row_tile(request, monkeypatch):
    """The 1-RHS plan's own tile (a row a thread on these sizes), 2 rows
    a thread (no least grid), or the other table staging (bf16 read from
    device memory, f32 and f64 staged; no least grid)."""
    if request.param == "rt2":
        monkeypatch.setattr(hk, "ROW_MIN_TILES", 1)
        monkeypatch.setattr(hk, "ROW_ROWS", dict.fromkeys(hk.ROW_ROWS, 2))
    if request.param == "flipped":
        monkeypatch.setattr(hk, "ROW_TABLE_STAGED", {
            k: not v for k, v in hk.ROW_TABLE_STAGED.items()})
        monkeypatch.setattr(hk, "ROW_MIN_TILES", 0)
    hk.dia_row_plan.cache_clear()
    yield request.param
    hk.dia_row_plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROW_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dia_kernels_match_plain(card, dtype, case, row_tile):
    make, extra = ROW_CASES[case]
    A = make()
    n, m = A.shape
    D = to_dia(A, dtype, card)
    data = _widened(D, extra)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, generator=g).to(dtype).to(card)
    b, dw = (torch.randn(n, generator=g).to(dtype).to(card)
             for _ in range(2))
    launched = int(n > 0)
    before = dict(hk.LAUNCHES)
    y = hk.dia_spmv(data, D.offs, x, n)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dia_spmv"] == before["dia_spmv"] + launched
    assert y.shape == (n,)
    if n:
        assert _rel(y, hk.dia_spmv_plain(data, D.offs, x, n)) \
            <= LIMIT[dtype]
    if n != m:
        return
    s = hk.dia_jacobi_sweep(data, D.offs, x, b, dw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dia_jacobi_sweep"] == \
        before["dia_jacobi_sweep"] + launched
    assert s.shape == (n,)
    if n:
        assert _rel(s, hk.dia_jacobi_sweep_plain(data, D.offs, x, b, dw)) \
            <= LIMIT[dtype]


def _at_lead(t, lead):
    """A copy of t whose storage starts `lead` elements past a 16-byte
    boundary, as a row of an (m + 1, n) Krylov basis with n odd does."""
    pad = 16 // t.element_size()
    buf = torch.full((t.numel() + pad,), float("nan"), dtype=t.dtype,
                     device=t.device)
    assert buf.data_ptr() % 16 == 0
    view = buf[lead:lead + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stencil", "grid33", "ld_above_n"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dia_kernels_take_unaligned_views(card, dtype, case, row_tile):
    """The table, x, b and dw may start anywhere on their element size:
    each at its own lead past a 16-byte boundary, NaN before and after
    it (none of which may reach the result), against the plain version
    on the same views."""
    make, extra = ROW_CASES[case]
    A = make()
    n = A.shape[0]
    D = to_dia(A, dtype, card)
    g = torch.Generator().manual_seed(1)
    x, b, dw = (torch.randn(n, generator=g).to(dtype).to(card)
                for _ in range(3))
    V = 16 // x.element_size()
    for lead in ((1, V - 1, V // 2, 1), (V - 1, 1, 1, V - 1)):
        data, xv, bv, wv = (_at_lead(t, a % V) for t, a in zip(
            (_widened(D, extra), x, b, dw), lead))
        assert (xv.data_ptr() % 16) // xv.element_size() == lead[1] % V
        before = dict(hk.LAUNCHES)
        y = hk.dia_spmv(data, D.offs, xv, n)
        s = hk.dia_jacobi_sweep(data, D.offs, xv, bv, wv)
        torch.cuda.synchronize()
        assert hk.LAUNCHES["dia_spmv"] == before["dia_spmv"] + 1
        assert hk.LAUNCHES["dia_jacobi_sweep"] == \
            before["dia_jacobi_sweep"] + 1
        assert _rel(y, hk.dia_spmv_plain(data, D.offs, xv, n)) \
            <= LIMIT[dtype]
        assert _rel(s, hk.dia_jacobi_sweep_plain(data, D.offs, xv, bv,
                                                 wv)) <= LIMIT[dtype]


@pytest.mark.cuda
def test_gmres_on_a_dia_hierarchy_at_odd_n(card):
    """GMRES preconditioned by the flagship's f32 DIA hierarchy at 17^3
    = 4,913 rows, every level DIA: the Arnoldi rows V[j] that the
    V-cycle's l1-Jacobi sweeps take as b start 4 j n bytes into the
    basis, off the 16-byte boundary unless 4 divides j.  The same cycles
    as on the CPU (one, at rel_res 2e-6 there) and x within 1e-5 of the
    CPU's (both lie within 3e-7 of the f64 solution on the CPU)."""
    from parelag_tpu_torch import flagship as fl
    from parelag_tpu_torch.solvers.cg import gmres
    A_levels, P_levels, _ = fl.build_h1_structured(16, min_coarse=64,
                                                   device="cpu")
    n = A_levels[0].shape[0]
    assert n == 4_913
    b = np.random.RandomState(3).rand(n).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        H, _ = fl.build_solver(A_levels, P_levels, dev)
        before = dict(hk.LAUNCHES)
        x, (cycles, res) = gmres(H.levels[0].A.matvec,
                                 torch.as_tensor(b).to(dev),
                                 precond=H.apply, rtol=1e-5, restart=10)
        out[str(dev)] = (x.cpu().double(), int(cycles), float(res))
    assert hk.LAUNCHES["dia_jacobi_sweep"] > before["dia_jacobi_sweep"]
    assert hk.LAUNCHES["dia_spmv"] > before["dia_spmv"]
    (xc, cc, rc), (xg, cg, rg) = out["cpu"], out[str(card)]
    assert cg == cc == 1 and rg <= 1e-5 * np.linalg.norm(b)
    assert (xg - xc).abs().max() <= 1e-5 * xc.abs().max()


# the (values, x) dtype pairs of the BCSR kernels
BCSR_PAIRS = [(torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float32, torch.bfloat16),
              (torch.float32, torch.float32),
              (torch.float64, torch.float64)]


def _ragged(per_row, n=20_001, m=7_777):
    """per_row nonzeros a row near the diagonal's band, every 7th row
    empty, and row 5 with 100 (more than a warp); n is odd, so not a
    multiple of any group of lanes."""
    rng = np.random.RandomState(per_row)
    rows = np.repeat(np.arange(n), per_row)
    cols = (rows * m // n + rng.randint(-300, 300, rows.size)) % m
    keep = rows % 7 != 3
    rows = np.concatenate([rows[keep], np.full(100, 5)])
    cols = np.concatenate([cols[keep], rng.choice(m, 100, replace=False)])
    return sp.csr_matrix((rng.randn(rows.size), (rows, cols)),
                         shape=(n, m))


@pytest.mark.cuda
@pytest.mark.parametrize("per_row,group", [(3, 4), (26, 16)])
@pytest.mark.parametrize("tdt,xdt", BCSR_PAIRS)
def test_bcsr_kernel_matches_plain(card, tdt, xdt, per_row, group):
    A = _ragged(per_row)
    B = to_bcsr(A, tdt, device=card)
    assert B.group == group and B.row_ptr.diff().max().item() >= 100
    x = torch.as_tensor(np.random.RandomState(1).randn(A.shape[1])
                        ).to(xdt).to(card)
    before = hk.LAUNCHES["bcsr_spmv"]
    y = B @ x
    torch.cuda.synchronize()
    assert hk.LAUNCHES["bcsr_spmv"] == before + 1
    yp = hk.bcsr_spmv_plain(B.row_ptr, B.col_idx, B.values, x, A.shape[0])
    assert _rel(y, yp) <= LIMIT[y.dtype]
    assert not y[3::7].any()


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(card):
    D = to_dia(_stencil(1000), torch.float32, card)
    with pytest.raises(ValueError, match="dtypes"):
        hk.dia_spmv(D.data, D.offs, torch.ones(1000, device=card,
                                               dtype=torch.bfloat16), 1000)
    with pytest.raises(ValueError, match="one-dimensional"):
        hk.dia_spmv(D.data, D.offs, torch.ones(1000, 2, device=card), 1000)
    with pytest.raises(ValueError, match="offsets"):
        hk.dia_spmv(D.data[:1], D.offs, torch.ones(1000, device=card), 1000)


@pytest.mark.cuda
def test_flagship_small_on_card(card):
    from parelag_tpu_torch import flagship as fl
    rec, _ = fl.lane_h1(16, card, min_coarse=64)
    assert rec["converged"] and rec["levels"] == 3
    assert abs(rec["iters"] - rec["host_iters"]) <= 2
    for k in ("dia_spmv", "dia_jacobi_sweep", "bcsr_spmv"):
        assert rec["kernels"][k] > 0, rec["kernels"]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 3, 16, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dia_multirhs_kernels_match_plain(card, dtype, s):
    """s = 1, 3 and 37 stage X element by element, one column a thread;
    16 and 64 in 16-byte runs.  s = 37 and 64 (and 16 in f64) split the
    columns into slices."""
    n = 50_001
    D = to_dia(_stencil(n), dtype, card)
    g = torch.Generator().manual_seed(1)
    x, b = (torch.randn(n, s, generator=g).to(dtype).to(card)
            for _ in range(2))
    dw = torch.randn(n, generator=g).to(dtype).to(card)
    before = dict(hk.LAUNCHES)
    y = hk.dia_spmv_multirhs(D.data, D.offs, x, n)
    w = hk.dia_jacobi_sweep_multirhs(D.data, D.offs, x, b, dw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dia_spmv_multirhs"] == \
        before["dia_spmv_multirhs"] + 1
    assert hk.LAUNCHES["dia_jacobi_sweep_multirhs"] == \
        before["dia_jacobi_sweep_multirhs"] + 1
    assert _rel(y, hk.dia_spmv_plain(D.data, D.offs, x, n)) <= LIMIT[dtype]
    assert _rel(w, hk.dia_jacobi_sweep_plain(D.data, D.offs, x, b, dw)) \
        <= LIMIT[dtype]
    # column q of the block product is the 1-RHS product of column q
    y1 = hk.dia_spmv(D.data, D.offs, x[:, s - 1].contiguous(), n)
    assert _rel(y[:, s - 1], y1) <= LIMIT[dtype]


def _grid27(k):
    """The 27-point stencil on a k^3 grid of points, random values."""
    t = sp.diags([np.ones(k - 1), np.ones(k), np.ones(k - 1)], [-1, 0, 1])
    A = sp.kron(sp.kron(t, t), t).tocsr()
    A.data = np.random.RandomState(k).rand(A.nnz) + 0.5
    return A


def _banded_rect(n, m):
    """n x m with offsets past both ends of X, and one at m - n."""
    offs = sorted({-900, -30, -1, 0, 1, 30, 900, m - n})
    A = sp.diags([1.0] * len(offs), offs, shape=(n, m)).tocsr()
    A.data = np.random.RandomState(n).rand(A.nnz)
    return A


def _scattered(n, nd=48):
    """nd offsets scattered over +-19,200 rows, at least 64 apart: one
    window each once the plan has cut R to 32."""
    rng = np.random.RandomState(nd)
    offs = 64 * np.sort(rng.choice(np.arange(-300, 300), nd, replace=False))
    return sp.diags([rng.rand(n - abs(o)) for o in offs], offs).tocsr()


# (operator, windows of its f32 s = 16 plan): the 33^3 grid (35,937
# rows, not a multiple of R) makes one window per z-plane; on the 65^3
# grid (1,105 tiles) a block marches up several planes, staging only
# each new top window into its ring of slots
STAGED_CASES = {
    "grid33": (lambda: _grid27(33), 3),
    "grid65": (lambda: _grid27(65), 3),
    "scattered48": (lambda: _scattered(50_001), 48),
    "wide": (lambda: _banded_rect(30_001, 41_000), None),
    "tall": (lambda: _banded_rect(41_000, 30_001), None),
}


def _unaligned(t):
    """A copy of t whose storage starts 1 element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STAGED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dia_multirhs_staged_shapes(card, case, dtype):
    """The staged kernels on a 27-point grid, 48 scattered offsets and
    rectangular tables (m != n), each with a 16-byte aligned X and one
    that is not; the sweep where the table is square."""
    make, nwin = STAGED_CASES[case]
    A = make()
    n, m = A.shape
    D = to_dia(A, dtype, card)
    if nwin is not None:
        assert len(hk.dia_stage_plan(D.offs, 16, torch.float32).windows) \
            == nwin
    g = torch.Generator().manual_seed(2)
    for s in (3, 16):
        X = torch.randn(m, s, generator=g).to(dtype).to(card)
        for x in (X, _unaligned(X)):
            before = hk.LAUNCHES["dia_spmv_multirhs"]
            y = D @ x
            torch.cuda.synchronize()
            assert hk.LAUNCHES["dia_spmv_multirhs"] == before + 1
            assert y.shape == (n, s)
            assert _rel(y, hk.dia_spmv_plain(D.data, D.offs, x, n)) \
                <= LIMIT[dtype]
        if n != m:
            continue
        b = torch.randn(n, s, generator=g).to(dtype).to(card)
        dw = torch.rand(n, generator=g).to(dtype).to(card)
        for x in (X, _unaligned(X)):
            before = hk.LAUNCHES["dia_jacobi_sweep_multirhs"]
            w = hk.dia_jacobi_sweep_multirhs(D.data, D.offs, x, b, dw)
            torch.cuda.synchronize()
            assert hk.LAUNCHES["dia_jacobi_sweep_multirhs"] == before + 1
            assert _rel(w, hk.dia_jacobi_sweep_plain(D.data, D.offs, x, b,
                                                     dw)) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [3, 26])
@pytest.mark.parametrize("s", [1, 3, 16, 37, 64])
@pytest.mark.parametrize("tdt,xdt", BCSR_PAIRS)
def test_bcsr_multirhs_kernel_matches_plain(card, tdt, xdt, s, per_row):
    """s = 1, 3 and 37 take one column per lane (37: two chunks for some
    lanes), 16 and 64 16-byte column groups; at s = 16 an X that is not
    16-byte aligned takes the one-column path too."""
    A = _ragged(per_row)
    n, m = A.shape
    B = to_bcsr(A, tdt, device=card)
    X = torch.as_tensor(np.random.RandomState(s).randn(m, s)).to(xdt)
    xs = [X.to(card)]
    if s == 16:
        buf = torch.empty(m * s + 1, dtype=xdt, device=card)
        buf[1:].copy_(xs[0].reshape(-1))
        xs.append(buf[1:].view(m, s))
    for x in xs:
        before = hk.LAUNCHES["bcsr_spmv_multirhs"]
        y = B @ x
        torch.cuda.synchronize()
        assert hk.LAUNCHES["bcsr_spmv_multirhs"] == before + 1
        assert y.shape == (n, s)
        assert _rel(y, hk.bcsr_spmv_plain(B.row_ptr, B.col_idx, B.values,
                                          x, n)) <= LIMIT[y.dtype]
        # column q of the block product is the 1-RHS product of column q
        y1 = B @ x[:, s - 1].contiguous()
        assert _rel(y[:, s - 1], y1) <= LIMIT[y.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 50), (100, 50)])
def test_bcsr_kernels_on_empty_matrices(card, shape):
    """No rows, or rows with no nonzero: y is empty or zero."""
    B = to_bcsr(sp.csr_matrix(shape), torch.float32, device=card)
    for x in (torch.ones(shape[1], device=card),
              torch.ones(shape[1], 16, device=card)):
        y = B @ x
        torch.cuda.synchronize()
        assert y.shape == (shape[0],) + tuple(x.shape[1:])
        assert not y.any()


@pytest.mark.cuda
def test_bcsr_kernels_reject_what_they_do_not_take(card):
    A = _ragged(3, n=1000, m=500)
    B = to_bcsr(A, torch.float32, device=card)
    with pytest.raises(ValueError, match="s <= 64"):
        B @ torch.ones(500, 65, device=card)
    with pytest.raises(ValueError, match="devices"):
        B @ torch.ones(500)
    with pytest.raises(ValueError, match="devices"):
        hk.bcsr_spmv_multirhs(B.row_ptr, B.col_idx, B.values.cpu(),
                              torch.ones(500, 2, device=card), 1000)
    Bd = to_bcsr(A, torch.float64, device=card)
    with pytest.raises(ValueError, match="dtypes"):
        Bd @ torch.ones(500, device=card)
    with pytest.raises(ValueError, match="dtypes"):
        B @ torch.ones(500, 4, device=card, dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_matches_plain(card, dtype):
    """Rows not a multiple of the block: the ragged edge is masked."""
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    rng = np.random.RandomState(3)
    A = sp.random(30_001, 9_000, density=8 / 9_000, random_state=rng,
                  format="csr")
    E = from_scipy(A, dtype=dtype, device=card)
    x = torch.as_tensor(rng.randn(9_000)).to(dtype).to(card)
    before = hk.LAUNCHES["ell_spmv"]
    y = E @ x
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_spmv"] == before + 1
    assert _rel(y, hk.ell_spmv_plain(E.indices, E.values, x)) \
        <= LIMIT[dtype]
    ref = A @ x.double().cpu().numpy()
    assert np.abs(y.double().cpu().numpy() - ref).max() \
        <= LIMIT[dtype] * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [6, 343])
def test_ell_kernel_bf16(card, k, xdt):
    """bf16 values with bf16 or f32 x (the bf16 cycle's pairs), summed in
    f32, y in the promoted dtype: within 1e-2 of the plain version at
    the high-order A0's k = 343 (G = 16 lanes, S = 4 slots, the rest of
    each row looped) and at a small k."""
    n = 40_001 if k == 343 else 100_001
    idx, val, x = (t.to(card) for t in _ell_operand(n, 20_001, k,
                                                    torch.float32, seed=k))
    val, x = val.to(torch.bfloat16), x.to(xdt)
    before = hk.LAUNCHES["ell_spmv"]
    y = hk.ell_spmv(idx, val, x)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_spmv"] == before + 1
    assert y.dtype == torch.promote_types(torch.bfloat16, xdt)
    assert _rel(y, hk.ell_spmv_plain(idx, val, x)) <= LIMIT[torch.bfloat16]
    assert not y[(val == 0).all(1)].any()


def _ell_operand(n, m, k, dtype, seed):
    """(n, k) ELL indices and values as from_scipy lays them out (row r
    holds r % (k + 1) entries, every 7th row none, padding at column 0
    with value 0), one entry at column m - 1, and x (m,)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, m, (n, k)).astype(np.int32)
    val = rng.randn(n, k)
    fill = np.arange(n) % (k + 1)
    fill[::7] = 0
    pad = np.arange(k)[None, :] >= fill[:, None]
    idx[pad], val[pad] = 0, 0
    idx[n // 2, 0], val[n // 2, 0] = m - 1, 1.5
    return (torch.as_tensor(idx), torch.as_tensor(val).to(dtype),
            torch.as_tensor(rng.randn(m)).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 6, 27, 33])
def test_ell_kernel_widths(card, k, dtype):
    """Each width's plan (G lanes, S slots) on 10,001 rows, a ragged last
    block, and on 300,001 rows, more threads than the card holds at
    once."""
    for n in (10_001, 300_001):
        idx, val, x = (t.to(card) for t in _ell_operand(n, 3_001, k, dtype,
                                                        seed=k))
        before = hk.LAUNCHES["ell_spmv"]
        y = hk.ell_spmv(idx, val, x)
        torch.cuda.synchronize()
        assert hk.LAUNCHES["ell_spmv"] == before + 1
        yp = hk.ell_spmv_plain(idx, val, x)
        assert _rel(y, yp) <= LIMIT[dtype], (n, k, hk.ell_launch_plan(n, k))
        assert y[n // 2] != 0 and not y[(val == 0).all(1)].any()


@pytest.mark.cuda
def test_new_kernels_reject_what_they_do_not_take(card):
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    D = to_dia(_stencil(1000), torch.float32, card)
    with pytest.raises(ValueError, match="s <= 64"):
        hk.dia_spmv_multirhs(D.data, D.offs,
                             torch.ones(1000, 65, device=card), 1000)
    with pytest.raises(ValueError, match="dtypes"):
        hk.dia_spmv_multirhs(D.data, D.offs, torch.ones(
            1000, 2, device=card, dtype=torch.float64), 1000)
    E = from_scipy(_stencil(1000), dtype=np.float32, device=card)
    with pytest.raises(ValueError, match="one-dimensional"):
        E @ torch.ones(1000, 2, device=card)
    # ELL takes f32/f32, f64/f64, bf16/bf16 and bf16/f32 only
    Eb = from_scipy(_stencil(1000), dtype=torch.bfloat16, device=card)
    for xdt in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="dtypes"):
            Eb @ torch.ones(1000, device=card, dtype=xdt)
    with pytest.raises(ValueError, match="dtypes"):
        E @ torch.ones(1000, device=card, dtype=torch.bfloat16)
    Eh = from_scipy(_stencil(1000), dtype=torch.float16, device=card)
    with pytest.raises(ValueError, match="dtypes"):
        Eh @ torch.ones(1000, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="one-dimensional"):
        Eb @ torch.ones(1000, 2, device=card, dtype=torch.bfloat16)


@pytest.mark.cuda
def test_multirhs_flagship_small_on_card(card):
    from parelag_tpu_torch import flagship as fl
    rec, _ = fl.lane_h1(16, card, n_rhs=4, min_coarse=64)
    mr = rec["multirhs"]
    assert mr["converged"] and mr["rel_res_max"] <= 1e-4
    assert mr["col0_rel_diff"] <= 1e-3
    for k in ("dia_spmv_multirhs", "dia_jacobi_sweep_multirhs",
              "bcsr_spmv_multirhs"):
        assert mr["kernels"][k] > 0, mr["kernels"]


@pytest.mark.cuda
def test_maxwell_small_on_card(card):
    from parelag_tpu_torch import maxwell_lane as ml
    rec, _ = ml.lane_maxwell(6, card)
    assert rec["rel_res"] <= 1e-6 or "rel_res_floor" in rec
    assert rec["kernels"]["ell_spmv"] > 0, rec["kernels"]


@pytest.mark.cuda
def test_zero_gram_eigenvalues_on_card(card):
    """An exactly-zero f32 Gram batch at the 16^3 chain's batch size:
    f32 eigvalsh on the card returns NaN for it; the setup's _eigvalsh
    gives zeros in f32."""
    from parelag_tpu_torch.amge.structured import _eigvalsh
    ev = _eigvalsh(torch.zeros((1944, 3, 3), device=card))
    assert ev.dtype == torch.float32 and ev.is_cuda
    assert not ev.any()


@pytest.mark.cuda
def test_device_solve_groups_on_card(card):
    """The 'device' backend of solve_groups on the card against the host
    backend: regular members within 1e-10, exactly singular and all-zero
    members finite (LU info / residual flag, host lstsq repair)."""
    from parelag_tpu_torch.ops import batched
    rng = np.random.RandomState(0)
    n, k = 9, 3
    A = rng.randn(40, n, n) + n * np.eye(n)
    U = rng.randn(n, n - 3)
    A[5] = U @ U.T                                 # rank n - 3
    A[6] = 0.0                                     # all zero
    B = rng.randn(40, n, k)
    Xd = batched.solve_groups([A], [B], backend="device", device=card)[0]
    Xh = batched.solve_groups([A], [B], backend="host")[0]
    assert np.isfinite(Xd).all() and Xd.flags.c_contiguous
    assert not Xd[6].any()
    reg = np.setdiff1d(np.arange(40), [5, 6])
    assert np.abs(Xd[reg] - Xh[reg]).max() <= 1e-10 * np.abs(Xh[reg]).max()


@pytest.mark.cuda
def test_svd_basis_on_card(card):
    from parelag_tpu_torch.ops import batched
    rng = np.random.RandomState(1)
    mats = [rng.randn(7, 3) for _ in range(70)] + [np.zeros((7, 3))]
    for (Ud, sd), (Uh, sh) in zip(
            batched.batched_svd_basis(mats, backend="device", device=card),
            batched.batched_svd_basis(mats, backend="host")):
        assert np.isfinite(Ud).all() and np.abs(sd - sh).max() <= 1e-10


def _generic_operators(card):
    """The BCSR operators of the generic engine's f32 hierarchy on the
    card (H1 chain at 16^3 over 3 levels, host backend), as the path
    gives them (hierarchy.level_operators)."""
    from parelag_tpu_torch import generic_lane
    from parelag_tpu_torch.ops.device_sparse import BcsrMatrix
    from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    seqs, A, _, _ = generic_lane.build_h1(16, "host", "cpu", min_coarse=8)
    H, _, _ = build_amge_hierarchy(seqs, 0, A.astype(np.float32),
                                   sweeps=generic_lane.SWEEPS,
                                   dtype=np.float32, device=card)
    return [(label, M) for label, M in level_operators(H)
            if isinstance(M, BcsrMatrix)]


@pytest.mark.cuda
def test_bcsr_kernel_on_generic_operators(card):
    """bcsr_spmv on the generic path's uneven rows (P0: 1 to ~8 nonzeros,
    coarse RAP rows long and uneven) against its plain version."""
    ops = _generic_operators(card)
    assert len(ops) >= 3
    for label, B in ops:
        n, m = B.shape
        x = torch.as_tensor(np.random.RandomState(2).randn(m)
                            .astype(np.float32)).to(card)
        before = hk.LAUNCHES["bcsr_spmv"]
        y = B @ x
        torch.cuda.synchronize()
        assert hk.LAUNCHES["bcsr_spmv"] == before + 1, label
        yp = hk.bcsr_spmv_plain(B.row_ptr, B.col_idx, B.values, x, n)
        assert _rel(y, yp) <= LIMIT[torch.float32], label


@pytest.mark.cuda
def test_generic_lane_and_entry_on_card(card):
    from parelag_tpu_torch import entry, generic_lane
    rec, _ = generic_lane.lane_generic(16, ("host", "device"), card,
                                       min_coarse=8)
    assert rec["dims_agree"] and rec["converged"]
    assert rec["iters"] <= rec["host_iters"] + 1
    assert rec["kernels"]["bcsr_spmv"] > 0, rec["kernels"]
    fn, args = entry.entry(card)
    y = fn(*args)
    fc, ac = entry.entry("cpu")
    assert _rel(y.cpu(), fc(*ac)) <= 1e-5


def _dense_offsets(n, nd):
    """An n x n operator with nd full diagonals (offsets spread over
    +-3000, both signs, past both ends of the rows)."""
    rng = np.random.RandomState(nd)
    offs = sorted(rng.choice(np.arange(-3000, 3000), nd, replace=False))
    return sp.diags([rng.rand(n - abs(o)) for o in offs], offs).tocsr()


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


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dia_spmv_at_64_offsets(card, dtype, extra, x_route):
    """The 1-RHS DIA kernels take up to 64 offsets (to_dia_ell keeps as
    many), with x staged and read from global memory, on the table as
    to_dia gives it and widened (ld = n + 3); 65 are refused, and the
    staged multi-RHS kernel stays at 48."""
    n = 50_001
    D = to_dia(_dense_offsets(n, 64), dtype, card)
    assert len(D.offs) == 64
    data = _widened(D, extra)
    plan = hk.dia_row_plan(D.offs, n, n, dtype)
    # staged unless the windows do not fit
    assert plan.staged == (x_route.startswith("staged")
                           and plan.table_bytes * plan.tstaged
                           + plan.stage_bytes <= hk.ROW_SMEM_BYTES)
    if x_route.endswith("rt2"):
        assert plan.rows == 2
    g = torch.Generator().manual_seed(1)
    x, b, dw = (torch.randn(n, generator=g).to(dtype).to(card)
                for _ in range(3))
    before = dict(hk.LAUNCHES)
    y = hk.dia_spmv(data, D.offs, x, n)
    s = hk.dia_jacobi_sweep(data, D.offs, x, b, dw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dia_spmv"] == before["dia_spmv"] + 1
    assert hk.LAUNCHES["dia_jacobi_sweep"] == before["dia_jacobi_sweep"] + 1
    assert _rel(y, hk.dia_spmv_plain(data, D.offs, x, n)) <= LIMIT[dtype]
    assert _rel(s, hk.dia_jacobi_sweep_plain(data, D.offs, x, b, dw)) \
        <= LIMIT[dtype]
    D65 = to_dia(_dense_offsets(n, 65), dtype, card)
    with pytest.raises(ValueError, match="max 64"):
        hk.dia_spmv(D65.data, D65.offs, x, n)
    with pytest.raises(ValueError, match="max 48"):
        hk.dia_spmv_multirhs(D.data, D.offs, x[:, None].contiguous(), n)


@pytest.mark.cuda
def test_dia_ell_matrix_on_card(card):
    """A DiaEllMatrix of the 8^3 multiplier system (29 DIA offsets + a
    COO remainder): the dia_spmv kernel plus index_add_ against the same
    matrix on the CPU."""
    from parelag_tpu_torch import darcy_lane
    from parelag_tpu_torch.ops.device_sparse import to_dia_ell
    _, H, _ = darcy_lane.build_darcy_hyb(8)
    Dg = to_dia_ell(H, np.float32, device=card)
    Dc = to_dia_ell(H, np.float32, device="cpu")
    x = torch.as_tensor(np.random.RandomState(3).randn(H.shape[0])
                        .astype(np.float32))
    before = hk.LAUNCHES["dia_spmv"]
    y = Dg @ x.to(card)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dia_spmv"] == before + 1
    assert _rel(y.cpu(), Dc @ x) <= LIMIT[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_diag_inverse_on_card(card, dtype):
    """BlockDiagInverse with 1 x 1, 2 x 2 and 5 x 5 buckets on the card
    against the CPU."""
    from parelag_tpu_torch.ops.device_sparse import BlockDiagInverse
    rng = np.random.RandomState(2)
    sizes = (1, 2, 5)
    tensors = [torch.as_tensor(rng.rand(k) if s == 1 else rng.randn(k, s, s))
               .to(dtype) for s, k in zip(sizes, (300, 200, 100))]
    Bc = BlockDiagInverse(tensors, sizes)
    Bg = BlockDiagInverse([t.to(card) for t in tensors], sizes)
    r = torch.as_tensor(rng.randn(300 + 400 + 500)).to(dtype)
    assert _rel((Bg @ r.to(card)).cpu(), Bc @ r) <= LIMIT[dtype]


@pytest.mark.cuda
def test_hybridized_solve_on_card(card):
    """The 8^3 hybridized multiplier solve on the card (f32 PCG, f64
    host refinement) against the port on the CPU (f64): rtol met, x
    within 1e-6, the DIA and BCSR kernels launched."""
    from parelag_tpu_torch import darcy_lane
    hyb, H, g = darcy_lane.build_darcy_hyb(8)
    xc = hyb._device_solve(H, g, rtol=1e-8, device="cpu")
    before = dict(hk.LAUNCHES)
    xg = hyb._device_solve(H, g, rtol=1e-8, device=card)
    info = hyb.last_device
    assert info["dtype"] == "float32" and info["passes"] >= 2
    assert np.linalg.norm(g - H @ xg) <= 1e-8 * np.linalg.norm(g)
    assert np.abs(xg - xc).max() <= 1e-6 * np.abs(xc).max()
    for k in ("dia_spmv", "bcsr_spmv"):
        assert hk.LAUNCHES[k] > before[k], k


@pytest.mark.cuda
def test_darcy_block_gmres_on_card(card):
    """The blocked Darcy AMGe GMRES (f64 ELL levels) on the card: the
    CPU's cycles and the direct solve within 1e-8."""
    from parelag_tpu_torch import darcy_lane
    rg, _ = darcy_lane.lane_darcy_block(1, card)
    rc, _ = darcy_lane.lane_darcy_block(1, "cpu")
    assert rg["cycles"] == rc["cycles"] and rg["err_vs_direct"] < 1e-8
    assert rg["kernels"]["ell_spmv"] > 0, rg["kernels"]


@pytest.mark.cuda
def test_chebyshev_bf16_dia_level_on_card(card):
    """A Chebyshev smoother (degree 3) on a bf16 DIA level, as the
    flagship's bf16 preconditioner applies it: the card (dia_spmv
    launched for every residual) against the same bf16 tensors on the
    CPU (plain versions)."""
    from parelag_tpu_torch.solvers.smoothers import make_chebyshev
    n = 40
    T = sp.diags([4 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    I = sp.identity(n)
    A = (sp.kron(sp.kron(T, T), I) + sp.kron(sp.kron(I, T), T)
         + sp.kron(sp.kron(T, I), T)).tocsr().astype(np.float32)
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(A.shape[0]).astype(np.float32))
    ys = []
    for dev in ("cpu", card):
        S = make_chebyshev(A, degree=3, device=dev).to(torch.bfloat16)
        D = to_dia(A, torch.bfloat16, dev)
        bb = b.to(torch.bfloat16).to(dev)
        before = dict(hk.LAUNCHES)
        ys.append(S.apply(D, bb, torch.zeros_like(bb)))
        launched = hk.LAUNCHES["dia_spmv"] - before["dia_spmv"]
    torch.cuda.synchronize()
    assert launched == 3
    assert ys[1].dtype == torch.bfloat16
    assert _rel(ys[1].cpu(), ys[0]) <= LIMIT[torch.bfloat16]


@pytest.mark.cuda
def test_tune_cycle_on_card(card):
    """tune_cycle on the 16^3 structured hierarchy with the bf16
    preconditioner: every row's iterations within one of, and its
    converged flag equal to, the same call on the CPU."""
    from parelag_tpu_torch import flagship
    from parelag_tpu_torch.solvers.autotune import tune_cycle
    A, P, b = flagship.build_h1_structured(16, 64, device="cpu")
    kw = dict(rtol=1e-5, dtype=np.float32, matrix_format="dia",
              precond_dtype=torch.bfloat16, repeats=1)
    bg, tg = tune_cycle(A, P, b, device=card, **kw)
    _, tc = tune_cycle(A, P, b, device="cpu", **kw)
    for rg, rc in zip(tg, tc):
        assert abs(rg["iters"] - rc["iters"]) <= 1, (rg, rc)
        assert rg["converged"] == rc["converged"]
    assert bg is not None
    assert bg["hierarchy"].levels[0].A.data.is_cuda


@pytest.mark.cuda
def test_spectral_coarsen_darcy_on_card(card):
    """The structured spectral engine at (12, 12, 6) on the SPE10-like
    field in f64 on the card against the port on the CPU: per-entity
    counts exact, the upscaling error within 1e-8 relative, the spot
    oracle within 1e-8."""
    from parelag_tpu_torch import spectral_lane
    from parelag_tpu_torch.amge.structured_spectral import (
        spectral_coarsen_darcy)
    cells = (12, 12, 6)
    field, coeff = spectral_lane.spe10_coeff(cells)
    f = spectral_lane._pick_factors(cells)
    outs = [spectral_coarsen_darcy(cells, f, coeff, h=field.sizes,
                                   device=d) for d in ("cpu", card)]
    for k in ("n_facet_dofs", "n_ae_u_dofs", "n_ae_p_dofs"):
        assert np.array_equal(getattr(outs[0], k), getattr(outs[1], k)), k
    fine = spectral_lane.fine_darcy(cells, coeff, field.sizes)
    ec, eg = (spectral_lane.upscaling_error(fine, o.P2, o.P3)
              for o in outs)
    assert abs(eg - ec) <= 1e-8 * ec, (eg, ec)
    assert outs[1].ext_spot_err < 1e-8 and outs[1].ns_res < 1e-10


@pytest.mark.cuda
def test_darcy_sa_chain_on_card_has_bcsr_transfers(card):
    """The darcy SA chain built on the card: every transfer a
    BcsrMatrix (transfer_format), no TileCooMatrix on any level."""
    from parelag_tpu_torch import darcy_lane
    from parelag_tpu_torch.ops.device_sparse import BcsrMatrix
    hyb, H, g = darcy_lane.build_darcy_hyb(16)
    _, _, Hier, _, _, _ = hyb._device_setup(H, device=card)
    mats = [m for l in Hier.levels for m in (l.A, l.P, l.R)
            if m is not None]
    assert not any(type(m).__name__ == "TileCooMatrix" for m in mats)
    assert all(isinstance(l.P, BcsrMatrix) and isinstance(l.R, BcsrMatrix)
               for l in Hier.levels if l.P is not None)


@pytest.mark.cuda
def test_library_pcg_ams_on_card(card):
    """PCG + AMS through the XML solver library at nref 2 on the card:
    the Krylov loop runs on the device (executed_on), its f64 hierarchy
    is BCSR with Hiptmair's ELL operators, the true residual meets the
    rtol's reach, and iterations and x match the CPU run."""
    from parelag_tpu_torch.library_lane import (
        SCALAR, build_chain, run_composition, scalar_problem)
    from parelag_tpu_torch.ops.device_sparse import BcsrMatrix, EllMatrix
    from parelag_tpu_torch.solvers.library import SolverState
    form, entries, entry = SCALAR["PCG-AMS"]
    out = []
    for d in (card, torch.device("cpu")):
        _, seqs, _ = build_chain(2, d)
        A, b = scalar_problem(seqs, form)
        out.append(run_composition(entries, entry, A, A, b,
                                   SolverState(seqs, [form], device=d)))
    (rg, sg, xg), (rc, _, xc) = out
    assert rg["executed_on"] == "device" and rg["rel_res"] <= 1e-6
    l0 = sg._prec._H.levels[0]
    assert isinstance(l0.A, BcsrMatrix) and l0.A.values.is_cuda
    assert l0.A.values.dtype == torch.float64
    assert isinstance(l0.pre.D, EllMatrix)
    assert rg["kernels"]["bcsr_spmv"] > 0 and rg["kernels"]["ell_spmv"] > 0
    assert abs(rg["iters"] - rc["iters"]) <= 1
    assert np.abs(xg - xc).max() <= 1e-8 * np.abs(xc).max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1000, 3), (4096, 27), (333, 90)])
def test_bcsr_spmv_f64_matches_plain(card, n, k):
    """bcsr_spmv in f64 (the library's hierarchies) against its plain
    version within 1e-12, on rows of ~k nonzeros (every group width)."""
    rng = np.random.RandomState(n)
    M = sp.random(n, n, density=k / n, random_state=rng, format="csr")
    B = to_bcsr(M, torch.float64, device=card)
    x = torch.as_tensor(rng.randn(n)).to(card)
    before = hk.LAUNCHES["bcsr_spmv"]
    yk = hk.bcsr_spmv(B.row_ptr, B.col_idx, B.values, x, n)
    assert hk.LAUNCHES["bcsr_spmv"] == before + 1
    yp = hk.bcsr_spmv_plain(B.row_ptr, B.col_idx, B.values, x, n)
    assert yk.dtype == torch.float64
    assert _rel(yk, yp) <= LIMIT[torch.float64]


@pytest.mark.cuda
def test_ho_operators_on_card_match_plain(card):
    """The high-order lane at 4^3, p = 2, on the card: every operator its
    f32 hierarchy and bf16 preconditioner apply, in the format the build
    gives it (A0 BCSR, as at 16^3; BCSR transfers), kernel against
    plain; then one preconditioned solve converges with bcsr_spmv
    launched."""
    from parelag_tpu_torch import ho_lane
    from parelag_tpu_torch.kernel_profile import KERNEL_OF
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    seqs, A, b, _ = ho_lane.build_ho(4, 2, card)
    H, Hb, _, _ = ho_lane.build_solver(seqs, A, card)
    assert [type(l.P).__name__ for l in Hb.levels[:-1]] == ["BcsrMatrix"]
    assert type(Hb.levels[0].A).__name__ == "BcsrMatrix"
    assert Hb.levels[0].A.dtype == torch.bfloat16
    rng = np.random.RandomState(11)
    for label, M in level_operators(H) + level_operators(Hb):
        name = KERNEL_OF[type(M)]
        for xdt in {M.dtype, torch.float32}:
            x = torch.as_tensor(rng.randn(M.shape[1])).to(xdt).to(card)
            before = hk.LAUNCHES[name]
            y = M @ x
            torch.cuda.synchronize()
            assert hk.LAUNCHES[name] == before + 1, (label, xdt)
            if name == "ell_spmv":
                yp = hk.ell_spmv_plain(M.indices, M.values, x)
            else:
                yp = hk.bcsr_spmv_plain(M.row_ptr, M.col_idx, M.values, x,
                                        M.shape[0])
            assert _rel(y, yp) <= LIMIT[y.dtype], (label, M.dtype, xdt)
    before = dict(hk.LAUNCHES)
    x, (it, _) = ho_lane.solve(H, Hb, torch.as_tensor(
        b.astype(np.float32)).to(card))
    assert int(it) < ho_lane.MAXITER
    assert ho_lane.rel_res(A, b, x) <= 10 * ho_lane.RTOL
    assert hk.LAUNCHES["bcsr_spmv"] > before["bcsr_spmv"]


@pytest.mark.cuda
def test_coarsen_darcy_on_card_matches_cpu(card):
    """coarsen_darcy (the L2 and Hdiv stages) on a heterogeneous 8^3
    level on the card against the CPU, f64, within 1e-12; its P2 and P3
    equal."""
    from parelag_tpu_torch.amge import structured as stc
    rng = np.random.default_rng(7)
    shape = (8, 8, 8)
    per_ae = 10.0 ** rng.uniform(-2, 2, size=64)
    cc = stc.children_cells((4, 4, 4))      # the fine cells of each AE
    coeff = np.empty(512)
    coeff[cc] = per_ae[:, None]
    outs = []
    for d in (card, torch.device("cpu")):
        c, o = stc.coarsen_darcy(stc.fine_level(shape, coeff=coeff,
                                                device=d))
        outs.append((c, o, stc.materialize_P_darcy(o, shape)))
    (lg, og, Pg), (lc, oc, Pc) = outs
    for f in ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c"):
        assert _rel(getattr(og, f).cpu(), getattr(oc, f)) <= 1e-12, f
    for f in ("m03", "m12", "m02", "d2", "t3", "t2"):
        assert _rel(getattr(lg, f).cpu(), getattr(lc, f)) <= 1e-12, f
    for a, b in zip(Pg, Pc):
        assert abs(a - b).max() <= 1e-12 * abs(b).max()


@pytest.mark.cuda
def test_rcm_hierarchy_on_card(card):
    """build_amge_hierarchy(reorder='rcm') on the card: perm / iperm on
    the card, amge_pcg_solve in the permuted space with the same
    iterations (within one) and x (1e-8) as the unpermuted f64 solve."""
    from parelag_tpu_torch import ho_lane
    from parelag_tpu_torch.solvers.amge_solver import (
        amge_pcg_solve, build_amge_hierarchy)
    seqs, A, b, _ = ho_lane.build_ho(4, 1, card)
    out = []
    for reorder in (None, "rcm"):
        H, _, _ = build_amge_hierarchy(seqs, 0, A, reorder=reorder,
                                       device=card)
        out.append((H, amge_pcg_solve(H, H.levels[0].A, b, rtol=1e-10,
                                      device=card)))
    (H0, (x0, (it0, _))), (Hr, (xr, (itr, _))) = out
    assert Hr.perm.is_cuda and Hr.iperm.is_cuda and H0.perm is None
    assert abs(int(itr) - int(it0)) <= 1
    assert np.abs(xr - x0).max() <= 1e-8 * np.abs(x0).max()
    assert np.linalg.norm(b - A @ xr) <= 1e-8 * np.linalg.norm(b)


@pytest.mark.cuda
def test_rank_batched_step_on_card_matches_cpu(card):
    """The init step and one rank-batched L-level V-cycle PCG step of the
    dist lane's setup (2 ranks, grid 16 x 8 x 20) on the card equal the
    same steps on the CPU: every output within 1e-10 in f64; in f32, the
    lane's dtype, x within twice f32's own error on the CPU (its x
    against the same steps in f64 arithmetic on the same f32 tables: two
    f32 runs that far from it lie within twice it); ell_spmv runs every
    local product on the card."""
    from parelag_tpu_torch.parallel import dist_bench
    from parelag_tpu_torch.parallel.sharding import make_dd_mesh
    cpu = torch.device("cpu")
    for dtype in (np.float64, np.float32):
        _, hier, b = dist_bench.build(2, 4, dtype)
        outs = []
        for dev in (card, cpu):
            before = hk.LAUNCHES["ell_spmv"]
            st = dist_bench.steps_from_zero(hier, b,
                                            make_dd_mesh(2, dev))(1)
            torch.cuda.synchronize()
            outs.append([t.cpu().double() for t in st])
            launched = hk.LAUNCHES["ell_spmv"] - before
            assert (launched > 0) == (dev.type == "cuda"), launched
        (g, c) = outs
        if dtype == np.float64:
            for i in range(4):
                assert _rel(g[i], c[i]) <= 1e-10, i
        else:
            x64 = dist_bench.steps_from_zero(dist_bench.cast(
                hier, np.float64), b, make_dd_mesh(2, cpu))(1)[0]
            assert _rel(g[0], c[0]) <= 2 * _rel(c[0], x64)


@pytest.mark.cuda
def test_checkpoint_reload_on_card(card, tmp_path):
    """The 16^3 flagship hierarchy (DIA A, bf16 BCSR transfers) saved and
    loaded onto the card: the same BCSR launch group, a bitwise equal
    bf16 cycle, the same kernels launched."""
    from torch import nn
    from parelag_tpu_torch import flagship
    from parelag_tpu_torch.utils import checkpoint
    A, P, b = flagship.build_h1_structured(16, 64, device=card)
    H, Hb = flagship.build_solver(A, P, card)
    path = tmp_path / "h.pt"
    checkpoint.save_pytree(nn.ModuleList([H, Hb]), str(path))
    H2, Hb2 = checkpoint.load_pytree(str(path))
    assert Hb2.levels[0].P.group == Hb.levels[0].P.group
    r = torch.as_tensor(b.astype(np.float32)).to(card).to(torch.bfloat16)
    counts = []
    ys = []
    for h in (Hb, Hb2):
        before = dict(hk.LAUNCHES)
        ys.append(h.apply(r))
        torch.cuda.synchronize()
        counts.append({k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES})
    assert torch.equal(ys[0], ys[1])
    assert counts[0] == counts[1] and counts[0]["dia_jacobi_sweep"] > 0
    assert counts[0]["bcsr_spmv"] > 0


@pytest.mark.cuda
def test_multiprocess_solve_on_card(card):
    """tests/_mp_worker.py's f64 solve in 2 processes (on one card: gloo,
    both on it): the error against spsolve, equal digests, every
    process's products in ell_spmv."""
    from parelag_tpu_torch.parallel import mp_worker
    from parelag_tpu_torch.parallel.sharding import backend_for
    recs = mp_worker.launch(2, "solve", timeout=300)
    assert all(r["err"] < 1e-10 for r in recs), recs
    assert len({r["digest"] for r in recs}) == 1
    backend = backend_for(card, torch.cuda.device_count(), 2)
    assert all(r["launches"]["ell_spmv"] > 0 and r["backend"] == backend
               and r["device"].startswith("cuda") for r in recs)


@pytest.mark.cuda
def test_multiprocess_nccl_on_cards(card, tmp_path):
    """A card a process (NCCL; skips on fewer than 4 cards): the f64
    solve in 4 processes, and the dist lane in 2, each process setting
    up its own ranks: the one-process lane's tables byte for byte, x
    within twice f32's own error (on the CPU) of the one-process run."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    from parelag_tpu_torch.parallel import dist_bench, mp_worker
    from parelag_tpu_torch.parallel.sharding import make_dd_mesh
    recs = mp_worker.launch(4, "solve", timeout=300)
    assert [r["device"] for r in recs] == [f"cuda:{r}" for r in range(4)]
    assert all(r["backend"] == "nccl" and r["err"] < 1e-10 for r in recs)
    assert len({r["digest"] for r in recs}) == 1
    x_out = tmp_path / "x.npy"
    recs = mp_worker.launch(2, "dist", 4, steps=5, x_out=x_out,
                            timeout=300)
    _, hier, b = dist_bench.build(8, 4)
    assert all(r["backend"] == "nccl" and r["kernels"]["ell_spmv"] > 0
               and r["digest"] == dist_bench.table_digest(hier)
               for r in recs)
    x1 = dist_bench.time_steps(hier, b, make_dd_mesh(8, card), 5)[0]
    cpu = make_dd_mesh(8, "cpu")
    xc, x64 = (dist_bench.time_steps(h, b, cpu, 5)[0]
               for h in (hier, dist_bench.cast(hier, np.float64)))
    gap = np.linalg.norm(xc - x64) / np.linalg.norm(x64)
    x = np.load(x_out)
    assert np.linalg.norm(x - x1) / np.linalg.norm(x1) <= 2 * gap


# ---- the device-resident PCG (solvers/cg.compile_pcg, ops/graph_loop) --

LOOP_X_LIMIT = 1e-6     # the device program's x against the Python
                        # loop's, relative (bitwise is expected: the same
                        # kernels in the same order)


def _loop_check(rec):
    """A lane record's device program against its Python loop
    (flagship.loop_record's fields)."""
    assert rec["loop"] == "device" and rec["graph_nodes"] > 0
    assert rec["loop_iters"] == rec["python_loop_iters"] > 0
    assert set(rec["timed_iters"]) == {rec["loop_iters"]}
    assert rec["python_loop_x_rel"] <= LOOP_X_LIMIT
    assert rec["kernels"] == rec["python_loop_kernels"]
    assert rec["loop_tests"] == sum(i + 1 for i in rec["timed_iters"])
    # the captured body's nodes: one per counted launch of a hand kernel
    assert rec["body_own_kernel_nodes"] == rec["body_launches"] > 0
    assert rec["body_kernel_nodes"] >= rec["body_launches"]


@pytest.mark.cuda
def test_device_loop_flagship_on_card(card):
    """flagship 24^3, 1 and 16 right-hand sides: the compiled solve
    against the Python loop."""
    from parelag_tpu_torch import flagship as fl
    rec, _ = fl.lane_h1(24, card, n_rhs=16)
    _loop_check(rec)
    _loop_check(rec["multirhs"])
    assert rec["kernels"]["dia_jacobi_sweep"] > 0
    assert rec["multirhs"]["kernels"]["dia_jacobi_sweep_multirhs"] > 0


@pytest.mark.cuda
def test_device_loop_lanes_on_card(card):
    """Maxwell 8^3 (Hiptmair, BCSR and ELL), generic 8^3 (AMGe) and
    ho_p2 4^3 (bf16 BCSR A0): each compiled solve against its Python
    loop."""
    from parelag_tpu_torch import generic_lane, ho_lane
    from parelag_tpu_torch import maxwell_lane as ml
    rec, _ = ml.lane_maxwell(8, card)
    _loop_check(rec)
    assert rec["kernels"]["ell_spmv"] > 0
    rec, _ = generic_lane.lane_generic(8, device=card)
    _loop_check(rec)
    rec, _ = ho_lane.lane_ho(4, device=card)
    _loop_check(rec)
    assert rec["kernels"]["bcsr_spmv"] > 0


def _spd_on(card, n=3000, seed=5, dtype=np.float32):
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=6 / n, random_state=rng, format="csr")
    A = (M @ M.T + 4 * sp.eye(n)).tocsr()
    b = torch.as_tensor(rng.randn(n).astype(dtype)).to(card)
    return from_scipy(A, dtype=dtype, device=card), b


@pytest.mark.cuda
def test_compiled_pcg_two_b_edges_and_counts(card):
    """Two b through one capture give two fresh Python loops' x and
    iterations; zero iterations (r0.z0 <= atol^2) and the maxiter cap
    stop where pcg stops; each replay counts init + body x iterations
    launches; the body's hand-kernel nodes equal its counted launches."""
    from parelag_tpu_torch.ops import graph_loop as gl
    from parelag_tpu_torch.solvers.cg import compile_pcg, pcg
    A, b = _spd_on(card)
    solve = compile_pcg(A.matvec, b, rtol=1e-5, atol=0.0)
    prog = solve.program
    assert prog.body_nodes[2] == sum(prog.body.values()) == 2
    for v in (b, 2 * b + 1):
        before = gl.snapshot()
        x, (it, nom) = solve(v)
        d = gl.delta(gl.snapshot(), before)
        xp, (itp, nomp) = pcg(A.matvec, v, rtol=1e-5, atol=0.0)
        assert it == itp > 0 and torch.equal(x, xp)
        assert torch.equal(nom, nomp)
        assert d["ell_spmv"] == 1 + it and d["pcg_loop_test"] == 1 + it
    x, (it, _) = compile_pcg(A.matvec, b, rtol=1e-5, atol=1e3)(b)
    assert it == 0 and not x.any()
    x, (it, _) = compile_pcg(A.matvec, b, rtol=1e-12, atol=0.0,
                             maxiter=3)(b)
    xp, (itp, _) = pcg(A.matvec, b, rtol=1e-12, atol=0.0, maxiter=3)
    assert it == itp == 3 and torch.equal(x, xp)


@pytest.mark.cuda
def test_compiled_pcg_host_read_raises_at_capture(card):
    """A body that reads the card from the host cannot be captured: the
    capture raises (nothing falls back to the Python loop), and the card
    and the allocator work after it."""
    from parelag_tpu_torch.solvers.cg import compile_pcg, pcg
    A, b = _spd_on(card)

    def matvec(v):
        y = A.matvec(v)
        if float(y.sum()) == 12345.0:          # a host read
            y = y + 1
        return y

    with pytest.raises(RuntimeError):
        compile_pcg(matvec, b, rtol=1e-5, atol=0.0)
    torch.cuda.empty_cache()
    x, (it, _) = compile_pcg(A.matvec, b, rtol=1e-5, atol=0.0)(b)
    xp, (itp, _) = pcg(A.matvec, b, rtol=1e-5, atol=0.0)
    assert it == itp and torch.equal(x, xp)


@pytest.mark.cuda
@pytest.mark.parametrize("s, dtype", [(1, torch.float32),
                                      (16, torch.float32),
                                      (1, torch.float64),
                                      (64, torch.float64)])
def test_pcg_loop_test_kernel_matches_plain(card, s, dtype):
    from parelag_tpu_torch.ops import graph_loop as gl
    rng = np.random.RandomState(s)
    for case in range(10):
        tol2 = torch.as_tensor(rng.rand(s) + 0.1).to(dtype)
        nom = tol2 * torch.as_tensor(rng.choice([0.5, 1.0, 2.0], s)
                                     ).to(dtype)
        if case == 1:
            nom = tol2.clone()
        if case == 2:
            nom[0] = float("nan")
        it0 = 9 if case in (3, 4) else int(rng.randint(0, 9))
        out = []
        for on in ("cpu", card):
            it = torch.tensor(it0, dtype=torch.int32, device=on)
            go = torch.zeros((), dtype=torch.bool, device=on)
            gl.pcg_loop_test(nom.to(on), tol2.to(on), it, 10, case % 2, go)
            out.append((int(it), bool(go)))
        assert out[0] == out[1], (case, out)
    with pytest.raises(ValueError):
        gl.pcg_loop_test(torch.ones(65, device=card),
                         torch.ones(65, device=card),
                         torch.zeros((), dtype=torch.int32, device=card), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("steps_per_sync", [1, 3])
def test_pcg_stepper_on_card(card, steps_per_sync):
    """make_pcg_stepper's two graphs (init, step) against the same
    stepper on the CPU."""
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    from parelag_tpu_torch.solvers.cg import make_pcg_stepper
    A, b = _spd_on(card, dtype=np.float64)
    rng = np.random.RandomState(5)
    M = sp.random(3000, 3000, density=6 / 3000, random_state=rng,
                  format="csr")
    Ac = from_scipy((M @ M.T + 4 * sp.eye(3000)).tocsr(),
                    dtype=np.float64, device="cpu")
    solve = make_pcg_stepper(A.matvec, steps_per_sync=steps_per_sync)
    solve_c = make_pcg_stepper(Ac.matvec, steps_per_sync=steps_per_sync)
    for v in (b, 3 * b):
        x, (it, nom) = solve(v, rtol=1e-10)
        xc, (itc, _) = solve_c(v.cpu(), rtol=1e-10)
        assert it == itc and it % steps_per_sync == 0
        assert (x.cpu() - xc).abs().max() <= 1e-9 * xc.abs().max()
