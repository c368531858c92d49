"""The ELL kernel's launch plan and its arithmetic, on the CPU.
hopper_kernels.ell_launch_plan decides how csrc/ell.cu cuts a product
(G lanes a row, S slots a lane, the block count), so these tests hold
the plan to its numbers for k in {1, 2, 6, 27, 33} and on the Maxwell
lane's three ELL operators at 24^3 (counted from the grid's sizes), and
emulate the kernel thread by thread in numpy from a plan
(csrc/row_spmv.cuh at one row a group: each lane's slots in order, then
its strided rest, then the xor-shuffle tree, lane 0 storing) against
ell_spmv_plain and ell_spmv_pallas in interpret mode: f32 within 1e-6
relative, f64 within 1e-12.  Inputs come from numpy seeds and hold
padded rows, empty rows and a ragged last group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parelag_tpu.ops.pallas_kernels import ell_spmv_pallas
from parelag_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(1)

LIMIT = {np.float32: 1e-6, np.float64: 1e-12}
PALLAS_TILE = 256            # ell_spmv_pallas's default row tile


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _plan(n, lanes, slots):
    """A plan forced to (G, S), its grid counted here."""
    return hk.EllPlan(lanes, slots, -(-n * lanes // hk.ELL_THREADS))


@pytest.mark.parametrize("k,lanes,slots", [
    (1, 1, 1), (2, 1, 2), (6, 2, 4), (27, 8, 4), (33, 16, 4)])
def test_ell_plan_by_width(k, lanes, slots):
    """Where rows are many, the fewest lanes that cover k at 4 slots a
    lane, up to 16 (k = 33 then loops over its last slot), and the fewest
    slots that cover k with them; a block of 256 threads for every
    256 / G rows."""
    n = 1_000_001
    assert hk.ell_launch_plan(n, k) == hk.EllPlan(
        lanes, slots, -(-n * lanes // 256))


# SMs of an H100: the least blocks a plan gives a grid, lanes allowing
H100_SMS = 132


@pytest.mark.parametrize("n,k,plan", [
    (10_000, 1, (1, 1, 40)), (10_000, 2, (2, 1, 79)),
    (10_000, 6, (4, 2, 157)), (10_000, 27, (8, 4, 313)),
    (1_000, 27, (16, 2, 63)), (343, 27, (16, 2, 22))])
def test_ell_plan_fills_the_card(n, k, plan):
    """Fewer rows than fill 132 blocks take more lanes while the row has
    slots for them (up to 16), at fewer slots each."""
    assert hk.ell_launch_plan(n, k) == hk.EllPlan(*plan)


def test_ell_plan_maxwell_24():
    """D0 (edges x vertices, 2 a row), D0^T (at most 6 edges a vertex)
    and A_aux = D0^T A D0 (27 a row) of the 24^3 lane: each launches at
    least one block for each of the card's SMs."""
    nv, ne = 25 ** 3, 3 * 24 * 25 ** 2
    plans = {name: hk.ell_launch_plan(n, k) for name, n, k in (
        ("D0", ne, 2), ("D0^T", nv, 6), ("A_aux", nv, 27))}
    assert (ne, nv) == (45_000, 15_625)
    assert plans == {"D0": hk.EllPlan(1, 2, 176),
                     "D0^T": hk.EllPlan(4, 2, 245),
                     "A_aux": hk.EllPlan(8, 4, 489)}
    for p in plans.values():
        assert p.blocks >= H100_SMS


def test_ell_plan_flagship_p0():
    """P0 of the 96^3 flagship as ELL (912,673 rows, k = 8): 2 lanes of
    4 slots a row."""
    assert hk.ell_launch_plan(912_673, 8) == hk.EllPlan(2, 4, 7_131)


def emulate(indices, values, x, plan):
    """csrc/ell.cu's y for `plan`, thread by thread in numpy, in the
    kernel's order of sums; asserts that each row is stored once."""
    n, k = values.shape
    m = x.shape[0]
    G, S = plan.lanes, plan.slots
    t = np.arange(plan.blocks * hk.ELL_THREADS)
    row, lane = t // G, t % G
    idx, val = indices.ravel(), values.ravel()
    y = np.zeros(n, values.dtype)
    stored = np.zeros(n, int)

    def product(j, hi):
        """Each thread's entry j of its row (0 past the row's end or for
        a column outside [0, m))."""
        c = np.where(j < hi, idx[np.minimum(j, idx.size - 1)], -1)
        v = np.where(j < hi, val[np.minimum(j, val.size - 1)], 0)
        ok = (c >= 0) & (c < m)
        return np.where(ok, v * x[np.where(ok, c, 0)], 0).astype(x.dtype)

    lo, hi = np.minimum(row, n) * k, np.minimum(row + 1, n) * k
    acc = np.zeros(t.size, x.dtype)
    j = lo + lane
    for _ in range(S):
        acc += product(j, hi)
        j += G
    while (j < hi).any():
        acc += product(j, hi)
        j += G
    a = acc.reshape(-1, G)
    o = G // 2
    while o:
        a = a + a[:, np.arange(G) ^ o]
        o //= 2
    acc = a.ravel()
    st = (row < n) & (lane == 0)
    y[row[st]] = acc[st]
    stored[row[st]] += 1
    assert (stored == 1).all()
    return y


def _ell(n, m, k, dtype, seed):
    """An (n, k) ELL operand as from_scipy lays it out: row r holds r % (k
    + 1) entries (every 7th row empty), padding at column 0 with value 0,
    and one entry at column m - 1."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, m, (n, k)).astype(np.int32)
    val = rng.randn(n, k).astype(dtype)
    fill = np.arange(n) % (k + 1)
    fill[::7] = 0
    pad = np.arange(k)[None, :] >= fill[:, None]
    idx[pad], val[pad] = 0, 0
    idx[n // 2, 0] = m - 1
    val[n // 2, 0] = 1.5
    return idx, val, rng.randn(m).astype(dtype)


PLANS = [(1, 1), (1, 4), (2, 1), (2, 4), (8, 1), (8, 4), (16, 2),
         (32, 1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 2, 6, 27, 33])
def test_ell_emulation_matches_plain_and_pallas(k, dtype):
    """The plan's own cut and forced cuts (more and fewer lanes than k, a
    strided rest past S * G slots), on 1,001 rows: the last block is
    ragged for every G, and the Pallas kernel takes the rows padded to
    its tile."""
    n, m = 1_001, 700
    idx, val, x = _ell(n, m, k, dtype, seed=k)
    yp = hk.ell_spmv_plain(torch.as_tensor(idx), torch.as_tensor(val),
                           torch.as_tensor(x)).numpy()
    npad = -(-n // PALLAS_TILE) * PALLAS_TILE
    ipad = np.zeros((npad, k), np.int32)
    vpad = np.zeros((npad, k), dtype)
    ipad[:n], vpad[:n] = idx, val
    yj = np.asarray(ell_spmv_pallas(jnp.asarray(ipad), jnp.asarray(vpad),
                                    jnp.asarray(x), interpret=True))[:n]
    plans = [hk.ell_launch_plan(n, k)] + [_plan(n, *p) for p in PLANS]
    for plan in plans:
        ye = emulate(idx, val, x, plan)
        assert ye.dtype == dtype
        assert _rel(ye, yp) <= LIMIT[dtype], plan
        assert _rel(ye, yj) <= LIMIT[dtype], plan


def test_ell_emulation_bounds_check():
    """A column outside [0, m) reads 0 in the kernel."""
    idx, val, x = _ell(300, 50, 6, np.float64, seed=9)
    bad = idx.copy()
    bad[5, 0], bad[6, 1] = 50, -3
    plan = hk.ell_launch_plan(300, 6)
    ye = emulate(bad, val, x, plan)
    ok = val.copy()
    ok[5, 0] = ok[6, 1] = 0
    ref = emulate(idx, ok, x, plan)
    assert _rel(ye, ref) <= 1e-15
