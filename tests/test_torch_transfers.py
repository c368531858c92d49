"""The formats on the card.  Transfers (ROADMAP C2): P and R are BCSR on
a CUDA device and ELL on the CPU, where the JAX package's rule on its
8 x 128 tile counts would pick TileCoo.  A (ROADMAP C3):
hierarchy.a_format sends an operator whose ELL table would be mostly
padding to BCSR.  The 'meta' device stands in for the card in
build_hierarchy: it allocates nothing."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu_torch.ops.device_sparse import BC, BR, bcsr_stats
from parelag_tpu_torch.solvers import hierarchy as th
from parelag_tpu_torch.solvers.autotune import _factory


def _jax_rule(M, itemsize):
    """The JAX build_hierarchy's transfer choice
    (parelag_tpu/solvers/hierarchy.py, to_dev_transfer): BCSR while its
    padded tiles stay within 4x of the nonempty ones, else TileCoo,
    else ELL."""
    nbr, kb, ntiles = bcsr_stats(M)
    bcsr_b = nbr * kb * BR * BC * itemsize
    coo_b = ntiles * BR * BC * itemsize
    if bcsr_b <= min(max(4 * coo_b, 64e6), 1.5e9):
        return "bcsr"
    return "tilecoo" if coo_b <= 1.5e9 else "ell"


def _wide_restriction():
    """A restriction with the darcy SA R0's tile statistics at a small
    size: 512 rows over 512,000 columns, one row block dense in column
    tiles (4,000 of them) and the other 63 one tile each, so the padded
    BCSR array (64 x 4,000 tiles) is 60x the nonempty tiles."""
    n, m = 512, 4000 * BC
    rows = np.concatenate([np.zeros(4000, np.int64), np.arange(8, n)])
    cols = np.concatenate([np.arange(4000) * BC, np.arange(8, n) * 7])
    return sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, m))


def test_transfer_format_is_bcsr_on_the_card():
    R = _wide_restriction()
    assert _jax_rule(R, 2) == "tilecoo"
    assert th.transfer_format(torch.device("cuda", 0)) == "bcsr"
    assert th.transfer_format("cuda") == "bcsr"
    assert th.transfer_format("cpu") == "ell"
    assert th.transfer_format("cuda", matrix_format="ell") == "ell"


def test_build_hierarchy_stores_bcsr_transfers_off_the_cpu():
    """A 2-level hierarchy with that transfer: BCSR P and R on the
    stand-in card (no TileCooMatrix), ELL on the CPU."""
    P = _wide_restriction().T.tocsr()                # 512,000 x 512
    A0 = sp.identity(P.shape[0], format="csr")
    A1 = (P.T @ P).tocsr() + sp.identity(P.shape[1], format="csr")
    for dev, fmt in (("meta", "BcsrMatrix"), ("cpu", "EllMatrix")):
        H = th.build_hierarchy(
            [A0, A1], [P], _factory(dict(smoother="l1jacobi"), dev),
            dtype=np.float32, transfer_dtype=torch.bfloat16, device=dev)
        lvl = H.levels[0]
        assert type(lvl.P).__name__ == type(lvl.R).__name__ == fmt
        assert lvl.R.shape == (512, P.shape[0])


def _padded_rows(n=2048, seed=0):
    """A matrix with the ho_p2 A0's trouble at a small size: one row of
    343 nonzeros among rows of 5 spread over the columns, so its ELL
    table would hold ~66 slots a nonzero, and its JAX tile array fails
    the tile test (the rule that sent the ho_p2 A0 to ELL)."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.repeat(np.arange(1, n), 5),
                           np.zeros(343, np.int64)])
    cols = np.concatenate([rng.randint(0, n, 5 * (n - 1)),
                           rng.choice(n, 343, replace=False)])
    M = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    return (M + M.T + 20 * sp.identity(n)).tocsr()


def test_padded_a_goes_to_bcsr_on_the_card():
    """ROADMAP C3: on the stand-in card an operator whose ELL table
    would be mostly padding is a BcsrMatrix, asked as "auto" or through
    the "dia" fall-through, and stays one in the bf16 cast; the CPU
    keeps ELL."""
    A = _padded_rows()
    nbr, kb, _ = bcsr_stats(A)
    k = int(np.diff(A.indptr).max())
    slots = nbr * kb * BR * BC
    assert slots * 4 <= (1 << 29) and slots > 128 * A.nnz   # tile test: ELL
    assert A.shape[0] * k > th.ELL_MAX_FILL * A.nnz
    for fmt in ("auto", "dia"):
        for dev, name in (("meta", "BcsrMatrix"), ("cpu", "EllMatrix")):
            H = th.build_hierarchy([A], [], _factory(
                dict(smoother="l1jacobi"), dev), dtype=np.float32,
                matrix_format=fmt, device=dev)
            Hb = H.cast(torch.bfloat16)
            assert type(H.levels[0].A).__name__ == name, (fmt, dev)
            assert type(Hb.levels[0].A).__name__ == name
            assert Hb.levels[0].A.values.dtype == torch.bfloat16


@pytest.mark.parametrize("lane,stats,fmt", [
    # (rows, nonzeros, longest row, value bytes, JAX tile count) of each
    # lane's operator on the H100 (kernel_profile --formats)
    ("ho_p2 A0", (117649, 11710909, 343, 4, 514745), "bcsr"),
    ("spe10 L1 SA A0", (32768, 3633870, 241, 4, 348160), "bcsr"),
    ("generic 64^3 A0", (274625, 6765657, 27, 4, 308961), "ell"),
    ("library form-0 A0", (274625, 6765657, 27, 8, 2025411), "ell"),
    ("library form-1 A0", (811200, 25082568, 33, 8, 2737800), "ell"),
    ("darcy SA A0", (1048576, 8668672, 11, 4, 1179648), "ell"),
    ("darcy SA A1", (71469, 4523720, 99, 4, 223350), "ell"),
    ("Maxwell 24^3 A0", (45000, 1180752, 33, 4, 73125), "bcsr"),
    ("generic 64^3 A1", (35937, 912673, 27, 4, 26958), "bcsr"),
])
def test_a_format_on_the_lanes_statistics(lane, stats, fmt):
    """ROADMAP C3 as a pure function: the padded ho_p2 A0 (3.45 slots a
    nonzero) and SPE10 L1 A0 (2.17) take BCSR; every other operator keeps
    the format it had before the fill bound."""
    n, nnz, k, itemsize, tiles = stats
    assert th.a_format((n, n), nnz, k, itemsize, tiles) == fmt
