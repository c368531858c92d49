"""The transfer format on the card (ROADMAP C2): P and R are BCSR on a
CUDA device and ELL on the CPU, where the JAX package's rule on its
8 x 128 tile counts would pick TileCoo.  The 'meta' device stands in
for the card in build_hierarchy: it allocates nothing."""

import numpy as np
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
