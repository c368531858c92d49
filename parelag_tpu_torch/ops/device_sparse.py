"""Device sparse-matrix formats (PyTorch).

Counterpart of parelag_tpu/ops/device_sparse.py.  Every format is an
nn.Module whose tensors are registered buffers, so `Module.to(device)`
moves it and `Module.to(dtype)` casts its floating values while leaving
the integer index arrays alone (Hierarchy.cast relies on this).  The
structure metadata (shape, offsets, padding) are plain attributes.

  DiaMatrix      gather-free shift SpMV; matvec and fused Jacobi sweeps
                 go through ops/hopper_kernels (dia_spmv /
                 dia_jacobi_sweep, and their _multirhs kernels for
                 (n, s) inputs)
  BcsrMatrix     the nonzeros in row order (row_ptr, col_idx, values),
                 not the JAX package's 8 x 128 tiles; matvec through
                 hopper_kernels.bcsr_spmv (bcsr_spmv_multirhs for (m, s))
  TileCooMatrix  only the nonempty tiles, with a segment-sum over row
                 blocks (index_add_, plain torch as XLA's segment_sum in
                 JAX, for (m,) and (m, s) alike)
  EllMatrix      padded rows (gather + row reduce); matvec through
                 hopper_kernels.ell_spmv (the kernel for a 1-D x on the
                 card, where the JAX ell_matvec_best takes the Pallas
                 kernel wherever it lowers)
  CooMatrix      row, column, value triples; the matvec is a gather and
                 an index_add_ (plain torch, as XLA's scatter-add in JAX)
  DiaEllMatrix   A = D + R: the densest diagonals as a DiaMatrix (the
                 dia_spmv kernel), the rest as a CooMatrix
  BlockDiagInverse  block-diagonal inverse over contiguous same-size
                 blocks: elementwise for 1 x 1 blocks, one batched
                 (k, s, s) einsum otherwise (plain torch, as in JAX)

Every matvec takes x of shape (m,) or (m, s), as the JAX formats do.
The DIA table is kept at its logical width n: the CUDA kernel bounds-
checks its x reads, so the 8192-row tile padding of the TPU layout is
not needed; nor is to_coo's padding of the nonzeros to a multiple of
8192 (a TPU shape bucket).  The converters (from_scipy, to_bcsr,
to_tilecoo, to_dia, to_coo, to_dia_ell) put the matrix on the card
unless the caller names another device.
"""

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import hopper_kernels as hk


def as_torch_dtype(dtype):
    """torch dtype of a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[name]


def _tensor(a, dtype=None, device="cpu"):
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return t.to(device)


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


class EllMatrix(nn.Module):
    """ELL layout: indices (n, k) int32, values (n, k); padding entries
    point at column 0 with value 0.  The matvec is hopper_kernels.
    ell_spmv: the CUDA kernel on the card (1-D x; f32, f64, bf16, or
    bf16 values with f32 x), its plain gather + row reduce on the CPU."""

    def __init__(self, indices, values, shape):
        super().__init__()
        self.register_buffer("indices", indices)
        self.register_buffer("values", values)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.values.dtype

    def matvec(self, x):
        return hk.ell_spmv(self.indices, self.values, x)

    def __matmul__(self, x):
        return self.matvec(x)


def ell_matvec_T(A, x):
    """y = A^T x of an EllMatrix (n, m) by a scatter-add of its
    entries (restriction when only P is stored); x (n,)."""
    contrib = (A.values * x[:, None]).reshape(-1)
    y = torch.zeros(A.shape[1], dtype=contrib.dtype, device=x.device)
    return y.index_add_(0, A.indices.reshape(-1).long(), contrib)


def from_scipy(A, dtype=None, device=None) -> EllMatrix:
    """Convert scipy sparse to device ELL."""
    device = resolve_device(device)
    A = sp.csr_matrix(A)
    n, m = A.shape
    dtype = dtype or A.dtype
    nnz_per_row = np.diff(A.indptr)
    k = max(int(nnz_per_row.max()) if n else 0, 1)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float64)
    if A.nnz:
        rows = np.repeat(np.arange(n), nnz_per_row)
        within = (np.arange(A.nnz)
                  - np.repeat(A.indptr[:-1], nnz_per_row))
        indices[rows, within] = A.indices
        values[rows, within] = A.data
    return EllMatrix(_tensor(indices, device=device),
                     _tensor(values, dtype, device), (n, m))


BR, BC = 8, 128     # the TPU tile: BCSR's structure counts, TileCoo's tiles


class BcsrMatrix(nn.Module):
    """The JAX BcsrMatrix's matrix, stored as its nonzeros in row order:
    row_ptr (n + 1) int32, col_idx (nnz) int32 and values (nnz), sorted
    by (row, column), with no duplicates and no explicit zeros.

    The JAX package stores dense 8 x 128 tiles, the shape of the TPU's
    matrix unit and lanes; like the other TPU workarounds it is not
    ported.  On the V-cycle's transfers those tiles are 1-3 % full, and
    on the H100 the product is bound by the bytes it reads, so the port
    keeps only the nonzeros: no device holds or streams the padding.
    What the format choice and the flop model count of the tile layout
    stays as plain attributes: nbr row blocks of 8 rows and kb, the
    nonempty 128-column blocks of the densest row block (the JAX layout
    holds nbr * kb tiles); padded = (n_pad, m_pad) of that layout.
    group records the lanes per row that the 1-RHS CUDA kernel takes
    for this matrix (hopper_kernels.group_width of the mean nonzeros per
    row)."""

    def __init__(self, row_ptr, col_idx, values, shape, padded, nbr, kb):
        super().__init__()
        self.register_buffer("row_ptr", row_ptr)
        self.register_buffer("col_idx", col_idx)
        self.register_buffer("values", values)
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.nbr, self.kb = int(nbr), int(kb)
        self.group = hk.group_width(col_idx.numel(), self.shape[0])

    @classmethod
    def from_tiles(cls, col_blocks, tiles, shape, padded):
        """From the JAX layout (col_blocks (nbr, kb) and tiles (nbr, kb,
        8, 128), on their device): the tiles' nonzeros in (row, column)
        order; a column block listed twice in a row block is summed."""
        nbr, kb = col_blocks.shape
        n, m = shape
        rb, k, r, c = (tiles != 0).nonzero(as_tuple=True)
        row = rb * BR + r
        col = col_blocks[rb, k].long() * BC + c
        keep = (row < n) & (col < m)
        key, inv = torch.unique(row[keep] * m + col[keep],
                                return_inverse=True)
        values = torch.zeros(key.numel(), dtype=tiles.dtype,
                             device=tiles.device)
        values.index_add_(0, inv, tiles[rb, k, r, c][keep])
        row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=tiles.device)
        row_ptr[1:] = torch.bincount(key // max(m, 1), minlength=n).cumsum(0)
        return cls(row_ptr, (key % max(m, 1)).to(torch.int32), values,
                   shape, padded, nbr, kb)

    @property
    def dtype(self):
        return self.values.dtype

    def matvec(self, x):
        if x.ndim == 2:
            return hk.bcsr_spmv_multirhs(self.row_ptr, self.col_idx,
                                         self.values, x, self.shape[0])
        return hk.bcsr_spmv(self.row_ptr, self.col_idx, self.values, x,
                            self.shape[0])

    def __matmul__(self, x):
        return self.matvec(x)


def _bcsr_blocks(A):
    """Shared host structure of bcsr_stats/to_tilecoo: unique (row
    block, col block) keys of the nonzeros."""
    coo = A.tocoo()
    n, m = A.shape
    nbc = -(-m // BC)
    rb = coo.row.astype(np.int64) // BR
    cb = coo.col.astype(np.int64) // BC
    key = rb * nbc + cb
    uk, inv = np.unique(key, return_inverse=True)
    return coo, nbc, rb, uk, inv


def to_bcsr(A, dtype=np.float32, device=None) -> BcsrMatrix:
    """Convert scipy sparse to the BcsrMatrix layout straight from its
    CSR (duplicates summed, indices sorted, explicit zeros dropped)."""
    device = resolve_device(device)
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.eliminate_zeros()
    n, m = A.shape
    nbr, kb, _ = bcsr_stats(A)
    return BcsrMatrix(_tensor(A.indptr.astype(np.int32), device=device),
                      _tensor(A.indices.astype(np.int32), device=device),
                      _tensor(A.data, dtype, device), (n, m),
                      (nbr * BR, -(-m // BC) * BC), nbr, kb)


class TileCooMatrix(nn.Module):
    """COO of nonempty (8, 128) tiles sorted by row block; the matvec is
    a block gather of x, a multiply-reduce per tile and a segment-sum
    over row blocks (index_add_, accumulated in f32 or f64)."""

    def __init__(self, row_blocks, col_blocks, tiles, shape, padded):
        super().__init__()
        self.register_buffer("row_blocks", row_blocks)
        self.register_buffer("col_blocks", col_blocks)
        self.register_buffer("tiles", tiles)
        self.shape = tuple(shape)
        self.padded = tuple(padded)

    @property
    def dtype(self):
        return self.tiles.dtype

    def matvec(self, x):
        n, m = self.shape
        out = _promoted(self.tiles, x)
        acc = hk.acc_dtype(out)
        rest = tuple(x.shape[1:])
        xp = torch.zeros((self.padded[1],) + rest, dtype=acc,
                         device=x.device)
        xp[:m] = x.to(acc)
        g = xp.reshape((-1, BC) + rest)[self.col_blocks]   # (t, 128[, s])
        if x.ndim == 2:
            part = torch.einsum("trc,tcs->trs", self.tiles.to(acc), g)
        else:
            part = torch.einsum("trc,tc->tr", self.tiles.to(acc), g)
        y = torch.zeros((self.padded[0] // BR, BR) + rest, dtype=acc,
                        device=x.device)
        y.index_add_(0, self.row_blocks, part)
        return y.reshape((-1,) + rest)[:n].to(out)

    def __matmul__(self, x):
        return self.matvec(x)


def bcsr_stats(A):
    """Host-side structure stats for format selection without building
    the tiles: (nbr, kb, ntiles) — BCSR stores nbr*kb tiles padded to the
    densest row block, TileCoo stores exactly ntiles."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo, nbc, rb, uk, inv = _bcsr_blocks(A)
    nbr = -(-n // BR)
    counts = np.bincount((uk // nbc).astype(np.int64), minlength=nbr)
    kb = int(counts.max()) if counts.size else 1
    return nbr, max(kb, 1), int(uk.size)


def to_tilecoo(A, dtype=np.float32, device=None) -> TileCooMatrix:
    """Convert scipy sparse to COO-of-tiles (sorted by row block)."""
    device = resolve_device(device)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    n_pad = -(-n // BR) * BR
    m_pad = -(-m // BC) * BC
    coo, nbc, rb, uk, inv = _bcsr_blocks(A)
    tdt = as_torch_dtype(dtype)
    tiles = torch.zeros((max(uk.size, 1), BR, BC), dtype=tdt)
    tiles[torch.as_tensor(inv.astype(np.int64)),
          torch.as_tensor(coo.row.astype(np.int64) % BR),
          torch.as_tensor(coo.col.astype(np.int64) % BC)] = \
        torch.as_tensor(coo.data).to(tdt)
    urb = (uk // nbc).astype(np.int32) if uk.size else np.zeros(1, np.int32)
    ucb = (uk % nbc).astype(np.int32) if uk.size else np.zeros(1, np.int32)
    return TileCooMatrix(_tensor(urb, device=device),
                         _tensor(ucb, device=device), tiles.to(device),
                         (n, m), (n_pad, m_pad))


class DiaMatrix(nn.Module):
    """Diagonal (shift) layout: y[i] = sum_d data[d, i] * x[i + offs[d]].
    data (nd, n) row-aligned coefficients; offs a static tuple of column
    offsets (col - row)."""

    def __init__(self, data, offs, shape):
        super().__init__()
        self.register_buffer("data", data)
        self.offs = tuple(int(o) for o in offs)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        """x (m,) or (m, s); an (m, s) x goes through the multi-RHS
        kernel, which on the card takes s <= 64 and x of the table's
        dtype and raises otherwise."""
        if x.ndim == 2:
            return hk.dia_spmv_multirhs(self.data, self.offs, x,
                                        self.shape[0])
        return hk.dia_spmv(self.data, self.offs, x, self.shape[0])

    def jacobi_sweeps(self, b, x, dinv_omega, sweeps):
        """`sweeps` fused (weighted-)Jacobi sweeps x <- x + dinv_omega *
        (b - A x), one kernel launch per sweep; b and x (n,) or (n, s),
        dinv_omega (n,) shared by the columns.  As in the JAX module, x
        is cast to b's dtype and the fused path applies only to a square
        operator, a right-hand side of the table's dtype and s <= 64;
        otherwise it returns None and the smoother takes its generic
        path."""
        n, m = self.shape
        if not (n == m and b.dtype == self.data.dtype):
            return None
        if b.ndim == 2 and b.shape[1] > hk.MAX_RHS:
            return None
        sweep = (hk.dia_jacobi_sweep_multirhs if b.ndim == 2
                 else hk.dia_jacobi_sweep)
        dw = dinv_omega.to(b.dtype)
        x = x.to(b.dtype)
        for _ in range(sweeps):
            x = sweep(self.data, self.offs, x, b, dw)
        return x

    def __matmul__(self, x):
        return self.matvec(x)


def to_dia(A, dtype=np.float32, device=None) -> DiaMatrix:
    """Convert scipy sparse to the row-aligned diagonal layout."""
    device = resolve_device(device)
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo = A.tocoo()
    off = coo.col.astype(np.int64) - coo.row
    offsets = np.unique(off)
    slot = np.searchsorted(offsets, off)
    # sum in the target precision where numpy has it, as the JAX to_dia
    # does (duplicates then round alike); bf16 sums in f64
    np_dt = (np.float32 if as_torch_dtype(dtype) == torch.float32
             else np.float64)
    data = np.zeros((max(offsets.size, 1), n), dtype=np_dt)
    np.add.at(data, (slot, coo.row), coo.data.astype(np_dt))
    if offsets.size == 0:
        offsets = np.zeros(1, dtype=np.int64)
    return DiaMatrix(_tensor(data, dtype, device),
                     tuple(int(o) for o in offsets), (n, m))


class CooMatrix(nn.Module):
    """COO: y = zeros.index_add_(rows, vals * x[cols]) for x (m,) or
    (m, s), summed in the promoted dtype.  The format of the sparse
    remainder of a DiaEllMatrix split: the gather and the scatter touch
    2 * nnz elements where an ELL table would gather n * k."""

    def __init__(self, rows, cols, vals, shape):
        super().__init__()
        self.register_buffer("rows", rows)
        self.register_buffer("cols", cols)
        self.register_buffer("vals", vals)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x):
        contrib = hk._rows(self.vals, x) * x[self.cols]
        y = torch.zeros((self.shape[0],) + tuple(x.shape[1:]),
                        dtype=contrib.dtype, device=x.device)
        return y.index_add_(0, self.rows, contrib)

    def __matmul__(self, x):
        return self.matvec(x)


def to_coo(A, dtype=np.float32, device=None) -> CooMatrix:
    """Convert scipy sparse to device COO (its stored entries, in the
    order scipy's COO gives them)."""
    device = resolve_device(device)
    A = sp.coo_matrix(A)
    return CooMatrix(_tensor(A.row.astype(np.int32), device=device),
                     _tensor(A.col.astype(np.int32), device=device),
                     _tensor(A.data, dtype, device), A.shape)


class DiaEllMatrix(nn.Module):
    """Hybrid split A = D + R: the high-occupancy diagonals in DIA
    (`dia`, a DiaMatrix: the dia_spmv kernel on the card) and the
    stragglers in `ell`, a CooMatrix (the JAX package's attribute name;
    to_dia_ell puts the remainder in COO).  The facet multiplier systems
    of structured meshes put 95 %+ of their nonzeros on a few dozen
    diagonals (29 at 8^3 to 32^3)."""

    def __init__(self, dia, ell, shape):
        super().__init__()
        self.dia, self.ell = dia, ell
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.dia.dtype

    def matvec(self, x):
        return self.dia @ x + self.ell @ x

    def __matmul__(self, x):
        return self.matvec(x)


def to_dia_ell(A, dtype=np.float32, min_fill=0.05, max_diags=64,
               device=None) -> DiaEllMatrix:
    """Split scipy sparse A into a DiaEllMatrix: offsets filled on at
    least `min_fill` of the rows (up to `max_diags` of them, densest
    first; dia_spmv takes up to 64 on the card) become DIA, the rest a
    COO remainder."""
    device = resolve_device(device)
    A = sp.csr_matrix(A)
    n, m = A.shape
    coo = A.tocoo()
    off = coo.col.astype(np.int64) - coo.row
    offs, cnt = np.unique(off, return_counts=True)
    dense = offs[np.argsort(-cnt)[:max_diags]]
    dense = np.sort(dense[np.isin(dense, offs[cnt >= min_fill * n])])
    in_dia = np.isin(off, dense)
    D = sp.coo_matrix((coo.data[in_dia],
                       (coo.row[in_dia], coo.col[in_dia])), shape=(n, m))
    R = sp.coo_matrix((coo.data[~in_dia],
                       (coo.row[~in_dia], coo.col[~in_dia])), shape=(n, m))
    return DiaEllMatrix(to_dia(D, dtype=dtype, device=device),
                        to_coo(R, dtype=dtype, device=device), (n, m))


class BlockDiagInverse(nn.Module):
    """Block-diagonal inverse in block-contiguous ordering: bucket j
    holds k_j blocks of size sizes[j] (a (k,) inverse diagonal for size
    1, else (k, s, s) inverses) and covers the next k_j * s_j rows.  The
    apply is static slices, an elementwise product for 1 x 1 blocks and
    one batched einsum for the others; r (n,) or (n, c)."""

    def __init__(self, tensors, sizes):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        for j, T in enumerate(tensors):
            self.register_buffer(f"block{j}", T)

    @property
    def tensors(self):
        return tuple(getattr(self, f"block{j}")
                     for j in range(len(self.sizes)))

    @property
    def dtype(self):
        return self.block0.dtype

    def matvec(self, r):
        rest = tuple(r.shape[1:])
        outs, o = [], 0
        for s, B in zip(self.sizes, self.tensors):
            k = B.shape[0]
            seg = r[o:o + k * s]
            if s == 1:
                outs.append(hk._rows(B, r) * seg)
            else:
                outs.append(torch.einsum(
                    "kij,kj...->ki...", B, seg.reshape((k, s) + rest)
                ).reshape((k * s,) + rest))
            o += k * s
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def __matmul__(self, r):
        return self.matvec(r)


def dia_ell_fill(A, min_fill=0.05, max_diags=64):
    """Fraction of nnz the DIA part of to_dia_ell would capture."""
    A = sp.coo_matrix(A)
    if A.nnz == 0:
        return 1.0
    n = A.shape[0]
    off = A.col.astype(np.int64) - A.row
    offs, cnt = np.unique(off, return_counts=True)
    keep = cnt[np.argsort(-cnt)[:max_diags]]
    return float(keep[keep >= min_fill * n].sum()) / A.nnz


def diag_of(A_scipy) -> np.ndarray:
    return sp.csr_matrix(A_scipy).diagonal()


def dia_n_offsets(A) -> int:
    """Distinct (col - row) offsets — the DIA storage multiplier."""
    coo = sp.coo_matrix(A)
    return int(np.unique(coo.col.astype(np.int64) - coo.row).size)


def l1_row_weights(A_scipy) -> np.ndarray:
    """l1-Jacobi weights d_i = sum_j |a_ij| (reference
    Weightedl1Smoother row weights, ParELAG_MatrixUtils.hpp:40-142)."""
    A = sp.csr_matrix(A_scipy)
    return np.asarray(np.abs(A).sum(axis=1)).ravel()
