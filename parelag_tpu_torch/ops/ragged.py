"""Flat ragged-array helpers for vectorized per-agglomerate index work.

The setup phase manipulates thousands of variable-length per-entity index
lists (closure dofs, boundary dofs, interior ranges). Python loops over
these lists dominated setup cost; every helper here processes the whole
family in O(1) numpy calls over a concatenated (cat, off) layout — the
host-side mirror of the bucketed/padded device layout used for compute.
"""

import numpy as np


def sizes_to_offsets(sizes) -> np.ndarray:
    sizes = np.asarray(sizes, dtype=np.int64)
    off = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    return off


def lists_to_cat(lists, dtype=np.int64):
    """List of 1-D arrays -> (cat, off)."""
    n = len(lists)
    sizes = np.fromiter((len(x) for x in lists), np.int64, n)
    off = sizes_to_offsets(sizes)
    if off[-1] == 0:
        return np.zeros(0, dtype=dtype), off
    cat = np.concatenate([np.asarray(x, dtype=dtype) for x in lists])
    return cat, off


def cat_to_lists(cat, off):
    """(cat, off) -> list of views (no copies)."""
    return np.split(cat, off[1:-1])


def ranges_cat(starts, stops):
    """Concatenation of arange(starts[i], stops[i]) for all i -> (cat, off).
    Fully vectorized (no Python loop)."""
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    lens = stops - starts
    off = sizes_to_offsets(lens)
    total = int(off[-1])
    if total == 0:
        return np.zeros(0, dtype=np.int64), off
    cat = (np.arange(total, dtype=np.int64)
           - np.repeat(off[:-1], lens)
           + np.repeat(starts, lens))
    return cat, off


def merge_ragged(parts, n_rows=None):
    """Row-wise concatenation of K ragged arrays: for every row i the output
    row is parts[0][i] ++ parts[1][i] ++ ... Each part is a (cat, off) pair
    over the same number of rows. Returns (cat, off)."""
    parts = [p for p in parts]
    if not parts:
        return np.zeros(0, dtype=np.int64), np.zeros(
            (n_rows or 0) + 1, dtype=np.int64)
    n = parts[0][1].size - 1
    lens = [np.diff(off) for _, off in parts]
    L = np.sum(lens, axis=0) if parts else np.zeros(n, np.int64)
    off = sizes_to_offsets(L)
    out = np.zeros(int(off[-1]),
                   dtype=parts[0][0].dtype if parts[0][0].size else np.int64)
    prefix = np.zeros(n, dtype=np.int64)
    for (cat, poff), l in zip(parts, lens):
        if cat.size:
            ent = np.repeat(np.arange(n, dtype=np.int64), l)
            within = (np.arange(cat.size, dtype=np.int64)
                      - np.repeat(poff[:-1], l))
            out[off[:-1][ent] + prefix[ent] + within] = cat
        prefix += l
    return out, off


def expand_blocks(rows_cat, row_off, cols_cat, col_off):
    """COO expansion of dense blocks: block b contributes the cross product
    rows[b] x cols[b]. Returns (row_ids, col_ids) concatenated over blocks,
    ordered row-major within each block (matching block.ravel())."""
    rlen = np.diff(row_off)
    clen = np.diff(col_off)
    nb = rlen.size
    if nb and rlen.min() == rlen.max() and clen.min() == clen.max():
        # uniform-arity fast path (FE meshes): pure C broadcasts — the
        # gathered-modulo general path below is ~30x slower at scale
        k, c = int(rlen[0]), int(clen[0])
        R2 = rows_cat.reshape(nb, k)
        C2 = cols_cat.reshape(nb, c)
        return (np.repeat(R2, c, axis=1).ravel(),
                np.tile(C2, (1, k)).ravel())
    cnt = rlen * clen
    boff = sizes_to_offsets(cnt)
    total = int(boff[-1])
    if total == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    rows = np.repeat(rows_cat, np.repeat(clen, rlen))
    ent = np.repeat(np.arange(nb, dtype=np.int64), cnt)
    within = np.arange(total, dtype=np.int64) - boff[:-1][ent]
    cols = cols_cat[col_off[:-1][ent] + within % clen[ent]]
    return rows, cols


def two_level_ranges(parent_cat, parent_off, starts, stops):
    """For every parent row, concatenate the ranges of its children:
    row i -> ++_{s in parent_cat[off[i]:off[i+1]]} arange(starts[s], stops[s]).
    Returns (cat, off) with off per parent row."""
    ch_cat, ch_off = ranges_cat(starts[parent_cat], stops[parent_cat])
    # per-parent length = sum of child lengths
    ch_lens = np.diff(ch_off)
    n_par = parent_off.size - 1
    par_of_child = np.repeat(np.arange(n_par, dtype=np.int64),
                             np.diff(parent_off))
    L = np.bincount(par_of_child, weights=ch_lens,
                    minlength=n_par).astype(np.int64)
    return ch_cat, sizes_to_offsets(L)


class BlockList:
    """Ragged list of dense 2-D blocks backed by ONE flat buffer.

    List-compatible (len / index / iterate, items are reshaped views), plus
    a vectorized `gather` that stacks same-shape members with one fancy
    index instead of a Python-level np.stack loop."""

    __slots__ = ("cat", "off", "rsz", "csz")

    def __init__(self, cat, off, rsz, csz):
        self.cat = cat
        self.off = np.asarray(off, dtype=np.int64)
        self.rsz = np.asarray(rsz, dtype=np.int64)
        self.csz = np.asarray(csz, dtype=np.int64)

    @classmethod
    def from_list(cls, blocks):
        n = len(blocks)
        rsz = np.fromiter((b.shape[0] for b in blocks), np.int64, n)
        csz = np.fromiter((b.shape[1] for b in blocks), np.int64, n)
        off = sizes_to_offsets(rsz * csz)
        cat = (np.concatenate([np.asarray(b).ravel() for b in blocks])
               if n and off[-1] else np.zeros(int(off[-1])))
        return cls(cat, off, rsz, csz)

    def __len__(self):
        return self.rsz.size

    def __getitem__(self, i):
        return self.cat[self.off[i]:self.off[i + 1]].reshape(
            int(self.rsz[i]), int(self.csz[i]))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def gather(self, idxs, shape):
        """(len(idxs), *shape) stack of same-shape members, vectorized."""
        idxs = np.asarray(idxs, dtype=np.int64)
        k = int(shape[0] * shape[1])
        if idxs.size == 0 or k == 0:
            return np.zeros((idxs.size,) + tuple(shape))
        # contiguous run of uniform-size blocks -> zero-copy reshape
        lo, hi = int(idxs[0]), int(idxs[-1])
        if (hi - lo + 1 == idxs.size
                and int(self.off[hi + 1] - self.off[lo]) == idxs.size * k
                and np.array_equal(idxs, np.arange(lo, hi + 1))):
            return self.cat[self.off[lo]:self.off[hi + 1]].reshape(
                (idxs.size,) + tuple(shape))
        if k >= 4096:
            # large blocks: per-item memcpy beats materializing a huge
            # fancy-index array
            return np.stack([self[int(i)] for i in idxs])
        flat = self.off[idxs][:, None] + np.arange(k, dtype=np.int64)
        return self.cat[flat].reshape((idxs.size,) + tuple(shape))


def take(blocks, idxs, shape=None):
    """Stack blocks[idxs] (all the same shape) into one 3-D array; uses the
    vectorized gather when `blocks` is a BlockList."""
    if isinstance(blocks, BlockList):
        if shape is None:
            i0 = int(np.asarray(idxs)[0])
            shape = (int(blocks.rsz[i0]), int(blocks.csz[i0]))
        return blocks.gather(idxs, shape)
    return np.stack([blocks[i] for i in idxs])


def group_by(keys):
    """Group indices 0..n-1 by key (tuple-like rows). Returns dict
    key -> np.ndarray of indices, ordered by first occurrence.

    Integer ndarray keys (1-D values or 2-D rows) take a fully vectorized
    lexsort path — the per-item Python loop dominated flagship-scale
    coarsening (~10^6 agglomerates per stage)."""
    if isinstance(keys, np.ndarray) and keys.dtype.kind in "iu":
        if keys.ndim == 1:
            return _group_rows(keys[:, None], scalar=True)
        if keys.ndim == 2:
            return _group_rows(keys, scalar=False)
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}


def _group_rows(arr, scalar):
    n = arr.shape[0]
    if n == 0:
        return {}
    order = np.lexsort(arr.T[::-1])
    srt = arr[order]
    new = np.ones(n, dtype=bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    starts = np.nonzero(new)[0]
    bounds = np.append(starts, n)
    firsts = np.minimum.reduceat(order, starts)
    out = {}
    for g in np.argsort(firsts, kind="stable"):   # first-occurrence order
        idxs = np.sort(order[bounds[g]:bounds[g + 1]])
        row = srt[starts[g]]
        key = int(row[0]) if scalar else tuple(int(v) for v in row)
        out[key] = idxs
    return out
