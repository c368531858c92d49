"""Distributed multilevel k-way graph partitioning (the ParMETIS role).

Reference: src/partitioning/ParmetisGraphPartitioner.hpp:34 wraps
ParMETIS_V3_PartKway over a distributed element graph. The recipe rebuilt
here with genuinely RESTRICTED per-rank data (each rank holds the
adjacency rows of its owned vertices, with global column ids, plus the
partition values of halo vertices exchanged between phases):

  1. distributed coarsening — per-rank heavy-edge matching restricted to
     LOCAL vertex pairs (ParMETIS matches mostly-locally too); global
     coarse numbering by exclusive prefix over ranks; coarse rows
     assembled per rank from its own rows + the neighbor coarse-id halo;
  2. when the coarse graph is small it is allgathered and every rank runs
     the same deterministic serial multilevel partitioner on it (the
     reference's "initial partition on the coarsest graph");
  3. distributed uncoarsening — project back level by level and run
     boundary KL-style refinement passes: each rank evaluates move gains
     for its owned boundary vertices from its rows + the halo partition
     values, and moves are applied under a global balance constraint.

Quality contract (tests/test_dist_partition.py): edge cut within a small
factor of the serial multilevel partitioner and strictly better than
independent per-rank partitioning, with balanced parts.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class VertexShard:
    """One rank's restricted view of the distributed graph."""
    rank: int
    verts: np.ndarray          # owned global vertex ids (sorted)
    rows: sp.csr_matrix        # (n_owned, n_global) adjacency rows
    vwgt: np.ndarray           # owned vertex weights


def make_vertex_shards(A, rank_of_vertex, R, vwgt=None):
    """Split a global adjacency (for tests; production builds shards from
    per-rank topology rows directly, parallel.dist_topology)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    vwgt = np.ones(n) if vwgt is None else np.asarray(vwgt, float)
    rank_of_vertex = np.asarray(rank_of_vertex)
    return [VertexShard(r, np.where(rank_of_vertex == r)[0],
                        A[rank_of_vertex == r],
                        vwgt[rank_of_vertex == r])
            for r in range(R)]


def _local_heavy_matching(shard, rng):
    """Greedy heavy-edge matching among the shard's OWNED vertices.
    Returns match partner per owned vertex (global id, self when
    unmatched)."""
    verts = shard.verts
    gset = np.full(int(shard.rows.shape[1]), -1, dtype=np.int64)
    gset[verts] = np.arange(verts.size)
    partner = np.full(verts.size, -1, dtype=np.int64)
    order = rng.permutation(verts.size)
    rows = shard.rows
    for li in order:
        if partner[li] >= 0:
            continue
        a, b = rows.indptr[li], rows.indptr[li + 1]
        cols = rows.indices[a:b]
        wts = rows.data[a:b]
        lj = gset[cols]
        ok = (lj >= 0) & (lj != li)
        if ok.any():
            cand = lj[ok]
            free = partner[cand] < 0
            if free.any():
                j = cand[free][np.argmax(wts[ok][free])]
                partner[li] = j
                partner[j] = li
                continue
        partner[li] = li
    return partner


def _contract(shards, R, rng):
    """One distributed contraction level. Returns (new shards, per-rank
    vertex -> coarse-global maps, n_coarse)."""
    maps, counts = [], []
    for s in shards:
        partner = _local_heavy_matching(s, rng)
        # coarse id local to rank: min(li, partner) representative
        rep = np.minimum(np.arange(partner.size), partner)
        uniq, inv = np.unique(rep, return_inverse=True)
        maps.append(inv)
        counts.append(uniq.size)
    off = np.concatenate([[0], np.cumsum(counts)])
    n_coarse = int(off[-1])
    # "halo exchange": global vertex -> coarse global id, visible where
    # a rank has an edge to the vertex (here: one dense map, standing in
    # for the per-neighbor messages)
    n_global = int(shards[0].rows.shape[1])
    v2c = np.full(n_global, -1, dtype=np.int64)
    for s, m in zip(shards, maps):
        v2c[s.verts] = off[s.rank] + m

    new_shards = []
    for s, m in zip(shards, maps):
        coo = s.rows.tocoo()
        cu = (off[s.rank] + m)[coo.row]
        cv = v2c[coo.col]
        keep = cu != cv
        Ac_rows = sp.csr_matrix(
            (coo.data[keep], ((cu - off[s.rank])[keep], cv[keep])),
            shape=(counts[s.rank], n_coarse))
        Ac_rows.sum_duplicates()
        wc = np.zeros(counts[s.rank])
        np.add.at(wc, m, s.vwgt)
        new_shards.append(VertexShard(
            s.rank, off[s.rank] + np.arange(counts[s.rank]),
            Ac_rows, wc))
    return new_shards, maps, n_coarse


def _conn_table(s, part, k):
    """(nv_local, k) part-connectivity weights of the shard's owned
    vertices — one bincount over the CSR rows (vectorized; the per-vertex
    Python loop cost minutes at bench scale)."""
    rows = s.rows
    nv = s.verts.size
    v_of = np.repeat(np.arange(nv, dtype=np.int64),
                     np.diff(rows.indptr))
    key = v_of * k + part[rows.indices]
    return np.bincount(key, weights=rows.data,
                       minlength=nv * k).reshape(nv, k)


def _refine_pass(shards, part, k, target, imb=1.05):
    """One distributed boundary-refinement pass: ranks propose positive-
    gain moves for their owned boundary vertices (gains from one
    vectorized connectivity table per rank + the partition halo); moves
    apply best-gain-first under the balance constraint."""
    sizes = np.zeros(k)
    for s in shards:
        np.add.at(sizes, part[s.verts], s.vwgt)
    cap = imb * target
    gains, verts, srcs, dsts, wgts = [], [], [], [], []
    for s in shards:
        conn = _conn_table(s, part, k)
        own = part[s.verts]
        best = np.argmax(conn, axis=1)
        gain = conn[np.arange(own.size), best] \
            - conn[np.arange(own.size), own]
        sel = (best != own) & (gain > 0)
        gains.append(gain[sel])
        verts.append(s.verts[sel])
        srcs.append(own[sel])
        dsts.append(best[sel])
        wgts.append(s.vwgt[sel])
    gains = np.concatenate(gains)
    order = np.argsort(-gains)
    verts = np.concatenate(verts)[order]
    srcs = np.concatenate(srcs)[order]
    dsts = np.concatenate(dsts)[order]
    wgts = np.concatenate(wgts)[order]
    n_moved = 0
    for v, src, dst, w in zip(verts, srcs, dsts, wgts):
        if part[v] != src:
            continue
        if sizes[dst] + w > cap or sizes[src] - w < 0.25 * target:
            continue
        part[v] = dst
        sizes[src] -= w
        sizes[dst] += w
        n_moved += 1
    return n_moved


def _balance_pass(shards, part, k, target, imb=1.10):
    """Move least-penalty boundary vertices out of overweight parts into
    neighbor parts with headroom (the ParMETIS balance phase); gains from
    the vectorized per-rank connectivity tables."""
    sizes = np.zeros(k)
    for s in shards:
        np.add.at(sizes, part[s.verts], s.vwgt)
    cap = imb * target
    pens, verts, srcs, dsts, wgts = [], [], [], [], []
    for s in shards:
        own = part[s.verts]
        over = sizes[own] > cap
        if not over.any():
            continue
        conn = _conn_table(s, part, k)
        masked = conn.copy()
        masked[np.arange(own.size), own] = -np.inf
        masked[:, :] = np.where(conn > 0, masked, -np.inf)
        dst = np.argmax(masked, axis=1)
        has = np.isfinite(masked[np.arange(own.size), dst])
        sel = over & has
        pen = (conn[np.arange(own.size), own]
               - conn[np.arange(own.size), dst])
        pens.append(pen[sel])
        verts.append(s.verts[sel])
        srcs.append(own[sel])
        dsts.append(dst[sel])
        wgts.append(s.vwgt[sel])
    if not pens:
        return 0
    pens = np.concatenate(pens)
    order = np.argsort(pens)
    verts = np.concatenate(verts)[order]
    srcs = np.concatenate(srcs)[order]
    dsts = np.concatenate(dsts)[order]
    wgts = np.concatenate(wgts)[order]
    n_moved = 0
    for v, src, dst, w in zip(verts, srcs, dsts, wgts):
        if part[v] != src or sizes[src] <= cap:
            continue
        if sizes[dst] + w > cap:
            continue
        part[v] = dst
        sizes[src] -= w
        sizes[dst] += w
        n_moved += 1
    return n_moved


def parmetis_kway(shards, k, seed=0, n_refine=3, min_coarse=None):
    """Distributed multilevel k-way partition. Returns the global part
    vector (the union of per-rank owned results)."""
    R = len(shards)
    rng = np.random.RandomState(seed)
    min_coarse = min_coarse or max(20 * k, 64)

    levels = [shards]
    maps = []
    while True:
        n_now = sum(s.verts.size for s in levels[-1])
        if n_now <= min_coarse:
            break
        nxt, m, n_c = _contract(levels[-1], R, rng)
        if n_c >= n_now:
            break
        levels.append(nxt)
        maps.append(m)

    # allgather the coarsest graph; identical serial partition everywhere
    # (coarse verts are rank-prefix numbered, so rank-order vstack is
    # already global order)
    from parelag_tpu_torch.partitioning.partitioners import (
        multilevel_graph_partition)
    coarse = levels[-1]
    n_c = sum(s.verts.size for s in coarse)
    assert np.array_equal(
        np.concatenate([s.verts for s in coarse]), np.arange(n_c))
    A_c = sp.vstack([s.rows for s in coarse]).tocsr()[:, :n_c]
    wc = np.concatenate([s.vwgt for s in coarse])
    part = multilevel_graph_partition(
        A_c + A_c.T, k, weights=wc, seed=seed).astype(np.int64)

    total_w = sum(float(s.vwgt.sum()) for s in shards)
    target = total_w / k
    # uncoarsen + refine
    for lvl in range(len(levels) - 1, 0, -1):
        fine = levels[lvl - 1]
        n_f = sum(s.verts.size for s in fine)
        part_f = np.empty(n_f, dtype=np.int64)
        for s, sc, m in zip(fine, levels[lvl], maps[lvl - 1]):
            part_f[s.verts] = part[sc.verts[m]]
        part = part_f
        _balance_pass(fine, part, k, target)
        for _ in range(n_refine):
            if _refine_pass(fine, part, k, target) == 0:
                break
    for _ in range(2):
        _balance_pass(levels[0], part, k, target)
        for _ in range(n_refine):
            if _refine_pass(levels[0], part, k, target) == 0:
                break
    return part


def edge_cut(A, part):
    """Total weight of edges crossing parts (diagnostic)."""
    coo = sp.csr_matrix(A).tocoo()
    cross = part[coo.row] != part[coo.col]
    return float(coo.data[cross].sum()) / 2.0
