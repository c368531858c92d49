"""Distributed (rank-sharded) topology coarsening — the
SharedEntityCommunication pattern.

The reference distributes setup over MPI ranks: each rank owns a subdomain;
entities on rank interfaces are grouped/numbered by their OWNER rank, which
gathers the neighbors' partial adjacency data, computes, and broadcasts the
result back (SharedEntityCommunication.hpp:36-180, SharingMap + the
AssembleNonLocal call in CoarsenLocalPartitioning, Topology.cpp:744-760).

Here the same owner-computes protocol runs over R rank shards with
genuinely RESTRICTED per-rank data (each rank sees only its owned elements
plus a one-layer facet halo); the "network" is an in-memory exchange dict,
shaped exactly like the gather/broadcast pair, so the protocol drops onto
jax collectives or host RPC unchanged. The distributed grouping is
digit-identical to the serial MIS because coarse facets never span owners:
all members of a coarse facet share the same (global) agglomerate
signature, hence the same owner.

Scope: element agglomeration + coarse FACET construction (the codim that
carries all inter-rank coupling). Lower codims follow the same pattern and
currently run serially (ROADMAP: distributed coarsening).
"""

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.ops import csr as C


@dataclass
class RankShard:
    """What one rank actually stores: its elements, the rows of B0 for
    them, the halo facets, and the bdr-attribute rows for halo facets."""
    rank: int
    elems: np.ndarray                 # owned (global) element ids
    B0_rows: sp.csr_matrix            # (n_owned, n_facets_global) local rows
    facet_halo: np.ndarray            # facets adjacent to owned elements
    facet_owner: np.ndarray           # owner rank per halo facet
    bdr_rows: sp.csr_matrix | None    # facet x attr rows (halo facets only)
    part_local: np.ndarray            # agglomerate id per owned element
    ae_ids: np.ndarray = None         # global AE ids of local agglomerates


def make_shards(topo, rank_of_elem, part, R):
    """Build the per-rank restricted data. `part` must refine the rank
    decomposition (every agglomerate inside one rank)."""
    rank_of_elem = np.asarray(rank_of_elem)
    part = np.asarray(part)
    B0 = topo.B[0].tocsr()
    B0t = B0.T.tocsr()
    n_f = B0.shape[1]
    # facet owner = min rank of adjacent elements (owner-computes rule,
    # SharingMap.hpp:52-66)
    facet_owner = np.full(n_f, np.iinfo(np.int64).max, dtype=np.int64)
    coo = B0.tocoo()
    np.minimum.at(facet_owner, coo.col, rank_of_elem[coo.row])

    shards = []
    for r in range(R):
        elems = np.where(rank_of_elem == r)[0]
        rows = B0[elems]
        halo = np.unique(rows.indices)
        bdr = (topo.facet_bdr_attribute.tocsr()
               if topo.facet_bdr_attribute is not None else None)
        shards.append(RankShard(
            rank=r, elems=elems, B0_rows=rows, facet_halo=halo,
            facet_owner=facet_owner[halo],
            bdr_rows=bdr, part_local=part[elems]))
    return shards, facet_owner


def distributed_partition(shards, n_parts_total):
    """Distributed k-way partitioning (the ParMETIS PartKway role,
    reference ParmetisGraphPartitioner): each rank runs the multilevel
    partitioner on its LOCAL element subgraph (built from its own B0 rows —
    no remote data), with a quota proportional to its element count; global
    part ids by exclusive prefix over ranks. Agglomerates therefore refine
    the rank decomposition, which is exactly what the distributed
    coarsening protocol requires."""
    from parelag_tpu_torch.partitioning.partitioners import (
        multilevel_graph_partition)
    n_total = sum(s.elems.size for s in shards)
    quotas = [max(1, round(n_parts_total * s.elems.size / n_total))
              for s in shards]
    out = np.full(n_total, -1, dtype=np.int64)
    nxt = 0
    for s, k in zip(shards, quotas):
        # local adjacency through shared facets (pattern of B0_r B0_r^T)
        local = C.bool_mult(s.B0_rows, s.B0_rows.T)
        p = multilevel_graph_partition(local, k, seed=s.rank)
        out[s.elems] = nxt + p
        nxt += int(p.max()) + 1
    return out


def distributed_coarsen_facets(shards, R):
    """Run the owner-computes coarse-facet construction. Returns
    (fc_AF global csr, AE_elem global csr, exchange_stats dict)."""
    # ---- phase 1: global agglomerate numbering (allgather counts) ---- #
    local_n_ae = []
    for s in shards:
        uniq, inv = np.unique(s.part_local, return_inverse=True)
        s.part_local = inv
        local_n_ae.append(uniq.size)
    offsets = np.concatenate([[0], np.cumsum(local_n_ae)])
    n_ae = int(offsets[-1])
    for s in shards:
        s.ae_ids = offsets[s.rank] + np.arange(local_n_ae[s.rank])

    # ---- phase 2: each rank computes PARTIAL facet signatures from its
    # local B0 rows (signed: AE orientation entries) ---- #
    partials = []              # per rank: dict facet -> list[(global AE, s)]
    for s in shards:
        AE_loc = C.transpose_orientation(s.part_local, local_n_ae[s.rank])
        AE_fc = C.mult_orientation(AE_loc, s.B0_rows)    # local AE x facets
        coo = AE_fc.tocoo()
        d = {}
        for a, f, v in zip(coo.row, coo.col, coo.data):
            d.setdefault(int(f), []).append(
                (int(offsets[s.rank] + a), float(v)))
        partials.append(d)

    # ---- phase 3: exchange — owner gathers neighbor partials for its
    # facets (the SharedEntityCommunication Reduce direction) ---- #
    gathered = [dict() for _ in range(R)]       # owner rank -> facet -> sig
    n_msgs = 0
    bytes_moved = 0
    for s in shards:
        d = partials[s.rank]
        for f, own in zip(s.facet_halo, s.facet_owner):
            sig = d.get(int(f))
            if sig is None:
                continue
            tgt = gathered[own]
            tgt.setdefault(int(f), []).extend(sig)
            if own != s.rank:
                n_msgs += 1
                bytes_moved += 16 * len(sig)

    # ---- phase 4: owner groups its facets by full signature (+ bdr
    # attribute), exactly the serial MIS criterion ---- #
    assignments = {}            # facet -> (coarse id local to owner, owner)
    local_counts = []
    for r, s in enumerate(shards):
        groups = {}
        for f, sig in gathered[r].items():
            key = tuple(sorted(sig))
            if s.bdr_rows is not None:
                row = s.bdr_rows[f]
                key = key + tuple(
                    ("bdr", int(c), float(v))
                    for c, v in zip(row.indices, row.data))
            groups.setdefault(key, []).append(f)
        ordered = sorted(groups.values(), key=lambda fs: min(fs))
        for cid, fs in enumerate(ordered):
            for f in fs:
                assignments[f] = (cid, r)
        local_counts.append(len(ordered))

    # ---- phase 5: global coarse-facet numbering + broadcast back ---- #
    af_off = np.concatenate([[0], np.cumsum(local_counts)])
    n_af = int(af_off[-1])
    n_fc_global = max(int(s.B0_rows.shape[1]) for s in shards)
    rows, cols, vals = [], [], []
    for f, (cid, r) in assignments.items():
        rows.append(f)
        cols.append(af_off[r] + cid)
        # orientation: first signature entry's sign convention (serial MIS
        # keeps the raw +-1 table data; orientation data lives in AE_fc)
        vals.append(1.0)
    fc_AF = sp.csr_matrix((vals, (rows, cols)), shape=(n_fc_global, n_af))

    AE_rows, AE_cols = [], []
    for s in shards:
        AE_rows.extend(s.ae_ids[s.part_local])
        AE_cols.extend(s.elems)
    n_e = sum(s.elems.size for s in shards)
    AE_elem = sp.csr_matrix(
        (np.ones(n_e), (AE_rows, AE_cols)),
        shape=(n_ae, n_e))
    stats = dict(n_msgs=n_msgs, bytes_moved=bytes_moved, n_ae=n_ae,
                 n_af=n_af)
    return fc_AF, AE_elem, stats
