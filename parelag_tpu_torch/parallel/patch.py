"""Rank patches: the distributed-memory decomposition of the setup phase.

The reference distributes Coarsen() over MPI ranks (one subdomain per rank;
agglomerates never span ranks, Topology.hpp:503-512). Its communication
fabric is SharingMap/SharedEntityCommunication: owners gather neighbor data,
compute shared coarse entities once, and broadcast the results
(DeRhamSequence.cpp:1818-2086).

The TPU-native decomposition here: each rank holds a PATCH — its owned
elements plus every agglomerate sharing a vertex with them (complete halo
AEs). Because per-coarse-entity computations depend only on the entity's
closure data, and because patch-local numbering is GLOBAL-ORDER-PRESERVING
(monotone gid remaps keep every lexsort/unique/grouping identical), running
the serial engine on the patch reproduces the serial results bit-for-bit
for all coarse entities owned by the rank. The owner-computes-and-broadcast
protocol becomes compute-in-overlap: shared entities are computed
redundantly (identically) by each adjacent rank from its own patch — the
communication is the one-time halo construction instead of per-stage
messages, which is the latency-optimal trade on a TPU mesh (setup messages
are many and small; the halo is one bulk exchange).
"""

from dataclasses import dataclass, field

import numpy as np

from parelag_tpu_torch.mesh.mesh import Mesh
from parelag_tpu_torch.mesh.entities import lookup_rows, unique_rows


def contains_rows(table, queries):
    """Boolean mask: which query rows appear in `table` (row-wise)."""
    table = np.asarray(table, dtype=np.int64)
    queries = np.asarray(queries, dtype=np.int64)
    if table.size == 0 or queries.size == 0:
        return np.zeros(queries.shape[0], dtype=bool)
    order = np.lexsort(table.T[::-1])
    srt = table[order]
    k = srt.shape[1]
    dt = np.dtype((np.void, 8 * k))
    sv = np.ascontiguousarray(srt.astype(">i8")).view(dt).ravel()
    qv = np.ascontiguousarray(queries.astype(">i8")).view(dt).ravel()
    pos = np.searchsorted(sv, qv)
    return (pos < sv.size) & (sv[np.minimum(pos, sv.size - 1)] == qv)


@dataclass
class RankPatch:
    rank: int
    mesh: Mesh                   # patch submesh (global coordinates)
    elem_gids: np.ndarray        # sorted global element ids of the patch
    vert_gids: np.ndarray        # sorted global vertex ids
    part_local: np.ndarray       # local AE id per patch element
    ae_gids: np.ndarray          # global AE id per local AE (sorted)
    ae_rank: np.ndarray          # owning rank per local AE
    owned_elem_mask: np.ndarray  # per patch element: owned by this rank
    # filled by the driver:
    topo: object = None
    seq: object = None
    ent_gids: dict = field(default_factory=dict)  # codim -> fine entity gids


def build_rank_patches(mesh, rank_of_elem, partition, n_ranks):
    """Split a mesh into per-rank patches.

    rank_of_elem: rank per element; partition: AE id per element (must be
    nested in ranks: every AE's elements share one rank — the reference's
    local-partitioning invariant). Patch of rank r = all elements of every
    AE that shares a vertex with an owned element (complete halo AEs)."""
    rank_of_elem = np.asarray(rank_of_elem)
    partition = np.asarray(partition)
    n_ae = int(partition.max()) + 1
    # rank per AE (assert nested)
    ae_rank = np.full(n_ae, -1, dtype=np.int64)
    ae_rank[partition] = rank_of_elem
    assert np.all(ae_rank[partition] == rank_of_elem), \
        "agglomerates must not span ranks"

    elems = mesh.elements
    nv = mesh.num_vertices
    # vertex -> AEs incidence
    vert_ae_keys = np.unique(
        elems.astype(np.int64).ravel() * n_ae
        + np.repeat(partition, elems.shape[1]))
    v_of = vert_ae_keys // n_ae
    a_of = vert_ae_keys % n_ae

    patches = []
    for r in range(n_ranks):
        owned_ae = np.nonzero(ae_rank == r)[0]
        owned_verts = np.unique(
            v_of[np.isin(a_of, owned_ae)])
        halo_ae = np.unique(a_of[np.isin(v_of, owned_verts)])
        emask = np.isin(partition, halo_ae)
        elem_gids = np.nonzero(emask)[0]
        vert_gids = np.unique(elems[elem_gids].ravel())
        # monotone gid -> local id remap (ORDER-PRESERVING: all internal
        # lexsorts/uniques then coincide with the serial run)
        vmap = np.full(nv, -1, dtype=np.int64)
        vmap[vert_gids] = np.arange(vert_gids.size)
        local_elems = vmap[elems[elem_gids]]
        # boundary faces contained in patch elements
        bdr = mesh.bdr_faces
        cand = np.all(np.isin(bdr, vert_gids), axis=1)
        if cand.any():
            pf = np.sort(elems[elem_gids][:, mesh.local_faces], axis=2)
            pf = pf.reshape(-1, pf.shape[2])
            keep = np.zeros(bdr.shape[0], dtype=bool)
            keep[np.nonzero(cand)[0]] = contains_rows(
                pf, np.sort(bdr[cand], axis=1))
        else:
            keep = cand
        pmesh = Mesh(
            vertices=mesh.vertices[vert_gids].copy(),
            elements=local_elems,
            kind=mesh.kind,
            attrib=mesh.attrib[elem_gids].copy(),
            bdr_faces=vmap[bdr[keep]],
            bdr_attrib=mesh.bdr_attrib[keep].copy(),
        )
        ae_gids = np.sort(halo_ae)
        amap = np.full(n_ae, -1, dtype=np.int64)
        amap[ae_gids] = np.arange(ae_gids.size)
        patches.append(RankPatch(
            rank=r, mesh=pmesh, elem_gids=elem_gids, vert_gids=vert_gids,
            part_local=amap[partition[elem_gids]], ae_gids=ae_gids,
            ae_rank=ae_rank[ae_gids],
            owned_elem_mask=(rank_of_elem[elem_gids] == r)))
    return patches


def fine_entity_gids(patch, global_ents, codim, dim=3):
    """Global ids of the patch's fine entities at `codim` (3D:
    0=elements, 1=faces, 2=edges, 3=vertices), via order-preserving key
    lookup into the global entity tables."""
    if codim in patch.ent_gids:
        return patch.ent_gids[codim]
    if codim == 0:
        out = patch.elem_gids
    elif codim == dim:
        out = patch.vert_gids
    else:
        pe = patch.topo.entities
        if codim == 1:
            loc = np.sort(patch.vert_gids[np.asarray(pe.face_verts)],
                          axis=1)
            out = lookup_rows(global_ents.face_sorted, loc)
        else:
            loc = patch.vert_gids[pe.edges]
            # edges table rows are unique sorted pairs; match via packed key
            nvg = int(max(global_ents.edges.max(), loc.max())) + 1
            gkeys = (global_ents.edges[:, 0].astype(np.int64) * nvg
                     + global_ents.edges[:, 1])
            lkeys = loc[:, 0].astype(np.int64) * nvg + loc[:, 1]
            order = np.argsort(gkeys)
            pos = np.searchsorted(gkeys[order], lkeys)
            assert np.all(gkeys[order][pos] == lkeys)
            out = order[pos]
    patch.ent_gids[codim] = out
    return out
