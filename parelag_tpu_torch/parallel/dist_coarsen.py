"""End-to-end distributed Coarsen over rank patches.

The full reference pipeline — distributed topology coarsening, coarse
traces for every form, all facet/ridge/peak extensions, cochain projectors
and coarse operators (DeRhamSequence::Coarsen under MPI,
DeRhamSequence.cpp:572-692 with the SharingMap/SharedEntityCommunication
exchanges at :1818-2086 and SharingMap.cpp:499) — executed per rank on its
patch (parallel.patch.RankPatch): owned elements + complete halo
agglomerates, with order-preserving local numbering.

No rank ever holds a global matrix: each rank builds its patch topology,
its patch de Rham sequence, coarsens it, and keeps the coarse entities it
owns (owner = min adjacent-AE rank, the reference's hypre-style ownership).
Shared coarse entities are computed identically in the overlap by every
adjacent rank (deterministic per-entity closure computations), replacing
the reference's owner-computes + broadcast messages with one bulk halo at
construction; results are bit-identical to the serial engine, validated
digit-exact by tests/test_dist_coarsen.py.

The coarse global numbering is rank-independent: coarse dofs are ordered by
(form-stage codim, global entity representative, index within entity) with
owner offsets, so every rank addresses shared coarse dofs consistently
without negotiation.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.mesh.entities import derive_entities
from parelag_tpu_torch.parallel.patch import (
    RankPatch, build_rank_patches, fine_entity_gids)


def distributed_coarsen(mesh, rank_of_elem, partition, n_ranks,
                        upscaling_order=0, svd_tol=1e-9, jform_start=0,
                        check_topology=False):
    """Run the distributed setup; returns (patches, global_ents).

    Each returned patch has .topo (patch topology, coarsened), .seq (patch
    fine sequence, coarsened) and .coarse (patch coarse sequence).
    check_topology enables the Betti checker + pinch repair on every
    patch topology (each patch carries the COMPLETE closure of its halo
    agglomerates, so repair decisions — facet deagglomeration, curl-range
    enrichment — are entity-local and identical on every patch sharing
    the entity; reference protocol DeRhamSequence.cpp:283-424)."""
    patches = build_rank_patches(mesh, rank_of_elem, partition, n_ranks)
    global_ents = derive_entities(mesh)
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
    for p in patches:
        p.topo = AgglomeratedTopology.from_mesh(p.mesh)
        p.topo.coarsen_local_partitioning(p.part_local,
                                          check_topology=check_topology)
        p.seq = DeRhamSequenceFE(p.topo, p.mesh)
        p.seq.jform_start = jform_start
        p.seq.set_upscaling_targets(upscaling_order)
        p.coarse = p.seq.coarsen(svd_tol)
    return patches, global_ents


# ---------------------------------------------------------------------- #
# ownership + global identification of coarse entities
# ---------------------------------------------------------------------- #
def coarse_owner_ranks(patch, codim):
    """Owning rank per patch coarse entity of `codim` (min adjacent-AE
    rank; matches SharingMap's lowest-rank-owns convention)."""
    topo_c = patch.topo.coarser
    if codim == 0:
        return patch.ae_rank
    from parelag_tpu_torch.ops import csr as C
    conn = C.pattern(topo_c.connectivity(0, codim)).tocsc()
    n_ent = topo_c.num_entities(codim)
    owner = np.full(n_ent, np.iinfo(np.int64).max, dtype=np.int64)
    coo = conn.tocoo()
    np.minimum.at(owner, coo.col, patch.ae_rank[coo.row])
    return owner


def coarse_entity_reps(patch, global_ents, codim, dim=3):
    """Global representative (min member fine-entity gid) per patch coarse
    entity — a rank-independent identity for shared coarse entities."""
    return coarse_entity_sigs(patch, global_ents, codim, dim)[0]


def coarse_entity_sigs(patch, global_ents, codim, dim=3):
    """(reps, member_count, member_gid_sum) per patch coarse entity. The
    full triple identifies an entity by its member SET, so a patch-fringe
    artifact that happens to share a representative with the true global
    entity (e.g. a one-sided merge of several interface facets at the halo
    boundary) can never alias it."""
    AE_e = sp.csr_matrix(patch.topo.AEntity_entity[codim])
    gids = fine_entity_gids(patch, global_ents, codim, dim)
    n = AE_e.shape[0]
    reps = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    rows = np.repeat(np.arange(n), np.diff(AE_e.indptr))
    np.minimum.at(reps, rows, gids[AE_e.indices])
    counts = np.diff(AE_e.indptr)
    sums = np.zeros(n, dtype=np.int64)
    np.add.at(sums, rows, gids[AE_e.indices])
    return reps, counts, sums


def fine_dof_gids(patch, global_ents, form, dim=3):
    """Global fine dof ids of a patch for `form`. Lowest order: dofs ARE
    entities of codim dim-form. Arbitrary order (entity-major HO
    handlers): per-entity dof blocks over global entity gids — the global
    layout [verts | edges*n_edge | faces*n_face | cells*n_int] with the
    same within-entity order on every rank (gid-derived edge directions
    and face frames survive the patch's MONOTONE vertex remap)."""
    seq = patch.seqs[0] if hasattr(patch, "seqs") else patch.seq
    h = seq.dof[form]
    if hasattr(h, "off_f"):                 # HO entity-major handler
        return _ho_dof_gids(patch, global_ents, h, form, dim)
    return fine_entity_gids(patch, global_ents, dim - form, dim)


def _ho_dof_gids(patch, global_ents, h, form, dim=3):
    nv_g = global_ents.num_vertices
    ned_g = global_ents.num_edges
    nfc_g = global_ents.num_faces
    off_e_g = nv_g if form == 0 else 0
    off_f_g = off_e_g + ned_g * h.n_edge
    off_i_g = off_f_g + nfc_g * h.n_face
    parts = []
    if form == 0:
        parts.append(patch.vert_gids)
    if h.n_edge:
        eg = fine_entity_gids(patch, global_ents, 2, dim)
        parts.append((off_e_g + eg[:, None] * h.n_edge
                      + np.arange(h.n_edge)[None, :]).ravel())
    if h.n_face:
        fg = fine_entity_gids(patch, global_ents, 1, dim)
        parts.append((off_f_g + fg[:, None] * h.n_face
                      + np.arange(h.n_face)[None, :]).ravel())
    if h.n_int:
        parts.append((off_i_g + patch.elem_gids[:, None] * h.n_int
                      + np.arange(h.n_int)[None, :]).ravel())
    out = np.concatenate(parts)
    assert out.size == h.ndofs
    return out


@dataclass
class CoarseNumbering:
    """Global coarse dof numbering for one form."""
    ndofs: int
    # per patch: (local coarse dof id -> global id), -1 for non-owned-rank
    local_to_global: list
    owner_of_global: np.ndarray


def global_coarse_numbering(patches, global_ents, form, dim=3):
    """Rank-independent coarse dof numbering: stages ordered exactly like
    the serial DofHandlerALG (codim descending from dim-form), entities
    within a stage ordered by global representative, dofs within an entity
    by interior index. Every patch gets a map for ALL its local coarse dofs
    (owned or ghost), so interface columns address consistently."""
    max_codim = dim - form
    # collect (codim, rep) -> dof count, registered ONLY by the entity's
    # owner patch: patch-fringe artifacts (coarse entities whose global
    # closure extends beyond a patch) are always non-owned there and must
    # not enter the numbering; truly shared entities are computed
    # identically by every adjacent rank
    stage_entities = {}
    owners = {}
    sig_of = {}
    per_patch_meta = []
    for p in patches:
        cdof = p.coarse.dof[form]
        meta = {}
        for codim in range(max_codim, -1, -1):
            reps, mcnt, msum = coarse_entity_sigs(
                p, global_ents, codim, dim)
            orank = coarse_owner_ranks(p, codim)
            counts = (cdof.n_ranget[codim] + cdof.n_null[codim]).copy()
            # curl-range enrichment extras count toward the entity
            for (c, ient), v in cdof._extra_interior.items():
                if c == codim:
                    counts[ient] += v.size
            own = orank == p.rank
            for i in np.nonzero(own)[0]:
                stage_entities.setdefault(codim, {})[
                    int(reps[i])] = int(counts[i])
                owners[(codim, int(reps[i]))] = p.rank
                sig_of[(codim, int(reps[i]))] = (int(mcnt[i]),
                                                 int(msum[i]))
            meta[codim] = (reps, mcnt, msum)
        per_patch_meta.append(meta)

    # global offsets per (codim, rep): codim descending, rep ascending
    offset_of = {}
    owner_list = []
    pos = 0
    for codim in range(max_codim, -1, -1):
        for rep in sorted(stage_entities.get(codim, {})):
            cnt = stage_entities[codim][rep]
            offset_of[(codim, rep)] = pos
            owner_list.extend([owners[(codim, rep)]] * cnt)
            pos += cnt

    loc2glob = []
    for ip, p in enumerate(patches):
        cdof = p.coarse.dof[form]
        out = np.full(cdof.ndofs, -1, dtype=np.int64)
        for codim in range(max_codim, -1, -1):
            reps, mcnt, msum = per_patch_meta[ip][codim]
            o = cdof.interior_offsets[codim]
            for i, rep in enumerate(reps):
                key = (codim, int(rep))
                base = offset_of.get(key)
                if base is None or sig_of[key] != (int(mcnt[i]),
                                                   int(msum[i])):
                    continue              # fringe artifact: never used
                cnt_reg = o[i + 1] - o[i]
                out[o[i]:o[i + 1]] = base + np.arange(cnt_reg)
                ex = cdof._extras(codim, i)     # enrichment extras map
                out[ex] = base + cnt_reg + np.arange(ex.size)  # after the
                #                                  entity's regular dofs
        loc2glob.append(out)
    return CoarseNumbering(pos, loc2glob,
                           np.asarray(owner_list, dtype=np.int64))


def rank_P_rows(patch, global_ents, numbering, form, n_fine, dim=3):
    """This rank's contribution to the global interpolation P of `form`:
    columns of coarse entities OWNED by the rank, in global fine/coarse
    numbering. The union over ranks is exactly the serial P (validated by
    the tests); no rank needs any other rank's matrix."""
    cdof = patch.coarse.dof[form]
    max_codim = dim - form
    owned_cols = np.zeros(cdof.ndofs, dtype=bool)
    for codim in range(max_codim, -1, -1):
        orank = coarse_owner_ranks(patch, codim)
        o = cdof.interior_offsets[codim]
        own = np.nonzero(orank == patch.rank)[0]
        for i in own:
            owned_cols[o[i]:o[i + 1]] = True
            owned_cols[cdof._extras(codim, i)] = True
    P = sp.csc_matrix(patch.seq.P[form])
    keep = np.nonzero(owned_cols)[0]
    Pk = P[:, keep].tocoo()
    rows = fine_dof_gids(patch, global_ents, form, dim)[Pk.row]
    cols = numbering.local_to_global[patch.rank][keep][Pk.col]
    return rows, cols, Pk.data


def rank_D_rows(patch, numbering_p, numbering_u, form):
    """This rank's rows of the coarse derivative D_c[form]: rows of
    jform+1 coarse dofs owned by the rank, in global coarse numbering."""
    Dc = sp.csr_matrix(patch.coarse.D[form])
    g_rows = numbering_p.local_to_global[patch.rank]
    g_cols = numbering_u.local_to_global[patch.rank]
    own = (g_rows >= 0) & (
        numbering_p.owner_of_global[np.maximum(g_rows, 0)] == patch.rank)
    keep = np.nonzero(own)[0]
    Dk = Dc[keep].tocoo()
    rows = g_rows[keep][Dk.row]
    cols = g_cols[Dk.col]
    assert np.all(cols >= 0), \
        "owned coarse-D row references an unidentified ghost dof"
    return rows, cols, Dk.data


def publish_P(patches, global_ents, numbering, form, n_fine, dim=3):
    """Owner-published interpolation columns in (global fine row, global
    coarse col, value) triplet form — the SharingMap::Distribute analog:
    the only inter-rank payload the distributed RAP needs."""
    rows, cols, vals = [], [], []
    for p in patches:
        r, c, v = rank_P_rows(p, global_ents, numbering, form, n_fine, dim)
        rows.append(r)
        cols.append(c)
        vals.append(v)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def rank_coarse_operator_rows(patch, global_ents, numbering, form, A_fn,
                              published, n_fine, dim=3):
    """Owned rows of the coarse operator Ac = P^T A P in global numbering
    — the distributed RAP (hypre_RDP / mfem::RAP analog, Hierarchy.cpp:366).

    A_fn(patch) returns the PATCH fine operator (assembled from patch-local
    mass matrices); `published` are the owner-published P triplets
    restricted here to the patch's fine dofs (columns of neighboring
    ranks' coarse dofs that overlap this rank's support — the halo P).
    No global fine matrix exists anywhere; owned rows are exact because an
    owned basis function's support (its agglomerates + their closures) and
    every overlapping published column are complete within the patch."""
    rows_g, cols_g, vals = published
    fg = fine_dof_gids(patch, global_ents, form, dim)
    lmap = np.full(n_fine, -1, dtype=np.int64)
    lmap[fg] = np.arange(fg.size)
    sel = lmap[rows_g] >= 0
    P_halo = sp.coo_matrix(
        (vals[sel], (lmap[rows_g[sel]], cols_g[sel])),
        shape=(fg.size, numbering.ndofs)).tocsr()
    A_loc = sp.csr_matrix(A_fn(patch))
    Ac = (P_halo.T @ A_loc @ P_halo).tocsr()
    own_rows = np.nonzero(
        numbering.owner_of_global == patch.rank)[0]
    Ak = Ac[own_rows].tocoo()
    return own_rows[Ak.row], Ak.col, Ak.data
