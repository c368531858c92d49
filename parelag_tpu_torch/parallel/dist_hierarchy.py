"""Multi-level distributed setup -> solve pipeline (no global fine matrix).

The reference runs the WHOLE hierarchy distributed at every depth: recursive
DeRhamSequence::Coarsen under MPI (src/amge/DeRhamSequence.cpp:572-692) and
per-level ParCSR RAP inside the hierarchy builder
(src/linalg/solver_ops/ParELAG_Hierarchy.cpp:282-385). This module recurses
the patch-based distributed Coarsen of parallel.dist_coarsen to arbitrary
depth and feeds the resulting per-level OWNED OPERATOR ROWS directly into
the device-sharded L-level V-cycle (parallel.sharding.DistributedHierarchy)
— no rank ever assembles a global fine matrix; the only globally assembled
object is the coarsest-level operator, exactly when it is small enough for
the replicated dense inverse (the reference's coarse-solver gather).

Design (extends the single-level RankPatch protocol):

* The level partitions must be NESTED IN RANKS: every top-level agglomerate
  lives on one rank (the reference invariant "agglomerates never span
  ranks", Topology.hpp:503-512). Nesting makes every intermediate-level AE
  rank-pure too.
* A rank's patch = all fine elements of every TOP-level AE sharing a fine
  vertex with its owned elements. Because membership is nested, vertex
  adjacency at the top level subsumes vertex adjacency at all finer levels,
  so every AE of EVERY level inside the patch is complete, and the
  order-preserving local numbering keeps all per-entity computations
  bit-identical to the serial engine (see parallel.patch docstring).
* Shared coarse entities at any level are identified rank-independently by
  their fine-member signature (min gid, count, gid-sum) obtained by
  composing the AEntity_entity chains down to level 0.
* Owned rows of the level-(l+1) operator are computed per patch as
  Pcomp^T A_patch Pcomp where Pcomp is the composite prolongation
  level0 <- level(l+1) assembled from the owner-published P triplets of
  levels 0..l RESTRICTED to the patch (the SharingMap::Distribute payload);
  owned-row exactness holds because an owned coarse basis function's level-0
  support, and every published column overlapping it, are complete within
  the vertex-adjacency patch.

Validated digit-exact against the serial multi-level engine by
tests/test_dist_hierarchy.py.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.mesh.entities import derive_entities
from parelag_tpu_torch.ops import csr as C
from parelag_tpu_torch.parallel.patch import build_rank_patches, fine_entity_gids
from parelag_tpu_torch.parallel.dist_coarsen import (
    CoarseNumbering, fine_dof_gids)


def _dense_remap(vals):
    """(local_ids, sorted_unique_globals): order-preserving dense remap."""
    uniq, inv = np.unique(np.asarray(vals), return_inverse=True)
    return inv, uniq


def compose_partitions(partitions):
    """comp[l][e] = level-(l+1) agglomerate of fine element e."""
    comp = [np.asarray(partitions[0])]
    for p in partitions[1:]:
        comp.append(np.asarray(p)[comp[-1]])
    return comp


def distributed_coarsen_multilevel(mesh, rank_of_elem, partitions, n_ranks,
                                   upscaling_order=0, svd_tol=1e-9,
                                   jform_start=0, fe_hook=None,
                                   targets_fn=None, seq_factory=None,
                                   ranks=None):
    """Recursive distributed Coarsen (DeRhamSequence.cpp:572-692 under MPI).

    partitions[0] maps fine elements -> level-1 AEs; partitions[l] maps
    level-l AEs -> level-(l+1) AEs. Every partition must be clean (each AE
    connected and ids contiguous) and the composed top level nested in
    ranks. Returns (patches, global_ents); each patch carries .topos
    (fine..coarsest-1, each with .coarser set), .seqs (fine..coarsest) and
    per-level local AE gid tables .ae_gids_lvl / owner ranks .ae_rank_lvl.

    fe_hook(seq_fe): optional per-patch hook on the fine FE sequence (e.g.
    replace_mass_integrator with a coordinate-based coefficient — patch
    meshes keep global coordinates, so the field is rank-consistent).

    targets_fn(seq): optional per-level hook called before each coarsen to
    install LOCAL (e.g. spectral) targets. This is the distributed-spectral
    protocol: the reference merges per-AE spectral targets on shared
    agglomerated entities via SharedEntityCommunication collect/SVD/
    broadcast (DeRhamSequence.cpp:283-424); here every shared entity's
    adjacent agglomerates are complete inside each adjacent rank's patch,
    so the hook recomputes the identical eigensolves in the overlap — the
    owner-computes+broadcast messages become the one-time bulk halo, and
    shared-entity targets come out bit-identical on every adjacent rank
    (validated digit-exact by tests/test_dist_spectral.py).
    """
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE

    rank_of_elem = np.asarray(rank_of_elem)
    comp = compose_partitions(partitions)
    n_levels = len(partitions)

    # global rank per AE at every level (nested => well-defined)
    ae_rank_g = []
    for lvl in range(n_levels):
        n_ae = int(comp[lvl].max()) + 1
        r = np.full(n_ae, -1, dtype=np.int64)
        r[comp[lvl]] = rank_of_elem
        assert np.all(r[comp[lvl]] == rank_of_elem), \
            "partitions must be nested in ranks at every level"
        ae_rank_g.append(r)

    patches = build_rank_patches(mesh, rank_of_elem, comp[-1], n_ranks)
    if ranks is not None:
        # true multi-process deployment: THIS process coarsens only its
        # own rank's patch(es); cross-rank data rides the numbering /
        # published-P exchanges (tests/_mp_setup_worker.py)
        patches = [p for p in patches if p.rank in set(ranks)]
    global_ents = derive_entities(mesh)

    for p in patches:
        p.topos = [AgglomeratedTopology.from_mesh(p.mesh)]
        p.ae_gids_lvl = []
        p.ae_rank_lvl = []
        # per-level local partitions by order-preserving dense remap of the
        # global AE ids present in the patch
        local_part, ae_gids = _dense_remap(comp[0][p.elem_gids])
        for lvl in range(n_levels):
            p.topos[-1].coarsen_local_partitioning(local_part)
            assert p.topos[-1].coarser.num_entities(0) == ae_gids.size, (
                "partition not clean: connected-components fixup changed "
                "the agglomerate count inside a patch")
            p.ae_gids_lvl.append(ae_gids)
            p.ae_rank_lvl.append(ae_rank_g[lvl][ae_gids])
            p.topos.append(p.topos[-1].coarser)
            if lvl + 1 < n_levels:
                local_part, ae_gids = _dense_remap(
                    np.asarray(partitions[lvl + 1])[ae_gids])
        seq0 = (DeRhamSequenceFE(p.topos[0], p.mesh)
                if seq_factory is None
                else seq_factory(p.topos[0], p.mesh))
        seq0.jform_start = jform_start
        if fe_hook is not None:
            fe_hook(seq0)
        seq0.set_upscaling_targets(upscaling_order)
        p.seqs = [seq0]
        for lvl in range(n_levels):
            if targets_fn is not None:
                p.seqs[-1].agglomerate_dofs()
                targets_fn(p.seqs[-1])
            p.seqs.append(p.seqs[-1].coarsen(svd_tol))
        # keep the single-level aliases alive for dist_coarsen helpers
        p.topo = p.topos[0]
        p.seq = p.seqs[0]
        p.coarse = p.seqs[1]
        p.ae_rank = p.ae_rank_lvl[0]
    return patches, global_ents


# ---------------------------------------------------------------------- #
# rank-independent identification of level-l coarse entities
# ---------------------------------------------------------------------- #
def _member_pattern(patch, level, codim):
    """Boolean pattern (level-`level` entities x patch FINE entities of the
    same codim), composed through the AEntity_entity chain."""
    pat = C.pattern(patch.topos[0].AEntity_entity[codim])
    for lvl in range(1, level):
        pat = C.bool_mult(
            C.pattern(patch.topos[lvl].AEntity_entity[codim]), pat)
    return sp.csr_matrix(pat)


def entity_sigs_level(patch, global_ents, level, codim, dim=3):
    """(reps, member_count, member_gid_sum) of level-`level` entities at
    `codim`, in FINE global-entity terms (rank-independent identity; the
    full triple rules out patch-fringe aliasing as in dist_coarsen)."""
    pat = _member_pattern(patch, level, codim)
    gids = fine_entity_gids(patch, global_ents, codim, dim)
    n = pat.shape[0]
    rows = np.repeat(np.arange(n), np.diff(pat.indptr))
    reps = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(reps, rows, gids[pat.indices])
    counts = np.diff(pat.indptr)
    sums = np.zeros(n, dtype=np.int64)
    np.add.at(sums, rows, gids[pat.indices])
    return reps, counts, sums


def entity_owner_ranks_level(patch, level, codim):
    """Owning rank per level-`level` entity of `codim` = min adjacent-AE
    rank at that level (SharingMap's lowest-rank-owns convention)."""
    if codim == 0:
        return patch.ae_rank_lvl[level - 1]
    topo_c = patch.topos[level]
    conn = C.pattern(topo_c.connectivity(0, codim)).tocsc()
    owner = np.full(topo_c.num_entities(codim), np.iinfo(np.int64).max,
                    dtype=np.int64)
    coo = conn.tocoo()
    np.minimum.at(owner, coo.col, patch.ae_rank_lvl[level - 1][coo.row])
    return owner


def patch_numbering_meta(patch, global_ents, form, level, dim=3):
    """Per-codim numbering metadata of ONE rank's patch at `level` — the
    exchangeable payload of the multi-process numbering protocol (the
    reference ships the same information through SharingMap::SetUp /
    SharedEntityCommunication; here it rides one allgather).  Per codim:
    (reps, member_count, member_sum, owner_rank, dof_count) int64 arrays
    over the patch's agglomerated entities."""
    cdof = patch.seqs[level].dof[form]
    max_codim = dim - form
    meta = {}
    for codim in range(max_codim, -1, -1):
        reps, mcnt, msum = entity_sigs_level(
            patch, global_ents, level, codim, dim)
        orank = entity_owner_ranks_level(patch, level, codim)
        counts = np.asarray(cdof.n_ranget[codim]
                            + cdof.n_null[codim], dtype=np.int64)
        meta[codim] = (np.asarray(reps, np.int64),
                       np.asarray(mcnt, np.int64),
                       np.asarray(msum, np.int64),
                       np.asarray(orank, np.int64), counts)
    return meta


def numbering_offsets_from_meta(metas_by_rank, max_codim):
    """Reduce exchanged per-rank metadata into the global dof layout:
    (ndofs, offset_of[(codim, rep)], sig_of[(codim, rep)], owner_per_dof).
    Deterministic regardless of which process contributed which rank."""
    stage_entities, owners, sig_of = {}, {}, {}
    for rank, meta in metas_by_rank:
        for codim, (reps, mcnt, msum, orank, counts) in meta.items():
            for i in np.nonzero(orank == rank)[0]:
                stage_entities.setdefault(codim, {})[
                    int(reps[i])] = int(counts[i])
                owners[(codim, int(reps[i]))] = int(rank)
                sig_of[(codim, int(reps[i]))] = (int(mcnt[i]),
                                                 int(msum[i]))
    offset_of = {}
    owner_list = []
    pos = 0
    for codim in range(max_codim, -1, -1):
        for rep in sorted(stage_entities.get(codim, {})):
            offset_of[(codim, rep)] = pos
            owner_list.extend([owners[(codim, rep)]]
                              * stage_entities[codim][rep])
            pos += stage_entities[codim][rep]
    return pos, offset_of, sig_of, np.asarray(owner_list, np.int64)


def patch_loc2glob_from_meta(patch, meta, offset_of, sig_of, form, level,
                             dim=3):
    """Local coarse dof -> global id for one patch, given the reduced
    global layout (fringe artifacts rejected by the member signature)."""
    cdof = patch.seqs[level].dof[form]
    max_codim = dim - form
    out = np.full(cdof.ndofs, -1, dtype=np.int64)
    for codim in range(max_codim, -1, -1):
        reps, mcnt, msum, _, _ = meta[codim]
        o = cdof.interior_offsets[codim]
        for i, rep in enumerate(reps):
            key = (codim, int(rep))
            base = offset_of.get(key)
            if base is None or sig_of[key] != (int(mcnt[i]),
                                               int(msum[i])):
                continue
            out[o[i]:o[i + 1]] = base + np.arange(o[i + 1] - o[i])
    return out


def global_numbering_level(patches, global_ents, form, level, dim=3):
    """Rank-independent global numbering of the level-`level` coarse dofs of
    `form` (generalizes dist_coarsen.global_coarse_numbering to any depth):
    stages ordered codim-descending like the serial DofHandlerALG, entities
    within a stage by fine-member representative, dofs within an entity by
    interior index. Owned entities register counts; fringe artifacts are
    rejected by the full member signature.  Composed from the
    multi-process protocol pieces above (a true multi-process run
    exchanges patch_numbering_meta and reduces identically —
    tests/_mp_setup_worker.py)."""
    max_codim = dim - form
    metas = [(p.rank, patch_numbering_meta(p, global_ents, form, level,
                                           dim)) for p in patches]
    pos, offset_of, sig_of, owner = numbering_offsets_from_meta(
        metas, max_codim)
    loc2glob = {p.rank: patch_loc2glob_from_meta(
        p, meta, offset_of, sig_of, form, level, dim)
        for p, (_, meta) in zip(patches, metas)}
    return CoarseNumbering(pos, loc2glob, owner)


# ---------------------------------------------------------------------- #
# owner-published interpolation triplets per level
# ---------------------------------------------------------------------- #
def rank_P_rows_level(patch, global_ents, num_fine, num_coarse, form,
                      level, dim=3):
    """Rank's owned columns of P at `level` (level-`level` rows x
    level-(level+1) cols) in GLOBAL numbering. num_fine is None at level 0
    (rows are fine dofs, numbered by fine gids)."""
    cdof = patch.seqs[level + 1].dof[form]
    max_codim = dim - form
    owned_cols = np.zeros(cdof.ndofs, dtype=bool)
    for codim in range(max_codim, -1, -1):
        orank = entity_owner_ranks_level(patch, level + 1, codim)
        o = cdof.interior_offsets[codim]
        for i in np.nonzero(orank == patch.rank)[0]:
            owned_cols[o[i]:o[i + 1]] = True
    P = sp.csc_matrix(patch.seqs[level].P[form])
    keep = np.nonzero(owned_cols)[0]
    Pk = P[:, keep].tocoo()
    if level == 0:
        row_g = fine_dof_gids(patch, global_ents, form, dim)
    else:
        row_g = num_fine.local_to_global[patch.rank]
    rows = row_g[Pk.row]
    cols = num_coarse.local_to_global[patch.rank][keep][Pk.col]
    ok = rows >= 0
    assert np.all(ok[np.nonzero(np.abs(Pk.data) > 0)]), \
        "owned P column references an unidentified row dof"
    return rows[ok], cols[ok], Pk.data[ok]


def publish_P_level(patches, global_ents, num_fine, num_coarse, form,
                    level, dim=3):
    """Owner-published P triplets of `level` — the only inter-rank payload
    (SharingMap::Distribute analog). In a multi-host run each rank receives
    only the triplets whose rows touch its patch; here the union is built
    once and every consumer restricts (parallel.dist_coarsen.publish_P)."""
    rows, cols, vals = [], [], []
    for p in patches:
        r, c, v = rank_P_rows_level(p, global_ents, num_fine, num_coarse,
                                    form, level, dim)
        rows.append(r)
        cols.append(c)
        vals.append(v)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def _patch_composite_P(patch, global_ents, published, numberings, form,
                       level, n_fine, dim=3):
    """Composite prolongation (patch fine dofs x global level-`level` dofs)
    from the published triplets, restricted level-by-level to the patch's
    reach (the halo-P of the recursion)."""
    fg = fine_dof_gids(patch, global_ents, form, dim)
    lmap = np.full(n_fine, -1, dtype=np.int64)
    lmap[fg] = np.arange(fg.size)
    rows_g, cols_g, vals = published[0]
    sel = lmap[rows_g] >= 0
    Pc = sp.coo_matrix(
        (vals[sel], (lmap[rows_g[sel]], cols_g[sel])),
        shape=(fg.size, numberings[0].ndofs)).tocsr()
    for lvl in range(1, level):
        rows_g, cols_g, vals = published[lvl]
        # only rows reachable from the patch (the received halo columns)
        reach = np.zeros(numberings[lvl - 1].ndofs, dtype=bool)
        reach[Pc.indices] = True
        sel = reach[rows_g]
        Pl = sp.coo_matrix(
            (vals[sel], (rows_g[sel], cols_g[sel])),
            shape=(numberings[lvl - 1].ndofs, numberings[lvl].ndofs)
        ).tocsr()
        Pc = (Pc @ Pl).tocsr()
    return Pc


def rank_operator_rows_level(patch, global_ents, published, numberings,
                             form, level, A_fn, n_fine, dim=3):
    """Owned rows of the level-`level` operator A_l = Pcomp^T A_0 Pcomp in
    global numbering — the recursive distributed RAP
    (ParELAG_Hierarchy.cpp:282-385). A_fn(patch) returns the PATCH fine
    operator; exact for owned rows because an owned coarse basis function's
    fine support and every overlapping published column are complete within
    the vertex-adjacency patch."""
    Pc = _patch_composite_P(patch, global_ents, published, numberings,
                            form, level, n_fine, dim)
    A_loc = sp.csr_matrix(A_fn(patch))
    Ac = (Pc.T @ A_loc @ Pc).tocsr()
    own = np.nonzero(
        numberings[level - 1].owner_of_global == patch.rank)[0]
    Ak = Ac[own].tocoo()
    return own[Ak.row], Ak.col, Ak.data


def rank_fine_rows(patch, global_ents, form, A_fn, fine_owner, n_fine,
                   dim=3):
    """Owned rows of the FINE operator from patch-local assembly (each rank
    owns the dofs whose min adjacent element rank is itself)."""
    fg = fine_dof_gids(patch, global_ents, form, dim)
    A_loc = sp.csr_matrix(A_fn(patch))
    own_local = np.nonzero(fine_owner[fg] == patch.rank)[0]
    Ak = A_loc[own_local].tocoo()
    return fg[own_local][Ak.row], fg[Ak.col], Ak.data


# ---------------------------------------------------------------------- #
# distributed setup output -> device-sharded hierarchy
# ---------------------------------------------------------------------- #
@dataclass
class DistMLSetup:
    """Everything the distributed solve needs, produced without a global
    fine matrix: per-level owned operator rows + published P triplets."""
    n_levels: int                  # operator levels (fine..coarsest)
    ndofs: list                    # global dof count per level
    owners: list                   # dof owner vector per level
    A_rows: list                   # per level: list over ranks of triplets
    P_published: list              # per coarsening: published triplets
    numberings: list               # CoarseNumbering per coarse level
    fine_gids: list                # per rank: fine dof gids of its patch


def distributed_operator_setup(patches, global_ents, form, A_fn,
                               rank_of_elem, dim=3):
    """Run the post-coarsening distributed operator setup: per-level global
    numberings, published P, per-rank owned operator rows at every level."""
    n_coarsen = len(patches[0].seqs) - 1
    # true global fine dof count from the gid space
    n_fine = max(int(fine_dof_gids(p, global_ents, form, dim).max())
                 for p in patches) + 1

    fine_owner = np.full(n_fine, np.iinfo(np.int64).max, dtype=np.int64)
    rank_of_elem = np.asarray(rank_of_elem)
    for p in patches:
        fg = fine_dof_gids(p, global_ents, form, dim)
        # min adjacent element rank, computed from patch connectivity
        pat = sp.csr_matrix(
            p.seqs[0].dof[form].entity_dof_pattern(0)).T.tocsr()
        ranks = rank_of_elem[p.elem_gids]
        coo = pat.tocoo()
        np.minimum.at(fine_owner, fg[coo.row], ranks[coo.col])

    numberings = []
    published = []
    num_prev = None
    for lvl in range(n_coarsen):
        num = global_numbering_level(patches, global_ents, form, lvl + 1,
                                     dim)
        pub = publish_P_level(patches, global_ents, num_prev, num, form,
                              lvl, dim)
        numberings.append(num)
        published.append(pub)
        num_prev = num

    A_rows = [[rank_fine_rows(p, global_ents, form, A_fn, fine_owner,
                              n_fine, dim) for p in patches]]
    for lvl in range(1, n_coarsen + 1):
        A_rows.append([
            rank_operator_rows_level(p, global_ents, published, numberings,
                                     form, lvl, A_fn, n_fine, dim)
            for p in patches])

    ndofs = [n_fine] + [n.ndofs for n in numberings]
    owners = [fine_owner] + [n.owner_of_global for n in numberings]
    fine_gids = [fine_dof_gids(p, global_ents, form, dim) for p in patches]
    return DistMLSetup(n_coarsen + 1, ndofs, owners, A_rows, published,
                       numberings, fine_gids)


def distribute_from_rank_rows(rank_rows, owner, ndofs, ndev,
                              dtype=np.float64):
    """Build a sharding.DistributedSystem directly from per-rank owned-row
    triplets — the device-block construction never assembles a global CSR
    (rows land straight in their owner device's padded block)."""
    from parelag_tpu_torch.parallel.sharding import (
        DistributedSystem, owner_layout)

    owner = np.asarray(owner)
    n = ndofs
    slot, n_loc, virt = owner_layout(owner, ndev)

    # global max row width across ranks (one scalar allreduce)
    k = 1
    for rows, cols, vals in rank_rows:
        if rows.size:
            k = max(k, int(np.bincount(rows.astype(np.int64)).max()))
    indices = np.zeros((ndev, n_loc, k), dtype=np.int32)
    values = np.zeros((ndev, n_loc, k), dtype=dtype)
    row_mask = np.zeros((ndev, n_loc), dtype=dtype)
    row_mask[owner, slot] = 1.0
    for r, (rows, cols, vals) in enumerate(rank_rows):
        if not rows.size:
            continue
        assert np.all(owner[rows] == r), \
            "rank contributed a row it does not own"
        o = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[o], cols[o], vals[o]
        starts = np.concatenate(([True], rows[1:] != rows[:-1]))
        pos = np.arange(rows.size) - np.flatnonzero(starts)[
            np.cumsum(starts) - 1]
        indices[r, slot[rows], pos] = virt[cols]
        values[r, slot[rows], pos] = vals
    l1 = np.abs(values).sum(axis=2)
    dinv = np.where(l1 > 0, 1.0 / np.maximum(l1, 1e-30), 0.0).astype(dtype)
    return DistributedSystem(ndev, n_loc, n, owner, slot, virt,
                             indices, values, row_mask, dinv)


def build_hierarchy_from_setup(setup: DistMLSetup, ndev,
                               dtype=np.float64):
    """DistributedHierarchy straight from the distributed setup output.
    The coarsest operator is the only globally assembled matrix (replicated
    dense inverse, applied when it fits — the reference's coarse gather)."""
    from parelag_tpu_torch.parallel.sharding import (
        DistributedHierarchy, build_halo_plan, distribute_rect)

    systems, plans, P_rows = [], [], []
    for lvl in range(setup.n_levels):
        s = distribute_from_rank_rows(
            setup.A_rows[lvl], setup.owners[lvl], setup.ndofs[lvl], ndev,
            dtype=dtype)
        systems.append(s)
        plans.append(build_halo_plan(s))
    for lvl in range(setup.n_levels - 1):
        s, s_c = systems[lvl], systems[lvl + 1]
        rows_g, cols_g, vals = setup.P_published[lvl]
        P_csr = sp.coo_matrix(
            (vals, (rows_g, s_c.virt[cols_g])),
            shape=(setup.ndofs[lvl], ndev * s_c.n_loc)).tocsr()
        Pi, Pv = distribute_rect(P_csr, setup.owners[lvl], ndev, s.n_loc,
                                 dtype=dtype)
        P_rows.append((Pi, Pv))
    # coarsest: gather the owned rows (small by construction)
    rows = np.concatenate([t[0] for t in setup.A_rows[-1]])
    cols = np.concatenate([t[1] for t in setup.A_rows[-1]])
    vals = np.concatenate([t[2] for t in setup.A_rows[-1]])
    Ac = sp.coo_matrix((vals, (rows, cols)),
                       shape=(setup.ndofs[-1], setup.ndofs[-1])).toarray()
    coarse_inv = np.linalg.inv(Ac).astype(dtype)
    return DistributedHierarchy(systems, plans, P_rows, coarse_inv,
                                setup.owners)


def distributed_rhs(setup: DistMLSetup, patches, b_fn):
    """Global fine rhs from per-patch assembly restricted to owned dofs
    (b_fn(patch) -> patch-local vector)."""
    b = np.zeros(setup.ndofs[0])
    for p, fg in zip(patches, setup.fine_gids):
        bl = np.asarray(b_fn(p))
        own = setup.owners[0][fg] == p.rank
        b[fg[own]] = bl[own]
    return b
