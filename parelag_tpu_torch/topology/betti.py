"""Agglomerate validity checking via Betti numbers.

Rebuild of AgglomeratedTopologyCheck (reference
src/topology/AgglomeratedTopologyCheck.{hpp,cpp}): for each agglomerated
entity of a codim, compute the Betti numbers of its closure sub-complex from
ranks of the restricted boundary operators:

    betti[iAE, nLower-1-i] = dim C_{i+1} - rank dB_i - rank dB_{i+1}

where dB_i = B[codim+i] restricted to the AE's entities. betti[:,0] is the
number of connected components; betti[:,1] counts tunnels; betti[:,2] holes.

An agglomerated element is bad if it is disconnected, has tunnels, or holes;
an agglomerated facet if disconnected or with holes; an agglomerated ridge if
disconnected. An additional connectivity check rejects agglomerates whose
boundary edges touch more than two boundary faces (reference
additionalTopologyCheck, AgglomeratedTopologyCheck.cpp:25-84).
"""

import numpy as np

from parelag_tpu_torch.ops import csr as C


def _blocklist_ranks(bl, tol_rel=1e-9):
    """Numerical ranks of every block in a ragged BlockList.

    Blocks are bucketed by exact shape, deduplicated by content (on a
    structured mesh nearly every agglomerate produces the same restricted
    incidence matrix — interior/face/edge/corner classes), and only the
    unique representatives go through a stacked batched SVD. Replaces the
    per-AE Python SVD loop that made check_topology intractable at bench
    scale."""
    n = len(bl)
    ranks = np.zeros(n, dtype=np.int64)
    rsz, csz = bl.rsz, bl.csz
    ok = (rsz > 0) & (csz > 0)
    if not ok.any():
        return ranks
    keys = rsz * (np.int64(1) << 32) + csz
    for key in np.unique(keys[ok]):
        idxs = np.where(ok & (keys == key))[0]
        r, c = int(rsz[idxs[0]]), int(csz[idxs[0]])
        flat = bl.gather(idxs, (r, c)).reshape(idxs.size, r * c)
        # content dedup via memcmp on a void view
        v = np.ascontiguousarray(flat).view(
            np.dtype((np.void, flat.dtype.itemsize * flat.shape[1])))
        v = v.reshape(-1)
        _, first, inv = np.unique(v, return_index=True,
                                  return_inverse=True)
        batch = flat[first].reshape(first.size, r, c)
        sv = np.linalg.svd(batch, compute_uv=False)
        cut = tol_rel * np.maximum(sv[:, 0], 1.0)
        ranks[idxs] = (sv > cut[:, None]).sum(axis=1)[inv]
    return ranks


def compute_betti_numbers(topo, codim) -> np.ndarray:
    """(nAE, nLowerDims) matrix of Betti numbers per agglomerated entity."""
    n_lower = topo.dim - codim
    if n_lower == 0:
        return np.zeros((0, 0))

    AE_entity = [C.pattern(topo.AEntity_entity[codim])]
    for i in range(n_lower):
        AE_entity.append(C.bool_mult(AE_entity[i], topo.B[codim + i]))
    n_ae = AE_entity[0].shape[0]

    # rank of B[codim+i] restricted to each AE's (ents_i, ents_{i+1}):
    # one flat extraction per chain position, then bucketed batched SVDs
    rank = np.zeros((n_ae, n_lower + 1), dtype=np.int64)
    for i in range(n_lower):
        Mi, Mi1 = AE_entity[i].tocsr(), AE_entity[i + 1].tocsr()
        blocks = C.extract_blocks_cat(
            topo.B[codim + i], Mi.indices, Mi.indptr,
            Mi1.indices, Mi1.indptr)
        rank[:, i] = _blocklist_ranks(blocks)

    dim_k = np.stack([np.diff(m.tocsr().indptr) for m in AE_entity],
                     axis=1)                       # (n_ae, n_lower+1)
    betti = np.zeros((n_ae, n_lower), dtype=np.int64)
    for i in range(n_lower):
        betti[:, n_lower - 1 - i] = (
            dim_k[:, i + 1] - rank[:, i] - rank[:, i + 1])
    return betti


def _additional_check(topo, codim, isbad):
    """Boundary edges of the AE boundary must belong to exactly two boundary
    faces of the AE (manifold boundary). Vectorized: with unit AE_bface
    entries, AE_bedge = AE_bface @ |face_edge| counts per-edge incident
    boundary faces, so the per-AE condition sum(counts) == 2 * #edges is a
    row-sum vs row-nnz comparison."""
    AE_bface = C.drop_zeros(
        (topo.AEntity_entity[codim] @ topo.B[codim]).tocsr(), 1e-10)
    AE_bface = C.abs_csr(AE_bface)
    abs_face_edge = C.abs_csr(topo.B[codim + 1])
    AE_bedge = (AE_bface @ abs_face_edge).tocsr()
    rowsum = np.asarray(AE_bedge.sum(axis=1)).ravel()
    rownnz = np.diff(AE_bedge.indptr)
    isbad |= np.abs(rowsum - 2.0 * rownnz) > 1e-10
    return isbad


def mark_bad_agglomerates(topo, codim) -> np.ndarray:
    """Boolean array: which agglomerated entities of this codim are invalid
    (reference MarkBadAgglomeratedEntities)."""
    betti = compute_betti_numbers(topo, codim)
    n_ae = betti.shape[0]
    isbad = np.zeros(n_ae, dtype=bool)
    if codim == 0:
        isbad |= betti[:, 0] != 1
        for i in range(1, topo.dim):
            isbad |= betti[:, i] != 0
    elif codim == 1:
        isbad |= betti[:, 0] != 1
        for i in range(1, betti.shape[1]):
            isbad |= betti[:, i] != 0
    elif codim == 2:
        isbad |= betti[:, 0] != 1
    if topo.dim == 3 and codim in (0, 1):
        _additional_check(topo, codim, isbad)
    elif topo.dim == 2 and codim == 0:
        _additional_check(topo, codim, isbad)
    return isbad


def describe_bad_agglomerates(topo, codim):
    """Human-readable report lines (reference ShowBadAgglomeratedEntities):
    'Element i is disconnected.', 'Element i has n tunnels.',
    'Element i has n holes.', 'Facet i ...', 'Ridge i ...'."""
    betti = compute_betti_numbers(topo, codim)
    name = {0: "Element", 1: "Facet", 2: "Ridge"}[codim]
    lines = []
    for iae in range(betti.shape[0]):
        if betti[iae, 0] != 1:
            lines.append(
                f"{name} {iae} is disconnected. The number of connected "
                f"components is {betti[iae, 0]}")
        n_lower = betti.shape[1]
        for i in range(1, n_lower):
            if betti[iae, i] != 0:
                kind = "holes" if i == n_lower - 1 else "tunnels"
                if codim == 1 and i == 1:
                    kind = "holes"
                lines.append(f"{name} {iae} has {betti[iae, i]} {kind}.")
    return lines
