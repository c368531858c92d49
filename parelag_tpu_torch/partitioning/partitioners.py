"""Element partitioners for agglomeration.

Rebuild of the reference src/partitioning/ layer:
  * refined_mesh_partition   — inverse of uniform refinement
                               (MFEMRefinedMeshPartitioner.cpp:48-91)
  * cartesian_partition      — IJK box coarsening
                               (CartesianPartitioner.hpp:43-133)
  * geometric_box_partition  — boxes from vertex coordinates
                               (GeometricBoxPartitioner.hpp:27)
  * graph_partition          — METIS KWAY stand-in: greedy graph-growing
                               with boundary refinement (MetisGraphPartitioner
                               .cpp:37-409; METIS itself is not available in
                               this build, so this is our own partitioner with
                               the same interface: contiguous, balanced parts)
  * logical_partition        — user-supplied logical coarsening over the
                               element_element graph (LogicalPartitioner
                               .hpp:41-139)
"""

import numpy as np
import scipy.sparse as sp


def refined_mesh_partition(n_elements, n_parts) -> np.ndarray:
    """partition[e] = e // (n_elements/n_parts). Children of a parent are
    contiguous after Mesh.uniform_refinement, exactly the MFEM>=4.1 numbering
    the reference relies on (MFEMRefinedMeshPartitioner.cpp:62-68)."""
    assert n_elements % n_parts == 0
    factor = n_elements // n_parts
    return np.repeat(np.arange(n_parts, dtype=np.int64), factor)


def cartesian_partition(ijk_shape, coarsening) -> np.ndarray:
    """Partition a Cartesian (nx,ny,nz) element grid by coarsening factors
    (cx,cy,cz). Element order: x fastest (hex_grid_mesh order)."""
    nx, ny, nz = ijk_shape
    cx, cy, cz = coarsening
    mx, my = -(-nx // cx), -(-ny // cy)
    e = np.arange(nx * ny * nz, dtype=np.int64)
    ix = e % nx
    iy = (e // nx) % ny
    iz = e // (nx * ny)
    return (ix // cx) + (iy // cy) * mx + (iz // cz) * (mx * my)


def geometric_box_partition(mesh, n_parts) -> np.ndarray:
    """Partition by a grid of geometric boxes over element centroids
    (GeometricBoxPartitioner.cpp:20-82): per-direction box count =
    round(extent / (volume/n_parts)^(1/dim)); element assigned by centroid."""
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    dim = 3
    volume = np.prod(hi - lo)
    target_radius = (volume / n_parts) ** (1.0 / dim)
    ndir = np.maximum(
        ((hi - lo) / target_radius + 0.5).astype(np.int64), 1)
    radius = (hi - lo) / ndir
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    which = np.minimum(((cent - lo) / radius).astype(np.int64), ndir - 1)
    idx = which[:, 0] + ndir[0] * which[:, 1] + ndir[0] * ndir[1] * which[:, 2]
    # compress to used boxes (empty partitions are dropped later anyway)
    _, part = np.unique(idx, return_inverse=True)
    return part.astype(np.int64)


def logical_partition(elem_elem, logical_info) -> np.ndarray:
    """Group elements with identical logical info that are connected in the
    element graph (LogicalPartitioner semantics)."""
    from parelag_tpu_torch.ops.csr import connected_components
    info = np.asarray(logical_info)
    part, _ = connected_components(info, elem_elem)
    return part


def _heavy_edge_matching(A, w, rng):
    """One level of heavy-edge-matching graph coarsening: returns
    (coarse label per node, coarse adjacency with summed edge weights,
    coarse node weights)."""
    n = A.shape[0]
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    for u in order:
        if match[u] >= 0:
            continue
        lo, hi = A.indptr[u], A.indptr[u + 1]
        best, best_w = -1, -1.0
        for j in range(lo, hi):
            v = A.indices[j]
            if v != u and match[v] < 0 and A.data[j] > best_w:
                best, best_w = v, A.data[j]
        match[u] = u if best < 0 else best
        if best >= 0:
            match[best] = u
    # coarse labels
    label = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for u in range(n):
        if label[u] < 0:
            label[u] = nxt
            label[match[u]] = nxt
            nxt += 1
    coo = A.tocoo()
    keep = coo.row != coo.col
    Ac = sp.csr_matrix(
        (coo.data[keep], (label[coo.row[keep]], label[coo.col[keep]])),
        shape=(nxt, nxt))
    Ac.sum_duplicates()
    wc = np.zeros(nxt)
    np.add.at(wc, label, w)
    return label, Ac, wc


def multilevel_graph_partition(elem_elem, n_parts, weights=None, seed=0,
                               min_coarse=None) -> np.ndarray:
    """Multilevel k-way partition (the METIS recipe,
    MetisGraphPartitioner.cpp:37-): heavy-edge-matching V-cycle — coarsen
    until ~15 nodes per part, partition the coarsest graph with the greedy
    grower, then uncoarsen with boundary refinement at every level."""
    A = sp.csr_matrix(elem_elem).astype(float)
    n = A.shape[0]
    if n_parts <= 1:
        return np.zeros(n, dtype=np.int64)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=float)
    min_coarse = min_coarse or max(15 * n_parts, 32)
    rng = np.random.RandomState(seed)

    graphs, labels, nodew = [A], [], [w]
    while graphs[-1].shape[0] > min_coarse:
        label, Ac, wc = _heavy_edge_matching(graphs[-1], nodew[-1], rng)
        if Ac.shape[0] >= graphs[-1].shape[0]:   # matching stalled
            break
        labels.append(label)
        graphs.append(Ac)
        nodew.append(wc)

    part = graph_partition(graphs[-1], n_parts, weights=nodew[-1],
                           seed=seed, n_refine_sweeps=6)
    for lvl in range(len(labels) - 1, -1, -1):
        part = part[labels[lvl]]
        part = _balance_partition(graphs[lvl], part, nodew[lvl], n_parts)
        part = _refine_partition(graphs[lvl], part, nodew[lvl], n_parts,
                                 sweeps=3)
    part = _balance_partition(graphs[0], part, nodew[0], n_parts)
    return part


def _balance_partition(A, part, w, n_parts, tol=1.15, max_rounds=60):
    """Move boundary nodes out of overweight parts into their lightest
    adjacent part until every part is within tol of the mean."""
    A = sp.csr_matrix(A)
    size = np.zeros(n_parts)
    np.add.at(size, part, w)
    target = w.sum() / n_parts
    for _ in range(max_rounds):
        heavy = np.where(size > tol * target)[0]
        if heavy.size == 0:
            break
        moved = 0
        for u in np.argsort(-w):            # try big nodes first
            pu = part[u]
            if size[pu] <= tol * target:
                continue
            nbrs = A.indices[A.indptr[u]:A.indptr[u + 1]]
            cand = np.unique(part[nbrs[nbrs != u]])
            cand = cand[cand != pu]
            cand = cand[size[cand] + w[u] <= tol * target]
            if cand.size == 0:
                continue
            best = cand[np.argmin(size[cand])]
            part[u] = best
            size[pu] -= w[u]
            size[best] += w[u]
            moved += 1
        if moved == 0:
            break
    return part


def _refine_partition(A, part, w, n_parts, sweeps=3):
    """Boundary KL/FM-style sweeps (shared by the greedy and multilevel
    partitioners)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    size = np.zeros(n_parts)
    np.add.at(size, part, w)
    target = w.sum() / n_parts
    for _ in range(sweeps):
        moved = 0
        for u in range(n):
            pu = part[u]
            nbrs = A.indices[A.indptr[u]:A.indptr[u + 1]]
            nbr_parts, counts = np.unique(part[nbrs[nbrs != u]],
                                          return_counts=True)
            if nbr_parts.size <= 1:
                continue
            best = nbr_parts[np.argmax(counts)]
            gain = counts.max() - counts[nbr_parts == pu].sum()
            if (best != pu and gain > 0 and
                    size[pu] - w[u] >= 0.5 * target and
                    size[best] + w[u] <= 1.5 * target):
                part[u] = best
                size[pu] -= w[u]
                size[best] += w[u]
                moved += 1
        if moved == 0:
            break
    return part


def graph_partition(elem_elem, n_parts, weights=None, seed=0,
                    n_refine_sweeps=4) -> np.ndarray:
    """Balanced contiguous k-way partition of an element adjacency graph.

    Greedy multi-seed graph growing (BFS from spread seeds, always extending
    the currently-smallest part) followed by boundary Kernighan-Lin-style
    refinement sweeps that move boundary elements to reduce edge cut subject
    to balance. Deterministic for a fixed seed. Serves the role of
    METIS_PartGraphKway with CONTIG+MINCONN (MetisGraphPartitioner.cpp:37-);
    for large graphs prefer multilevel_graph_partition (the full METIS
    recipe with heavy-edge-matching coarsening).
    """
    A = sp.csr_matrix(elem_elem)
    n = A.shape[0]
    if n_parts <= 1:
        return np.zeros(n, dtype=np.int64)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=float)
    target = w.sum() / n_parts

    if n > 20000:
        # large-graph fast path: the greedy grower's farthest-point seeding
        # is O(n_parts * n) in Python; the vectorized multi-source grower
        # is O(E) per sweep (the SPE10-scale regime: ~64 elements/part)
        return _fast_partition(A, n_parts, w, seed)

    rng = np.random.RandomState(seed)
    # spread seeds by repeated farthest-point BFS
    seeds = [int(rng.randint(n))]
    dist = _bfs_dist(A, seeds[0])
    for _ in range(n_parts - 1):
        far = int(np.argmax(np.where(np.isfinite(dist), dist, -1)))
        seeds.append(far)
        dist = np.minimum(dist, _bfs_dist(A, far))

    part = np.full(n, -1, dtype=np.int64)
    size = np.zeros(n_parts)
    frontiers = []
    for p, s in enumerate(seeds):
        part[s] = p
        size[p] = w[s]
        frontiers.append([s])

    assigned = n_parts
    while assigned < n:
        p = int(np.argmin(np.where(
            [len(fr) > 0 for fr in frontiers], size, np.inf)))
        if not np.isfinite(size[p]) or not frontiers[p]:
            # all frontiers empty but unassigned remain (disconnected):
            # seed a new BFS in the smallest part from any unassigned elem
            un = int(np.nonzero(part < 0)[0][0])
            p = int(np.argmin(size))
            part[un] = p
            size[p] += w[un]
            frontiers[p] = [un]
            assigned += 1
            continue
        new_frontier = []
        for u in frontiers[p]:
            for v in A.indices[A.indptr[u]:A.indptr[u + 1]]:
                if part[v] < 0:
                    part[v] = p
                    size[p] += w[v]
                    new_frontier.append(v)
                    assigned += 1
        frontiers[p] = new_frontier

    # boundary refinement: move elements to the neighbor part that reduces
    # cut, if balance stays within 10% of target
    for _ in range(n_refine_sweeps):
        moved = 0
        for u in range(n):
            pu = part[u]
            nbrs = A.indices[A.indptr[u]:A.indptr[u + 1]]
            nbr_parts, counts = np.unique(part[nbrs[nbrs != u]],
                                          return_counts=True)
            if nbr_parts.size <= 1:
                continue
            best = nbr_parts[np.argmax(counts)]
            gain = counts.max() - counts[nbr_parts == pu].sum()
            if (best != pu and gain > 0 and
                    size[pu] - w[u] >= 0.5 * target and
                    size[best] + w[u] <= 1.5 * target):
                part[u] = best
                size[pu] -= w[u]
                size[best] += w[u]
                moved += 1
        if moved == 0:
            break
    return part


def _fast_partition(A, n_parts, w, seed, balance_rounds=30,
                    refine_rounds=4):
    """Vectorized contiguous k-way partition for large graphs: BFS-order
    strided seeding, multi-source level-synchronous label growth (ties go
    to the currently-smaller part), then batched balance/refine rounds —
    every step O(E) numpy, no per-node Python."""
    from parelag_tpu_torch.ops.ragged import ranges_cat
    n = A.shape[0]
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)

    def frontier_neighbors(frontier):
        cat, _ = ranges_cat(indptr[frontier], indptr[frontier + 1])
        nb = indices[cat]
        src = np.repeat(frontier, np.diff(
            np.stack([indptr[frontier], indptr[frontier + 1]]).T,
            axis=1).ravel())
        return nb, src

    # seeds: stride the BFS visit order (spatially spread on mesh graphs)
    rng = np.random.RandomState(seed)
    start = int(rng.randint(n))
    order = np.full(n, -1, dtype=np.int64)
    order[start] = 0
    frontier = np.array([start], dtype=np.int64)
    visited = 1
    chunks = [frontier]
    while frontier.size:
        nb, _ = frontier_neighbors(frontier)
        nb = np.unique(nb)
        nb = nb[order[nb] < 0]
        order[nb] = 1
        chunks.append(nb)
        frontier = nb
        visited += nb.size
    bfs_order = np.concatenate(chunks)
    if bfs_order.size < n:                  # disconnected leftovers
        rest = np.setdiff1d(np.arange(n), bfs_order)
        bfs_order = np.concatenate([bfs_order, rest])
    seeds = bfs_order[np.linspace(0, n - 1, n_parts).astype(np.int64)]
    seeds = np.unique(seeds)
    while seeds.size < n_parts:             # collisions: top up randomly
        extra = rng.randint(n, size=n_parts - seeds.size)
        seeds = np.unique(np.concatenate([seeds, extra]))
    seeds = seeds[:n_parts]

    part = np.full(n, -1, dtype=np.int64)
    part[seeds] = np.arange(n_parts)
    size = np.zeros(n_parts)
    np.add.at(size, part[seeds], w[seeds])
    frontier = seeds
    while True:
        if frontier.size == 0:
            un = np.nonzero(part < 0)[0]
            if un.size == 0:
                break
            p = int(np.argmin(size))
            part[un[0]] = p
            size[p] += w[un[0]]
            frontier = un[:1]
            continue
        nb, src = frontier_neighbors(frontier)
        lab = part[src]
        m = part[nb] < 0
        nb, lab = nb[m], lab[m]
        if nb.size == 0:
            frontier = np.zeros(0, dtype=np.int64)
            continue
        # ties between parts claiming the same node: smaller part wins
        srank = np.argsort(np.argsort(size))
        o = np.lexsort((srank[lab], nb))
        nb, lab = nb[o], lab[o]
        first = np.ones(nb.size, dtype=bool)
        first[1:] = nb[1:] != nb[:-1]
        nb, lab = nb[first], lab[first]
        part[nb] = lab
        np.add.at(size, lab, w[nb])
        frontier = nb

    target = w.sum() / n_parts
    for phase, rounds in (("balance", balance_rounds),
                          ("refine", refine_rounds)):
        for _ in range(rounds):
            # per-node dominant neighbor part + own-part neighbor count
            coo = A.tocoo()
            m = coo.row != coo.col
            r, c = coo.row[m], coo.col[m]
            key = r.astype(np.int64) * n_parts + part[c]
            uk, cnt = np.unique(key, return_counts=True)
            ur, up = uk // n_parts, uk % n_parts
            # best foreign part per node (max count)
            own = part[ur] == up
            own_cnt = np.zeros(n, dtype=np.int64)
            own_cnt[ur[own]] = cnt[own]
            fr, fp, fc = ur[~own], up[~own], cnt[~own]
            if fr.size == 0:
                break
            o = np.lexsort((-fc, fr))
            fr, fp, fc = fr[o], fp[o], fc[o]
            first = np.ones(fr.size, dtype=bool)
            first[1:] = fr[1:] != fr[:-1]
            cand_u, cand_p, cand_c = fr[first], fp[first], fc[first]
            gain = cand_c - own_cnt[cand_u]
            if phase == "balance":
                movers = ((size[part[cand_u]] > 1.1 * target)
                          & (size[cand_p] < size[part[cand_u]])
                          & (gain >= 0))
            else:
                movers = ((gain > 0)
                          & (size[part[cand_u]] - w[cand_u]
                             >= 0.6 * target)
                          & (size[cand_p] + w[cand_u] <= 1.4 * target))
            if not movers.any():
                break
            # cap: move at most a third of each part's movers per round
            # (batched moves approximate the sequential KL sweep)
            mu = cand_u[movers]
            mp = cand_p[movers]
            sel = rng.rand(mu.size) < 0.5
            if not sel.any():
                sel[:] = True
            mu, mp = mu[sel], mp[sel]
            np.add.at(size, part[mu], -w[mu])
            np.add.at(size, mp, w[mu])
            part[mu] = mp
    return part


def _bfs_dist(A, src):
    n = A.shape[0]
    dist = np.full(n, np.inf)
    dist[src] = 0
    frontier = [src]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in A.indices[A.indptr[u]:A.indptr[u + 1]]:
                if dist[v] == np.inf:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def metis_material_partition(elem_elem, material_id, n_parts,
                             weights=None, seed=0) -> np.ndarray:
    """Material-id-aware METIS coarsening (reference
    CoarsenMetisMaterialId.hpp:39, the LogicalPartitioner coarsening op
    that partitions WITHIN material regions using METIS): every connected
    material region is partitioned independently by the multilevel
    partitioner with a quota proportional to its size, so no agglomerate
    ever crosses a material interface. Returns a global partition vector
    with contiguous ids grouped by (material region, local part)."""
    from parelag_tpu_torch.ops.csr import connected_components
    A = sp.csr_matrix(elem_elem)
    n = A.shape[0]
    mat = np.asarray(material_id)
    w = np.ones(n) if weights is None else np.asarray(weights, float)
    # split into connected material regions (identical logical info)
    region, n_reg = connected_components(
        np.unique(mat, return_inverse=True)[1], A)
    out = np.empty(n, dtype=np.int64)
    total = w.sum()
    nxt = 0
    for r in range(n_reg):
        sel = np.where(region == r)[0]
        quota = max(1, round(n_parts * float(w[sel].sum()) / total))
        if quota == 1 or sel.size == 1:
            out[sel] = nxt
            nxt += 1
            continue
        sub = A[sel][:, sel]
        p = multilevel_graph_partition(sub, quota, weights=w[sel],
                                       seed=seed)
        out[sel] = nxt + p
        nxt += int(p.max()) + 1
    return out
