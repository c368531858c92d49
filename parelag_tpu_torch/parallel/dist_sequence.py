"""Distributed de Rham coarsening, stage 1: coarse traces by owner rank.

The reference's setup distributes every coarsening stage over MPI ranks;
shared coarse entities are computed once by their owner from gathered
neighbor data and the resulting coarse basis columns are broadcast back
(SharedEntityCommunication used inside ComputeCoarseTraces,
DeRhamSequence.cpp:1723-2000). This module runs that protocol for the
codim-1 trace stage (the stage that carries ALL inter-rank coupling — the
coarse facet spaces): each rank computes the PV + deflated-target weighted
SVD for the coarse facets it owns, using only data a rank would hold
locally (trace-mass blocks and target values of its halo facets), then
"sends" the resulting local P blocks to the other adjacent rank.

Validation contract (test_dist_sequence): digit-identical per-facet trace
blocks, counts and coarse mass blocks vs the serial
DeRhamSequence._compute_coarse_traces.
"""

from dataclasses import dataclass

import numpy as np

from parelag_tpu_torch.ops.batched import batched_weighted_svd


@dataclass
class FacetTraceResult:
    facet: int                  # coarse facet id
    owner: int
    dofs: np.ndarray            # fine dofs of the facet (closure order)
    p_block: np.ndarray         # (n_dofs, 1 + nkeep): [pv | kept traces]
    cmass: np.ndarray           # coarse facet mass block
    n_sent_to: tuple            # ranks that received the block


def distributed_facet_traces(seq, jform, fc_AF, rank_of_elem, R,
                             svd_tol=None, codim=1):
    """Owner-computes trace stage for `jform` at `codim` (facets for RT,
    ridges for ND, ...).

    seq: fine DeRhamSequenceFE with targets set and agglomerate_dofs done.
    fc_AF: fine-entity x coarse-entity table at that codim; rank_of_elem:
    rank per fine element (coarse-entity owner = min adjacent rank;
    receivers = the other adjacent ranks). Returns
    (list of FacetTraceResult, stats dict)."""
    import scipy.sparse as sp
    from parelag_tpu_torch.ops import csr as C

    # elements adjacent to each fine entity of this codim
    conn = C.pattern(seq.topo.B[0])
    for c in range(1, codim):
        conn = C.bool_mult(conn, C.pattern(seq.topo.B[c]))
    ent_elem = sp.csr_matrix(conn).T.tocsr()
    rank_of_elem = np.asarray(rank_of_elem)

    def adjacent_ranks(members):
        elems = np.unique(np.concatenate(
            [ent_elem.indices[ent_elem.indptr[f]:ent_elem.indptr[f + 1]]
             for f in members]))
        return np.unique(rank_of_elem[elems])

    svd_tol = seq.svd_tol if svd_tol is None else svd_tol
    pv = seq.compute_pv_traces(codim)
    targets = seq.targets[jform]
    n_targets = targets.shape[1] if targets is not None else 0
    Mlocal = seq.M[(codim, jform)]

    csc = sp.csc_matrix(fc_AF)
    n_af = csc.shape[1]

    # per coarse facet: members + owner (min adjacent rank)
    Ms, Ts, metas = [], [], []
    for j in range(n_af):
        members = csc.indices[csc.indptr[j]:csc.indptr[j + 1]]
        if members.size == 0:
            continue
        adj = adjacent_ranks(members)
        owner = int(adj.min())
        # RANK-LOCAL assembly: the owner holds the member facets' local
        # trace-mass blocks and the dof values of pv/targets on them
        dofs = np.unique(np.concatenate(
            [np.asarray(Mlocal.dofs[f]) for f in members]))
        pos = {int(d): i for i, d in enumerate(dofs)}
        Mloc = np.zeros((dofs.size, dofs.size))
        for f in members:
            idx = np.array([pos[int(d)] for d in Mlocal.dofs[f]])
            Mloc[np.ix_(idx, idx)] += np.asarray(Mlocal.blocks[f])
        loc_pv = pv[dofs]
        T = targets[dofs, :].copy() if n_targets else np.zeros(
            (dofs.size, 0))
        pv_m = Mloc @ loc_pv
        pv_dot_pv = float(loc_pv @ pv_m)
        if T.shape[1]:
            T -= np.outer(loc_pv, (pv_m @ T) / pv_dot_pv)
        Ms.append(Mloc)
        Ts.append(T)
        metas.append((j, owner, dofs, loc_pv, pv_dot_pv,
                      tuple(int(r) for r in adj if r != owner)))

    svds = batched_weighted_svd(Ms, Ts)
    return _finish_traces(metas, Ms, svds, svd_tol)


def _finish_traces(metas, Ms, svds, svd_tol):
    results = []
    n_msgs = 0
    bytes_moved = 0
    for (j, owner, dofs, loc_pv, pv_dot_pv, receivers), Mloc, (U, s) in zip(
            metas, Ms, svds):
        s_tol = pv_dot_pv * svd_tol
        nkeep = int(np.searchsorted(-s, -s_tol))
        p_block = np.concatenate(
            [loc_pv[:, None], np.sqrt(pv_dot_pv) * U[:, :nkeep]], axis=1)
        cmass = p_block.T @ Mloc @ p_block
        cmass = 0.5 * (cmass + cmass.T)
        results.append(FacetTraceResult(
            facet=j, owner=owner, dofs=dofs, p_block=p_block,
            cmass=cmass, n_sent_to=receivers))
        # broadcast direction of SharedEntityCommunication: the block goes
        # to every other rank adjacent to the coarse facet
        n_msgs += len(receivers)
        bytes_moved += p_block.size * 8 * len(receivers)
    return results, dict(n_msgs=n_msgs, bytes_moved=bytes_moved,
                         n_af=len(results))


@dataclass
class AEExtensionResult:
    ae: int
    owner: int
    u_int: np.ndarray           # fine interior Hdiv dofs of the AE
    cbdr_facets: tuple          # coarse facets on the AE boundary
    ext: np.ndarray             # (n_int, n_cbdr) extension columns
    rt: np.ndarray              # (n_int, n_rt) RangeT bubbles
    nulls: np.ndarray           # (n_int, n_null) target-extension columns
    dvals: np.ndarray           # coarse-D row entries of the AE's L2 PV
                                # against [cbdr dofs | rt dofs]


def distributed_rt_extension(seq, trace_results, rank_of_elem,
                             svd_tol=None):
    """Stage 2 for the Hdiv form, distributed per agglomerate owner: the
    hFacetExtension saddle [M B^T 0; B 0 T^T; 0 T 0] of each agglomerate
    runs on the rank owning its elements; the boundary data is exactly the
    trace blocks broadcast in stage 1 (reference hFacetExtension,
    DeRhamSequence.cpp:2293-2530, distributed through
    SharedEntityCommunication).

    Every input is rank-local: the AE's assembled mass/derivative blocks,
    its L2 PV (constant), the trace blocks of its boundary coarse facets
    (owned or received), and the targets on its dofs."""
    import scipy.sparse as sp
    from parelag_tpu_torch.amge.localmass import assemble_agglomerate_blocks
    from parelag_tpu_torch.ops import csr as C
    from parelag_tpu_torch.ops.batched import batched_solve

    jform = seq.nforms - 2          # Hdiv
    svd_tol = seq.svd_tol if svd_tol is None else svd_tol
    rank_of_elem = np.asarray(rank_of_elem)
    topo = seq.topo
    uagg, pagg = seq.dofagg[jform], seq.dofagg[jform + 1]
    AE_e = topo.AEntity_entity[0]
    Md = assemble_agglomerate_blocks(seq.M[(0, jform)], AE_e, uagg, 0)
    Wd = assemble_agglomerate_blocks(seq.M[(0, jform + 1)], AE_e, pagg, 0)
    D = seq.D[jform].tocsr()

    # coarse facets on each AE boundary
    AE_AF = C.pattern(topo.coarser.B[0]).tocsr()
    by_facet = {r.facet: r for r in trace_results}

    n_ae = len(Md)
    recs = []
    for iae in range(n_ae):
        elems = AE_e.tocsr().indices[
            AE_e.tocsr().indptr[iae]:AE_e.tocsr().indptr[iae + 1]]
        owner = int(rank_of_elem[elems].min())
        u_all = uagg.ae_dofs(0)[iae]
        nu_int = int(uagg.n_interior(0)[iae])
        u_int, u_bdr = u_all[:nu_int], u_all[nu_int:]
        p_all = pagg.ae_dofs(0)[iae]
        Mloc, Wloc = Md[iae], Wd[iae]
        Dloc = C.extract_submatrix(D, p_all, u_all)
        Bloc = Wloc @ Dloc
        M_ii = Mloc[:nu_int, :nu_int]
        B_ii = Bloc[:, :nu_int]
        B_ib = Bloc[:, nu_int:]
        np_int = p_all.size
        # L2 PV on the AE = the constant function's interpolant = ones
        ploc_pv = np.ones(np_int)
        Tvec = Wloc @ ploc_pv
        nsys = nu_int + np_int + 1
        A = np.zeros((nsys, nsys))
        A[:nu_int, :nu_int] = M_ii
        A[nu_int:nu_int + np_int, :nu_int] = B_ii
        A[:nu_int, nu_int:nu_int + np_int] = B_ii.T
        A[-1, nu_int:nu_int + np_int] = Tvec
        A[nu_int:nu_int + np_int, -1] = Tvec

        # boundary data: stage-1 trace blocks of the AE's coarse facets
        facets = AE_AF.indices[AE_AF.indptr[iae]:AE_AF.indptr[iae + 1]]
        pos = {int(d): i for i, d in enumerate(u_bdr)}
        blocks = []
        for f in facets:
            r = by_facet[int(f)]
            rows = np.array([pos[int(d)] for d in r.dofs])
            blk = np.zeros((u_bdr.size, r.p_block.shape[1]))
            blk[rows] = r.p_block
            blocks.append(blk)
        Pb = np.concatenate(blocks, axis=1) if blocks else np.zeros(
            (u_bdr.size, 0))
        k_ext = Pb.shape[1]
        rhs_ext = np.zeros((nsys, k_ext))
        rhs_ext[:nu_int] = -Mloc[:nu_int, nu_int:] @ Pb
        rhs_ext[nu_int:nu_int + np_int] = -B_ib @ Pb
        # null-target extensions (rank-local target values on the AE)
        targets = seq.targets[jform]
        n_tars = targets.shape[1] if targets is not None else 0
        if n_tars and nu_int > 0:
            t_int = targets[u_int, :]
            t_bdr = targets[u_bdr, :]
            rhs_null = np.zeros((nsys, n_tars))
            rhs_null[:nu_int] = -Mloc[:nu_int, nu_int:] @ t_bdr
            rhs_null[nu_int:nu_int + np_int] = B_ii @ t_int
        else:
            t_int = np.zeros((nu_int, 0))
            rhs_null = np.zeros((nsys, 0))
        recs.append(dict(iae=iae, owner=owner, u_int=u_int,
                         facets=tuple(int(f) for f in facets),
                         A=A, rhs=np.concatenate([rhs_ext, rhs_null],
                                                 axis=1),
                         t_int=t_int,
                         nu_int=nu_int, np_int=np_int, k_ext=k_ext))

    sols = batched_solve([r["A"] for r in recs], [r["rhs"] for r in recs])
    out = []
    for r, sol in zip(recs, sols):
        nu_int, k_ext = r["nu_int"], r["k_ext"]
        sol_ext = sol[:, :k_ext]
        sol_null = sol[:, k_ext:]
        lam = sol_ext[-1, :]
        dvals = np.where(np.abs(lam) > 1e-12, -lam, 0.0)
        null_basis = np.zeros((nu_int, 0))
        if sol_null.shape[1]:
            bub = r["t_int"] - sol_null[:nu_int]
            U, sv, _ = np.linalg.svd(bub, full_matrices=False)
            n_null = int(np.searchsorted(-sv, -svd_tol))
            null_basis = U[:, :n_null]
        out.append(AEExtensionResult(
            ae=r["iae"], owner=r["owner"], u_int=r["u_int"],
            cbdr_facets=r["facets"], ext=sol_ext[:nu_int],
            rt=np.zeros((nu_int, 0)), nulls=null_basis, dvals=dvals))
    return out


def assemble_distributed_P(seq, trace_results, ext_results):
    """Assemble the global coarse Hdiv interpolation from the distributed
    stage outputs, with OWNER-PREFIX coarse dof numbering (facets in owner
    order, then per-AE null dofs): returns (P csr, facet_col_ranges,
    ae_null_ranges). Together with the per-stage equality tests this closes
    the loop: the distributed protocol reproduces the serial coarse space
    exactly (up to the owner-order dof permutation)."""
    import scipy.sparse as sp

    # facet trace dofs numbered by (owner, facet id)
    order = sorted(trace_results, key=lambda r: (r.owner, r.facet))
    col_of_facet = {}
    nxt = 0
    rows, cols, vals = [], [], []
    for r in order:
        k = r.p_block.shape[1]
        col_of_facet[r.facet] = (nxt, k)
        for c in range(k):
            rows.extend(r.dofs)
            cols.extend([nxt + c] * r.dofs.size)
            vals.extend(r.p_block[:, c])
        nxt += k
    ae_null = {}
    for e in sorted(ext_results, key=lambda r: (r.owner, r.ae)):
        # extension columns accumulate into the facet columns
        ofs = 0
        for f in e.cbdr_facets:
            base, k = col_of_facet[f]
            for c in range(k):
                rows.extend(e.u_int)
                cols.extend([base + c] * e.u_int.size)
                vals.extend(e.ext[:, ofs + c])
            ofs += k
        if e.nulls.shape[1]:
            ae_null[e.ae] = (nxt, e.nulls.shape[1])
            for c in range(e.nulls.shape[1]):
                rows.extend(e.u_int)
                cols.extend([nxt + c] * e.u_int.size)
                vals.extend(e.nulls[:, c])
            nxt += e.nulls.shape[1]
    P = sp.csr_matrix((vals, (rows, cols)),
                      shape=(seq.dof[seq.nforms - 2].ndofs, nxt))
    return P, col_of_facet, ae_null


def distributed_nd_facet_extension(seq, ridge_traces, facet_traces,
                                   rank_of_elem, svd_tol=None):
    """The Hcurl facet Lagrange stage, distributed per coarse-facet owner:
    extend the ridge trace dofs into facet interiors through the saddle
    [M B^T 0; B 0 T^T; 0 T 0] with the facet's Hdiv PV as multiplier
    (serial: sequence._extension(jform=1, codim=1, use_lagrange=True)).
    Inputs per facet are rank-local + the broadcast stage-1 blocks: ridge
    traces (boundary data) and the facet's own Hdiv trace block (PV and
    null columns feed T and the RangeT right-hand sides)."""
    import scipy.sparse as sp
    from parelag_tpu_torch.ops import csr as C
    from parelag_tpu_torch.ops.batched import batched_solve, batched_plain_svd

    jform = seq.nforms - 3          # Hcurl in 3D
    codim = 1
    svd_tol = seq.svd_tol if svd_tol is None else svd_tol
    uagg = seq.dofagg[jform]
    pagg = seq.dofagg[jform + 1]
    topo = seq.topo
    AF_e = topo.AEntity_entity[codim]
    Md = None
    from parelag_tpu_torch.amge.localmass import assemble_agglomerate_blocks
    Md = assemble_agglomerate_blocks(seq.M[(codim, jform)], AF_e, uagg,
                                     codim)
    Wd = assemble_agglomerate_blocks(seq.M[(codim, jform + 1)], AF_e, pagg,
                                     codim)
    D = seq.D[jform].tocsr()
    targets = seq.targets[jform]
    n_tars = targets.shape[1] if targets is not None else 0

    # boundary coarse dofs of each facet = ridge-trace blocks on its ridges
    AF_AR = C.pattern(topo.coarser.B[codim]).tocsr()
    ridge_by_id = {r.facet: r for r in ridge_traces}
    facet_by_id = {r.facet: r for r in facet_traces}
    rank_of_elem = np.asarray(rank_of_elem)
    elem_of = sp.csr_matrix(C.pattern(topo.B[0])).T.tocsr()

    n_af = len(Md)
    recs = []
    for iaf in range(n_af):
        u_all = uagg.ae_dofs(codim)[iaf]
        nu_int = int(uagg.n_interior(codim)[iaf])
        u_int, u_bdr = u_all[:nu_int], u_all[nu_int:]
        p_all = pagg.ae_dofs(codim)[iaf]
        np_int = int(pagg.n_interior(codim)[iaf])
        p_int = p_all[:np_int]
        Mloc, Wloc = Md[iaf], Wd[iaf]
        Dloc = C.extract_submatrix(D, p_all, u_all)
        Bloc = Wloc @ Dloc
        M_ii = Mloc[:nu_int, :nu_int]
        M_ib = Mloc[:nu_int, nu_int:]
        B_ii = Bloc[:np_int, :nu_int]
        B_ib = Bloc[:np_int, nu_int:]
        W_ii = Wloc[:np_int, :np_int]

        ftr = facet_by_id[iaf]
        fpos = {int(d): i for i, d in enumerate(ftr.dofs)}
        fidx = np.array([fpos[int(d)] for d in p_int])
        ploc_pv = ftr.p_block[fidx, 0]
        cP = ftr.p_block[fidx, 1:]             # facet Hdiv null columns
        Tvec = W_ii @ ploc_pv
        nsys = nu_int + np_int + 1
        A = np.zeros((nsys, nsys))
        A[:nu_int, :nu_int] = M_ii
        A[nu_int:nu_int + np_int, :nu_int] = B_ii
        A[:nu_int, nu_int:nu_int + np_int] = B_ii.T
        A[-1, nu_int:nu_int + np_int] = Tvec
        A[nu_int:nu_int + np_int, -1] = Tvec

        # boundary data: ridge-trace blocks of the facet's ridges
        ridges = AF_AR.indices[AF_AR.indptr[iaf]:AF_AR.indptr[iaf + 1]]
        bpos = {int(d): i for i, d in enumerate(u_bdr)}
        blocks = []
        for rg in ridges:
            rtr = ridge_by_id[int(rg)]
            rows = np.array([bpos[int(d)] for d in rtr.dofs])
            blk = np.zeros((u_bdr.size, rtr.p_block.shape[1]))
            blk[rows] = rtr.p_block
            blocks.append(blk)
        Pb = np.concatenate(blocks, axis=1) if blocks else np.zeros(
            (u_bdr.size, 0))
        k_ext = Pb.shape[1]
        rhs_ext = np.zeros((nsys, k_ext))
        rhs_ext[:nu_int] = -M_ib @ Pb
        rhs_ext[nu_int:nu_int + np_int] = -B_ib @ Pb
        n_rt = cP.shape[1] if nu_int > 0 else 0
        rhs_rt = np.zeros((nsys, n_rt))
        if n_rt:
            rhs_rt[nu_int:nu_int + np_int] = W_ii @ cP[:, :n_rt]
        if n_tars and nu_int > n_rt:
            t_int = targets[u_int, :]
            t_bdr = targets[u_bdr, :]
            rhs_null = np.zeros((nsys, n_tars))
            rhs_null[:nu_int] = -M_ib @ t_bdr
            rhs_null[nu_int:nu_int + np_int] = B_ii @ t_int
        else:
            t_int = np.zeros((nu_int, 0))
            rhs_null = np.zeros((nsys, 0))
        elems = np.unique(np.concatenate(
            [elem_of.indices[elem_of.indptr[f]:elem_of.indptr[f + 1]]
             for f in AF_e.tocsr().indices[
                 AF_e.tocsr().indptr[iaf]:AF_e.tocsr().indptr[iaf + 1]]]))
        recs.append(dict(
            iaf=iaf, owner=int(rank_of_elem[elems].min()),
            u_int=u_int, nu_int=nu_int, k_ext=k_ext, k_rt=n_rt,
            t_int=t_int, A=A,
            rhs=np.concatenate([rhs_ext, rhs_rt, rhs_null], axis=1)))

    sols = batched_solve([r["A"] for r in recs], [r["rhs"] for r in recs])
    bubs = []
    for r, sol in zip(recs, sols):
        k0 = r["k_ext"] + r["k_rt"]
        bubs.append(r["t_int"] - sol[:r["nu_int"], k0:]
                    if sol.shape[1] > k0 else np.zeros((r["nu_int"], 0)))
    svds = batched_plain_svd(bubs)
    out = []
    for r, sol, (U, sv) in zip(recs, sols, svds):
        nu_int = r["nu_int"]
        lam = sol[-1, :r["k_ext"]]
        n_null = int(np.searchsorted(-sv, -svd_tol))
        out.append(AEExtensionResult(
            ae=r["iaf"], owner=r["owner"], u_int=r["u_int"],
            cbdr_facets=(), ext=sol[:nu_int, :r["k_ext"]],
            rt=sol[:nu_int, r["k_ext"]:r["k_ext"] + r["k_rt"]],
            nulls=U[:, :n_null],
            dvals=np.where(np.abs(lam) > 1e-12, -lam, 0.0)))
    return out
