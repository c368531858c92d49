"""Device-resident spectral Hdiv-L2 coarsening on cartesian grids
(PyTorch).

Counterpart of parelag_tpu/amge/structured_spectral.py, the SPE10 north
star's setup (examples/MultigridTestSPE10.cpp:169-187): ONE cartesian
coarsening step of the Darcy pair (jform_start=2) with per-axis factors
(fx, fy, fz) and a per-cell coefficient, in three families of batched
dense programs over all entities of a family --

  * per-AE spectral Hdiv-L2 eigenproblems
    (ComputeLocalHdivL2SpectralTargetsFromAEntity,
    LocalSpectralTargets.cpp:46-90);
  * coarse facet and cell traces with targets
    (ComputeCoarseTracesWithTargets, DeRhamSequence.cpp:1723-2086);
  * Hdiv interior Lagrange extensions with RangeT bubbles and null
    target extensions (hFacetExtension, DeRhamSequence.cpp:2169-2628).

Variable kept-mode counts ride fixed slot capacities plus masks: a
masked slot is a zero target column and a zero P column (dropped at the
host materialization).

Differences from the JAX module:
  * the stages run on the device of the call (the card, or the CPU in
    the tests) through structured._run_stage with direct batched solves
    (torch.linalg.solve) and eigh/svd in the working dtype; the
    Newton-Schulz branch (_ns_spd_inverse, _ext_saddle_solve_ns,
    solve_mode), the TPU's answer to its batched-LU compile times, is
    not ported, so the stages take the JAX module's 'direct' branch;
  * the solve stages return the relative residual max ||A X - B|| / ||B||
    of their chunk (the spectral stage's M X = BC^T, the extension's
    saddle), which the convergence guard reads; the guards raise
    RuntimeError where the JAX module asserts;
  * the JAX zeros().at[].add() scatters are index_add_ (faces that two
    cells share repeat in the index);
  * the 3 x 3 bubble Gram's eigh runs in f64 (cuSOLVER's f32 eigh gives
    NaN on an exactly-zero batch, as structured._eigvalsh notes);
  * each stage also reports, per entity, how close its deciding
    eigenvalues or singular values sit to their keep thresholds
    (SpectralDarcyOut.near_threshold), and the seconds of each stage.

The host index plane, the f64 spot oracle and the host materialization
are copies of the JAX module's code.
"""

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from parelag_tpu_torch import resolve_device, synchronize
from parelag_tpu_torch.amge import structured as _st
from parelag_tpu_torch.ops.device_sparse import as_torch_dtype


# --------------------------------------------------------------------- #
# index plane: general-factor AE closure numbering (host, int arithmetic)
# --------------------------------------------------------------------- #

def _grid3(*ranges):
    return _st._grid3(*ranges)


def ae_cells(cshape, f):
    """(n_ae, fx*fy*fz) fine cell ids per AE, lex within the AE
    (x fastest) — the p-dof (L2) order of every stage."""
    fx, fy, fz = f
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    cols = []
    for dz in range(fz):
        for dy in range(fy):
            for dx in range(fx):
                cols.append(_st.cell_id(
                    fshape, f[0] * ijk[:, 0] + dx,
                    f[1] * ijk[:, 1] + dy, f[2] * ijk[:, 2] + dz))
    return np.stack(cols, axis=1)


def _ae_face_offsets(f):
    """Static (axis, ox, oy, oz) lattice offsets of one AE's closure
    faces in the canonical interior-first order:
      [interior: family a, a-coord 1..fa-1, (b,c)-lex]  then
      [boundary: facet-by-facet in [x0,x1,y0,y1,z0,z1] order, each
       facet's fb*fc children (b,c)-lex (b fastest)].
    Returns (offsets list, nu_int)."""
    fx, fy, fz = f
    offs = []
    for a, (na, nb_, nc_) in enumerate(((fx, fy, fz), (fy, fx, fz),
                                        (fz, fx, fy))):
        b, c = [ax for ax in range(3) if ax != a]
        for da in range(1, na):
            for dc in range(f[c]):
                for db in range(f[b]):
                    o = [0, 0, 0]
                    o[a], o[b], o[c] = da, db, dc
                    offs.append((a, o[0], o[1], o[2]))
    nu_int = len(offs)
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        for side in (0, 1):
            for dc in range(f[c]):
                for db in range(f[b]):
                    o = [0, 0, 0]
                    o[a], o[b], o[c] = side * f[a], db, dc
                    offs.append((a, o[0], o[1], o[2]))
    return offs, nu_int


def ae_faces(cshape, f):
    """(n_ae, nu) fine face ids of every AE's closure, interior-first
    (see _ae_face_offsets).  Returns (ids, nu_int)."""
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    offs, nu_int = _ae_face_offsets(f)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    base = ijk * np.asarray(f)[None, :]
    out = np.empty((len(ijk), len(offs)), dtype=np.int64)
    for s, (a, ox, oy, oz) in enumerate(offs):
        out[:, s] = _st.face_id(fshape, a, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
    return out, nu_int


def cell_face_slots(f):
    """(fx*fy*fz, 6) position of each child cell's local faces (M02
    order [x0,x1,y0,y1,z0,z1]) within the AE face-slot order."""
    offs, _ = _ae_face_offsets(f)
    pos = {off: s for s, off in enumerate(offs)}
    fx, fy, fz = f
    out = np.empty((fx * fy * fz, 6), dtype=np.int64)
    i = 0
    for dz in range(fz):
        for dy in range(fy):
            for dx in range(fx):
                out[i] = [pos[(0, dx, dy, dz)], pos[(0, dx + 1, dy, dz)],
                          pos[(1, dx, dy, dz)], pos[(1, dx, dy + 1, dz)],
                          pos[(2, dx, dy, dz)], pos[(2, dx, dy, dz + 1)]]
                i += 1
    return out


def facet_children(cshape, f):
    """Per family a: (n_facets_a, fb*fc) fine face ids of each coarse
    facet's children, (b,c)-lex — the same in-facet order as the AE
    boundary slots, so restricting an AE's boundary block to one of its
    facets is a contiguous slice.  Returns [ids_x, ids_y, ids_z]."""
    fshape = tuple(c * ff for c, ff in zip(cshape, f))
    nx, ny, nz = cshape
    fams = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = ijk * np.asarray(f)[None, :]
        base[:, a] = ijk[:, a] * f[a]
        out = np.empty((len(ijk), f[b] * f[c]), dtype=np.int64)
        s = 0
        for dc in range(f[c]):
            for db in range(f[b]):
                o = np.zeros((len(ijk), 3), dtype=np.int64)
                o[:, b], o[:, c] = db, dc
                out[:, s] = _st.face_id(
                    fshape, a, base[:, 0] + o[:, 0],
                    base[:, 1] + o[:, 1], base[:, 2] + o[:, 2])
                s += 1
        fams.append(out)
    return fams


def facet_neighbors(cshape):
    """Per family a: (n_facets_a, 2) [left AE, right AE] ids with -1
    for missing (domain boundary).  Left = AE on the -a side (sees the
    facet as its a1 boundary block), right = +a side (sees it as a0)."""
    nx, ny, nz = cshape
    fams = []
    for a in range(3):
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        left = ijk.copy()
        left[:, a] -= 1
        lvalid = left[:, a] >= 0
        rvalid = ijk[:, a] < (nx, ny, nz)[a]
        lid = np.where(lvalid, _st.cell_id(
            cshape, np.clip(left[:, 0], 0, None),
            np.clip(left[:, 1], 0, None),
            np.clip(left[:, 2], 0, None)), -1)
        rid = np.where(rvalid, _st.cell_id(
            cshape, np.minimum(ijk[:, 0], nx - 1),
            np.minimum(ijk[:, 1], ny - 1),
            np.minimum(ijk[:, 2], nz - 1)), -1)
        fams.append(np.stack([lid, rid], axis=1))
    return fams


def facet_bdr_slices(f):
    """Per family a: (slot0_left, slot0_right, nch) — where a facet's
    children sit inside the left/right neighbor AE's boundary block
    (offsets RELATIVE to the boundary start).  Left neighbor sees the
    facet as its (a, side=1) block, right neighbor as (a, side=0)."""
    out = []
    start = 0
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        nch = f[b] * f[c]
        s0, s1 = start, start + nch
        out.append((s1, s0, nch))        # (left sees a1, right sees a0)
        start += 2 * nch
    return out


def ae_facet_ids(cshape):
    """(n_ae, 6) coarse facet ids per AE in [x0,x1,y0,y1,z0,z1] order
    (the coarse d2 column pattern)."""
    return _st.d2_cols(cshape)


# --------------------------------------------------------------------- #
# stage programs (batched torch; one chunk of entities a call)
# --------------------------------------------------------------------- #

#: relative-residual guards of the solve stages (the JAX module's
#: _NS_GUARD_TOL and _EXT_GUARD_TOL, there on its Newton-Schulz
#: backward residuals; a direct f64 solve leaves ~1e-14)
_GUARD_TOL = 1e-4
_EXT_GUARD_TOL = 5e-4
#: an entity whose deciding eigenvalue or singular value lies within
#: this relative distance of its keep threshold is "near" it: another
#: eigensolver build may keep another count there
NEAR_REL = 1e-10


def _rel_residual(A, X, B):
    """max over the batch of ||A X - B||_F / ||B||_F (a 0-d tensor)."""
    R = torch.linalg.matrix_norm(A @ X - B)
    return (R / torch.clamp(torch.linalg.matrix_norm(B), min=1e-300)).max()


def _eigh(G):
    """Eigen-decomposition of a small symmetric batch in f64, returned in
    G's dtype (see the module notes)."""
    ev, Q = torch.linalg.eigh(G.double())
    return ev.to(G.dtype), Q.to(G.dtype)


def _margin(vals, thr, k):
    """(n,) least relative distance |vals[:, j] - thr| / thr over the
    deciding columns j < k (thr (n,))."""
    k = min(int(k), vals.shape[1])
    if k == 0:
        return thr.new_full(thr.shape, float("inf"))
    thr = torch.clamp(thr, min=1e-300)
    return ((vals[:, :k] - thr[:, None]).abs() / thr[:, None]).min(1).values


def _mask_cols(V, nkeep):
    """V (n, r, K) with the columns k >= nkeep zeroed."""
    K = V.shape[2]
    mask = (torch.arange(K, device=V.device)[None, :]
            < nkeep[:, None]).to(V.dtype)
    return V * mask[:, None, :]


def _spectral_stage(m02_ch, m03_ch, m12_bdr, d2_ch, fslot, nu_int,
                    spect_tol, max_evects):
    """Per-AE mixed Hdiv-L2 eigenproblem (one uniform batch):
      m02_ch (n, ncell, 6, 6) kinv-weighted cell Hdiv blocks,
      m03_ch (n, ncell) L2 masses (vols), m12_bdr (n, nbd) boundary
      facet trace masses, d2_ch (n, ncell, 6) fine div values,
      fslot (ncell, 6) static, nu_int static.
    Returns (V (n, npl+nbd, K) the lowest K generalized eigenvectors,
    columns >= nkeep zeroed; nkeep (n,) by the reference criterion
    |w| <= tol * max(|w_max|, 1) clipped to [1, K]; w (n, npl+nbd) the
    eigenvalues ascending; margin (n,) of the K deciding eigenvalues;
    the relative residual of M X = BC^T)."""
    n, ncell = m03_ch.shape
    nbd = m12_bdr.shape[1]
    nu = nu_int + nbd
    M = _st._assemble(m02_ch, fslot, nu)
    Dloc = _st._place(d2_ch, (ncell, nu), np.arange(ncell)[:, None], fslot)
    B = m03_ch[:, :, None] * Dloc                    # (n, ncell, nu)
    # C = [0 | diag(Q)] rows for the boundary trace block
    C = _st._place(m12_bdr, (nbd, nu), np.arange(nbd),
                   nu_int + np.arange(nbd))
    BC = torch.cat([B, C], dim=1)                    # (n, npl+nbd, nu)
    BCt = BC.transpose(1, 2)
    X = _st._solve_batch(M, BCt)                     # M^{-1} BC^T
    res = _rel_residual(M, X, BCt)
    S = BC @ X
    S = 0.5 * (S + S.transpose(1, 2))
    # RHS = blkdiag(W, Q); Cholesky-reduced generalized eigh on the
    # diagonal RHS is a symmetric similarity scale
    rd = torch.cat([m03_ch, m12_bdr], dim=1)         # (n, npl+nbd)
    isq = 1.0 / torch.sqrt(rd)
    St = S * isq[:, :, None] * isq[:, None, :]
    St = 0.5 * (St + St.transpose(1, 2))
    w, Vt = torch.linalg.eigh(St)                    # ascending
    V = isq[:, :, None] * Vt                         # L^{-T} Vt
    thr = spect_tol * torch.clamp(w[:, -1].abs(), min=1.0)
    K = int(max_evects)
    nkeep = torch.clamp((w.abs() <= thr[:, None]).sum(1), 1, K)
    Vk = V[:, :, :K]
    # reference sign convention: first component of the first kept
    # vector non-negative
    sgn = torch.where(Vk[:, 0, 0] < 0, -1.0, 1.0).to(Vk.dtype)
    Vk = torch.cat([Vk[:, :, :1] * sgn[:, None, None], Vk[:, :, 1:]], 2)
    return (_mask_cols(Vk, nkeep), nkeep, w,
            _margin(w.abs(), thr, K), res)


def _trace_stage_targets(m_ch, pv_ch, T, svd_tol, kcap):
    """Facet/cell trace stage with targets and 1x1 child blocks
    (mirrors _compute_coarse_traces): m_ch (n, nd) diag mass, pv_ch
    (n, nd), T (n, nd, kt) targets (masked columns are zero).
    Returns (ptr (n, nd) PV column values, F (n, nd) cochain
    functionals, U (n, nd, kcap) kept columns scaled sqrt(dots) and
    masked, nkeep (n,), dots (n,), margin (n,) of the deciding singular
    values)."""
    dt = m_ch.dtype
    mpv = m_ch * pv_ch
    dots = torch.sum(pv_ch * mpv, dim=1)
    F = mpv / dots[:, None]
    coef = torch.einsum("bi,bik->bk", mpv, T) / dots[:, None]
    Td = T - pv_ch[:, :, None] * coef[:, None, :]
    # M-weighted SVD (true SVD, not the Gram: squaring the Gram also
    # squares the rounding floor to sqrt(eps)*sigma_max, which leaks
    # junk modes past the dots*svd_tol threshold the generic engine's
    # LAPACK SVD rejects)
    sc = torch.sqrt(m_ch)
    U0, s, _ = torch.linalg.svd(Td * sc[:, :, None], full_matrices=False)
    U = U0 / sc[:, :, None]
    # junk floor: true-SVD rounding noise scales with sigma_max at the
    # WORKING precision, not with the dots-relative reference threshold;
    # modes below ~200*eps*sigma_max are indistinguishable from noise in
    # this dtype and are not kept
    thr = torch.maximum(dots * svd_tol, 200.0 * float(torch.finfo(dt).eps)
                        * torch.clamp(s[:, 0], min=1e-30))
    keep = s > thr[:, None]
    nmax = s.shape[1]
    kcap = int(kcap)
    nkeep = torch.clamp(keep.sum(1), max=kcap)
    U = _mask_cols(U, nkeep)
    U = (U[:, :, :kcap] if nmax >= kcap else torch.cat(
        [U, U.new_zeros(U.shape[:2] + (kcap - nmax,))], dim=2))
    scale = torch.sqrt(dots)
    return (pv_ch, F, U * scale[:, None, None], nkeep, dots,
            _margin(s, thr, kcap))


def _ext_spot_check(shape, h, coeff, l2_weight, cells, fslot,
                    slot_facet, nu_int, ptr_bdr, pb_slot, U3np,
                    Pintnp, K2, n_spot):
    """f64 host oracle for the extension stage on `n_spot` AEs (spread
    deterministically over the grid): rebuild each AE's Lagrange saddle
    from analytic f64 inputs plus the SAME upstream trace data the
    device stage consumed (ptr_bdr/pb_slot/U3), solve it directly, and
    return the worst relative M_ii-energy error of any kept Pint
    column.  Cost: n_spot dense (nu_int+ncell+1)^2 f64 solves — O(ms)
    against a minutes-scale setup."""
    n_ae, ncell = cells.shape
    nbd = ptr_bdr.shape[1]
    nu = nu_int + nbd
    K3 = U3np.shape[2]
    k_ext = 6 * (1 + K2)
    ref64 = _st.fine_local_masses(h, np.float64)
    m02_ref = np.asarray(ref64[(0, 2)], dtype=np.float64)
    m03_ref = float(np.asarray(ref64[(0, 3)])[0, 0])
    _, _, d2np = _st.fine_derivative_values(shape, h, np.float64)
    coeff64 = np.asarray(coeff, dtype=np.float64)
    w64 = (np.asarray(l2_weight, dtype=np.float64)
           if l2_weight is not None else None)
    rows = np.arange(nbd)
    cols_extra = (6 + np.asarray(slot_facet)[:, None] * K2
                  + np.arange(K2)[None, :])
    spots = np.unique(np.linspace(0, n_ae - 1, n_spot).astype(np.int64))
    worst = 0.0
    for e in spots:
        ce = cells[e]
        m02_e = coeff64[ce][:, None, None] * m02_ref[None]
        m03_e = (w64[ce] if w64 is not None
                 else np.ones(ncell)) * m03_ref
        d2_e = d2np[ce]
        M = np.zeros((nu, nu))
        Dloc = np.zeros((ncell, nu))
        for i in range(ncell):
            sl = fslot[i]
            M[np.ix_(sl, sl)] += m02_e[i]
            Dloc[i, sl] = d2_e[i]
        B = m03_e[:, None] * Dloc
        Pb = np.zeros((nbd, k_ext))
        Pb[rows, slot_facet] = np.asarray(ptr_bdr[e], dtype=np.float64)
        Pb[rows[:, None], cols_extra] = np.asarray(
            pb_slot[e], dtype=np.float64)
        M_ii, M_ib = M[:nu_int, :nu_int], M[:nu_int, nu_int:]
        B_ii, B_ib = B[:, :nu_int], B[:, nu_int:]
        nsys = nu_int + ncell + 1
        rhs = np.zeros((nsys, k_ext + K3))
        rhs[:nu_int, :k_ext] = -(M_ib @ Pb)
        rhs[nu_int:nu_int + ncell, :k_ext] = -(B_ib @ Pb)
        rhs[nu_int:nu_int + ncell, k_ext:] = m03_e[:, None] * U3np[e]
        A = np.zeros((nsys, nsys))
        A[:nu_int, :nu_int] = M_ii
        A[nu_int:nu_int + ncell, :nu_int] = B_ii
        A[:nu_int, nu_int:nu_int + ncell] = B_ii.T
        A[-1, nu_int:nu_int + ncell] = m03_e
        A[nu_int:nu_int + ncell, -1] = m03_e
        try:
            X = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:       # pragma: no cover
            X = np.linalg.lstsq(A, rhs, rcond=None)[0]
        P64 = X[:nu_int]
        D = Pintnp[e][:, :k_ext + K3] - P64
        e_col = np.einsum("ik,ij,jk->k", D, M_ii, D)
        ref_col = np.einsum("ik,ij,jk->k", P64, M_ii, P64)
        scale = max(float(ref_col.max()), 1e-30)
        worst = max(worst, float(np.sqrt(
            np.clip(e_col, 0.0, None).max() / scale)))
    return worst



def _extension_stage(m02_ch, m03_ch, d2_ch, ptr_bdr, pb_slot, t2_u,
                     rt_cols, fslot, slot_facet, nu_int, null_tol):
    """Hdiv interior Lagrange extension with RangeT bubbles and null
    targets (mirrors _extension use_lagrange=True):
      m02_ch (n, ncell, 6, 6), m03_ch (n, ncell), d2_ch (n, ncell, 6),
      ptr_bdr (n, nbd) facet PV trace values on the AE's boundary
      slots, pb_slot (n, nbd, K2) each boundary slot's row of its own
      facet's kept-mode columns (masked), t2_u (n, nu, 3) global Hdiv
      targets in AE slot order, rt_cols (n, ncell, K3) kept L2 target
      columns (masked), fslot (ncell, 6) static, slot_facet (nbd,)
      static facet index [0..6) of each boundary slot, nu_int static.
    Returns (Pint (n, nu_int, k_ext + K3), lam (n, k_ext), bubU
    (n, nu_int, 3) masked kept bubbles, n_null (n,), bub_sv (n, 3),
    margin (n,) of the bubble singular values, the relative residual
    of the saddle solve)."""
    n, ncell = m03_ch.shape
    nbd = ptr_bdr.shape[1]
    nu = nu_int + nbd
    dt = m02_ch.dtype
    dev = m02_ch.device
    M = _st._assemble(m02_ch, fslot, nu)
    Dloc = _st._place(d2_ch, (ncell, nu), np.arange(ncell)[:, None], fslot)
    B = m03_ch[:, :, None] * Dloc                    # (n, ncell, nu)
    T = m03_ch                                       # W_ii @ pv (pv=1)

    K2 = pb_slot.shape[2]
    k_ext = 6 * (1 + K2)
    # Pb (n, nbd, k_ext): boundary slot s of facet j carries the PV
    # value at column j and its facet's kept-mode row at columns
    # 6 + j*K2 .. (block-diagonal by facet; masked slots are zero)
    rows = np.arange(nbd)
    cols_extra = (6 + slot_facet[:, None] * K2
                  + np.arange(K2)[None, :])          # (nbd, K2)
    Pb = ptr_bdr.new_zeros((n, nbd, k_ext))
    Pb[:, _st._ix(rows, dev), _st._ix(slot_facet, dev)] = ptr_bdr
    Pb[:, _st._ix(rows[:, None], dev), _st._ix(cols_extra, dev)] = pb_slot

    M_ii, M_ib = M[:, :nu_int, :nu_int], M[:, :nu_int, nu_int:]
    B_ii, B_ib = B[:, :, :nu_int], B[:, :, nu_int:]
    nsys = nu_int + ncell + 1
    K3 = rt_cols.shape[2]
    t_int, t_bdr = t2_u[:, :nu_int], t2_u[:, nu_int:]
    kn = t2_u.shape[2]
    ip = slice(nu_int, nu_int + ncell)
    rhs = M.new_zeros((n, nsys, k_ext + K3 + kn))
    rhs[:, :nu_int, :k_ext] = -(M_ib @ Pb)
    rhs[:, ip, :k_ext] = -(B_ib @ Pb)
    rhs[:, ip, k_ext:k_ext + K3] = m03_ch[:, :, None] * rt_cols
    rhs[:, :nu_int, k_ext + K3:] = -(M_ib @ t_bdr)
    rhs[:, ip, k_ext + K3:] = B_ii @ t_int

    A = M.new_zeros((n, nsys, nsys))
    A[:, :nu_int, :nu_int] = M_ii
    A[:, ip, :nu_int] = B_ii
    A[:, :nu_int, ip] = B_ii.transpose(1, 2)
    A[:, -1, ip] = T
    A[:, ip, -1] = T
    X = _st._solve_batch(A, rhs)
    res = _rel_residual(A, X, rhs)
    Pint = X[:, :nu_int, :k_ext + K3]
    lam = X[:, -1, :k_ext]
    bub = t_int - X[:, :nu_int, k_ext + K3:]
    # thin SVD of the (nu_int, kn) bubble stack via the kn x kn Gram (the
    # JAX module's route; its floor is sqrt(eps)*sigma_max, below)
    G = torch.einsum("bik,bil->bkl", bub, bub)
    ev, Q = _eigh(G)
    s = torch.sqrt(torch.clamp(ev, min=0.0)).flip(1)
    Q = Q.flip(2)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    U = torch.einsum("bik,bkl->bil", bub, Q) / safe[:, None, :]
    # Gram noise floor is sqrt(eps)*sigma_max at the working precision
    thr = torch.clamp(50.0 * float(np.sqrt(torch.finfo(dt).eps))
                      * torch.clamp(s[:, 0], min=1e-30), min=null_tol)
    n_null = (s > thr[:, None]).sum(1)
    return (Pint, lam, _mask_cols(U, n_null), n_null, s,
            _margin(s, thr, kn), res)


# --------------------------------------------------------------------- #
# the coarsening step
# --------------------------------------------------------------------- #

@dataclass
class SpectralDarcyOut:
    """One structured spectral Hdiv-L2 coarsening step."""
    cshape: tuple
    f: tuple
    P2: object            # host CSR (fine faces x coarse Hdiv dofs)
    P3: object            # host CSR (fine cells x coarse L2 dofs)
    n_facet_dofs: object  # (n_facets,) 1 + kept per coarse facet
    n_ae_u_dofs: object   # (n_ae,) rt + null interior Hdiv dofs
    n_ae_p_dofs: object   # (n_ae,) 1 + kept L2 dofs
    ns_res: float = 0.0   # largest relative residual of a stage solve
    ext_spot_err: float = 0.0  # f64 spot-oracle energy error (worst AE)
    # the port's own: seconds per stage, each stage's residual, and per
    # keep rule the entities within NEAR_REL of their threshold (ids in
    # the stage's entity order: AEs, or facets of family a) with the
    # least relative margin seen
    stage_s: dict = field(default_factory=dict)
    stage_res: dict = field(default_factory=dict)
    near_threshold: dict = field(default_factory=dict)
    min_margin: dict = field(default_factory=dict)


#: byte budget of the largest stage tensor of one chunk (the nu x nu M
#: scatter plus the solve workspace, ~4 copies).  The JAX module bounds
#: it to 3e8 bytes, a TPU HBM budget; here it is sized for the H100's
#: 80 GB (a tenth of it): the full SPE10 grid's spectral and extension
#: stages run in 5 chunks of 2,850 AEs
STAGE_BYTES = 8.0e9


def spectral_coarsen_darcy(shape, f, coeff, h=None, l2_weight=None,
                           spect_tol=0.002, max_evects=5,
                           svd_tol=1e-9, kcap2=None, dtype=np.float64,
                           chunk=8192, spot_check=3, spot_tol=None,
                           device=None):
    """One spectral Hdiv-L2 coarsening of the fine grid `shape` with
    per-axis factors `f` and per-cell Hdiv coefficient `coeff` (SPE10
    kinv; the L2 mass keeps unit weight like the reference examples),
    every stage a batched program on `device` (None: the card), chunked
    over entities.  Returns SpectralDarcyOut with host CSR P2/P3."""
    if not all(s % ff == 0 for s, ff in zip(shape, f)):
        raise RuntimeError(f"factors {f} do not divide the grid {shape}")
    dev = resolve_device(device)
    cshape = tuple(s // ff for s, ff in zip(shape, f))
    if h is None:
        h = tuple(1.0 / s for s in shape)
    dt = np.dtype(dtype)
    tdt = as_torch_dtype(dt)
    if spot_tol is None:
        # calibrated against measured spot errors (f64 direct ~1e-13;
        # f32 with refinement in the JAX module's tests)
        spot_tol = 1e-8 if dt.itemsize == 8 else 2e-3
    nc, nf, ne, nv = _st.grid_counts(shape)
    ncells_ae = int(np.prod(f))
    n_ae = int(np.prod(cshape))
    stage_s, stage_res, near, min_margin = {}, {}, {}, {}

    def tt(a):
        return torch.as_tensor(np.asarray(a, dtype=dt)).to(dev)

    def full(vals):
        return torch.cat([torch.full((nf[a],), float(vals[a]), dtype=tdt,
                                     device=dev) for a in range(3)])

    # ---- fine value plane (analytic, device) ---- #
    ref = _st.fine_local_masses(h, dt)
    c = tt(coeff)
    w = tt(l2_weight) if l2_weight is not None else torch.ones(
        nc, dtype=tdt, device=dev)
    m02 = c[:, None, None] * tt(ref[(0, 2)])[None]
    m03 = w * float(ref[(0, 3)][0, 0])
    m12 = full([ref[(1, 2)][a][0, 0] for a in range(3)])
    _, _, d2np = _st.fine_derivative_values(shape, h, dt)
    d2 = tt(d2np)
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    pv2 = full(areas)
    # order-0 global Hdiv targets: three unit fields (flux = area)
    ea = np.eye(3, dtype=dt) * np.asarray(areas, dtype=dt)
    t2 = torch.cat([tt(ea[a]).expand(nf[a], 3) for a in range(3)], dim=0)

    # ---- index plane ---- #
    cells = ae_cells(cshape, f)                       # (n_ae, ncells)
    faces, nu_int = ae_faces(cshape, f)               # (n_ae, nu)
    fslot = cell_face_slots(f)
    fch = facet_children(cshape, f)
    fnbr = facet_neighbors(cshape)
    bsl = facet_bdr_slices(f)
    nbd = faces.shape[1] - nu_int
    K3 = int(max_evects)
    if kcap2 is None:
        kcap2 = 2 * K3
    K2 = int(kcap2)
    nu = faces.shape[1]
    chunk_big = max(128, min(chunk, int(STAGE_BYTES / max(
        4 * nu * nu * dt.itemsize, 1))))

    def run(name, fn, spec, n, ch=None):
        t0 = time.perf_counter()
        outs = _st._run_stage(fn, spec, n, ch or chunk)
        synchronize(dev)
        stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
        return outs

    def keep_rule(name, margin):
        m = margin.cpu().numpy()
        near[name] = np.flatnonzero(m < NEAR_REL).tolist()
        min_margin[name] = float(m.min()) if m.size else float("inf")

    # ---- stage A: per-AE spectral eigenproblems ---- #
    bdr_faces = faces[:, nu_int:]
    Vk, nkeepA, _, margA, resA = run(
        "spec", lambda a, b, c_, d_: _spectral_stage(
            a, b, c_, d_, fslot, nu_int, float(spect_tol), K3),
        [("g", m02, cells), ("g", m03, cells), ("g", m12, bdr_faces),
         ("g", d2, cells)], n_ae, ch=chunk_big)
    stage_res["spec"] = float(resA)
    keep_rule("spec", margA)
    npl = ncells_ae
    l2_tars = Vk[:, :npl]                             # (n_ae, npl, K3)
    mu = Vk[:, npl:]                                  # (n_ae, nbd, K3)

    # ---- stage T3: L2 traces with the spectral L2 targets ---- #
    svd_eff = float(max(svd_tol, 200.0 * np.finfo(dt).eps))
    ptr3, F3, U3, nk3, dots3, marg3 = run(
        "t3", lambda m, p, t: _trace_stage_targets(m, p, t, svd_eff, K3),
        [("g", m03, cells), ("g", torch.ones(nc, dtype=tdt, device=dev),
                             cells), ("d", l2_tars)], n_ae)
    keep_rule("t3", marg3)

    # ---- stage T2 (per family): facet traces with merged AE targets - #
    fam_out = []
    for a in range(3):
        ids = fch[a]                                  # (nfa, nch)
        nbrs = fnbr[a]
        s_left, s_right, nch = bsl[a]
        # targets: left AE's block at its a1 slots, right AE's at a0;
        # -1 neighbors gather row 0 and are masked to zero
        lidx = np.where(nbrs[:, 0] >= 0, nbrs[:, 0], 0)
        ridx = np.where(nbrs[:, 1] >= 0, nbrs[:, 1], 0)
        lmask = tt((nbrs[:, 0] >= 0).astype(dt))
        rmask = tt((nbrs[:, 1] >= 0).astype(dt))

        def t2fam(m_ch, pv_ch, muL, muR, lm, rm,
                  _sl=s_left, _sr=s_right, _nch=nch):
            TL = muL[:, _sl:_sl + _nch] * lm[:, None, None]
            TR = muR[:, _sr:_sr + _nch] * rm[:, None, None]
            T = torch.cat([TL, TR], dim=2)
            return _trace_stage_targets(m_ch, pv_ch, T, svd_eff, K2)

        outs = run("t2a", t2fam,
                   [("g", m12, ids), ("g", pv2, ids),
                    ("g", mu, lidx), ("g", mu, ridx),
                    ("d", lmask), ("d", rmask)], len(ids))
        keep_rule(f"t2{a}", outs[5])
        fam_out.append(outs)

    t0 = time.perf_counter()
    # stitch the three families into global facet arrays (per-facet
    # child counts differ across families; keep ragged as a list)
    nfacets = [len(fch[a]) for a in range(3)]
    facet_off = np.concatenate([[0], np.cumsum(nfacets)])

    # per-AE boundary-slot views of the facet-stage outputs: the PV
    # trace value and the facet's kept-mode row per boundary slot
    # (boundary slots are facet-contiguous in the same (b,c)-lex order
    # as facet_children, so these are direct gathers)
    afacets = ae_facet_ids(cshape)                    # (n_ae, 6) global
    nk2_all = np.empty(int(facet_off[-1]), dtype=np.int64)
    for a in range(3):
        nk2_all[facet_off[a]:facet_off[a + 1]] = fam_out[a][3].cpu().numpy()
    ptr2_fam = [fam_out[a][0].cpu().numpy().astype(dt) for a in range(3)]
    u2_fam = [fam_out[a][2].cpu().numpy().astype(dt) for a in range(3)]
    ptr_bdr = np.empty((n_ae, nbd), dtype=dt)
    pb_slot = np.zeros((n_ae, nbd, K2), dtype=dt)
    slot_facet = np.empty(nbd, dtype=np.int64)
    for j in range(6):
        a, side = j // 2, j % 2
        loc = afacets[:, j] - facet_off[a]
        s_left, s_right, nch = bsl[a]
        s0 = s_left if side == 1 else s_right
        slot_facet[s0:s0 + nch] = j
        ptr_bdr[:, s0:s0 + nch] = ptr2_fam[a][loc]
        pb_slot[:, s0:s0 + nch, :] = u2_fam[a][loc]
    stage_s["stitch"] = time.perf_counter() - t0

    # ---- stage E2: interior extension ---- #
    tol_n = max(svd_tol, 200.0 * float(np.finfo(dt).eps))
    Pint_t, _, bubU_t, n_null_t, _, margE, resE = run(
        "ext", lambda a_, b_, c_, d_, e_, g_, r_:
        _extension_stage(a_, b_, c_, d_, e_, g_, r_, fslot, slot_facet,
                         nu_int, tol_n),
        [("g", m02, cells), ("g", m03, cells), ("g", d2, cells),
         ("d", tt(ptr_bdr)), ("d", tt(pb_slot)),
         ("g", t2, faces), ("d", U3)], n_ae, ch=chunk_big)
    stage_res["ext"] = float(resE)
    keep_rule("null", margE)

    ns_res = max(stage_res.values())
    for k, v in stage_res.items():
        tol = _EXT_GUARD_TOL if k == "ext" else _GUARD_TOL
        if not v < tol:
            raise RuntimeError(f"stage {k} solve did not converge: relative "
                               f"residual {v} (limit {tol}); all stages "
                               f"{stage_res}")

    t0 = time.perf_counter()
    nk3 = nk3.cpu().numpy()
    ptr3 = ptr3.cpu().numpy()
    U3 = U3.cpu().numpy()
    Pint = Pint_t.cpu().numpy()
    bubU = bubU_t.cpu().numpy()
    n_null = n_null_t.cpu().numpy()
    stage_s["fetch"] = time.perf_counter() - t0

    # ---- coarse-operator quality invariant (f64 spot oracle) ---- #
    # a handful of AEs' extension saddles re-solved on the host in f64
    # from analytic inputs and the SAME upstream trace data, the device
    # Pint columns compared in the M_ii ENERGY norm
    t0 = time.perf_counter()
    ext_spot = 0.0
    if spot_check:
        ext_spot = _ext_spot_check(
            shape, h, coeff, l2_weight, cells, fslot,
            slot_facet, nu_int, ptr_bdr, pb_slot,
            np.asarray(U3, dtype=np.float64), np.asarray(
                Pint, dtype=np.float64), K2, int(spot_check))
        if not ext_spot < spot_tol:
            raise RuntimeError(
                f"extension spot oracle: device Pint deviates from the f64 "
                f"host solution in energy norm by {ext_spot} (limit "
                f"{spot_tol})")
    stage_s["spot"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # ---- host materialization (masked columns dropped) ---- #
    # All four ragged kept-column blocks are emitted by ARRAY ops over a
    # (entity, capacity) keep-mask — at the (60,220,85) north star the
    # per-AE/per-facet list-append loops this replaces were the setup's
    # host hump (round-4 verdict item 6): 14k AEs x 6 facets of appends.
    import scipy.sparse as sp

    def _ragged_sel(counts, cap):
        """(entity, k) index pairs where k < counts[entity], row-major —
        the same visit order as the loops this replaces."""
        counts = np.asarray(counts, dtype=np.int64)
        mask = np.arange(cap)[None, :] < counts[:, None]
        return np.nonzero(mask)

    nk3np = np.asarray(nk3, dtype=np.int64)
    p_off = np.concatenate([[0], np.cumsum(1 + nk3np)])
    n_p_coarse = int(p_off[-1])
    ptr3np = np.asarray(ptr3, dtype=np.float64)
    U3np = np.asarray(U3, dtype=np.float64)
    rows3, cols3, vals3 = [], [], []
    rows3.append(cells.ravel())
    cols3.append(np.repeat(p_off[:-1], npl))
    vals3.append(ptr3np.ravel())
    ia, kk = _ragged_sel(nk3np, U3np.shape[2])
    rows3.append(cells[ia].ravel())
    cols3.append(np.repeat(p_off[ia] + 1 + kk, npl))
    vals3.append(U3np[ia, :, kk].ravel())
    P3 = sp.coo_matrix(
        (np.concatenate(vals3),
         (np.concatenate(rows3), np.concatenate(cols3))),
        shape=(nc, n_p_coarse)).tocsr()

    # coarse Hdiv dof numbering: [facet blocks (PV + kept) in global
    # facet order] then [per-AE interior: rt (nk3) + null (n_null)]
    nk2np = nk2_all
    u_off_f = np.concatenate([[0], np.cumsum(1 + nk2np)])
    n_facet_dofs = int(u_off_f[-1])
    n_nullnp = np.asarray(n_null, dtype=np.int64)
    u_off_i = (n_facet_dofs
               + np.concatenate([[0], np.cumsum(nk3np + n_nullnp)]))
    n_u_coarse = int(u_off_i[-1])

    rows2, cols2, vals2 = [], [], []
    # facet trace blocks
    for a in range(3):
        ids = fch[a]
        ptr2a = np.asarray(ptr2_fam[a], dtype=np.float64)
        u2a = np.asarray(u2_fam[a], dtype=np.float64)
        base = facet_off[a]
        nfa, nch = ids.shape
        offs = u_off_f[base:base + nfa]
        rows2.append(ids.ravel())
        cols2.append(np.repeat(offs, nch))
        vals2.append(ptr2a.ravel())
        fi, kk = _ragged_sel(nk2np[base:base + nfa], u2a.shape[2])
        rows2.append(ids[fi].ravel())
        cols2.append(np.repeat(offs[fi] + 1 + kk, nch))
        vals2.append(u2a[fi, :, kk].ravel())
    # interior blocks: extension columns in [6*(1+K2) ext | K3 rt] +
    # null bubbles
    Pintnp = np.asarray(Pint, dtype=np.float64)
    bubnp = np.asarray(bubU, dtype=np.float64)
    int_faces = faces[:, :nu_int]
    K2b = K2
    # ext PV columns: every (iae, j) pair
    gfc_all = afacets                           # (n_ae, 6)
    rows2.append(np.repeat(int_faces, 6, axis=0).ravel())
    cols2.append(np.repeat(u_off_f[gfc_all.ravel()], nu_int))
    vals2.append(np.swapaxes(Pintnp[:, :, :6], 1, 2).ravel())
    # ext kept columns: (iae, j, k) with k < nk2[afacets[iae, j]]
    iae_j, kk = _ragged_sel(nk2np[gfc_all.ravel()], K2b)
    ia, jj = iae_j // 6, iae_j % 6
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_f[gfc_all.ravel()[iae_j]] + 1 + kk,
                           nu_int))
    vals2.append(Pintnp[ia, :, 6 + jj * K2b + kk].ravel())
    # rt columns: (iae, k) with k < nk3
    ia, kk = _ragged_sel(nk3np, Pintnp.shape[2] - 6 * (1 + K2b))
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_i[ia] + kk, nu_int))
    vals2.append(Pintnp[ia, :, 6 * (1 + K2b) + kk].ravel())
    # null bubbles: (iae, k) with k < n_null
    ia, kk = _ragged_sel(n_nullnp, bubnp.shape[2])
    rows2.append(int_faces[ia].ravel())
    cols2.append(np.repeat(u_off_i[ia] + nk3np[ia] + kk, nu_int))
    vals2.append(bubnp[ia, :, kk].ravel())
    P2 = sp.coo_matrix(
        (np.concatenate(vals2),
         (np.concatenate(rows2), np.concatenate(cols2))),
        shape=(sum(nf), n_u_coarse)).tocsr()

    stage_s["materialize"] = time.perf_counter() - t0

    return SpectralDarcyOut(
        cshape=cshape, f=tuple(f), P2=P2, P3=P3,
        n_facet_dofs=1 + nk2np, n_ae_u_dofs=nk3np + n_nullnp,
        n_ae_p_dofs=1 + nk3np, ns_res=ns_res, ext_spot_err=ext_spot,
        stage_s=stage_s, stage_res=stage_res, near_threshold=near,
        min_margin=min_margin)
