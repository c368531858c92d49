"""Multilevel device-resident spectral Hdiv-L2 coarsening (block
engine, PyTorch).

Counterpart of parelag_tpu/amge/structured_spectral_ml.py.  The one-step
engine (amge/structured_spectral.py) coarsens the FINE cartesian grid,
where every facet carries one Hdiv dof and every cell one L2 dof; its
coarse level has variable counts (1 + kept modes a facet, RangeT and
bubble dofs a cell).  The reference recurses Coarsen() to any depth
(DeRhamSequence.cpp:572-692, spectral targets recomputed per level as in
MultigridTestSPE10.cpp:169-187); here every per-entity dof population
rides a FIXED slot capacity plus an active-count mask, so each level's
three stages stay uniform batched dense programs:

  * CapF slots per facet  (1 + kcap2 after one coarsening),
  * CapP slots per cell   (1 + max_evects),
  * CapI interior-u slots per cell (max_evects + n_bubble_targets),

slot 0 of every facet/cell block the PV dof.  Level 1 is the degenerate
case CapF=CapP=1, CapI=0, where the block stages reduce to the one-step
engine's math; level k+1 consumes the cell-local Galerkin blocks the
level-k extension emits.  Masked slots carry zero operator rows and
columns, made harmless by identity padding in the local solves and a
scale-aware eigenvalue shift in the spectral stage.

Differences from the JAX module are the one-step port's (direct solves
on the device of the level's tensors, no Newton-Schulz branch, relative
residuals for the guard, which raises RuntimeError, f64 eigh of the
bubble Gram), plus an f64 host spot oracle of the extension stage on
every level (_ext_spot_check_blk: the JAX chain has none).
"""

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from parelag_tpu_torch import resolve_device, synchronize
from parelag_tpu_torch.amge import structured as _st
from parelag_tpu_torch.amge import structured_spectral as _sp
from parelag_tpu_torch.ops.device_sparse import as_torch_dtype


# multiplier on the Gershgorin bound of the ACTIVE transformed Schur
# block: padded (inactive) slots get a planted eigenvalue this factor
# above every physical mode, so they are never among the kept smallest.
# The pad must stay SCALE-AWARE: a fixed huge shift (1e8) makes the f32
# eigh's absolute eigenvalue noise (~eps * ||A||) swamp the O(1) active
# eigenvalues — measured on the chip as kept-mode collapse (46 vs 70
# coarse u dofs at (12,20,8)); 16x the active bound keeps the noise at
# ~16*eps relative, far under the 2e-3 spectral keep threshold.
_PAD_EIG_FACTOR = 16.0


def _host(t):
    """A tensor (any device) or array as a host f64 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


@dataclass
class BlockLevelOut:
    """One block-level coarsening step: host CSR prolongations in the
    level's COMPRESSED dof numbering ([facet dofs by facet, then cell
    interior dofs] for u; [cell dofs by cell] for p) plus the next
    BlockLevel for recursion.  ns_res: the largest relative residual of
    the step's stage solves; ext_spot_err: the f64 spot oracle's worst
    energy error; stage_s: seconds per stage."""
    P2: object
    P3: object
    next_level: object
    ns_res: float
    ext_spot_err: float = 0.0
    stage_s: dict = None
    stage_res: dict = None


@dataclass
class BlockLevel:
    """One level of the block chain: the cartesian cell grid plus the
    cell/facet-local operator blocks in slot-capacity layout.

    Layouts (all tensors on the level's device, dtype uniform):
      cell_M (nc, 6*CapF + CapI, same) — cell-local Hdiv mass in the
          cell layout [x0|x1|y0|y1|z0|z1 facet blocks, interior block]
          (level 1: the 6x6 kinv-weighted hex blocks);
      cell_B (nc, CapP, 6*CapF + CapI) — W-weighted divergence rows;
      cell_W (nc, CapP, CapP) — L2 mass blocks (level 1: vol scalars);
      facet_Q (sum nf, CapF, CapF) — facet trace mass blocks, global
          facet order (x family, then y, then z);
      pv_f (sum nf, CapF) — the global PV (constant-flux) field's
          representation on each facet block (level 1: the face areas;
          level >= 2: the slot-0 indicator);
      t2_f (sum nf, CapF, kt) / t2_i (nc, CapI, kt) — the polynomial
          (bubble) targets' representation in this level's coordinates;
      facet_n (sum nf,) / cell_pn (nc,) — active slot counts (prefix
          of CapF / CapP), host int arrays;
      cell_rt_n / cell_null_n (nc,) — active interior-u counts: the
          interior block is [capRT RangeT slots | CapI - capRT null
          slots] and each sub-block's actives are a prefix.
    """
    cshape: tuple
    capF: int
    capP: int
    capI: int
    capRT: int
    cell_M: object
    cell_B: object
    cell_W: object
    facet_Q: object
    pv_f: object
    t2_f: object
    t2_i: object
    facet_n: object          # host int arrays
    cell_pn: object
    cell_rt_n: object
    cell_null_n: object
    h: tuple

    @property
    def dtype(self):
        return self.cell_M.dtype

    def un_mask_np(self):
        """(nc, capI) active interior-u slot mask (host)."""
        nc = len(self.cell_rt_n)
        m = np.zeros((nc, self.capI))
        m[:, :self.capRT] = (np.arange(self.capRT)[None, :]
                             < self.cell_rt_n[:, None])
        m[:, self.capRT:] = (np.arange(self.capI - self.capRT)[None, :]
                             < self.cell_null_n[:, None])
        return m

    def u_offsets(self):
        """Compressed u-dof numbering: facet blocks then cell
        interiors.  Returns (facet dof offsets (nf+1,), interior dof
        offsets (nc+1,) shifted past the facets, ndofs_u)."""
        fo = np.concatenate([[0], np.cumsum(self.facet_n)])
        io = int(fo[-1]) + np.concatenate(
            [[0], np.cumsum(self.cell_rt_n + self.cell_null_n)])
        return fo, io, int(io[-1])

    def p_offsets(self):
        po = np.concatenate([[0], np.cumsum(self.cell_pn)])
        return po, int(po[-1])



def fine_block_level(shape, coeff, h=None, l2_weight=None,
                     dtype=np.float64, device=None) -> BlockLevel:
    """The fine grid as the degenerate block level (CapF=CapP=1,
    CapI=0) on `device` (None: the card) — the same value plane as
    spectral_coarsen_darcy's."""
    dev = resolve_device(device)
    if h is None:
        h = tuple(1.0 / s for s in shape)
    dt = np.dtype(dtype)
    tdt = as_torch_dtype(dt)
    nc, nf, ne, nv = _st.grid_counts(shape)
    ref = _st.fine_local_masses(h, dt)

    def tt(a):
        return torch.as_tensor(np.asarray(a, dtype=dt)).to(dev)

    def full(vals):
        return torch.cat([torch.full((nf[a],), float(vals[a]), dtype=tdt,
                                     device=dev) for a in range(3)])

    c = tt(coeff)
    w = tt(l2_weight) if l2_weight is not None else torch.ones(
        nc, dtype=tdt, device=dev)
    m02 = c[:, None, None] * tt(ref[(0, 2)])[None]
    vol = float(ref[(0, 3)][0, 0])
    m03 = w * vol
    m12 = full([ref[(1, 2)][a][0, 0] for a in range(3)])
    _, _, d2np = _st.fine_derivative_values(shape, h, dt)
    d2 = tt(d2np)
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    # order-0 global Hdiv targets (unit fields, flux = area) in facet
    # coordinates; no interior component at the fine level
    ea = np.eye(3, dtype=dt) * np.asarray(areas, dtype=dt)
    t2_f = torch.cat([tt(ea[a]).expand(nf[a], 3) for a in range(3)],
                     dim=0)[:, None, :]                  # (nf, 1, 3)
    pv_f = full(areas)[:, None]                          # (nf, 1)
    return BlockLevel(
        cshape=tuple(shape), capF=1, capP=1, capI=0, capRT=0,
        cell_M=m02,
        cell_B=(m03[:, None] * d2)[:, None, :],          # (nc, 1, 6)
        cell_W=m03[:, None, None],
        facet_Q=m12[:, None, None],
        pv_f=pv_f,
        t2_f=t2_f, t2_i=torch.zeros((nc, 0, 3), dtype=tdt, device=dev),
        facet_n=np.ones(sum(nf), np.int64),
        cell_pn=np.ones(nc, np.int64),
        cell_rt_n=np.zeros(nc, np.int64),
        cell_null_n=np.zeros(nc, np.int64), h=tuple(h))


def _colmap(f, capF, capI):
    """(ncell, 6*capF + capI) AE-local u-dof index of every cell's
    local dofs, in the AE layout [interior-facet blocks | cell-interior
    blocks | boundary-facet blocks] (interior-first for the extension's
    contiguous elimination).  Also returns (nu_int_dofs, nbd_slots,
    slot_facet6) with slot_facet6 (nbd_slots,) = which of the AE's 6
    coarse facets each boundary SLOT belongs to."""
    fslot = _sp.cell_face_slots(f)                  # (ncell, 6) slots
    offs, nu_int = _sp._ae_face_offsets(f)
    ncell = fslot.shape[0]
    n_slots = len(offs)
    nbd = n_slots - nu_int
    base_int_cells = nu_int * capF
    base_bdr = nu_int * capF + ncell * capI

    def slot_base(t):
        return np.where(t < nu_int, t * capF,
                        base_bdr + (t - nu_int) * capF)

    cm = np.empty((ncell, 6 * capF + capI), dtype=np.int64)
    for j in range(6):
        b = slot_base(fslot[:, j])
        cm[:, j * capF:(j + 1) * capF] = b[:, None] + np.arange(capF)
    cm[:, 6 * capF:] = (base_int_cells
                        + np.arange(ncell)[:, None] * capI
                        + np.arange(capI)[None, :])
    # boundary slots appear facet-contiguous in [x0,x1,y0,y1,z0,z1]
    # order with f[b]*f[c] children each (same as _ae_face_offsets)
    slot_facet6 = np.empty(nbd, dtype=np.int64)
    s0 = 0
    for a in range(3):
        bb, cc = [ax for ax in range(3) if ax != a]
        nch = f[bb] * f[cc]
        for side in (0, 1):
            slot_facet6[s0:s0 + nch] = 2 * a + side
            s0 += nch
    return cm, nu_int * capF + ncell * capI, nbd, slot_facet6


def _scatter_ae_ops(mch, bch, qbdr, cm, nu_dofs, nbd, capF, u_act):
    """Assemble the AE-local operators from gathered cell/facet blocks.

    mch (n, ncell, cl, cl) cell_M blocks (cl = 6*capF + capI),
    bch (n, ncell, capP, cl), qbdr (n, nbd, capF, capF) boundary facet
    trace masses, cm (ncell, cl) static AE-local column map, u_act
    (n, nu) active-u mask assembled by coarsen_block_level from the facet/cell
    masks.

    Returns (M (n, nu, nu) identity-padded on inactive u slots,
             B (n, ncell*capP, nu), C (n, nbd*capF, nu) trace rows)."""
    n, ncell, cl, _ = mch.shape
    capP = bch.shape[2]
    nu = nu_dofs + nbd * capF
    M = _st._assemble(mch, cm, nu)
    rows = (np.arange(ncell)[:, None] * capP
            + np.arange(capP)[None, :])                 # (ncell, capP)
    flat = (rows[:, :, None] * nu + cm[:, None, :]).reshape(-1)
    B = bch.new_zeros((n, ncell * capP * nu))
    B.index_add_(1, _st._ix(flat, bch.device), bch.reshape(n, -1))
    B = B.reshape(n, ncell * capP, nu)
    # trace rows: boundary facet block j occupies rows j*capF.. and
    # columns nu_dofs + j*capF..
    rb = (np.arange(nbd)[:, None] * capF
          + np.arange(capF)[None, :])                   # (nbd, capF)
    cbl = nu_dofs + rb
    C = _st._place(qbdr, (nbd * capF, nu), rb[:, :, None], cbl[:, None, :])
    pad = 1.0 - u_act
    M = M + torch.diag_embed(pad * pad)
    return M, B, C


def _blk_chol_scale(R_blocks, mask):
    """Batched Cholesky of SPD blocks with inactive slots padded to the
    identity: R (n, k, s, s), mask (n, k, s) active flags.  Returns L
    (lower) with identity rows/cols on inactive slots."""
    s = R_blocks.shape[-1]
    eye = torch.eye(s, dtype=R_blocks.dtype, device=R_blocks.device)
    pad = (1.0 - mask)[:, :, :, None] * eye[None, None]
    Rp = R_blocks * mask[:, :, :, None] * mask[:, :, None, :] + pad
    return torch.linalg.cholesky(Rp)


def _blk_tri(L_blocks, V, upper):
    """V (n, k*s, m) <- blkdiag(L)^-1 V (lower) or blkdiag(L^T)^-1 V
    (upper) with L (n, k, s, s)."""
    n, k, s, _ = L_blocks.shape
    seg = V.reshape(n, k, s, -1)
    A = L_blocks.transpose(2, 3) if upper else L_blocks
    return torch.linalg.solve_triangular(A, seg, upper=upper).reshape(
        n, k * s, -1)


def _spectral_stage_blk(mch, bch, wch, qbdr, wmask, qmask_bdr,
                        u_act, cm, nu_dofs, nbd, capF,
                        spect_tol, max_evects):
    """Generalized per-AE mixed Hdiv-L2 eigenproblem over block slots
    (level-1 degenerate case == _sp._spectral_stage; reference
    LocalSpectralTargets.cpp:46-90).

    wmask (n, ncell, capP), qmask_bdr (n, nbd, capF) active masks,
    u_act (n, nu) AE-layout u activity.  Returns (V (n, npl+nbdofs, K)
    masked kept modes, nkeep (n,), the relative residual of
    M X = BC^T)."""
    n, ncell = wch.shape[:2]
    capP = wch.shape[2]
    dt = mch.dtype
    M, B, C = _scatter_ae_ops(mch, bch, qbdr, cm, nu_dofs, nbd, capF,
                              u_act)
    BC = torch.cat([B, C], dim=1)            # (n, npl + nbdofs, nu)
    BCt = BC.transpose(1, 2)
    X = _st._solve_batch(M, BCt)
    res = _sp._rel_residual(M, X, BCt)
    S = BC @ X
    S = 0.5 * (S + S.transpose(1, 2))
    # RHS = blkdiag(W blocks, Q boundary blocks); generalized eigh via
    # blockwise Cholesky (the blocks are tiny: capP/capF <= ~11)
    Lw = _blk_chol_scale(wch, wmask)
    Lq = _blk_chol_scale(qbdr, qmask_bdr)
    npl = ncell * capP
    nn = npl + nbd * capF
    rmask = torch.cat([wmask.reshape(n, -1), qmask_bdr.reshape(n, -1)],
                      dim=1)
    # zero inactive rows/cols of S so the only thing on padded slots is
    # the planted shift (applied to St below, AFTER the Cholesky
    # transform, where its scale can be tied to the active spectrum)
    S = S * rmask[:, :, None] * rmask[:, None, :]

    def lsolve(V, upper=False):
        return torch.cat([_blk_tri(Lw, V[:, :npl], upper),
                          _blk_tri(Lq, V[:, npl:], upper)], dim=1)

    # St = L^-1 S L^-T with L = blkdiag(Lw, Lq)
    St = lsolve(lsolve(S).transpose(1, 2))
    St = 0.5 * (St + St.transpose(1, 2))
    # scale-aware pad on the inactive slots: Gershgorin bound of the
    # active block puts every planted eigenvalue above the physical
    # range without inflating ||St|| (see _PAD_EIG_FACTOR note)
    bound = (St.abs().sum(2) * rmask).max(1).values
    pad = _PAD_EIG_FACTOR * torch.clamp(bound, min=1.0)
    St = St + torch.diag_embed((1.0 - rmask) ** 2 * pad[:, None])
    w, Vt = torch.linalg.eigh(St)
    # back-transform: V = L^-T Vt
    V = lsolve(Vt, upper=True)

    # active eigenvalue range: padded eigenvalues sit at the TOP
    # (ascending eigh); the reference threshold compares against the
    # largest ACTIVE eigenvalue
    n_act = rmask.sum(1).to(torch.int64)
    w_act_max = w.gather(1, torch.clamp(n_act - 1, min=0)[:, None])[:, 0]
    thr = spect_tol * torch.clamp(w_act_max.abs(), min=1.0)
    idx = torch.arange(nn, device=w.device)[None, :]
    nkeep = ((w.abs() <= thr[:, None]) & (idx < n_act[:, None])).sum(1)
    K = int(max_evects)
    nkeep = torch.clamp(nkeep, 1, K)
    Vk = V[:, :, :K]
    sgn = torch.where(Vk[:, 0, 0] < 0, -1.0, 1.0).to(dt)
    Vk = torch.cat([Vk[:, :, :1] * sgn[:, None, None], Vk[:, :, 1:]], 2)
    # zero components on inactive slots too
    return _sp._mask_cols(Vk, nkeep) * rmask[:, :, None], nkeep, res


def _trace_stage_blk(Qb, pv, T, dof_mask, svd_tol, kcap):
    """Generalized facet/cell trace stage (block mass): Qb (n, k, s, s)
    child mass blocks, pv (n, k*s) PV vector, T (n, k*s, kt) deflation
    targets, dof_mask (n, k, s) active flags.  Mirrors
    _sp._trace_stage_targets with the diag mass replaced by
    blkdiag(Qb) through its Cholesky.  Returns (F (n, k*s) PV cochain
    functional, U (n, k*s, kcap) kept columns scaled sqrt(dots),
    nkeep, dots)."""
    n, k, s, _ = Qb.shape
    nd = k * s
    dt = Qb.dtype
    L = _blk_chol_scale(Qb, dof_mask)
    mvec = dof_mask.reshape(n, nd)
    pv = pv * mvec

    def mdot(V):
        """blkdiag(Qb) @ V (active-masked)."""
        seg = (V * mvec[:, :, None]).reshape(n, k, s, -1)
        return (Qb @ seg).reshape(n, nd, -1) * mvec[:, :, None]

    mpv = mdot(pv[:, :, None])[:, :, 0]
    dots = torch.sum(pv * mpv, dim=1)
    F = mpv / dots[:, None]
    T = T * mvec[:, :, None]
    coef = torch.einsum("bi,bik->bk", mpv, T) / dots[:, None]
    Td = T - pv[:, :, None] * coef[:, None, :]
    # M-weighted SVD through the block Cholesky (true SVD — the Gram
    # squares the rounding floor, see _sp._trace_stage_targets)
    Ts = (L.transpose(2, 3) @ Td.reshape(n, k, s, -1)).reshape(n, nd, -1)
    U0, sv, _ = torch.linalg.svd(Ts, full_matrices=False)
    U = _blk_tri(L, U0, upper=True)
    thr = torch.maximum(dots * svd_tol, 200.0 * float(torch.finfo(dt).eps)
                        * torch.clamp(sv[:, 0], min=1e-30))
    nmax = sv.shape[1]
    kcap = int(kcap)
    nkeep = torch.clamp((sv > thr[:, None]).sum(1), max=kcap)
    U = _sp._mask_cols(U, nkeep) * mvec[:, :, None]
    U = (U[:, :, :kcap] if nmax >= kcap else torch.cat(
        [U, U.new_zeros(U.shape[:2] + (kcap - nmax,))], dim=2))
    scale = torch.sqrt(dots)
    return F, U * scale[:, None, None], nkeep, dots


def _ext_operands(mch, bch, wch, cm, nu_dofs, nbd, capF, ptr_bdr,
                  pb_slot, slot_facet6, t2_loc, rt_cols, u_act, wmask):
    """The extension saddle of _extension_stage_blk and its right-hand
    sides: (A (n, nsys, nsys) with the inactive-p padding, rhs, M, B,
    Pb), nsys = nu_int + ncell*capP + 1."""
    n, ncell = wch.shape[:2]
    capP = wch.shape[2]
    dev = mch.device
    # trace rows don't appear in the extension saddle
    qpad = mch.new_zeros((n, nbd, capF, capF))
    M, B, _ = _scatter_ae_ops(mch, bch, qpad, cm, nu_dofs, nbd, capF,
                              u_act)
    nu_int = nu_dofs
    # T = W_loc @ pv_p with pv_p = slot-0 indicator per cell block
    T = wch[:, :, :, 0].reshape(n, -1) * wmask.reshape(n, -1)

    K2 = pb_slot.shape[2]
    k_ext_f = 1 + K2                       # new dofs per coarse facet
    k_ext = 6 * k_ext_f
    nbdofs = nbd * capF
    rows = np.arange(nbdofs)
    sf = np.repeat(slot_facet6, capF)      # facet6 id per boundary DOF
    cols_extra = (sf[:, None] * k_ext_f + 1 + np.arange(K2)[None, :])
    Pb = mch.new_zeros((n, nbdofs, k_ext))
    Pb[:, _st._ix(rows, dev), _st._ix(sf * k_ext_f, dev)] = ptr_bdr
    Pb[:, _st._ix(rows[:, None], dev), _st._ix(cols_extra, dev)] = pb_slot

    M_ii, M_ib = M[:, :nu_int, :nu_int], M[:, :nu_int, nu_int:]
    B_ii, B_ib = B[:, :, :nu_int], B[:, :, nu_int:]
    npl = ncell * capP
    nsys = nu_int + npl + 1
    ip = slice(nu_int, nu_int + npl)

    K3 = rt_cols.shape[2]
    t_int, t_bdr = t2_loc[:, :nu_int], t2_loc[:, nu_int:]
    kn = t2_loc.shape[2]
    rw = (np.arange(ncell)[:, None] * capP + np.arange(capP)[None, :])
    Wblk = _st._place(wch, (npl, npl), rw[:, :, None], rw[:, None, :])
    rhs = mch.new_zeros((n, nsys, k_ext + K3 + kn))
    rhs[:, :nu_int, :k_ext] = -(M_ib @ Pb)
    rhs[:, ip, :k_ext] = -(B_ib @ Pb)
    rhs[:, ip, k_ext:k_ext + K3] = Wblk @ rt_cols
    rhs[:, :nu_int, k_ext + K3:] = -(M_ib @ t_bdr)
    rhs[:, ip, k_ext + K3:] = B_ii @ t_int

    # inactive p rows: keep the saddle nonsingular (their B rows are
    # zero); the multiplier row always stays (PV pressure is active)
    p_act = wmask.reshape(n, npl)
    A = mch.new_zeros((n, nsys, nsys))
    A[:, :nu_int, :nu_int] = M_ii
    A[:, ip, :nu_int] = B_ii
    A[:, :nu_int, ip] = B_ii.transpose(1, 2)
    A[:, -1, ip] = T
    A[:, ip, -1] = T
    pd = mch.new_zeros((n, nsys))
    pd[:, ip] = 1.0 - p_act
    A = A + torch.diag_embed(pd)
    return A, rhs, M, B, Pb


def _extension_stage_blk(mch, bch, wch, cm, nu_dofs, nbd, capF,
                         ptr_bdr, pb_slot, slot_facet6, t2_loc,
                         rt_cols, u_act, wmask, null_tol):
    """Generalized Hdiv interior Lagrange extension (level-1 degenerate
    case == _sp._extension_stage; reference hFacetExtension,
    DeRhamSequence.cpp:2169-2628).

      ptr_bdr (n, nbd*capF) PV boundary values (slot-0 indicators x pv
      values), pb_slot (n, nbd*capF, K2) each boundary dof's row of its
      own facet's kept-mode columns, slot_facet6 (nbd,) static,
      t2_loc (n, nu, kt) bubble targets in AE coordinates, rt_cols
      (n, ncell*capP, K3) kept L2 target columns, u_act (n, nu)
      AE-layout u activity.

    Returns (Pint (n, nu_int, k_ext + K3), bubU (n, nu_int, kt) masked,
    n_null (n,), the AE-local assembled (M, B, Pb) for the next-level
    Galerkin stage, and the relative residual of the saddle solve)."""
    A, rhs, M, B, Pb = _ext_operands(
        mch, bch, wch, cm, nu_dofs, nbd, capF, ptr_bdr, pb_slot,
        slot_facet6, t2_loc, rt_cols, u_act, wmask)
    dt = mch.dtype
    nu_int = nu_dofs
    k_ext = Pb.shape[2]
    K3 = rt_cols.shape[2]
    X = _st._solve_batch(A, rhs)
    res = _sp._rel_residual(A, X, rhs)
    Pint = X[:, :nu_int, :k_ext + K3]
    bub = t2_loc[:, :nu_int] - X[:, :nu_int, k_ext + K3:]
    G = torch.einsum("bik,bil->bkl", bub, bub)
    ev, Q = _sp._eigh(G)
    sv = torch.sqrt(torch.clamp(ev, min=0.0)).flip(1)
    Q = Q.flip(2)
    safe = torch.where(sv > 0, sv, torch.ones_like(sv))
    U = torch.einsum("bik,bkl->bil", bub, Q) / safe[:, None, :]
    thr = torch.clamp(50.0 * float(np.sqrt(torch.finfo(dt).eps))
                      * torch.clamp(sv[:, 0], min=1e-30), min=null_tol)
    n_null = (sv > thr[:, None]).sum(1)
    return Pint, _sp._mask_cols(U, n_null), n_null, M, B, Pb, res


def _ext_spot_check_blk(level, cells, faces, nu_int_sl, cm, nu_dofs, nbd,
                        capF, slot_facet6, ptr_bdr, pb_slot, U3, Pint,
                        n_spot):
    """f64 host oracle of the block extension stage on `n_spot` AEs
    spread over the grid: each AE's saddle is assembled again in numpy
    f64 from the level's cell blocks (gathered to the host) and the SAME
    upstream trace data the device stage took (ptr_bdr, pb_slot, U3),
    solved directly, and the device Pint columns are compared in the
    M_ii energy norm; returns the worst relative error, normalized by
    the dominant column as _sp._ext_spot_check does."""
    n_ae, ncell = cells.shape
    capP = level.capP
    spots = np.unique(np.linspace(0, n_ae - 1, n_spot).astype(np.int64))
    qm = (np.arange(capF)[None, :] < level.facet_n[:, None]).astype(float)
    wm = (np.arange(capP)[None, :] < level.cell_pn[:, None]).astype(float)
    um = level.un_mask_np()
    kt = level.t2_f.shape[2]
    sel = torch.as_tensor(cells[spots].ravel())
    fsel = torch.as_tensor(faces[spots].ravel())

    def gather(t, idx, rows):
        return _host(t[idx.to(t.device)]).reshape((len(spots), rows)
                                                 + tuple(t.shape[1:]))

    mch = torch.as_tensor(gather(level.cell_M, sel, ncell))
    bch = torch.as_tensor(gather(level.cell_B, sel, ncell))
    wch = torch.as_tensor(gather(level.cell_W, sel, ncell))
    t2f = gather(level.t2_f, fsel, faces.shape[1])
    t2i = gather(level.t2_i, sel, ncell)
    n = len(spots)
    qm_sl = qm[faces[spots]]
    u_act = np.concatenate([qm_sl[:, :nu_int_sl].reshape(n, -1),
                            um[cells[spots]].reshape(n, -1),
                            qm_sl[:, nu_int_sl:].reshape(n, -1)], axis=1)
    t2_loc = np.concatenate([t2f[:, :nu_int_sl].reshape(n, -1, kt),
                             t2i.reshape(n, -1, kt),
                             t2f[:, nu_int_sl:].reshape(n, -1, kt)], axis=1)
    A, rhs, M, _, _ = _ext_operands(
        mch, bch, wch, cm, nu_dofs, nbd, capF,
        torch.as_tensor(_host(ptr_bdr[spots])),
        torch.as_tensor(_host(pb_slot[spots])), slot_facet6,
        torch.as_tensor(t2_loc),
        torch.as_tensor(_host(U3[torch.as_tensor(spots, device=U3.device)])),
        torch.as_tensor(u_act), torch.as_tensor(wm[cells[spots]]))
    A, rhs, M = A.numpy(), rhs.numpy(), M.numpy()
    Pd = _host(Pint[torch.as_tensor(spots, device=Pint.device)])
    kc = Pd.shape[2]
    worst = 0.0
    for e in range(n):
        X = np.linalg.solve(A[e], rhs[e])
        P64 = X[:nu_dofs, :kc]
        M_ii = M[e][:nu_dofs, :nu_dofs]
        D = Pd[e] - P64
        e_col = np.einsum("ik,ij,jk->k", D, M_ii, D)
        ref_col = np.einsum("ik,ij,jk->k", P64, M_ii, P64)
        scale = max(float(ref_col.max()), 1e-30)
        worst = max(worst, float(np.sqrt(
            np.clip(e_col, 0.0, None).max() / scale)))
    return worst


def coarsen_block_level(level: BlockLevel, f, spect_tol=0.002,
                        max_evects=5, svd_tol=1e-9, kcap2=None,
                        chunk=8192, spot_check=3,
                        spot_tol=None) -> BlockLevelOut:
    """One cartesian coarsening of a BlockLevel with per-axis factors
    `f`: the three stages of the one-step engine generalized to block
    slots, plus the Galerkin emission of the next BlockLevel, on the
    device of the level's tensors, chunked through _st._run_stage like
    the one-step engine."""
    cshape = level.cshape
    if not all(s % ff == 0 for s, ff in zip(cshape, f)):
        raise RuntimeError(f"factors {f} do not divide the grid {cshape}")
    dev = level.cell_M.device
    ae_shape = tuple(s // ff for s, ff in zip(cshape, f))
    tdt = level.cell_M.dtype
    dt = np.dtype(str(tdt).replace("torch.", ""))
    if spot_tol is None:
        spot_tol = 1e-8 if dt.itemsize == 8 else 2e-3
    capF, capP, capI = level.capF, level.capP, level.capI
    ncell = int(np.prod(f))
    n_ae = int(np.prod(ae_shape))
    kt = level.t2_f.shape[2]
    stage_s, stage_res = {}, {}

    # ---- index plane ---- #
    cells = _sp.ae_cells(ae_shape, f)                 # (n_ae, ncell)
    faces, nu_int_sl = _sp.ae_faces(ae_shape, f)      # (n_ae, nslots)
    cm, nu_dofs, nbd, slot_facet6 = _colmap(f, capF, capI)
    fch = _sp.facet_children(ae_shape, f)
    fnbr = _sp.facet_neighbors(ae_shape)
    bsl = _sp.facet_bdr_slices(f)
    afacets = _sp.ae_facet_ids(ae_shape)              # (n_ae, 6)
    nu = nu_dofs + nbd * capF

    K3 = int(max_evects)
    if kcap2 is None:
        kcap2 = 2 * K3
    K2 = int(kcap2)
    capFp = 1 + K2
    k_ext = 6 * capFp
    capPp = 1 + K3
    capIp = K3 + kt

    def tt(a):
        return torch.as_tensor(np.asarray(a, dtype=dt)).to(dev)

    # ---- device masks ---- #
    qm = tt(np.arange(capF)[None, :] < level.facet_n[:, None])
    wm = tt(np.arange(capP)[None, :] < level.cell_pn[:, None])
    um = tt(level.un_mask_np())

    def build_u_act(qm_sl, um_c):
        """AE-layout u activity from the gathered facet/cell masks:
        layout [interior facet blocks | cell interiors | boundary
        facet blocks] is contiguous in exactly this order."""
        n = qm_sl.shape[0]
        return torch.cat([
            qm_sl[:, :nu_int_sl].reshape(n, -1),
            um_c.reshape(n, -1),
            qm_sl[:, nu_int_sl:].reshape(n, -1)], dim=1)

    # per-stage chunk (see _sp.STAGE_BYTES)
    chunk_big = max(64, min(chunk, int(_sp.STAGE_BYTES / max(
        4 * nu * nu * dt.itemsize, 1))))
    svd_eff = float(max(svd_tol, 200.0 * np.finfo(dt).eps))

    def run(name, fn, spec, n, ch=None):
        t0 = time.perf_counter()
        outs = _st._run_stage(fn, spec, n, ch or chunk)
        synchronize(dev)
        stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
        return outs

    # ---- stage A: per-AE block spectral eigenproblems ---- #
    bdr_faces = faces[:, nu_int_sl:]

    def specfn(mch, bch, wch, qbdr, wm_c, qm_sl, um_c):
        u_act = build_u_act(qm_sl, um_c)
        return _spectral_stage_blk(
            mch, bch, wch, qbdr, wm_c, qm_sl[:, nu_int_sl:],
            u_act, cm, nu_dofs, nbd, capF, float(spect_tol), K3)

    Vk, nkeepA, res = run(
        "spec", specfn,
        [("g", level.cell_M, cells), ("g", level.cell_B, cells),
         ("g", level.cell_W, cells), ("g", level.facet_Q, bdr_faces),
         ("g", wm, cells), ("g", qm, faces), ("g", um, cells)],
        n_ae, ch=chunk_big)
    stage_res["spec"] = float(res)
    npl = ncell * capP
    l2_tars = Vk[:, :npl]                     # (n_ae, npl, K3)
    mu = Vk[:, npl:]                          # (n_ae, nbd*capF, K3)

    # ---- stage T3: L2 traces with the spectral L2 targets ---- #
    def t3fn(wch, wm_c, tars):
        n = wch.shape[0]
        pv = wch.new_zeros((n, ncell * capP))
        pv[:, ::capP] = 1.0
        return _trace_stage_blk(wch, pv, tars, wm_c, svd_eff, K3)

    F3, U3, nk3, dots3 = run(
        "t3", t3fn,
        [("g", level.cell_W, cells), ("g", wm, cells),
         ("d", l2_tars)], n_ae)

    # ---- stage T2 per family: facet traces + coarse facet mass + the
    #      bubble-target facet functionals ---- #
    fam_out = []
    for a in range(3):
        ids = fch[a]                          # (nfa, nch)
        nbrs = fnbr[a]
        s_left, s_right, nch = bsl[a]
        dl, dr = s_left * capF, s_right * capF
        wd = nch * capF
        lidx = np.where(nbrs[:, 0] >= 0, nbrs[:, 0], 0)
        ridx = np.where(nbrs[:, 1] >= 0, nbrs[:, 1], 0)
        lmask = tt(nbrs[:, 0] >= 0)
        rmask = tt(nbrs[:, 1] >= 0)

        def t2fam(Qb, pvch, t2ch, muL, muR, lm, rm, qm_ch,
                  _dl=dl, _dr=dr, _w=wd):
            n, nch_, cF = pvch.shape
            nd = nch_ * cF
            TL = muL[:, _dl:_dl + _w] * lm[:, None, None]
            TR = muR[:, _dr:_dr + _w] * rm[:, None, None]
            T = torch.cat([TL, TR], dim=2)
            F2, U2, nk2, dots2 = _trace_stage_blk(
                Qb, pvch.reshape(n, nd), T, qm_ch, svd_eff, K2)
            # coarse facet mass + bubble-target functionals through
            # the SAME prolongation columns the materialization emits
            qv = qm_ch.reshape(n, nd)[:, :, None]
            Pf = torch.cat([pvch.reshape(n, nd, 1), U2], dim=2)
            mPf = (Qb @ (Pf * qv).reshape(n, nch_, cF, -1)).reshape(
                n, nd, -1) * qv
            Qp = Pf.transpose(1, 2) @ mPf
            colm = (torch.arange(capFp, device=Qp.device)[None, :]
                    < (1 + nk2)[:, None]).to(Qp.dtype)
            Qp = (Qp * colm[:, :, None] * colm[:, None, :]
                  + torch.diag_embed((1.0 - colm) ** 2))
            rhsT = mPf.transpose(1, 2) @ t2ch.reshape(n, nd, -1)
            coefF = _st._solve_batch(Qp, rhsT)
            res = _sp._rel_residual(Qp, coefF, rhsT)
            return F2, U2, nk2, dots2, Qp, coefF * colm[:, :, None], res

        outs = run("t2a", t2fam,
                   [("g", level.facet_Q, ids), ("g", level.pv_f, ids),
                    ("g", level.t2_f, ids),
                    ("g", mu, lidx), ("g", mu, ridx),
                    ("d", lmask), ("d", rmask),
                    ("g", qm, ids)], len(ids))
        stage_res[f"t2{a}"] = float(outs[6])
        fam_out.append(outs)

    t0 = time.perf_counter()
    nfacets = [len(fch[a]) for a in range(3)]
    facet_off = np.concatenate([[0], np.cumsum(nfacets)])
    nk2_all = np.empty(int(facet_off[-1]), dtype=np.int64)
    for a in range(3):
        nk2_all[facet_off[a]:facet_off[a + 1]] = \
            fam_out[a][2].cpu().numpy()

    # per-AE boundary views: PV values and kept-mode rows per slot dof
    u2_fam = [fam_out[a][1].cpu().numpy().astype(dt) for a in range(3)]
    pvf_np = level.pv_f.cpu().numpy().astype(dt)
    nbdofs = nbd * capF
    ptr_bdr = pvf_np[bdr_faces].reshape(n_ae, nbdofs)
    pb_slot = np.zeros((n_ae, nbdofs, K2), dtype=dt)
    for j in range(6):
        a, side = j // 2, j % 2
        loc = afacets[:, j] - facet_off[a]
        s_left, s_right, nch = bsl[a]
        # bsl offsets are RELATIVE to the boundary start already
        d0 = (s_left if side == 1 else s_right) * capF
        pb_slot[:, d0:d0 + nch * capF, :] = u2_fam[a][loc]
    stage_s["stitch"] = time.perf_counter() - t0

    # ---- stage E2 + Galerkin: extension and next-level emission ---- #
    tol_n = max(svd_tol, 200.0 * float(np.finfo(dt).eps))
    coefF_all = torch.cat([fam_out[a][5] for a in range(3)], dim=0)

    def extfn(mch, bch, wch, ptr_b, pb_s, t2f_sl, t2i_c, u3_c, nk3_c,
              coefF_ae, qm_sl, um_c, wm_c):
        n = mch.shape[0]
        u_act = build_u_act(qm_sl, um_c)
        t2_loc = torch.cat([
            t2f_sl[:, :nu_int_sl].reshape(n, -1, kt),
            t2i_c.reshape(n, -1, kt),
            t2f_sl[:, nu_int_sl:].reshape(n, -1, kt)], dim=1)
        Pint, bubU, n_null, M, B, Pb, res = _extension_stage_blk(
            mch, bch, wch, cm, nu_dofs, nbd, capF,
            ptr_b, pb_s, slot_facet6, t2_loc, u3_c, u_act, wm_c,
            tol_n)
        # ---- next-level Galerkin blocks ---- #
        capUp = k_ext + K3 + kt
        P_loc = mch.new_zeros((n, nu, capUp))
        P_loc[:, :nu_dofs, :k_ext + K3] = Pint
        P_loc[:, :nu_dofs, k_ext + K3:] = bubU
        P_loc[:, nu_dofs:, :k_ext] = Pb
        MP = M @ P_loc
        cellMp = P_loc.transpose(1, 2) @ MP
        pv_p = mch.new_zeros((n, ncell * capP, 1))
        pv_p[:, ::capP, 0] = 1.0
        P3_loc = torch.cat([pv_p, u3_c], dim=2)
        cellBp = P3_loc.transpose(1, 2) @ (B @ P_loc)
        rw = (np.arange(ncell)[:, None] * capP
              + np.arange(capP)[None, :])
        Wblk = _st._place(wch, (ncell * capP, ncell * capP),
                          rw[:, :, None], rw[:, None, :])
        cellWp = P3_loc.transpose(1, 2) @ (Wblk @ P3_loc)
        # ---- bubble-target interior projection (cochain Pi) ---- #
        r = t2_loc - P_loc[:, :, :k_ext] @ coefF_ae.reshape(n, k_ext, kt)
        P_i = P_loc[:, :nu_dofs, k_ext:]
        MiPi = M[:, :nu_dofs, :nu_dofs] @ P_i
        G = P_i.transpose(1, 2) @ MiPi
        ar = torch.arange(max(K3, kt), device=mch.device)[None, :]
        colm = torch.cat([ar[:, :K3] < nk3_c[:, None],
                          ar[:, :kt] < n_null[:, None]], dim=1).to(
            mch.dtype)
        G = (G * colm[:, :, None] * colm[:, None, :]
             + torch.diag_embed((1.0 - colm) ** 2))
        rhsG = MiPi.transpose(1, 2) @ r[:, :nu_dofs]
        coef_i = _st._solve_batch(G, rhsG)
        res = torch.maximum(res, _sp._rel_residual(G, coef_i, rhsG))
        return (Pint, bubU, n_null, cellMp, cellBp, cellWp,
                coef_i * colm[:, :, None], res)

    Pint, bubU, n_null, cellMp, cellBp, cellWp, t2_i_p, res = run(
        "ext", extfn,
        [("g", level.cell_M, cells), ("g", level.cell_B, cells),
         ("g", level.cell_W, cells),
         ("d", tt(ptr_bdr)), ("d", tt(pb_slot)),
         ("g", level.t2_f, faces), ("g", level.t2_i, cells),
         ("d", U3), ("d", nk3),
         ("g", coefF_all, afacets),
         ("g", qm, faces), ("g", um, cells), ("g", wm, cells)],
        n_ae, ch=chunk_big)
    stage_res["ext"] = float(res)

    ns_res = max(stage_res.values())
    for k, v in stage_res.items():
        tol = _sp._EXT_GUARD_TOL if k == "ext" else _sp._GUARD_TOL
        if not v < tol:
            raise RuntimeError(f"block stage {k} solve did not converge: "
                               f"relative residual {v} (limit {tol}); all "
                               f"stages {stage_res}")

    t0 = time.perf_counter()
    ext_spot = 0.0
    if spot_check:
        ext_spot = _ext_spot_check_blk(
            level, cells, faces, nu_int_sl, cm, nu_dofs, nbd, capF,
            slot_facet6, ptr_bdr, pb_slot, U3, Pint, int(spot_check))
        if not ext_spot < spot_tol:
            raise RuntimeError(
                f"block extension spot oracle: device Pint deviates from "
                f"the f64 host solution in energy norm by {ext_spot} "
                f"(limit {spot_tol})")
    stage_s["spot"] = time.perf_counter() - t0

    # ---- host materialization + next level ---- #
    t0 = time.perf_counter()
    nk3_np = nk3.cpu().numpy().astype(np.int64)
    n_null_np = n_null.cpu().numpy().astype(np.int64)
    P2, P3 = _materialize(level, ae_shape, f, fch, facet_off, faces,
                          nu_int_sl, cells, afacets, fam_out, nk2_all,
                          nk3_np, n_null_np, _host(U3), _host(Pint),
                          _host(bubU), capFp, K2, K3, kt)
    stage_s["materialize"] = time.perf_counter() - t0

    Qp_all = torch.cat([fam_out[a][4] for a in range(3)], dim=0)
    pvfp = Qp_all.new_zeros((int(facet_off[-1]), capFp))
    pvfp[:, 0] = 1.0
    nxt = BlockLevel(
        cshape=ae_shape, capF=capFp, capP=capPp, capI=capIp, capRT=K3,
        cell_M=cellMp, cell_B=cellBp, cell_W=cellWp, facet_Q=Qp_all,
        pv_f=pvfp, t2_f=coefF_all, t2_i=t2_i_p,
        facet_n=1 + nk2_all, cell_pn=1 + nk3_np,
        cell_rt_n=nk3_np, cell_null_n=n_null_np, h=level.h)
    return BlockLevelOut(P2=P2, P3=P3, next_level=nxt, ns_res=ns_res,
                         ext_spot_err=ext_spot, stage_s=stage_s,
                         stage_res=stage_res)


def _materialize(level, ae_shape, f, fch, facet_off, faces, nu_int_sl,
                 cells, afacets, fam_out, nk2, nk3, n_null, U3np,
                 Pintnp, bubnp, capFp, K2, K3, kt):
    """Host CSR P2/P3 in the level's compressed dof numbering (facet
    dofs by facet, then cell interior dofs), masked columns dropped —
    the block generalization of the one-step engine's array-op
    materialization."""
    capF, capP, capI = level.capF, level.capP, level.capI
    capRT = level.capRT
    fo, io, ndofs_u = level.u_offsets()
    po, ndofs_p = level.p_offsets()
    n_ae, ncell = cells.shape
    fn = level.facet_n
    pn = level.cell_pn
    rtn, nun = level.cell_rt_n, level.cell_null_n

    # new dof offsets
    u_off_f = np.concatenate([[0], np.cumsum(1 + nk2)])
    n_facet_dofs = int(u_off_f[-1])
    u_off_i = (n_facet_dofs
               + np.concatenate([[0], np.cumsum(nk3 + n_null)]))
    n_u_coarse = int(u_off_i[-1])
    p_off = np.concatenate([[0], np.cumsum(1 + nk3)])
    n_p_coarse = int(p_off[-1])

    rows2, cols2, vals2 = [], [], []
    # ---- facet trace blocks ---- #
    pvf_np = _host(level.pv_f)
    for a in range(3):
        ids = fch[a]                                   # (nfa, nch)
        nfa, nch = ids.shape
        nd = nch * capF
        base = facet_off[a]
        U2 = _host(fam_out[a][1])
        Pf = np.concatenate(
            [pvf_np[ids].reshape(nfa, nd, 1), U2], axis=2)
        # row dof ids + validity per (child slot)
        rid = (fo[ids][:, :, None]
               + np.arange(capF)[None, None, :]).reshape(nfa, nd)
        rok = (np.arange(capF)[None, None, :]
               < fn[ids][:, :, None]).reshape(nfa, nd)
        cok = (np.arange(capFp)[None, :] < (1 + nk2[base:base + nfa]
                                            )[:, None])   # (nfa, capFp)
        jf, rr, kk = np.nonzero(rok[:, :, None] & cok[:, None, :])
        rows2.append(rid[jf, rr])
        cols2.append(u_off_f[base + jf] + kk)
        vals2.append(Pf[jf, rr, kk])

    # ---- interior rows ---- #
    # AE-local interior dof ids + validity, layout [int facet blocks |
    # cell interior blocks]
    int_faces = faces[:, :nu_int_sl]
    rid_f = (fo[int_faces][:, :, None]
             + np.arange(capF)[None, None, :]).reshape(n_ae, -1)
    rok_f = (np.arange(capF)[None, None, :]
             < fn[int_faces][:, :, None]).reshape(n_ae, -1)
    # cell interiors: compressed id = io[c] + (k for rt slot k,
    # rtn[c] + k for null slot k)
    slot_in = np.arange(capI)
    off_in = np.where(slot_in[None, None, :] < capRT,
                      slot_in[None, None, :],
                      rtn[cells][:, :, None]
                      + (slot_in[None, None, :] - capRT))
    rid_c = (io[cells][:, :, None] + off_in).reshape(n_ae, -1)
    rok_c = np.where(
        slot_in[None, None, :] < capRT,
        slot_in[None, None, :] < rtn[cells][:, :, None],
        (slot_in[None, None, :] - capRT)
        < nun[cells][:, :, None]).reshape(n_ae, -1)
    rid_all = np.concatenate([rid_f, rid_c], axis=1)   # (n_ae, nu_dofs)
    rok_all = np.concatenate([rok_f, rok_c], axis=1)

    k_ext = 6 * capFp
    # ext columns: (j, k) -> new facet afacets[:, j] dof k
    gfc = afacets                                      # (n_ae, 6)
    ext_cols = (u_off_f[gfc][:, :, None]
                + np.arange(capFp)[None, None, :]).reshape(n_ae, -1)
    ext_cok = (np.arange(capFp)[None, None, :]
               < (1 + nk2)[gfc][:, :, None]).reshape(n_ae, -1)
    ia, rr, cc = np.nonzero(rok_all[:, :, None]
                            & ext_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(ext_cols[ia, cc])
    vals2.append(Pintnp[ia, rr, cc])
    # rt columns
    rt_cok = np.arange(K3)[None, :] < nk3[:, None]
    ia, rr, cc = np.nonzero(rok_all[:, :, None] & rt_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(u_off_i[ia] + cc)
    vals2.append(Pintnp[ia, rr, k_ext + cc])
    # null columns
    nl_cok = np.arange(kt)[None, :] < n_null[:, None]
    ia, rr, cc = np.nonzero(rok_all[:, :, None] & nl_cok[:, None, :])
    rows2.append(rid_all[ia, rr])
    cols2.append(u_off_i[ia] + nk3[ia] + cc)
    vals2.append(bubnp[ia, rr, cc])

    P2 = sp.coo_matrix(
        (np.concatenate(vals2),
         (np.concatenate(rows2), np.concatenate(cols2))),
        shape=(ndofs_u, n_u_coarse)).tocsr()

    # ---- P3 ---- #
    rid_p = (po[cells][:, :, None]
             + np.arange(capP)[None, None, :]).reshape(n_ae, -1)
    rok_p = (np.arange(capP)[None, None, :]
             < pn[cells][:, :, None]).reshape(n_ae, -1)
    pv_p = np.zeros((n_ae, ncell * capP, 1))
    pv_p[:, ::capP, 0] = 1.0
    P3_loc = np.concatenate([pv_p, U3np], axis=2)      # (n, npl, 1+K3)
    p_cok = np.arange(1 + K3)[None, :] < (1 + nk3)[:, None]
    ia, rr, cc = np.nonzero(rok_p[:, :, None] & p_cok[:, None, :])
    rows3 = rid_p[ia, rr]
    cols3 = p_off[ia] + cc
    vals3 = P3_loc[ia, rr, cc]
    P3 = sp.coo_matrix((vals3, (rows3, cols3)),
                       shape=(ndofs_p, n_p_coarse)).tocsr()
    return P2, P3


def spectral_coarsen_darcy_chain(shape, factors, coeff, h=None,
                                 l2_weight=None, spect_tol=0.002,
                                 max_evects=5, svd_tol=1e-9,
                                 kcap2=None, dtype=np.float64,
                                 chunk=8192, spot_check=3, device=None):
    """Multilevel spectral Hdiv-L2 coarsening on `device` (None: the
    card): `factors` is a list of per-axis factor triples, one per
    coarsening step (reference: recursive Coarsen() with per-level
    spectral targets, DeRhamSequence.cpp:572-692).  Returns (levels,
    outs): the BlockLevel chain and the per-step BlockLevelOut (host
    CSR P2/P3 in each level's compressed numbering)."""
    lvl = fine_block_level(shape, coeff, h=h, l2_weight=l2_weight,
                           dtype=dtype, device=device)
    levels, outs = [lvl], []
    for f in factors:
        out = coarsen_block_level(lvl, tuple(f), spect_tol=spect_tol,
                                  max_evects=max_evects,
                                  svd_tol=svd_tol, kcap2=kcap2,
                                  chunk=chunk, spot_check=spot_check)
        outs.append(out)
        lvl = out.next_level
        levels.append(lvl)
    return levels, outs
