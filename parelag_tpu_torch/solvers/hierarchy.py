"""Multigrid hierarchy and V/W(mu)-cycle (PyTorch).

Counterpart of parelag_tpu/solvers/hierarchy.py (reference Hierarchy,
ParELAG_Hierarchy.hpp:28-114, .cpp:109-253): pre-smooth -> residual ->
restrict -> recurse (mu times) -> interpolate + correct -> post-smooth;
the coarsest level applies a dense inverse.  Levels are nn.Modules with
registered buffers, so `Hierarchy.cast(torch.bfloat16)` rides
`Module.to(dtype)` (floating buffers only) and keeps the coarse inverse
in full precision.  build_hierarchy(reorder="rcm") permutes every level
by reverse Cuthill-McKee and keeps level 0's permutation as the
Hierarchy's perm / iperm index buffers.
"""

import copy

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops.device_sparse import (
    BC, BR, as_torch_dtype, bcsr_stats, dia_n_offsets, from_scipy, to_bcsr,
    to_dia)


class Level(nn.Module):
    """One level: operator A, transfers P (from the next coarser level)
    and R = P^T, smoothers pre/post, or the dense coarse_inv at the
    coarsest level (then P, R, pre and post are None)."""

    def __init__(self, A, P=None, R=None, pre=None, post=None,
                 coarse_inv=None):
        super().__init__()
        self.A, self.P, self.R = A, P, R
        self.pre, self.post = pre, post
        self.register_buffer("coarse_inv", coarse_inv)


class Hierarchy(nn.Module):
    """Levels finest first.  perm / iperm (int64 index tensors, or None):
    level 0's dof reordering (RCM); the hierarchy then works in permuted
    space, b' = b[perm] in and x = x'[iperm] out (amge_pcg_solve)."""

    def __init__(self, levels, mu=1, perm=None, iperm=None):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.mu = int(mu)            # 1 = V-cycle, 2 = W-cycle
        self.register_buffer("perm", perm)
        self.register_buffer("iperm", iperm)

    def cycle(self, b, x=None):
        if not b.is_floating_point():
            b = b.to(self.levels[0].A.dtype)
        if x is None:
            return _cycle(self.levels, 0, b, torch.zeros_like(b), self.mu,
                          x_is_zero=True)
        return _cycle(self.levels, 0, b, x, self.mu)

    def apply(self, b):
        """One cycle from a zero guess — the preconditioner; b (n,) or
        (n, s) (s right-hand sides at once)."""
        return self.cycle(b)

    def cast(self, dtype, keep_coarse_inv=True):
        """A copy with every floating buffer cast to `dtype` (e.g.
        torch.bfloat16: the preconditioner tolerates low precision and
        the SpMVs are bytes-bound).  The coarse dense inverse keeps its
        precision by default: it is small and its conditioning matters
        most; keep_coarse_inv=False casts it too (every buffer in one
        dtype, as build_device_sa_hierarchy asks).  (Module.to casts in
        place, hence the copy.)"""
        new = copy.deepcopy(self).to(as_torch_dtype(dtype))
        if keep_coarse_inv:
            for lvl, old in zip(new.levels, self.levels):
                if old.coarse_inv is not None:
                    lvl.coarse_inv = old.coarse_inv
        return new


def level_operators(H):
    """The operators a cycle of H applies, as (label, operator) in level
    order: A_l, P_l and R_l of every level above the coarsest (whose
    dense inverse stands in for its A), each in the format the build
    gave it."""
    out = []
    for l, lvl in enumerate(H.levels):
        if lvl.coarse_inv is None:
            out += [(f"A{l}", lvl.A), (f"P{l}", lvl.P), (f"R{l}", lvl.R)]
    return out


def _cycle(levels, l, b, x, mu, x_is_zero=False):
    lvl = levels[l]
    if lvl.coarse_inv is not None:
        dt = torch.promote_types(lvl.coarse_inv.dtype, b.dtype)
        return lvl.coarse_inv.to(dt) @ b.to(dt)
    if x_is_zero and hasattr(lvl.pre, "apply_zero"):
        x = lvl.pre.apply_zero(lvl.A, b)
    else:
        x = lvl.pre.apply(lvl.A, b, x)
    r = b - lvl.A @ x
    rc = lvl.R @ r
    ec = torch.zeros((lvl.R.shape[0],) + tuple(b.shape[1:]),
                     dtype=b.dtype, device=b.device)
    first = True
    for _ in range(mu):
        ec = _cycle(levels, l + 1, rc, ec, mu, x_is_zero=first)
        first = False
    x = x + lvl.P @ ec
    return lvl.post.apply(lvl.A, b, x)


def transfer_format(device, matrix_format="auto"):
    """The format of P and R on `device`: "bcsr" on the card (the
    bcsr_spmv kernel streams the nonzeros in row order), "ell" on the
    CPU or when matrix_format asks for it.  The JAX package picks among
    BCSR, TileCoo and ELL by its 8 x 128 tile counts, because its BCSR
    pads every row block to the densest one; the port's BcsrMatrix
    stores no tiles, so that rule has no reason here (on the 64^3 darcy
    SA chain it made R0 a ~1 GB TileCoo and P0 an ELL matrix)."""
    if matrix_format == "ell" or torch.device(device).type == "cpu":
        return "ell"
    return "bcsr"


#: a_format keeps ELL only while the padded table holds at most this
#: many slots a nonzero (the SA and AMGe levels the rule keeps in ELL
#: hold 1.03-1.56; the ho_p2 A0 holds 3.45: 343 slots for 99.5 a row)
ELL_MAX_FILL = 2.0


def a_format(shape, nnz, k, itemsize, tiles):
    """The format of an operator A on the card, from its shape, stored
    nonzeros, longest row k, value bytes and `tiles`, the JAX package's
    8 x 128 tile count (ops/device_sparse.bcsr_stats: nbr * kb).  An ELL
    table of more than ELL_MAX_FILL slots a nonzero goes to BCSR, which
    stores the nonzeros only: the padding streams more than ELL's
    regular rows save (ROADMAP C3: the ho_p2 A0 as a 343-slot table took
    2.3-3.1x the CSR library call).  A table within that bound keeps the
    format the port took before the bound and measured since, the JAX
    package's tile test (BCSR while its tile array stays under 2^29
    bytes and 128 x the nonzeros, else ELL): no size or fill threshold
    alone reproduces it, since the same matrices take ELL in f64 and BCSR
    in f32 there, and Maxwell's BCSR A0 is as large as the library's ELL
    A1."""
    if shape[0] * k > ELL_MAX_FILL * max(nnz, 1):
        return "bcsr"
    slots = tiles * BR * BC
    if slots * itemsize <= (1 << 29) and slots <= 128 * max(nnz, 1):
        return "bcsr"
    return "ell"


def rcm_permute(A_scipy_levels, P_scipy_levels):
    """Reverse Cuthill-McKee on every level (the JAX build_hierarchy's
    reorder="rcm"): returns the permuted A_l[p_l][:, p_l], the permuted
    P_l[p_l][:, p_{l+1}] and the permutations p_l."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    perms, A_out = [], []
    for A in A_scipy_levels:
        A = sp.csr_matrix(A)
        p = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        perms.append(p)
        A_out.append(A[p][:, p])
    P_out = [sp.csr_matrix(P)[perms[l]][:, perms[l + 1]]
             for l, P in enumerate(P_scipy_levels)]
    return A_out, P_out, perms


def build_hierarchy(A_scipy_levels, P_scipy_levels, smoother_factory,
                    mu=1, dtype=np.float64, matrix_format="auto",
                    reorder=None, transfer_dtype=None,
                    device=None) -> Hierarchy:
    """Assemble a device Hierarchy from host sparse matrices.

    A_scipy_levels: [A_0, ..., A_L]; P_scipy_levels: [P_0, ..., P_{L-1}];
    smoother_factory(A_scipy, level) -> smoother module (given the
    permuted A under reorder).  matrix_format for A: "dia" (DIA while a
    level has at most 48 offsets, else "auto"), "bcsr", "ell" or "auto"
    (ELL on the CPU, a_format's rule on the card).  The transfer format
    is transfer_format's: BCSR on the card, ELL on the CPU.
    reorder="rcm": rcm_permute every level; the Hierarchy carries level
    0's perm / iperm.  device=None builds on the card."""
    device = resolve_device(device)
    if reorder not in (None, "rcm"):
        raise ValueError(f"reorder={reorder!r} (need None or 'rcm')")
    on_cpu = device.type == "cpu"

    def to_dev_transfer(M):
        M = sp.csr_matrix(M)
        tdt = transfer_dtype if transfer_dtype is not None else dtype
        if transfer_format(device, matrix_format) == "bcsr":
            return to_bcsr(M, dtype=tdt, device=device)
        return from_scipy(M, dtype=tdt, device=device)

    def to_dev(M):
        M = sp.csr_matrix(M)
        fmt = matrix_format
        if fmt == "dia":
            # gather-free shift SpMV while the offset count stays small
            # (the 27-diagonal lexicographic grid); coarse RAP levels that
            # are not banded fall through to the "auto" rule
            nd = dia_n_offsets(M)
            if (nd <= 48 and nd * max(M.shape)
                    * np.dtype(dtype).itemsize <= (1 << 30)):
                return to_dia(M, dtype=dtype, device=device)
            fmt = "auto"
        if fmt == "auto" and on_cpu:
            fmt = "ell"
        elif fmt == "auto":
            # the tile counts of the nonzeros to_bcsr would keep
            Mz = sp.csr_matrix(M, copy=True)
            Mz.sum_duplicates()
            Mz.eliminate_zeros()
            nbr, kb, _ = bcsr_stats(Mz)
            fmt = a_format(M.shape, M.nnz,
                           int(np.diff(M.indptr).max(initial=0)),
                           np.dtype(dtype).itemsize, nbr * kb)
        if fmt == "bcsr":
            return to_bcsr(M, dtype=dtype, device=device)
        return from_scipy(M, dtype=dtype, device=device)

    perm0 = iperm0 = None
    if reorder == "rcm":
        A_scipy_levels, P_scipy_levels, perms = rcm_permute(
            A_scipy_levels, P_scipy_levels)
        inv = np.empty_like(perms[0])
        inv[perms[0]] = np.arange(perms[0].size)
        perm0 = torch.as_tensor(perms[0].astype(np.int64)).to(device)
        iperm0 = torch.as_tensor(inv.astype(np.int64)).to(device)

    n_lev = len(A_scipy_levels)
    levels = []
    for l in range(n_lev):
        A = A_scipy_levels[l]
        if l == n_lev - 1:
            if A.shape[0] > 16384:
                # a dense inverse here is O(n^2) memory / O(n^3) flops:
                # the coarsening chain stalled or coarse_size is wrong
                raise RuntimeError(
                    f"coarsest level has {A.shape[0]} rows — too large "
                    "for a dense coarse inverse; the coarsening chain "
                    "stalled or coarse_size is misconfigured")
            Ainv = np.linalg.inv(A.toarray())
            levels.append(Level(
                A=to_dev(A), coarse_inv=torch.as_tensor(
                    Ainv.astype(dtype)).to(device)))
        else:
            P = sp.csr_matrix(P_scipy_levels[l])
            sm = smoother_factory(A, l).to(device)
            levels.append(Level(
                A=to_dev(A), P=to_dev_transfer(P),
                R=to_dev_transfer(P.T.tocsr()), pre=sm, post=sm))
    return Hierarchy(levels, mu, perm0, iperm0)


def rap(A, P):
    """Coarse operator P^T A P with the zero-row fix for eliminated BC
    rows (reference ParELAG_Hierarchy.cpp:366-371 +
    hypre_ParCSRMatrixFixZeroRows)."""
    A = sp.csr_matrix(A)
    P = sp.csr_matrix(P)
    Ac = (P.T @ A @ P).tocsr()
    rowsum = np.asarray(np.abs(Ac).sum(axis=1)).ravel()
    zero = np.where(rowsum < 1e-14)[0]
    if zero.size:
        Ac = (Ac + sp.csr_matrix(
            (np.ones(zero.size), (zero, zero)), shape=Ac.shape)).tocsr()
    return Ac
