"""Blocked saddle-point multigrid: the Darcy AMGe solver (PyTorch).

Counterpart of parelag_tpu/solvers/block.py (reference
buildBlockedHierarchyFromDeRhamSequence, ParELAG_Hierarchy.cpp:397+,
MonolithicBlockedOperatorFactory, and the Block-Jacobi/GS smoothers of
the sample XML GMRES-AMGe-BlkJacobi-GS-AMG): each level holds the
monolithic saddle operator

    A_l = [ M_l  B_l^T ]      B_l = W_l D_l,  C_l = w W_l (>= 0)
          [ B_l  -C_l  ]

with block-diagonal transfers diag(P_u, P_p); the smoother is an inexact
Uzawa sweep with l1-Jacobi approximations of M and of the explicit
Schur complement S = B diag(M)^{-1} B^T + C.  The levels are ELL
matrices (from_scipy: the ell_spmv kernel on the card) in a
solvers/hierarchy.Hierarchy, and the V-cycle preconditions GMRES
(solvers/cg.gmres).  monolithic_saddle is the JAX package's, copied.
"""

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.ops.device_sparse import from_scipy
from parelag_tpu_torch.solvers.hierarchy import Hierarchy, Level


class BlockSaddleSmoother(nn.Module):
    """Inexact-Uzawa sweeps on [M B^T; B -C] (symmetrizable variant of the
    reference's Block Jacobi/GS smoother with diagonal Schur
    approximation, ParELAG_SchurComplementFactory.cpp): the first n0
    rows are the flux block.  Returns a new x; the input is not
    overwritten."""

    def __init__(self, n0, m_dinv, s_dinv, sweeps, omega):
        super().__init__()
        self.n0 = int(n0)
        self.register_buffer("m_dinv", m_dinv)      # l1 weights of M
        self.register_buffer("s_dinv", s_dinv)      # l1 weights of S
        self.sweeps = int(sweeps)
        self.omega = float(omega)

    def apply(self, A, b, x):
        n0 = self.n0
        x = x.clone()
        for _ in range(self.sweeps):
            r = b - A @ x
            x[:n0] += self.omega * hk._rows(self.m_dinv, r) * r[:n0]
            r = b - A @ x
            # Schur sign: after eliminating u the p-block is -(S);
            # descend along -S^{-1} r_p
            x[n0:] -= self.omega * hk._rows(self.s_dinv, r) * r[n0:]
        return x


def monolithic_saddle(M, B, C=None) -> sp.csr_matrix:
    """[[M, B^T], [B, -C]] as one sparse matrix
    (MonolithicBlockedOperatorFactory analog)."""
    Cblk = None if C is None else (-sp.csr_matrix(C))
    return sp.bmat([[M, B.T], [B, Cblk]], format="csr")


def build_darcy_amge_hierarchy(seqs, w_weight=0.0, sweeps=2, omega=0.8,
                               dtype=np.float64, mu=1, device=None):
    """Blocked AMGe hierarchy for the Darcy saddle problem over a
    DeRhamSequence chain, on `device` (None: the card): ELL operators
    and transfers (from_scipy), BlockSaddleSmoother on every level but
    the coarsest, a dense inverse there.  Returns (Hierarchy, A_levels,
    n0s) with the host CSR levels and each level's flux-block size."""
    device = resolve_device(device)
    dim = seqs[0].dim
    uform, pform = dim - 1, dim
    n_lev = len(seqs)

    A_levels, n0s = [], []
    for s in seqs:
        M = s.compute_mass_operator(uform)
        W = s.compute_mass_operator(pform)
        B = (W @ s.D[uform]).tocsr()
        C = (w_weight * W) if w_weight != 0 else None
        A_levels.append(monolithic_saddle(M, B, C))
        n0s.append(M.shape[0])

    def vec(v):
        return torch.as_tensor(v.astype(dtype)).to(device)

    levels = []
    for l in range(n_lev):
        A = A_levels[l]
        if l == n_lev - 1:
            Ainv = np.linalg.inv(A.toarray())
            levels.append(Level(A=from_scipy(A, dtype=dtype, device=device),
                                coarse_inv=vec(Ainv)))
            continue
        n0 = n0s[l]
        M = A[:n0, :n0].tocsr()
        B = A[n0:, :n0].tocsr()
        C = (-A[n0:, n0:]).tocsr()
        dM = np.asarray(np.abs(M).sum(axis=1)).ravel()
        S = (B @ sp.diags(1.0 / M.diagonal()) @ B.T + C).tocsr()
        dS = np.asarray(np.abs(S).sum(axis=1)).ravel()
        sm = BlockSaddleSmoother(
            n0, vec(1.0 / np.where(dM > 0, dM, 1.0)),
            vec(1.0 / np.where(dS > 0, dS, 1.0)), sweeps, omega)
        P = sp.block_diag([seqs[l].P[uform], seqs[l].P[pform]],
                          format="csr")
        levels.append(Level(
            A=from_scipy(A, dtype=dtype, device=device),
            P=from_scipy(P, dtype=dtype, device=device),
            R=from_scipy(P.T.tocsr(), dtype=dtype, device=device),
            pre=sm, post=sm))
    return Hierarchy(levels, mu), A_levels, n0s


def darcy_gmres_solve(H, A_scipy, b, rtol=1e-6, restart=50,
                      max_restarts=40, dtype=np.float64):
    """GMRES with one blocked V-cycle as right preconditioner (the
    GMRES-AMGe composition of the reference's darcy XML), on the device
    that holds H.  A_scipy is unused, as in the JAX version: the
    operator is H's level 0.  Returns (x as numpy, (cycles, ||b - A x||)).
    """
    A0 = H.levels[0].A
    bt = torch.as_tensor(np.asarray(b, dtype=dtype)).to(A0.values.device)
    from parelag_tpu_torch.solvers.cg import gmres
    x, (it, res) = gmres(A0.matvec, bt, precond=H.apply, rtol=rtol,
                         restart=restart, max_restarts=max_restarts)
    return x.cpu().numpy(), (int(it), float(res))
