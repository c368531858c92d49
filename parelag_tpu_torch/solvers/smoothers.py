"""Smoothers for the AMGe hierarchy (PyTorch).

Counterpart of parelag_tpu/solvers/smoothers.py; ported so far:

  * l1-Jacobi  — x += omega * r / d with d_i = sum_j |a_ij| (hypre's l1
                 variant, reference ParELAG_HypreSmootherFactory.cpp:
                 73-84).  On a DIA operator its sweeps run as fused
                 kernels (DiaMatrix.jacobi_sweeps).
  * Chebyshev  — degree-k polynomial in D^{-1}A over [ratio * lmax,
                 lmax], lmax from a seeded host power iteration (hypre's
                 Chebyshev); its residuals b - A x run the level's SpMV
                 (dia_spmv on a DIA level).
  * block Jacobi — x += omega * B^{-1} (b - A x) with B^{-1} a
                 BlockDiagInverse (the facet blocks of the hybridized
                 multiplier system, amge/hybridization.py).
  * Hiptmair   — primary smoother + potential-space smoothing through D:
                 x += D S_aux(D^T r) (reference ParELAG_HiptmairSmoother.
                 hpp:25-90), the H(curl) smoother of the Maxwell lane; its
                 D, D^T and A_aux are ELL matrices (hopper_kernels.
                 ell_spmv on the card).

Every smoother takes b and x of shape (n,) or (n, s).
"""

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops.device_sparse import from_scipy, l1_row_weights


class L1JacobiSmoother(nn.Module):
    def __init__(self, dinv, sweeps=1, omega=1.0):
        super().__init__()
        self.register_buffer("dinv", dinv)
        self.sweeps = int(sweeps)
        self.omega = float(omega)

    def _d(self, b):
        return self.dinv if b.ndim == 1 else self.dinv[:, None]

    def apply(self, A, b, x):
        fused = self._fused(A, b, x, self.sweeps)
        if fused is not None:
            return fused
        d = self._d(b)
        for _ in range(self.sweeps):
            x = x + self.omega * d * (b - A @ x)
        return x

    def apply_zero(self, A, b):
        """Smooth from a known-zero initial guess (saves one SpMV)."""
        d = self._d(b)
        x = self.omega * d * b
        if self.sweeps > 1:
            fused = self._fused(A, b, x, self.sweeps - 1)
            if fused is not None:
                return fused
        for _ in range(self.sweeps - 1):
            x = x + self.omega * d * (b - A @ x)
        return x

    def _fused(self, A, b, x, sweeps):
        """Fused DIA sweeps (one kernel launch per sweep); None -> the
        caller takes the generic path."""
        if sweeps <= 0 or not hasattr(A, "jacobi_sweeps"):
            return None
        return A.jacobi_sweeps(b, x, self.omega * self.dinv, sweeps)


def make_l1_jacobi(A_scipy, sweeps=1, omega=1.0,
                   device=None) -> L1JacobiSmoother:
    d = l1_row_weights(A_scipy)
    d = np.where(d > 0, d, 1.0)
    return L1JacobiSmoother(
        torch.as_tensor(1.0 / d).to(resolve_device(device)), sweeps, omega)


class ChebyshevSmoother(nn.Module):
    """Chebyshev over [lmin, lmax] of D^{-1}A (hypre-style); coeffs =
    (lmin, lmax, degree), host floats.  dinv is a buffer, so
    Hierarchy.cast casts it as it casts l1-Jacobi's weights."""

    def __init__(self, dinv, coeffs):
        super().__init__()
        self.register_buffer("dinv", dinv)
        self.coeffs = tuple(coeffs)

    def apply(self, A, b, x):
        """x is cast to b's dtype first, as DiaMatrix.jacobi_sweeps casts
        it (a bf16 cycle's correction P @ e arrives in f32, and the DIA
        kernels take one dtype)."""
        lmin, lmax, degree = self.coeffs
        x = x.to(b.dtype)
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - A @ x)
        d = r / theta
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            x = x + d
            r = dinv * (b - A @ x)
            d = rho_new * rho * d + 2.0 * rho_new / delta * r
            rho = rho_new
        return x + d


def estimate_lmax(A_scipy, dinv, iters=20, seed=0):
    """Power iteration for lambda_max(D^{-1} A) on the host, from
    RandomState(seed).rand."""
    rng = np.random.RandomState(seed)
    n = A_scipy.shape[0]
    x = rng.rand(n)
    A = sp.csr_matrix(A_scipy)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def make_chebyshev(A_scipy, degree=3, ratio=0.3,
                   device=None) -> ChebyshevSmoother:
    d = sp.csr_matrix(A_scipy).diagonal()
    d = np.where(d > 0, d, 1.0)
    dinv = 1.0 / d
    lmax = 1.1 * estimate_lmax(A_scipy, dinv)
    return ChebyshevSmoother(
        torch.as_tensor(dinv).to(resolve_device(device)),
        (ratio * lmax, lmax, degree))


class BlockJacobiSmoother(nn.Module):
    """Damped block-Jacobi smoother over a block-contiguous permuted
    system (the facet supervariables of the hybridized multiplier
    system, amge.hybridization._facet_blocks; point smoothers are
    near-singular on the spectral coarse multiplier systems).  `binv`
    is an ops.device_sparse.BlockDiagInverse."""

    def __init__(self, binv, sweeps=1, omega=0.7):
        super().__init__()
        self.binv = binv
        self.sweeps = int(sweeps)
        self.omega = float(omega)

    def apply(self, A, b, x):
        for _ in range(self.sweeps):
            x = x + self.omega * (self.binv @ (b - A @ x))
        return x

    def apply_zero(self, A, b):
        x = self.omega * (self.binv @ b)
        for _ in range(self.sweeps - 1):
            x = x + self.omega * (self.binv @ (b - A @ x))
        return x


class HiptmairSmoother(nn.Module):
    """Two-space smoother: primary on A, auxiliary on A_aux = D^T A D
    through the potential space (reference ParELAG_HiptmairSmoother.hpp).
    D maps potentials to forms (the gradient for H(curl))."""

    def __init__(self, primary, aux, D, Dt, A_aux):
        super().__init__()
        self.primary, self.aux = primary, aux
        self.D, self.Dt, self.A_aux = D, Dt, A_aux

    def apply(self, A, b, x):
        # forward: primary, then the auxiliary-space correction
        x = self.primary.apply(A, b, x)
        r = b - A @ x
        raux = self.Dt @ r
        eaux = self.aux.apply(self.A_aux, raux, torch.zeros_like(raux))
        x = x + self.D @ eaux
        return self.primary.apply(A, b, x)


def aux_operator(A_scipy, D_scipy):
    """Host CSR of Hiptmair's auxiliary operator D^T A D, with a unit
    diagonal on its empty rows (e.g. eliminated-BC potentials)."""
    D = sp.csr_matrix(D_scipy)
    A_aux = (D.T @ sp.csr_matrix(A_scipy) @ D).tocsr()
    fix = np.where(np.asarray(np.abs(A_aux).sum(axis=1)).ravel() == 0)[0]
    if fix.size:
        A_aux = (A_aux + sp.csr_matrix(
            (np.ones(fix.size), (fix, fix)), shape=A_aux.shape)).tocsr()
    return A_aux


def make_hiptmair(A_scipy, D_scipy, primary_sweeps=1, aux_sweeps=1,
                  dtype=None, device=None) -> HiptmairSmoother:
    """Hiptmair smoother of A with the potential derivative D.  dtype
    casts A and D first, so every part is built in it (the JAX package
    leaves that to the backend, f32 on the TPU); None keeps the inputs'
    dtypes as the JAX make_hiptmair does.  device=None puts it on the
    card."""
    device = resolve_device(device)
    A = sp.csr_matrix(A_scipy)
    D = sp.csr_matrix(D_scipy)
    if dtype is not None:
        A, D = A.astype(dtype), D.astype(dtype)
    A_aux = aux_operator(A, D)
    if dtype is not None:
        A_aux = A_aux.astype(dtype)
    return HiptmairSmoother(
        primary=make_l1_jacobi(A, sweeps=primary_sweeps, device=device),
        aux=make_l1_jacobi(A_aux, sweeps=aux_sweeps, device=device),
        D=from_scipy(D, device=device),
        Dt=from_scipy(D.T.tocsr(), device=device),
        A_aux=from_scipy(A_aux, device=device))
