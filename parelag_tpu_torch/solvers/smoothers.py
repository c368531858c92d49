"""Smoothers for the AMGe hierarchy (PyTorch).

Counterpart of parelag_tpu/solvers/smoothers.py; this slice ports the
l1-Jacobi smoother, x += omega * r / d with d_i = sum_j |a_ij| (hypre's
l1 variant, reference ParELAG_HypreSmootherFactory.cpp:73-84).  On a DIA
operator its sweeps run as fused kernels (DiaMatrix.jacobi_sweeps).
"""

import numpy as np
import torch
from torch import nn

from parelag_tpu_torch.ops.device_sparse import l1_row_weights


class L1JacobiSmoother(nn.Module):
    def __init__(self, dinv, sweeps=1, omega=1.0):
        super().__init__()
        self.register_buffer("dinv", dinv)
        self.sweeps = int(sweeps)
        self.omega = float(omega)

    def apply(self, A, b, x):
        fused = self._fused(A, b, x, self.sweeps)
        if fused is not None:
            return fused
        for _ in range(self.sweeps):
            x = x + self.omega * self.dinv * (b - A @ x)
        return x

    def apply_zero(self, A, b):
        """Smooth from a known-zero initial guess (saves one SpMV)."""
        x = self.omega * self.dinv * b
        if self.sweeps > 1:
            fused = self._fused(A, b, x, self.sweeps - 1)
            if fused is not None:
                return fused
        for _ in range(self.sweeps - 1):
            x = x + self.omega * self.dinv * (b - A @ x)
        return x

    def _fused(self, A, b, x, sweeps):
        """Fused DIA sweeps (one kernel launch per sweep); None -> the
        caller takes the generic path."""
        if sweeps <= 0 or not hasattr(A, "jacobi_sweeps"):
            return None
        return A.jacobi_sweeps(b, x, self.omega * self.dinv, sweeps)


def make_l1_jacobi(A_scipy, sweeps=1, omega=1.0,
                   device="cpu") -> L1JacobiSmoother:
    d = l1_row_weights(A_scipy)
    d = np.where(d > 0, d, 1.0)
    return L1JacobiSmoother(torch.as_tensor(1.0 / d).to(device), sweeps,
                            omega)
