"""Plain reference for the H1 structured configurations.

The problem, worked out from the grid alone: Q1 finite elements on an
n^3 grid of [0,1]^3 (vertex values, x fastest, then y, then z), the
operator K + M (stiffness plus mass, exactly integrated), zero Dirichlet
values on the x and y walls, eliminated symmetrically with the
diagonal kept on the eliminated rows (mfem's EliminateRowCol).  On a
uniform grid K and M are sums of Kronecker products of the 1D P1
matrices, so the operator is applied axis by axis as three-point
stencils: no assembled matrix, no matrix product (and so no TF32).

judge() holds the solution of every judged call against this operator:
||b - A x|| / ||b|| in float64, column by column.  solve() is the same
operator under Jacobi-preconditioned CG in any dtype; the control runs
it in the precision below the configuration's.

Imports torch and numpy only: nothing of the program.
"""

import numpy as np
import torch


def line_stencils(n):
    """The 1D P1 stiffness and mass on n cells of [0, 1] as (diagonal
    (n+1,), off-diagonal value) pairs, in float64."""
    h = 1.0 / n
    ends = np.ones(n + 1)
    ends[1:-1] = 2.0
    return (ends / h, -1.0 / h), (ends * h / 3.0, h / 6.0)


class Operator:
    """A = K + M on the n^3 grid with the x and y walls eliminated, on
    `device` in `dtype`; apply() takes (N,) or (N, s)."""

    def __init__(self, n, device, dtype=torch.float64):
        self.n, self.device, self.dtype = n, device, dtype
        (kd, ko), (md, mo) = line_stencils(n)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.k, self.m = (t(kd), ko), (t(md), mo)
        dk, dm = kd, md
        diag = (np.einsum("z,y,x->zyx", dk, dm, dm)
                + np.einsum("z,y,x->zyx", dm, dk, dm)
                + np.einsum("z,y,x->zyx", dm, dm, dk)
                + np.einsum("z,y,x->zyx", dm, dm, dm))
        wall = np.zeros((n + 1,) * 3, dtype=bool)
        wall[:, :, 0] = wall[:, :, n] = True
        wall[:, 0, :] = wall[:, n, :] = True
        self.diag = t(diag)
        self.wall = torch.as_tensor(wall, device=device)
        self.free = (~self.wall).to(dtype)

    @staticmethod
    def _line(X, stencil, axis):
        """The three-point stencil (diagonal, off) along `axis` of X."""
        d, o = stencil
        shape = [1] * X.ndim
        shape[axis] = -1
        Y = X * d.view(shape)
        lo = [slice(None)] * X.ndim
        hi = [slice(None)] * X.ndim
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        Y[tuple(lo)] += o * X[tuple(hi)]
        Y[tuple(hi)] += o * X[tuple(lo)]
        return Y

    def _grid(self, v):
        """(N,) or (N, s) -> (s, n+1, n+1, n+1) in self.dtype."""
        n1 = self.n + 1
        v = v.to(self.dtype)
        return (v[None] if v.ndim == 1 else v.T).reshape(-1, n1, n1, n1)

    @staticmethod
    def _flat(X, like):
        X = X.reshape(X.shape[0], -1)
        return X[0] if like.ndim == 1 else X.T

    def apply(self, v):
        X = self._grid(v)
        Xf = X * self.free
        U = self._line(Xf, self.m, 3)
        V = self._line(Xf, self.k, 3)
        W1 = self._line(U + V, self.m, 2) + self._line(U, self.k, 2)
        W2 = self._line(U, self.m, 2)
        Y = self._line(W1, self.m, 1) + self._line(W2, self.k, 1)
        Y = Y * self.free + self.diag * self.wall.to(self.dtype) * X
        return self._flat(Y, v)

    def dinv(self, like):
        d = self._flat(self.diag[None].expand(
            1 if like.ndim == 1 else like.shape[1], -1, -1, -1), like)
        return 1.0 / d


def residuals(n, b, x, device):
    """||b - A x|| / ||b|| per column, float64 (a list)."""
    A = Operator(n, device)
    b64 = b.to(device=device, dtype=torch.float64)
    r = b64 - A.apply(x.to(device=device, dtype=torch.float64))
    num = torch.linalg.vector_norm(r.reshape(r.shape[0], -1), dim=0)
    den = torch.linalg.vector_norm(b64.reshape(b64.shape[0], -1), dim=0)
    return (num / den).tolist()


def judge(config, samples, device):
    """samples: [{"b": b, "x": x}, ...], the judged calls' right-hand
    sides and the program's solutions.  Returns {"res_max": the largest
    relative residual over every column of every sample}."""
    n = int(config["cells_per_axis"])
    worst = 0.0
    for s in samples:
        worst = max([worst] + residuals(n, s["b"], s["x"], device))
    return {"res_max": worst}


def solve(config, b, device, dtype, maxiter=1000):
    """Jacobi-preconditioned CG on A in `dtype`, every column to the
    configuration's rtol (||r|| <= rtol ||b||) or maxiter steps; returns
    each column's iterate of least recurrence residual, so that a run
    that stalls in a low precision still gives its best answer."""
    n = int(config["cells_per_axis"])
    rtol = float(config["rtol"])
    A = Operator(n, device, dtype)
    b = b.to(device=device, dtype=dtype)
    dinv = A.dinv(b)
    dot = lambda u, v: torch.sum(u * v, dim=0)
    safe = lambda v: torch.where(v != 0, v, torch.ones_like(v))
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z.clone()
    rz = dot(r, z)
    nb = torch.linalg.vector_norm(b.float(), dim=0)
    best_x, best_r = x.clone(), nb.clone()
    for _ in range(maxiter):
        Ap = A.apply(p)
        alpha = rz / safe(dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        nr = torch.linalg.vector_norm(r.float(), dim=0)
        better = nr < best_r
        best_x = torch.where(better, x, best_x)
        best_r = torch.where(better, nr, best_r)
        if bool(torch.all(best_r <= rtol * nb)):
            break
        z = dinv * r
        rz_new = dot(r, z)
        p = z + (rz_new / safe(rz)) * p
        rz = rz_new
    return best_x
