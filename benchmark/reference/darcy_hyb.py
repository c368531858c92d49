"""Plain reference for the mixed Darcy configurations.

The problem, worked out from the grid alone: lowest-order
Raviart-Thomas fluxes u and piecewise-constant pressures p on an n^3
grid of [0,1]^3 with unit permeability and natural (zero) pressure
boundary values,

    M u + B^T p = 0,    B u = f,

M the RT0 mass and B the signed cell-face incidence (net outflow of a
cell), f the cell sources times the cell volume.  On a uniform grid M
couples only the two faces of a cell across one axis, so each axis's
fluxes form lines of n + 1 faces with the same tridiagonal matrix:
(1/h) [1/3 1/6; 1/6 1/3] per cell, in fluxes along +axis.

The program reports u in its own face numbering and orientation, a
rule of the mesh alone: faces are numbered in the lexicographic order
of their sorted vertex ids (vertex ix + (n+1) iy + (n+1)^2 iz), and a
face's flux is taken along the outward normal of the first cell, in
cell order (ix fastest), that holds it: +axis, except on the faces of
the planes x = 0, y = 0, z = 0, where it is -axis.  Cells are numbered
ix fastest, then iy, then iz.

judge() holds every judged (u, p) against both equations in float64.
solve() is the same problem by CG on the Schur complement B M^-1 B^T
(M^-1 exact, line by line) in any dtype; the control runs it in the
precision below the configuration's.

Imports torch and numpy only: nothing of the program.
"""

import numpy as np
import torch


def face_numbering(n):
    """(order, sign): for each face in axis order (x faces as an
    (n, n, n+1) [z, y, x-plane] array, then y faces (n, n+1, n), then z
    faces (n+1, n, n), each raveled), its index in the program's
    numbering and the sign that turns the program's flux into the flux
    along +axis."""
    n1 = n + 1
    vid = lambda ix, iy, iz: ix + n1 * (iy + n1 * iz)
    keys, signs = [], []
    for axis in range(3):
        shape = [n, n, n]                  # z, y, x
        shape[2 - axis] = n1
        iz, iy, ix = np.meshgrid(*[np.arange(s) for s in shape],
                                 indexing="ij")
        corners = []
        for a in (0, 1):
            for c in (0, 1):
                d = [0, 0, 0]                      # x, y, z offsets
                others = [k for k in range(3) if k != axis]
                d[others[0]], d[others[1]] = a, c
                corners.append(vid(ix + d[0], iy + d[1], iz + d[2]))
        keys.append(np.sort(np.stack([k.ravel() for k in corners], 1), 1))
        plane = (ix, iy, iz)[axis].ravel()
        signs.append(np.where(plane == 0, -1.0, 1.0))
    keys = np.concatenate(keys)
    rank = np.lexsort(keys.T[::-1])
    order = np.empty_like(rank)
    order[rank] = np.arange(rank.size)
    return order, np.concatenate(signs)


class Problem:
    """The operators of the n^3 problem on `device` in `dtype`, acting
    on fluxes in axis order along +axis (ux (n, n, n+1), uy (n, n+1,
    n), uz (n+1, n, n)) and pressures (n, n, n) [z, y, x]."""

    def __init__(self, n, device, dtype=torch.float64):
        self.n, self.device, self.dtype = n, device, dtype
        h = 1.0 / n
        n1 = n + 1
        d = np.full(n1, 2.0 / 3.0)
        d[0] = d[-1] = 1.0 / 3.0
        T = (np.diag(d) + np.diag(np.full(n, 1.0 / 6.0), 1)
             + np.diag(np.full(n, 1.0 / 6.0), -1)) / h
        self.T = torch.as_tensor(T, dtype=dtype, device=device)
        self.Tinv = torch.as_tensor(np.linalg.inv(T), dtype=dtype,
                                    device=device)
        order, sign = face_numbering(n)
        self.order = torch.as_tensor(order, device=device)
        self.sign = torch.as_tensor(sign, dtype=dtype, device=device)
        self.shapes = [(n, n, n1), (n, n1, n), (n1, n, n)]

    def split(self, u):
        out, o = [], 0
        for s in self.shapes:
            k = int(np.prod(s))
            out.append(u[..., o:o + k].reshape(u.shape[:-1] + s))
            o += k
        return out

    def from_program(self, u):
        """The program's u (nu,) -> fluxes along +axis, axis order."""
        u = torch.as_tensor(u).to(device=self.device, dtype=self.dtype)
        return self.split(u[self.order] * self.sign)

    def _lines(self, F, axis, mat):
        """mat (n+1, n+1) along the face-plane axis of flux family
        `axis` (dims: z, y, x -> that family's axis 2 - axis)."""
        dim = 2 - axis
        return torch.movedim(torch.movedim(F, dim, -1) @ mat.T, -1, dim)

    def mass(self, U):
        return [self._lines(F, a, self.T) for a, F in enumerate(U)]

    def mass_inv(self, U):
        return [self._lines(F, a, self.Tinv) for a, F in enumerate(U)]

    def div(self, U):
        """B u: each cell's net outflow."""
        ux, uy, uz = U
        return ((ux[..., 1:] - ux[..., :-1]) + (uy[..., 1:, :] - uy[..., :-1, :])
                + (uz[..., 1:, :, :] - uz[..., :-1, :, :]))

    def div_t(self, P):
        """B^T p: on each face the pressure of the cell behind it minus
        the pressure of the cell ahead (zero outside)."""
        out = []
        for axis in range(3):
            dim = P.ndim - 1 - axis
            pad = [0, 0] * (P.ndim - 1 - dim) + [1, 1]
            Pp = torch.nn.functional.pad(P, pad)
            lo = [slice(None)] * P.ndim
            hi = [slice(None)] * P.ndim
            lo[dim], hi[dim] = slice(0, -1), slice(1, None)
            out.append(Pp[tuple(lo)] - Pp[tuple(hi)])
        return out


def _norm(parts):
    return float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in parts)))


def _ratio(num, den):
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def residuals(n, f, u, p, device):
    """(||M u + B^T p|| / ||B^T p||, ||B u - f|| / ||f||) in float64 for
    the program's u, p and the source f (cell order)."""
    pr = Problem(n, device)
    U = pr.from_program(u)
    P = torch.as_tensor(p).to(device=device, dtype=torch.float64).reshape(
        n, n, n)
    F = torch.as_tensor(f).to(device=device, dtype=torch.float64).reshape(
        n, n, n)
    BtP = pr.div_t(P)
    ru = [a + b for a, b in zip(pr.mass(U), BtP)]
    rp = pr.div(U) - F
    return _ratio(_norm(ru), _norm(BtP)), _ratio(_norm([rp]), _norm([F]))


def judge(config, samples, device):
    """samples: [{"f": rhs_p, "u": u, "p": p}, ...]: each judged call's
    source and the program's answer.  Returns the largest relative
    residual of either equation over the samples."""
    n = int(config["cells_per_axis"])
    worst = 0.0
    for s in samples:
        worst = max((worst,) + residuals(n, s["f"], s["u"], s["p"], device))
    return {"res_max": worst}


def solve(config, f, device, dtype, maxiter=5000):
    """CG on S p = -f, S = B M^-1 B^T, to ||S p + f|| <= rtol ||f|| or
    maxiter steps, in `dtype` (matrix products with TF32 off); u = -M^-1
    B^T p.  Returns (u, p) in the program's numbering and orientation,
    the iterate of least recurrence residual."""
    n = int(config["cells_per_axis"])
    rtol = float(config["rtol"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pr = Problem(n, device, dtype)
        F = torch.as_tensor(f).to(device=device, dtype=dtype).reshape(n, n, n)
        S = lambda P: pr.div(pr.mass_inv(pr.div_t(P)))
        P = torch.zeros_like(F)
        r = -F
        d = r.clone()
        rr = torch.sum(r * r)
        nf = float(torch.linalg.vector_norm(F.double()))
        best_P, best_r = P.clone(), nf
        for _ in range(maxiter):
            Sd = S(d)
            dSd = torch.sum(d * Sd)
            alpha = rr / torch.where(dSd != 0, dSd, torch.ones_like(dSd))
            P = P + alpha * d
            r = r - alpha * Sd
            nr = float(torch.linalg.vector_norm(r.double()))
            if nr < best_r:
                best_P, best_r = P.clone(), nr
            if best_r <= rtol * nf:
                break
            rr_new = torch.sum(r * r)
            d = r + (rr_new / torch.where(rr != 0, rr, torch.ones_like(rr))) * d
            rr = rr_new
        U = [-F_ for F_ in pr.mass_inv(pr.div_t(best_P))]
        flat = torch.cat([F_.reshape(-1) for F_ in U])
        u = torch.empty_like(flat)
        u[pr.order] = flat * pr.sign
        return u, best_P.reshape(-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
