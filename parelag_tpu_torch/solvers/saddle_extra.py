"""Additional saddle-point solvers: Block 2x2 LDU, Bramble-Pasciak CG,
and the multilevel divergence-free solver.

Reference components:
  * Block2x2LDUInverseOperator (ParELAG_Block2x2LDUInverseOperator.hpp:26)
  * BramblePasciakSolver/Transformation
    (ParELAG_BramblePasciakTransformation.hpp:29-86)
  * MLDivFree (ParELAG_MLDivFree.hpp:24-150)

A copy of parelag_tpu/solvers/saddle_extra.py; MLDivFree takes
device= (None: the card) for its H(curl) AMGe solve and its
HybridHdivL2 solve.
"""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelag_tpu_torch import resolve_device


class Block2x2LDU:
    """Full LDU-based inverse action for [[M, B^T], [B, -C]]:

        A = L D U,  L = [[I,0],[B Mh^{-1}, I]], D = diag(Mh, -Sh),
        U = [[I, Mh^{-1} B^T],[0, I]]

    with Mh = diag(M) (Jacobi) and Sh = B Mh^{-1} B^T + C solved by sparse
    LU (the reference's 'Full' Schur option,
    ParELAG_SchurComplementFactory.cpp)."""

    def __init__(self, M, B, C=None, damping=1.0):
        self.M = sp.csr_matrix(M)
        self.B = sp.csr_matrix(B)
        self.n0 = self.M.shape[0]
        self.minv = damping / self.M.diagonal()
        S = (self.B @ sp.diags(self.minv) @ self.B.T).tocsc()
        if C is not None:
            S = (S + sp.csc_matrix(C)).tocsc()
        self._S_lu = spla.splu(S)

    def apply(self, b):
        b = np.asarray(b)
        f, g = b[: self.n0], b[self.n0:]
        # L^{-1}
        y0 = f
        y1 = g - self.B @ (self.minv * f)
        # D^{-1}
        z0 = self.minv * y0
        z1 = -self._S_lu.solve(y1)
        # U^{-1}
        x1 = z1
        x0 = z0 - self.minv * (self.B.T @ x1)
        return np.concatenate([x0, x1])

    solve = apply


class BramblePasciakCG:
    """Bramble-Pasciak transformed CG for [[M, B^T], [B, -C]] x = b.

    With Mh = gamma diag(M), gamma < lambda_min(diag(M)^{-1} M), the
    transformed system

        [[M Mh^{-1} - I, 0], [B Mh^{-1}, -I]] (A x - b) = 0

    is SPD in the inner product <(u,p),(v,q)> = ((M - Mh)u, v) + (p, q),
    enabling plain CG (reference ParELAG_BramblePasciakTransformation)."""

    def __init__(self, M, B, C=None, gamma=None, power_iters=30):
        self.M = sp.csr_matrix(M)
        self.B = sp.csr_matrix(B)
        self.C = sp.csr_matrix(C) if C is not None else None
        self.n0 = self.M.shape[0]
        d = self.M.diagonal()
        if gamma is None:
            # gamma must satisfy gamma < lambda_min(diag(M)^{-1} M) so that
            # Mh = gamma diag(M) < M (BP requirement); compute lambda_min of
            # the diagonally-scaled mass by shift-invert Lanczos
            Ds = sp.diags(1.0 / np.sqrt(d))
            Ms = (Ds @ self.M @ Ds).tocsc()
            try:
                lam_min = float(spla.eigsh(
                    Ms, k=1, sigma=0, which="LM",
                    return_eigenvectors=False)[0])
            except Exception:
                lam_min = float(spla.eigsh(
                    Ms, k=1, which="SA",
                    return_eigenvectors=False)[0])
            gamma = 0.9 * lam_min
        self.gamma = gamma
        self.mh_inv = 1.0 / (gamma * d)
        self.iterations = 0
        # Schur preconditioner for the pressure block of the transformed
        # system (the reference pairs BP with an S-preconditioner)
        S = (self.B @ sp.diags(1.0 / d) @ self.B.T).tocsc()
        if self.C is not None:
            S = (S + sp.csc_matrix(self.C)).tocsc()
        self._S_lu = spla.splu(S)

    def _matvec(self, x):
        """A x for the saddle operator."""
        u, p = x[: self.n0], x[self.n0:]
        Au = self.M @ u + self.B.T @ p
        Ap = self.B @ u - (self.C @ p if self.C is not None else 0.0)
        return np.concatenate([Au, Ap])

    def _transform(self, r):
        """Apply the BP transformation T r."""
        ru, rp = r[: self.n0], r[self.n0:]
        w = self.mh_inv * ru
        tu = self.M @ w - ru
        tp = self.B @ w - rp
        return np.concatenate([tu, tp])

    def _ip(self, x, y):
        """BP inner product <x,y> = ((M - Mh) xu, yu) + (xp, yp)."""
        xu, xp = x[: self.n0], x[self.n0:]
        yu, yp = y[: self.n0], y[self.n0:]
        Mxu = self.M @ xu - xu / self.mh_inv
        return float(Mxu @ yu + xp @ yp)

    def _prec(self, r):
        """Block-diagonal preconditioner (identity on u, Schur LU on p)."""
        out = r.copy()
        out[self.n0:] = self._S_lu.solve(r[self.n0:])
        return out

    def solve(self, b, rtol=1e-8, maxiter=1000):
        b = np.asarray(b)
        x = np.zeros_like(b)
        r = self._transform(b - self._matvec(x))
        z = self._prec(r)
        d = z.copy()
        rz = self._ip(r, z)
        b_norm = np.linalg.norm(b)
        it = 0
        # stopping on the true residual: the BP inner product becomes
        # near-semidefinite for gamma close to lambda_min, making <r,z>
        # an unreliable convergence measure at high accuracy
        while it < maxiter and np.linalg.norm(
                b - self._matvec(x)) > rtol * b_norm:
            Ad = self._transform(self._matvec(d))
            alpha = rz / self._ip(d, Ad)
            x = x + alpha * d
            r = r - alpha * Ad
            z = self._prec(r)
            rz_new = self._ip(r, z)
            d = z + (rz_new / rz) * d
            rz = rz_new
            it += 1
        self.iterations = it
        return x


class MLDivFree:
    """Multilevel divergence-free solver for the Darcy saddle problem
    (reference ParELAG_MLDivFree.hpp:24-150): split u = u_particular +
    curl(phi): the particular solution satisfies the divergence constraint
    exactly (computed here by the hybridized local solver); the
    divergence-free correction solves the curl-curl-projected SPD system
    N = C^T M C in the Hcurl potential space with AMGe(Hiptmair)-PCG;
    the pressure is recovered from the momentum residual.  device:
    where the H(curl) hierarchy is built and solved (None: the
    card)."""

    def __init__(self, seqs, w_weight=0.0, rtol=1e-8, device=None):
        self.device = resolve_device(device)
        self.seqs = seqs
        self.rtol = rtol
        s = seqs[0]
        dim = s.dim
        assert dim == 3, "MLDivFree uses the 3D curl potential space"
        self.uform, self.pform = 2, 3
        self.M = s.compute_mass_operator(self.uform)
        self.W = s.compute_mass_operator(self.pform)
        self.Bop = (self.W @ s.D[self.uform]).tocsr()
        self.Curl = s.D[1].tocsr()          # Hcurl -> Hdiv
        from parelag_tpu_torch.amge.hybridization import HybridHdivL2
        self._hyb = HybridHdivL2(s, W_weight=w_weight)
        # curl-curl projected operator (SPD on the complement of gradients)
        self.N = (self.Curl.T @ self.M @ self.Curl).tocsr()
        # regularize the gradient null space with the Hcurl mass
        self.N_reg = (self.N + 1e-8 * s.compute_mass_operator(1)).tocsr()

    def solve(self, rhs_u, rhs_p):
        s = self.seqs[0]
        # (1) particular solution: exact constraint via hybridization
        u_p, p0 = self._hyb.solve(rhs_u, rhs_p, solver="cg",
                                  rtol=self.rtol, rescale=True,
                                  device=self.device)
        # (2) divergence-free correction: min energy over u_p + curl(phi)
        r = rhs_u - self.M @ u_p
        g = self.Curl.T @ r
        if self.seqs[0].P[1] is not None:
            from parelag_tpu_torch.solvers.amge_solver import (
                build_amge_hierarchy, amge_pcg_solve)
            H, _, _ = build_amge_hierarchy(self.seqs, 1, self.N_reg,
                                           smoother="hiptmair",
                                           device=self.device)
            phi, info = amge_pcg_solve(H, H.levels[0].A, g, rtol=self.rtol,
                                       device=self.device)
        else:
            # Hcurl chain not coarsened (jFormStart=2 hierarchies):
            # single-level Jacobi-PCG on the regularized curl-curl operator
            dinv = 1.0 / self.N_reg.diagonal()
            Pm = spla.LinearOperator(self.N_reg.shape,
                                     matvec=lambda v: dinv * v)
            phi, _ = spla.cg(self.N_reg, g, M=Pm, rtol=self.rtol,
                             atol=0.0, maxiter=3000)
        u = u_p + self.Curl @ phi
        # (3) pressure from the momentum residual: B^T p = rhs_u - M u
        res = rhs_u - self.M @ u
        p, *_ = spla.lsqr(self.Bop.T, res, atol=1e-12, btol=1e-12)[:1], None
        p = p[0]
        return u, p
