"""Krylov solvers (PyTorch).

Counterpart of parelag_tpu/solvers/cg.py: `pcg`, `minres`, `bicgstab`,
`gmres` and `pcg_host`.  The convergence rule of pcg is mfem CG's
(reference ParELAG_KrylovSolver.hpp:25-144): stop when r.z <=
max(rtol^2 * r0.z0, atol^2).  The JAX versions are lax.while_loop
programs; here each loop runs in Python, on either device, and reads its
stopping test on the host once per iteration (GMRES: once per restart).
The rules, guards and return values are the JAX versions'; their dots
are over all entries (jnp.vdot flattens), as here.  make_pcg_stepper,
a TPU compile workaround, is not ported.
"""

import numpy as np
import torch

from parelag_tpu_torch import resolve_device


def pcg(matvec, b, precond=None, x0=None, rtol=1e-6, atol=1e-12,
        maxiter=500):
    """Preconditioned conjugate gradients.  Returns (x, (niter, r.z)).

    The JAX version is one lax.while_loop program; here the loop runs in
    Python and reads the stopping test on the host once per iteration
    (one device sync each).  b may be (n,) or (n, s): dots are
    column-wise and the loop runs until every column has converged."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    d = z
    dot = lambda u, v: torch.sum(u * v, dim=0)
    nom = dot(r, z)
    tol2 = torch.clamp(rtol * rtol * nom, min=atol * atol)
    it = 0
    while it < maxiter and bool(torch.any(nom > tol2)):
        Ad = matvec(d)
        dAd = dot(d, Ad)
        alpha = nom / torch.where(dAd != 0, dAd, torch.ones_like(dAd))
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        nom_new = dot(r, z)
        beta = nom_new / torch.where(nom != 0, nom, torch.ones_like(nom))
        d = z + beta * d
        nom = nom_new
        it += 1
    return x, (it, nom)


def _dot(u, v):
    return torch.sum(u * v)


def _nonzero(t):
    return torch.where(t != 0, t, torch.ones_like(t))


def minres(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
           maxiter=500):
    """Preconditioned MINRES (Paige-Saunders Lanczos recurrence with
    Givens rotations, the Elman-Silvester-Wathen PMINRES formulation;
    the reference Krylov dispatch's MINRES, ParELAG_KrylovSolver.cpp:
    42-61): symmetric (possibly indefinite) operator, SPD
    preconditioner.  Returns (x, (niter, |eta|)), |eta| the
    preconditioned residual norm estimate."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    v1 = b - matvec(x)
    z1 = precond(v1)
    gamma1 = torch.sqrt(torch.clamp(_dot(v1, z1), min=0.0))
    tol = torch.clamp(rtol * gamma1, min=atol)
    v0 = torch.zeros_like(b)
    w0 = torch.zeros_like(b)
    w1 = torch.zeros_like(b)
    eta = gamma1
    one = torch.ones((), dtype=b.dtype, device=b.device)
    gamma0 = c0 = c1 = one
    s0 = s1 = torch.zeros_like(one)
    it = 0
    while it < maxiter and bool((eta.abs() > tol) & (gamma1 > 0)):
        g1 = _nonzero(gamma1)
        z = z1 / g1
        Az = matvec(z)
        delta = _dot(z, Az)
        g0 = _nonzero(gamma0)
        v2 = Az - (delta / g1) * v1 - (gamma1 / g0) * v0
        z2 = precond(v2)
        gamma2 = torch.sqrt(torch.clamp(_dot(v2, z2), min=0.0))
        a0 = c1 * delta - c0 * s1 * gamma1
        a1 = torch.sqrt(a0 * a0 + gamma2 * gamma2)
        a2 = s1 * delta + c0 * c1 * gamma1
        a3 = s0 * gamma1
        a1s = _nonzero(a1)
        c2 = a0 / a1s
        s2 = gamma2 / a1s
        w2 = (z - a3 * w0 - a2 * w1) / a1s
        x = x + (c2 * eta) * w2
        eta = -s2 * eta
        v0, v1, z1, w0, w1 = v1, v2, z2, w1, w2
        gamma0, gamma1 = gamma1, gamma2
        c0, c1, s0, s1 = c1, c2, s1, s2
        it += 1
    return x, (it, eta.abs())


def bicgstab(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
             maxiter=500):
    """Preconditioned BiCGSTAB (van der Vorst), right-preconditioned like
    mfem's BiCGSTABSolver in the reference Krylov dispatch
    (ParELAG_KrylovSolver.cpp:42-61); a non-finite residual or a zero
    rho ends the iteration.  Returns (x, (niter, ||r||^2))."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    res2 = _dot(r, r)
    tol2 = torch.clamp(rtol * rtol * res2, min=atol * atol)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    it, ok = 0, True
    while ok and it < maxiter and bool(res2 > tol2):
        rho_new = _dot(rhat, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / _nonzero(_dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = _dot(t, s) / _nonzero(_dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        res2 = _dot(r, r)
        rho = rho_new
        it += 1
        ok = bool(torch.isfinite(res2) & (rho_new.abs() > 0))
    return x, (it, res2)


def gmres(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
          restart=30, max_restarts=20):
    """Right-preconditioned restarted GMRES(m) (mfem::GMRESSolver in the
    reference KrylovSolver wrapper): each cycle takes m = min(restart, n)
    Arnoldi steps with modified Gram-Schmidt (a step whose new vector
    has norm <= 1e-30 keeps it unnormalised, as the JAX fixed-size loop
    does), then the least-squares update; cycles run while ||b - A x||
    > max(rtol ||b||, atol) and fewer than max_restarts have run.  The
    (m + 1) x m least-squares problem is solved on the host in f64 by
    numpy's SVD-based lstsq (JAX's jnp.linalg.lstsq is SVD-based too).
    Returns (x, (cycles, ||b - A x||))."""
    if precond is None:
        precond = lambda r: r
    n = b.shape[0]
    m = min(restart, n)
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(rtol * float(torch.linalg.norm(b)), atol)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        V[0] = r / _nonzero(beta)
        for j in range(m):
            w = matvec(precond(V[j]))
            for i in range(j + 1):
                hij = w @ V[i]
                w = w - hij * V[i]
                H[i, j] = hij
            hj1 = torch.linalg.norm(w)
            H[j + 1, j] = hj1
            V[j + 1] = w / torch.where(hj1 > 1e-30, hj1,
                                       torch.ones_like(hj1))
        e1 = np.zeros(m + 1)
        e1[0] = float(beta)
        y = np.linalg.lstsq(H.double().cpu().numpy(), e1, rcond=None)[0]
        y = torch.as_tensor(y).to(device=b.device, dtype=b.dtype)
        return x + precond(V[:m].T @ y)

    it = 0
    while it < max_restarts and float(
            torch.linalg.norm(b - matvec(x))) > tol:
        x = arnoldi_cycle(x)
        it += 1
    return x, (it, torch.linalg.norm(b - matvec(x)))


def pcg_host(A_scipy, b, precond=None, rtol=1e-6, atol=1e-12, maxiter=500,
             device=None):
    """Host convenience wrapper: a scipy matrix (as an f64 ELL matrix on
    `device`, None: the card) and a numpy b in, the numpy solution and
    pcg's (niter, r.z) out."""
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    device = resolve_device(device)
    A = from_scipy(A_scipy, dtype=np.float64, device=device)
    bt = torch.as_tensor(np.asarray(b)).to(device)
    x, info = pcg(A.matvec, bt, precond=precond, rtol=rtol, atol=atol,
                  maxiter=maxiter)
    return x.cpu().numpy(), info
