"""Krylov solvers (PyTorch).

Counterpart of parelag_tpu/solvers/cg.py; this slice ports `pcg`.  The
convergence rule is mfem CG's (reference ParELAG_KrylovSolver.hpp:
25-144): stop when r.z <= max(rtol^2 * r0.z0, atol^2).
"""

import torch


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
