"""Krylov solvers (PyTorch).

Counterpart of parelag_tpu/solvers/cg.py: `pcg`, `compile_pcg`,
`make_pcg_stepper`, `minres`, `bicgstab`, `gmres` and `pcg_host`.  The
convergence rule of pcg is mfem CG's (reference
ParELAG_KrylovSolver.hpp:25-144): stop when r.z <= max(rtol^2 * r0.z0,
atol^2).  The JAX versions are lax.while_loop programs that the JAX
bench runs under jax.jit; here:
  * compile_pcg is jax.jit(pcg): on a CUDA tensor the whole solve is one
    captured CUDA graph whose loop is a WHILE node, its test set on the
    card by the pcg_loop_test kernel (ops/graph_loop.py); the host reads
    once, when the solve ends.  On a CPU tensor the same program runs
    under a Python loop driven by the test's plain version.
  * make_pcg_stepper is the JAX stepper: one step replayed as a CUDA
    graph (eager on the CPU), r.z read on the host every steps_per_sync
    steps.
  * pcg, minres, bicgstab and gmres loop in Python, on either device,
    and read their stopping test on the host once per iteration
    (GMRES: once per restart).
The rules, guards and return values are the JAX versions'; their dots
are over all entries (jnp.vdot flattens), as here.
"""

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import graph_loop
from parelag_tpu_torch.utils.timing import TimeManager, span


def pcg(matvec, b, precond=None, x0=None, rtol=1e-6, atol=1e-12,
        maxiter=500):
    """Preconditioned conjugate gradients.  Returns (x, (niter, r.z)).

    The JAX version is one lax.while_loop program; here the loop runs in
    Python and reads the stopping test on the host once per iteration
    (one device sync each).  b may be (n,) or (n, s): dots are
    column-wise and the loop runs until every column has converged.  A
    call is the span "krylov.pcg" (utils/timing.py)."""
    with span("krylov.pcg"):
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


class CompiledPcg:
    """pcg compiled for one shape, dtype and device (compile_pcg).

    Static buffers b, x, r, z, d, nom, tol2 and the int32 counter `it`
    live on b_like's device; the init part and the loop body are pcg's,
    with its guarded divisions, writing into those buffers in place (the
    body's temporaries are freed at its end; under capture they come
    from a memory pool kept with the graph).  On the card the program is one CUDA graph
    (graph_loop.capture_while): init, a test, and a WHILE node over the
    body and a test; `compile_s` is its capture and instantiation,
    `graph_nodes` its node count and `program` the GraphProgram.  On the
    CPU the body runs under a Python loop driven by
    graph_loop.pcg_loop_test's plain version (compile_s 0, graph_nodes
    0, program None).  A call is the span "krylov.solve"; on the card it
    adds the graph's device seconds (GraphProgram.device_seconds) to the
    timer "krylov.graph"."""

    def __init__(self, matvec, b_like, precond=None, rtol=1e-6, atol=1e-12,
                 maxiter=500):
        self.matvec = matvec
        self.precond = precond if precond is not None else (lambda r: r)
        self.rtol, self.atol, self.maxiter = rtol, atol, int(maxiter)
        self.shape, self.dtype = tuple(b_like.shape), b_like.dtype
        self.device = b_like.device
        self.b, self.x, self.r, self.z, self.d = (
            torch.zeros_like(b_like) for _ in range(5))
        cols = self.shape[1:]
        self.nom = torch.zeros(cols, dtype=self.dtype, device=self.device)
        self.tol2 = torch.zeros_like(self.nom)
        self.it = torch.zeros((), dtype=torch.int32, device=self.device)
        self.program, self.compile_s, self.graph_nodes = None, 0.0, 0
        if self.device.type == "cuda":
            self.program = graph_loop.capture_while(
                self._init, self._body, self._test, self.device)
            self.compile_s = self.program.compile_s
            self.graph_nodes = self.program.nodes

    def _init(self):
        self.r.copy_(self.b - self.matvec(self.x))
        self.z.copy_(self.precond(self.r))
        self.d.copy_(self.z)
        self.nom.copy_(torch.sum(self.r * self.z, dim=0))
        self.tol2.copy_(torch.clamp(self.rtol * self.rtol * self.nom,
                                    min=self.atol * self.atol))
        self.it.zero_()

    def _body(self):
        Ad = self.matvec(self.d)
        dAd = torch.sum(self.d * Ad, dim=0)
        alpha = self.nom / torch.where(dAd != 0, dAd, torch.ones_like(dAd))
        self.x.add_(alpha * self.d)
        self.r.sub_(alpha * Ad)
        self.z.copy_(self.precond(self.r))
        nom_new = torch.sum(self.r * self.z, dim=0)
        beta = nom_new / torch.where(self.nom != 0, self.nom,
                                     torch.ones_like(self.nom))
        self.d.mul_(beta).add_(self.z)
        self.nom.copy_(nom_new)

    def _test(self, step, handle=None):
        return graph_loop.pcg_loop_test(self.nom, self.tol2, self.it,
                                        self.maxiter, step, handle=handle)

    def __call__(self, b, x0=None):
        """Solve from b (x0: the start, None: zero).  Returns (x, (it,
        r.z)) as pcg does: x a new tensor, it an int, r.z a tensor."""
        if tuple(b.shape) != self.shape or b.dtype != self.dtype:
            raise ValueError(f"b {b.dtype} {tuple(b.shape)}: compiled for "
                             f"{self.dtype} {self.shape}")
        with span("krylov.solve"):
            self.b.copy_(b)
            if x0 is None:
                self.x.zero_()
            else:
                self.x.copy_(x0)
            if self.program is None:
                self._init()
                go = self._test(0)
                while bool(go):
                    self._body()
                    go = self._test(1)
                return self.x.clone(), (int(self.it), self.nom.clone())
            self.program.replay()
            it = int(self.it)              # the one host read of a solve
            self.program.count_run(it)
            # the graph has ended: its events' time is ready
            TimeManager.get_timer("krylov.graph").add(
                self.program.device_seconds())
            return self.x.clone(), (it, self.nom.clone())


def compile_pcg(matvec, b_like, precond=None, rtol=1e-6, atol=1e-12,
                maxiter=500):
    """jax.jit(lambda bb: pcg(matvec, bb, precond, ...)): pcg compiled
    for b_like's shape, dtype and device.  Returns solve(b, x0=None) ->
    (x, (it, r.z)), a CompiledPcg: on a CUDA tensor one captured graph
    with the loop test on the card (the capture raises if the body
    cannot be captured, e.g. on a host read; nothing falls back to the
    Python loop), on a CPU tensor the same program under a Python loop.
    Iterations and x are pcg's: the same operations in the same
    order."""
    return CompiledPcg(matvec, b_like, precond, rtol, atol, maxiter)


def make_pcg_stepper(matvec, precond=None, steps_per_sync=2):
    """The JAX make_pcg_stepper (parelag_tpu/solvers/cg.py:226-267): one
    CG step (matvec + preconditioner + vector updates, its divisions
    unguarded), convergence checked on the host every steps_per_sync
    steps, so `it` may pass the stopping step by up to steps_per_sync -
    1.  x0 = 0, r = b; the stop rule is pcg's (r.z <= max(rtol^2 nom0,
    atol^2)).  On a CUDA b the init and the step are two captured
    graphs (compiled at the first b of a shape and dtype, kept for the
    next) and the host replays the step steps_per_sync times between
    reads of r.z; on a CPU b they run eagerly.  Returns solve(b,
    rtol=1e-6, atol=0.0, maxiter=500) -> (x, (niter, final r.z as a
    float))."""
    if precond is None:
        precond = lambda r: r
    programs = {}

    def program(b):
        key = (tuple(b.shape), b.dtype, b.device)
        if key not in programs:
            st = [torch.zeros_like(b) for _ in range(5)]     # b, x, r, z, d
            nom = torch.zeros((), dtype=b.dtype, device=b.device)

            def init():
                bb, x, r, z, d = st
                z.copy_(precond(bb))
                x.zero_()
                r.copy_(bb)
                d.copy_(z)
                nom.copy_(bb @ z)

            def step():
                _, x, r, z, d = st
                Ad = matvec(d)
                alpha = nom / (d @ Ad)
                x.add_(alpha * d)
                r.sub_(alpha * Ad)
                z.copy_(precond(r))
                nom_new = r @ z
                d.mul_(nom_new / nom).add_(z)
                nom.copy_(nom_new)

            if b.device.type == "cuda":
                st[0].copy_(b)
                gi = graph_loop.capture(init, b.device)
                gs = graph_loop.capture(step, b.device)
                init, step = (lambda: (gi.replay(), gi.count_run()),
                              lambda: (gs.replay(), gs.count_run()))
            programs[key] = (st, nom, init, step)
        return programs[key]

    def solve(b, rtol=1e-6, atol=0.0, maxiter=500):
        st, nom, init, step = program(b)
        st[0].copy_(b)
        init()
        n = float(nom)
        tol2 = max(rtol * rtol * n, atol * atol)
        it = 0
        while n > tol2 and it < maxiter:
            for _ in range(min(steps_per_sync, maxiter - it)):
                step()
                it += 1
            n = float(nom)
        return st[1].clone(), (it, n)

    return solve


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
