"""The device-resident PCG of the port (solvers/cg.compile_pcg, the loop
test of ops/graph_loop) and make_pcg_stepper against the JAX package on
the CPU: the loop test against JAX's `cond`, the compiled program
against jax.jit(pcg), the stepper against the JAX stepper.  Inputs are
made with numpy from seeds.  f64 systems agree within 1e-10 (the same
operations; XLA sums in another order); the f32 V-cycle PCG within 1e-5
relative (f32 rounding in two summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bench
from parelag_tpu.solvers.autotune import _factory as jfactory
from parelag_tpu.solvers.cg import make_pcg_stepper as jstepper
from parelag_tpu.solvers.cg import pcg as jpcg
from parelag_tpu.solvers.hierarchy import build_hierarchy as jbuild
from parelag_tpu_torch import convert
from parelag_tpu_torch import flagship as fl
from parelag_tpu_torch.ops import graph_loop as gl
from parelag_tpu_torch.ops import hopper_kernels as hk
from parelag_tpu_torch.solvers.cg import (
    CompiledPcg, compile_pcg, make_pcg_stepper, pcg)

torch.set_num_threads(1)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jcond(nom, tol2, it, maxiter):
    """The `cond` of parelag_tpu/solvers/cg.py::pcg."""
    return bool(jnp.any(jnp.asarray(nom) > jnp.asarray(tol2))
                & (jnp.asarray(it) < maxiter))


def _spd(n, seed, density=0.08):
    rng = np.random.RandomState(seed)
    A = sp.random(n, n, density=density, random_state=rng)
    return (A @ A.T + n * sp.eye(n)).tocsr(), rng


# name: (nom, tol2, it, maxiter, step)
LOOP_CASES = {
    "nom_equals_tol2": ([0.5], [0.5], 3, 10, 0),
    "nom_above_tol2": ([0.5], [0.25], 3, 10, 1),
    "it_equals_maxiter": ([1.0], [1e-3], 10, 10, 0),
    "step_reaches_maxiter": ([1.0], [1e-3], 9, 10, 1),
    "zero_iterations": ([1e-20], [1e-12], 0, 10, 0),
    "one_column_unconverged": ([1e-9, 1e-9, 2.0, 1e-9],
                               [1e-6, 1e-6, 1e-6, 1e-6], 4, 50, 1),
    "all_columns_converged": ([1e-9] * 16, [1e-6] * 16, 4, 50, 1),
    "nan_compares_false": ([float("nan"), 1e-9], [1e-6, 1e-6], 1, 50, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_test_matches_jax_cond(case, dtype):
    nom, tol2, it0, maxiter, step = LOOP_CASES[case]
    nom_t = torch.tensor(nom, dtype=dtype)
    tol2_t = torch.tensor(tol2, dtype=dtype)
    want = _jcond(np.asarray(nom), np.asarray(tol2), it0 + step, maxiter)
    go, it = gl.loop_test_plain(nom_t, tol2_t,
                                torch.tensor(it0, dtype=torch.int32),
                                maxiter, step)
    assert go.shape == () and bool(go) == want and int(it) == it0 + step
    # the wrapper on CPU tensors: in place, through the plain version
    itc = torch.tensor(it0, dtype=torch.int32)
    goc = torch.zeros((), dtype=torch.bool)
    out = gl.pcg_loop_test(nom_t, tol2_t, itc, maxiter, step, goc)
    assert bool(out) == bool(goc) == want and int(itc) == it0 + step
    assert gl.LAUNCHES["pcg_loop_test"] == 0     # no kernel on the CPU


@pytest.mark.parametrize("precond", [None, "jacobi"])
@pytest.mark.parametrize("n_rhs", [None, 4])
def test_compile_pcg_matches_jax_jit_f64(n_rhs, precond):
    A, rng = _spd(120, 0)
    shape = (120,) if n_rhs is None else (120, n_rhs)
    b = rng.randn(*shape)
    dinv = 1.0 / A.diagonal()
    Aj = jnp.asarray(A.toarray())
    At = torch.as_tensor(A.toarray())
    jpre = tpre = None
    if precond:
        jpre = lambda r: (jnp.asarray(dinv)[:, None] if r.ndim == 2
                          else jnp.asarray(dinv)) * r
        tpre = lambda r: (torch.as_tensor(dinv)[:, None] if r.ndim == 2
                          else torch.as_tensor(dinv)) * r
    xj, (itj, nomj) = jax.jit(lambda bb: jpcg(
        lambda v: Aj @ v, bb, precond=jpre, rtol=1e-10, atol=0.0,
        maxiter=300))(jnp.asarray(b))
    solve = compile_pcg(lambda v: At @ v, torch.as_tensor(b),
                        precond=tpre, rtol=1e-10, atol=0.0, maxiter=300)
    assert isinstance(solve, CompiledPcg) and solve.program is None
    assert solve.compile_s == 0.0 and solve.graph_nodes == 0
    xt, (itt, nomt) = solve(torch.as_tensor(b))
    assert isinstance(itt, int) and itt == int(itj) and 0 < itt < 300
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-10
    assert tuple(nomt.shape) == tuple(np.shape(nomj))


def _h1_chain(nx=8, min_coarse=8):
    Aj, Pj, bj = bench._build_h1_structured(nx, min_coarse)
    return Aj, Pj, bj.astype(np.float32)


def test_compile_pcg_matches_jax_jit_h1_f32_vcycle():
    """The structured 8^3 H1 chain, the f32 hierarchy of the JAX build
    carried across, f32 PCG preconditioned by one f32 V(2,2) cycle at
    the flagship's rtol: the same iterations, x within 1e-5."""
    Aj, Pj, bj = _h1_chain()
    Hj = jbuild(Aj, Pj, jfactory(fl.CYCLE), mu=1, dtype=np.float32,
                matrix_format="dia")
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    # the coarse inverse is kept in f64: the cycle's result goes back to
    # f32 on both sides
    xj, (itj, _) = jax.jit(lambda bb: jpcg(
        lambda v: Hj.levels[0].A @ v, bb,
        precond=lambda r: Hj.apply(r).astype(jnp.float32), rtol=fl.RTOL,
        atol=0.0, maxiter=fl.MAXITER))(jnp.asarray(bj))
    bt = torch.as_tensor(bj)

    def precond(r):
        return Ht.apply(r).to(torch.float32)

    solve = compile_pcg(Ht.levels[0].A.matvec, bt, precond=precond,
                        rtol=fl.RTOL, atol=0.0, maxiter=fl.MAXITER)
    xt, (itt, _) = solve(bt)
    assert xt.dtype == torch.float32
    assert itt == int(itj) and 0 < itt < fl.MAXITER
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-5
    # the Python loop of the port on the same hierarchy: bitwise
    xp, (itp, _) = pcg(Ht.levels[0].A.matvec, bt, precond=precond,
                       rtol=fl.RTOL, atol=0.0, maxiter=fl.MAXITER)
    assert itp == itt and torch.equal(xp, xt)


@pytest.mark.parametrize("n_rhs", [None, 16])
def test_compile_pcg_flagship_solve_bitwise(n_rhs):
    """The flagship's own solve (f32 PCG, bf16 V(2,2)) through
    flagship.compile_solve against flagship.solve, 1 and 16 right-hand
    sides: the same operations in the same order, so the same
    iterations and the same bits."""
    At, Pt, bt = fl.build_h1_structured(8, 8, device="cpu")
    H, Hb = fl.build_solver(At, Pt, "cpu")
    b = torch.as_tensor(bt.astype(np.float32))
    if n_rhs:
        b = torch.as_tensor(np.random.RandomState(0).randn(
            b.shape[0], n_rhs).astype(np.float32))
    x1, (it1, nom1) = fl.solve(H, Hb, b)
    solve = fl.compile_solve(H, Hb, b)
    x2, (it2, nom2) = solve(b)
    assert it1 == it2 and 0 < it2 < fl.MAXITER
    assert torch.equal(x1, x2) and torch.equal(nom1, nom2)


def test_compiled_solver_reuses_buffers():
    """Two b through one compiled solver give what two fresh pcg calls
    give, and an x0 starts the loop where pcg's x0 does."""
    A, rng = _spd(90, 1)
    At = torch.as_tensor(A.toarray())
    b1, b2, x0 = (torch.as_tensor(rng.randn(90)) for _ in range(3))
    solve = compile_pcg(lambda v: At @ v, b1, rtol=1e-9, atol=0.0)
    for b, start in ((b1, None), (b2, None), (b1, x0), (b2, None)):
        xs, (its, noms) = solve(b, start)
        xp, (itp, nomp) = pcg(lambda v: At @ v, b, x0=start, rtol=1e-9,
                              atol=0.0)
        assert its == itp and torch.equal(xs, xp)
        assert torch.equal(noms, nomp)
    with pytest.raises(ValueError):
        solve(b1.float())


@pytest.mark.parametrize("rtol, atol, maxiter, want", [
    (1e-3, 1e3, 50, 0),          # r0.z0 <= atol^2: zero iterations
    (1e-14, 0.0, 3, 3),          # the maxiter cap
])
def test_compiled_loop_edges(rtol, atol, maxiter, want):
    A, rng = _spd(60, 2)
    At = torch.as_tensor(A.toarray())
    b = torch.as_tensor(rng.randn(60))
    x, (it, _) = compile_pcg(lambda v: At @ v, b, rtol=rtol, atol=atol,
                             maxiter=maxiter)(b)
    xp, (itp, _) = pcg(lambda v: At @ v, b, rtol=rtol, atol=atol,
                       maxiter=maxiter)
    xj, (itj, _) = jax.jit(lambda bb: jpcg(
        lambda v: jnp.asarray(A.toarray()) @ v, bb, rtol=rtol, atol=atol,
        maxiter=maxiter))(jnp.asarray(b.numpy()))
    assert it == itp == int(itj) == want
    assert torch.equal(x, xp)
    assert _rel(x.numpy(), np.asarray(xj)) < 1e-10 if want else \
        not x.any()


@pytest.mark.parametrize("steps_per_sync", [1, 2, 3])
def test_stepper_matches_jax(steps_per_sync):
    """tests/test_solvers.py::test_pcg_stepper_host_driven's system:
    the port's stepper takes the JAX stepper's iterations (a multiple
    of steps_per_sync past the stop, as there) and x within 1e-9."""
    from parelag_tpu.ops.device_sparse import from_scipy as jfrom_scipy
    rng = np.random.RandomState(0)
    n = 120
    A = sp.random(n, n, density=0.08, random_state=rng)
    A = (A @ A.T + n * sp.eye(n)).tocsr()
    b = rng.rand(n)
    Ad = jfrom_scipy(A, dtype=np.float64)
    xj, (itj, nomj) = jstepper(lambda v: Ad @ v,
                               steps_per_sync=steps_per_sync)(
        jnp.asarray(b), rtol=1e-12, maxiter=300)
    At = torch.as_tensor(A.toarray())
    solve = make_pcg_stepper(lambda v: At @ v,
                             steps_per_sync=steps_per_sync)
    xt, (itt, nomt) = solve(torch.as_tensor(b), rtol=1e-12, maxiter=300)
    assert itt == itj and itt % steps_per_sync == 0
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-9
    assert isinstance(nomt, float)
    assert np.linalg.norm(A @ xt.numpy() - b) < 1e-8
    # a second b through the same stepper (its buffers are reused)
    xt2, (itt2, _) = solve(torch.as_tensor(2 * b), rtol=1e-12,
                           maxiter=300)
    assert itt2 == itt and np.abs(xt2.numpy() - 2 * xt.numpy()).max() \
        < 1e-9


def test_stepper_maxiter_and_preconditioner():
    """The stepper stops at maxiter (never more steps) and applies its
    preconditioner as the JAX one does."""
    A, rng = _spd(80, 3)
    b = rng.randn(80)
    dinv = 1.0 / A.diagonal()
    xj, (itj, _) = jstepper(lambda v: jnp.asarray(A.toarray()) @ v,
                            precond=lambda r: jnp.asarray(dinv) * r,
                            steps_per_sync=4)(jnp.asarray(b), rtol=1e-14,
                                              maxiter=6)
    At = torch.as_tensor(A.toarray())
    xt, (itt, _) = make_pcg_stepper(
        lambda v: At @ v, precond=lambda r: torch.as_tensor(dinv) * r,
        steps_per_sync=4)(torch.as_tensor(b), rtol=1e-14, maxiter=6)
    assert itt == itj == 6
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-10


def test_launch_count_arithmetic():
    """A captured program's launches come back as init + body x
    iterations for every run; a capture itself counts nothing."""
    snap = gl.snapshot()
    assert set(snap) == set(hk.LAUNCHES) | {"pcg_loop_test"}
    init = {"dia_spmv": 2, "dia_jacobi_sweep": 4, "pcg_loop_test": 1}
    body = {"dia_spmv": 3, "bcsr_spmv": 2, "dia_jacobi_sweep": 4,
            "pcg_loop_test": 1}
    prog = gl.GraphProgram(None, init, body, 0.0, 0, None)
    try:
        prog.count_run(7)
        prog.count_run(0)
        d = gl.delta(gl.snapshot(), snap)
        assert d["dia_spmv"] == 2 * 2 + 3 * 7
        assert d["dia_jacobi_sweep"] == 4 * 2 + 4 * 7
        assert d["bcsr_spmv"] == 2 * 7
        assert d["pcg_loop_test"] == 2 + 7
        assert d["ell_spmv"] == 0
    finally:
        gl._restore(snap)
    assert gl.snapshot() == snap
