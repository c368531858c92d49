"""Parity of the port's smoother, hierarchy, V-cycle and PCG with the JAX
package on the CPU.  JAX hierarchies cross over through
convert.hierarchy_from_numpy; the f64 cycle agrees within 1e-10
relative (same operations, different summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.solvers import hierarchy as jh
from parelag_tpu.solvers import smoothers as jsm
from parelag_tpu.solvers.autotune import _factory as jfactory
from parelag_tpu.solvers.cg import pcg as jpcg
from parelag_tpu_torch import convert
from parelag_tpu_torch.solvers import hierarchy as th
from parelag_tpu_torch.solvers import smoothers as tsm
from parelag_tpu_torch.solvers.autotune import _factory as tfactory
from parelag_tpu_torch.solvers.cg import pcg as tpcg

torch.set_num_threads(1)

CFG = dict(mu=1, smoother="l1jacobi", sweeps=2)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _laplace_chain(n=12):
    """A 3-level chain on an n^3 7-point Laplacian (+ mass) with
    piecewise-constant aggregation by 2x2x2 blocks; DIA-friendly fine
    operator (7 offsets), Galerkin coarse operators."""
    I = sp.identity(n)
    T = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T) + 0.1 * sp.identity(n ** 3)).tocsr()
    A_levels, P_levels = [A], []
    m = n
    for _ in range(2):
        agg1 = np.arange(m) // 2
        P1 = sp.csr_matrix((np.ones(m), (np.arange(m), agg1)),
                           shape=(m, m // 2))
        P = sp.kron(sp.kron(P1, P1), P1).tocsr()
        P_levels.append(P)
        A_levels.append(th.rap(A_levels[-1], P))
        m //= 2
    return A_levels, P_levels


@pytest.fixture(scope="module")
def chain():
    return _laplace_chain()


@pytest.mark.parametrize("fmt", ["dia", "bcsr", "ell"])
def test_cycle_f64_matches_jax(chain, fmt):
    A_levels, P_levels = chain
    Hj = jh.build_hierarchy(A_levels, P_levels, jfactory(CFG),
                            dtype=np.float64, matrix_format=fmt)
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    r = np.random.RandomState(0).randn(A_levels[0].shape[0])
    yj = np.asarray(Hj.apply(jnp.asarray(r)))
    yt = Ht.apply(torch.as_tensor(r)).numpy()
    assert _rel(yt, yj) < 1e-10
    # the port's own build_hierarchy gives the same hierarchy
    Hb = th.build_hierarchy(A_levels, P_levels, tfactory(CFG, "cpu"),
                            dtype=np.float64, matrix_format=fmt,
                            device="cpu")
    assert [type(l.A).__name__ for l in Hb.levels] == \
        [type(l.A).__name__ for l in Hj.levels]
    assert [type(l.P).__name__ for l in Hb.levels] == \
        [type(l.P).__name__ for l in Hj.levels]
    assert _rel(Hb.apply(torch.as_tensor(r)).numpy(), yj) < 1e-10


def test_bf16_cast_cycle(chain):
    """The bf16 preconditioner: coarse inverse kept at full precision,
    every other floating buffer bf16; the cycle agrees with the JAX bf16
    cycle and with the f64 cycle within bf16 rounding (3e-2: the JAX
    side sums in bf16, the port's DIA sums in f32)."""
    A_levels, P_levels = chain
    Hj = jh.build_hierarchy(A_levels, P_levels, jfactory(CFG),
                            dtype=np.float64, matrix_format="dia")
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    Htb = Ht.cast(torch.bfloat16)
    assert Htb.levels[-1].coarse_inv.dtype == torch.float64
    assert Htb.levels[0].A.dtype == torch.bfloat16
    assert Htb.levels[0].pre.dinv.dtype == torch.bfloat16
    assert Ht.levels[0].A.dtype == torch.float64    # original untouched
    r = np.random.RandomState(1).randn(A_levels[0].shape[0])
    y64 = np.asarray(Hj.apply(jnp.asarray(r)))
    yjb = np.asarray(Hj.cast(jnp.bfloat16).apply(
        jnp.asarray(r).astype(jnp.bfloat16)).astype(jnp.float64))
    ytb = Htb.apply(torch.as_tensor(r).to(torch.bfloat16))
    assert ytb.dtype == torch.bfloat16
    ytb = ytb.double().numpy()
    assert _rel(ytb, yjb) < 3e-2
    assert _rel(ytb, y64) < 3e-2


def test_pcg_matches_jax(chain):
    """f64 PCG with the V-cycle preconditioner: same iteration count,
    solutions within 1e-10."""
    A_levels, P_levels = chain
    Hj = jh.build_hierarchy(A_levels, P_levels, jfactory(CFG),
                            dtype=np.float64, matrix_format="dia")
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    b = np.random.RandomState(2).randn(A_levels[0].shape[0])
    xj, (itj, _) = jax.jit(lambda bb: jpcg(
        lambda v: Hj.levels[0].A @ v, bb, precond=Hj.apply, rtol=1e-8,
        atol=0.0, maxiter=50))(jnp.asarray(b))
    xt, (itt, nom) = tpcg(Ht.levels[0].A.matvec, torch.as_tensor(b),
                          precond=Ht.apply, rtol=1e-8, atol=0.0,
                          maxiter=50)
    assert itt == int(itj) and itt < 50
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-10
    # unpreconditioned, multi-RHS (column-wise dots)
    B = np.random.RandomState(3).randn(A_levels[0].shape[0], 2)
    Xt, _ = tpcg(lambda v: torch.as_tensor(A_levels[0] @ v.numpy()),
                 torch.as_tensor(B), rtol=1e-10, atol=0.0, maxiter=400)
    assert _rel(A_levels[0] @ Xt.numpy(), B) < 1e-8


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_smoother_matches_jax(chain, fmt):
    """apply (fused DIA sweeps or the generic path) and apply_zero."""
    A = chain[0][0]
    Hj = jh.build_hierarchy([A], [], jfactory(CFG), dtype=np.float64,
                            matrix_format=fmt)
    Ajm = Hj.levels[0].A
    Atm = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu").levels[0].A
    sj = jsm.make_l1_jacobi(A, sweeps=2, omega=0.8)
    st = tsm.make_l1_jacobi(A, sweeps=2, omega=0.8, device="cpu")
    rng = np.random.RandomState(4)
    b, x0 = rng.randn(A.shape[0]), rng.randn(A.shape[0])
    assert _rel(st.apply(Atm, torch.as_tensor(b), torch.as_tensor(x0)),
                sj.apply(Ajm, jnp.asarray(b), jnp.asarray(x0))) < 1e-12
    assert _rel(st.apply_zero(Atm, torch.as_tensor(b)),
                sj.apply_zero(Ajm, jnp.asarray(b))) < 1e-12


def test_transfer_format_keys_on_device(chain):
    """CPU tensors get ELL transfers (as JAX on its CPU backend); any
    other device gets BCSR (hierarchy.transfer_format).  The
    'meta' device stands in for the card here: it allocates nothing."""
    A_levels, P_levels = chain
    Hc = th.build_hierarchy(A_levels, P_levels, tfactory(CFG, "cpu"),
                            dtype=np.float32, matrix_format="dia",
                            transfer_dtype=torch.bfloat16, device="cpu")
    assert {type(l.P).__name__ for l in Hc.levels[:-1]} == {"EllMatrix"}
    Hm = th.build_hierarchy(A_levels, P_levels, tfactory(CFG, "meta"),
                            dtype=np.float32, matrix_format="dia",
                            transfer_dtype=torch.bfloat16, device="meta")
    assert {type(l.P).__name__ for l in Hm.levels[:-1]} == {"BcsrMatrix"}
    assert Hm.levels[0].P.values.dtype == torch.bfloat16
    assert Hm.levels[0].A.data.device.type == "meta"
    assert [type(l.A).__name__ for l in Hm.levels] == ["DiaMatrix"] * 3


def test_coarse_guard_and_rap():
    n = 16385
    A = sp.identity(n, format="csr")
    with pytest.raises(RuntimeError, match="too large"):
        th.build_hierarchy([A], [], tfactory(CFG, "cpu"), device="cpu")
    rng = np.random.RandomState(5)
    A = sp.random(60, 60, density=0.1, random_state=rng)
    A = (A + A.T).tocsr()
    P = sp.random(60, 20, density=0.1, random_state=rng, format="csr")
    assert abs(th.rap(A, P) - jh.rap(A, P)).max() == 0.0
    with pytest.raises(ValueError, match="gauss_seidel"):
        tfactory(dict(smoother="gauss_seidel"))


@pytest.fixture(scope="module")
def rcm_problem():
    """tests/test_solvers.py::test_rcm_reordered_hierarchy_solves's
    problem: the H1 operator of the nref 1 upscaling chain, with load -1
    on attribute 1 and Dirichlet on 2-5, on both packages' chains."""
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            from parelag_tpu.models import upscaling as up
        else:
            from parelag_tpu_torch.models import upscaling as up
        _, _, seqs = up.build_hierarchy(nref_parallel=1)
        s = seqs[0]
        A = (s.compute_mass_operator(0)
             + s.D[0].T @ s.compute_mass_operator(1) @ s.D[0]).tocsr()
        b = up.boundary_rhs(s, 0, {1: -1.0})
        marker = up.mark_dofs_on_bndr(s, 0, {2, 3, 4, 5})
        out[side] = (seqs,) + up.eliminate_rowcols(A, b, marker,
                                                   np.zeros(A.shape[0]))
    return out


def test_rcm_matches_jax(rcm_problem):
    """build_amge_hierarchy(reorder='rcm'): the port's perm / iperm equal
    the JAX package's, every permuted level operator and transfer agrees
    (1e-12), and amge_pcg_solve in the permuted space gives JAX's
    iterations (within one) and x (1e-8) at rtol 1e-10."""
    from parelag_tpu.solvers.amge_solver import (
        amge_pcg_solve as jsolve, build_amge_hierarchy as jbuild)
    from parelag_tpu_torch.solvers.amge_solver import (
        amge_pcg_solve as tsolve, build_amge_hierarchy as tbuild)
    seqs_j, Aj, bj = rcm_problem["jax"]
    seqs_t, At, bt = rcm_problem["port"]
    Hj, _, _ = jbuild(seqs_j, 0, Aj, smoother="l1jacobi", reorder="rcm")
    Ht, _, _ = tbuild(seqs_t, 0, At, smoother="l1jacobi", reorder="rcm",
                      device="cpu")
    np.testing.assert_array_equal(Ht.perm.numpy(), np.asarray(Hj.perm))
    np.testing.assert_array_equal(Ht.iperm.numpy(), np.asarray(Hj.iperm))
    Hc = convert.hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, Hj),
                                      device="cpu")
    np.testing.assert_array_equal(Hc.perm.numpy(), Ht.perm.numpy())
    v = torch.as_tensor(np.random.RandomState(2).randn(At.shape[0]))
    for lt, lc in zip(Ht.levels, Hc.levels):
        if lt.coarse_inv is None:
            for a, c in ((lt.A, lc.A), (lt.P, lc.P), (lt.R, lc.R)):
                w = v[:a.shape[1]]
                assert _rel((a @ w).numpy(), (c @ w).numpy()) < 1e-12
    xj, (itj, _) = jsolve(Hj, None, bj, rtol=1e-10)
    xt, (itt, _) = tsolve(Ht, None, bt, rtol=1e-10, device="cpu")
    assert abs(int(itt) - int(itj)) <= 1, (itt, itj)
    assert _rel(xt, np.asarray(xj)) < 1e-8
    assert np.linalg.norm(At @ xt - bt) < 1e-7 * np.linalg.norm(bt)
