"""The port's ops/batched.py against the JAX package's on seeded inputs.

The host paths are copies: equal to the reference's bit for bit (the
same LAPACK / native calls).  The 'device' backend (run here with
device="cpu": the same torch.linalg calls the card makes) replaces the
reference's Newton-Schulz f32 solve with an f64 LU: its residual is held
to 10x the f64 LAPACK solve's on condition numbers 1e6 and 1e10 (the
bound of tests/test_bench_pipeline.py:91-107), and on exactly singular
and all-zero members it must give no NaN, only the host lstsq repair.
The SVD's device branch is held to the host branch at 1e-10 (singular
values; vectors up to sign)."""

import numpy as np
import pytest
import torch

from parelag_tpu.ops import batched as jb
from parelag_tpu_torch.ops import batched as tb

torch.set_num_threads(1)


def _maxabs(a):
    return np.abs(np.asarray(a)).max(initial=0.0)


def _ill(n, cond, rng):
    Q, _ = np.linalg.qr(rng.randn(n, n))
    return (Q * np.logspace(0, -np.log10(cond), n)) @ Q.T


@pytest.mark.parametrize("entry", ["solve_groups", "batched_solve"])
@pytest.mark.parametrize("cond", [1e6, 1e10])
def test_device_solve_ill_conditioned(cond, entry):
    rng = np.random.RandomState(0)
    n = 24
    A = np.stack([_ill(n, cond, rng) for _ in range(3)])
    B = rng.randn(3, n, 3)
    if entry == "solve_groups":
        X = tb.solve_groups([A], [B], backend="device", device="cpu")[0]
    else:
        X = [np.asarray(x) for x in tb.batched_solve(
            list(A), list(B), backend="device", device="cpu")]
    for a, b, x in zip(A, B, X):
        r = np.abs(a @ x - b).max()
        r_ref = np.abs(a @ np.linalg.solve(a, b) - b).max()
        assert r < 10 * max(r_ref, 1e-13), (cond, r, r_ref)


def _singular_stack(rng, n=6, k=2):
    """A regular member, a rank-deficient one (consistent right-hand
    side), a rank-deficient one with an inconsistent right-hand side,
    and an all-zero one."""
    reg = rng.randn(n, n) + n * np.eye(n)
    U = rng.randn(n, n - 2)
    low = U @ U.T
    B = rng.randn(4, n, k)
    B[1] = low @ rng.randn(n, k)
    return np.stack([reg, low, low, np.zeros((n, n))]), B


def test_device_solve_singular_members_repaired():
    rng = np.random.RandomState(1)
    A, B = _singular_stack(rng)
    X = tb.solve_groups([A], [B], backend="device", device="cpu")[0]
    assert np.isfinite(X).all()
    assert np.abs(X[3]).max() == 0.0             # lstsq of a zero system
    np.testing.assert_allclose(X[0], np.linalg.solve(A[0], B[0]),
                               rtol=1e-12, atol=1e-12)
    # the inconsistent member fails the residual bound: the repair is
    # the min-norm lstsq of the equilibrated system
    s = np.abs(A[2]).max(axis=1)
    d = 1.0 / np.sqrt(np.where(s > 0, s, 1.0))
    Y = np.linalg.lstsq(A[2] * d[:, None] * d[None, :], B[2] * d[:, None],
                        rcond=1e-12)[0]
    np.testing.assert_allclose(X[2], Y * d[:, None], rtol=1e-10, atol=1e-12)
    assert np.abs(A[1] @ X[1] - B[1]).max() < 1e-10


def test_device_solve_never_passes_a_nan(monkeypatch):
    """A non-finite LU result (cuSOLVER gave NaN on all-zero f32 batches)
    is flagged by its residual and repaired on the host."""
    real = torch.linalg.solve_ex

    def nan_first(A, B, check_errors=False):
        X, info = real(A, B, check_errors=check_errors)
        X = X.clone()
        X[0] = float("nan")
        return X, torch.zeros_like(info)
    monkeypatch.setattr(torch.linalg, "solve_ex", nan_first)
    rng = np.random.RandomState(2)
    A = rng.randn(3, 5, 5) + 5 * np.eye(5)
    B = rng.randn(3, 5, 2)
    X = tb.solve_groups([A], [B], backend="device", device="cpu")[0]
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-10,
                               atol=1e-12)


def test_device_solve_is_row_major():
    """The setup's native kernels read the solution stack as C order
    (ext_gram_blocks); torch's LU returns column-major members."""
    rng = np.random.RandomState(3)
    A = rng.randn(4, 7, 7) + 7 * np.eye(7)
    B = rng.randn(4, 7, 3)
    X = tb.solve_groups([A], [B], backend="device", device="cpu")[0]
    assert X.flags.c_contiguous


def _groups(rng):
    As, Bs = [], []
    for m, n, k in ((5, 6, 2), (3, 9, 4), (2, 4, 1), (2, 3, 0)):
        As.append(rng.randn(m, n, n) + n * np.eye(n))
        Bs.append(rng.randn(m, n, k))
    return As, Bs


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_solve_groups_matches_jax_host(backend):
    rng = np.random.RandomState(4)
    As, Bs = _groups(rng)
    skip = [False, True, False, False]
    Xj = jb.solve_groups(As, Bs, backend="host", skip=skip)
    Xt = tb.solve_groups(As, Bs, backend=backend, skip=skip, device="cpu")
    assert [x.shape for x in Xt] == [x.shape for x in Xj]
    tol = 0.0 if backend != "device" else 1e-12
    for xt, xj in zip(Xt, Xj):
        assert _maxabs(xt - xj) <= tol * max(_maxabs(xj), 1)
    assert Xt[1] is Bs[1]                        # skipped: passthrough


@pytest.mark.parametrize("backend", ["host", "device"])
def test_batched_solve_matches_jax_host(backend):
    rng = np.random.RandomState(5)
    sizes = [(4, 2), (6, 3), (4, 2), (5, 1), (4, 2), (3, 0)]
    systems = [rng.randn(n, n) + n * np.eye(n) for n, _ in sizes]
    rhs = [rng.randn(n, k) for n, k in sizes]
    skip = [False, False, True, False, False, False]
    outj = jb.batched_solve(systems, rhs, backend="host", skip=skip)
    outt = tb.batched_solve(systems, rhs, backend=backend, skip=skip,
                            device="cpu")
    assert len(outt) == len(outj)
    for xt, xj in zip(outt, outj):
        assert xt.shape == xj.shape
        assert _maxabs(np.asarray(xt) - np.asarray(xj)) <= 1e-12


def test_host_stack_matches_jax_on_singular_members():
    rng = np.random.RandomState(6)
    A, B = _singular_stack(rng)
    np.testing.assert_array_equal(tb._host_solve_stack(A, B),
                                  jb._host_solve_stack(A, B))


def _svd_mats(rng):
    mats = [rng.randn(7, 3) for _ in range(4)]
    mats.append(np.outer(rng.randn(7), rng.randn(3)))   # rank one
    mats.append(np.zeros((7, 3)))                       # all zero
    mats += [rng.randn(5, 5), rng.randn(4, 6), np.zeros((0, 3)),
             np.zeros((4, 0))]
    return mats


def test_svd_basis_device_matches_host():
    rng = np.random.RandomState(7)
    mats = _svd_mats(rng)
    host = jb.batched_svd_basis(mats, backend="host")
    dev = tb.batched_svd_basis(mats, backend="device", device="cpu")
    for T, (Uh, sh), (Ud, sd) in zip(mats, host, dev):
        assert Ud.shape == Uh.shape and sd.shape == sh.shape
        assert np.isfinite(Ud).all() and np.isfinite(sd).all()
        if T.size == 0:
            continue
        np.testing.assert_allclose(sd, sh, rtol=0, atol=1e-10 * max(
            sh.max(), 1.0))
        keep = sh > 1e-8 * max(sh.max(), 1e-300)     # defined directions
        np.testing.assert_allclose(np.abs(Ud[:, keep]),
                                   np.abs(Uh[:, keep]), atol=1e-10)


def test_svd_basis_repairs_non_finite_members(monkeypatch):
    real = torch.linalg.svd

    def nan_first(T, full_matrices=False):
        U, s, V = real(T, full_matrices=full_matrices)
        s = s.clone()
        s[0] = float("nan")
        return U, s, V
    monkeypatch.setattr(torch.linalg, "svd", nan_first)
    rng = np.random.RandomState(8)
    mats = [rng.randn(6, 2) for _ in range(3)]
    dev = tb.batched_svd_basis(mats, backend="device", device="cpu")
    for T, (U, s) in zip(mats, dev):
        np.testing.assert_allclose(s, np.linalg.svd(T, compute_uv=False),
                                   atol=1e-12)


def test_svd_basis_auto_stays_host_without_a_device():
    rng = np.random.RandomState(9)
    mats = [rng.randn(5, 2).astype(np.float32) for _ in range(64)]
    for (Ut, st), (Uj, sj) in zip(tb.batched_svd_basis(mats),
                                  jb.batched_svd_basis(mats,
                                                       backend="host")):
        np.testing.assert_array_equal(Ut, Uj)
        np.testing.assert_array_equal(st, sj)


def test_weighted_and_plain_svd_match_jax():
    rng = np.random.RandomState(10)
    Ms, Ts = [], []
    for n, t in ((5, 2), (5, 2), (4, 3), (3, 0)):
        G = rng.randn(n, n)
        Ms.append(G @ G.T + n * np.eye(n))
        Ts.append(rng.randn(n, t))
    Ms[1] = np.diag(rng.rand(5) + 1.0)        # the diagonal fast path
    for (Ut, st), (Uj, sj) in zip(tb.batched_weighted_svd(Ms, Ts),
                                  jb.batched_weighted_svd(Ms, Ts)):
        np.testing.assert_array_equal(Ut, Uj)
        np.testing.assert_array_equal(st, sj)
    for (Ut, st), (Uj, sj) in zip(tb.batched_plain_svd(Ts),
                                  jb.batched_plain_svd(Ts)):
        np.testing.assert_array_equal(Ut, Uj)
        np.testing.assert_array_equal(st, sj)
