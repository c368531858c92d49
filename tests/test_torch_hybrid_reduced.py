"""HybridHdivL2.solve's reduced multiplier system, built once per operator
and kept (parelag_tpu_torch/amge/hybridization.py, `_reduced`): repeated
solves on one object give bitwise what a fresh object's single solve
gives, for every solver and with and without the rescaling; the span
"hybrid.reduce_build" counts one build per (rescale, format) and system;
the solves leave the hybridized system and the kept reduced system
unchanged, and an `inner` solver gets the reduced system it got before.
This file imports neither jax nor parelag_tpu."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelag_tpu_torch.amge.hybridization import HybridHdivL2
from parelag_tpu_torch.models import darcy as tdarcy
from parelag_tpu_torch.utils.timing import TimeManager

torch.set_num_threads(1)

SOLVERS = ["direct", "cg", "amg", "device"]


def _rhss(seq, n=3):
    nu, npp = seq.dof[seq.dim - 1].ndofs, seq.dof[seq.dim].ndofs
    rng = np.random.RandomState(18)
    return [(rng.randn(nu), rng.randn(npp)) for _ in range(n)]


@pytest.fixture(scope="module")
def levels():
    """Levels of build_darcy_hierarchy, each with three right-hand sides
    that carry essential data (rhs_u) and a source (rhs_p): "fine" the
    fine level at nref 1 (test_torch_darcy's problem; its rescaling is
    1), "coarse" the algebraic coarse level at nref 2 (53 free
    multipliers, a rescaling that is not 1), "no_free" the coarse level
    at nref 1 (every multiplier essential)."""
    _, _, seqs1 = tdarcy.build_darcy_hierarchy(nref_parallel=1)
    _, _, seqs2 = tdarcy.build_darcy_hierarchy(nref_parallel=2)
    return {name: (seq, _rhss(seq)) for name, seq in
            (("fine", seqs1[0]), ("coarse", seqs2[1]),
             ("no_free", seqs1[1]))}


@pytest.fixture(scope="module")
def darcy(levels):
    return levels["fine"]


@pytest.fixture
def registry():
    TimeManager.clear()
    yield TimeManager
    TimeManager.clear()


def _count(name):
    return TimeManager.totals().get(name, (0.0, 0))[1]


def _arrays(A):
    return [A.data.copy(), A.indices.copy(), A.indptr.copy()]


def _same_arrays(A, arrays):
    return all(np.array_equal(a, b) for a, b in zip(_arrays(A), arrays))


def _solve(hyb, rhs, solver, rescale, **kw):
    return hyb.solve(*rhs, solver=solver, rescale=rescale, rtol=1e-10,
                     device="cpu", **kw)


def _expected_reduced(hyb, rescale):
    """The free multiplier system as solve() built it on every call."""
    keep = ~hyb.ess_mult
    Hff = hyb.hybrid_system[keep][:, keep].tocsc()
    if rescale:
        d = hyb.rescaling[keep]
        d = np.where(np.abs(d) > 0, d, 1.0)
        Hff = sp.diags(d) @ Hff @ sp.diags(d)
    return Hff.tocsr()


def _solve_rebuilding(hyb, rhs, solver, rescale):
    """solve() as it was with the reduced system built on every call: the
    system's copy, the essential lift, the slicing, the rescaling and
    the format, then the same solver and recovery."""
    g, ess_data = hyb.rhs_transform(*rhs)
    H = hyb.hybrid_system.copy()
    mu = np.zeros(hyb.n_mult)
    ess = hyb.ess_mult
    mu[ess] = ess_data[ess]
    g = g - H @ (mu * ess)
    keep = ~ess
    if keep.any():
        Hff = H[keep][:, keep].tocsc()
        gf = g[keep]
        if rescale:
            d = hyb.rescaling[keep]
            d = np.where(np.abs(d) > 0, d, 1.0)
            Hff = sp.diags(d) @ Hff @ sp.diags(d)
            gf = d * gf
        if solver != "direct":
            Hff = Hff.tocsr()
        xf = hyb._solve_free(Hff, gf, 1e-10, solver, None, "cpu")
        mu[keep] = d * xf if rescale else xf
    return hyb.recover(mu)


@pytest.mark.parametrize("level", ["fine", "coarse", "no_free"])
@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("solver", SOLVERS)
def test_repeated_solves_match_a_fresh_solve_bitwise(levels, level, solver,
                                                     rescale):
    """Three solves on one object against a fresh object's single solve
    and against the solve that rebuilds the reduced system, bitwise (and
    the device solve's record)."""
    seq, rhss = levels[level]
    hyb = HybridHdivL2(seq)
    for rhs in rhss:
        u, p = _solve(hyb, rhs, solver, rescale)
        fresh = HybridHdivL2(seq)
        u0, p0 = _solve(fresh, rhs, solver, rescale)
        assert np.array_equal(u, u0) and np.array_equal(p, p0)
        if solver == "device" and level != "no_free":
            assert hyb.last_device == fresh.last_device
        u1, p1 = _solve_rebuilding(HybridHdivL2(seq), rhs, solver, rescale)
        assert np.array_equal(u, u1) and np.array_equal(p, p1)
    assert np.abs(u).max() > 0 and np.abs(p).max() > 0


def test_one_build_per_system_and_format(registry, darcy):
    seq, rhss = darcy
    hyb = HybridHdivL2(seq)
    for rhs in rhss:
        _solve(hyb, rhs, "cg", True)
    assert _count("hybrid.reduce_build") == 1
    assert _count("hybrid.transform") == 3
    assert _count("hybrid.reduce") == 3
    _solve(hyb, rhss[0], "cg", False)
    assert _count("hybrid.reduce_build") == 2
    _solve(hyb, rhss[1], "amg", True)         # the same CSR system
    _solve(hyb, rhss[2], "cg", False)
    assert _count("hybrid.reduce_build") == 2
    _solve(hyb, rhss[0], "direct", True)      # the direct solve's format
    assert _count("hybrid.reduce_build") == 3
    hyb.hybrid_system = hyb.hybrid_system.copy()
    _solve(hyb, rhss[1], "cg", True)
    assert _count("hybrid.reduce_build") == 4
    assert _count("hybrid.transform") == 8


@pytest.mark.parametrize("solver", SOLVERS)
def test_solves_leave_the_systems_unchanged(darcy, solver):
    seq, rhss = darcy
    hyb = HybridHdivL2(seq)
    H = _arrays(hyb.hybrid_system)
    _solve(hyb, rhss[0], solver, True)
    fmt = "csc" if solver == "direct" else "csr"
    keep, d, Hff = hyb._reduced(True, fmt)
    kept = _arrays(Hff)
    for rhs in rhss[1:]:
        _solve(hyb, rhs, solver, True)
    assert hyb._reduced(True, fmt)[2] is Hff
    assert _same_arrays(Hff, kept)
    assert _same_arrays(hyb.hybrid_system, H)
    assert abs(Hff - _expected_reduced(hyb, True)).max() == 0


@pytest.mark.parametrize("rescale", [True, False])
def test_inner_gets_the_reduced_system(darcy, rescale):
    seq, rhss = darcy
    hyb = HybridHdivL2(seq)
    expected = _arrays(_expected_reduced(hyb, rescale))
    got = []

    def inner(Hff, gf, rtol):
        got.append((Hff, _arrays(Hff)))
        return spla.spsolve(Hff.tocsc(), gf), 1

    for rhs in rhss:
        _solve(hyb, rhs, "direct", rescale, inner=inner)
    assert len(got) == 3 and hyb.last_iterations == 1
    for Hff, arrays in got:
        assert Hff.format == "csr" and Hff is got[0][0]
        assert all(np.array_equal(a, b) for a, b in zip(arrays, expected))
    assert _same_arrays(got[0][0], expected)
