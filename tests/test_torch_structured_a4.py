"""The structured engine's remaining forms (ROADMAP A4) on the CPU in f64:
materialize_P for jforms 2 and 3, coarsen_structured(jform_start=),
coarsen_darcy / materialize_P_darcy, the heterogeneous fine_level and
fine_global_masses against the JAX module (1e-12 relative: both sides
solve the same small dense systems with LAPACK, so only rounding
separates them), and the invariant contracts of tests/test_structured.py
on the port's own chain: D o D = 0, Galerkin masses for all four forms,
commutation, Pi P = I, the Darcy chain equal to the full chain, and the
heterogeneous chain."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.amge import structured as jst
from parelag_tpu_torch.amge import structured as tst

torch.set_num_threads(1)

TOL = 1e-12
SHAPES = [(4, 4, 4), (8, 8, 4)]
DARCY_FIELDS = ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c")
FIELDS_BY_START = {
    2: DARCY_FIELDS,
    1: DARCY_FIELDS + ("ptr1", "f1", "pf1", "pc1", "d1c"),
    0: DARCY_FIELDS + ("ptr1", "f1", "pf1", "pc1", "d1c", "pe0", "pf0",
                       "pc0", "d0c")}


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sprel(A, B):
    D = (A - B).tocsr()
    den = max(np.abs(B.data).max() if B.nnz else 0.0, 1e-300)
    return (np.abs(D.data).max() if D.nnz else 0.0) / den


def _per_ae_coeff(shape, cshape, seed=7):
    """A log-uniform coefficient constant on each coarse cell of cshape
    (test_structured.py's heterogeneous regime: agglomerate-resolved)."""
    rng = np.random.default_rng(seed)
    f = tuple(s // c for s, c in zip(shape, cshape))
    per_ae = 10.0 ** rng.uniform(-2, 2, size=int(np.prod(cshape)))
    k, j, i = np.meshgrid(*(np.arange(s) for s in shape[::-1]),
                          indexing="ij")
    ae = ((k // f[2]) * cshape[1] + j // f[1]) * cshape[0] + i // f[0]
    return per_ae[ae.ravel()]


@pytest.mark.parametrize("shape", SHAPES, ids=["4x4x4", "8x8x4"])
@pytest.mark.parametrize("jform_start", [0, 1, 2])
def test_jform_start_matches_jax(shape, jform_start):
    """coarsen_structured(jform_start=) emits the JAX module's outputs
    and coarse arrays, and leaves the forms below jform_start empty."""
    cj, oj = jst.coarsen_structured(jst.fine_level(shape),
                                    jform_start=jform_start)
    ct, ot = tst.coarsen_structured(tst.fine_level(shape, device="cpu"),
                                    jform_start=jform_start)
    for f in FIELDS_BY_START[jform_start]:
        assert _rel(getattr(ot, f).numpy(), getattr(oj, f)) < TOL, f
    for f in set(FIELDS_BY_START[0]) - set(FIELDS_BY_START[jform_start]):
        assert getattr(ot, f) is None and getattr(oj, f) is None, f
    for f, v in vars(cj).items():
        if f == "shape":
            continue
        if v is None:
            assert getattr(ct, f) is None, f
        else:
            assert _rel(getattr(ct, f).numpy(), v) < TOL, f


@pytest.mark.parametrize("shape", SHAPES, ids=["4x4x4", "8x8x4"])
@pytest.mark.parametrize("jform", [2, 3])
def test_materialize_P_high_forms_match_jax(shape, jform):
    _, oj = jst.coarsen_structured(jst.fine_level(shape), jform_start=0)
    _, ot = tst.coarsen_structured(tst.fine_level(shape, device="cpu"))
    Pj = jst.materialize_P(oj, shape, jform)
    Pt = tst.materialize_P(ot, shape, jform)
    assert Pt.shape == Pj.shape and _sprel(Pt, Pj) < TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["4x4x4", "8x8x4"])
def test_coarsen_darcy_matches_jax(shape):
    cj, oj = jst.coarsen_darcy(jst.fine_level(shape))
    ct, ot = tst.coarsen_darcy(tst.fine_level(shape, device="cpu"))
    assert isinstance(ot, tst.DarcyLevelOut) and ot.cshape == oj.cshape
    for f in DARCY_FIELDS:
        assert _rel(getattr(ot, f).numpy(), getattr(oj, f)) < TOL, f
    for f in ("cc", "cf", "cfaces", "ufaces"):
        np.testing.assert_array_equal(getattr(ot, f), getattr(oj, f))
    for f in ("m03", "m12", "m02", "d2", "pv2", "t3", "t2"):
        assert _rel(getattr(ct, f).numpy(), getattr(cj, f)) < TOL, f
    for Pt, Pj in zip(tst.materialize_P_darcy(ot, shape),
                      jst.materialize_P_darcy(oj, shape)):
        assert _sprel(Pt, Pj) < TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["4x4x4", "8x8x4"])
def test_heterogeneous_fine_level_matches_jax(shape):
    """fine_level(h=, coeff=, l2_weight=) holds the JAX module's arrays,
    and the per-AE heterogeneous level coarsens to its outputs;
    fine_global_masses with the same coefficient agrees too."""
    cshape = tuple(s // 2 for s in shape)
    coeff = _per_ae_coeff(shape, cshape)
    w = np.random.default_rng(3).uniform(0.5, 2.0, size=coeff.size)
    h = (0.5, 0.25, 0.125)
    lj = jst.fine_level(shape, h=h, coeff=coeff, l2_weight=w)
    lt = tst.fine_level(shape, h=h, coeff=coeff, l2_weight=w, device="cpu")
    for f, v in vars(lj).items():
        if f != "shape":
            assert _rel(getattr(lt, f).numpy(), v) < TOL, f
    lj = jst.fine_level(shape, coeff=coeff)
    lt = tst.fine_level(shape, coeff=coeff, device="cpu")
    _, oj = jst.coarsen_structured(lj, jform_start=0)
    _, ot = tst.coarsen_structured(lt)
    for f in FIELDS_BY_START[0]:
        assert _rel(getattr(ot, f).numpy(), getattr(oj, f)) < TOL, f
    mj = jst.fine_global_masses(shape, h, coeff=coeff)
    mt = tst.fine_global_masses(shape, h, coeff=coeff)
    for j in range(4):
        assert _sprel(mt[j], mj[j]) < TOL, j
        if j < 3:
            # the codim-0 masses of the level are the same operators
            assert _sprel(tst.global_mass(lt, j),
                          jst.fine_global_masses(shape, tuple(
                              1.0 / s for s in shape), coeff=coeff)[j]) \
                < TOL, j


def test_h1_uniform_cell_block_takes_h():
    h = (0.5, 0.25, 0.125)
    np.testing.assert_allclose(tst.h1_uniform_cell_block((4, 4, 4), h=h),
                               jst.h1_uniform_cell_block((4, 4, 4), h=h),
                               rtol=0, atol=1e-14)


# ------------------------------------------------------------------ #
# the invariant contracts of tests/test_structured.py, port chain
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def chain884():
    return tst.coarsen_chain(tst.fine_level((8, 8, 8), device="cpu"), 3,
                             jform_start=0)


def test_dd_zero_all_levels(chain884):
    levels, _ = chain884
    for lvl in levels:
        D0, D1, D2 = (tst.global_derivative(lvl, j) for j in range(3))
        assert np.abs((D1 @ D0).toarray()).max() < 1e-13
        assert np.abs((D2 @ D1).toarray()).max() < 1e-13


def _galerkin_and_commutation(levels, outs):
    """max over transitions and forms of the Galerkin residual
    |P^T M_f P - M_c| and the commutation residual |D_f P_j - P_j+1 D_c|,
    each relative to its largest entry."""
    gal = com = 0.0
    for lvl, out, coarse in zip(levels, outs, levels[1:]):
        P = [tst.materialize_P(out, lvl.shape, j) for j in range(4)]
        for j in range(4):
            gal = max(gal, _sprel((P[j].T @ tst.global_mass(lvl, j)
                                   @ P[j]).tocsr(),
                                  tst.global_mass(coarse, j)))
        for j in range(3):
            lhs = (tst.global_derivative(lvl, j) @ P[j]).tocsr()
            rhs = (P[j + 1] @ tst.global_derivative(coarse, j)).tocsr()
            com = max(com, _sprel(rhs, lhs))
    return gal, com


def test_galerkin_mass_and_commutation(chain884):
    """M_c = P^T M_f P for every form, and D_f P_j = P_{j+1} D_c, at
    every transition of the port's chain."""
    gal, com = _galerkin_and_commutation(*chain884)
    assert gal < 1e-12 and com < 1e-11, (gal, com)


def test_pi_p_identity(chain884):
    """Pi P = I for the L2 cell averages and the Hdiv facet fluxes."""
    levels, outs = chain884
    for lvl, out in zip(levels, outs):
        ncf = tst.grid_counts(lvl.shape)[0]
        nff = sum(tst.grid_counts(lvl.shape)[1])
        ncc = tst.grid_counts(out.cshape)[0]
        nfc = sum(tst.grid_counts(out.cshape)[1])
        F3 = sp.coo_matrix((out.f3.numpy().ravel(),
                            (np.repeat(np.arange(ncc), 8), out.cc.ravel())),
                           shape=(ncc, ncf)).tocsr()
        I3 = (F3 @ tst.materialize_P(out, lvl.shape, 3)).toarray()
        assert _rel(I3, np.eye(ncc)) < 1e-12
        F2 = sp.coo_matrix((out.f2.numpy().ravel(),
                            (np.repeat(np.arange(nfc), 4), out.cf.ravel())),
                           shape=(nfc, nff)).tocsr()
        I2 = (F2 @ tst.materialize_P(out, lvl.shape, 2)).toarray()
        assert _rel(I2, np.eye(nfc)) < 1e-12


def test_darcy_chain_matches_full_chain():
    lvl0 = tst.fine_level((4, 4, 4), device="cpu")
    cd, outd = tst.coarsen_darcy(lvl0)
    cs, outs = tst.coarsen_structured(lvl0, jform_start=0)
    for f in DARCY_FIELDS:
        assert _rel(getattr(outd, f).numpy(),
                    getattr(outs, f).numpy()) < 1e-14, f
    assert _rel(cd.m02.numpy(), cs.m02.numpy()) < 1e-14


def test_heterogeneous_chain_invariants():
    """Agglomerate-resolved coefficients: Galerkin and commutation hold
    on the weighted chain too (two levels at 4^3, the coefficient of
    test_structured.py: seed 7, one value per 2x2x2 agglomerate)."""
    shape = (4, 4, 4)
    lvl0 = tst.fine_level(shape, coeff=_per_ae_coeff(shape, (2, 2, 2)),
                          device="cpu")
    gal, com = _galerkin_and_commutation(
        *tst.coarsen_chain(lvl0, 2, jform_start=0))
    assert gal < 1e-12 and com < 1e-11, (gal, com)


def test_bad_jform_start_and_jform_are_refused():
    lvl0 = tst.fine_level((2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="jform_start"):
        tst.coarsen_structured(lvl0, jform_start=3)
    _, out = tst.coarsen_structured(lvl0)
    with pytest.raises(ValueError, match="jform"):
        tst.materialize_P(out, (2, 2, 2), 4)
