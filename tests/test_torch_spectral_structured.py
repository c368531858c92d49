"""Parity of the port's structured spectral Hdiv-L2 engine
(amge/structured_spectral.py, amge/structured_spectral_ml.py) and of
models/spectral.py with the JAX package on the CPU, in f64 direct
solves (the JAX stages under tests/conftest.py's x64, 'direct' mode).

Eigenvector signs and bases of degenerate eigenvalues follow the LAPACK
build, so the coarse spaces are compared, not the matrices: equal
per-entity counts and P shapes, the Darcy upscaling error to 1e-8
relative (the convention-free standard of the JAX package's
tests/test_structured_spectral.py; an absolute floor of 1e-12 where a
coarse space reproduces the fine solution and the error is rounding),
and the column spaces:
||P_port - P_jax G|| <= 1e-8 ||P_port|| with G the M-weighted
least-squares fit."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelag_tpu.amge import structured_spectral as jsps
from parelag_tpu.amge import structured_spectral_ml as jml
from parelag_tpu_torch import spectral_lane
from parelag_tpu_torch.amge import structured as stc
from parelag_tpu_torch.amge import structured_spectral as tsps
from parelag_tpu_torch.amge import structured_spectral_ml as tml

torch.set_num_threads(1)

SHAPE = (8, 8, 4)


def _coeff_field(shape, seed=3, sigma=2.0):
    """The random field of the JAX package's
    tests/test_structured_spectral.py."""
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-sigma, sigma, size=int(np.prod(shape)))


def _ops(shape, coeff):
    """Fine (M2, W, B) of the mixed Darcy problem (h = 1/shape)."""
    h = tuple(1.0 / s for s in shape)
    nc, nf, _, _ = stc.grid_counts(shape)
    ref = stc.fine_local_masses(h)
    M2 = stc.assemble_global(coeff[:, None, None] * ref[(0, 2)][None],
                             stc.cell_faces(shape), sum(nf))
    W = sp.diags(np.full(nc, float(ref[(0, 3)][0, 0]))).tocsr()
    _, _, d2 = stc.fine_derivative_values(shape, h)
    D2 = stc.assemble_d_csr(d2, stc.d2_cols(shape), (nc, sum(nf)))
    return M2.tocsr(), W, (W @ D2).tocsr()


def _upscale_err(ops, P2, P3):
    """u upscaling error of the mixed Darcy problem (unit source,
    natural BC), fine direct solve against the Galerkin-coarse one."""
    M2, W, B = ops
    nu = M2.shape[0]
    A = sp.bmat([[M2, B.T], [B, None]], format="csc")
    uf = spla.spsolve(A, np.concatenate([np.zeros(nu), W.diagonal()]))[:nu]
    P2, P3 = sp.csr_matrix(P2), sp.csr_matrix(P3)
    Ac = sp.bmat([[P2.T @ M2 @ P2, (P3.T @ B @ P2).T],
                  [P3.T @ B @ P2, None]], format="csc")
    xc = spla.spsolve(Ac, np.concatenate([np.zeros(P2.shape[1]),
                                          P3.T @ W.diagonal()]))
    du = P2 @ xc[:P2.shape[1]] - uf
    return float(np.sqrt(du @ (M2 @ du)) / np.sqrt(uf @ (M2 @ uf)))


def _span_gap(Pt, Pj, M):
    """||Pt - Pj G|| / ||Pt|| with G the M-weighted least-squares fit
    (dense, small shapes)."""
    Pt, Pj = np.asarray(sp.csr_matrix(Pt).todense()), \
        np.asarray(sp.csr_matrix(Pj).todense())
    M = np.asarray(sp.csr_matrix(M).todense())
    G = np.linalg.solve(Pj.T @ M @ Pj, Pj.T @ M @ Pt)
    return np.linalg.norm(Pt - Pj @ G) / np.linalg.norm(Pt)


@pytest.mark.parametrize("f", [(2, 2, 2), (4, 4, 2)])
@pytest.mark.parametrize("max_evects", [2, 5])
def test_spectral_coarsen_darcy_matches_jax(f, max_evects):
    coeff = _coeff_field(SHAPE)
    oj = jsps.spectral_coarsen_darcy(SHAPE, f, coeff, max_evects=max_evects)
    ot = tsps.spectral_coarsen_darcy(SHAPE, f, coeff, max_evects=max_evects,
                                     device="cpu")
    for k in ("n_facet_dofs", "n_ae_u_dofs", "n_ae_p_dofs"):
        assert np.array_equal(getattr(ot, k), getattr(oj, k)), k
    assert ot.P2.shape == oj.P2.shape and ot.P3.shape == oj.P3.shape
    ops = _ops(SHAPE, coeff)
    et, ej = _upscale_err(ops, ot.P2, ot.P3), _upscale_err(ops, oj.P2, oj.P3)
    assert abs(et - ej) <= 1e-8 * ej + 1e-12, (et, ej)
    assert _span_gap(ot.P2, oj.P2, ops[0]) <= 1e-8
    assert _span_gap(ot.P3, oj.P3, ops[1]) <= 1e-8
    # the direct solves' residuals and the f64 spot oracle
    assert ot.ns_res < 1e-10 and ot.ext_spot_err < 1e-8
    assert set(ot.stage_s) >= {"spec", "t3", "t2a", "ext", "materialize"}


@pytest.fixture(scope="module")
def chunk():
    """One chunk of the (8, 8, 4) / (2, 2, 2) coarsening's stage inputs,
    gathered on the host: the spectral stage's and the L2 trace
    stage's."""
    f, shape = (2, 2, 2), SHAPE
    cshape = tuple(s // ff for s, ff in zip(shape, f))
    h = tuple(1.0 / s for s in shape)
    coeff = _coeff_field(shape)
    ref = stc.fine_local_masses(h)
    nc, nf, _, _ = stc.grid_counts(shape)
    cells = tsps.ae_cells(cshape, f)
    faces, nu_int = tsps.ae_faces(cshape, f)
    m02 = coeff[:, None, None] * ref[(0, 2)][None]
    m03 = np.full(nc, float(ref[(0, 3)][0, 0]))
    m12 = np.concatenate([np.full(nf[a], float(ref[(1, 2)][a][0, 0]))
                          for a in range(3)])
    _, _, d2 = stc.fine_derivative_values(shape, h)
    return dict(args=(m02[cells], m03[cells], m12[faces[:, nu_int:]],
                      d2[cells]), fslot=tsps.cell_face_slots(f),
                nu_int=nu_int)


def test_spectral_stage_matches_jax(chunk):
    """_spectral_stage alone: the kept counts equal, the port's
    eigenvalues within 1e-10 of the Rayleigh quotients of JAX's kept
    eigenvectors, and the kept spans equal."""
    a, fs, ni = chunk["args"], chunk["fslot"], chunk["nu_int"]
    K = 5
    Vj, nj = jsps._spectral_stage(*map(jnp.asarray, a), fs, ni, 0.002, K)
    Vt, nt, w, margin, res = tsps._spectral_stage(
        *map(torch.as_tensor, a), fs, ni, 0.002, K)
    Vj, nj = np.asarray(Vj), np.asarray(nj)
    assert np.array_equal(nt.numpy(), nj) and res.item() < 1e-12
    assert (margin.numpy() > 0).all()
    # the generalized problem S v = lam blkdiag(W, Q) v, assembled here
    m02, m03, m12, d2 = a
    nu = ni + m12.shape[1]
    for e in range(len(nj)):
        M = np.zeros((nu, nu))
        Bl = np.zeros((m03.shape[1], nu))
        for i, sl in enumerate(fs):
            M[np.ix_(sl, sl)] += m02[e, i]
            Bl[i, sl] = m03[e, i] * d2[e, i]
        C = np.zeros((m12.shape[1], nu))
        C[np.arange(m12.shape[1]), ni + np.arange(m12.shape[1])] = m12[e]
        BC = np.vstack([Bl, C])
        S = BC @ np.linalg.solve(M, BC.T)
        R = np.concatenate([m03[e], m12[e]])
        k = nj[e]
        Vje, Vte = Vj[e][:, :k], Vt[e].numpy()[:, :k]
        lam = np.einsum("ik,ij,jk->k", Vje, S, Vje) / np.einsum(
            "ik,i,ik->k", Vje, R, Vje)
        assert np.abs(w[e, :k].numpy() - lam).max() <= 1e-10 * max(
            1.0, abs(w[e, -1].item()))
        G = np.linalg.lstsq(Vje, Vte, rcond=None)[0]
        assert np.linalg.norm(Vte - Vje @ G) <= 1e-8 * np.linalg.norm(Vte)


def test_trace_stage_matches_jax(chunk):
    """_trace_stage_targets alone on the L2 trace inputs with random
    targets: nkeep and ptr exact, F and dots to 1e-12, equal spans."""
    m03 = chunk["args"][1]
    n, nd = m03.shape
    T = np.random.RandomState(1).randn(n, nd, 5)
    T[:, :, 4] = T[:, :, 0] + 2.0 * T[:, :, 1]          # a dependent one
    pv = np.ones_like(m03)
    j = [np.asarray(v) for v in jsps._trace_stage_targets(
        jnp.asarray(m03), jnp.asarray(pv), jnp.asarray(T), 1e-9, 5)]
    t = [v.numpy() for v in tsps._trace_stage_targets(
        torch.as_tensor(m03), torch.as_tensor(pv), torch.as_tensor(T),
        1e-9, 5)]
    assert np.array_equal(t[0], j[0]) and np.array_equal(t[3], j[3])
    assert (t[3] == 4).all()
    assert _rel(t[1], j[1]) <= 1e-12 and _rel(t[4], j[4]) <= 1e-12
    for e in range(n):
        k = t[3][e]
        G = np.linalg.lstsq(j[2][e][:, :k], t[2][e][:, :k], rcond=None)[0]
        assert np.linalg.norm(t[2][e][:, :k] - j[2][e][:, :k] @ G) <= \
            1e-10 * np.linalg.norm(t[2][e][:, :k])


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("max_evects", [2, 4])
def test_chain_matches_jax(max_evects):
    """spectral_coarsen_darcy_chain at (8, 8, 4) over (2,2,2), (2,2,1):
    every level's dims and per-entity counts equal, the upscaling error
    of the composed prolongations to 1e-8."""
    coeff = _coeff_field(SHAPE)
    facs = [(2, 2, 2), (2, 2, 1)]
    lj, oj = jml.spectral_coarsen_darcy_chain(SHAPE, facs, coeff,
                                              max_evects=max_evects)
    lt, ot = tml.spectral_coarsen_darcy_chain(SHAPE, facs, coeff,
                                              max_evects=max_evects,
                                              device="cpu")
    assert [o.P2.shape for o in ot] == [o.P2.shape for o in oj]
    assert [o.P3.shape for o in ot] == [o.P3.shape for o in oj]
    for a, b in zip(lt[1:], lj[1:]):
        for k in ("facet_n", "cell_pn", "cell_rt_n", "cell_null_n"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    ops = _ops(SHAPE, coeff)
    errs = []
    for outs in (ot, oj):
        P2, P3 = outs[0].P2, outs[0].P3
        for o in outs[1:]:
            P2, P3 = P2 @ o.P2, P3 @ o.P3
        errs.append(_upscale_err(ops, P2, P3))
    assert abs(errs[0] - errs[1]) <= 1e-8 * errs[1] + 1e-12, errs
    assert max(o.ns_res for o in ot) < 1e-10
    assert max(o.ext_spot_err for o in ot) < 1e-8


def test_models_spectral_golden():
    """models/spectral.py (a copy of the JAX module): the
    form2spectralAMGe golden values of the JAX package's
    tests/test_spectral.py."""
    from parelag_tpu_torch.models.spectral import (
        upscaling_2form_spectral_amge)
    r = upscaling_2form_spectral_amge()
    assert f"{r.u_l2_errors[0]:.4e}" == "7.4780e-04"
    assert f"{r.u_energy_errors[0]:.4e}" == "1.3227e-02"
    assert r.u_l2_errors[1] < 1e-10 and r.u_energy_errors[1] < 1e-10


def test_spectral_lanes_on_the_cpu():
    """spectral_lane's two lanes at (8, 8, 4) on the CPU: the JAX
    records' fields, the JAX engine's coarse dims on the same field and
    factors, and u_l2_rel against the test's own direct solves."""
    from parelag_tpu_torch.models.spe10 import synthetic_spe10_field
    cells = SHAPE
    rec, out = spectral_lane.lane_spe10_structured(cells, device="cpu")
    field = synthetic_spe10_field(cells, seed=0)
    coeff = field.inv_perm.mean(-1).transpose(2, 1, 0).ravel()
    f = spectral_lane._pick_factors(cells)
    oj = jsps.spectral_coarsen_darcy(cells, f, coeff, h=field.sizes)
    assert (rec["ndofs_u"], rec["coarse_u"], rec["coarse_p"]) == \
        (oj.P2.shape[0], oj.P2.shape[1], oj.P3.shape[1])
    fine = spectral_lane.fine_darcy(cells, coeff, field.sizes)
    ops = fine[:3]
    assert abs(rec["u_l2_rel"] - _upscale_err(ops, oj.P2, oj.P3)) <= \
        1e-8 * rec["u_l2_rel"]
    for k in ("factors", "setup_s", "value", "stage_s", "ext_spot_err"):
        assert k in rec
    mrec, (levels, outs) = spectral_lane.lane_spe10_ml(cells, device="cpu")
    assert mrec["nlevels"] == 3 and len(mrec["coarse_u"]) == 2
    assert mrec["ns_res"] < 1e-10 and mrec["ext_spot_err"] < 1e-8
    assert 0 < mrec["u_l2_rel"] < 1
