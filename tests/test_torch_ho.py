"""The high-order de Rham spaces (ROADMAP A11) and the ho_p2 lane against
the JAX package on the CPU, on the same inputs.

Tolerances: the copied spaces run the same numpy code, so D and every
local mass M[(codim, form)] agree within 1e-12 relative (the edited
_metric_mass sums in another order); after coarsen(), on the host
pass-2 backend and on the "device" backend with device="cpu" (f64 torch
solves), P, the cochain projectors and the coarse dims agree within
1e-12 (1e-11 in 2D, see there); the two edited contractions equal the JAX einsums within 1e-13 on
random stacks; UpscalingGeneralForm's errors within 1e-10; the lane's
PCG iterations within one of the same lane built from the JAX modules,
both with rel_res <= 1e-4 (10 x rtol, tune_cycle's rule).

The JAX package's coarsen() pays its slow three-operand einsum (about
1.6 s an agglomerate at p = 2 here), so each JAX sequence is built once
per module at 4^3 or less."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.amge import fespace2d as jfe2
from parelag_tpu.amge import fespace2d_ho as jfe2ho
from parelag_tpu.amge import fespace3d_ho as jfe3
from parelag_tpu.amge import fespace3d_tet_ho as jtet
from parelag_tpu.mesh import mesh as jmesh
from parelag_tpu.mesh import vtk as jvtk
from parelag_tpu.topology import topology as jtopo
from parelag_tpu_torch import ho_lane
from parelag_tpu_torch.amge import fespace2d as tfe2
from parelag_tpu_torch.amge import fespace2d_ho as tfe2ho
from parelag_tpu_torch.amge import fespace3d_ho as tfe3
from parelag_tpu_torch.amge import fespace3d_tet_ho as ttet
from parelag_tpu_torch.mesh import mesh as tmesh
from parelag_tpu_torch.mesh import vtk as tvtk
from parelag_tpu_torch.partitioning.partitioners import cartesian_partition
from parelag_tpu_torch.topology import topology as ttopo

torch.set_num_threads(1)

TOL = 1e-12
SIDES = {"jax": (jmesh, jtopo), "port": (tmesh, ttopo)}


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} != {b.shape}")
    return np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(initial=0.0),
                                                1e-300)


def _sprel(A, B):
    assert A.shape == B.shape
    D = sp.csr_matrix(A - B)
    den = max(np.abs(sp.csr_matrix(B).data).max(initial=0.0), 1e-300)
    return np.abs(D.data).max(initial=0.0) / den


def _same_spaces(a, b):
    """D and every local mass of two fine sequences."""
    for j, (Da, Db) in enumerate(zip(a.D, b.D)):
        if Db is not None:
            assert _sprel(Da, Db) < TOL, ("D", j)
    assert set(a.M) == set(b.M)
    for key in b.M:
        ca, cb = a.M[key].concatenated(), b.M[key].concatenated()
        np.testing.assert_array_equal(ca[0], cb[0])
        assert _rel(ca[2], cb[2]) < TOL, ("M", key)


def _same_coarsening(a, b, ca, cb, tol=TOL):
    """P, the cochain projectors and the coarse dims of two coarsened
    sequences a -> ca and b -> cb."""
    assert [d.ndofs for d in ca.dof] == [d.ndofs for d in cb.dof]
    for j in range(b.nforms):
        assert _sprel(a.P[j], b.P[j]) < tol, ("P", j, _sprel(a.P[j], b.P[j]))
        assert _sprel(a.Pi[j].matrix, b.Pi[j].matrix) < tol, ("Pi", j)


def _hex_seq(side, nx, p, backend=None):
    """The lane's setup on an nx^3 grid at order p: 2x2x2 cartesian
    agglomerates, order-0 targets, one coarsen() (backend None: the
    sequence's default, the host)."""
    m_, t_ = SIDES[side]
    mesh = m_.hex_grid_mesh(nx, nx, nx)
    topo = t_.AgglomeratedTopology.from_mesh(mesh)
    topo.coarsen_local_partitioning(
        cartesian_partition((nx, nx, nx), (2, 2, 2)))
    cls = (jfe3 if side == "jax" else tfe3).DeRhamSequence3DFE_HO
    seq = cls(topo, mesh, p)
    seq.set_upscaling_targets(0)
    if backend is not None:
        seq.solve_backend = backend
        seq.solve_device = "cpu"
    return seq, seq.coarsen()


@pytest.fixture(scope="module")
def jax_hex():
    """The JAX package's sequences, built once: {(nx, p): (fine,
    coarse)}."""
    return {}


HEX_CASES = [(3, 1), (3, 2), (4, 1), (4, 2)]


@pytest.mark.parametrize("nx,p", HEX_CASES,
                         ids=[f"{n}^3-p{p}" for n, p in HEX_CASES])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_hex_ho_matches_jax(jax_hex, nx, p, backend):
    if (nx, p) not in jax_hex:
        jax_hex[(nx, p)] = _hex_seq("jax", nx, p)
    js, jc = jax_hex[(nx, p)]
    ts, tc = _hex_seq("port", nx, p, backend)
    _same_spaces(ts, js)
    _same_coarsening(ts, js, tc, jc)


@pytest.mark.parametrize("p", [0, 1, 2])
def test_2d_spaces_match_jax(p):
    """The 2D spaces on a 4^2 quad grid: DeRhamSequence2DFE_HO at order
    p (and the lowest-order DeRhamSequence2DFE beside p = 0), fine
    spaces and one coarsening by 2x2 agglomerates."""
    out = {}
    for side, (m_, t_) in SIDES.items():
        mesh = m_.quad_grid_mesh(4, 4)
        topo = t_.AgglomeratedTopology.from_mesh(mesh)
        topo.coarsen_local_partitioning(
            cartesian_partition((4, 4, 1), (2, 2, 1)))
        mods = (jfe2ho, jfe2) if side == "jax" else (tfe2ho, tfe2)
        seqs = [mods[0].DeRhamSequence2DFE_HO(topo, mesh, feorder=p)]
        if p == 0:
            seqs.append(mods[1].DeRhamSequence2DFE(topo, mesh))
        out[side] = [(s, s.coarsen()) for s in seqs]
    for (ts, tc), (js, jc) in zip(out["port"], out["jax"]):
        _same_spaces(ts, js)
        # P0 at p = 2 differs by 2.8e-12: its local H1 solves amplify
        # the rounding of sequence.py's Cst edit (every other P: <= 1.3e-14)
        _same_coarsening(ts, js, tc, jc, tol=1e-11)


def _kuhn_tets(side, n):
    """A Kuhn split of the n^3 hex grid of [0,1]^3: each cube into the 6
    tets along its x/y/z paths from the min to the max corner (every
    face cut along the diagonal through its min corner, so neighbours
    conform), positively oriented; boundary quads split the same way.
    Tet e belongs to cube e // 6."""
    m_ = SIDES[side][0]
    hexm = m_.hex_grid_mesh(n, n, n)
    V = hexm.vertices
    tets = []
    paths = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
             (2, 1, 0)]
    for el in hexm.elements:
        lo = V[el].min(axis=0)
        bits = {tuple((V[v] > lo + 1e-12).astype(int)): v for v in el}
        for path in paths:
            c = [0, 0, 0]
            tet = [bits[tuple(c)]]
            for ax in path:
                c[ax] = 1
                tet.append(bits[tuple(c)])
            a, b, cc, d = (V[v] for v in tet)
            if np.linalg.det(np.stack([b - a, cc - a, d - a])) < 0:
                tet[2], tet[3] = tet[3], tet[2]
            tets.append(tet)
    bdr, battr = [], []
    for f, at in zip(hexm.bdr_faces, hexm.bdr_attrib):
        lo, hi = V[f].min(axis=0), V[f].max(axis=0)
        vmin = [v for v in f if np.allclose(V[v], lo)][0]
        vmax = [v for v in f if np.allclose(V[v], hi)][0]
        for v in f:
            if v not in (vmin, vmax):
                bdr.append([vmin, v, vmax])
                battr.append(at)
    return m_.Mesh(vertices=V.copy(), elements=np.array(tets, np.int64),
                   kind="tet", attrib=np.ones(len(tets), np.int64),
                   bdr_faces=np.array(bdr, np.int64),
                   bdr_attrib=np.array(battr, np.int64))


@pytest.mark.parametrize("p", [1, 2])
def test_tet_ho_matches_jax(p):
    """DeRhamSequenceTetFE_HO on a Kuhn split of the 2^3 hex grid (48
    tets; the reference's cube456.mesh is not in the repository), fine
    spaces and one coarsening by the tets of each cube."""
    out = {}
    for side, (m_, t_) in SIDES.items():
        mesh = _kuhn_tets(side, 2)
        topo = t_.AgglomeratedTopology.from_mesh(mesh)
        topo.coarsen_local_partitioning(np.arange(mesh.num_elements) // 6)
        cls = (jtet if side == "jax" else ttet).DeRhamSequenceTetFE_HO
        seq = cls(topo, mesh, p)
        seq.set_upscaling_targets(0)
        out[side] = (seq, seq.coarsen())
    (ts, tc), (js, jc) = out["port"], out["jax"]
    assert np.abs((ts.D[1] @ ts.D[0]).toarray()).max() < 1e-11
    _same_spaces(ts, js)
    _same_coarsening(ts, js, tc, jc)


def test_metric_mass_edit_matches_jax():
    """The port's one-GEMM _metric_mass against the JAX module's nine
    broadcast products on random stacks (ne, nq, 3, 3), to 1e-13."""
    rng = np.random.RandomState(5)
    ne, nq, ndof = 37, 27, 54
    E = rng.randn(ndof, nq, 3)
    G = rng.randn(ne, nq, 3, 3)
    w = rng.rand(ne, nq)
    Mj = jfe3.DeRhamSequence3DFE_HO._metric_mass(None, E, G, w)
    Mt = tfe3.DeRhamSequence3DFE_HO._metric_mass(None, E, G, w)
    assert Mt.shape == Mj.shape == (ne, ndof, ndof)
    assert _rel(Mt, Mj) < 1e-13


def test_cst_edit_matches_the_einsum():
    """sequence.py's Cst as two batched matmuls against the reference's
    three-operand einsum (the edit SEQUENCE_EDITS pins), on random stacks
    of its shapes, to 1e-13."""
    rng = np.random.RandomState(6)
    D2i = rng.randn(7, 40, 25)
    W2 = rng.randn(7, 40, 40)
    W2st = W2 + W2.transpose(0, 2, 1)
    ref = np.einsum("bki,bkl,blj->bij", D2i, W2st, D2i, optimize=True)
    Cst = np.matmul(np.matmul(D2i.transpose(0, 2, 1), W2st), D2i)
    assert _rel(Cst, ref) < 1e-13


def test_upscaling_feorder1_matches_jax():
    from parelag_tpu.models import upscaling as jup
    from parelag_tpu_torch.models import upscaling as tup
    rt = tup.upscaling_general_form(0, nref_parallel=1, feorder=1)
    rj = jup.upscaling_general_form(0, nref_parallel=1, feorder=1)
    assert rt.ndofs[0] == rj.ndofs[0] == 729
    assert list(rt.ndofs) == list(rj.ndofs)
    for a, b in ((rt.u_l2_errors, rj.u_l2_errors),
                 (rt.u_energy_errors, rj.u_energy_errors)):
        assert _rel(a, b) < 1e-10


def test_lane_ho_matches_the_jax_lane(jax_hex):
    """lane_ho(4, p=2, device="cpu") against bench.py::lane_ho's steps
    run on the JAX modules (the same sequence, system, f32 hierarchy and
    bf16 preconditioner): iterations within one, both residuals within
    10 x rtol."""
    import jax.numpy as jnp
    from parelag_tpu.models.upscaling import (
        eliminate_rowcols, mark_dofs_on_bndr)
    from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
    from parelag_tpu.solvers.cg import pcg
    rec, (seqs, A, b, H, Hb, x) = ho_lane.lane_ho(4, 2, device="cpu")
    assert rec["ndofs"] == 2197 and rec["dims"][1] == [27, 54, 36, 8]
    assert rec["converged"] and rec["rel_res"] <= 10 * ho_lane.RTOL
    assert abs(rec["iters"] - rec["host_iters"]) <= 1

    if (4, 2) not in jax_hex:
        jax_hex[(4, 2)] = _hex_seq("jax", 4, 2)
    seq, coarse = jax_hex[(4, 2)]
    Aj = (seq.compute_mass_operator(0) + seq.D[0].T
          @ seq.compute_mass_operator(1) @ seq.D[0]).tocsr()
    bj = np.random.RandomState(0).randn(Aj.shape[0])
    marker = mark_dofs_on_bndr(seq, 0, {1, 2, 3, 4, 5, 6})
    Aj, bj = eliminate_rowcols(Aj, bj, marker, np.zeros(Aj.shape[0]))
    assert _sprel(A, Aj) < TOL and _rel(b, bj) < TOL
    Hj, _, _ = build_amge_hierarchy(
        [seq, coarse], 0, Aj.astype(np.float32), smoother="l1jacobi",
        sweeps=2, dtype=np.float32, matrix_format="dia",
        transfer_dtype=jnp.bfloat16)
    Hjb = Hj.cast(jnp.bfloat16)

    def precond(r):
        return Hjb.apply(r.astype(jnp.bfloat16)).astype(jnp.float32)

    xj, (itj, _) = pcg(lambda v: Hj.levels[0].A @ v,
                       jnp.asarray(bj.astype(np.float32)), precond=precond,
                       rtol=ho_lane.RTOL, atol=0.0, maxiter=ho_lane.MAXITER)
    relj = (np.linalg.norm(bj - Aj @ np.asarray(xj, np.float64))
            / np.linalg.norm(bj))
    assert abs(rec["iters"] - int(itj)) <= 1, (rec["iters"], int(itj))
    assert relj <= 10 * ho_lane.RTOL


def test_vtk_and_coloring_match_jax(tmp_path):
    """The copied visualization modules write the same agglomerate file
    (partition and greedy coloring) as the JAX package's."""
    paths = {}
    for side, (m_, t_) in SIDES.items():
        mesh = m_.hex_grid_mesh(4, 4, 2)
        topo = t_.AgglomeratedTopology.from_mesh(mesh)
        coarse = topo.coarsen_local_partitioning(
            cartesian_partition((4, 4, 2), (2, 2, 2)))
        vtk = jvtk if side == "jax" else tvtk
        paths[side] = os.path.join(tmp_path, f"{side}.vtk")
        vtk.save_agglomerates_vtk(topo, mesh, paths[side], coarse)
    with open(paths["jax"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
