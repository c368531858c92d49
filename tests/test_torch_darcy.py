"""The port's hybridized mixed Darcy path (device_sparse's DIA + COO
split and block inverse, SA-AMG, HybridHdivL2's device solve, spectral
targets, SPE10, the blocked Darcy AMGe GMRES and the Krylov methods)
against the JAX package on the CPU, on the same seeded inputs.

Tolerances (f64 throughout unless stated): matvecs of the same matrix
within 1e-12 relative (summation order only); the copied host code
(SA setup, the hybridized system, its rescaling and facet blocks) gives
the same numbers; one SA V-cycle within 1e-10; the multiplier PCG takes
the JAX package's iterations and its x agrees within 1e-8 relative (the
r.z stop at rtol 1e-8); the port's f32 branch, refined on the host,
meets rtol and lies within 1e-6 of the JAX f64 solution; Krylov methods
the same iterations and x within 1e-10.  The module byte checks cover
the copied files and functions."""

import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parelag_tpu.amge import hexfe as jhexfe
from parelag_tpu.amge import hybridization as jhyb
from parelag_tpu.amge import spectral as jspec
from parelag_tpu.amge.fespace import DeRhamSequenceFE as JSeq
from parelag_tpu.mesh.mesh import hex_grid_mesh as jmesh
from parelag_tpu.models import darcy as jdarcy
from parelag_tpu.models import samplegen as jsamplegen
from parelag_tpu.models import spe10 as jspe10
from parelag_tpu.ops import device_sparse as jds
from parelag_tpu.solvers import block as jblock
from parelag_tpu.solvers import cg as jcg
from parelag_tpu.solvers import sa_amg as jsa
from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
from parelag_tpu_torch import convert, darcy_lane
from parelag_tpu_torch.amge import hybridization as thyb
from parelag_tpu_torch.amge import spectral as tspec
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE as TSeq
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh as tmesh
from parelag_tpu_torch.models import darcy as tdarcy
from parelag_tpu_torch.models import samplegen as tsamplegen
from parelag_tpu_torch.models import spe10 as tspe10
from parelag_tpu_torch.ops import device_sparse as tds
from parelag_tpu_torch.solvers import block as tblock
from parelag_tpu_torch.solvers import cg as tcg
from parelag_tpu_torch.solvers import sa_amg as tsa
from parelag_tpu_torch.solvers.hierarchy import build_hierarchy
from parelag_tpu_torch.solvers.smoothers import make_l1_jacobi
from parelag_tpu_torch.topology.topology import AgglomeratedTopology as TTopo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a = a.toarray() if sp.issparse(a) else np.asarray(a, dtype=np.float64)
    b = b.toarray() if sp.issparse(b) else np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(initial=0.0),
                                                1e-300)


def _np(t):
    return t.detach().to(torch.float64).cpu().numpy()


def _laplacian3d(nx):
    e = np.ones(nx)
    T = sp.diags([2 * e, -e[:-1], -e[:-1]], [0, 1, -1])
    I = sp.identity(nx)
    return (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
            + sp.kron(sp.kron(I, I), T)).tocsr()


def _hybrid(side, nx):
    """(hyb, Hs, gf) of bench.py::lane_darcy_hybridized at nx^3."""
    if side == "port":
        return darcy_lane.build_darcy_hyb(nx)
    mesh = jmesh(nx, nx, nx)
    seq = JSeq(JTopo.from_mesh(mesh), mesh)
    seq.jform_start = 2
    hyb = jhyb.HybridHdivL2(seq)
    vols = jhexfe.hex_volumes(mesh.vertices[mesh.elements])
    g, _ = hyb.rhs_transform(np.zeros(seq.dof[2].ndofs), vols)
    keep = ~hyb.ess_mult
    Hff = hyb.hybrid_system[keep][:, keep].tocsr()
    d = hyb.rescaling[keep]
    d = np.where(np.abs(d) > 0, d, 1.0)
    return hyb, (sp.diags(d) @ Hff @ sp.diags(d)).tocsr(), d * g[keep]


@pytest.fixture(scope="module")
def hyb8():
    return {side: _hybrid(side, 8) for side in ("jax", "port")}


# --------------------------------------------------------------------- #
# device_sparse: the DIA + COO split, COO, the block inverse
# --------------------------------------------------------------------- #

def test_dia_ell_split_matches_jax(hyb8):
    """to_dia_ell on the 8^3 multiplier system: the same 29 offsets, the
    same fill, and each part's matvec (and the whole) within 1e-12."""
    _, H, _ = hyb8["port"]
    assert tds.dia_ell_fill(H) == jds.dia_ell_fill(H) >= 0.5
    Dj = jds.to_dia_ell(H, dtype=np.float64)
    Dt = tds.to_dia_ell(H, dtype=np.float64, device="cpu")
    assert Dt.dia.offs == Dj.dia.offs and len(Dt.dia.offs) == 29
    x = np.random.RandomState(0).randn(H.shape[0])
    xt = torch.as_tensor(x)
    assert _rel(_np(Dt.ell @ xt), np.asarray(Dj.ell @ jnp.asarray(x))) \
        <= 1e-12
    assert _rel(_np(Dt @ xt), np.asarray(Dj @ jnp.asarray(x))) <= 1e-12
    assert _rel(_np(Dt @ xt), H @ x) <= 1e-12
    # the JAX objects carried across give the same products
    Dc = convert.matrix_from_numpy(jax.tree_util.tree_map(np.asarray, Dj),
                                   "cpu")
    assert _rel(_np(Dc @ xt), H @ x) <= 1e-12


@pytest.mark.parametrize("s", [1, 3])
def test_coo_matvec_matches_jax(s):
    rng = np.random.RandomState(s)
    A = sp.random(300, 200, density=0.03, random_state=rng, format="csr")
    x = rng.randn(200, s) if s > 1 else rng.randn(200)
    Ct = tds.to_coo(A, dtype=np.float64, device="cpu")
    assert _rel(_np(Ct @ torch.as_tensor(x)), A @ x) <= 1e-12
    if s == 1:
        Cj = jds.to_coo(A, dtype=np.float64)
        assert _rel(_np(Ct @ torch.as_tensor(x)),
                    np.asarray(Cj @ jnp.asarray(x))) <= 1e-12


def test_block_diag_inverse_matches_jax():
    """Buckets of 1 x 1, 2 x 2 and 3 x 3 blocks: the port's apply, the
    JAX one and the dense block-diagonal product agree within 1e-12; a
    2-D right-hand side applies column by column."""
    rng = np.random.RandomState(4)
    sizes, tensors, dense = (1, 2, 3), [], []
    for s, k in zip(sizes, (5, 4, 3)):
        if s == 1:
            T = rng.rand(k) + 0.5
            dense += [np.array([[t]]) for t in T]
        else:
            T = rng.randn(k, s, s)
            dense += list(T)
        tensors.append(T)
    Bj = jds.BlockDiagInverse([jnp.asarray(T) for T in tensors], sizes)
    Bt = tds.BlockDiagInverse([torch.as_tensor(T) for T in tensors], sizes)
    full = sp.block_diag(dense).toarray()
    r = rng.randn(full.shape[0])
    assert _rel(_np(Bt @ torch.as_tensor(r)), full @ r) <= 1e-12
    assert _rel(_np(Bt @ torch.as_tensor(r)),
                np.asarray(Bj @ jnp.asarray(r))) <= 1e-12
    R = rng.randn(full.shape[0], 3)
    assert _rel(_np(Bt @ torch.as_tensor(R)), full @ R) <= 1e-12
    Bf = Bt.to(torch.float32)
    assert Bf.dtype == torch.float32 and Bf.sizes == sizes


def test_ell_matvec_T_matches_jax():
    rng = np.random.RandomState(7)
    A = sp.random(120, 90, density=0.05, random_state=rng, format="csr")
    x = rng.randn(120)
    Et = tds.from_scipy(A, dtype=np.float64, device="cpu")
    Ej = jds.from_scipy(A, dtype=np.float64)
    y = _np(tds.ell_matvec_T(Et, torch.as_tensor(x)))
    assert _rel(y, A.T @ x) <= 1e-12
    assert _rel(y, np.asarray(jds.ell_matvec_T(Ej, jnp.asarray(x)))) \
        <= 1e-12
    assert np.array_equal(tds.diag_of(A), jds.diag_of(A))


def test_hierarchy_cast_keeps_or_casts_the_coarse_inverse():
    A = _laplacian3d(6)
    A_l, P_l = tsa.build_sa_hierarchy(A, coarse_size=50)
    H = build_hierarchy(A_l, P_l, lambda a, l: make_l1_jacobi(
        a, sweeps=2, device="cpu"), dtype=np.float64, device="cpu")
    kept = H.cast(torch.float32)
    cast = H.cast(torch.float32, keep_coarse_inv=False)
    assert kept.levels[-1].coarse_inv.dtype == torch.float64
    assert cast.levels[-1].coarse_inv.dtype == torch.float32
    assert cast.levels[0].pre.dinv.dtype == torch.float32
    assert H.levels[-1].coarse_inv.dtype == torch.float64    # a copy


# --------------------------------------------------------------------- #
# SA-AMG
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["laplacian 12^3", "multipliers 8^3"])
def test_sa_hierarchy_matches_jax(hyb8, which):
    """build_sa_hierarchy (copied host code): the same level sizes and
    the same operators within 1e-12."""
    if which.startswith("laplacian"):
        A, cs = _laplacian3d(12), 200
    else:
        A, cs = hyb8["port"][1], 100
    Aj, Pj = jsa.build_sa_hierarchy(A, coarse_size=cs)
    At, Pt = tsa.build_sa_hierarchy(A, coarse_size=cs)
    assert [a.shape for a in At] == [a.shape for a in Aj]
    assert len(At) >= 2
    for a, b in zip(At + Pt, Aj + Pj):
        assert _rel(a, b) <= 1e-12


def test_device_sa_cycle_matches_jax():
    """One V-cycle of build_device_sa_hierarchy (f64), port against JAX,
    and both against HostVCycle at the JAX test's 1e-8."""
    A = _laplacian3d(12)
    Hj, A_l, P_l = jsa.build_device_sa_hierarchy(A, dtype=np.float64,
                                                 coarse_size=200)
    Ht, _, _ = tsa.build_device_sa_hierarchy(A, dtype=np.float64,
                                             coarse_size=200, device="cpu")
    assert Ht.levels[-1].coarse_inv.dtype == torch.float64
    r = np.random.RandomState(1).rand(A.shape[0])
    yt = _np(Ht.cycle(torch.as_tensor(r)))
    assert _rel(yt, np.asarray(Hj.cycle(jnp.asarray(r)))) <= 1e-10
    assert _rel(yt, tsa.HostVCycle(A_l, P_l, sweeps=2)(r)) <= 1e-8


def test_device_sa_dtype_follows_the_device():
    Ht, _, _ = tsa.build_device_sa_hierarchy(_laplacian3d(8),
                                             coarse_size=100, device="cpu")
    assert all(b.dtype == torch.float64 for b in Ht.buffers()
               if b.is_floating_point())
    Hf, _, _ = tsa.build_device_sa_hierarchy(
        _laplacian3d(8), coarse_size=100, dtype=np.float32, device="cpu")
    assert all(b.dtype == torch.float32 for b in Hf.buffers()
               if b.is_floating_point())


def test_convert_sa_hierarchy_gives_the_same_cycle(hyb8):
    """The JAX hybridized device hierarchy (facet block-Jacobi fine
    smoother, l1-Jacobi below) and its DIA + COO operator, carried to the
    port by convert: the same cycle and matvec within 1e-12."""
    hj, H, _ = hyb8["jax"]
    perm, Hd, Hier, npad, dtype, f32 = hj._device_setup(H)
    assert dtype == np.float64 and not f32
    Hn = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hier), "cpu")
    assert type(Hn.levels[0].pre).__name__ == "BlockJacobiSmoother"
    Hdn = convert.matrix_from_numpy(jax.tree_util.tree_map(np.asarray, Hd),
                                    "cpu")
    r = np.random.RandomState(2).randn(npad)
    assert _rel(_np(Hn.cycle(torch.as_tensor(r))),
                np.asarray(Hier.cycle(jnp.asarray(r)))) <= 1e-12
    assert _rel(_np(Hdn @ torch.as_tensor(r)),
                np.asarray(Hd @ jnp.asarray(r))) <= 1e-12


# --------------------------------------------------------------------- #
# HybridHdivL2
# --------------------------------------------------------------------- #

def test_hybrid_system_matches_jax(hyb8):
    (hj, Hj, gj), (ht, Ht, gt) = hyb8["jax"], hyb8["port"]
    assert ht.n_mult == hj.n_mult
    assert np.array_equal(ht.ess_mult, hj.ess_mult)
    assert _rel(ht.hybrid_system, hj.hybrid_system) <= 1e-12
    assert _rel(ht.rescaling, hj.rescaling) <= 1e-12
    assert _rel(Ht, Hj) <= 1e-12 and _rel(gt, gj) <= 1e-12


@pytest.fixture(scope="module")
def spe10_coarse():
    """The spectral coarse level of spe10_darcy((8, 8, 4)): facet blocks
    of more than one multiplier."""
    from parelag_tpu_torch.amge.spectral import (
        compute_local_hdiv_l2_spectral_targets)
    from parelag_tpu_torch.partitioning.partitioners import graph_partition
    field = tspe10.synthetic_spe10_field((8, 8, 4), seed=0)
    nx, ny, nz = field.cells
    hx, hy, hz = field.sizes
    mesh = tmesh(nx, ny, nz, nx * hx, ny * hy, nz * hz)
    topo = TTopo.from_mesh(mesh)
    topo.coarsen_local_partitioning(graph_partition(
        topo.local_element_element(), mesh.num_elements // 8, seed=0))
    seq = TSeq(topo, mesh)
    seq.jform_start = 2
    seq.replace_mass_integrator(
        2, lambda p: field.inverse_permeability(p).mean(axis=-1))
    seq.set_upscaling_targets(0)
    seq.agglomerate_dofs()
    tr, l2 = compute_local_hdiv_l2_spectral_targets(seq, 0.002, 5)
    seq.set_local_targets(1, 2, tr)
    seq.set_local_targets(0, 3, l2)
    return thyb.HybridHdivL2(seq.coarsen(svd_tol=1e-9)).hybrid_system


@pytest.mark.parametrize("which", ["fine 8^3", "spe10 coarse"])
def test_facet_blocks_match_jax(hyb8, spe10_coarse, which):
    """_facet_blocks and _facet_block_inverse (copied): the same
    permutation and buckets; on the SPE10 spectral coarse level the
    blocks have more than one multiplier."""
    H = hyb8["port"][1] if which.startswith("fine") else spe10_coarse
    H = sp.csr_matrix(H)
    pj, bj = jhyb.HybridHdivL2._facet_blocks(H)
    pt, bt = thyb.HybridHdivL2._facet_blocks(H)
    assert np.array_equal(pt, pj)
    assert [s for s, _ in bt] == [s for s, _ in bj]
    for (_, T), (_, U) in zip(bt, bj):
        assert _rel(T, U) <= 1e-12
    if which == "spe10 coarse":
        assert max(s for s, _ in bt) > 1
    assert _rel(thyb.HybridHdivL2._facet_block_inverse(H),
                jhyb.HybridHdivL2._facet_block_inverse(H)) <= 1e-12


@pytest.mark.parametrize("nx,iters", [(8, 18), (12, 20)])
def test_device_solve_matches_jax(nx, iters):
    """_device_solve on the CPU (f64, one pass): the JAX package's
    iterations (20 at 12^3) and x within 1e-8; the same SA levels and
    operator format."""
    hj, Hj, gj = _hybrid("jax", nx)
    ht, Ht, gt = _hybrid("port", nx)
    xj = hj._device_solve(Hj, gj, rtol=1e-8)
    xt = ht._device_solve(Ht, gt, rtol=1e-8, device="cpu")
    assert ht.last_iterations == hj.last_iterations == iters
    assert ht.last_passes == 1
    assert _rel(xt, xj) <= 1e-8
    info = ht.last_device
    assert info["format"] == "DiaEllMatrix" and info["dia_offsets"] == 29
    assert info["sa_level_sizes"] == [int(l.A.shape[0])
                                      for l in hj._dev_cache[3].levels]
    # the r.z stop at rtol 1e-8 leaves ||r|| / ||b|| a few times above
    assert np.linalg.norm(gt - Ht @ xt) <= 1e-7 * np.linalg.norm(gt)


def test_device_solve_f32_branch_refines(hyb8):
    """The card's branch, forced on the CPU: f32 PCG (inner rtol 1e-6)
    inside f64 host refinement meets rtol 1e-8 in at most 4 passes and
    lies within 1e-6 of the JAX package's f64 solution."""
    hj, Hj, gj = hyb8["jax"]
    ht, Ht, gt = hyb8["port"]
    xj = hj._device_solve(Hj, gj, rtol=1e-8)
    xt = ht._device_solve(Ht, gt, rtol=1e-8, device="cpu",
                          dtype=np.float32)
    info = ht.last_device
    assert info["dtype"] == "float32" and 2 <= info["passes"] <= 4
    assert np.linalg.norm(gt - Ht @ xt) <= 1e-8 * np.linalg.norm(gt)
    assert _rel(xt, xj) <= 1e-6


@pytest.mark.parametrize("solver", ["device", "auto", "amg", "cg"])
def test_hybrid_solve_matches_jax(solver):
    """HybridHdivL2.solve on build_darcy_hierarchy's fine level (the JAX
    tests' problem): every solver of the port within 1e-7 of the JAX
    direct solve ("auto" with device="cpu" is the host SA-AMG PCG)."""
    mesh, _, seqs = jdarcy.build_darcy_hierarchy(nref_parallel=1)
    vols = jhexfe.hex_volumes(mesh.vertices[mesh.elements])
    b_u = np.zeros(seqs[0].dof[2].ndofs)
    u0, p0 = jhyb.HybridHdivL2(seqs[0]).solve(b_u, vols, solver="direct",
                                              rescale=True)
    _, _, tseqs = tdarcy.build_darcy_hierarchy(nref_parallel=1)
    u, p = thyb.HybridHdivL2(tseqs[0]).solve(
        b_u, vols, solver=solver, rescale=True, rtol=1e-12, device="cpu")
    assert np.abs(u - u0).max() < 1e-7 and np.abs(p - p0).max() < 1e-7


# --------------------------------------------------------------------- #
# SPE10, samples, spectral targets
# --------------------------------------------------------------------- #

def test_spe10_darcy_matches_jax():
    """spe10_darcy((8, 8, 4)) with spectral targets and the device
    multiplier solve: equal ndofs and multipliers, u_l2_rel within 1e-8
    (one f64 pass at rtol 1e-8 on both sides)."""
    kw = dict(cells=(8, 8, 4), n_levels=2, spectral=True,
              mult_solver="device")
    rj = jspe10.spe10_darcy(**kw)
    rt = tspe10.spe10_darcy(device="cpu", **kw)
    assert rt["ndofs"] == rj["ndofs"] and rt["iters"] == rj["iters"]
    assert abs(rt["u_l2_rel"] - rj["u_l2_rel"]) <= 1e-8
    assert all(d["dtype"] == "float64" and d["passes"] == 1
               for d in rt["device_solves"])


def test_sample_generator_matches_jax():
    sj = jsamplegen.HdivL2SampleGenerator(nref=1, seed=3).sample()
    st = tsamplegen.HdivL2SampleGenerator(nref=1, seed=3).sample()
    assert np.array_equal(st["kinv"], sj["kinv"])
    assert abs(st["u_l2_rel_err"] - sj["u_l2_rel_err"]) <= 1e-8


def _spectral_blocks():
    rng = np.random.RandomState(3)
    blocks = []
    for i in range(80):
        n = 7 if i % 2 else 9
        Q = np.linalg.qr(rng.randn(n, n))[0]
        lam = np.concatenate([[1e-8, 5e-4], rng.uniform(0.3, 1.0, n - 2)])
        blocks.append((Q * lam) @ Q.T + 1e-3 * np.eye(n))
    return blocks


@pytest.mark.parametrize("rel_tol", [0.01, 1e-6])
def test_spectral_device_branch_mode_counts(rel_tol):
    """The device branch (f64 torch.linalg.eigh per exact shape group,
    here on the CPU): the host's mode counts and subspaces (1e-8), and
    the JAX host path's; below the f32 floor too (the JAX device branch
    sends rel_tol < 1e-5 to the host, the port's f64 branch keeps it)."""
    blocks = _spectral_blocks()
    host = tspec.compute_local_spectral_targets(blocks, rel_tol, 4,
                                                backend="host")
    dev = tspec.compute_local_spectral_targets(blocks, rel_tol, 4,
                                               backend="device",
                                               device="cpu")
    jax_host = jspec.compute_local_spectral_targets(blocks, rel_tol, 4,
                                                    backend="host")
    for h, d, j in zip(host, dev, jax_host):
        assert h.shape == d.shape == j.shape
        Ph, Pd = h @ np.linalg.pinv(h), d @ np.linalg.pinv(d)
        assert np.abs(Ph - Pd).max() < 1e-8
        assert _rel(h, j) <= 1e-12


# --------------------------------------------------------------------- #
# Krylov methods and the blocked Darcy solve
# --------------------------------------------------------------------- #

def _systems(seed=0, n=60):
    rng = np.random.RandomState(seed)
    Q = rng.rand(n, n)
    spd = Q @ Q.T + n * np.eye(n)
    nonsym = spd + 0.3 * n * (rng.rand(n, n) - 0.5)
    k = n // 3
    B = rng.randn(k, n - k)
    sym_indef = np.block([[spd[:n - k, :n - k], B.T],
                          [B, np.zeros((k, k))]])
    return rng, spd, nonsym, sym_indef


@pytest.mark.parametrize("method", ["minres", "bicgstab", "gmres"])
def test_krylov_matches_jax(method):
    """The same seeded system and Jacobi-like diagonal preconditioner:
    the JAX package's iteration count and x within 1e-10."""
    rng, spd, nonsym, sym_indef = _systems()
    A = {"minres": sym_indef, "bicgstab": nonsym, "gmres": nonsym}[method]
    b = rng.rand(A.shape[0])
    dinv = 1.0 / np.abs(A).sum(axis=1)
    kw = dict(rtol=1e-10)
    if method == "gmres":
        kw.update(restart=8, max_restarts=40)
    xj, (itj, resj) = getattr(jcg, method)(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        precond=lambda r: jnp.asarray(dinv) * r, **kw)
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    xt, (itt, rest) = getattr(tcg, method)(
        lambda v: At @ v, torch.as_tensor(b), precond=lambda r: dt * r,
        **kw)
    assert int(itt) == int(itj) > 1
    assert _rel(_np(xt), np.asarray(xj)) <= 1e-10
    assert np.linalg.norm(b - A @ _np(xt)) <= 1e-8 * np.linalg.norm(b)


def test_pcg_host_matches_jax():
    A = _laplacian3d(6)
    b = np.random.RandomState(5).rand(A.shape[0])
    xj, (itj, _) = jcg.pcg_host(A, b, rtol=1e-10, maxiter=500)
    xt, (itt, _) = tcg.pcg_host(A, b, rtol=1e-10, maxiter=500, device="cpu")
    assert isinstance(xt, np.ndarray) and int(itt) == int(itj)
    assert _rel(xt, np.asarray(xj)) <= 1e-10


def test_darcy_gmres_matches_jax():
    """build_darcy_amge_hierarchy + darcy_gmres_solve (nref 1, derefine,
    no aggressive level): the same GMRES cycles, x within 1e-10 of the
    JAX one, and of the direct solve within the JAX test's 1e-8."""
    import scipy.sparse.linalg as spla
    out = {}
    for side, mod, blk in (("jax", jdarcy, jblock),
                           ("port", tdarcy, tblock)):
        mesh, _, seqs = mod.build_darcy_hierarchy(
            nref_parallel=1, partition="derefine", aggressive_levels=0)
        kw = {} if side == "jax" else {"device": "cpu"}
        H, A_levels, n0s = blk.build_darcy_amge_hierarchy(
            seqs, sweeps=3, omega=0.6, **kw)
        vols = jhexfe.hex_volumes(mesh.vertices[mesh.elements])
        b = np.concatenate([np.zeros(n0s[0]), vols])
        out[side] = (blk.darcy_gmres_solve(H, A_levels[0], b, rtol=1e-8),
                     A_levels, b)
    (xj, (itj, _)), Aj, b = out["jax"]
    (xt, (itt, _)), At, _ = out["port"]
    assert itt == itj and all(_rel(a, c) <= 1e-12 for a, c in zip(At, Aj))
    assert _rel(xt, xj) <= 1e-10
    xref = spla.spsolve(At[0].tocsc(), b)
    assert np.abs(xt - xref).max() < 1e-8


def test_block_saddle_smoother_matches_jax():
    """One BlockSaddleSmoother sweep pair on level 0, carried across by
    convert, against the JAX smoother (1e-12); the input x is kept."""
    _, _, seqs = jdarcy.build_darcy_hierarchy(
        nref_parallel=1, partition="derefine", aggressive_levels=0)
    Hj, A_levels, n0s = jblock.build_darcy_amge_hierarchy(seqs, sweeps=2)
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), "cpu")
    rng = np.random.RandomState(8)
    n = A_levels[0].shape[0]
    b, x = rng.randn(n), rng.randn(n)
    xt = torch.as_tensor(x)
    lj, lt = Hj.levels[0], Ht.levels[0]
    y = _np(lt.pre.apply(lt.A, torch.as_tensor(b), xt))
    assert _rel(y, np.asarray(lj.pre.apply(lj.A, jnp.asarray(b),
                                           jnp.asarray(x)))) <= 1e-12
    assert np.array_equal(_np(xt), x)


# --------------------------------------------------------------------- #
# the lanes on the CPU
# --------------------------------------------------------------------- #

def test_darcy_lanes_on_the_cpu():
    """darcy_lane's records at small sizes: darcy_hyb at 8^3 against the
    JAX bench's lane (n_mult, iters, SA level sizes), spe10 at (8, 8, 4)
    against spe10_darcy's, the block lane against its direct solve."""
    import bench
    rec, _ = darcy_lane.lane_darcy_hybridized(8, "cpu")
    ref = bench.lane_darcy_hybridized(8)
    for k in ("n_mult", "iters", "sa_level_sizes", "cells"):
        assert rec[k] == ref[k], k
    assert rec["rel_res"] <= 1e-7 and rec["passes"] == 1
    assert rec["format"] == "DiaEllMatrix" and rec["timer"] == "host_clock"
    assert not any(rec["kernels"].values())
    srec, _ = darcy_lane.lane_spe10((8, 8, 4), "cpu")
    assert srec["ndofs"] == [1152, 181] and srec["n_mult"] == [896, 133]
    assert srec["u_l2_rel"] < 0.25
    brec, _ = darcy_lane.lane_darcy_block(1, "cpu")
    assert brec["err_vs_direct"] < 1e-8 and brec["cycles"] <= 2
    assert brec["formats"] == ["EllMatrix"] * len(brec["level_sizes"])


def test_lane_returns_the_operators_its_solve_ran():
    """lane_darcy_hybridized returns the outer operator and SA hierarchy
    that _device_solve runs (the setup cache's own objects), and
    hierarchy.level_operators lists A, P and R of every level above the
    coarsest, whose dense inverse stands in for its A."""
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    _, (hyb, Hs, _, _, Hd, H) = darcy_lane.lane_darcy_hybridized(8, "cpu")
    _, Hd2, H2, *_ = hyb._device_setup(Hs, "cpu")
    assert Hd2 is Hd and H2 is H
    ops = level_operators(H)
    assert H.levels[-1].coarse_inv is not None
    assert len(ops) == 3 * (len(H.levels) - 1)
    for (label, M), (l, attr) in zip(
            ops, [(l, a) for l in range(len(H.levels) - 1) for a in "APR"]):
        assert label == f"{attr}{l}" and M is getattr(H.levels[l], attr)


# --------------------------------------------------------------------- #
# the copied host code, byte for byte
# --------------------------------------------------------------------- #

def _rewritten(text):
    return re.sub(r"(?m)^(\s*)from parelag_tpu\.", r"\1from parelag_tpu_torch.",
                  text)


COPIED = [(jsa, tsa, n) for n in ("strength_filter", "aggregate",
                                  "_rho_dinv_a", "build_sa_hierarchy",
                                  "HostVCycle")] \
    + [(jspec, tspec, n) for n in ("weighted_l1_diagonal",
                                   "smallest_generalized",
                                   "compute_local_hdiv_l2_spectral_targets")] \
    + [(jblock, tblock, "monolithic_saddle")]

HYB_METHODS = ["__init__", "rhs_transform", "recover", "_facet_blocks",
               "_facet_block_inverse", "_host_amg_solve"]


@pytest.mark.parametrize("jmod,tmod,name", COPIED,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}"
                              for _, t, n in COPIED])
def test_copied_function_equals_its_source(jmod, tmod, name):
    assert inspect.getsource(getattr(tmod, name)) == _rewritten(
        inspect.getsource(getattr(jmod, name)))


@pytest.mark.parametrize("name", HYB_METHODS)
def test_copied_hybridization_method_equals_its_source(name):
    assert inspect.getsource(getattr(thyb.HybridHdivL2, name)) == \
        _rewritten(inspect.getsource(getattr(jhyb.HybridHdivL2, name)))


# the documented edits of the port's models/spe10.py: spe10_darcy takes
# device= for HybridHdivL2.solve and records each level's device solve
SPE10_EDITS = [
    ('mult_solver="auto", seed=0):',
     'mult_solver="auto", seed=0, device=None):'),
    ('    solver info."""',
     '    solver info. device: where the "device" and "auto" multiplier\n'
     '    solvers run (HybridHdivL2.solve; None: the card); device_solves\n'
     '    holds each level\'s HybridHdivL2.last_device, '
     'device_hierarchies\n    its last_hierarchy and device_operators its '
     'last_operator (None where\n    no device solve ran)."""'),
    ('rtol=1e-8, rescale=True)',
     'rtol=1e-8, rescale=True, device=device)'),
    ('            out["iters"].append(hyb.n_mult)\n',
     '            out["iters"].append(hyb.n_mult)\n'
     '            out.setdefault("device_solves", []).append(\n'
     '                getattr(hyb, "last_device", None))\n'
     '            out.setdefault("device_hierarchies", []).append(\n'
     '                getattr(hyb, "last_hierarchy", None))\n'
     '            out.setdefault("device_operators", []).append(\n'
     '                getattr(hyb, "last_operator", None))\n'),
]


@pytest.mark.parametrize("path", ["models/samplegen.py", "models/darcy.py",
                                  "models/spe10.py"])
def test_copied_model_equals_its_source(path):
    """The model files are copies; spe10.py after SPE10_EDITS."""
    with open(os.path.join(ROOT, "parelag_tpu", path)) as f:
        src = _rewritten(f.read())
    if path.endswith("spe10.py"):
        for old, new in SPE10_EDITS:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
    with open(os.path.join(ROOT, "parelag_tpu_torch", path)) as f:
        assert f.read() == src
