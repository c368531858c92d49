"""The port's checkpoint module (parelag_tpu_torch/utils/checkpoint.py)
against the JAX package's on the CPU: tests/test_checkpoint.py's two
cases on the same 2x2x2 refined setup built through the port (a
reloaded hierarchy's apply bitwise equal, the transfers exact and a
resumed PCG to ||Ax - b|| < 1e-7), transfers files read across the two
packages exactly in both directions, a bitwise round trip of every
module class the loader accepts, and the refusal of crafted files for
each global the JAX module's restricted unpickler blocks."""

import inspect
import io
import json
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu.amge.fespace import DeRhamSequenceFE as JSeq
from parelag_tpu.mesh.mesh import hex_grid_mesh as jmesh
from parelag_tpu.models import upscaling as jup
from parelag_tpu.partitioning.partitioners import (
    refined_mesh_partition as jpart)
from parelag_tpu.solvers import hierarchy as jh
from parelag_tpu.solvers.autotune import _factory as jfactory
from parelag_tpu.topology.topology import AgglomeratedTopology as JTopo
from parelag_tpu.utils import checkpoint as jck
from parelag_tpu_torch import convert
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE as TSeq
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh as tmesh
from parelag_tpu_torch.models import upscaling as tup
from parelag_tpu_torch.ops import device_sparse as ds
from parelag_tpu_torch.partitioning.partitioners import (
    refined_mesh_partition as tpart)
from parelag_tpu_torch.solvers import block, hierarchy as th
from parelag_tpu_torch.solvers import smoothers as tsm
from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
from parelag_tpu_torch.solvers.autotune import _factory as tfactory
from parelag_tpu_torch.solvers.cg import pcg
from parelag_tpu_torch.topology.topology import AgglomeratedTopology as TTopo
from parelag_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)


def _setup(mesh, topo_cls, seq_cls, part, up):
    """tests/test_checkpoint.py's _setup through either package."""
    m = mesh(2, 2, 2).uniform_refinement()
    topo = topo_cls.from_mesh(m)
    topo.coarsen_local_partitioning(part(64, 8))
    seq = seq_cls(topo, m)
    seq.set_upscaling_targets(0)
    seq.coarsen()
    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    A = (M + seq.D[0].T @ W @ seq.D[0]).tocsr()
    b = up.boundary_rhs(seq, 0, {1: -1.0})
    marker = up.mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = up.eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return seq, A, b


@pytest.fixture(scope="module")
def port_setup():
    return _setup(tmesh, TTopo, TSeq, tpart, tup)


@pytest.fixture(scope="module")
def jax_setup():
    return _setup(jmesh, JTopo, JSeq, jpart, jup)


def _roundtrip(tree, tmp_path):
    p = tmp_path / "tree.pt"
    ck.save_pytree(tree, str(p))
    return ck.load_pytree(str(p), device="cpu")


def _same_tree(a, b):
    """Equal classes, plain attributes and buffers (bitwise), shared
    submodules still shared."""
    assert type(a) is type(b)
    for k, v in vars(a).items():
        if not k.startswith("_"):
            assert vars(b)[k] == v and type(vars(b)[k]) is type(v), k
    assert a._buffers.keys() == b._buffers.keys()
    for k, t in a._buffers.items():
        u = b._buffers[k]
        assert (t is None) == (u is None), k
        if t is not None:
            assert t.dtype == u.dtype and torch.equal(t, u), k
    assert a._modules.keys() == b._modules.keys()
    for k, m in a._modules.items():
        if m is not None:
            _same_tree(m, b._modules[k])
    if isinstance(a, th.Level) and a.pre is not None:
        assert (a.pre is a.post) == (b.pre is b.post)


def test_hierarchy_roundtrip(port_setup, tmp_path):
    """tests/test_checkpoint.py::test_hierarchy_roundtrip: a bitwise
    equal apply and equal sweeps."""
    seq, A, b = port_setup
    H, _, _ = build_amge_hierarchy([seq, seq.coarser], 0, A,
                                   smoother="l1jacobi", device="cpu")
    H2 = _roundtrip(H, tmp_path)
    bt = torch.as_tensor(b)
    assert torch.equal(H.apply(bt), H2.apply(bt))
    assert H2.levels[0].pre.sweeps == H.levels[0].pre.sweeps
    _same_tree(H, H2)


def test_transfers_roundtrip(port_setup, tmp_path):
    """tests/test_checkpoint.py::test_transfers_roundtrip: P, Pi, D
    exact, and a solve resumed from the stored transfers alone."""
    seq, A, b = port_setup
    p = tmp_path / "transfers.npz"
    ck.save_transfers([seq], str(p))
    back = ck.load_transfers(str(p))
    assert len(back) == 1
    for j in range(4):
        assert np.abs(back[0]["P"][j] - seq.P[j]).max() == 0.0
        assert np.abs(back[0]["Pi"][j] - seq.Pi[j].matrix).max() == 0.0
    for j in range(3):
        assert np.abs(back[0]["D"][j] - seq.D[j]).max() == 0.0
    P0 = back[0]["P"][0]
    H = th.build_hierarchy([A, th.rap(A, P0)], [P0],
                           lambda AA, l: tsm.make_l1_jacobi(
                               AA, sweeps=2, device="cpu"), device="cpu")
    x, _ = pcg(H.levels[0].A.matvec, torch.as_tensor(b),
               precond=H.apply, rtol=1e-10)
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-7


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _transfers_equal(x, y):
    assert len(x) == len(y)
    for lx, ly in zip(x, y):
        for key in ("P", "D", "Pi"):
            assert len(lx[key]) == len(ly[key])
            for a, c in zip(lx[key], ly[key]):
                assert (a is None) == (c is None)
                if a is not None:
                    assert _csr_equal(a, c)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_transfers_files_cross_packages(writer, port_setup, jax_setup,
                                        tmp_path):
    """A transfers file written by either package loads in the other
    exactly, and both write the same keys for the same chain."""
    seq_t, _, _ = port_setup
    seq_j, _, _ = jax_setup
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jck.save_transfers([seq_j], str(pj))
    ck.save_transfers([seq_t], str(pt))
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
    src = pj if writer == "jax" else pt
    _transfers_equal(ck.load_transfers(str(src)),
                     jck.load_transfers(str(src)))
    # the copied chain agrees with the JAX chain it was copied from
    _transfers_equal(ck.load_transfers(str(pt)), jck.load_transfers(str(pj)))


def test_transfer_functions_are_the_jax_copies():
    for name in ("_csr_pack", "_csr_unpack", "save_transfers",
                 "load_transfers"):
        assert inspect.getsource(getattr(ck, name)) == \
            inspect.getsource(getattr(jck, name)), name


def _chain(n=8):
    """A 3-level 7-point Laplacian chain with 2x2x2 aggregation."""
    I = sp.identity(n)
    T = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T) + 0.1 * sp.identity(n ** 3)).tocsr()
    A_levels, P_levels, m = [A], [], n
    for _ in range(2):
        P1 = sp.csr_matrix((np.ones(m), (np.arange(m), np.arange(m) // 2)),
                           shape=(m, m // 2))
        P_levels.append(sp.kron(sp.kron(P1, P1), P1).tocsr())
        A_levels.append(th.rap(A_levels[-1], P_levels[-1]))
        m //= 2
    return A_levels, P_levels


def _laplace(fmt, smoother="l1jacobi"):
    A_levels, P_levels = _chain()
    cfg = dict(mu=1, smoother=smoother, sweeps=2)
    return th.build_hierarchy(A_levels, P_levels, tfactory(cfg, "cpu"),
                              dtype=np.float64, matrix_format=fmt,
                              device="cpu")


def _dia_ell():
    H = _laplace("ell")
    H.levels[0].A = ds.to_dia_ell(_chain()[0][0], dtype=np.float64,
                                  device="cpu")
    return H


def _tilecoo_block_jacobi():
    """TileCoo transfers and block Jacobi (1 x 1 and 2 x 2 blocks) on
    the fine level."""
    H = _laplace("ell")
    A0, P0 = _chain()[0][0], _chain()[1][0]
    lvl = H.levels[0]
    lvl.P = ds.to_tilecoo(P0, dtype=np.float64, device="cpu")
    lvl.R = ds.to_tilecoo(P0.T.tocsr(), dtype=np.float64, device="cpu")
    d = A0.diagonal()
    pairs = np.linalg.inv(np.stack([np.diag(d[i:i + 2])
                                    for i in range(0, 64, 2)]))
    binv = ds.BlockDiagInverse(
        [torch.as_tensor(pairs), torch.as_tensor(1.0 / d[64:])], (2, 1))
    lvl.pre = lvl.post = tsm.BlockJacobiSmoother(binv, sweeps=2)
    return H


def _hiptmair(setup):
    seq, _, _ = setup
    A1 = (seq.compute_mass_operator(1) + seq.D[1].T
          @ seq.compute_mass_operator(2) @ seq.D[1]).tocsr()
    H, _, _ = build_amge_hierarchy([seq, seq.coarser], 1, A1,
                                   smoother="hiptmair", device="cpu")
    return H


def _block_saddle(setup):
    seq, _, _ = setup
    H, _, _ = block.build_darcy_amge_hierarchy([seq, seq.coarser],
                                               device="cpu")
    return H


HIERARCHIES = {
    "dia": lambda s: _laplace("dia"),
    "bcsr": lambda s: _laplace("bcsr"),
    "ell": lambda s: _laplace("ell"),
    "dia_ell": lambda s: _dia_ell(),
    "chebyshev": lambda s: _laplace("dia", "chebyshev"),
    "tilecoo_block_jacobi": lambda s: _tilecoo_block_jacobi(),
    "hiptmair": _hiptmair,
    "block_saddle": _block_saddle,
    "bf16_cast": lambda s: _laplace("dia").cast(torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(HIERARCHIES))
def test_module_tree_roundtrip(case, port_setup, tmp_path):
    """Every format and smoother the loader accepts: the same tree,
    buffers bitwise, and a bitwise equal apply."""
    H = HIERARCHIES[case](port_setup)
    H2 = _roundtrip(H, tmp_path)
    _same_tree(H, H2)
    n = H.levels[0].A.shape[0]
    r = torch.as_tensor(np.random.RandomState(3).randn(n)).to(
        H.levels[0].A.dtype)
    assert torch.equal(H.apply(r), H2.apply(r))


def test_jax_hierarchy_through_convert(tmp_path):
    """A JAX hierarchy carried over by convert.py (its tiled BCSR becomes
    the port's BcsrMatrix) round-trips, and still agrees with JAX."""
    A_levels, P_levels = _chain()
    Hj = jh.build_hierarchy(A_levels, P_levels,
                            jfactory(dict(mu=1, smoother="l1jacobi",
                                          sweeps=2)),
                            dtype=np.float64, matrix_format="bcsr")
    Ht = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    H2 = _roundtrip(Ht, tmp_path)
    _same_tree(Ht, H2)
    r = np.random.RandomState(4).randn(A_levels[0].shape[0])
    y2 = H2.apply(torch.as_tensor(r))
    assert torch.equal(Ht.apply(torch.as_tensor(r)), y2)
    yj = np.asarray(Hj.apply(jnp.asarray(r)))
    assert np.abs(y2.numpy() - yj).max() <= 1e-10 * np.abs(yj).max()


def test_save_refuses_foreign_modules(tmp_path):
    with pytest.raises(TypeError, match="not a solver module"):
        ck.save_pytree(nn.Linear(2, 2), str(tmp_path / "x.pt"))


# the globals tests/test_checkpoint.py's restricted unpickler blocks: a
# builtin outside its list (eval, the getattr REDUCE gadget), os.system,
# subprocess.Popen, a module smuggled through a port module's import, a
# port module or function instead of a class, a class from outside the
# package
BLOCKED = [("builtins", "eval"), ("builtins", "getattr"), ("os", "system"),
           ("posix", "system"), ("subprocess", "Popen"),
           ("parelag_tpu_torch.ops.build", "subprocess"),
           ("parelag_tpu_torch.ops", "device_sparse"),
           ("parelag_tpu_torch.ops.device_sparse", "from_scipy"),
           ("torch.nn.modules.linear", "Linear"),
           ("collections", "OrderedDict")]


def _valid_file(tmp_path):
    p = tmp_path / "valid.pt"
    ck.save_pytree(_laplace("ell"), str(p))
    return p


@pytest.mark.parametrize("module,name", BLOCKED)
def test_crafted_structure_is_refused(module, name, tmp_path):
    """A valid file whose JSON structure names another global."""
    payload = torch.load(_valid_file(tmp_path), weights_only=True)
    tree = json.loads(payload["tree"])
    tree["modules"]["levels"]["modules"]["0"]["class"] = f"{module}.{name}"
    payload["tree"] = json.dumps(tree)
    p = tmp_path / "crafted.pt"
    torch.save(payload, p)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        ck.load_pytree(str(p), device="cpu")


@pytest.mark.parametrize("module,name", BLOCKED)
def test_crafted_pickle_is_refused(module, name, tmp_path):
    """A torch.save archive whose pickle calls the global: refused
    before it runs, by torch's weights-only unpickler or, for a global
    it allows, by the payload check."""
    crafted = (b"\x80\x02c" + module.encode() + b"\n" + name.encode()
               + b"\n)R.")
    src = zipfile.ZipFile(io.BytesIO(_valid_file(tmp_path).read_bytes()))
    p = tmp_path / "crafted.pt"
    with zipfile.ZipFile(p, "w", zipfile.ZIP_STORED) as out:
        for item in src.infolist():
            data = src.read(item.filename)
            out.writestr(item, crafted if item.filename.endswith(
                "/data.pkl") else data)
    with pytest.raises(pickle.UnpicklingError):
        ck.load_pytree(str(p), device="cpu")


def test_crafted_attributes_are_refused(tmp_path):
    payload = torch.load(_valid_file(tmp_path), weights_only=True)
    for attr, value in (("__class__", "x"), ("_buffers", 1),
                        ("shape", {"eval": "1"})):
        tree = json.loads(payload["tree"])
        level0 = tree["modules"]["levels"]["modules"]["0"]
        level0["modules"]["A"]["attrs"][attr] = value
        p = tmp_path / "crafted.pt"
        torch.save(dict(payload, tree=json.dumps(tree)), p)
        with pytest.raises(pickle.UnpicklingError):
            ck.load_pytree(str(p), device="cpu")
