"""Checkpoint/resume for setup-phase products.

Counterpart of parelag_tpu/utils/checkpoint.py.  The reference has no
checkpointing -- every run pays the full coarsening cost.  Here the
expensive artifacts (the de Rham transfer operators and the assembled
solver hierarchy) are persistable so a solve-phase job can resume
without redoing setup:

  * save_pytree/load_pytree: any tree of the port's solver modules
    (Hierarchy, Level, the sparse formats of ops/device_sparse, the
    smoothers) -> one torch.save file: the tree's structure as JSON
    (each module's class, plain attributes, buffer keys and children)
    and its buffers as tensors (dtypes and devices ride the tensors).
  * save_transfers/load_transfers: the per-form P/D/Pi scipy matrices of
    a coarsened DeRhamSequence chain, as flat npz keys.

The transfers file has the JAX package's format key for key, so a file
written by either package loads in the other.  The pytree file does not
cross: the JAX file holds a pickled JAX treedef, which this package
cannot read without importing jax, and the port's modules are not JAX
pytrees.  A JAX hierarchy crosses through convert.hierarchy_from_numpy.

SECURITY: checkpoints are TRUSTED-INPUT ONLY, as in the JAX package.
load_pytree reads the file with torch.load(weights_only=True), whose
unpickler resolves no global outside torch's tensor-rebuild allow-list,
and resolves the class names of the JSON structure only against
_CLASSES, the port's own module classes (and torch's ModuleList that
holds the levels): a builtin, os.system, subprocess.Popen, a module, a
function or a class from anywhere else raises pickle.UnpicklingError.
Loading rebuilds each module without calling its constructor, so a
loaded BcsrMatrix keeps the saved `group` and every format keeps the
shapes and offsets its kernels' launch plans (hopper_kernels.
dia_stage_plan, ell_launch_plan) are keyed by.
"""

import json
import pickle

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import device_sparse as ds
from parelag_tpu_torch.solvers import block, hierarchy, smoothers

FORMAT = "parelag_tpu_torch.checkpoint/1"

_CLASSES = {f"{c.__module__}.{c.__qualname__}": c for c in (
    nn.ModuleList, hierarchy.Hierarchy, hierarchy.Level,
    ds.EllMatrix, ds.BcsrMatrix, ds.TileCooMatrix, ds.DiaMatrix,
    ds.CooMatrix, ds.DiaEllMatrix, ds.BlockDiagInverse,
    smoothers.L1JacobiSmoother, smoothers.ChebyshevSmoother,
    smoothers.BlockJacobiSmoother, smoothers.HiptmairSmoother,
    block.BlockSaddleSmoother)}


def _plain(v):
    """A plain attribute (shapes, offsets, counts, sweeps, omega,
    coefficients) as JSON, tuples tagged."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, tuple):
        return {"tuple": [_plain(x) for x in v]}
    raise TypeError(f"save_pytree: attribute of type {type(v).__name__}")


def _unplain(v):
    if isinstance(v, dict) and set(v) == {"tuple"} and isinstance(
            v["tuple"], list):
        return tuple(_unplain(x) for x in v["tuple"])
    if v is None or isinstance(v, (bool, str, int, float)):
        return v
    raise pickle.UnpicklingError(f"checkpoint attribute {v!r}")


def _encode(mod, tensors, memo):
    """JSON node of one module; a module met before is a reference."""
    if id(mod) in memo:
        return {"ref": memo[id(mod)]}
    name = f"{type(mod).__module__}.{type(mod).__qualname__}"
    if _CLASSES.get(name) is not type(mod):
        raise TypeError(f"save_pytree: {name} is not a solver module")
    memo[id(mod)] = len(memo)
    buffers = {}
    for k, t in mod._buffers.items():
        buffers[k] = None if t is None else f"t{len(tensors)}"
        if t is not None:
            tensors[buffers[k]] = t
    return {"class": name,
            "attrs": {k: _plain(v) for k, v in vars(mod).items()
                      if not k.startswith("_") and k != "training"},
            "buffers": buffers,
            "modules": {k: None if m is None else _encode(m, tensors, memo)
                        for k, m in mod._modules.items()}}


def _decode(node, tensors, built):
    if "ref" in node:
        return built[node["ref"]]
    cls = _CLASSES.get(node["class"])
    if cls is None:
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {node['class']}")
    mod = cls.__new__(cls)
    nn.Module.__init__(mod)
    built.append(mod)
    for k, v in node["attrs"].items():
        if not k.isidentifier() or k.startswith("_"):
            raise pickle.UnpicklingError(f"checkpoint attribute name {k!r}")
        setattr(mod, k, _unplain(v))
    for k, key in node["buffers"].items():
        mod.register_buffer(k, None if key is None else tensors[key])
    for k, child in node["modules"].items():
        mod.add_module(k, None if child is None
                       else _decode(child, tensors, built))
    return mod


def save_pytree(tree, path):
    """Persist a tree of the port's solver modules (e.g. a Hierarchy)."""
    tensors = {}
    structure = _encode(tree, tensors, {})
    torch.save({"format": FORMAT, "tree": json.dumps(structure),
                "tensors": tensors}, path)


def load_pytree(path, device=None):
    """Restore a tree saved by save_pytree on `device` (None: the card;
    device="cpu" rebuilds on the CPU).

    Trusted-input only (see module docstring): torch.load with
    weights_only=True, class names resolved against _CLASSES only."""
    device = resolve_device(device)
    payload = torch.load(path, map_location=device, weights_only=True)
    if not (isinstance(payload, dict)
            and set(payload) == {"format", "tree", "tensors"}
            and payload["format"] == FORMAT
            and isinstance(payload["tree"], str)
            and isinstance(payload["tensors"], dict)
            and all(isinstance(t, torch.Tensor)
                    for t in payload["tensors"].values())):
        raise pickle.UnpicklingError(f"{path}: not a {FORMAT} file")
    return _decode(json.loads(payload["tree"]), payload["tensors"], [])


def _csr_pack(d, key, M):
    M = sp.csr_matrix(M)
    d[f"{key}_data"] = M.data
    d[f"{key}_indices"] = M.indices
    d[f"{key}_indptr"] = M.indptr
    d[f"{key}_shape"] = np.asarray(M.shape)


def _csr_unpack(z, key):
    return sp.csr_matrix(
        (z[f"{key}_data"], z[f"{key}_indices"], z[f"{key}_indptr"]),
        shape=tuple(z[f"{key}_shape"]))


def save_transfers(seqs, path):
    """Persist the coarsening products of a DeRhamSequence chain: per level
    and form the interpolation P, derivative D, and projector Pi."""
    d = {"n_levels": np.asarray(len(seqs))}
    for l, s in enumerate(seqs):
        nf = len(s.D)
        d[f"lev{l}_nforms"] = np.asarray(nf + 1)
        for j in range(nf):
            if s.D[j] is not None:
                _csr_pack(d, f"lev{l}_D{j}", s.D[j])
        if getattr(s, "P", None) is not None:
            for j, Pj in enumerate(s.P):
                if Pj is not None:
                    _csr_pack(d, f"lev{l}_P{j}", Pj)
        if getattr(s, "Pi", None) is not None:
            for j, Pij in enumerate(s.Pi):
                if Pij is not None:
                    _csr_pack(d, f"lev{l}_Pi{j}",
                              Pij.matrix if hasattr(Pij, "matrix") else Pij)
    np.savez_compressed(path, **d)


def load_transfers(path):
    """Restore {level: {"P": [..], "D": [..], "Pi": [..]}} scipy matrices."""
    out = []
    with np.load(path) as z:
        n_levels = int(z["n_levels"])
        for l in range(n_levels):
            nf = int(z[f"lev{l}_nforms"]) - 1
            lev = {"P": [None] * (nf + 1), "D": [None] * nf,
                   "Pi": [None] * (nf + 1)}
            for j in range(nf):
                if f"lev{l}_D{j}_data" in z.files:
                    lev["D"][j] = _csr_unpack(z, f"lev{l}_D{j}")
            for j in range(nf + 1):
                if f"lev{l}_P{j}_data" in z.files:
                    lev["P"][j] = _csr_unpack(z, f"lev{l}_P{j}")
                if f"lev{l}_Pi{j}_data" in z.files:
                    lev["Pi"][j] = _csr_unpack(z, f"lev{l}_Pi{j}")
            out.append(lev)
    return out
