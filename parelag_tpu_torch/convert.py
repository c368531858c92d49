"""Carry state built by the JAX package across to the port.

The inputs are JAX objects whose array leaves a caller has already
turned into numpy (`jax.tree_util.tree_map(np.asarray, H)`); the classes
are recognised by name and attributes, so this module imports neither
jax nor parelag_tpu.  bf16 leaves (numpy's ml_dtypes bfloat16) become
torch.bfloat16.
"""

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.amge.structured import StructuredLevel
from parelag_tpu_torch.ops.device_sparse import (
    BcsrMatrix, BlockDiagInverse, CooMatrix, DiaEllMatrix, DiaMatrix,
    EllMatrix, TileCooMatrix)
from parelag_tpu_torch.solvers.block import BlockSaddleSmoother
from parelag_tpu_torch.solvers.hierarchy import Hierarchy, Level
from parelag_tpu_torch.solvers.smoothers import (
    BlockJacobiSmoother, ChebyshevSmoother, HiptmairSmoother,
    L1JacobiSmoother)


def _tensor(a, device):
    """numpy (incl. ml_dtypes bfloat16) -> torch tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _matrix(M, device):
    if M is None:
        return None
    name = type(M).__name__
    if name == "DiaMatrix":
        n = M.shape[0]
        # the JAX table is tile-padded past n; the port keeps width n
        return DiaMatrix(_tensor(np.asarray(M.data)[:, :n], device),
                         M.offs, M.shape)
    if name == "BcsrMatrix":
        # the port keeps the tiles' nonzeros, not the tiles
        return BcsrMatrix.from_tiles(_tensor(M.col_blocks, device),
                                     _tensor(M.tiles, device), M.shape,
                                     M.padded)
    if name == "TileCooMatrix":
        return TileCooMatrix(_tensor(M.row_blocks, device),
                             _tensor(M.col_blocks, device),
                             _tensor(M.tiles, device), M.shape, M.padded)
    if name == "EllMatrix":
        return EllMatrix(_tensor(M.indices, device),
                         _tensor(M.values, device), M.shape)
    if name == "CooMatrix":
        # the JAX padding entries (row = col = 0, value 0) add nothing
        return CooMatrix(_tensor(M.rows, device), _tensor(M.cols, device),
                         _tensor(M.vals, device), M.shape)
    if name == "DiaEllMatrix":
        return DiaEllMatrix(_matrix(M.dia, device), _matrix(M.ell, device),
                            M.shape)
    if name == "BlockDiagInverse":
        return BlockDiagInverse([_tensor(T, device) for T in M.tensors],
                                M.sizes)
    raise TypeError(f"matrix format {name} is not ported")


def _smoother(S, device):
    if S is None:
        return None
    name = type(S).__name__
    if name == "L1JacobiSmoother":
        return L1JacobiSmoother(_tensor(S.dinv, device), S.sweeps, S.omega)
    if name == "ChebyshevSmoother":
        return ChebyshevSmoother(_tensor(S.dinv, device),
                                 tuple(float(c) for c in S.coeffs[:2])
                                 + (int(S.coeffs[2]),))
    if name == "BlockJacobiSmoother":
        return BlockJacobiSmoother(_matrix(S.binv, device), S.sweeps,
                                   S.omega)
    if name == "BlockSaddleSmoother":
        return BlockSaddleSmoother(S.n0, _tensor(S.m_dinv, device),
                                   _tensor(S.s_dinv, device), S.sweeps,
                                   S.omega)
    if name == "HiptmairSmoother":
        return HiptmairSmoother(
            _smoother(S.primary, device), _smoother(S.aux, device),
            _matrix(S.D, device), _matrix(S.Dt, device),
            _matrix(S.A_aux, device))
    raise TypeError(f"smoother {name} is not ported")


def matrix_from_numpy(M, device=None):
    """The port's matrix for a JAX device matrix with numpy leaves
    (DiaMatrix, BcsrMatrix, TileCooMatrix, EllMatrix, CooMatrix,
    DiaEllMatrix, BlockDiagInverse; device=None: on the card)."""
    return _matrix(M, resolve_device(device))


def hierarchy_from_numpy(H, device=None) -> Hierarchy:
    """The port's Hierarchy for a JAX Hierarchy with numpy leaves
    (device=None: on the card): the flagship's and the generic engine's,
    the SA and blocked Darcy hierarchies, and those a JAX library solver
    built (solvers/library.py: _AMGeSolver._H and _AuxAMGSolver._H, with
    l1-Jacobi, Chebyshev or Hiptmair smoothers), with the perm / iperm
    of an RCM-reordered one."""
    device = resolve_device(device)
    levels = []
    for lvl in H.levels:
        pre = _smoother(lvl.pre, device)
        post = pre if lvl.post is lvl.pre else _smoother(lvl.post, device)
        ci = lvl.coarse_inv
        levels.append(Level(
            A=_matrix(lvl.A, device), P=_matrix(lvl.P, device),
            R=_matrix(lvl.R, device), pre=pre, post=post,
            coarse_inv=None if ci is None else _tensor(ci, device)))
    perm, iperm = (None if a is None else _tensor(a, device).long()
                   for a in (getattr(H, "perm", None),
                             getattr(H, "iperm", None)))
    return Hierarchy(levels, H.mu, perm, iperm)


def structured_level_from_numpy(lvl, device=None) -> StructuredLevel:
    """The port's StructuredLevel for a JAX StructuredLevel with numpy
    leaves (fields the port does not carry are refused; device=None: on
    the card)."""
    device = resolve_device(device)
    fields = {k: v for k, v in vars(lvl).items() if k != "shape"}
    known = set(StructuredLevel.__dataclass_fields__) - {"shape"}
    extra = set(fields) - known
    if extra:
        raise TypeError(f"unknown StructuredLevel fields {sorted(extra)}")
    return StructuredLevel(
        shape=tuple(lvl.shape),
        **{k: None if v is None else _tensor(v, device)
           for k, v in fields.items()})
