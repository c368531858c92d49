"""The port's counterpart of __graft_entry__.entry(): one AMGe V-cycle
preconditioned CG step on the H1 (Poisson) hierarchy of the 2x2x2 hex
cube refined once (125 dofs, two levels), on the card.

    python -m parelag_tpu_torch.entry        # prints "entry ok: (125,)"

build_poisson is __graft_entry__._build_poisson on the port's copies of
the generic engine.  dryrun_multichip(n) is __graft_entry__'s
multi-device dry run with the n ranks as the batch axis of one device
(parallel.sharding.RankMesh).
"""

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.models.upscaling import (
    boundary_rhs, eliminate_rowcols, mark_dofs_on_bndr)
from parelag_tpu_torch.partitioning.partitioners import (
    refined_mesh_partition)
from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
from parelag_tpu_torch.topology.topology import AgglomeratedTopology


def build_poisson(nx=2, nref=1, dtype=np.float32):
    """The sequence chain [fine, coarse] of the nx^3 hex cube refined
    nref times (one agglomerate per 8 fine elements), and the
    BC-eliminated H1 operator A = M0 + D0^T M1 D0 and load b (natural
    data -1 on attribute 1, Dirichlet on attributes 2-5) in dtype."""
    mesh = hex_grid_mesh(nx, nx, nx)
    for _ in range(nref):
        mesh = mesh.uniform_refinement()
    topo = AgglomeratedTopology.from_mesh(mesh)
    ne = mesh.num_elements
    topo.coarsen_local_partitioning(refined_mesh_partition(ne, ne // 8))
    seq = DeRhamSequenceFE(topo, mesh)
    seq.set_upscaling_targets(0)
    seqs = [seq, seq.coarsen()]

    M = seq.compute_mass_operator(0)
    W = seq.compute_mass_operator(1)
    D = seq.D[0]
    A = (M + D.T @ W @ D).tocsr()
    b = boundary_rhs(seq, 0, {1: -1.0})
    marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return seqs, A.astype(dtype), b.astype(dtype)


def step(hierarchy, b_dev):
    """One MG-preconditioned CG step from a zero guess: x = alpha d with
    d = z = H.apply(b) and alpha = (r.z) / (d.Ad)."""
    r = b_dev
    z = hierarchy.apply(r)
    d = z
    Ad = hierarchy.levels[0].A @ d
    alpha = (r @ z) / (d @ Ad)
    return alpha * d


def entry(device=None):
    """(fn, (H, b)): the f32 l1-Jacobi V(1,1) hierarchy of build_poisson
    on `device` (None: the card) and its load; fn(H, b) is step."""
    device = resolve_device(device)
    seqs, A, b = build_poisson(nx=2, nref=1, dtype=np.float32)
    H, _, _ = build_amge_hierarchy(seqs, 0, A, smoother="l1jacobi",
                                   sweeps=1, dtype=np.float32,
                                   device=device)
    return step, (H, torch.as_tensor(b).to(device))


def dryrun_multichip(n_devices, device=None):
    """The full distributed pipeline over n_devices ranks on `device`
    (None: the card): the distributed setup of the dist lane's grid
    (16, 4 n, 20) -- recursive patch-based Coarsen, per-level owned
    operator rows, no global fine matrix -- feeding one rank-batched
    L-level V-cycle PCG step with the halo exchange at every level (all
    outputs finite), then the setup's rank-batched dense solves
    (parallel.shard_setup.sharded_solve_groups) against numpy.  Raises
    RuntimeError on a failed check."""
    from parelag_tpu_torch.parallel.dist_bench import build, steps_from_zero
    from parelag_tpu_torch.parallel.shard_setup import sharded_solve_groups
    from parelag_tpu_torch.parallel.sharding import make_dd_mesh
    mesh = make_dd_mesh(n_devices, device)
    _, hier, b = build(n_devices, 4, dtype=np.float32)
    out = steps_from_zero(hier, b, mesh)(0)
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise RuntimeError("dryrun_multichip: a non-finite step output")
    rng = np.random.RandomState(0)
    As = [rng.randn(2 + r % 3, 6, 6).astype(np.float32) + 6 * np.eye(
        6, dtype=np.float32) for r in range(n_devices)]
    Bs = [rng.randn(A.shape[0], 6, 2).astype(np.float32) for A in As]
    Xs = sharded_solve_groups(As, Bs, mesh)
    for A_, B_, X_ in zip(As, Bs, Xs):
        if not np.abs(A_ @ X_ - B_).max() < 1e-3:
            raise RuntimeError("dryrun_multichip: sharded setup solve")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
