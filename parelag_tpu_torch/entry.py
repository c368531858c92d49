"""The port's counterpart of __graft_entry__.entry(): one AMGe V-cycle
preconditioned CG step on the H1 (Poisson) hierarchy of the 2x2x2 hex
cube refined once (125 dofs, two levels), on the card.

    python -m parelag_tpu_torch.entry        # prints "entry ok: (125,)"

build_poisson is __graft_entry__._build_poisson on the port's copies of
the generic engine; the multi-chip dry run (dryrun_multichip) is not
ported yet (ROADMAP A12).
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


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
