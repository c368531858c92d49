"""LogicalPartitionerDemo / EmbeddedMeshPartitionerDemo equivalents.

Reference: examples/LogicalPartitionerDemo.cpp — H1 Poisson (f = 1, u = 0 on
the whole boundary) on an N^3 hex grid, multilevel upscaling with logical
Cartesian IJK coarsening (ratio 2 per direction per level, integer-division
semantics of CoarsenLogicalCartesianOperator); the golden lane
(examples/CMakeLists.txt:105-111) asserts the per-level upscaling errors.
"""

import numpy as np

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.models.upscaling import (
    mark_dofs_on_bndr, eliminate_rowcols, solve_spd, UpscalingResult)


def logical_cartesian_levels(N, n_levels, ratio=(2, 2, 2)):
    """Per-level partition vectors from IJK integer division."""
    nx = list(N)
    parts = []
    ijk = np.stack(np.meshgrid(np.arange(N[0]), np.arange(N[1]),
                               np.arange(N[2]), indexing="ij"),
                   axis=-1).reshape(-1, 3)
    # element order: x fastest (hex_grid_mesh)
    order = np.lexsort((ijk[:, 0], ijk[:, 1], ijk[:, 2]))
    ijk = ijk[order]
    cur = ijk.copy()
    dims = list(N)
    for _ in range(n_levels - 1):
        new = cur // np.asarray(ratio)
        ndims = [(-(-dims[d] // ratio[d])) for d in range(3)]
        pid = (new[:, 0] + ndims[0] * new[:, 1]
               + ndims[0] * ndims[1] * new[:, 2])
        # compress ids in first-seen order (stable agglomerate numbering)
        _, inv = np.unique(pid, return_inverse=True)
        parts.append(inv)
        # next level operates on the coarse grid
        uniq = np.unique(pid)
        lookup = {int(p): k for k, p in enumerate(uniq)}
        cur = np.stack(np.meshgrid(
            np.arange(ndims[0]), np.arange(ndims[1]), np.arange(ndims[2]),
            indexing="ij"), axis=-1).reshape(-1, 3)
        order = np.lexsort((cur[:, 0], cur[:, 1], cur[:, 2]))
        cur = cur[order]
        keep = (cur[:, 0] < ndims[0]) & (cur[:, 1] < ndims[1]) & \
               (cur[:, 2] < ndims[2])
        cur = cur[keep]
        dims = ndims
    return parts


def logical_partitioner_demo(N=(12, 12, 12), n_levels=4, upscaling_order=0,
                             svd_tol=1e-9, solver="direct"
                             ) -> UpscalingResult:
    mesh = hex_grid_mesh(*N)
    parts = logical_cartesian_levels(N, n_levels)
    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for p in parts:
        topos.append(topos[-1].coarsen_local_partitioning(p))

    seq = DeRhamSequenceFE(topos[0], mesh)
    seq.set_upscaling_targets(upscaling_order)
    seqs = [seq]
    for _ in range(n_levels - 1):
        seqs.append(seqs[-1].coarsen(svd_tol=svd_tol))

    form = 0
    Ml = [s.compute_mass_operator(0) for s in seqs]
    Wl = [s.compute_mass_operator(1) for s in seqs]
    Dl = [s.D[0] for s in seqs]
    Pl = [seqs[i].P[0] for i in range(n_levels - 1)]
    rhs = [seq.domain_lf_scalar(0, lambda p: np.ones(p.shape[:-1]))]
    for i in range(n_levels - 1):
        rhs.append(Pl[i].T @ rhs[i])

    ess = {1, 2, 3, 4, 5, 6}
    sols, u_l2, u_en, u_norm, ndofs = [], [], [], [], []
    for k in range(n_levels):
        A = (Ml[k] + Dl[k].T @ Wl[k] @ Dl[k]).tocsr()
        marker = mark_dofs_on_bndr(seqs[k], form, ess)
        A2, b = eliminate_rowcols(A, rhs[k].copy(), marker,
                                  np.zeros(A.shape[0]))
        x = solve_spd(A2, b, solver)
        sols.append(x)
        ndofs.append(A.shape[0])
        h = x
        for j in range(k, 0, -1):
            h = Pl[j - 1] @ h
        u_norm.append(float(np.sqrt(x @ (Ml[k] @ x))))
        if k > 0:
            d = h - sols[0]
            du = Dl[0] @ d
            u_l2.append(float(np.sqrt(d @ (Ml[0] @ d))))
            u_en.append(float(np.sqrt(du @ (Wl[0] @ du))))
    return UpscalingResult(u_l2[::-1], u_en[::-1], u_norm, ndofs)
