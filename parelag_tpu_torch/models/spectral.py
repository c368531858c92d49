"""Spectral AMGe upscaling drivers (Upscaling0FormSpectral equivalent).

Reference: examples/Upscaling0FormSpectral.cpp — H1 upscaling with a
checkerboard-discontinuous stiffness coefficient where the coarse spaces are
enriched by per-agglomerate spectral targets: at every level, solve
A_loc x = lambda diag(weighted-l1) x on each agglomerate of the level's
operator A = M + D^T W D and keep the near-null modes (spect_tol, max_evects),
restricting them to lower codims and adding their gradients as Hcurl targets
(PopulateLocalTargetsFromForm).
"""

import numpy as np

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge.localmass import assemble_agglomerate_blocks
from parelag_tpu_torch.amge.spectral import compute_local_spectral_targets
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.partitioning.partitioners import refined_mesh_partition
from parelag_tpu_torch.models.upscaling import (
    mark_dofs_on_bndr, eliminate_rowcols, solve_spd, UpscalingResult)
from parelag_tpu_torch.ops import csr as C


def checkerboard_coeff(p):
    """3D checkerboard, cells of width 0.1, values 1e6 / 1
    (Upscaling0FormSpectral.cpp:33-50)."""
    cx = np.ceil(p[..., 0] * 10.0).astype(np.int64) & 1
    cy = np.ceil(p[..., 1] * 10.0).astype(np.int64) & 1
    cz = np.ceil(p[..., 2] * 10.0).astype(np.int64) & 1
    hit = ((cz == 1) & (cx == cy)) | ((cz == 0) & (cx != cy))
    return np.where(hit, 1e6, 1.0)


def _spectral_agg_operator(seq):
    """Per-AE dense blocks of A = M + D^T W D (the level operator restricted
    to agglomerates, Upscaling0FormSpectral.cpp:259-276)."""
    AE_e = seq.topo.AEntity_entity[0]
    agg0, agg1 = seq.dofagg[0], seq.dofagg[1]
    Md = assemble_agglomerate_blocks(seq.M[(0, 0)], AE_e, agg0, 0)
    Wd = assemble_agglomerate_blocks(seq.M[(0, 1)], AE_e, agg1, 0)
    D = seq.D[0].tocsr()
    out = []
    for iae in range(len(Md)):
        u_all = agg0.ae_dofs(0)[iae]
        e_all = agg1.ae_dofs(0)[iae]
        Dloc = C.extract_submatrix(D, e_all, u_all)
        out.append(Md[iae] + Dloc.T @ Wd[iae] @ Dloc)
    return out


def project_bdr_vertex_values(seq_fe, attr_values):
    """Nodal boundary lift: set vertex values face-by-face in ascending
    attribute order, last write wins (mfem ProjectBdrCoefficient analog)."""
    mesh = seq_fe.mesh
    lift = np.zeros(seq_fe.dof[0].ndofs)
    order = np.argsort(mesh.bdr_attrib, kind="stable")
    for i in order:
        attr = int(mesh.bdr_attrib[i])
        if attr in attr_values:
            lift[mesh.bdr_faces[i]] = attr_values[attr]
    return lift


def upscaling_0form_spectral(par_ref_levels=2, spect_tol=0.005,
                             max_evects=10, coarsening_step=1,
                             svd_tol=1e-9, upscaling_order=0,
                             solver="direct") -> UpscalingResult:
    mesh = hex_grid_mesh(2, 2, 2)
    level_ne = []
    for _ in range(par_ref_levels):
        level_ne.append(mesh.num_elements)
        mesh = mesh.uniform_refinement()
    level_ne = [mesh.num_elements] + level_ne[::-1]
    n_levels = par_ref_levels // coarsening_step + 1

    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for il in range(n_levels - 1):
        ne = topos[il].num_entities(0)
        part = refined_mesh_partition(
            ne, level_ne[(il + 1) * coarsening_step])
        topos.append(topos[il].coarsen_local_partitioning(part))

    seq0 = DeRhamSequenceFE(topos[0], mesh)
    seq0.replace_mass_integrator(1, checkerboard_coeff)
    seq0.set_upscaling_targets(upscaling_order)
    seqs = [seq0]
    for il in range(n_levels - 1):
        s = seqs[il]
        s.agglomerate_dofs()
        blocks = _spectral_agg_operator(s)
        local = compute_local_spectral_targets(blocks, spect_tol, max_evects)
        s.set_local_targets(0, 0, local)
        s.populate_local_targets_from_form(0)
        seqs.append(s.coarsen(svd_tol=svd_tol))

    # problem: A u = 0 with u = 1 on attr 1, u = 0 on attr 3
    ess_attrs = {1, 3}
    form = 0
    Ml = [s.compute_mass_operator(0) for s in seqs]
    Wl = [s.compute_mass_operator(1) for s in seqs]
    Dl = [s.D[0] for s in seqs]
    Pl = [seqs[i].P[0] for i in range(n_levels - 1)]

    rhs = [np.zeros(seqs[0].dof[0].ndofs)]
    ess_data = [project_bdr_vertex_values(seq0, {1: 1.0, 3: 0.0})]
    for i in range(n_levels - 1):
        rhs.append(Pl[i].T @ rhs[i])
        ess_data.append(seqs[i].Pi[0].matrix @ ess_data[i])

    sols, u_l2, u_en, u_norm, ndofs = [], [], [], [], []
    for k in range(n_levels):
        A = (Ml[k] + Dl[k].T @ Wl[k] @ Dl[k]).tocsr()
        marker = mark_dofs_on_bndr(seqs[k], form, ess_attrs)
        A2, b = eliminate_rowcols(A, rhs[k].copy(), marker, ess_data[k])
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


def upscaling_2form_spectral_amge(par_ref_levels=2, spect_tol=0.0025,
                                  max_evects=8, svd_tol=1e-9,
                                  solver="direct") -> UpscalingResult:
    """Upscaling2FormSpectralAMGe equivalent: Hdiv upscaling with mixed
    Hdiv-L2 spectral coarse targets per level (reference golden
    7.4780e-04 / ~1e-07; the coarsest-level value depends on the dof-scaling
    convention through the boundary-trace block of the local eigenproblem,
    see tests/test_spectral.py)."""
    import numpy as np
    from parelag_tpu_torch.amge.spectral import (
        compute_local_hdiv_l2_spectral_targets)
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE

    mesh = hex_grid_mesh(2, 2, 2)
    level_ne = []
    for _ in range(par_ref_levels):
        level_ne.append(mesh.num_elements)
        mesh = mesh.uniform_refinement()
    level_ne = [mesh.num_elements] + level_ne[::-1]
    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for il in range(par_ref_levels):
        topos.append(topos[il].coarsen_local_partitioning(
            refined_mesh_partition(topos[il].num_entities(0),
                                   level_ne[il + 1])))
    seq0 = DeRhamSequenceFE(topos[0], mesh)
    seq0.set_upscaling_targets(0)
    seqs = [seq0]
    for il in range(par_ref_levels):
        s = seqs[il]
        s.agglomerate_dofs()
        tr, l2 = compute_local_hdiv_l2_spectral_targets(
            s, spect_tol, max_evects)
        s.set_local_targets(1, 2, tr)
        s.set_local_targets(0, 3, l2)
        seqs.append(s.coarsen(svd_tol=svd_tol))

    n_levels = len(seqs)
    form = 2
    fe = seqs[0]
    Ml = [s.compute_mass_operator(2) for s in seqs]
    Wl = [s.compute_mass_operator(3) for s in seqs]
    Dl = [s.D[2] for s in seqs]
    Pl = [seqs[i].P[2] for i in range(n_levels - 1)]

    def f(p):
        out = np.zeros(p.shape)
        out[..., 2] = 1.0
        return out

    rhs = [fe.domain_lf_vector(2, f)]
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
