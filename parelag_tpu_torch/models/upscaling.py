"""Upscaling drivers: the UpscalingGeneralForm / Upscaling*Form app family.

Rebuild of reference testsuite/UpscalingGeneralForm.cpp (the golden-value
acceptance driver) and the examples/Upscaling{0,2}Form* mains: build the
multilevel de Rham hierarchy on the fallback 2x2x2 hex cube (the reference's
`Mesh(2,2,2,HEXAHEDRON)` path, UpscalingGeneralForm.cpp:225-229), assemble
A_l = M_l + D_l^T W_l D_l per level with essential BCs on attributes 2-5 and
natural data -1 on attribute 1, solve every level, interpolate coarse
solutions to the fine grid and report the reference's printed quantities:

    u l2-like errors     = sqrt((u_H - u_h)^T M_0 (u_H - u_h))
    u energy-like errors = sqrt((D(u_H - u_h))^T W_0 D(u_H - u_h))

(ReduceAndOutputUpscalingErrors, src/utilities/UpscalingPieces.cpp:182-253).

A copy of parelag_tpu/models/upscaling.py.  build_hierarchy also takes
backend= and device= (pass 2 of every coarsen() on that backend, as
generic_lane.build_h1 sets it).
"""

from dataclasses import dataclass
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.partitioning.partitioners import (
    refined_mesh_partition, graph_partition, geometric_box_partition)


# ---------------------------------------------------------------------- #
# boundary helpers
# ---------------------------------------------------------------------- #
def mark_dofs_on_bndr(seq, form, attrs) -> np.ndarray:
    """Mark dofs on boundary facets whose attribute is in `attrs`
    (DofHandlerFE/ALG::MarkDofsOnSelectedBndr, DofHandler.cpp:315,812).
    Works at any level through the facet_bdr_attribute table."""
    topo = seq.topo
    battr = topo.facet_bdr_attribute.tocsr()
    marker = np.zeros(seq.dof[form].ndofs, dtype=bool)
    has = np.diff(battr.indptr) > 0
    first = np.zeros(battr.shape[0], dtype=np.int64)
    first[has] = battr.indices[battr.indptr[:-1][has]] + 1
    active = has & np.isin(first, np.fromiter(attrs, dtype=np.int64))
    cat, off = seq.dof[form].entity_dofs_cat(1)   # facet closure dofs
    marker[cat[np.repeat(active, np.diff(off))]] = True
    return marker


def boundary_rhs(seq_fe: DeRhamSequenceFE, form, attr_values) -> np.ndarray:
    """Natural-BC linear form on the fine level.

    form 0: sum_a v_a * int_{bdr_a} phi_i dA      (BoundaryLFIntegrator)
    form 1: int_{bdr_a} (f x n) . phi_i dA, f=(1,1,1) on active attrs
            (VectorFEBoundaryTangentLFIntegrator)
    form 2: sum_a v_a * int_{bdr_a} phi_i . n dA  (VectorFEBoundaryFluxLFI)
    with n the outward normal.
    """
    if hasattr(seq_fe, "boundary_rhs_ho"):       # arbitrary-order 3D
        return seq_fe.boundary_rhs_ho(form, attr_values)
    mesh = seq_fe.mesh
    ents = seq_fe.ents
    b = np.zeros(seq_fe.dof[form].ndofs)
    from parelag_tpu_torch.mesh.entities import bdr_face_ids
    fids = bdr_face_ids(mesh, ents)
    # outward sign of the stored canonical face orientation: bdr faces are
    # created by their unique element, whose outward cycle is stored, so the
    # canonical normal points outward iff B0[elem, face] = +1.
    B0t = ents.B0.T.tocsr()
    battrs = np.asarray(mesh.bdr_attrib)
    for attr, val in attr_values.items():
        sel = np.where(battrs == attr)[0]
        if sel.size == 0:
            continue
        f = fids[sel]
        out_sign = B0t.data[B0t.indptr[f]]                   # (m,)
        if form == 2:   # flux dof basis has phi.n_out = out_sign / A
            np.add.at(b, f, val * out_sign)
            continue
        cyc = np.asarray(ents.face_verts)[f]                 # (m, 4)
        coords = mesh.vertices[cyc]                          # (m, 4, 3)
        _, F = hexfe._face_param(coords, hexfe._Q2)          # (m,nq,3,2)
        cr = np.cross(F[..., 0], F[..., 1])                  # (m, nq, 3)
        s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
        if form == 0:
            W = np.linalg.norm(cr, axis=2)
            N = np.stack([(1 - s) * (1 - t), s * (1 - t),
                          s * t, (1 - s) * t], axis=1)
            vals = val * np.einsum("q,mq,qi->mi", hexfe._QW2, W, N)
            np.add.at(b, cyc.ravel(), vals.ravel())
        else:
            normal = cr * out_sign[:, None, None]            # outward
            fvec = np.asarray(val, dtype=float)
            Ehat = np.zeros((s.size, 4, 2))
            Ehat[:, 0, 0] = 1 - t
            Ehat[:, 1, 1] = s
            Ehat[:, 2, 0] = -t
            Ehat[:, 3, 1] = -(1 - s)
            G = np.einsum("mqai,mqaj->mqij", F, F)
            Ginv = hexfe._inv2(G)
            phys = np.einsum("mqab,mqbc,qic->mqia", F, Ginv, Ehat,
                             optimize=True)
            fxn = np.cross(np.broadcast_to(fvec, normal.shape), normal)
            vals = np.einsum("q,mqa,mqia->mi", hexfe._QW2, fxn, phys,
                             optimize=True)
            edges = np.asarray(ents.face_edge)[f]
            np.add.at(b, edges.ravel(),
                      (vals * np.asarray(ents.face_edge_sign)[f]).ravel())
    return b


# ---------------------------------------------------------------------- #
@dataclass
class UpscalingResult:
    u_l2_errors: list           # coarse levels, finest-coarse last
    u_energy_errors: list
    u_norms: list
    ndofs: list

    def print_report(self):
        fmt = lambda xs: " ".join(f"{x:.4e}" for x in xs)
        print(f"u l2-like errors: {fmt(self.u_l2_errors)} ")
        print(f"u energy-like errors: {fmt(self.u_energy_errors)} ")


def build_hierarchy(nref_parallel=1, n_levels=None, unstructured=False,
                    geometric=False, svd_tol=1e-9, upscaling_order=0,
                    mesh=None, coarsening_factor=2, coeff_hooks=None,
                    verbose=False, feorder=0, backend=None, device=None):
    """Mesh + topology + sequence chain (UpscalingGeneralForm.cpp:200-515).

    verbose=True prints the reference driver's observability surface: a
    TimeManager phase table (Mesh Agglomeration / DeRhamSequence
    Construction per level, MultigridTestDarcy.cpp:233-247,550) and the
    coarsening-stats stream (PV/NullSpace dof counts per form,
    DeRhamSequence.cpp:2080-2083).

    backend ('host' | 'device' | None: the sequence's default) is set
    with device (None: the card) on each level before its coarsen()."""
    from parelag_tpu_torch.utils.timing import TimeManager
    if mesh is None:
        mesh = hex_grid_mesh(2, 2, 2)
    n_levels = (nref_parallel + 1) if n_levels is None else n_levels
    level_ne = []
    with TimeManager.add_timer("Mesh refinement"):
        for _ in range(nref_parallel):
            level_ne.append(
                mesh.num_elements if not (unstructured or geometric)
                else mesh.num_elements // 2)
            mesh = mesh.uniform_refinement()
    level_ne = [mesh.num_elements] + level_ne[::-1]

    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for il in range(n_levels - 1):
        with TimeManager.add_timer(f"Mesh Agglomeration: level {il + 1}"):
            ne = topos[il].num_entities(0)
            if unstructured:
                part = graph_partition(
                    topos[il].local_element_element(), level_ne[il + 1],
                    seed=0)
            elif geometric:
                part = geometric_box_partition(mesh, level_ne[il + 1])
            else:
                part = refined_mesh_partition(ne, level_ne[il + 1])
            topos.append(topos[il].coarsen_local_partitioning(
                part, check_topology=unstructured))

    log_mark = DeRhamSequenceFE.log_mark()
    with TimeManager.add_timer("DeRhamSequence Construction: level 0"):
        if feorder > 0 and mesh.kind == "hex":
            from parelag_tpu_torch.amge.fespace3d_ho import DeRhamSequence3DFE_HO
            seqs = [DeRhamSequence3DFE_HO(topos[0], mesh, feorder)]
        elif feorder > 0:
            from parelag_tpu_torch.amge.fespace3d_tet_ho import (
                DeRhamSequenceTetFE_HO)
            seqs = [DeRhamSequenceTetFE_HO(topos[0], mesh, feorder)]
        else:
            seqs = [DeRhamSequenceFE(topos[0], mesh)]
        if coeff_hooks:
            for form, fn in coeff_hooks.items():
                seqs[0].replace_mass_integrator(form, fn)
        seqs[0].set_upscaling_targets(upscaling_order)
    for il in range(n_levels - 1):
        if backend is not None:
            seqs[il].solve_backend = backend
            seqs[il].solve_device = resolve_device(device)
        with TimeManager.add_timer(
                f"DeRhamSequence Construction: level {il + 1}"):
            seqs.append(seqs[il].coarsen(svd_tol=svd_tol))
    if verbose:
        for line in DeRhamSequenceFE.log_since(log_mark):
            print(line)
        TimeManager.print_summary()
    return mesh, topos, seqs


def upscaling_general_form(form, nref_parallel=1, svd_tol=1e-9,
                           upscaling_order=0, unstructured=False,
                           geometric=False, rtol=1e-6, atol=1e-12,
                           solver="direct", feorder=0) -> UpscalingResult:
    """The canonical golden-value run (UpscalingGeneralForm.exe --form F
    --nref_parallel N --feorder P; feorder > 0 builds the arbitrary-order
    3D sequence, amge.fespace3d_ho)."""
    mesh, topos, seqs = build_hierarchy(
        nref_parallel, unstructured=unstructured, geometric=geometric,
        svd_tol=svd_tol, upscaling_order=upscaling_order, feorder=feorder)
    n_levels = len(seqs)

    ess_attrs = {2, 3, 4, 5}
    if form == 0:
        nat = {1: -1.0}
    elif form == 1:
        nat = {1: (1.0, 1.0, 1.0)}
    else:
        nat = {1: -1.0}

    Ml = [s.compute_mass_operator(form) for s in seqs]
    Wl = [s.compute_mass_operator(form + 1) for s in seqs]
    Dl = [s.D[form] for s in seqs]
    Pl = [seqs[i].P[form] for i in range(n_levels - 1)]

    rhs = [boundary_rhs(seqs[0], form, nat)]
    for i in range(n_levels - 1):
        rhs.append(Pl[i].T @ rhs[i])

    sols, ndofs = [], []
    u_l2, u_en, u_norm = [], [], []
    for k in range(n_levels):
        A = (Ml[k] + Dl[k].T @ Wl[k] @ Dl[k]).tocsr()
        marker = mark_dofs_on_bndr(seqs[k], form, ess_attrs)
        b = rhs[k].copy()
        A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
        x = solve_spd(A, b, solver, rtol, atol)
        sols.append(x)
        ndofs.append(A.shape[0])

        # interpolate down to the fine level
        h = x
        for j in range(k, 0, -1):
            h = Pl[j - 1] @ h
        u_norm.append(float(np.sqrt(x @ (Ml[k] @ x))))
        if k > 0:
            diff = h - sols_fine0
            du = Dl[0] @ diff
            u_l2.append(float(np.sqrt(diff @ (Ml[0] @ diff))))
            u_en.append(float(np.sqrt(du @ (Wl[0] @ du))))
        else:
            sols_fine0 = x
    # reference prints coarsest first
    return UpscalingResult(u_l2[::-1], u_en[::-1], u_norm, ndofs)


def eliminate_rowcols(A, b, marker, values):
    """Symmetric elimination of essential dofs (mfem EliminateRowCol
    semantics used at UpscalingGeneralForm.cpp:668-672): zero row+col,
    keep diagonal, rhs -= A[:,m] v_m, rhs[m] = diag*v_m."""
    A = A.tocsr().copy()
    keep = ~marker
    idx = np.nonzero(marker)[0]
    if idx.size == 0:
        return A, b
    diag = A.diagonal()
    v = np.zeros(A.shape[0])
    v[idx] = values[idx]
    b = b - A @ v
    D = sp.diags(keep.astype(float))
    A = (D @ A @ D).tocsr()
    A = A + sp.diags(np.where(marker, diag, 0.0))
    b[idx] = diag[idx] * values[idx]
    return A.tocsr(), b


def solve_spd(A, b, solver="direct", rtol=1e-6, atol=1e-12, maxiter=500):
    if solver == "direct":
        return spla.spsolve(A.tocsc(), b)
    if solver == "cg":
        from parelag_tpu_torch.solvers.cg import pcg_host
        x, _ = pcg_host(A, b, rtol=rtol, atol=atol, maxiter=maxiter)
        return x
    raise ValueError(solver)


def upscaling_2form_amge(par_ref_levels=2, svd_tol=1e-9,
                         upscaling_order=0, solver="direct",
                         spectral_hook=None) -> UpscalingResult:
    """Upscaling2FormAMGe equivalent (golden lane
    examples/CMakeLists.txt:51-63): 3-level Hdiv upscaling on the generated
    cube, f = (0,0,1) body source, u.n = 0 essential on the whole boundary;
    reference golden 1.9010e-02 3.9570e-03 / 1.2883e-01 5.7793e-02."""
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
    seqs = [DeRhamSequenceFE(topos[0], mesh)]
    seqs[0].set_upscaling_targets(upscaling_order)
    for il in range(par_ref_levels):
        if spectral_hook is not None:
            spectral_hook(seqs[il])
        seqs.append(seqs[il].coarsen(svd_tol=svd_tol))

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
