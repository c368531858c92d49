"""Boundary helpers of the upscaling drivers (copies).

The host helpers of parelag_tpu/models/upscaling.py that the generic H1
problem and models/spectral.py need (mark_dofs_on_bndr, boundary_rhs,
eliminate_rowcols, UpscalingResult, solve_spd), copied with their import
lines rewritten; the rest of the module (the UpscalingGeneralForm
programs) is not ported yet.
"""

from dataclasses import dataclass
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge import hexfe


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


def solve_spd(A, b, solver="direct", rtol=1e-6, atol=1e-12, maxiter=500):
    if solver == "direct":
        return spla.spsolve(A.tocsc(), b)
    if solver == "cg":
        from parelag_tpu_torch.solvers.cg import pcg_host
        x, _ = pcg_host(A, b, rtol=rtol, atol=atol, maxiter=maxiter)
        return x
    raise ValueError(solver)
