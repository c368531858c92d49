"""ElectricPotential example: electrostatics of a uniformly charged unit
ball in mixed (Hdiv-L2) form with AMGe upscaling.

Rebuild of reference examples/ElectricPotential.cpp: exact potential
phi(r) = (1 - r^2/3)/2 inside the ball, 1/(3r) outside
(ElectricPotential.cpp:40-64), charge density rho = 1 on attribute-1
elements and 0 outside (PWConstCoefficient, :146-148), natural BC from the
exact potential through VectorFEBoundaryFluxLFIntegrator (:170-174), and
L2 errors of the flux/potential against the analytical solution per
coarsening level (:300-420). The reference runs on a sphere_in_sphere
tet mesh; here the domain is the cube [-2,2]^3 with the ball resolved by
element attributes — the exact solution solves the same PDE on any domain
once the boundary flux uses the exact potential, so the analytical error
checks carry over (up to the staircase approximation of the ball).
"""

from dataclasses import dataclass, replace

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.partitioning.partitioners import refined_mesh_partition
from parelag_tpu_torch.ops import csr as C


def exact_potential(x):
    r = np.linalg.norm(x, axis=-1)
    return np.where(r > 1.0, 1.0 / (3.0 * np.maximum(r, 1e-300)),
                    0.5 * (1.0 - r * r / 3.0))


def exact_field(x):
    r = np.linalg.norm(x, axis=-1, keepdims=True)
    scale = np.where(r > 1.0, 1.0 / (3.0 * np.maximum(r, 1e-300) ** 3),
                     1.0 / 3.0)
    return x * scale


def boundary_flux_rhs(seq_fe, fn):
    """b_f = int_face fn (v_f . n_out) dA for RT0 (variable-coefficient
    VectorFEBoundaryFluxLFIntegrator). The RT0 trace is v.n = 1/A w.r.t.
    the canonical normal, so b_f = out_sign * mean(fn over the face)."""
    mesh = seq_fe.mesh
    ents = seq_fe.ents
    b = np.zeros(seq_fe.dof[2].ndofs)
    from parelag_tpu_torch.mesh.entities import bdr_face_ids
    fids = bdr_face_ids(mesh, ents)
    B0t = ents.B0.T.tocsr()
    for f in fids:
        out_sign = B0t.data[B0t.indptr[f]]
        cyc = np.array(ents.face_verts[f])
        coords = mesh.vertices[cyc][None, :, :]
        X, F = hexfe._face_param(coords, hexfe._Q2)
        W = np.linalg.norm(np.cross(F[0, :, :, 0], F[0, :, :, 1]), axis=1)
        area = float(hexfe._QW2 @ W)
        phi = np.asarray(fn(X[0]))
        b[f] += out_sign * float(hexfe._QW2 @ (W * phi)) / area
    return b


@dataclass
class ElectricPotentialResult:
    ndofs_u: list
    u_analytic_errors: list       # per level, L2 flux error vs exact
    p_analytic_errors: list
    u_upscaling_errors: list      # coarse-vs-fine, levels 1..
    u_norm: float


def electric_potential(nref=1, n=4, coarsening_factor=8, n_levels=2,
                       svd_tol=1e-9):
    """Solve the charged-ball mixed problem at every level of an AMGe
    hierarchy and report analytical + upscaling errors
    (ElectricPotential.cpp main loop, :420-560)."""
    base = hex_grid_mesh(n, n, n, sx=4.0, sy=4.0, sz=4.0)
    mesh = replace(base, vertices=base.vertices - 2.0)
    for _ in range(nref):
        mesh = mesh.uniform_refinement()
    centers = mesh.vertices[mesh.elements].mean(axis=1)
    attrib = np.where(np.linalg.norm(centers, axis=1) <= 1.0, 1, 2)
    mesh = replace(mesh, attrib=attrib.astype(np.int64))

    topos = [AgglomeratedTopology.from_mesh(mesh)]
    ne = mesh.num_elements
    for il in range(n_levels - 1):
        part = refined_mesh_partition(
            topos[il].num_entities(0),
            max(topos[il].num_entities(0) // coarsening_factor, 1))
        topos.append(topos[il].coarsen_local_partitioning(part))

    seq0 = DeRhamSequenceFE(topos[0], mesh)
    seq0.jform_start = 2
    seq0.set_upscaling_targets(0)
    seqs = [seq0]
    for il in range(n_levels - 1):
        seqs.append(seqs[il].coarsen(svd_tol=svd_tol))

    # fine forms: (E,v) - (p, div v) = -b ; (div E, w) = q
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    b = boundary_flux_rhs(seq0, exact_potential)
    q = np.where(mesh.attrib == 1, vols, 0.0)

    ec = mesh.vertices[mesh.elements]
    X = seq0.element_quad_points()
    w = seq0._quad_weights(ec)
    phys = seq0._vector_shapes_at_quad(2, ec)
    E_exact = exact_field(X)
    phi_c = exact_potential(centers)

    res = ElectricPotentialResult([], [], [], [], 0.0)
    res.u_norm = float(np.sqrt(np.einsum(
        "nq,nqa,nqa->", w, E_exact, E_exact)))
    u_fine_ref = None

    for k in range(n_levels):
        s = seqs[k]
        M = s.compute_mass_operator(2)
        W = s.compute_mass_operator(3)
        B = (W @ s.D[2]).tocsr()
        n_u = M.shape[0]
        A = sp.bmat([[M, B.T], [B, None]], format="csc")
        # restrict rhs through the cochain projectors (Pi chain)
        bk, qk = b, q
        for l in range(k):
            bk = seqs[l].P[2].T @ bk
            qk = seqs[l].P[3].T @ qk
        sol = spla.spsolve(A, np.concatenate([-bk, qk]))
        u_k, p_k = sol[:n_u], -sol[n_u:]
        # prolong to the fine level
        for l in range(k - 1, -1, -1):
            u_k = seqs[l].P[2] @ u_k
            p_k = seqs[l].P[3] @ p_k
        # pointwise flux field from RT0 dofs (global face-flux convention)
        coeff = u_k[seq0.ents.elem_face] * seq0.ents.elem_face_sign
        u_h = np.einsum("nqia,ni->nqa", phys, coeff)
        err_u = float(np.sqrt(np.einsum(
            "nq,nqa,nqa->", w, u_h - E_exact, u_h - E_exact)))
        err_p = float(np.sqrt(np.sum(vols * (p_k - phi_c) ** 2)))
        res.ndofs_u.append(n_u)
        res.u_analytic_errors.append(err_u)
        res.p_analytic_errors.append(err_p)
        if k == 0:
            u_fine_ref = u_h
        else:
            res.u_upscaling_errors.append(float(np.sqrt(np.einsum(
                "nq,nqa,nqa->", w, u_h - u_fine_ref, u_h - u_fine_ref))))
    return res
