"""2D de Rham sequence: H1 -> H(div) -> L2 on quadrilateral meshes.

Rebuild of reference DeRhamSequence2D_Hdiv_FE (DeRhamSequenceFE.cpp:724-798):
FE collections [H1 (Q1), RT0, L2 (Q0)] with derivative operators
rot-grad (H1 -> Hdiv) and div (Hdiv -> L2).

Implementation: 2D meshes are embedded at z = 0 and all local matrices reuse
the 3D surface kernels (hexfe face_* / edge_*). The 2D RT0 element is the
90-degree rotation of the 2D ND0 element, so its mass matrix equals the
tangential-trace ND mass with flux dofs identified with circulations of the
rotated field; the flux dof convention is flux across the edge through the
canonical normal n = rot(t, -90), t = (head - tail).
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.amge.sequence import DeRhamSequence
from parelag_tpu_torch.amge.dofhandler import DofHandlerFE
from parelag_tpu_torch.amge.localmass import LocalMass
from parelag_tpu_torch.amge import hexfe


class DeRhamSequence2DFE(DeRhamSequence):
    def __init__(self, topo, mesh):
        assert mesh.dim == 2 and mesh.kind == "quad"
        super().__init__(topo, 3)
        self.kind = "quad"
        self.mesh = mesh
        self.ents = topo.entities

        for j in range(3):
            self.dof[j] = DofHandlerFE(j, mesh, self.ents)

        self._geom_cache = {}
        self._build_derivatives()
        self._assemble_local_mass()
        self.L2_const_rep = np.ones(self.dof[2].ndofs)

    # ------------------------------------------------------------------ #
    def _elem_coords(self):
        if "elem" not in self._geom_cache:
            self._geom_cache["elem"] = self.mesh.vertices[self.mesh.elements]
        return self._geom_cache["elem"]

    def _edge_coords(self):
        if "edge" not in self._geom_cache:
            self._geom_cache["edge"] = self.mesh.vertices[self.ents.edges]
        return self._geom_cache["edge"]

    def element_areas(self):
        return hexfe.face_areas(self._elem_coords())

    def element_quad_points(self):
        s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
        N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t,
                      (1 - s) * t], axis=1)
        return np.einsum("qi,nic->nqc", N, self._elem_coords())

    # ------------------------------------------------------------------ #
    def _build_derivatives(self):
        e = self.ents
        # rot-grad: flux of rot(grad u) across an edge = u_head - u_tail
        self.D[0] = e.B1.copy()
        areas = self.element_areas()
        self.D[1] = (sp.diags(1.0 / areas) @ e.B0).tocsr()

    def _assemble_local_mass(self, elem_coeffs=None):
        m, e = self.mesh, self.ents
        ec = self._elem_coords()
        rc = self._edge_coords()
        ne = m.num_elements
        coeff = elem_coeffs or {}

        self.M[(0, 0)] = LocalMass(
            list(m.elements),
            list(_weighted(hexfe.face_h1_mass(ec), None)))
        # RT0 2D mass == tangential ND mass under the 90-degree rotation
        self.M[(0, 1)] = LocalMass(
            list(e.elem_edge),
            list(hexfe.face_nd_mass(ec, e.elem_edge_sign)))
        areas = hexfe.face_areas(ec)
        self.M[(0, 2)] = LocalMass(
            [np.array([i]) for i in range(ne)],
            list(areas[:, None, None]))
        if coeff:
            # quadrature-weighted recompute for codim-0 slots
            if 0 in coeff:
                self.M[(0, 0)] = LocalMass(
                    list(m.elements),
                    list(_face_h1_mass_coeff(ec, coeff[0])))
            if 1 in coeff:
                self.M[(0, 1)] = LocalMass(
                    list(e.elem_edge),
                    list(_face_nd_mass_coeff(ec, e.elem_edge_sign,
                                             coeff[1])))
            if 2 in coeff:
                self.M[(0, 2)] = LocalMass(
                    [np.array([i]) for i in range(ne)],
                    list(_l2_mass_coeff(ec, coeff[2])))

        self.M[(1, 0)] = LocalMass(list(e.edges),
                                   list(hexfe.edge_h1_mass(rc)))
        self.M[(1, 1)] = LocalMass(
            [np.array([i]) for i in range(e.num_edges)],
            list(hexfe.edge_nd_trace_mass(rc)))
        nv = m.num_vertices
        self.M[(2, 0)] = LocalMass(
            [np.array([i]) for i in range(nv)],
            [np.ones((1, 1)) for _ in range(nv)])

    def replace_mass_integrator(self, form, coeff_fn):
        pts = self.element_quad_points()
        vals = np.asarray(coeff_fn(pts))
        self._coeffs = getattr(self, "_coeffs", {})
        self._coeffs[form] = vals
        self._assemble_local_mass(self._coeffs)

    # ------------------------------------------------------------------ #
    def set_upscaling_targets(self, order=0):
        """fill2DCoefficientArray semantics: H1 gets monomials of total
        degree <= order+1, RT component fields of degree <= order, L2
        monomials of degree <= order."""
        self.targets[0] = self.interpolate_scalar_targets(
            0, _monomials2d(order + 1))
        self.targets[1] = self.interpolate_vector_targets(
            1, _vector_monomials2d(order))
        self.targets[2] = self.interpolate_scalar_targets(
            2, _monomials2d(order))

    def interpolate_scalar_targets(self, jform, fns):
        if jform == 0:
            pts = self.mesh.vertices
        else:
            pts = self._elem_coords().mean(axis=1)
        return np.stack([np.asarray(f(pts)) for f in fns], axis=1) \
            if fns else np.zeros((pts.shape[0], 0))

    def interpolate_vector_targets(self, jform, fns):
        """RT 2D: flux dof = int_e v . n ds, n = (t_y, -t_x)."""
        assert jform == 1
        rc = self._edge_coords()
        t = rc[:, 1] - rc[:, 0]
        g = hexfe._G2
        pts = (rc[:, 0][:, None, :] * (1 - g)[None, :, None]
               + rc[:, 1][:, None, :] * g[None, :, None])
        cols = []
        for f in fns:
            v = np.asarray(f(pts))
            flux = np.einsum("eq,q->e",
                             v[..., 0] * t[:, None, 1]
                             - v[..., 1] * t[:, None, 0], hexfe._W2)
            cols.append(flux)
        return np.stack(cols, axis=1) if fns else np.zeros((rc.shape[0], 0))

    def domain_lf_scalar(self, jform, fn):
        ec = self._elem_coords()
        X = self.element_quad_points()
        f = np.asarray(fn(X))
        _, F = hexfe._face_param(ec, hexfe._Q2)
        G = np.einsum("fqai,fqaj->fqij", F, F)
        W = np.sqrt(np.linalg.det(G))
        w = hexfe._QW2[None, :] * W
        b = np.zeros(self.dof[jform].ndofs)
        if jform == 0:
            s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
            N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t,
                          (1 - s) * t], axis=1)
            vals = np.einsum("nq,qi,nq->ni", w, N, f)
            np.add.at(b, self.mesh.elements.ravel(), vals.ravel())
        elif jform == 2:
            b[:] = (w * f).sum(axis=1)
        else:
            raise ValueError(jform)
        return b

    # ------------------------------------------------------------------ #
    def compute_pv_traces(self, codim) -> np.ndarray:
        jform = 2 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        if codim == 0:            # L2
            pv[:] = 1.0
        elif codim == 1:          # Hdiv: oriented edge lengths
            L = hexfe.edge_lengths(self._edge_coords())
            coo = AE_e.tocoo()
            pv[coo.col] = coo.data * L[coo.col]
        else:                     # H1 at agglomerated vertices
            pv[AE_e.indices] = 1.0
        return pv


def _weighted(blocks, coeff):
    return blocks


def _face_h1_mass_coeff(ec, coeff):
    s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
    N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t, (1 - s) * t],
                 axis=1)
    _, F = hexfe._face_param(ec, hexfe._Q2)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    W = np.sqrt(np.linalg.det(G))
    w = hexfe._QW2[None, :] * W * coeff
    return np.einsum("fq,qi,qj->fij", w, N, N)


def _face_nd_mass_coeff(ec, signs, coeff):
    s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
    nq = s.size
    Ehat = np.zeros((nq, 4, 2))
    Ehat[:, 0, 0] = 1 - t
    Ehat[:, 1, 1] = s
    Ehat[:, 2, 0] = -t
    Ehat[:, 3, 1] = -(1 - s)
    _, F = hexfe._face_param(ec, hexfe._Q2)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    Ginv = np.linalg.inv(G)
    W = np.sqrt(np.linalg.det(G))
    w = hexfe._QW2[None, :] * W * coeff
    M = np.einsum("fq,qia,fqab,qjb->fij", w, Ehat, Ginv, Ehat)
    return M * signs[:, :, None] * signs[:, None, :]


def _l2_mass_coeff(ec, coeff):
    _, F = hexfe._face_param(ec, hexfe._Q2)
    G = np.einsum("fqai,fqaj->fqij", F, F)
    W = np.sqrt(np.linalg.det(G))
    return ((hexfe._QW2[None, :] * W * coeff).sum(axis=1))[:, None, None]


def _monomials2d(max_order):
    fns = []
    for total in range(max_order + 1):
        for i in range(total + 1):
            j = total - i
            fns.append(lambda p, i=i, j=j:
                       (p[..., 0] ** i) * (p[..., 1] ** j))
    return fns


def _vector_monomials2d(max_order):
    fns = []
    for comp in range(2):
        for total in range(max_order + 1):
            for i in range(total + 1):
                j = total - i

                def f(p, comp=comp, i=i, j=j):
                    val = (p[..., 0] ** i) * (p[..., 1] ** j)
                    out = np.zeros(p.shape[:-1] + (2,))
                    out[..., comp] = val
                    return out
                fns.append(f)
    return fns
