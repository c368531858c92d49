"""Fine-level de Rham sequence from a mesh (DeRhamSequenceFE rebuild).

Reference: src/amge/DeRhamSequenceFE.{hpp,cpp} — owns the four FE spaces
H1 -> H(curl) -> H(div) -> L2 at the finest level, the derivative operators
D0=grad, D1=curl, D2=div as oriented incidence matrices, the 10-slot
(codim, form) local mass matrices, polynomial upscaling targets
(SetUpscalingTargets, DeRhamSequenceFE.cpp:927-982) and the PV-trace
interpolants per codim (DeRhamSequenceFE.cpp:690-930).

All local matrices come from the batched hex kernels in
parelag_tpu.amge.hexfe, already folded to global dof orientation.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.amge.sequence import DeRhamSequence
from parelag_tpu_torch.amge.dofhandler import DofHandlerFE
from parelag_tpu_torch.amge.localmass import LocalMass
from parelag_tpu_torch.amge import hexfe, tetfe
from parelag_tpu_torch.mesh.entities import derive_entities


class DeRhamSequenceFE(DeRhamSequence):
    def __init__(self, topo, mesh, dtype=np.float64):
        """dtype: storage precision of the local mass blocks. Passing
        np.float32 assembles the masses directly in f32 (the native
        kernels still accumulate in f64), so a cast_setup(np.float32)
        pipeline skips the multi-GB post-build re-cast entirely."""
        super().__init__(topo, mesh.dim + 1)
        self.kind = mesh.kind
        self.mesh = mesh
        self._mass_dtype = np.dtype(dtype)
        self.ents = topo.entities if hasattr(topo, "entities") else \
            derive_entities(mesh)

        for j in range(self.nforms):
            self.dof[j] = DofHandlerFE(j, mesh, self.ents)

        self._geom_cache = {}
        # masses first: the native single-pass kernel computes element
        # volumes alongside, which _build_derivatives consumes for D2
        self._assemble_local_mass()
        self._build_derivatives()

        # representation of the constant 1 in L2 (cell-value dofs)
        self.L2_const_rep = np.ones(self.dof[3].ndofs)

    # ------------------------------------------------------------------ #
    # geometry
    # ------------------------------------------------------------------ #
    def _elem_coords(self):
        if "elem" not in self._geom_cache:
            self._geom_cache["elem"] = self.mesh.vertices[self.mesh.elements]
        return self._geom_cache["elem"]

    def _face_coords(self):
        if "face" not in self._geom_cache:
            fv = np.asarray(self.ents.face_verts)
            self._geom_cache["face"] = self.mesh.vertices[fv]
        return self._geom_cache["face"]

    def _edge_coords(self):
        if "edge" not in self._geom_cache:
            self._geom_cache["edge"] = self.mesh.vertices[self.ents.edges]
        return self._geom_cache["edge"]

    def element_quad_points(self):
        """Physical coordinates of the element quadrature points
        (ne, nq, 3): tensor 2x2x2 Gauss on hexes, 4-pt degree-2 on tets."""
        ec = self._elem_coords()
        if self.kind == "hex":
            N = hexfe._q1_shapes(hexfe._Q3)       # (nq, 8)
            return np.einsum("qi,nic->nqc", N, ec)
        lam = np.concatenate(
            [1 - tetfe._TQ.sum(axis=1, keepdims=True), tetfe._TQ], axis=1)
        return np.einsum("qi,nic->nqc", lam, ec)

    # ------------------------------------------------------------------ #
    # derivative operators (oriented incidence; see hexfe docstring)
    # ------------------------------------------------------------------ #
    def _build_derivatives(self):
        e = self.ents
        self.D[0] = e.B2.copy()          # grad: circulation = u_head - u_tail
        self.D[1] = e.B1.copy()          # curl: Stokes over face cycle
        vols = self.element_volumes()
        self.D[2] = (sp.diags(1.0 / vols) @ e.B0).tocsr()  # div cell-average

    def element_volumes(self):
        if "vols" in self._geom_cache:
            return self._geom_cache["vols"]
        ec = self._elem_coords()
        vols = (hexfe.hex_volumes(ec) if self.kind == "hex"
                else tetfe.tet_volumes(ec))
        self._geom_cache["vols"] = vols
        return vols

    def facet_areas(self):
        fc = self._face_coords()
        return (hexfe.face_areas(fc) if self.kind == "hex"
                else tetfe.tri_areas(fc))

    # ------------------------------------------------------------------ #
    # local mass matrices, 10 (codim, form) slots
    # ------------------------------------------------------------------ #
    def _assemble_local_mass(self, elem_coeffs=None):
        """elem_coeffs: optional dict form -> (ne, nq) coefficient values
        (ReplaceMassIntegrator equivalent for codim-0 slots)."""
        m, e = self.mesh, self.ents
        ec = self._elem_coords()
        fc = self._face_coords()
        rc = self._edge_coords()
        ne = m.num_elements
        coeff = elem_coeffs or {}

        # ---- codim 0 (element) blocks for all forms ---- #
        # shared geometry: one Jacobian/tangent-frame evaluation feeds all
        # four element kernels and all three face kernels (computing them
        # per kernel dominated the fine build at scale). CHUNKED: the
        # geometry pipeline materializes several (chunk, nq, 3, 3)
        # temporaries — at ~10^6 elements whole-mesh temporaries are
        # hundreds of MB each and the build becomes allocator/bandwidth
        # bound; ~64k-element chunks keep them cache-sized at identical
        # results (every kernel is elementwise in the batch dimension)
        from parelag_tpu_torch.ops import native
        use_native = self.kind == "hex" and native.available()
        if use_native:
            # ONE C++ pass over the elements for all four forms + volumes
            # (the chunked numpy pipeline below is the fallback; identical
            # quadrature, ~6x slower at ~10^6 elements)
            blocks = {}
            (blocks[0], blocks[1], blocks[2], blocks[3],
             vols) = native.hex_masses(
                ec, hexfe._q1_dshapes(hexfe._Q3),
                hexfe._q1_shapes(hexfe._Q3),
                hexfe._nd0_ref_shapes(hexfe._Q3),
                hexfe._rt0_ref_shapes(hexfe._Q3), hexfe._QW3,
                e.elem_edge_sign, e.elem_face_sign, coeff,
                dtype=self._mass_dtype)
            self._geom_cache["vols"] = vols
            self.M[(0, 0)] = LocalMass.from_uniform(m.elements, blocks[0])
            self.M[(0, 1)] = LocalMass.from_uniform(e.elem_edge, blocks[1])
            self.M[(0, 2)] = LocalMass.from_uniform(e.elem_face, blocks[2])
            self.M[(0, 3)] = LocalMass.from_uniform(
                np.arange(ne)[:, None], blocks[3])
        elif self.kind == "hex":
            dt = self._mass_dtype
            blocks = {0: np.empty((ne, 8, 8), dt),
                      1: np.empty((ne, 12, 12), dt),
                      2: np.empty((ne, 6, 6), dt),
                      3: np.empty((ne, 1, 1), dt)}

            def _c(j, sl):
                cj = coeff.get(j)
                return None if cj is None else cj[sl]
            CH = 65536
            for s0 in range(0, max(ne, 1), CH):
                sl = slice(s0, min(s0 + CH, ne))
                geom = hexfe.elem_geom(ec[sl])
                blocks[0][sl] = hexfe.hex_h1_mass(
                    ec[sl], _c(0, sl), geom=geom)
                blocks[1][sl] = hexfe.hex_nd_mass(
                    ec[sl], e.elem_edge_sign[sl], _c(1, sl), geom=geom)
                blocks[2][sl] = hexfe.hex_rt_mass(
                    ec[sl], e.elem_face_sign[sl], _c(2, sl), geom=geom)
                blocks[3][sl] = hexfe.hex_l2_mass(
                    ec[sl], _c(3, sl), geom=geom)
            self.M[(0, 0)] = LocalMass.from_uniform(m.elements, blocks[0])
            self.M[(0, 1)] = LocalMass.from_uniform(e.elem_edge, blocks[1])
            self.M[(0, 2)] = LocalMass.from_uniform(e.elem_face, blocks[2])
            self.M[(0, 3)] = LocalMass.from_uniform(
                np.arange(ne)[:, None], blocks[3])
        else:
            dt = self._mass_dtype
            self.M[(0, 0)] = LocalMass.from_uniform(
                m.elements, tetfe.tet_h1_mass(
                    ec, coeff.get(0)).astype(dt, copy=False))
            self.M[(0, 1)] = LocalMass.from_uniform(
                e.elem_edge, tetfe.tet_nd_mass(
                    ec, e.elem_edge_sign,
                    coeff.get(1)).astype(dt, copy=False))
            self.M[(0, 2)] = LocalMass.from_uniform(
                e.elem_face, tetfe.tet_rt_mass(
                    ec, e.elem_face_sign,
                    coeff.get(2)).astype(dt, copy=False))
            self.M[(0, 3)] = LocalMass.from_uniform(
                np.arange(ne)[:, None], tetfe.tet_l2_mass(
                    ec, coeff.get(3)).astype(dt, copy=False))

        # ---- codim 1 (facet) trace masses ---- #
        if use_native:
            s, t = hexfe._Q2[:, 0], hexfe._Q2[:, 1]
            fsh = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t,
                            (1 - s) * t], axis=1)
            fE = np.zeros((s.size, 4, 2))
            fE[:, 0, 0] = 1 - t
            fE[:, 1, 1] = s
            fE[:, 2, 0] = -t
            fE[:, 3, 1] = -(1 - s)
            fh1, fnd, frt = native.face_masses(
                fc, fsh, fE, hexfe._Q2, hexfe._QW2, e.face_edge_sign,
                dtype=self._mass_dtype)
        elif self.kind == "hex":
            nf_tot = fc.shape[0]
            dt = self._mass_dtype
            fh1 = np.empty((nf_tot, 4, 4), dt)
            fnd = np.empty((nf_tot, 4, 4), dt)
            frt = np.empty((nf_tot, 1, 1), dt)
            CH = 131072
            for s0 in range(0, max(nf_tot, 1), CH):
                sl = slice(s0, min(s0 + CH, nf_tot))
                F = hexfe.face_geom(fc[sl])
                fh1[sl] = hexfe.face_h1_mass(fc[sl], F=F)
                fnd[sl] = hexfe.face_nd_mass(
                    fc[sl], e.face_edge_sign[sl], F=F)
                frt[sl] = hexfe.face_rt_trace_mass(fc[sl], F=F)
        else:
            dt = self._mass_dtype
            fh1 = tetfe.tri_h1_mass(fc).astype(dt, copy=False)
            fnd = tetfe.tri_nd_mass(
                fc, e.face_edge_sign).astype(dt, copy=False)
            frt = tetfe.tri_rt_trace_mass(fc).astype(dt, copy=False)
        self.M[(1, 0)] = LocalMass.from_uniform(
            np.asarray(e.face_verts), fh1)
        self.M[(1, 1)] = LocalMass.from_uniform(e.face_edge, fnd)
        self.M[(1, 2)] = LocalMass.from_uniform(
            np.arange(e.num_faces)[:, None], frt)

        # ---- codim 2 (ridge) ---- #
        dt = self._mass_dtype
        self.M[(2, 0)] = LocalMass.from_uniform(
            e.edges, hexfe.edge_h1_mass(rc).astype(dt, copy=False))
        self.M[(2, 1)] = LocalMass.from_uniform(
            np.arange(e.num_edges)[:, None],
            hexfe.edge_nd_trace_mass(rc).astype(dt, copy=False))

        # ---- codim 3 (peak) ---- #
        nv = m.num_vertices
        self.M[(3, 0)] = LocalMass.from_uniform(
            np.arange(nv)[:, None], np.ones((nv, 1, 1), dt))

    def replace_mass_integrator(self, form, coeff_fn):
        """Replace the codim-0 mass coefficient of `form` and reassemble
        (reference DeRhamSequenceFE::ReplaceMassIntegrator,
        DeRhamSequenceFE.hpp:101). coeff_fn(points (...,3)) -> scalar array;
        trace masses keep unit coefficient, matching the reference examples
        which only replace element integrators."""
        pts = self.element_quad_points()
        vals = np.asarray(coeff_fn(pts))
        self._coeffs = getattr(self, "_coeffs", {})
        self._coeffs[form] = vals
        self._assemble_local_mass(self._coeffs)

    # ------------------------------------------------------------------ #
    # targets (SetUpscalingTargets)
    # ------------------------------------------------------------------ #
    def set_upscaling_targets(self, order=0):
        """Polynomial targets per form: H1 gets all monomials of total degree
        <= order+1; ND/RT get per-component monomials of degree <= order;
        L2 gets monomials of degree <= order
        (reference Coefficient.cpp fill*CoefficientArray +
        DeRhamSequenceFE::SetUpscalingTargets)."""
        h1_polys = _monomials3d(order + 1)
        vec_polys = _vector_monomials3d(order)
        l2_polys = _monomials3d(order)
        self.targets[0] = self.interpolate_scalar_targets(0, h1_polys)
        self.targets[1] = self.interpolate_vector_targets(1, vec_polys)
        self.targets[2] = self.interpolate_vector_targets(2, vec_polys)
        self.targets[3] = self.interpolate_scalar_targets(3, l2_polys)

    def interpolate_scalar_targets(self, jform, fns):
        """Nodal interpolation of scalar functions into H1 (vertex values)
        or L2 (cell-center values)."""
        if jform == 0:
            pts = self.mesh.vertices
        else:
            pts = self._elem_coords().mean(axis=1)
        return np.stack([np.asarray(f(pts)) for f in fns], axis=1) \
            if fns else np.zeros((pts.shape[0], 0))

    def interpolate_vector_targets(self, jform, fns):
        """Moment interpolation of vector fields: ND dof = circulation along
        the edge (2-pt Gauss); RT dof = flux through the face (2x2 Gauss)."""
        CH = 131072       # chunked: whole-mesh quad-point temporaries are
        #                   hundreds of MB at ~10^6 entities
        if jform == 1:
            rc = self._edge_coords()
            ne_tot = rc.shape[0]
            out = np.empty((ne_tot, len(fns)))
            g = hexfe._G2
            for s0 in range(0, max(ne_tot, 1), CH):
                sl = slice(s0, min(s0 + CH, ne_tot))
                rcs = rc[sl]
                tang = rcs[:, 1] - rcs[:, 0]                # global direction
                pts = (rcs[:, 0][:, None, :] * (1 - g)[None, :, None]
                       + rcs[:, 1][:, None, :] * g[None, :, None])
                for j, f in enumerate(fns):
                    v = np.asarray(f(pts))                  # (nedge, nq, 3)
                    out[sl, j] = np.einsum("eqc,ec,q->e", v, tang,
                                           hexfe._W2)
            return out if fns else np.zeros((ne_tot, 0))
        elif jform == 2:
            fc = self._face_coords()
            nf_tot = fc.shape[0]
            out = np.empty((nf_tot, len(fns)))
            for s0 in range(0, max(nf_tot, 1), CH):
                sl = slice(s0, min(s0 + CH, nf_tot))
                fcs = fc[sl]
                if self.kind == "hex":
                    X, F = hexfe._face_param(fcs, hexfe._Q2)
                    normal = np.cross(F[..., 0], F[..., 1])  # cycle normal
                    qw = hexfe._QW2
                else:
                    a = fcs[:, 0][:, None, :]
                    F1 = (fcs[:, 1] - fcs[:, 0])[:, None, :]
                    F2 = (fcs[:, 2] - fcs[:, 0])[:, None, :]
                    sq = tetfe._SQ
                    X = (a + sq[None, :, 0, None] * F1
                         + sq[None, :, 1, None] * F2)
                    normal = np.broadcast_to(
                        np.cross(F1[:, 0], F2[:, 0])[:, None, :], X.shape)
                    # flux = sum_q w_q v(X_q).(F1 x F2), w sums to ref area
                    # 1/2 and |F1 x F2| = 2*area, so constants integrate
                    # exactly
                    qw = tetfe._SW
                for j, f in enumerate(fns):
                    v = np.asarray(f(X))                    # (nf, nq, 3)
                    out[sl, j] = np.einsum("fqc,fqc,q->f", v, normal, qw)
            return out if fns else np.zeros((nf_tot, 0))
        raise ValueError(jform)

    # ------------------------------------------------------------------ #
    # linear forms
    # ------------------------------------------------------------------ #
    def domain_lf_vector(self, jform, fn):
        """b_i = int_Omega f . phi_i for vector FE spaces (ND0/RT0):
        VectorFEDomainLFIntegrator equivalent, batched quadrature."""
        ec = self._elem_coords()
        X = self.element_quad_points()
        f = np.asarray(fn(X))                            # (ne, nq, 3)
        b = np.zeros(self.dof[jform].ndofs)
        phys = self._vector_shapes_at_quad(jform, ec)
        w = self._quad_weights(ec)
        vals = np.einsum("nq,nqia,nqa->ni", w, phys, f)
        if jform == 1:
            vals = vals * self.ents.elem_edge_sign
            np.add.at(b, self.ents.elem_edge.ravel(), vals.ravel())
        else:
            vals = vals * self.ents.elem_face_sign
            np.add.at(b, self.ents.elem_face.ravel(), vals.ravel())
        return b

    def _quad_weights(self, ec):
        """|J| * quadrature weights at element quad points (ne, nq)."""
        if self.kind == "hex":
            J = hexfe._jacobians(ec, hexfe._Q3)
            return hexfe._QW3[None, :] * np.abs(np.linalg.det(J))
        _, det, _ = tetfe._tet_jac(ec)
        return tetfe._TW[None, :] * np.abs(det)[:, None]

    def _vector_shapes_at_quad(self, jform, ec):
        """Physical ND0/RT0 shapes at the element quad points, local-table
        orientation (ne, nq, ndof, 3)."""
        if self.kind == "hex":
            J = hexfe._jacobians(ec, hexfe._Q3)
            if jform == 1:
                Jinv = np.linalg.inv(J)
                E = hexfe._nd0_ref_shapes(hexfe._Q3)
                return np.einsum("nqba,qib->nqia", Jinv, E)
            detJ_s = np.linalg.det(J)
            F = hexfe._rt0_ref_shapes(hexfe._Q3)
            return np.einsum("nqab,qib->nqia", J, F) / \
                detJ_s[:, :, None, None]
        # tets: Whitney shapes evaluated directly in physical coords
        from parelag_tpu_torch.mesh.mesh import TET_EDGES
        nq = tetfe._TQ.shape[0]
        ne = ec.shape[0]
        if jform == 1:
            g = tetfe._grad_lambda(ec)
            lam = np.concatenate(
                [1 - tetfe._TQ.sum(axis=1, keepdims=True), tetfe._TQ],
                axis=1)
            out = np.empty((ne, nq, 6, 3))
            for le, (a, bb) in enumerate(TET_EDGES):
                out[:, :, le, :] = (
                    lam[None, :, a, None] * g[:, None, bb, :]
                    - lam[None, :, bb, None] * g[:, None, a, :])
            return out
        vol = tetfe.tet_volumes(ec)
        X = self.element_quad_points()
        out = np.empty((ne, nq, 4, 3))
        for fidx in range(4):
            out[:, :, fidx, :] = (X - ec[:, fidx][:, None, :]) / (
                3.0 * vol[:, None, None])
        return out

    def domain_lf_scalar(self, jform, fn):
        """b_i = int f phi_i for H1 (Q1/P1) or L2 (Q0/P0)."""
        ec = self._elem_coords()
        X = self.element_quad_points()
        f = np.asarray(fn(X))
        w = self._quad_weights(ec)
        b = np.zeros(self.dof[jform].ndofs)
        if jform == 0:
            if self.kind == "hex":
                N = hexfe._q1_shapes(hexfe._Q3)
            else:
                N = np.concatenate(
                    [1 - tetfe._TQ.sum(axis=1, keepdims=True), tetfe._TQ],
                    axis=1)
            vals = np.einsum("nq,qi,nq->ni", w, N, f)
            np.add.at(b, self.mesh.elements.ravel(), vals.ravel())
        elif jform == 3:
            b[:] = (w * f).sum(axis=1)
        else:
            raise ValueError(jform)
        return b

    def boundary_dofs(self, jform):
        """Dofs of `jform` on the domain boundary (via bdr facet closures)."""
        from parelag_tpu_torch.mesh.entities import bdr_face_ids
        fids = bdr_face_ids(self.mesh, self.ents)
        ed = self.dof[jform].entity_dofs(1)
        out = np.zeros(self.dof[jform].ndofs, dtype=bool)
        for f in fids:
            out[ed[f]] = True
        return out

    # ------------------------------------------------------------------ #
    # PV traces (DeRhamSequence3D_FE::computePVTraces)
    # ------------------------------------------------------------------ #
    def compute_pv_traces(self, codim) -> np.ndarray:
        jform = self.nforms - 1 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        if codim == 0:            # L2: interpolant of 1
            pv[:] = 1.0
        elif codim == 1:          # Hdiv: unit-normal field; defined through
            # the facet trace mass so that (pv, t)_M = oriented net flux
            # exactly on curved faces too (equals sigma * area when flat)
            # 1x1 trace blocks read straight from the flat layout (the
            # per-block Python list cost ~10 s at 10^6-face scale)
            frt = self.M[(1, 2)].concatenated()[2]
            coo = AE_e.tocoo()
            pv[coo.col] = coo.data / frt[coo.col]
        elif codim == 2:          # Hcurl: unit-tangent field via the edge
            # trace mass ((pv, t)_M = oriented circulation sum)
            fnd = self.M[(2, 1)].concatenated()[2]
            coo = AE_e.tocoo()
            pv[coo.col] = coo.data / fnd[coo.col]
        else:                     # H1: ones at agglomerated peaks
            pv[AE_e.indices] = 1.0
        return pv


# -------------------------------------------------------------------- #
def _monomials3d(max_order):
    """All monomials x^i y^j z^k with i+j+k <= max_order, ordered by total
    degree then x-order (reference fill3DCoefficientArray)."""
    fns = []
    for total in range(max_order + 1):
        for i in range(total + 1):
            for j in range(total - i + 1):
                k = total - i - j
                fns.append(_mono(i, j, k))
    return fns


def _mono(i, j, k):
    def f(p):
        return (p[..., 0] ** i) * (p[..., 1] ** j) * (p[..., 2] ** k)
    return f


def _vector_monomials3d(max_order):
    """Per-component monomial vector fields (fill3DVectorCoefficientArray)."""
    fns = []
    for comp in range(3):
        for total in range(max_order + 1):
            for i in range(total + 1):
                for j in range(total - i + 1):
                    k = total - i - j
                    fns.append(_vmono(comp, i, j, k))
    return fns


def _vmono(comp, i, j, k):
    def f(p):
        val = (p[..., 0] ** i) * (p[..., 1] ** j) * (p[..., 2] ** k)
        out = np.zeros(p.shape)
        out[..., comp] = val
        return out
    return f
