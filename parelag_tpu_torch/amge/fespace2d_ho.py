"""Arbitrary-order 2D de Rham sequence: Q_{p+1} -> RT_p -> Q_p (feorder=p).

The reference builds arbitrary-order sequences through MFEM FE collections
(DeRhamSequenceFE.cpp order handling; every example exposes -feo,
e.g. Upscaling0Form.cpp:44-56). The TPU-native rebuild uses the exterior-
calculus dof design so the machinery stays array-shaped:

  * H1 = Q_{p+1}: NODAL dofs at tensor Gauss-Lobatto points — vertices,
    p interior nodes per edge (ordered along the GLOBAL edge direction,
    making them orientation-invariant), (p)^2 interior nodes... (k-1)^2
    for k = p+1.
  * Hdiv = RT_p: MOMENT dofs — per edge, p+1 flux moments against
    Legendre P_j in the global edge parameter (with the canonical normal
    n = rot(t, -90)); per element, 2p(p+1) interior reference moments.
  * L2 = Q_p: density (2-form) moments against the reference Legendre
    tensor basis.

With moment/nodal dofs and form-appropriate pullbacks (0-form composition,
Piola for Hdiv, density for L2), the discrete derivative matrices D0
(rot-grad) and D1 (div) are GEOMETRY-INDEPENDENT rational matrices — the
higher-order generalization of the +-1 incidence tables — so D1 @ D0 = 0
holds exactly and all geometry lives in the (batched, quadrature-built)
mass matrices. Orientation is a per-(element, edge) sign/permutation
transform applied to fixed reference layouts, vectorized over elements.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.amge.sequence import DeRhamSequence
from parelag_tpu_torch.amge.localmass import LocalMass
from parelag_tpu_torch.amge.dofhandler import DofHandlerBase
from parelag_tpu_torch.ops import ragged as Rg


# ---------------------------------------------------------------------- #
# 1-D reference machinery on [0, 1]
# ---------------------------------------------------------------------- #
def gauss_points(n):
    """n-point Gauss-Legendre on [0,1] -> (x, w)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def lobatto_points(k):
    """k+1 Gauss-Lobatto points on [0,1] (endpoints included)."""
    if k == 1:
        return np.array([0.0, 1.0])
    Pk = np.polynomial.legendre.Legendre.basis(k)
    inner = np.sort(Pk.deriv().roots())
    return np.concatenate([[-1.0], inner, [1.0]]) * 0.5 + 0.5


def legendre_vals(p, x):
    """(p+1, len(x)) Legendre P_0..P_p on [0,1] (shifted, unnormalized)."""
    t = 2.0 * np.asarray(x) - 1.0
    out = [np.ones_like(t)]
    if p >= 1:
        out.append(t)
    for j in range(2, p + 1):
        out.append(((2 * j - 1) * t * out[-1] - (j - 1) * out[-2]) / j)
    return np.stack(out, axis=0)


def nodal_basis_1d(nodes, x):
    """Lagrange basis at `nodes` evaluated at x -> (len(nodes), len(x))."""
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)
    E = np.vander(np.asarray(x), n, increasing=True)
    return np.linalg.solve(V.T, E.T)          # coeffs applied at x


def nodal_dbasis_1d(nodes, x):
    """Derivatives of the Lagrange basis at x."""
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)
    xp = np.asarray(x)
    dE = np.zeros((len(xp), n))
    for j in range(1, n):
        dE[:, j] = j * xp ** (j - 1)
    return np.linalg.solve(V.T, dE.T)


# ---------------------------------------------------------------------- #
# reference element tables for order p (cached per order)
# ---------------------------------------------------------------------- #
_REF_CACHE = {}


class _Ref:
    """All reference-element data for feorder = p on the unit square.

    Local layouts (the 'reference layout'):
      H1  : [4 corners (v0..v3)] + [per local edge: k-1 nodes in CYCLE
            direction] + [(k-1)^2 interior, x-fastest]      (k = p+1)
      RT  : [per local edge: p+1 moments (P_0..P_p) in CYCLE direction
            with OUTWARD normal] + [2p(p+1) interior moments:
            x-component against Q_{p-1,p}, then y against Q_{p,p-1}]
      L2  : [(p+1)^2 density moments, Legendre tensor, x-fastest]
    """

    def __init__(self, p):
        self.p = p
        k = p + 1
        self.k = k
        nq = p + 3
        gx, gw = gauss_points(nq)
        # tensor quadrature
        QX, QY = np.meshgrid(gx, gx, indexing="ij")
        self.qpts = np.stack([QX.ravel(), QY.ravel()], axis=1)
        self.qw = np.outer(gw, gw).ravel()
        self.gx, self.gw = gx, gw

        nodes = lobatto_points(k)
        self.nodes1d = nodes
        # 1-D bases at quadrature points
        self.N1 = nodal_basis_1d(nodes, gx)       # (k+1, nq)
        self.dN1 = nodal_dbasis_1d(nodes, gx)
        self.P1 = legendre_vals(p, gx)            # (p+1, nq)

        # ---- H1 local layout ---- #
        # node coordinates index pairs (ix, iy) per local dof
        corners = [(0, 0), (k, 0), (k, k), (0, k)]
        cyc = [(0, 1), (1, 2), (2, 3), (3, 0)]
        cpos = [np.array([0.0, 0.0]), np.array([1.0, 0.0]),
                np.array([1.0, 1.0]), np.array([0.0, 1.0])]
        h1_nodes = [cpos[i] for i in range(4)]
        for (a, b) in cyc:
            for t in nodes[1:-1]:
                h1_nodes.append(cpos[a] + t * (cpos[b] - cpos[a]))
        for iy in range(1, k):
            for ix in range(1, k):
                h1_nodes.append(np.array([nodes[ix], nodes[iy]]))
        self.h1_nodes = np.array(h1_nodes)        # (nH1, 2)
        self.nH1 = len(h1_nodes)

        # H1 shape values/gradients at quadrature points via tensor nodal
        # basis then Vandermonde re-expansion onto the node set
        self.h1_V, self.h1_dV = self._h1_shapes(self.qpts)

        # ---- RT_p reference basis (dual to the moment dofs) ---- #
        # monomial space Q_{p+1,p} x Q_{p,p+1}
        self.rt_mono = ([("x", i, j) for i in range(p + 2)
                         for j in range(p + 1)]
                        + [("y", i, j) for i in range(p + 1)
                           for j in range(p + 2)])
        self.nRT = len(self.rt_mono)
        self.n_rt_edge = p + 1
        self.n_rt_int = 2 * p * (p + 1)
        assert self.nRT == 4 * self.n_rt_edge + self.n_rt_int
        V = np.array([[self._rt_dof(i, m) for m in self.rt_mono]
                      for i in range(self.nRT)])
        self.rt_coeff = np.linalg.inv(V)          # columns = basis coeffs
        # basis values at quadrature points (nRT, nq2, 2)
        self.rt_V = self._rt_eval(self.qpts)

        # L2 reference: Legendre tensor basis (orthogonal, not normalized)
        # dof_i(w-hat) = int w-hat L_i ; basis dual: L_j / ||L_j||^2
        self.nL2 = (p + 1) ** 2
        self.l2_pairs = [(i, j) for j in range(p + 1)
                         for i in range(p + 1)]    # x-fastest
        l2n = np.array([1.0 / ((2 * i + 1) * (2 * j + 1))
                        for (i, j) in self.l2_pairs])
        self.l2_norm2 = l2n                        # int L_i^2 L_j^2
        # L2 basis values at qpts: dual basis = L / norm2
        P = legendre_vals(p, self.qpts[:, 0])
        Q = legendre_vals(p, self.qpts[:, 1])
        self.l2_V = np.stack(
            [P[i] * Q[j] / l2n[idx]
             for idx, (i, j) in enumerate(self.l2_pairs)], axis=0)

        # divergence of each basis fn expanded in L2 moments -> D1_ref
        self.D1_ref = self._d1_ref()
        # rot-grad of each H1 reference dof-basis in RT dofs -> D0_ref
        self.D0_ref = self._d0_ref()

        # edge trace of RT basis: flux density (v-hat . n-hat outward) on
        # each local edge as Legendre coefficients — needed for trace mass
        self.rt_edge_trace = self._rt_edge_traces()

    # ---------------- H1 helpers ---------------- #
    def _h1_shapes(self, pts):
        k = self.k
        nb = nodal_basis_1d(self.nodes1d, pts[:, 0])   # (k+1, n)
        nbY = nodal_basis_1d(self.nodes1d, pts[:, 1])
        db = nodal_dbasis_1d(self.nodes1d, pts[:, 0])
        dbY = nodal_dbasis_1d(self.nodes1d, pts[:, 1])
        # tensor nodal basis indexed by (ix, iy); express the dof basis by
        # matching each h1 node to its (ix, iy)
        idx = []
        for xy in self.h1_nodes:
            ix = int(np.argmin(np.abs(self.nodes1d - xy[0])))
            iy = int(np.argmin(np.abs(self.nodes1d - xy[1])))
            idx.append((ix, iy))
        V = np.stack([nb[ix] * nbY[iy] for ix, iy in idx], axis=0)
        dV = np.stack(
            [np.stack([db[ix] * nbY[iy], nb[ix] * dbY[iy]], axis=-1)
             for ix, iy in idx], axis=0)
        return V, dV

    # ---------------- RT helpers ---------------- #
    def _mono_eval(self, m, pts):
        c, i, j = m
        val = pts[:, 0] ** i * pts[:, 1] ** j
        out = np.zeros((pts.shape[0], 2))
        out[:, 0 if c == "x" else 1] = val
        return out

    _EDGE = [  # (start, dir, outward normal) of local edges v0v1..v3v0
        (np.array([0.0, 0.0]), np.array([1.0, 0.0]), np.array([0., -1.])),
        (np.array([1.0, 0.0]), np.array([0.0, 1.0]), np.array([1., 0.])),
        (np.array([1.0, 1.0]), np.array([-1.0, 0.0]), np.array([0., 1.])),
        (np.array([0.0, 1.0]), np.array([0.0, -1.0]), np.array([-1., 0.])),
    ]

    def _rt_dof(self, i, m):
        """Value of reference dof i on monomial field m."""
        p = self.p
        gx, gw = self.gx, self.gw
        if i < 4 * (p + 1):
            e, j = divmod(i, p + 1)
            s0, d, n = self._EDGE[e]
            pts = s0[None, :] + gx[:, None] * d[None, :]
            v = self._mono_eval(m, pts)
            P = legendre_vals(p, gx)[j]
            return float(np.sum(gw * (v @ n) * P))
        i -= 4 * (p + 1)
        # interior: x-comp against Q_{p-1,p} then y against Q_{p,p-1}
        if i < p * (p + 1):
            a, b = divmod(i, p + 1)          # a < p, b <= p
            comp = 0
        else:
            i -= p * (p + 1)
            a, b = divmod(i, p)              # a <= p, b < p
            comp = 1
        q = self.qpts
        v = self._mono_eval(m, q)[:, comp]
        if comp == 0:
            test = q[:, 0] ** a * q[:, 1] ** b     # a<p, b<=p
        else:
            test = q[:, 0] ** a * q[:, 1] ** b     # a<=p, b<p  (b index)
        return float(np.sum(self.qw * v * test))

    def _rt_eval(self, pts):
        out = np.zeros((self.nRT, pts.shape[0], 2))
        for mi, m in enumerate(self.rt_mono):
            val = self._mono_eval(m, pts)
            out += self.rt_coeff[mi][:, None, None] * val[None]
        return out

    def _d1_ref(self):
        """L2 density moments of div(rt basis) -> (nL2, nRT)."""
        p = self.p
        out = np.zeros((self.nL2, self.nRT))
        P = legendre_vals(p, self.qpts[:, 0])
        Q = legendre_vals(p, self.qpts[:, 1])
        for mi, (c, i, j) in enumerate(self.rt_mono):
            if c == "x":
                dv = (i * self.qpts[:, 0] ** max(i - 1, 0)
                      * self.qpts[:, 1] ** j) if i else 0.0
            else:
                dv = (j * self.qpts[:, 0] ** i
                      * self.qpts[:, 1] ** max(j - 1, 0)) if j else 0.0
            if np.isscalar(dv):
                continue
            moms = np.array([np.sum(self.qw * dv * P[a] * Q[b])
                             for (a, b) in self.l2_pairs])
            out += np.outer(moms, self.rt_coeff[mi])
        return out

    def _d0_ref(self):
        """RT dofs of rot-grad(H1 basis) -> (nRT, nH1); exact since
        rot-grad Q_{p+1} is inside RT_p."""
        # evaluate rot-grad at dof functionals numerically: edge moments
        # via edge quadrature of tangential derivative; interior moments
        # via tensor quadrature
        p, k = self.p, self.k
        out = np.zeros((self.nRT, self.nH1))
        gx, gw = self.gx, self.gw
        for e in range(4):
            s0, d, n = self._EDGE[e]
            pts = s0[None, :] + gx[:, None] * d[None, :]
            _, dV = self._h1_shapes(pts)
            # rot-grad u . n ds-density = tangential derivative along d
            du = dV[:, :, 0] * d[0] + dV[:, :, 1] * d[1]
            P = legendre_vals(p, gx)
            for j in range(p + 1):
                out[e * (p + 1) + j] = np.sum(
                    gw[None, :] * du * P[j][None, :], axis=1)
        q = self.qpts
        _, dV = self._h1_shapes(q)
        rg = np.stack([dV[:, :, 1], -dV[:, :, 0]], axis=-1)
        base = 4 * (p + 1)
        for i in range(p * (p + 1)):
            a, b = divmod(i, p + 1)
            test = q[:, 0] ** a * q[:, 1] ** b
            out[base + i] = np.sum(self.qw * rg[:, :, 0] * test, axis=1)
        for i in range(p * (p + 1)):
            a, b = divmod(i, p)
            test = q[:, 0] ** a * q[:, 1] ** b
            out[base + p * (p + 1) + i] = np.sum(
                self.qw * rg[:, :, 1] * test, axis=1)
        return out

    def _rt_edge_traces(self):
        """Per local edge: (p+1 moments basis) -> flux density Legendre
        coefficients of each RT basis function on that edge. Because the
        dofs ARE those moments, basis j has trace P_j-expansion with
        coefficient matrix = Gram-normalized identity on its own edge and
        zero on others; returned as values at edge quadrature points:
        (4, nRT, nq)."""
        p = self.p
        gx = self.gx
        out = np.zeros((4, self.nRT, gx.size))
        for e in range(4):
            s0, d, n = self._EDGE[e]
            pts = s0[None, :] + gx[:, None] * d[None, :]
            v = self._rt_eval(pts)
            out[e] = v @ n
        return out


def _ref(p) -> _Ref:
    if p not in _REF_CACHE:
        _REF_CACHE[p] = _Ref(p)
    return _REF_CACHE[p]


# ---------------------------------------------------------------------- #
# dof handlers
# ---------------------------------------------------------------------- #
class DofHandler2DHO(DofHandlerBase):
    """Order-p dof handler for one 2D form; dofs are numbered
    entity-major: H1 [vertices | p per edge | p^2 per element],
    RT [p+1 per edge | 2p(p+1) per element], L2 [(p+1)^2 per element].
    entity_dofs rows follow the element's REFERENCE layout (edge blocks in
    cycle order; H1 edge nodes listed in GLOBAL direction when the cycle
    opposes it the table row carries the reversal)."""

    def __init__(self, form, mesh, ents, p):
        self.form = form
        self.mesh = mesh
        self.ents = ents
        self.p = p
        self.dim = 2
        self.max_codim = 2 - form
        ne = mesh.num_elements
        ned = ents.num_edges
        nv = mesh.num_vertices
        k = p + 1
        if form == 0:
            self.n_edge, self.n_int = k - 1, (k - 1) ** 2
            self.off_e = nv
            self.off_i = nv + ned * self.n_edge
            self.ndofs = self.off_i + ne * self.n_int
        elif form == 1:
            self.n_edge, self.n_int = p + 1, 2 * p * (p + 1)
            self.off_e = 0
            self.off_i = ned * self.n_edge
            self.ndofs = self.off_i + ne * self.n_int
        else:
            self.n_edge, self.n_int = 0, (p + 1) ** 2
            self.off_e = 0
            self.off_i = 0
            self.ndofs = ne * self.n_int
        self._tables = {}

    def edge_dofs(self, e=None):
        """(ned, n_edge) global ids of edge-supported dofs."""
        ned = self.ents.num_edges
        out = (self.off_e + np.arange(ned)[:, None] * self.n_edge
               + np.arange(self.n_edge)[None, :])
        return out if e is None else out[e]

    def int_dofs(self):
        ne = self.mesh.num_elements
        return (self.off_i + np.arange(ne)[:, None] * self.n_int
                + np.arange(self.n_int)[None, :])

    def entity_dofs(self, codim):
        if codim in self._tables:
            return self._tables[codim]
        m, e, form, p = self.mesh, self.ents, self.form, self.p
        if codim == 0:
            parts = []
            if form == 0:
                parts.append(m.elements)           # 4 vertices
            if form in (0, 1):
                ed = self.edge_dofs()[e.elem_edge]  # (ne, 4, n_edge)
                # H1 edge nodes: table row must list the node at the
                # element's cycle position t; global numbering runs along
                # the global direction -> reverse when r = -1
                if form == 0 and self.n_edge > 1:
                    r = e.elem_edge_sign            # (ne, 4)
                    ed = np.where(r[:, :, None] > 0, ed, ed[:, :, ::-1])
                parts.append(ed.reshape(m.num_elements, -1))
            parts.append(self.int_dofs())
            t = np.concatenate([np.asarray(x) for x in parts], axis=1)
        elif codim == 1:
            if form == 0:
                # [tail, head, interior nodes (global order)]
                t = np.concatenate([e.edges, self.edge_dofs()], axis=1)
            elif form == 1:
                t = self.edge_dofs()
            else:
                raise ValueError("L2 has no edge dofs")
        else:
            if form != 0:
                raise ValueError
            t = np.arange(m.num_vertices)[:, None]
        self._tables[codim] = np.asarray(t)
        return self._tables[codim]


# ---------------------------------------------------------------------- #
# the sequence
# ---------------------------------------------------------------------- #
class DeRhamSequence2DFE_HO(DeRhamSequence):
    """Arbitrary-order 2D de Rham sequence (feorder = p >= 0)."""

    def __init__(self, topo, mesh, feorder=1):
        assert mesh.dim == 2 and mesh.kind == "quad"
        super().__init__(topo, 3)
        self.kind = "quad"
        self.mesh = mesh
        self.ents = topo.entities
        self.feorder = feorder
        self.ref = _ref(feorder)
        for j in range(3):
            self.dof[j] = DofHandler2DHO(j, mesh, self.ents, feorder)
        self._geometry()
        self._build_derivatives()
        self._assemble_local_mass()
        self.L2_const_rep = self._l2_dofs_of_one()

    # ---------------- geometry ---------------- #
    def _geometry(self):
        R = self.ref
        ec = self.mesh.vertices[self.mesh.elements][:, :, :2]  # (ne,4,2)
        s, t = R.qpts[:, 0], R.qpts[:, 1]
        N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t,
                      (1 - s) * t], axis=1)                    # (nq,4)
        dNs = np.stack([-(1 - t), (1 - t), t, -t], axis=1)
        dNt = np.stack([-(1 - s), -s, s, (1 - s)], axis=1)
        self.qphys = np.einsum("qi,nic->nqc", N, ec)
        J = np.empty((ec.shape[0], R.qpts.shape[0], 2, 2))
        J[:, :, :, 0] = np.einsum("qi,nic->nqc", dNs, ec)
        J[:, :, :, 1] = np.einsum("qi,nic->nqc", dNt, ec)
        self.J = J
        self.detJ = (J[..., 0, 0] * J[..., 1, 1]
                     - J[..., 0, 1] * J[..., 1, 0])
        rc = self.mesh.vertices[self.ents.edges][:, :, :2]
        self.edge_vec = rc[:, 1] - rc[:, 0]
        self.edge_len = np.linalg.norm(self.edge_vec, axis=1)
        self.edge_coords = rc
        # per-(element, local edge) sign table for RT moments:
        # global moment j = r^(j+1) * local(cycle/outward) moment j
        r = self.ents.elem_edge_sign                            # (ne,4)
        j = np.arange(self.ref.p + 1)
        self.rt_sign = (np.sign(r)[:, :, None].astype(float)
                        ** (j[None, None, :] + 1))
        ne = self.mesh.num_elements
        self.rt_elem_sign = np.concatenate(
            [self.rt_sign.reshape(ne, -1),
             np.ones((ne, self.ref.n_rt_int))], axis=1)

    # ---------------- derivatives ---------------- #
    def _build_derivatives(self):
        R = self.ref
        p, k = R.p, R.k
        d0, d1 = self.dof[0], self.dof[1]
        ned = self.ents.num_edges
        ne = self.mesh.num_elements

        # edge rows of D0: global-direction tangential-derivative moments
        # against [tail, head, interior nodes]; constant 1-D matrix
        gx, gw = R.gx, R.gw
        nodes = np.concatenate([[0.0, 1.0], R.nodes1d[1:-1]])
        dN = nodal_dbasis_1d(nodes, gx)                        # (k+1, nq)
        P = legendre_vals(p, gx)
        Dedge = np.einsum("q,jq,iq->ji", gw, P, dN)            # (p+1,k+1)

        b = sp.lil_matrix((d1.ndofs, d0.ndofs))
        rows = d1.edge_dofs()                                  # (ned,p+1)
        cols = self.dof[0].entity_dofs(1)                      # (ned,k+1)
        from parelag_tpu_torch.ops import csr as C
        bb = C.coo_builder()
        bb.add_blocks_var(
            rows.reshape(-1), np.arange(ned + 1) * (p + 1),
            cols.reshape(-1), np.arange(ned + 1) * (k + 1),
            np.tile(Dedge.ravel(), ned))
        # interior rows: reference constants, columns = element H1 table
        h1t = d0.entity_dofs(0)                                # (ne,nH1)
        irows = d1.int_dofs()                                  # (ne,n_int)
        D0int = R.D0_ref[4 * (p + 1):]                         # (n_int,nH1)
        bb.add_blocks_var(
            irows.reshape(-1), np.arange(ne + 1) * R.n_rt_int,
            h1t.reshape(-1), np.arange(ne + 1) * R.nH1,
            np.tile(D0int.ravel(), ne))
        self.D[0] = bb.tocsr((d1.ndofs, d0.ndofs), sum_duplicates=True)

        # D1: reference constants with RT sign transform per element
        d2 = self.dof[2]
        rt_t = d1.entity_dofs(0)                               # (ne,nRT)
        l2_t = d2.entity_dofs(0)                               # (ne,nL2)
        vals = (R.D1_ref[None, :, :]
                * self.rt_elem_sign[:, None, :])               # (ne,nL2,nRT)
        bb = C.coo_builder()
        bb.add_blocks_var(
            l2_t.reshape(-1), np.arange(ne + 1) * R.nL2,
            rt_t.reshape(-1), np.arange(ne + 1) * R.nRT,
            vals.ravel())
        self.D[1] = bb.tocsr((d2.ndofs, d1.ndofs), sum_duplicates=True)

    # ---------------- local mass matrices ---------------- #
    def _assemble_local_mass(self, elem_coeffs=None):
        R = self.ref
        coeff = elem_coeffs or {}
        ne = self.mesh.num_elements
        detJ = self.detJ
        qw = R.qw[None, :]

        def cw(form):
            c = coeff.get(form)
            return 1.0 if c is None else c

        # H1 element mass (reference layout == table layout)
        w = qw * np.abs(detJ) * cw(0)
        M0 = np.einsum("nq,iq,jq->nij", w, R.h1_V, R.h1_V)
        self.M[(0, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(0), M0)

        # RT element mass: metric J^T J / detJ, then the sign transform
        G = np.einsum("nqca,nqcb->nqab", self.J, self.J) \
            / detJ[:, :, None, None]
        w1 = qw[..., None, None] * G * np.asarray(cw(1))[..., None, None] \
            if np.ndim(cw(1)) else qw[..., None, None] * G * cw(1)
        M1 = np.einsum("iqa,nqab,jqb->nij", R.rt_V.transpose(0, 1, 2),
                       w1, R.rt_V, optimize=True)
        S = self.rt_elem_sign
        M1 = M1 * S[:, :, None] * S[:, None, :]
        self.M[(0, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(0), M1)

        # L2 element mass: density basis / detJ
        w2 = qw / np.abs(detJ) * cw(2)
        M2 = np.einsum("nq,iq,jq->nij", w2, R.l2_V, R.l2_V)
        self.M[(0, 2)] = LocalMass.from_uniform(
            self.dof[2].entity_dofs(0), M2)

        # edge trace masses
        k, p = R.k, R.p
        nodes = np.concatenate([[0.0, 1.0], R.nodes1d[1:-1]])
        N = nodal_basis_1d(nodes, R.gx)
        M1d = np.einsum("q,iq,jq->ij", R.gw, N, N)
        self.M[(1, 0)] = LocalMass.from_uniform(
            self.dof[0].entity_dofs(1),
            self.edge_len[:, None, None] * M1d[None])
        # RT normal-trace mass: flux density sum_j (2j+1) m_j P_j; on
        # straight edges int (v.n)(w.n) ds = sum_j (2j+1) m_v m_w / L
        tr = np.diag(2 * np.arange(p + 1) + 1.0)
        self.M[(1, 1)] = LocalMass.from_uniform(
            self.dof[1].entity_dofs(1),
            tr[None] / self.edge_len[:, None, None])
        nv = self.mesh.num_vertices
        self.M[(2, 0)] = LocalMass.from_uniform(
            np.arange(nv)[:, None], np.ones((nv, 1, 1)))

    def replace_mass_integrator(self, form, coeff_fn):
        vals = np.asarray(coeff_fn(self.qphys))
        self._coeffs = getattr(self, "_coeffs", {})
        self._coeffs[form] = vals
        self._assemble_local_mass(self._coeffs)

    # ---------------- interpolation / targets ---------------- #
    def h1_node_coords(self):
        R = self.ref
        m, e = self.mesh, self.ents
        verts = m.vertices[:, :2]
        tnodes = R.nodes1d[1:-1]
        rc = self.edge_coords
        edge_nodes = (rc[:, 0][:, None, :]
                      + tnodes[None, :, None]
                      * self.edge_vec[:, None, :]).reshape(-1, 2)
        k = R.k
        ref_int = np.array([[R.nodes1d[ix], R.nodes1d[iy]]
                            for iy in range(1, k)
                            for ix in range(1, k)]).reshape(-1, 2)
        if ref_int.shape[0]:
            s, t = ref_int[:, 0], ref_int[:, 1]
            N = np.stack([(1 - s) * (1 - t), s * (1 - t), s * t,
                          (1 - s) * t], axis=1)
            ec = m.vertices[m.elements][:, :, :2]
            int_nodes = np.einsum("qi,nic->nqc", N, ec).reshape(-1, 2)
        else:
            int_nodes = np.zeros((0, 2))
        return np.concatenate([verts, edge_nodes, int_nodes], axis=0)

    def interpolate_scalar_targets(self, jform, fns):
        if jform == 0:
            pts = self.h1_node_coords()
            return (np.stack([np.asarray(f(pts)) for f in fns], axis=1)
                    if fns else np.zeros((pts.shape[0], 0)))
        assert jform == 2
        R = self.ref
        cols = []
        for f in fns:
            v = np.asarray(f(self.qphys))          # (ne, nq)
            P = legendre_vals(R.p, R.qpts[:, 0])
            Q = legendre_vals(R.p, R.qpts[:, 1])
            dof = np.stack(
                [np.sum(R.qw * v * np.abs(self.detJ) * P[i] * Q[j],
                        axis=1) for (i, j) in R.l2_pairs], axis=1)
            cols.append(dof.reshape(-1))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[2].ndofs, 0)))

    def interpolate_vector_targets(self, jform, fns):
        assert jform == 1
        R = self.ref
        p = R.p
        gx, gw = R.gx, R.gw
        rc = self.edge_coords
        tvec = self.edge_vec
        n = np.stack([tvec[:, 1], -tvec[:, 0]], axis=1)  # rot(t,-90)*L
        pts = (rc[:, 0][:, None, :]
               + gx[None, :, None] * tvec[:, None, :])
        P = legendre_vals(p, gx)
        Jinv = np.linalg.inv(self.J)
        cols = []
        for f in fns:
            v = np.asarray(f(pts))                  # (ned, nq, 2)
            # edge moments: int v.n_hat P_j W ds_hat ; n*W ds_hat = n ds
            flux = np.einsum("eqc,ec->eq", v, n)
            mom = np.einsum("eq,jq,q->ej", flux, P, gw)
            ve = np.asarray(f(self.qphys))          # (ne, nq, 2)
            vhat = np.einsum("nq,nqab,nqb->nqa", self.detJ, Jinv, ve)
            ints = []
            q = R.qpts
            for i in range(p * (p + 1)):
                a, b = divmod(i, p + 1)
                ints.append(np.sum(
                    R.qw * vhat[:, :, 0] * q[:, 0] ** a * q[:, 1] ** b,
                    axis=1))
            for i in range(p * (p + 1)):
                a, b = divmod(i, p)
                ints.append(np.sum(
                    R.qw * vhat[:, :, 1] * q[:, 0] ** a * q[:, 1] ** b,
                    axis=1))
            interior = (np.stack(ints, axis=1) if ints
                        else np.zeros((ve.shape[0], 0)))
            cols.append(np.concatenate(
                [mom.reshape(-1), interior.reshape(-1)]))
        return (np.stack(cols, axis=1) if fns
                else np.zeros((self.dof[1].ndofs, 0)))

    def set_upscaling_targets(self, order=0):
        from parelag_tpu_torch.amge.fespace2d import (
            _monomials2d, _vector_monomials2d)
        self.targets[0] = self.interpolate_scalar_targets(
            0, _monomials2d(order + 1))
        self.targets[1] = self.interpolate_vector_targets(
            1, _vector_monomials2d(order))
        self.targets[2] = self.interpolate_scalar_targets(
            2, _monomials2d(order))

    def _l2_dofs_of_one(self):
        return self.interpolate_scalar_targets(
            2, [lambda q: np.ones(q.shape[:-1])])[:, 0]

    # ---------------- PV traces ---------------- #
    def compute_pv_traces(self, codim) -> np.ndarray:
        jform = 2 - codim
        pv = np.zeros(self.dof[jform].ndofs)
        AE_e = self.topo.AEntity_entity[codim].tocsr()
        if codim == 0:            # L2: dofs of constant 1 per AE
            one = self._l2_dofs_of_one()
            coo = AE_e.tocoo()
            d = self.dof[2]
            ids = d.int_dofs()[coo.col]             # (nnz, nL2)
            pv[ids.reshape(-1)] = np.repeat(
                coo.data, d.n_int) * one[ids.reshape(-1)]
        elif codim == 1:          # Hdiv: unit-flux field -> m_0 = length
            coo = AE_e.tocoo()
            e0 = self.dof[1].edge_dofs()[coo.col, 0]
            pv[e0] = coo.data * self.edge_len[coo.col]
        else:                     # H1 vertex picks
            pv[AE_e.indices] = 1.0
        return pv
