"""Dof handlers: fine (FE) and coarse (algebraic) degree-of-freedom tables.

Rebuild of reference src/amge/DofHandler.{hpp,cpp}:

* DofHandlerFE — lowest-order spaces where dofs ARE entities:
    H1 dofs = vertices, ND0 = edges, RT0 = faces, L2 = elements; per codim the
    entity_dof lists are fixed-arity arrays aligned with the batched local
    matrices of parelag_tpu.amge.hexfe.

* DofHandlerALG — coarse levels (reference DofHandler.cpp:870-1413): coarse
  dofs are numbered codim-descending (trace entities first); every entity of a
  codim has interior dofs split into RangeTSpace (PV / derivative-image) and
  NullSpace types; entity_dof rows gather interior dofs of all boundary
  sub-entities (via topology connectivity) followed by own interior dofs.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch.ops import ragged as R

RANGET = 1
NULLSPACE = 2


class DofHandlerBase:
    def entity_dofs_cat(self, codim):
        """(cat, off) flat layout of entity_dofs; default built from lists
        (uniform-arity 2D tables take the zero-loop path)."""
        t = self.entity_dofs(codim)
        if isinstance(t, np.ndarray) and t.ndim == 2:
            n, k = t.shape
            return (t.reshape(-1).astype(np.int64, copy=False),
                    np.arange(n + 1, dtype=np.int64) * k)
        return R.lists_to_cat(t)

    def entity_dof_pattern(self, codim) -> sp.csr_matrix:
        """Pattern CSR (n_entities x ndofs) of the closure dofs."""
        cat, off = self.entity_dofs_cat(codim)
        n = off.size - 1
        if n == 0:
            return sp.csr_matrix((0, self.ndofs))
        A = sp.csr_matrix(
            (np.ones(cat.size), cat.astype(np.int32), off),
            shape=(n, self.ndofs))
        A.sum_duplicates()
        A.sort_indices()
        return A


class DofHandlerFE(DofHandlerBase):
    """Fine-level dof handler for one form on a hex/tet mesh."""

    def __init__(self, form, mesh, ents):
        self.form = form
        self.mesh = mesh
        self.ents = ents
        self.dim = mesh.dim
        self.max_codim = self.dim - form
        ne = mesh.num_elements
        if form == 0:
            self.ndofs = mesh.num_vertices
        elif form == self.dim:
            self.ndofs = ne                       # L2
        elif form == 1:
            self.ndofs = ents.num_edges           # ND (3D) / RT (2D)
        else:
            self.ndofs = ents.num_faces           # RT (3D)
        self._tables = {}

    def entity_dofs(self, codim):
        """List (or uniform 2D array rows) of dof ids per entity of codim.
        Order matches the local matrix layouts of hexfe/tetfe (3D) and the
        embedded surface kernels (2D)."""
        if codim in self._tables:
            return self._tables[codim]
        m, e, form = self.mesh, self.ents, self.form
        if self.dim == 2:
            t = self._entity_dofs_2d(codim)
        else:
            t = self._entity_dofs_3d(codim)
        # FE tables are uniform-arity: keep as one 2D array (rows indexable)
        self._tables[codim] = np.asarray(t)
        return self._tables[codim]

    def _entity_dofs_3d(self, codim):
        m, e, form = self.mesh, self.ents, self.form
        if codim == 0:
            if form == 0:
                return m.elements
            if form == 1:
                return e.elem_edge
            if form == 2:
                return e.elem_face
            return np.arange(m.num_elements)[:, None]
        if codim == 1:
            if form == 0:
                return np.asarray(e.face_verts)
            if form == 1:
                return e.face_edge
            if form == 2:
                return np.arange(e.num_faces)[:, None]
            raise ValueError("L2 has no facet dofs")
        if codim == 2:
            if form == 0:
                return e.edges
            if form == 1:
                return np.arange(e.num_edges)[:, None]
            raise ValueError
        if form == 0:
            return np.arange(m.num_vertices)[:, None]
        raise ValueError

    def _entity_dofs_2d(self, codim):
        m, e, form = self.mesh, self.ents, self.form
        if codim == 0:
            if form == 0:
                return m.elements
            if form == 1:
                return e.elem_edge
            return np.arange(m.num_elements)[:, None]
        if codim == 1:
            if form == 0:
                return e.edges
            if form == 1:
                return np.arange(e.num_edges)[:, None]
            raise ValueError("L2 has no facet dofs")
        if form == 0:
            return np.arange(m.num_vertices)[:, None]
        raise ValueError


class DofHandlerALG(DofHandlerBase):
    """Coarse-level dof handler built during DeRhamSequence.Coarsen."""

    def __init__(self, form, coarse_topo):
        self.form = form
        self.topo = coarse_topo
        self.dim = coarse_topo.dim
        self.max_codim = self.dim - form
        # per codim: per-entity interior dof counts by type
        self.n_ranget = {}
        self.n_null = {}
        # per codim: entity interior dof offsets (after finalize of codim)
        self.interior_offsets = {}
        self.entity_ndofs = {}     # cumulative dof count after codim built
        self.ndofs = 0
        self.dof_types = []        # per dof: RANGET | NULLSPACE
        self._entity_dof = {}      # codim -> list of np arrays (closure dofs)
        self._entity_dof_cat = {}  # codim -> (cat, off) flat layout
        self._bdr_tables = {}      # codim -> (cat, off) boundary-dof table
        self._finalized = set()
        self._extra_interior = {}  # (codim, ient) -> np array of dof ids
                                   # appended after finalize (enrichment)

    # ------------------------------------------------------------------ #
    def init_codim(self, codim):
        n = self.topo.num_entities(codim)
        self.n_ranget[codim] = np.zeros(n, dtype=np.int64)
        self.n_null[codim] = np.zeros(n, dtype=np.int64)

    def set_n_ranget(self, codim, ient, n):
        self.n_ranget[codim][ient] = n

    def set_n_null(self, codim, ient, n):
        self.n_null[codim][ient] = n

    def append_dof_types(self, types):
        self.dof_types.extend(types)

    # ------------------------------------------------------------------ #
    def finalize_codim(self, codim):
        """Assign interior dof numbers of this codim (computeOffset,
        reference DofHandler.cpp:1060-1176) and build the entity_dof rows."""
        assert codim not in self._finalized
        n = self.topo.num_entities(codim)
        counts = self.n_ranget[codim] + self.n_null[codim]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        offsets += self.ndofs
        self.interior_offsets[codim] = offsets
        self.ndofs = int(offsets[-1])
        self.entity_ndofs[codim] = self.ndofs

        # entity_dof rows: interior dofs of sub-entities (codim descending:
        # peaks, ridges, facets), then own interior dofs — vectorized over
        # all entities via ragged merges
        bdr_cat, bdr_off = self._bdr_table(codim)
        own_cat, own_off = R.ranges_cat(offsets[:-1], offsets[1:])
        cat, off = R.merge_ragged([(bdr_cat, bdr_off), (own_cat, own_off)])
        self._entity_dof_cat[codim] = (cat, off)
        self._entity_dof[codim] = None    # list view materialized lazily
        #                                   (np.split of ~10^6 rows costs
        #                                   seconds; most consumers use
        #                                   the flat cat layout)
        self._finalized.add(codim)

    def _bdr_table(self, codim):
        """(cat, off) of boundary dofs (interior dofs of all higher-codim
        sub-entities, codim descending) for ALL entities of `codim`."""
        hit = self._bdr_tables.get(codim)
        if hit is not None:
            return hit
        n = self.topo.num_entities(codim)
        parts = []
        for sub in range(self.max_codim, codim, -1):
            conn = self.topo.connectivity(codim, sub).tocsr()
            o = self.interior_offsets[sub]
            sub_cat = conn.indices.astype(np.int64)
            sub_off = conn.indptr.astype(np.int64)
            cat, off = R.two_level_ranges(sub_cat, sub_off, o[:-1], o[1:])
            parts.append((cat, off))
        if parts:
            out = R.merge_ragged(parts)
        else:
            out = (np.zeros(0, dtype=np.int64),
                   np.zeros(n + 1, dtype=np.int64))
        self._bdr_tables[codim] = out
        return out

    # ------------------------------------------------------------------ #
    def append_interior_dofs(self, codim, ient, k) -> np.ndarray:
        """Append k NEW interior (NullSpace-like) dofs to an entity AFTER
        finalize, numbered at the end of the global dof range (coarse-space
        enrichment, e.g. the curl-range repair at pinched topology). Returns
        the new dof ids."""
        new = np.arange(self.ndofs, self.ndofs + k, dtype=np.int64)
        self.ndofs += k
        key = (codim, ient)
        prev = self._extra_interior.get(key, np.zeros(0, dtype=np.int64))
        self._extra_interior[key] = np.concatenate([prev, new])
        rows = self.entity_dofs(codim)    # materialize the list view
        rows[ient] = np.concatenate([rows[ient], new])
        self._entity_dof_cat.pop(codim, None)   # rows mutated -> rebuild
        self.dof_types.extend(["NULLSPACE"] * k)
        return new

    def _extras(self, codim, ient):
        return self._extra_interior.get(
            (codim, ient), np.zeros(0, dtype=np.int64))

    def entity_dofs(self, codim):
        if self._entity_dof[codim] is None:
            cat, off = self._entity_dof_cat[codim]
            self._entity_dof[codim] = np.split(cat, off[1:-1])
        return self._entity_dof[codim]

    def entity_dofs_cat(self, codim):
        hit = self._entity_dof_cat.get(codim)
        if hit is None:
            hit = R.lists_to_cat(self._entity_dof[codim])
            self._entity_dof_cat[codim] = hit
        return hit

    def interior_dofs(self, codim, ient) -> np.ndarray:
        o = self.interior_offsets[codim]
        return np.concatenate([np.arange(o[ient], o[ient + 1]),
                               self._extras(codim, ient)])

    def ranget_dofs(self, codim, ient) -> np.ndarray:
        """RangeT-type interior dofs of the entity (first within interior)."""
        o = self.interior_offsets[codim]
        return np.arange(o[ient], o[ient] + self.n_ranget[codim][ient])

    def ranget_dofs_cat(self, codim):
        """(cat, off) of ranget_dofs for all entities of the codim."""
        o = self.interior_offsets[codim]
        return R.ranges_cat(o[:-1], o[:-1] + self.n_ranget[codim])

    def null_dofs_cat(self, codim):
        """(cat, off) of null_dofs (incl. enrichment extras) for all
        entities of the codim."""
        o = self.interior_offsets[codim]
        cat, off = R.ranges_cat(o[:-1] + self.n_ranget[codim], o[1:])
        if any(c == codim for c, _ in self._extra_interior):
            n = o.size - 1
            ex = [self._extras(codim, i) for i in range(n)]
            cat, off = R.merge_ragged([(cat, off), R.lists_to_cat(ex)])
        return cat, off

    def null_dofs(self, codim, ient) -> np.ndarray:
        o = self.interior_offsets[codim]
        return np.concatenate([
            np.arange(o[ient] + self.n_ranget[codim][ient], o[ient + 1]),
            self._extras(codim, ient)])

    def dofs_on_bdr(self, codim, ient) -> np.ndarray:
        """Interior dofs of all higher-codim sub-entities on the closure
        (reference DofHandlerALG::GetDofsOnBdr, DofHandler.cpp:1013-1049).
        Served from the vectorized per-codim table."""
        cat, off = self._bdr_table(codim)
        return cat[off[ient]:off[ient + 1]]

    def dofs_on_bdr_cat(self, codim):
        """(cat, off) boundary-dof table for all entities of the codim."""
        return self._bdr_table(codim)

    def n_interior(self, codim, ient=None):
        if ient is None:
            extra = sum(v.size for (c, _), v in
                        self._extra_interior.items() if c == codim)
            return int((self.n_ranget[codim]
                        + self.n_null[codim]).sum()) + extra
        return int(self.n_ranget[codim][ient] + self.n_null[codim][ient]
                   + self._extras(codim, ient).size)
