"""Structured AMGe setup for cartesian-nested hex grids (PyTorch).

Counterpart of parelag_tpu/amge/structured.py: on a cartesian 2x2x2
agglomeration of a hex grid with order-0 upscaling targets every
agglomerated entity of a family has the same local structure, so every
stage of Coarsen() is one uniform batched dense operation over all
entities of the family.  The chain runs from L2 down to jform_start
(H1 coarsening consumes the Hdiv and Hcurl outputs); coarsen_darcy is
the Hdiv-L2 pair alone (jform_start=2).

Differences from the JAX module:
  * stages run on the device of the level's tensors (the card, or the
    CPU in the tests) with direct batched solves (torch.linalg.solve);
    the Newton-Schulz f32 mode, which existed for the TPU's batched-LU
    compile times, is not ported;
  * one plain chunk loop over entities (_run_stage, chunk size _CHUNK)
    replaces the jitted whole-level program and the three chunk dispatch
    modes; chunk=0 runs each stage over the whole level in one piece;
  * the static-structure guards raise RuntimeError instead of assert
    (coarsen_darcy's too; its DarcyLevelOut has no Newton-Schulz
    residual);
  * coarsening, P materialization and the stiffness blocks run in full
    f32/f64 (TF32 off), as the JAX module traces under matmul precision
    "float32".

The numpy grid and id helpers below are verbatim copies of the JAX
module's host plane (that module imports jax at its top, so it cannot
be imported here).  Conventions, from the JAX module:
  * H1 dofs = vertex values; Hcurl = edge circulations (tangent +axis);
    Hdiv = face fluxes (normal +axis); L2 = cell values.
  * grad rows: [-1 at tail, +1 at head].  curl rows: ccw circulation
    seen from the +a normal, stored in the canonical per-face edge
    order [eb(c0), eb(c1), ec(b0), ec(b1)] (signs D1_FAMILY_SIGNS).
    div rows: (+out - in)/cell_volume.
  * entity numbering is lexicographic (x fastest) per family; face and
    edge families are ordered [x; y; z].
"""

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops.device_sparse import as_torch_dtype

# --------------------------------------------------------------------- #
# host index plane: entity numbering and per-level id arrays
# --------------------------------------------------------------------- #

def _lex(i, j, k, ni, nj):
    return i + ni * (j + nj * k)


def grid_counts(shape):
    """Entity counts for a (nx, ny, nz) cell grid: cells, faces (x,y,z
    families), edges (x,y,z families), vertices."""
    nx, ny, nz = shape
    nc = nx * ny * nz
    nf = ((nx + 1) * ny * nz, nx * (ny + 1) * nz, nx * ny * (nz + 1))
    ne = (nx * (ny + 1) * (nz + 1), (nx + 1) * ny * (nz + 1),
          (nx + 1) * (ny + 1) * nz)
    nv = (nx + 1) * (ny + 1) * (nz + 1)
    return nc, nf, ne, nv


def face_id(shape, axis, i, j, k):
    """Face id within the global face numbering ([x|y|z] families).
    (i, j, k) are the face's own lattice coordinates: for axis=0 the
    x-coordinate i ranges 0..nx while j, k range over cells."""
    nx, ny, nz = shape
    dims = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    off = 0
    for a in range(axis):
        off += dims[a][0] * dims[a][1] * dims[a][2]
    ni, nj, _ = dims[axis]
    return off + _lex(i, j, k, ni, nj)


def edge_id(shape, axis, i, j, k):
    """Edge id ([x|y|z] families); for axis=0 the x-coordinate i ranges
    over cells 0..nx-1 while j, k range over vertices."""
    nx, ny, nz = shape
    dims = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
            (nx + 1, ny + 1, nz))
    off = 0
    for a in range(axis):
        off += dims[a][0] * dims[a][1] * dims[a][2]
    ni, nj, _ = dims[axis]
    return off + _lex(i, j, k, ni, nj)


def vert_id(shape, i, j, k):
    nx, ny, nz = shape
    return _lex(i, j, k, nx + 1, ny + 1)


def cell_id(shape, i, j, k):
    nx, ny, nz = shape
    return _lex(i, j, k, nx, ny)


def _grid3(*ranges):
    """meshgrid of index ranges -> flat (n, len(ranges)) int array,
    x fastest (lexicographic)."""
    gs = np.meshgrid(*ranges, indexing="ij")
    return np.stack([g.transpose(2, 1, 0).ravel() for g in gs], axis=1)


# --------------------------------------------------------------------- #
# fine level: analytic local matrices on a uniform brick grid
# --------------------------------------------------------------------- #

def _m1(h):
    """1D P1 mass on an interval of length h."""
    return (h / 6.0) * np.array([[2.0, 1.0], [1.0, 2.0]])


def fine_local_masses(h, dtype=np.float64):
    """Reference local mass matrices per (codim, jform) slot for a
    uniform brick cell of size h=(hx,hy,hz).  Local dof orderings:

      M00 (8x8):  cell vertices, lexicographic (x fastest)
      M10 (4x4):  face vertices, lexicographic in the face plane (per
                  axis family: the two in-plane axes in (b, c) order
                  where (b, c) = axes != a, b < c)
      M20 (2x2):  edge endpoints (tail, head)
      M30 (1x1):  vertex
      M01 (12x12): cell edges [4 x-edges (lex in (y,z)); 4 y; 4 z]
      M11 (4x4):  face edges [2 along b (lex in c); 2 along c (lex in b)]
      M21 (1x1):  edge
      M02 (6x6):  cell faces [x(i),x(i+1); y; z]
      M12 (1x1):  face
      M03 (1x1):  cell (value dofs: mass = cell volume)

    Returns dict keyed (codim, jform); face/edge-family-dependent slots
    map to a tuple of 3 per-axis matrices.
    """
    hx, hy, hz = (float(v) for v in h)
    m = {0: _m1(hx), 1: _m1(hy), 2: _m1(hz)}
    vol = hx * hy * hz

    def kron(*ms):
        out = ms[0]
        for mm in ms[1:]:
            out = np.kron(mm, out)   # x fastest => later axes outermost
        return out

    out = {}
    out[(0, 0)] = kron(m[0], m[1], m[2])
    out[(1, 0)] = tuple(
        kron(m[b], m[c])
        for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))))
    out[(2, 0)] = (m[0], m[1], m[2])
    out[(3, 0)] = np.array([[1.0]])

    # ND0: same-axis block for axis a = (m_b x m_c) / h_a (circulation
    # dofs; dual basis carries 1/h_a), cross-axis zero.
    hh = (hx, hy, hz)
    nd_blocks = []
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        nd_blocks.append(kron(m[b], m[c]) / hh[a])
    M01 = np.zeros((12, 12))
    for a in range(3):
        M01[4 * a:4 * a + 4, 4 * a:4 * a + 4] = nd_blocks[a]
    out[(0, 1)] = M01
    # face (normal axis a, in-plane (b, c)): edges [2 along b; 2 along c]
    m11 = []
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        blk = np.zeros((4, 4))
        blk[:2, :2] = m[c] / hh[b]
        blk[2:, 2:] = m[b] / hh[c]
        m11.append(blk)
    out[(1, 1)] = tuple(m11)
    out[(2, 1)] = tuple(np.array([[1.0 / hh[a]]]) for a in range(3))

    # RT0: axis-a pair block m_a / (h_b h_c) (flux dofs).
    M02 = np.zeros((6, 6))
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        M02[2 * a:2 * a + 2, 2 * a:2 * a + 2] = m[a] / (hh[b] * hh[c])
    out[(0, 2)] = M02
    out[(1, 2)] = tuple(np.array([[1.0 / (hh[b] * hh[c])]])
                        for a, (b, c) in
                        enumerate(((1, 2), (0, 2), (0, 1))))
    out[(0, 3)] = np.array([[vol]])

    return {k: (tuple(x.astype(dtype) for x in v)
                if isinstance(v, tuple) else v.astype(dtype))
            for k, v in out.items()}


def fine_derivative_values(shape, h, dtype=np.float64):
    """Per-row value arrays of the fine D operators in the fixed column
    patterns of this module:

      D0: (n_edges, 2)  cols [tail, head] vertices       -> [-1, +1]
      D1: (n_faces, 4)  cols [eb(c0), eb(c1), ec(b0), ec(b1)]
                                      -> per-family D1_FAMILY_SIGNS
      D2: (n_cells, 6)  cols [fx0,fx1,fy0,fy1,fz0,fz1]   -> (+-1)/vol

    Values are returned (patterns are implicit in the column functions
    below); at coarse levels the same patterns carry computed values.
    """
    nc, nf, ne, nv = grid_counts(shape)
    vol = float(np.prod(h))
    d0 = np.tile(np.array([-1.0, 1.0], dtype=dtype), (sum(ne), 1))
    d1 = np.concatenate([
        np.tile(D1_FAMILY_SIGNS[a].astype(dtype), (nf[a], 1))
        for a in range(3)], axis=0)
    d2 = np.tile(
        np.array([-1.0, 1.0, -1.0, 1.0, -1.0, 1.0], dtype=dtype) / vol,
        (nc, 1))
    return d0, d1, d2


def d0_cols(shape):
    """(n_edges, 2) vertex column ids matching fine_derivative_values."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        # _grid3 columns are already (x, y, z) lattice coordinates
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        head = ijk.copy()
        head[:, a] += 1
        tail = vert_id(shape, ijk[:, 0], ijk[:, 1], ijk[:, 2])
        headv = vert_id(shape, head[:, 0], head[:, 1], head[:, 2])
        cols.append(np.stack([tail, headv], axis=1))
    return np.concatenate(cols, axis=0)


def d1_cols(shape):
    """(n_faces, 4) edge column ids of the curl rows, in the CANONICAL
    per-face edge order [eb at c0, eb at c1, ec at b0, ec at b1] with
    (b, c) the in-plane axes, b < c — the same order as the M11 blocks
    (face_edges_m), so that coarse-level curl values emitted by the
    facet extension stage land in the same pattern.  The ccw-circulation
    signs in this order are D1_FAMILY_SIGNS[a] (the (b, c) = (x, z)
    pair of the y-family is anti-cyclic, flipping its signs)."""
    return face_edges_m(shape)


# ccw circulation signs (Stokes, right-hand rule around the +a normal)
# expressed in the canonical [eb(c0), eb(c1), ec(b0), ec(b1)] order:
D1_FAMILY_SIGNS = np.array([
    [1.0, -1.0, -1.0, 1.0],     # +x: (b,c)=(y,z) cyclic
    [-1.0, 1.0, 1.0, -1.0],     # +y: (b,c)=(x,z) anti-cyclic
    [1.0, -1.0, -1.0, 1.0],     # +z: (b,c)=(x,y) cyclic
])


def d2_cols(shape):
    """(n_cells, 6) face column ids [fx(i),fx(i+1),fy(j),fy(j+1),
    fz(k),fz(k+1)]."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    return np.stack([
        face_id(shape, 0, i, j, k), face_id(shape, 0, i + 1, j, k),
        face_id(shape, 1, i, j, k), face_id(shape, 1, i, j + 1, k),
        face_id(shape, 2, i, j, k), face_id(shape, 2, i, j, k + 1),
    ], axis=1)


# --------------------------------------------------------------------- #
# entity-dof maps (host, int arithmetic; also the device gather plans)
# --------------------------------------------------------------------- #

def cell_verts(shape):
    """(n_cells, 8) vertex ids, lexicographic (x fastest) within the
    cell — matches the M00 kron ordering."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out.append(vert_id(shape, i + dx, j + dy, k + dz))
    return np.stack(out, axis=1)


def cell_edges(shape):
    """(n_cells, 12) edge ids [4 x-edges (y fastest); 4 y-edges
    (x fastest); 4 z-edges (x fastest)] — matches the M01 ordering."""
    nx, ny, nz = shape
    ijk = _grid3(range(nx), range(ny), range(nz))
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        base = np.stack([i, j, k], axis=1)
        for dc in (0, 1):
            for db in (0, 1):
                co = base.copy()
                co[:, b] += db
                co[:, c] += dc
                cols.append(edge_id(shape, a, co[:, 0], co[:, 1],
                                    co[:, 2]))
    return np.stack(cols, axis=1)


def cell_faces(shape):
    """(n_cells, 6) — identical to d2_cols (matches the M02 ordering)."""
    return d2_cols(shape)


def face_verts(shape):
    """(n_faces, 4) vertex ids per face, (b, c)-lex (b fastest) —
    matches the M10 kron ordering."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for dc in (0, 1):
            for db in (0, 1):
                co = ijk.copy()
                co[:, b] += db
                co[:, c] += dc
                out.append(vert_id(shape, co[:, 0], co[:, 1], co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def face_edges_m(shape):
    """(n_faces, 4) edge ids [eb at c0, eb at c1, ec at b0, ec at b1] —
    matches the M11 block ordering (NOT the ccw d1 ordering)."""
    nx, ny, nz = shape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))

        def ecol(axis, db, dc):
            co = ijk.copy()
            co[:, b] += db
            co[:, c] += dc
            return edge_id(shape, axis, co[:, 0], co[:, 1], co[:, 2])

        cols.append(np.stack([ecol(b, 0, 0), ecol(b, 0, 1),
                              ecol(c, 0, 0), ecol(c, 1, 0)], axis=1))
    return np.concatenate(cols, axis=0)


def edge_verts(shape):
    """(n_edges, 2) — identical to d0_cols."""
    return d0_cols(shape)


def assemble_global(blocks, dofmap, ndofs):
    """Host CSR from per-entity local blocks.  blocks: (n, k, k) or a
    single (k, k) broadcast; dofmap: (n, k)."""
    import scipy.sparse as sp
    dofmap = np.asarray(dofmap)
    n, k = dofmap.shape
    blocks = np.broadcast_to(np.asarray(blocks), (n, k, k))
    rows = np.repeat(dofmap, k, axis=1).ravel()
    cols = np.tile(dofmap, (1, k)).ravel()
    return sp.coo_matrix(
        (blocks.ravel(), (rows, cols)), shape=(ndofs, ndofs)).tocsr()


def assemble_d_csr(dvals, dcols, shape_mat):
    """Host CSR of a derivative operator from its per-row value array
    and static column pattern."""
    import scipy.sparse as sp
    dvals = np.asarray(dvals)
    n, k = dvals.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return sp.coo_matrix(
        (dvals.ravel(), (rows, np.asarray(dcols).ravel())),
        shape=shape_mat).tocsr()


def fine_global_masses(shape, h, dtype=np.float64, coeff=None):
    """Host global mass CSRs per form (for parity tests and operator
    assembly); coeff: optional per-cell scalar weighting of the codim-0
    masses (SPE10-class heterogeneity)."""
    ref = fine_local_masses(h, dtype)
    nc, nf, ne, nv = grid_counts(shape)

    def wblk(M):
        if coeff is None:
            return M
        return np.asarray(coeff, dtype)[:, None, None] * M

    return {
        0: assemble_global(wblk(ref[(0, 0)]), cell_verts(shape), nv),
        1: assemble_global(wblk(ref[(0, 1)]), cell_edges(shape),
                           sum(ne)),
        2: assemble_global(wblk(ref[(0, 2)]), cell_faces(shape),
                           sum(nf)),
        3: assemble_global(wblk(ref[(0, 3)]),
                           np.arange(nc, dtype=np.int64)[:, None], nc),
    }


# --------------------------------------------------------------------- #
# coarse->fine child id arrays (factor-2 nesting)
# --------------------------------------------------------------------- #

def children_cells(cshape):
    """(n_coarse_cells, 8) fine cell ids, subgrid-lex (dx fastest)."""
    fshape = tuple(2 * s for s in cshape)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out.append(cell_id(fshape, 2 * ijk[:, 0] + dx,
                                   2 * ijk[:, 1] + dy, 2 * ijk[:, 2] + dz))
    return np.stack(out, axis=1)


def children_faces(cshape):
    """(n_coarse_faces, 4) fine face ids per coarse face, in-plane
    (b, c)-lex (b fastest) — the canonical facet-children order."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for dc in (0, 1):
            for db in (0, 1):
                co = 2 * ijk
                co[:, a] = 2 * ijk[:, a]          # vertex-line coord
                co[:, b] += db
                co[:, c] += dc
                out.append(face_id(fshape, a, co[:, 0], co[:, 1],
                                   co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def children_edges(cshape):
    """(n_coarse_edges, 2) fine edge ids per coarse edge, lex along the
    edge axis."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        out = []
        for da in (0, 1):
            co = 2 * ijk
            co[:, a] += da
            out.append(edge_id(fshape, a, co[:, 0], co[:, 1], co[:, 2]))
        cols.append(np.stack(out, axis=1))
    return np.concatenate(cols, axis=0)


def children_verts(cshape):
    """(n_coarse_verts,) fine vertex ids of the coarse lattice points."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    ijk = _grid3(range(nx + 1), range(ny + 1), range(nz + 1))
    return vert_id(fshape, 2 * ijk[:, 0], 2 * ijk[:, 1], 2 * ijk[:, 2])


# --------------------------------------------------------------------- #
# static 2x2x2-subgrid patterns (level-independent)
# --------------------------------------------------------------------- #

_S = (2, 2, 2)


def _subgrid_face_slots():
    """Canonical order of the 36 subgrid faces: [12 interior (family a
    at mid-plane, (b,c)-lex); 24 boundary grouped by coarse facet in
    [x0,x1,y0,y1,z0,z1] order, each facet's 4 children (b,c)-lex].
    Returns slot_of_face (36,): subgrid face id -> slot."""
    nc, nf, ne, nv = grid_counts(_S)
    order = []
    for a in range(3):                      # interior: axis coord == 1
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[a], co[b], co[c] = 1, db, dc
                order.append(face_id(_S, a, *co))
    for a in range(3):                      # boundary facets a0, a1
        b, c = [ax for ax in range(3) if ax != a]
        for side in (0, 2):
            for dc in (0, 1):
                for db in (0, 1):
                    co = [0, 0, 0]
                    co[a], co[b], co[c] = side, db, dc
                    order.append(face_id(_S, a, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == sum(nf) == 36
    slot = np.zeros(sum(nf), dtype=np.int64)
    slot[order] = np.arange(36)
    return slot


def _subgrid_u_faces(cshape):
    """(n_coarse_cells, 36) fine face ids of each coarse cell's subgrid
    faces, in the canonical 36-slot order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_face_slots()
    # subgrid face id -> (family, local lattice coords)
    inv = np.empty((36, 4), dtype=np.int64)
    for a in range(3):
        dims = [(3, 2, 2), (2, 3, 2), (2, 2, 3)][a]
        for x in range(dims[0]):
            for y in range(dims[1]):
                for z in range(dims[2]):
                    inv[face_id(_S, a, x, y, z)] = (a, x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 36), dtype=np.int64)
    for sf in range(36):
        a, x, y, z = inv[sf]
        out[:, slot[sf]] = face_id(
            fshape, a, 2 * ijk[:, 0] + x, 2 * ijk[:, 1] + y,
            2 * ijk[:, 2] + z)
    return out


def _cell_stage_patterns_hdiv():
    """Static patterns of the Hdiv interior (Lagrange) extension:
      fslot:  (8, 6)  child-cell face -> 36-slot (M02 local order)
    The 36-slot order puts the 12 interior faces first and the boundary
    faces facet-by-facet, so Pb rows are [4*f + i] for facet f child i."""
    slot = _subgrid_face_slots()
    return slot[cell_faces(_S)]


# --------------------------------------------------------------------- #
# Hcurl stage patterns
# --------------------------------------------------------------------- #

def _subgrid_edge_slots():
    """Canonical order of the 54 subgrid edges of a 2x2x2 cell-AE:
    [6 interior (axis a through the center, a-coord lex, a = x,y,z);
     24 coarse-edge children grouped by coarse edge in the coarse
     cell_edges order, each edge's 2 children lex along the axis;
     24 facet-interior edges grouped by facet in [x0,x1,y0,y1,z0,z1]
     order, each facet's 4 interior edges in the face-subgrid interior
     order (2 along b at c-line 1, b-lex; 2 along c at b-line 1)].
    Returns slot_of_edge (54,)."""
    order = []
    for a in range(3):                      # interior: through center
        for da in (0, 1):
            co = [1, 1, 1]
            co[a] = da
            order.append(edge_id(_S, a, *co))
    # coarse-edge children: coarse edges of the unit cell in cell_edges
    # order = [x-edges (dy,dz) y-lex; y; z] with endpoints scaled by 2
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                for da in (0, 1):
                    co = [0, 0, 0]
                    co[a], co[b], co[c] = da, 2 * db, 2 * dc
                    order.append(edge_id(_S, a, *co))
    # facet interiors: facet (axis fa, side s) at a-coord 2*s; in-plane
    # (b, c): edges along b at c-line 1 (db lex), then along c at b 1
    for fa in range(3):
        b, c = [ax for ax in range(3) if ax != fa]
        for s in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[fa], co[b], co[c] = 2 * s, db, 1
                order.append(edge_id(_S, b, *co))
            for dc in (0, 1):
                co = [0, 0, 0]
                co[fa], co[b], co[c] = 2 * s, 1, dc
                order.append(edge_id(_S, c, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == 54, order
    slot = np.zeros(54, dtype=np.int64)
    slot[order] = np.arange(54)
    return slot


def _subgrid_u_edges(cshape):
    """(n_coarse_cells, 54) fine edge ids in the canonical 54-slot
    order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_edge_slots()
    inv = np.empty((54, 4), dtype=np.int64)
    for a in range(3):
        dims = [(2, 3, 3), (3, 2, 3), (3, 3, 2)][a]
        for x in range(dims[0]):
            for y in range(dims[1]):
                for z in range(dims[2]):
                    inv[edge_id(_S, a, x, y, z)] = (a, x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 54), dtype=np.int64)
    for se in range(54):
        a, x, y, z = inv[se]
        out[:, slot[se]] = edge_id(
            fshape, a, 2 * ijk[:, 0] + x, 2 * ijk[:, 1] + y,
            2 * ijk[:, 2] + z)
    return out


def _face_subgrid_edge_order():
    """For each face family a: the 12 fine edges of a coarse face's 2x2
    subgrid in the canonical face order [4 interior (2 along b at
    c-line 1, b-lex; 2 along c at b-line 1); 8 boundary grouped by
    coarse edge in M11 order (eb(c0), eb(c1), ec(b0), ec(b1)), children
    lex].  Returns, per family, a list of 12 (axis, dx, dy, dz) OFFSETS
    from the (2*fa, 2*fb, 2*fc) face origin."""
    fams = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        offs = []

        def eo(axis, ob, oc):
            o = [0, 0, 0]
            o[b], o[c] = ob, oc
            return (axis, o[0], o[1], o[2])

        for db in (0, 1):
            offs.append(eo(b, db, 1))          # interior along b
        for dc in (0, 1):
            offs.append(eo(c, 1, dc))          # interior along c
        for db in (0, 1):
            offs.append(eo(b, db, 0))          # eb(c0) children
        for db in (0, 1):
            offs.append(eo(b, db, 2))          # eb(c1) children
        for dc in (0, 1):
            offs.append(eo(c, 0, dc))          # ec(b0) children
        for dc in (0, 1):
            offs.append(eo(c, 2, dc))          # ec(b1) children
        fams.append(offs)
    return fams


def _face_u_edges(cshape):
    """(n_coarse_faces, 12) fine edge ids of each coarse face's subgrid
    in the canonical face order (all three families concatenated)."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    fams = _face_subgrid_edge_order()
    cols = []
    for a in range(3):
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        out = np.empty((len(ijk), 12), dtype=np.int64)
        for s, (axis, ox, oy, oz) in enumerate(fams[a]):
            out[:, s] = edge_id(fshape, axis, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
        cols.append(out)
    return np.concatenate(cols, axis=0)


def _face_child_edge_slots():
    """(4, 4) per face family: child face (db, dc) local M11 edges ->
    face-subgrid slots.  The local M11 order and the face order above
    are family-independent in (b, c) terms, so one table serves all
    three families."""
    # face subgrid edge keyed by (along_b?, b-coord, c-line) for b-edges
    # and (along_b?, b-line, c-coord) for c-edges, mirroring the order
    # in _face_subgrid_edge_order
    key2slot = {}
    slotlist = [("b", db, 1) for db in (0, 1)] + \
               [("c", 1, dc) for dc in (0, 1)] + \
               [("b", db, 0) for db in (0, 1)] + \
               [("b", db, 2) for db in (0, 1)] + \
               [("c", 0, dc) for dc in (0, 1)] + \
               [("c", 2, dc) for dc in (0, 1)]
    for s, k in enumerate(slotlist):
        key2slot[k] = s
    out = np.empty((4, 4), dtype=np.int64)
    for dc in (0, 1):
        for db in (0, 1):
            ch = dc * 2 + db          # children order: b fastest
            # child's M11 edge order: eb(c0), eb(c1), ec(b0), ec(b1)
            out[ch] = [key2slot[("b", db, dc)],
                       key2slot[("b", db, dc + 1)],
                       key2slot[("c", db, dc)],
                       key2slot[("c", db + 1, dc)]]
    return out


def _cell_child_edge_slots():
    """(8, 12) child cell -> 54-slot positions of its cell_edges-order
    local edges."""
    slot = _subgrid_edge_slots()
    return slot[cell_edges(_S)]


def _cell_facet_edge_positions():
    """(6, 4) positions of each facet's 4 coarse edges (M11 order)
    within the coarse cell's 12-edge list (cell_edges order)."""
    ce = cell_edges((1, 1, 1))[0]                 # 12 ids
    pos = {int(e): i for i, e in enumerate(ce)}
    fe = face_edges_m((1, 1, 1))                  # (6, 4) in family order
    # reorder rows into the facet order [x0,x1,y0,y1,z0,z1]: family
    # order of face ids on (1,1,1) is [x0,x1,y0,y1,z0,z1] already
    return np.vectorize(pos.get)(fe)


# --------------------------------------------------------------------- #
# H1 stage patterns
# --------------------------------------------------------------------- #

def _subgrid_vert_slots():
    """Canonical order of the 27 subgrid vertices of a cell-AE:
    [1 interior (center); 8 corners (cell_verts order, coords x2);
     12 coarse-edge midpoints (cell_edges coarse order);
     6 facet centers ([x0,x1,y0,y1,z0,z1])].
    Returns slot_of_vert (27,)."""
    order = [vert_id(_S, 1, 1, 1)]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                order.append(vert_id(_S, 2 * dx, 2 * dy, 2 * dz))
    for a in range(3):                      # edge midpoints
        b, c = [ax for ax in range(3) if ax != a]
        for dc in (0, 1):
            for db in (0, 1):
                co = [0, 0, 0]
                co[a], co[b], co[c] = 1, 2 * db, 2 * dc
                order.append(vert_id(_S, *co))
    for a in range(3):                      # facet centers
        for s in (0, 2):
            co = [1, 1, 1]
            co[a] = s
            order.append(vert_id(_S, *co))
    order = np.array(order)
    assert len(set(order.tolist())) == 27
    slot = np.zeros(27, dtype=np.int64)
    slot[order] = np.arange(27)
    return slot


def _subgrid_u_verts(cshape):
    """(n_coarse_cells, 27) fine vertex ids in the canonical order."""
    fshape = tuple(2 * s for s in cshape)
    slot = _subgrid_vert_slots()
    inv = np.empty((27, 3), dtype=np.int64)
    for x in range(3):
        for y in range(3):
            for z in range(3):
                inv[vert_id(_S, x, y, z)] = (x, y, z)
    ijk = _grid3(range(cshape[0]), range(cshape[1]), range(cshape[2]))
    out = np.empty((len(ijk), 27), dtype=np.int64)
    for sv in range(27):
        x, y, z = inv[sv]
        out[:, slot[sv]] = vert_id(fshape, 2 * ijk[:, 0] + x,
                                   2 * ijk[:, 1] + y, 2 * ijk[:, 2] + z)
    return out


def _face_u_verts(cshape):
    """(n_coarse_faces, 9) fine vertex ids of a coarse face's subgrid:
    [center; 4 corners (M10 (b,c)-lex); 4 coarse-edge midpoints (M11
    order)]."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        b, c = [ax for ax in range(3) if ax != a]
        dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        offs = []
        o = [0, 0, 0]
        o[b], o[c] = 1, 1
        offs.append(tuple(o))                       # center
        for dc in (0, 1):
            for db in (0, 1):                       # corners
                o = [0, 0, 0]
                o[b], o[c] = 2 * db, 2 * dc
                offs.append(tuple(o))
        for (ob, oc) in ((1, 0), (1, 2), (0, 1), (2, 1)):  # mids, M11
            o = [0, 0, 0]
            o[b], o[c] = ob, oc
            offs.append(tuple(o))
        out = np.empty((len(ijk), 9), dtype=np.int64)
        for s, (ox, oy, oz) in enumerate(offs):
            out[:, s] = vert_id(fshape, base[:, 0] + ox,
                                base[:, 1] + oy, base[:, 2] + oz)
        cols.append(out)
    return np.concatenate(cols, axis=0)


def _edge_u_verts(cshape):
    """(n_coarse_edges, 3) fine vertex ids [mid, tail, head]."""
    fshape = tuple(2 * s for s in cshape)
    nx, ny, nz = cshape
    cols = []
    for a in range(3):
        dims = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz)][a]
        ijk = _grid3(range(dims[0]), range(dims[1]), range(dims[2]))
        base = 2 * ijk
        mid = base.copy()
        mid[:, a] += 1
        head = base.copy()
        head[:, a] += 2
        cols.append(np.stack([
            vert_id(fshape, mid[:, 0], mid[:, 1], mid[:, 2]),
            vert_id(fshape, base[:, 0], base[:, 1], base[:, 2]),
            vert_id(fshape, head[:, 0], head[:, 1], head[:, 2]),
        ], axis=1))
    return np.concatenate(cols, axis=0)


def _cell_child_vert_slots():
    """(8, 8) child cell -> 27-slot positions of its cell_verts."""
    return _subgrid_vert_slots()[cell_verts(_S)]


def _face_child_vert_slots():
    """(4, 4) child face -> 9-slot positions of its M10-order verts
    (family-independent in (b, c) terms)."""
    # 9-slot keyed by (b-coord, c-coord) in {0,1,2}^2
    key2slot = {(1, 1): 0, (0, 0): 1, (2, 0): 2, (0, 2): 3, (2, 2): 4,
                (1, 0): 5, (1, 2): 6, (0, 1): 7, (2, 1): 8}
    out = np.empty((4, 4), dtype=np.int64)
    for dc in (0, 1):
        for db in (0, 1):
            ch = dc * 2 + db
            out[ch] = [key2slot[(db + eb, dc + ec)]
                       for ec in (0, 1) for eb in (0, 1)]
    return out


def _cell_edge_vert_slots():
    """(54, 2) subgrid edge (slot order) -> 27-slot [tail, head]."""
    slot_e = _subgrid_edge_slots()
    slot_v = _subgrid_vert_slots()
    ev = edge_verts(_S)                    # (54, 2) subgrid vert ids
    out = np.empty((54, 2), dtype=np.int64)
    out[slot_e] = slot_v[ev]
    return out


def _face_edge_vert_slots():
    """(12, 2) face-subgrid edge (face order) -> 9-slot [tail, head]
    (family-independent)."""
    key2slot = {(1, 1): 0, (0, 0): 1, (2, 0): 2, (0, 2): 3, (2, 2): 4,
                (1, 0): 5, (1, 2): 6, (0, 1): 7, (2, 1): 8}
    fams = _face_subgrid_edge_order()
    # interpret offsets in (b, c) terms using family 0 ((b,c)=(1,2))
    out = np.empty((12, 2), dtype=np.int64)
    for s, (axis, ox, oy, oz) in enumerate(fams[0]):
        ob, oc = oy, oz
        if axis == 1:      # along b
            out[s] = [key2slot[(ob, oc)], key2slot[(ob + 1, oc)]]
        else:              # along c
            out[s] = [key2slot[(ob, oc)], key2slot[(ob, oc + 1)]]
    return out


# facet -> corner-vertex positions among the cell's 8 (cell_verts order)
def _cell_facet_vert_positions():
    cv = cell_verts((1, 1, 1))[0]
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.vectorize(pos.get)(face_verts((1, 1, 1)))


# coarse edge -> endpoint positions among the cell's 8
def _cell_edge_vert_positions():
    cv = cell_verts((1, 1, 1))[0]
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.vectorize(pos.get)(edge_verts((1, 1, 1)))


# face coarse edge (M11 order) -> endpoint positions among the face's
# 4 corners (M10 order): eb(c0): (0,1); eb(c1): (2,3); ec(b0): (0,2);
# ec(b1): (1,3)
_FACE_EDGE_VERT_POS = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])

# --------------------------------------------------------------------- #
# torch helpers
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def full_precision():
    """Full-precision f32 products on the card (TF32 off for matmul and
    cuDNN), restored on exit — the setup's static-structure guards trip
    under reduced-precision products, as they did on the TPU before the
    JAX module forced matmul precision "float32"."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _ix(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _assemble(blocks, slots, size):
    """Sum per-child local blocks (n, c, k, k) into (n, size, size) at
    the static slot pairs slots (c, k) (JAX: zeros.at[:, idx].add)."""
    n = blocks.shape[0]
    idx = (slots[:, :, None] * size + slots[:, None, :]).reshape(-1)
    out = blocks.new_zeros((n, size * size))
    out.index_add_(1, _ix(idx, blocks.device), blocks.reshape(n, -1))
    return out.reshape(n, size, size)


def _place(vals, shape, rows, cols):
    """(n,) + shape zeros with vals set at the static (rows, cols)
    positions (JAX: zeros.at[:, rows, cols].set(vals))."""
    out = vals.new_zeros((vals.shape[0],) + tuple(shape))
    out[:, _ix(rows, vals.device), _ix(cols, vals.device)] = vals
    return out


def _solve_batch(A, rhs):
    """Batched dense solve (direct LU)."""
    return torch.linalg.solve(A, rhs)


def _eigvalsh(G):
    """Eigenvalues of a batch of small symmetric Gram matrices, computed
    in f64 and returned in G's dtype.  On the card, torch.linalg.eigvalsh
    in f32 (cuSOLVER) returns NaN for an exactly-zero 3 x 3 matrix, which
    the deflated trace Gram of a homogeneous level is; in f64 (and
    through MAGMA) it does not (parelag_tpu_torch/eigvalsh_probe.py)."""
    return torch.linalg.eigvalsh(G.double()).to(G.dtype)


def _snap_zero(lam):
    """Zero-snap of structurally-zero coarse-derivative entries: exact
    arithmetic leaves them at the f64 eps floor."""
    thr = float(np.finfo(np.float64).eps)
    return torch.where(lam.abs() > thr, -lam, torch.zeros_like(lam))


def _bub_sv(bub):
    """Largest singular value of the bubble residuals (n, i, kt)."""
    if not bub.shape[2]:
        return bub.new_zeros(())
    G = torch.einsum("nit,nis->nts", bub, bub)
    return torch.sqrt(torch.clamp(_eigvalsh(G).max(), min=0.0))


def _coarse_mass(basis, Mae):
    cm = torch.einsum("nik,nij,njl->nkl", basis, Mae, basis)
    return 0.5 * (cm + cm.transpose(1, 2))


# --------------------------------------------------------------------- #
# level state
# --------------------------------------------------------------------- #

@dataclass
class StructuredLevel:
    """Per-level value plane (tensors on the level's device).  Local
    mass families follow the canonical local orders of
    fine_local_masses; derivative value arrays follow the d0/d1/d2
    column patterns.  At coarse levels the PV traces are all ones."""
    shape: tuple
    m00: object = None      # (nc, 8, 8)
    m10: object = None      # (nf, 4, 4)
    m20: object = None      # (ne, 2, 2)
    m01: object = None      # (nc, 12, 12)
    m11: object = None      # (nf, 4, 4)
    m21: object = None      # (ne,)
    m02: object = None      # (nc, 6, 6)
    m12: object = None      # (nf,)
    m03: object = None      # (nc,)
    d0: object = None       # (ne, 2)
    d1: object = None       # (nf, 4)
    d2: object = None       # (nc, 6)
    pv1: object = None      # (ne,)
    pv2: object = None      # (nf,)
    t0: object = None       # (nv, k0)
    t1: object = None       # (ne, k1)
    t2: object = None       # (nf, k2)
    t3: object = None       # (nc, k3)


def fine_level(shape, h=None, dtype=torch.float64, coeff=None,
               l2_weight=None, device=None) -> StructuredLevel:
    """Level-0 state on a brick grid of cell size h (None: 1/shape per
    axis, the [0,1]^3 grid), on `device` (None: the card).  coeff: a
    per-cell scalar weighting the codim-0 masses of all forms
    (heterogeneous media); l2_weight: a separate per-cell weight for the
    L2 mass (Darcy W; None: coeff).  Local matrices that are identical
    for every entity (all of them without coeff) are stored as broadcast
    (stride-0) views of one block each."""
    device = resolve_device(device)
    if h is None:
        h = tuple(1.0 / s for s in shape)
    nc, nf, ne, nv = grid_counts(shape)
    dt = as_torch_dtype(dtype)
    # host values in the level's precision, as the JAX module builds them
    np_dt = np.float32 if dt == torch.float32 else np.float64
    ref = fine_local_masses(h, np_dt)

    def tt(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    def bc(M, n):
        return tt(M).expand((n,) + M.shape)

    def fam(Ms, counts):
        return torch.cat([bc(M, c) for M, c in zip(Ms, counts)], dim=0)

    def full(vals, counts):
        return torch.cat([torch.full((c,), float(v), dtype=dt,
                                     device=device)
                          for v, c in zip(vals, counts)])

    def weighted(M):
        B = bc(M, nc)
        return B if coeff is None else c[:, None, None] * B

    c = None if coeff is None else tt(coeff)
    w = tt(l2_weight) if l2_weight is not None else c
    lvl = StructuredLevel(shape=tuple(shape))
    lvl.m00 = weighted(ref[(0, 0)])
    lvl.m01 = weighted(ref[(0, 1)])
    lvl.m02 = weighted(ref[(0, 2)])
    lvl.m03 = (torch.full((nc,), float(ref[(0, 3)][0, 0]), dtype=dt,
                          device=device) if w is None
               else w * float(ref[(0, 3)][0, 0]))
    lvl.m10 = fam(ref[(1, 0)], nf)
    lvl.m11 = fam(ref[(1, 1)], nf)
    lvl.m12 = full([ref[(1, 2)][a][0, 0] for a in range(3)], nf)
    lvl.m20 = fam(ref[(2, 0)], ne)
    lvl.m21 = full([ref[(2, 1)][a][0, 0] for a in range(3)], ne)
    d0, d1, d2 = fine_derivative_values(shape, h, np_dt)
    lvl.d0, lvl.d1, lvl.d2 = tt(d0), tt(d1), tt(d2)
    # PV traces: Hcurl = unit tangent (circulation = h_a), Hdiv = unit
    # normal (flux = area); H1/L2 = 1
    lvl.pv1 = full(h, ne)
    areas = (h[1] * h[2], h[0] * h[2], h[0] * h[1])
    lvl.pv2 = full(areas, nf)
    # order-0 polynomial upscaling targets: constants for H1/L2, the
    # three unit fields for Hcurl/Hdiv
    lvl.t0 = torch.ones((nv, 1), dtype=dt, device=device)
    lvl.t3 = torch.ones((nc, 1), dtype=dt, device=device)
    eh = np.eye(3, dtype=np_dt) * np.asarray(h, dtype=np_dt)
    ea = np.eye(3, dtype=np_dt) * np.asarray(areas, dtype=np_dt)
    lvl.t1 = torch.cat([bc(eh[a], ne[a]) for a in range(3)], dim=0)
    lvl.t2 = torch.cat([bc(ea[a], nf[a]) for a in range(3)], dim=0)
    return lvl


# --------------------------------------------------------------------- #
# stage cores
# --------------------------------------------------------------------- #

def _trace_scalar_stage(m_children, pv_children, t_children):
    """Trace stage with 1x1 child blocks (L2 / Hdiv-facet / Hcurl-edge
    traces; ComputeCoarseTracesWithTargets restricted to the pure-PV
    outcome): returns (Ptr, F, cm, t_coarse, max_rel_sv), max_rel_sv the
    largest deflated singular value relative to the PV norm."""
    mpv = m_children * pv_children
    dots = torch.sum(pv_children * mpv, dim=1)
    F = mpv / dots[:, None]
    kt = t_children.shape[2]
    t_coarse = torch.einsum("nk,nkt->nt", F, t_children)
    Td = t_children - pv_children[:, :, None] * t_coarse[:, None, :]
    w = Td * torch.sqrt(m_children)[:, :, None]
    G = torch.einsum("nkt,nks->nts", w, w)
    if kt:
        ev = _eigvalsh(G)
        max_rel = torch.max(torch.sqrt(torch.clamp(ev, min=0.0))
                            / dots[:, None])
    else:
        max_rel = dots.new_zeros(())
    return pv_children, F, dots, t_coarse, max_rel


_HDIV_CELL_ROWS24 = np.arange(24)
_HDIV_CELL_COLS24 = np.repeat(np.arange(6), 4)


def _hdiv_interior_stage(m02_ch, vols_ch, d2_ch, ptr3, ptr2_cf, t2_u,
                         fslot):
    """Hdiv interior Lagrange extension (hFacetExtension for jform=2):
    per coarse cell, u = 36 subgrid faces (12 interior first), p = 8
    child cells, one PV multiplier.
    Returns (Pint (n,12,6), d2c (n,6), cm (n,6,6), bub_sv)."""
    n = m02_ch.shape[0]
    Mae = _assemble(m02_ch, fslot, 36)
    Dloc = _place(d2_ch, (8, 36), np.arange(8)[:, None], fslot)
    B = vols_ch[:, :, None] * Dloc                  # (n, 8, 36)
    T = vols_ch * ptr3                              # (n, 8)
    Pb = _place(ptr2_cf.reshape(n, 24), (24, 6), _HDIV_CELL_ROWS24,
                _HDIV_CELL_COLS24)       # row 4*f + i <- facet f child i
    M_ii, M_ib = Mae[:, :12, :12], Mae[:, :12, 12:]
    B_ii, B_ib = B[:, :, :12], B[:, :, 12:]

    A = Mae.new_zeros((n, 21, 21))
    A[:, :12, :12] = M_ii
    A[:, 12:20, :12] = B_ii
    A[:, :12, 12:20] = B_ii.transpose(1, 2)
    A[:, 20, 12:20] = T
    A[:, 12:20, 20] = T

    kt = t2_u.shape[2]
    t_int, t_bdr = t2_u[:, :12], t2_u[:, 12:]
    rhs = Mae.new_zeros((n, 21, 6 + kt))
    rhs[:, :12, :6] = -(M_ib @ Pb)
    rhs[:, 12:20, :6] = -(B_ib @ Pb)
    rhs[:, :12, 6:] = -(M_ib @ t_bdr)
    rhs[:, 12:20, 6:] = B_ii @ t_int

    X = _solve_batch(A, rhs)
    Pint = X[:, :12, :6]
    d2c = _snap_zero(X[:, 20, :6])
    bub_sv = _bub_sv(t_int - X[:, :12, 6:])
    cm = _coarse_mass(torch.cat([Pint, Pb], dim=1), Mae)
    return Pint, d2c, cm, bub_sv


_E1F_ROWS8 = np.arange(8)
_E1F_COLS8 = np.repeat(np.arange(4), 2)


def _hcurl_facet_stage(m11_ch, m12_ch, d1_ch, ptr2_f, ptr1_ce, t1_u,
                       eslot):
    """Hcurl facet Lagrange extension (hFacetExtension for jform=1):
    per coarse face, u = 12 subgrid edges (4 interior first), p = 4
    child faces, one PV multiplier (the facet's Hdiv PV).
    Returns (Pf1 (n,4,4), d1c (n,4), cm (n,4,4), bub_sv)."""
    n = m11_ch.shape[0]
    Mae = _assemble(m11_ch, eslot, 12)
    Dloc = _place(d1_ch, (4, 12), np.arange(4)[:, None], eslot)
    B = m12_ch[:, :, None] * Dloc                   # (n, 4, 12)
    T = m12_ch * ptr2_f                             # (n, 4)
    Pb = _place(ptr1_ce.reshape(n, 8), (8, 4), _E1F_ROWS8, _E1F_COLS8)
    M_ii, M_ib = Mae[:, :4, :4], Mae[:, :4, 4:]
    B_ii, B_ib = B[:, :, :4], B[:, :, 4:]

    A = Mae.new_zeros((n, 9, 9))
    A[:, :4, :4] = M_ii
    A[:, 4:8, :4] = B_ii
    A[:, :4, 4:8] = B_ii.transpose(1, 2)
    A[:, 8, 4:8] = T
    A[:, 4:8, 8] = T

    kt = t1_u.shape[2]
    t_int, t_bdr = t1_u[:, :4], t1_u[:, 4:]
    rhs = Mae.new_zeros((n, 9, 4 + kt))
    rhs[:, :4, :4] = -(M_ib @ Pb)
    rhs[:, 4:8, :4] = -(B_ib @ Pb)
    rhs[:, :4, 4:] = -(M_ib @ t_bdr)
    rhs[:, 4:8, 4:] = B_ii @ t_int

    X = _solve_batch(A, rhs)
    Pf1 = X[:, :4, :4]
    d1c = _snap_zero(X[:, 8, :4])
    bub_sv = _bub_sv(t_int - X[:, :4, 4:])
    cm = _coarse_mass(torch.cat([Pf1, Pb], dim=1), Mae)
    return Pf1, d1c, cm, bub_sv


_E1C_ROWS24 = np.arange(24)
_E1C_COLS24 = np.repeat(np.arange(12), 2)


def _hcurl_interior_stage(m01_ch, m02_ch, vols_ch, d1_u, d2_ch,
                          ptr1_ce, pf1_cf, pint2, ptr2_cf, d1c_cf, t1_u,
                          eslot_cell, fslot, fe_slot, fep):
    """Hcurl interior extension ([M B^T; B -C], hRidgePeakExtension for
    jform=1, with null targets): per coarse cell, u = 54 subgrid edges
    (6 interior first), p = 36 subgrid faces (12 interior first),
    e2 = 8 child cells.  Returns (Pc1 (n,6,12), cm (n,12,12), bub_sv)."""
    n = m01_ch.shape[0]
    Mae = _assemble(m01_ch, eslot_cell, 54)
    Wae = _assemble(m02_ch, fslot, 36)
    D1loc = _place(d1_u, (36, 54), np.arange(36)[:, None], fe_slot)
    B = (Wae @ D1loc)[:, :12, :]                    # (n, 12, 54)
    D2loc = _place(d2_ch, (8, 36), np.arange(8)[:, None], fslot)
    D2i = D2loc[:, :, :12]
    C = torch.einsum("nki,nk,nkj->nij", D2i, vols_ch, D2i)

    # PDc = P2 @ D1c within the AE: (n, 36, 12)
    D1c_cell = _place(d1c_cf, (6, 12), np.arange(6)[:, None], fep)
    pd_int = pint2 @ D1c_cell                       # (n, 12, 12)
    pd_bdr = (ptr2_cf[:, :, :, None]
              * D1c_cell[:, :, None, :]).reshape(n, 24, 12)
    dPcs = torch.cat([pd_int, pd_bdr], dim=1)

    Pb = Mae.new_zeros((n, 48, 12))
    Pb[:, _ix(_E1C_ROWS24, Pb.device), _ix(_E1C_COLS24, Pb.device)] = \
        ptr1_ce.reshape(n, 24)
    # facet-interior rows 24 + 4f + j, cols fep[f]
    rows = (24 + 4 * np.arange(6)[:, None]
            + np.arange(4)[None, :])                        # (6, 4)
    Pb[:, _ix(rows[:, :, None], Pb.device), _ix(fep[:, None, :],
                                                Pb.device)] = pf1_cf

    M_ii, M_ib = Mae[:, :6, :6], Mae[:, :6, 6:]
    B_ii, B_ib = B[:, :, :6], B[:, :, 6:]
    A = Mae.new_zeros((n, 18, 18))
    A[:, :6, :6] = M_ii
    A[:, 6:, :6] = B_ii
    A[:, :6, 6:] = B_ii.transpose(1, 2)
    A[:, 6:, 6:] = -C

    kt = t1_u.shape[2]
    t_int, t_bdr = t1_u[:, :6], t1_u[:, 6:]
    rhs = Mae.new_zeros((n, 18, 12 + kt))
    rhs[:, :6, :12] = -(M_ib @ Pb)
    rhs[:, 6:, :12] = -(B_ib @ Pb) + Wae[:, :12, :] @ dPcs
    rhs[:, :6, 12:] = -(M_ib @ t_bdr)
    rhs[:, 6:, 12:] = B_ii @ t_int

    X = _solve_batch(A, rhs)
    Pc1 = X[:, :6, :12]
    bub_sv = _bub_sv(t_int - X[:, :6, 12:])
    cm = _coarse_mass(torch.cat([Pc1, Pb], dim=1), Mae)
    return Pc1, cm, bub_sv


def _h1_edge_stage(m20_ch, m21_ch, d0_ch, ptr1_e, t0_u):
    """H1 edge Lagrange extension (hFacetExtension for jform=0): per
    coarse edge, u = [mid, tail, head] vertices (1 interior), p = 2
    child edges, one PV multiplier (the coarse edge's Hcurl PV).
    Returns (pe0 (n,1,2), d0c (n,2), cm (n,2,2), bub_sv)."""
    n = m20_ch.shape[0]
    vslots = np.array([[1, 0], [0, 2]])
    Mae = _assemble(m20_ch, vslots, 3)
    Dloc = _place(d0_ch, (2, 3), np.arange(2)[:, None], vslots)
    B = m21_ch[:, :, None] * Dloc                   # (n, 2, 3)
    T = m21_ch * ptr1_e                             # (n, 2)
    Pb = torch.eye(2, dtype=Mae.dtype, device=Mae.device).expand(n, 2, 2)
    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]

    A = Mae.new_zeros((n, 4, 4))
    A[:, :1, :1] = M_ii
    A[:, 1:3, :1] = B_ii
    A[:, :1, 1:3] = B_ii.transpose(1, 2)
    A[:, 3, 1:3] = T
    A[:, 1:3, 3] = T

    kt = t0_u.shape[2]
    t_int, t_bdr = t0_u[:, :1], t0_u[:, 1:]
    rhs = Mae.new_zeros((n, 4, 2 + kt))
    rhs[:, :1, :2] = -(M_ib @ Pb)
    rhs[:, 1:3, :2] = -(B_ib @ Pb)
    rhs[:, :1, 2:] = -(M_ib @ t_bdr)
    rhs[:, 1:3, 2:] = B_ii @ t_int

    X = _solve_batch(A, rhs)
    pe0 = X[:, :1, :2]
    d0c = _snap_zero(X[:, 3, :2])
    bub_sv = _bub_sv(t_int - X[:, :1, 2:])
    cm = _coarse_mass(torch.cat([pe0, Pb], dim=1), Mae)
    return pe0, d0c, cm, bub_sv


def _h1_facet_stage(m10_ch, m11_ch, m12_ch, d0_fu, d1_ch, ptr1_fe,
                    pe0_fe, d0c_fe, pf1_f, t0_u, vslot, eslot, evslot):
    """H1 facet extension ([M B^T; B -C] with null targets,
    hRidgePeakExtension for jform=0 at codim 1): per coarse face,
    u = 9 subgrid vertices (1 interior), p = 12 subgrid edges (4
    interior), e2 = 4 child faces.  Returns (pf0 (n,1,4), cm (n,4,4),
    bub_sv)."""
    n = m10_ch.shape[0]
    Mae = _assemble(m10_ch, vslot, 9)
    Wae = _assemble(m11_ch, eslot, 12)
    D0loc = _place(d0_fu, (12, 9), np.arange(12)[:, None], evslot)
    B = (Wae @ D0loc)[:, :4, :]                     # (n, 4, 9)
    D1loc = _place(d1_ch, (4, 12), np.arange(4)[:, None], eslot)
    D1i = D1loc[:, :, :4]
    C = torch.einsum("nki,nk,nkj->nij", D1i, m12_ch, D1i)

    # PDc = P1 @ D0c within the face: (n, 12, 4)
    D0c_face = _place(d0c_fe, (4, 4), np.arange(4)[:, None],
                      _FACE_EDGE_VERT_POS)
    pd_int = pf1_f @ D0c_face                       # (n, 4, 4)
    pd_bdr = (ptr1_fe[:, :, :, None]
              * D0c_face[:, :, None, :]).reshape(n, 8, 4)
    dPcs = torch.cat([pd_int, pd_bdr], dim=1)

    Pb = Mae.new_zeros((n, 8, 4))
    ar4 = _ix(np.arange(4), Pb.device)
    Pb[:, ar4, ar4] = 1.0
    Pb[:, _ix(np.repeat(4 + np.arange(4), 2), Pb.device),
       _ix(_FACE_EDGE_VERT_POS.reshape(-1), Pb.device)] = \
        pe0_fe.reshape(n, 8)

    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]
    A = Mae.new_zeros((n, 5, 5))
    A[:, :1, :1] = M_ii
    A[:, 1:, :1] = B_ii
    A[:, :1, 1:] = B_ii.transpose(1, 2)
    A[:, 1:, 1:] = -C

    kt = t0_u.shape[2]
    t_int, t_bdr = t0_u[:, :1], t0_u[:, 1:]
    rhs = Mae.new_zeros((n, 5, 4 + kt))
    rhs[:, :1, :4] = -(M_ib @ Pb)
    rhs[:, 1:, :4] = -(B_ib @ Pb) + Wae[:, :4, :] @ dPcs
    rhs[:, :1, 4:] = -(M_ib @ t_bdr)
    rhs[:, 1:, 4:] = B_ii @ t_int

    X = _solve_batch(A, rhs)
    pf0 = X[:, :1, :4]
    bub_sv = _bub_sv(t_int - X[:, :1, 4:])
    cm = _coarse_mass(torch.cat([pf0, Pb], dim=1), Mae)
    return pf0, cm, bub_sv


def _h1_interior_stage(m00_ch, m01_ch, m02_ch, d0_u, d1_u, ptr1_ce,
                       pe0_ce, d0c_ce, pf1_cf, pc1, pf0_cf,
                       vslot_cell, eslot_cell, fslot, ev_slot, fe_slot,
                       fep, evp, fvp):
    """H1 interior extension ([M B^T; B -C], no null targets): per
    coarse cell, u = 27 subgrid vertices (1 interior), p = 54 subgrid
    edges (6 interior), e2 = 36 subgrid faces.
    Returns (pc0 (n,1,8), cm (n,8,8))."""
    n = m00_ch.shape[0]
    Mae = _assemble(m00_ch, vslot_cell, 27)
    Wae = _assemble(m01_ch, eslot_cell, 54)
    W2ae = _assemble(m02_ch, fslot, 36)
    D0loc = _place(d0_u, (54, 27), np.arange(54)[:, None], ev_slot)
    B = (Wae @ D0loc)[:, :6, :]                     # (n, 6, 27)
    D1loc = _place(d1_u, (36, 54), np.arange(36)[:, None], fe_slot)
    D1i = D1loc[:, :, :6]
    C = torch.einsum("nki,nkl,nlj->nij", D1i, W2ae, D1i)

    # PDc = P1 @ D0c within the AE: rows = 54 edges in slot order
    D0c_cell = _place(d0c_ce, (12, 8), np.arange(12)[:, None], evp)
    pd_int = pc1 @ D0c_cell                         # (n, 6, 8)
    pd_ce = (ptr1_ce[:, :, :, None]
             * D0c_cell[:, :, None, :]).reshape(n, 24, 8)
    # facet-interior rows: pf1[f] (4x4 coarse-edge cols) @ D0c rows of
    # the facet's coarse edges
    d0c_fcells = D0c_cell[:, _ix(fep, D0c_cell.device), :]  # (n,6,4,8)
    pd_fi = torch.einsum("nfij,nfjk->nfik", pf1_cf,
                         d0c_fcells).reshape(n, 24, 8)
    dPcs = torch.cat([pd_int, pd_ce, pd_fi], dim=1)

    Pb = Mae.new_zeros((n, 26, 8))
    ar8 = _ix(np.arange(8), Pb.device)
    Pb[:, ar8, ar8] = 1.0
    Pb[:, _ix(np.repeat(8 + np.arange(12), 2), Pb.device),
       _ix(evp.reshape(-1), Pb.device)] = pe0_ce.reshape(n, 24)
    Pb[:, _ix(np.repeat(20 + np.arange(6), 4), Pb.device),
       _ix(fvp.reshape(-1), Pb.device)] = pf0_cf.reshape(n, 24)

    M_ii, M_ib = Mae[:, :1, :1], Mae[:, :1, 1:]
    B_ii, B_ib = B[:, :, :1], B[:, :, 1:]
    A = Mae.new_zeros((n, 7, 7))
    A[:, :1, :1] = M_ii
    A[:, 1:, :1] = B_ii
    A[:, :1, 1:] = B_ii.transpose(1, 2)
    A[:, 1:, 1:] = -C

    rhs = Mae.new_zeros((n, 7, 8))
    rhs[:, :1, :] = -(M_ib @ Pb)
    rhs[:, 1:, :] = -(B_ib @ Pb) + Wae[:, :6, :] @ dPcs

    X = _solve_batch(A, rhs)
    pc0 = X[:, :1, :8]
    cm = _coarse_mass(torch.cat([pc0, Pb], dim=1), Mae)
    return pc0, cm


# --------------------------------------------------------------------- #
# one coarsening step
# --------------------------------------------------------------------- #

@dataclass
class LevelOut:
    """Per-level outputs of the structured coarsening (tensors on the
    level's device, plus host id arrays for materialization)."""
    cshape: tuple
    # L2 / Hdiv
    ptr3: object = None
    f3: object = None
    ptr2: object = None
    f2: object = None
    pint2: object = None
    d2c: object = None
    # Hcurl
    ptr1: object = None
    f1: object = None
    pf1: object = None
    pc1: object = None
    d1c: object = None
    # H1
    pe0: object = None
    pf0: object = None
    pc0: object = None
    d0c: object = None
    # host id arrays
    cc: object = None        # (ncc, 8) child cells
    cf: object = None        # (ncf, 4) child faces
    ce: object = None        # (nce, 2) child edges
    cv: object = None        # (ncv,)  child vertices
    cfaces: object = None    # (ncc, 6) coarse facet ids
    cedges: object = None    # (ncc, 12) coarse edge ids
    cverts: object = None    # (ncc, 8) coarse vertex ids
    fedges: object = None    # (ncf, 4) coarse edge ids per coarse face
    fverts: object = None    # (ncf, 4) coarse vertex ids per coarse face
    everts: object = None    # (nce, 2) coarse vertex ids per coarse edge
    ufaces: object = None    # (ncc, 36)
    uedges: object = None    # (ncc, 54)
    uverts: object = None    # (ncc, 27)
    fuedges: object = None   # (ncf, 12)
    fuverts: object = None   # (ncf, 9)
    euverts: object = None   # (nce, 3)
    max_rel_sv: float = 0.0
    bub_sv: float = 0.0


@dataclass
class DarcyLevelOut:
    """Per-level outputs of the Hdiv-L2 coarsening (tensors on the
    level's device + host id arrays for materialization)."""
    cshape: tuple
    ptr3: object            # (ncc, 8)   L2 trace P values
    f3: object              # (ncc, 8)   L2 cochain functionals
    ptr2: object            # (ncf, 4)   Hdiv facet-trace P values
    f2: object              # (ncf, 4)
    pint2: object           # (ncc, 12, 6) Hdiv interior P values
    d2c: object             # (ncc, 6)   coarse div values
    cc: object = None       # (ncc, 8)   fine cell ids (host)
    cf: object = None       # (ncf, 4)   fine face ids (host)
    cfaces: object = None   # (ncc, 6)   coarse facet ids (host)
    ufaces: object = None   # (ncc, 36)  fine face ids, slot order (host)
    max_rel_sv: float = 0.0
    bub_sv: float = 0.0


def _level_ids(cshape, jform_start=0):
    """Host id arrays of one coarsening step from L2 down to
    jform_start."""
    ids = dict(cc=children_cells(cshape), cf=children_faces(cshape),
               cfaces=d2_cols(cshape), ufaces=_subgrid_u_faces(cshape))
    if jform_start <= 1:
        ids.update(ce=children_edges(cshape),
                   fedges=face_edges_m(cshape),
                   cedges=cell_edges(cshape),
                   fuedges=_face_u_edges(cshape),
                   uedges=_subgrid_u_edges(cshape))
    if jform_start <= 0:
        ids.update(cv=children_verts(cshape), everts=d0_cols(cshape),
                   fverts=face_verts(cshape), cverts=cell_verts(cshape),
                   euverts=_edge_u_verts(cshape),
                   fuverts=_face_u_verts(cshape),
                   uverts=_subgrid_u_verts(cshape))
    return ids


#: entities per stage chunk: bounds the O(chunk * 54^2) stage tensors
#: (the whole first level at 96^3 would hold ~1.3 GB per such tensor)
_CHUNK = 8192


def _run_stage(fn, spec, n, chunk):
    """Run a batched stage over n entities in chunks of `chunk` (0: one
    piece).  spec entries, in the stage's argument order:
      ("g", tensor, idx)  gathered input tensor[idx], idx a host int
                          array with leading dim n;
      ("d", tensor)       per-entity tensor (leading dim n);
      ("s", const)        static pattern table (numpy).
    Per-entity outputs concatenate to length n; scalar outputs take the
    max over chunks."""
    chunk = n if not chunk else max(1, min(int(chunk), n))
    dev = next(e[1].device for e in spec if e[0] in "gd")
    idx = [_ix(e[2], dev) if e[0] == "g" else None for e in spec]
    parts = []
    for s in range(0, n, chunk):
        args = []
        for e, ix in zip(spec, idx):
            if e[0] == "g":
                args.append(e[1][ix[s:s + chunk]])
            elif e[0] == "d":
                args.append(e[1][s:s + chunk])
            else:
                args.append(e[1])
        parts.append(fn(*args))
    return tuple(torch.stack(leaves).max() if leaves[0].ndim == 0
                 else torch.cat(leaves, dim=0) for leaves in zip(*parts))


def _coarsen_core(arrs, ids, cshape, chunk, jform_start=0):
    """One coarsening step as a sequence of chunked stages (L2/Hdiv ->
    Hcurl (jform_start <= 1) -> H1 (jform_start == 0)).  Returns (coarse
    arrays, outputs, max trace sv, max bubble sv)."""
    dt = arrs["m03"].dtype
    dev = arrs["m03"].device
    nc, nf, ne, nv = grid_counts(cshape)
    out, co = {}, {}
    svs, bubs = [], []
    cc, cf, cfaces, ufaces = (ids["cc"], ids["cf"], ids["cfaces"],
                              ids["ufaces"])
    ncc, ncf = cc.shape[0], cf.shape[0]
    pv3 = torch.ones(arrs["m03"].shape[0], dtype=dt, device=dev)

    def stage(fn, spec, n):
        return _run_stage(fn, spec, n, chunk)

    # ---- L2 + Hdiv ---------------------------------------------------
    out["ptr3"], out["f3"], co["m03"], co["t3"], sv3 = stage(
        _trace_scalar_stage,
        [("g", arrs["m03"], cc), ("g", pv3, cc), ("g", arrs["t3"], cc)],
        ncc)
    out["ptr2"], out["f2"], co["m12"], co["t2"], sv2 = stage(
        _trace_scalar_stage,
        [("g", arrs["m12"], cf), ("g", arrs["pv2"], cf),
         ("g", arrs["t2"], cf)], ncf)
    out["pint2"], out["d2c"], co["m02"], bub2 = stage(
        _hdiv_interior_stage,
        [("g", arrs["m02"], cc), ("g", arrs["m03"], cc),
         ("g", arrs["d2"], cc), ("d", out["ptr3"]),
         ("g", out["ptr2"], cfaces), ("g", arrs["t2"], ufaces),
         ("s", _cell_stage_patterns_hdiv())], ncc)
    co["d2"] = out["d2c"]
    co["pv2"] = torch.ones(sum(nf), dtype=dt, device=dev)
    svs += [sv3, sv2]
    bubs += [bub2]
    if jform_start >= 2:
        return co, out, torch.stack(svs).max(), torch.stack(bubs).max()

    # ---- Hcurl --------------------------------------------------------
    ce, fedges, cedges, fuedges, uedges = (
        ids[k] for k in ("ce", "fedges", "cedges", "fuedges",
                         "uedges"))
    nce = ce.shape[0]
    out["ptr1"], out["f1"], co["m21"], co["t1"], sv1 = stage(
        _trace_scalar_stage,
        [("g", arrs["m21"], ce), ("g", arrs["pv1"], ce),
         ("g", arrs["t1"], ce)], nce)
    out["pf1"], out["d1c"], co["m11"], bub1f = stage(
        _hcurl_facet_stage,
        [("g", arrs["m11"], cf), ("g", arrs["m12"], cf),
         ("g", arrs["d1"], cf), ("d", out["ptr2"]),
         ("g", out["ptr1"], fedges), ("g", arrs["t1"], fuedges),
         ("s", _face_child_edge_slots())], ncf)
    out["pc1"], co["m01"], bub1c = stage(
        _hcurl_interior_stage,
        [("g", arrs["m01"], cc), ("g", arrs["m02"], cc),
         ("g", arrs["m03"], cc), ("g", arrs["d1"], ufaces),
         ("g", arrs["d2"], cc), ("g", out["ptr1"], cedges),
         ("g", out["pf1"], cfaces), ("d", out["pint2"]),
         ("g", out["ptr2"], cfaces), ("g", out["d1c"], cfaces),
         ("g", arrs["t1"], uedges),
         ("s", _cell_child_edge_slots()),
         ("s", _cell_stage_patterns_hdiv()),
         ("s", _cell_face_edge_slots()),
         ("s", _cell_facet_edge_positions())], ncc)
    co["d1"] = out["d1c"]
    co["pv1"] = torch.ones(sum(ne), dtype=dt, device=dev)
    svs += [sv1]
    bubs += [bub1f, bub1c]
    if jform_start == 1:
        return co, out, torch.stack(svs).max(), torch.stack(bubs).max()

    # ---- H1 -----------------------------------------------------------
    everts_u, fuverts, uverts = (
        ids[k] for k in ("euverts", "fuverts", "uverts"))
    out["pe0"], out["d0c"], co["m20"], bub0e = stage(
        _h1_edge_stage,
        [("g", arrs["m20"], ce), ("g", arrs["m21"], ce),
         ("g", arrs["d0"], ce), ("d", out["ptr1"]),
         ("g", arrs["t0"], everts_u)], nce)
    out["pf0"], co["m10"], bub0f = stage(
        _h1_facet_stage,
        [("g", arrs["m10"], cf), ("g", arrs["m11"], cf),
         ("g", arrs["m12"], cf), ("g", arrs["d0"], fuedges),
         ("g", arrs["d1"], cf), ("g", out["ptr1"], fedges),
         ("g", out["pe0"], fedges), ("g", out["d0c"], fedges),
         ("d", out["pf1"]), ("g", arrs["t0"], fuverts),
         ("s", _face_child_vert_slots()),
         ("s", _face_child_edge_slots()),
         ("s", _face_edge_vert_slots())], ncf)
    out["pc0"], co["m00"] = stage(
        _h1_interior_stage,
        [("g", arrs["m00"], cc), ("g", arrs["m01"], cc),
         ("g", arrs["m02"], cc), ("g", arrs["d0"], uedges),
         ("g", arrs["d1"], ufaces), ("g", out["ptr1"], cedges),
         ("g", out["pe0"], cedges), ("g", out["d0c"], cedges),
         ("g", out["pf1"], cfaces), ("d", out["pc1"]),
         ("g", out["pf0"], cfaces),
         ("s", _cell_child_vert_slots()),
         ("s", _cell_child_edge_slots()),
         ("s", _cell_stage_patterns_hdiv()),
         ("s", _cell_edge_vert_slots()),
         ("s", _cell_face_edge_slots()),
         ("s", _cell_facet_edge_positions()),
         ("s", _cell_edge_vert_positions()),
         ("s", _cell_facet_vert_positions())], ncc)
    co["d0"] = out["d0c"]
    co["t0"] = arrs["t0"][_ix(ids["cv"], dev)]
    bubs += [bub0e, bub0f]

    maxsv = torch.stack(svs).max()
    maxbub = torch.stack(bubs).max()
    return co, out, maxsv, maxbub


#: SVD keep threshold of the generic engine's trace/bubble stages
_SVD_TOL = 1e-9


def coarsen_structured(lvl: StructuredLevel, jform_start=0, chunk=None):
    """One cartesian 2x2x2 coarsening step of the de Rham chain from L2
    down to `jform_start` (the generic engine's Coarsen() loop, jform =
    3..jform_start).  Returns (coarse_level, LevelOut).  chunk: None =
    the module's _CHUNK, 0 = each stage over the whole level in one
    piece, > 0 = that chunk size."""
    shape = lvl.shape
    if not all(s % 2 == 0 for s in shape):
        raise ValueError(f"shape {shape} is not 2x2x2-coarsenable")
    if jform_start not in (0, 1, 2):
        raise ValueError(f"jform_start {jform_start} (need 0, 1 or 2)")
    cshape = tuple(s // 2 for s in shape)
    ids = _level_ids(cshape, jform_start)
    arrs = {k: v for k, v in vars(lvl).items()
            if k != "shape" and v is not None}
    with full_precision():
        co, outd, maxsv, maxbub = _coarsen_core(
            arrs, ids, cshape, _CHUNK if chunk is None else chunk,
            jform_start)

    coarse = StructuredLevel(shape=cshape, **co)
    out = LevelOut(cshape=cshape, **outd, **ids)
    out.max_rel_sv = float(maxsv)
    out.bub_sv = float(maxbub)
    # noise allowance 200*eps: the deflated-trace Gram is exact-zero in
    # exact arithmetic and only its rounding tail shows, while a
    # genuinely kept mode shows >= 1e-3 (heterogeneous coefficients)
    eff = max(_SVD_TOL, 200.0 * float(torch.finfo(lvl.m03.dtype).eps))
    bub_eff = max(1e2 * _SVD_TOL, eff)
    if not out.max_rel_sv < eff:
        raise RuntimeError(f"trace SVD kept a mode ({out.max_rel_sv}): "
                           "structure not static")
    if not out.bub_sv < bub_eff:
        raise RuntimeError(f"bubble SVD kept a mode ({out.bub_sv}): "
                           "structure not static")
    return coarse, out


def coarsen_darcy(lvl: StructuredLevel, chunk=None):
    """One structured coarsening step of the Hdiv x L2 pair (the
    reference's form_start=2 configuration: MultigridTestDarcy /
    SPE10): the L2 and Hdiv stages of coarsen_structured(jform_start=2),
    with its guards.  Returns (coarse_level, DarcyLevelOut)."""
    coarse, out = coarsen_structured(lvl, jform_start=2, chunk=chunk)
    return coarse, DarcyLevelOut(
        cshape=out.cshape, ptr3=out.ptr3, f3=out.f3, ptr2=out.ptr2,
        f2=out.f2, pint2=out.pint2, d2c=out.d2c, cc=out.cc, cf=out.cf,
        cfaces=out.cfaces, ufaces=out.ufaces, max_rel_sv=out.max_rel_sv,
        bub_sv=out.bub_sv)


def materialize_P_darcy(out: DarcyLevelOut, fshape):
    """Host CSRs (P2, P3) of one structured Darcy coarsening step."""
    return materialize_P(out, fshape, 2), materialize_P(out, fshape, 3)


def _cell_face_edge_slots():
    """(36, 4) subgrid face (slot order) -> 54-slot positions of its 4
    edges in the canonical M11 order."""
    slot_f = _subgrid_face_slots()
    slot_e = _subgrid_edge_slots()
    fe = face_edges_m(_S)                  # (36, 4) subgrid edge ids
    out = np.empty((36, 4), dtype=np.int64)
    out[slot_f] = slot_e[fe]
    return out


def _np(t):
    return t.detach().cpu().numpy()


def materialize_P(out: LevelOut, fshape, jform):
    """Host CSR of the structured P for one form at one level (jform 2
    and 3 also from a DarcyLevelOut)."""
    import scipy.sparse as sp
    ncf_, nff, nef, nvf = grid_counts(fshape)
    ncc, nfc, nec, nvc = grid_counts(out.cshape)
    if jform == 3:
        rows = out.cc.ravel()
        cols = np.repeat(np.arange(ncc), 8)
        return sp.coo_matrix((_np(out.ptr3).ravel(), (rows, cols)),
                             shape=(ncf_, ncc)).tocsr()
    if jform == 2:
        rows = np.concatenate([
            out.cf.ravel(),
            np.repeat(out.ufaces[:, :12].ravel(), 6)])
        cols = np.concatenate([
            np.repeat(np.arange(sum(nfc)), 4),
            np.tile(out.cfaces, (1, 12)).reshape(-1)])
        vals = np.concatenate([_np(out.ptr2).ravel(),
                               _np(out.pint2).ravel()])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(sum(nff), sum(nfc))).tocsr()
    if jform == 1:
        rows = np.concatenate([
            out.ce.ravel(),
            np.repeat(out.fuedges[:, :4].ravel(), 4),
            np.repeat(out.uedges[:, :6].ravel(), 12)])
        cols = np.concatenate([
            np.repeat(np.arange(sum(nec)), 2),
            np.tile(out.fedges, (1, 4)).reshape(-1),
            np.tile(out.cedges, (1, 6)).reshape(-1)])
        vals = np.concatenate([_np(out.ptr1).ravel(), _np(out.pf1).ravel(),
                               _np(out.pc1).ravel()])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(sum(nef), sum(nec))).tocsr()
    if jform != 0:
        raise ValueError(f"jform {jform} (need 0 to 3)")
    rows = np.concatenate([
        out.cv,
        np.repeat(out.euverts[:, 0], 2),
        np.repeat(out.fuverts[:, 0], 4),
        np.repeat(out.uverts[:, 0], 8)])
    cols = np.concatenate([
        np.arange(nvc), out.everts.ravel(), out.fverts.ravel(),
        out.cverts.ravel()])
    pe0 = _np(out.pe0)
    vals = np.concatenate([
        np.ones(nvc, dtype=pe0.dtype), pe0.ravel(),
        _np(out.pf0).ravel(), _np(out.pc0).ravel()])
    return sp.coo_matrix((vals, (rows, cols)), shape=(nvf, nvc)).tocsr()


# --------------------------------------------------------------------- #
# multilevel chain + global host views
# --------------------------------------------------------------------- #

def coarsen_chain(lvl: StructuredLevel, nlevels, jform_start=0):
    """Chain of structured coarsenings (DeRhamSequence.cpp:572-692
    applied nlevels-1 times) from L2 down to jform_start.  Returns
    (levels, outs) with len(levels) == nlevels, fine level first."""
    levels, outs = [lvl], []
    for _ in range(nlevels - 1):
        lvl, out = coarsen_structured(lvl, jform_start=jform_start)
        levels.append(lvl)
        outs.append(out)
    return levels, outs


def global_mass(lvl: StructuredLevel, jform):
    """Host CSR global mass of one form assembled from the level's
    codim-0 local blocks (ComputeMassOperator analog)."""
    import scipy.sparse as sp
    shape = lvl.shape
    nc, nf, ne, nv = grid_counts(shape)
    if jform == 0:
        return assemble_global(_np(lvl.m00), cell_verts(shape), nv)
    if jform == 1:
        return assemble_global(_np(lvl.m01), cell_edges(shape), sum(ne))
    if jform == 2:
        return assemble_global(_np(lvl.m02), cell_faces(shape), sum(nf))
    if jform == 3:
        return sp.diags(_np(lvl.m03)).tocsr()
    raise ValueError(jform)


def global_derivative(lvl: StructuredLevel, jform):
    """Host CSR derivative operator D_jform of the level."""
    shape = lvl.shape
    nc, nf, ne, nv = grid_counts(shape)
    if jform == 0:
        return assemble_d_csr(_np(lvl.d0), d0_cols(shape), (sum(ne), nv))
    if jform == 1:
        return assemble_d_csr(_np(lvl.d1), d1_cols(shape),
                              (sum(nf), sum(ne)))
    if jform == 2:
        return assemble_d_csr(_np(lvl.d2), d2_cols(shape), (nc, sum(nf)))
    raise ValueError(jform)


def boundary_entity_marker(shape, jform):
    """Boolean marker of grid-boundary entities in the global numbering
    (verts jform=0, edges jform=1, faces jform=2) — the structured-grid
    analog of mark_dofs_on_bndr over all 6 attributes.  An edge/vertex
    is boundary when any transverse lattice coordinate sits at its
    extreme; a face when its normal coordinate does."""
    nx, ny, nz = shape

    def fam(dims, bnd_axes):
        ni, nj, nk = dims
        m = np.zeros((nk, nj, ni), dtype=bool)
        for ax, extent in bnd_axes:
            sl = [slice(None)] * 3
            sl[2 - ax] = 0
            m[tuple(sl)] = True
            sl[2 - ax] = extent
            m[tuple(sl)] = True
        return m.ravel()

    if jform == 0:
        return fam((nx + 1, ny + 1, nz + 1),
                   [(0, nx), (1, ny), (2, nz)])
    if jform == 1:
        dims = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz))
        tr = ([(1, ny), (2, nz)], [(0, nx), (2, nz)], [(0, nx), (1, ny)])
        return np.concatenate([fam(dims[a], tr[a]) for a in range(3)])
    if jform == 2:
        dims = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
        nr = ([(0, nx)], [(1, ny)], [(2, nz)])
        return np.concatenate([fam(dims[a], nr[a]) for a in range(3)])
    raise ValueError(jform)


def _cell_edge_endpoint_slots(shape):
    """(12, 2) local vertex slot of each cell edge's (tail, head) in the
    cell_verts ordering — uniform across cells on the lexicographic
    grid (derived from cell 0)."""
    cv = cell_verts(shape)[0]
    ev = edge_verts(shape)[cell_edges(shape)[0]]     # (12, 2) vert ids
    pos = {int(v): i for i, v in enumerate(cv)}
    return np.array([[pos[int(a)], pos[int(b)]] for a, b in ev],
                    dtype=np.int64)


def h1_stiffness_blocks(lvl: StructuredLevel):
    """(nc, 8, 8) per-cell blocks of A = M0 + D0^T M1 D0: the cell-local
    gradient G (12x8) is the cell's d0 rows scattered to local vertex
    slots, so A_cell = m00 + G^T m01 G — one batched einsum per level."""
    shape = lvl.shape
    dev = lvl.d0.device
    dvals = lvl.d0[_ix(cell_edges(shape), dev)]      # (nc, 12, 2)
    G = _place(dvals, (12, 8), np.arange(12)[:, None],
               _cell_edge_endpoint_slots(shape))
    with full_precision():
        A = lvl.m00 + torch.einsum("nei,nef,nfj->nij", G, lvl.m01, G)
    return 0.5 * (A + A.transpose(1, 2))


def h1_stiffness(lvl: StructuredLevel):
    """Host CSR of A = M0 + D0^T M1 D0 assembled from the level's
    blocks."""
    nv = grid_counts(lvl.shape)[3]
    return assemble_global(_np(h1_stiffness_blocks(lvl)),
                           cell_verts(lvl.shape), nv)


def h1_uniform_cell_block(shape, h=None, dtype=np.float64):
    """(8, 8) per-cell block of M0 + G^T M1 G on the homogeneous fine
    level (h None: the [0,1]^3 grid) — identical for every cell, so the
    fine operator assembles host-side from one broadcast block."""
    if h is None:
        h = tuple(1.0 / s for s in shape)
    ref = fine_local_masses(h, np.dtype(dtype))
    d0, _, _ = fine_derivative_values(shape, h, np.dtype(dtype))
    ce0 = cell_edges(shape)[0]
    slots = _cell_edge_endpoint_slots(shape)
    G = np.zeros((12, 8), dtype=dtype)
    G[np.arange(12)[:, None], slots] = d0[ce0]
    A = np.asarray(ref[(0, 0)]) + G.T @ np.asarray(ref[(0, 1)]) @ G
    return 0.5 * (A + A.T)
