"""Unstructured conforming 3D meshes (hexahedral / tetrahedral).

Replaces the reference's dependency on mfem::Mesh/ParMesh for the features
ParElag actually uses: inline hex generation (mfem::Mesh::Make3D semantics,
used by the golden tests via the `Mesh(2,2,2,HEXAHEDRON)` fallback in
testsuite/UpscalingGeneralForm.cpp:225), uniform refinement with
children-contiguous-per-parent ordering (required by
MFEMRefinedMeshPartitioner.cpp:62-68 semantics for MFEM>=4.1), MFEM v1.0 and
NETGEN neutral mesh file readers (meshes/cube456.mesh is NETGEN tet format).

All arrays are numpy on host; the FE layer turns geometry into batched device
tensors.
"""

from dataclasses import dataclass, field
import numpy as np

# Local vertex numbering of the MFEM reference hexahedron:
#   v0=(0,0,0) v1=(1,0,0) v2=(1,1,0) v3=(0,1,0)
#   v4=(0,0,1) v5=(1,0,1) v6=(1,1,1) v7=(0,1,1)
HEX_EDGES = np.array(
    [(0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6), (4, 7),
     (0, 4), (1, 5), (2, 6), (3, 7)], dtype=np.int64)
# Outward-oriented face cycles (right-hand-rule normal points out of the hex).
HEX_FACES = np.array(
    [(3, 2, 1, 0),   # bottom z=0
     (0, 1, 5, 4),   # front  y=0
     (1, 2, 6, 5),   # right  x=1
     (2, 3, 7, 6),   # back   y=1
     (3, 0, 4, 7),   # left   x=0
     (4, 5, 6, 7)],  # top    z=1
    dtype=np.int64)

TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)
TET_FACES = np.array(
    [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)], dtype=np.int64)

# counterclockwise boundary edges of the reference quad (v0..v3 ccw)
QUAD_EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0)], dtype=np.int64)


@dataclass
class Mesh:
    """Conforming mesh of a single element type ('hex' or 'tet')."""

    vertices: np.ndarray          # (nv, 3) float64
    elements: np.ndarray          # (ne, 8) or (ne, 4) int64
    kind: str                     # 'hex' | 'tet' | 'quad'
    attrib: np.ndarray            # (ne,) int64 element attributes (1-based)
    bdr_faces: np.ndarray         # (nbf, 4|3) int64 vertex lists
    bdr_attrib: np.ndarray        # (nbf,) int64 boundary attributes (1-based)

    @property
    def dim(self):
        return 2 if self.kind == "quad" else 3

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_elements(self):
        return self.elements.shape[0]

    @property
    def local_edges(self):
        if self.kind == "quad":
            return QUAD_EDGES
        return HEX_EDGES if self.kind == "hex" else TET_EDGES

    @property
    def local_faces(self):
        return HEX_FACES if self.kind == "hex" else TET_FACES

    def transform(self, fn):
        """Apply coordinate transformation (mesh deformation)."""
        self.vertices = np.apply_along_axis(fn, 1, self.vertices)

    # ------------------------------------------------------------------ #
    def uniform_refinement(self) -> "Mesh":
        """Refine every element into 2^dim children, children contiguous per
        parent (so derefinement partitioning is partition[e] = e // 2^dim)."""
        if self.kind == "hex":
            return _refine_hex(self)
        if self.kind == "quad":
            return _refine_quad(self)
        return _refine_tet(self)


# ---------------------------------------------------------------------- #
# inline generator (mfem::Mesh::Make3D semantics)
# ---------------------------------------------------------------------- #
def hex_grid_mesh(nx, ny, nz, sx=1.0, sy=1.0, sz=1.0) -> Mesh:
    """Cartesian hex mesh of [0,sx]x[0,sy]x[0,sz].

    Vertex/element numbering and boundary attributes follow mfem
    Mesh::Make3D: index = ix + iy*(nx+1) + iz*(nx+1)*(ny+1); boundary
    attributes z=0 ->1, y=0 ->2, x=sx ->3, y=sy ->4, x=0 ->5, z=sz ->6.
    """
    X, Y, Z = np.meshgrid(
        np.linspace(0, sx, nx + 1),
        np.linspace(0, sy, ny + 1),
        np.linspace(0, sz, nz + 1),
        indexing="ij",
    )
    # index = ix + iy*(nx+1) + iz*(nx+1)*(ny+1)
    verts = np.stack(
        [X.transpose(2, 1, 0).ravel(),
         Y.transpose(2, 1, 0).ravel(),
         Z.transpose(2, 1, 0).ravel()], axis=1)

    def vid(ix, iy, iz):
        return ix + iy * (nx + 1) + iz * (nx + 1) * (ny + 1)

    elems = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                elems.append([
                    vid(ix, iy, iz), vid(ix + 1, iy, iz),
                    vid(ix + 1, iy + 1, iz), vid(ix, iy + 1, iz),
                    vid(ix, iy, iz + 1), vid(ix + 1, iy, iz + 1),
                    vid(ix + 1, iy + 1, iz + 1), vid(ix, iy + 1, iz + 1)])
    elems = np.array(elems, dtype=np.int64)

    bdr, battr = [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                if iz == 0:
                    bdr.append([vid(ix, iy, 0), vid(ix, iy + 1, 0),
                                vid(ix + 1, iy + 1, 0), vid(ix + 1, iy, 0)])
                    battr.append(1)
                if iy == 0:
                    bdr.append([vid(ix, 0, iz), vid(ix + 1, 0, iz),
                                vid(ix + 1, 0, iz + 1), vid(ix, 0, iz + 1)])
                    battr.append(2)
                if ix == nx - 1:
                    bdr.append([vid(nx, iy, iz), vid(nx, iy + 1, iz),
                                vid(nx, iy + 1, iz + 1), vid(nx, iy, iz + 1)])
                    battr.append(3)
                if iy == ny - 1:
                    bdr.append([vid(ix + 1, ny, iz), vid(ix, ny, iz),
                                vid(ix, ny, iz + 1), vid(ix + 1, ny, iz + 1)])
                    battr.append(4)
                if ix == 0:
                    bdr.append([vid(0, iy + 1, iz), vid(0, iy, iz),
                                vid(0, iy, iz + 1), vid(0, iy + 1, iz + 1)])
                    battr.append(5)
                if iz == nz - 1:
                    bdr.append([vid(ix, iy, nz), vid(ix + 1, iy, nz),
                                vid(ix + 1, iy + 1, nz), vid(ix, iy + 1, nz)])
                    battr.append(6)

    return Mesh(
        vertices=verts,
        elements=elems,
        kind="hex",
        attrib=np.ones(len(elems), dtype=np.int64),
        bdr_faces=np.array(bdr, dtype=np.int64),
        bdr_attrib=np.array(battr, dtype=np.int64),
    )


# ---------------------------------------------------------------------- #
# uniform refinement
# ---------------------------------------------------------------------- #
def _refine_hex(mesh: Mesh) -> Mesh:
    """Octasection of every hex. New vertices: edge midpoints, face centers,
    cell centers (deduplicated by vertex-key so the refined mesh is
    conforming)."""
    nv = mesh.num_vertices
    elems = mesh.elements
    verts = [mesh.vertices]
    key2id = {}
    next_id = nv

    def midpoint_id(vkey):
        nonlocal next_id
        vkey = tuple(sorted(vkey))
        if vkey not in key2id:
            key2id[vkey] = next_id
            verts.append(
                np.mean(mesh.vertices[list(vkey)], axis=0, keepdims=True))
            next_id += 1
        return key2id[vkey]

    new_elems = []
    new_attr = []
    for e in range(mesh.num_elements):
        v = elems[e]
        # lattice of 27 points of the refined hex, indexed (i,j,k) in {0,1,2}
        def lat(i, j, k):
            # corners
            corner = {(0, 0, 0): 0, (2, 0, 0): 1, (2, 2, 0): 2, (0, 2, 0): 3,
                      (0, 0, 2): 4, (2, 0, 2): 5, (2, 2, 2): 6, (0, 2, 2): 7}
            if (i, j, k) in corner:
                return v[corner[(i, j, k)]]
            # collect the corners this lattice point averages
            ii = [i] if i in (0, 2) else [0, 2]
            jj = [j] if j in (0, 2) else [0, 2]
            kk = [k] if k in (0, 2) else [0, 2]
            pts = [v[corner[(a, b, c)]] for a in ii for b in jj for c in kk]
            return midpoint_id(tuple(pts))

        for ck in range(2):
            for cj in range(2):
                for ci in range(2):
                    new_elems.append([
                        lat(ci, cj, ck), lat(ci + 1, cj, ck),
                        lat(ci + 1, cj + 1, ck), lat(ci, cj + 1, ck),
                        lat(ci, cj, ck + 1), lat(ci + 1, cj, ck + 1),
                        lat(ci + 1, cj + 1, ck + 1), lat(ci, cj + 1, ck + 1)])
                    new_attr.append(mesh.attrib[e])

    # boundary quads: split each into 4 children, inherit attribute
    new_bdr, new_battr = [], []
    for f in range(mesh.bdr_faces.shape[0]):
        a, b, c, d = mesh.bdr_faces[f]
        ab = midpoint_id((a, b)); bc = midpoint_id((b, c))
        cd = midpoint_id((c, d)); da = midpoint_id((d, a))
        ctr = midpoint_id((a, b, c, d))
        for quad in ([a, ab, ctr, da], [ab, b, bc, ctr],
                     [ctr, bc, c, cd], [da, ctr, cd, d]):
            new_bdr.append(quad)
            new_battr.append(mesh.bdr_attrib[f])

    return Mesh(
        vertices=np.concatenate(verts, axis=0),
        elements=np.array(new_elems, dtype=np.int64),
        kind="hex",
        attrib=np.array(new_attr, dtype=np.int64),
        bdr_faces=np.array(new_bdr, dtype=np.int64),
        bdr_attrib=np.array(new_battr, dtype=np.int64),
    )


def _refine_tet(mesh: Mesh) -> Mesh:
    """Octasection of every tet (4 corner tets + 4 interior tets around the
    shortest interior diagonal, fixed choice v01-v23)."""
    verts = [mesh.vertices]
    key2id = {}
    next_id = mesh.num_vertices

    def mid(a, b):
        nonlocal next_id
        k = (min(a, b), max(a, b))
        if k not in key2id:
            key2id[k] = next_id
            verts.append(np.mean(mesh.vertices[list(k)], axis=0,
                                 keepdims=True))
            next_id += 1
        return key2id[k]

    new_elems, new_attr = [], []
    for e in range(mesh.num_elements):
        v0, v1, v2, v3 = mesh.elements[e]
        m01, m02, m03 = mid(v0, v1), mid(v0, v2), mid(v0, v3)
        m12, m13, m23 = mid(v1, v2), mid(v1, v3), mid(v2, v3)
        children = [
            (v0, m01, m02, m03), (m01, v1, m12, m13),
            (m02, m12, v2, m23), (m03, m13, m23, v3),
            # interior octahedron split along diagonal m01-m23
            (m01, m12, m02, m23), (m01, m12, m23, m13),
            (m01, m02, m03, m23), (m01, m13, m23, m03),
        ]
        for ch in children:
            new_elems.append(ch)
            new_attr.append(mesh.attrib[e])

    new_bdr, new_battr = [], []
    for f in range(mesh.bdr_faces.shape[0]):
        a, b, c = mesh.bdr_faces[f]
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        for tri in ([a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]):
            new_bdr.append(tri)
            new_battr.append(mesh.bdr_attrib[f])

    return Mesh(
        vertices=np.concatenate(verts, axis=0),
        elements=np.array(new_elems, dtype=np.int64),
        kind="tet",
        attrib=np.array(new_attr, dtype=np.int64),
        bdr_faces=np.array(new_bdr, dtype=np.int64),
        bdr_attrib=np.array(new_battr, dtype=np.int64),
    )


# ---------------------------------------------------------------------- #
# readers
# ---------------------------------------------------------------------- #
def read_mesh(path) -> Mesh:
    with open(path) as f:
        head = f.readline().strip()
    if head.startswith("NETGEN"):
        return _read_netgen(path)
    if head.startswith("MFEM mesh"):
        return _read_mfem(path)
    raise ValueError(f"Unknown mesh format: {head!r}")


def _read_netgen(path) -> Mesh:
    """NETGEN neutral format (tets): nv, coords, ne, (attr v0 v1 v2 v3),
    nbf, (attr v0 v1 v2). 1-based vertex ids."""
    with open(path) as f:
        toks = f.read().split()
    assert toks[0] == "NETGEN_Neutral_Format"
    i = 1
    nv = int(toks[i]); i += 1
    verts = np.array(toks[i:i + 3 * nv], dtype=np.float64).reshape(nv, 3)
    i += 3 * nv
    ne = int(toks[i]); i += 1
    body = np.array(toks[i:i + 5 * ne], dtype=np.int64).reshape(ne, 5)
    i += 5 * ne
    attr = body[:, 0]
    elems = body[:, 1:] - 1
    nbf = int(toks[i]); i += 1
    bb = np.array(toks[i:i + 4 * nbf], dtype=np.int64).reshape(nbf, 4)
    battr = bb[:, 0]
    bdr = bb[:, 1:] - 1
    return Mesh(vertices=verts, elements=elems, kind="tet", attrib=attr,
                bdr_faces=bdr, bdr_attrib=battr)


def _read_mfem(path) -> Mesh:
    """Minimal MFEM v1.0 linear mesh reader (hex=5 / tet=4 geometries)."""
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f]
    lines = [ln for ln in lines if ln]

    def section(name):
        idx = lines.index(name)
        return idx + 1

    i = section("dimension")
    dim = int(lines[i])
    assert dim == 3, "only 3D MFEM meshes supported for now"

    i = section("elements")
    ne = int(lines[i])
    elems, attr = [], []
    kind = None
    for k in range(ne):
        parts = [int(x) for x in lines[i + 1 + k].split()]
        attr.append(parts[0])
        geom = parts[1]
        kind = {4: "tet", 5: "hex"}[geom]
        elems.append(parts[2:])

    i = section("boundary")
    nbf = int(lines[i])
    bdr, battr = [], []
    for k in range(nbf):
        parts = [int(x) for x in lines[i + 1 + k].split()]
        battr.append(parts[0])
        bdr.append(parts[2:])

    i = section("vertices")
    nv = int(lines[i])
    vdim = int(lines[i + 1])
    verts = np.array(
        [[float(x) for x in lines[i + 2 + k].split()] for k in range(nv)])
    if vdim < 3:
        verts = np.pad(verts, ((0, 0), (0, 3 - vdim)))

    return Mesh(vertices=verts, elements=np.array(elems, dtype=np.int64),
                kind=kind, attrib=np.array(attr, dtype=np.int64),
                bdr_faces=np.array(bdr, dtype=np.int64),
                bdr_attrib=np.array(battr, dtype=np.int64))


# ---------------------------------------------------------------------- #
# 2D quadrilateral meshes (reference DeRhamSequence2D_Hdiv_FE support)
# ---------------------------------------------------------------------- #
def quad_grid_mesh(nx, ny, sx=1.0, sy=1.0) -> Mesh:
    """Cartesian quad mesh of [0,sx]x[0,sy], embedded at z=0.

    mfem Mesh::Make2D conventions: vertex index = ix + iy*(nx+1); boundary
    attributes y=0 ->1, x=sx ->2, y=sy ->3, x=0 ->4."""
    xs = np.linspace(0, sx, nx + 1)
    ys = np.linspace(0, sy, ny + 1)
    verts = np.zeros(((nx + 1) * (ny + 1), 3))
    for iy in range(ny + 1):
        for ix in range(nx + 1):
            verts[ix + iy * (nx + 1), 0] = xs[ix]
            verts[ix + iy * (nx + 1), 1] = ys[iy]

    def vid(ix, iy):
        return ix + iy * (nx + 1)

    elems = []
    for iy in range(ny):
        for ix in range(nx):
            elems.append([vid(ix, iy), vid(ix + 1, iy),
                          vid(ix + 1, iy + 1), vid(ix, iy + 1)])

    bdr, battr = [], []
    for iy in range(ny):
        for ix in range(nx):
            if iy == 0:
                bdr.append([vid(ix, 0), vid(ix + 1, 0)]); battr.append(1)
            if ix == nx - 1:
                bdr.append([vid(nx, iy), vid(nx, iy + 1)]); battr.append(2)
            if iy == ny - 1:
                bdr.append([vid(ix + 1, ny), vid(ix, ny)]); battr.append(3)
            if ix == 0:
                bdr.append([vid(0, iy + 1), vid(0, iy)]); battr.append(4)

    return Mesh(
        vertices=verts,
        elements=np.array(elems, dtype=np.int64),
        kind="quad",
        attrib=np.ones(len(elems), dtype=np.int64),
        bdr_faces=np.array(bdr, dtype=np.int64),
        bdr_attrib=np.array(battr, dtype=np.int64),
    )


def _refine_quad(mesh: Mesh) -> Mesh:
    """Quadsection of every quad, children contiguous per parent."""
    verts = [mesh.vertices]
    key2id = {}
    next_id = mesh.num_vertices

    def mid(vkey):
        nonlocal next_id
        vkey = tuple(sorted(vkey))
        if vkey not in key2id:
            key2id[vkey] = next_id
            verts.append(np.mean(mesh.vertices[list(vkey)], axis=0,
                                 keepdims=True))
            next_id += 1
        return key2id[vkey]

    new_elems, new_attr = [], []
    for e in range(mesh.num_elements):
        a, b, c, d = mesh.elements[e]
        ab, bc, cd, da = mid((a, b)), mid((b, c)), mid((c, d)), mid((d, a))
        ctr = mid((a, b, c, d))
        for quad in ([a, ab, ctr, da], [ab, b, bc, ctr],
                     [ctr, bc, c, cd], [da, ctr, cd, d]):
            new_elems.append(quad)
            new_attr.append(mesh.attrib[e])

    new_bdr, new_battr = [], []
    for f in range(mesh.bdr_faces.shape[0]):
        a, b = mesh.bdr_faces[f]
        m = mid((a, b))
        for seg in ([a, m], [m, b]):
            new_bdr.append(seg)
            new_battr.append(mesh.bdr_attrib[f])

    return Mesh(
        vertices=np.concatenate(verts, axis=0),
        elements=np.array(new_elems, dtype=np.int64),
        kind="quad",
        attrib=np.array(new_attr, dtype=np.int64),
        bdr_faces=np.array(new_bdr, dtype=np.int64),
        bdr_attrib=np.array(new_battr, dtype=np.int64),
    )
