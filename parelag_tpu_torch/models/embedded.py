"""Embedded-interface partitioning demo.

Rebuild of reference examples/EmbeddedMeshPartitionerDemo.cpp: agglomerate
a mesh that contains an embedded material interface (element attributes) so
that no agglomerate crosses the interface
(MetisMaterialId/CoarsenMetisMaterialId + LogicalPartitioner,
EmbeddedMeshPartitionerDemo.cpp:217-270), then run the H1 upscaling
pipeline on the material-aligned coarse spaces.
"""

from dataclasses import replace

import numpy as np

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.partitioning.partitioners import graph_partition


def material_partition(el_el, attrs, n_parts, seed=0):
    """Partition each material region independently (the MetisMaterialId
    pattern: METIS runs per material, ids concatenated)."""
    import scipy.sparse as sp
    el_el = sp.csr_matrix(el_el)
    attrs = np.asarray(attrs)
    out = np.zeros(attrs.size, dtype=np.int64)
    nxt = 0
    total = attrs.size
    for a in np.unique(attrs):
        sel = np.where(attrs == a)[0]
        sub = el_el[sel][:, sel]
        k = max(1, round(n_parts * sel.size / total))
        out[sel] = nxt + graph_partition(sub, k, seed=seed)
        nxt += k
    return out


def embedded_ball_mesh(n=4, nref=1):
    """Cube [-2,2]^3 with a unit ball marked attribute 1 (else 2)."""
    base = hex_grid_mesh(n, n, n, sx=4.0, sy=4.0, sz=4.0)
    mesh = replace(base, vertices=base.vertices - 2.0)
    for _ in range(nref):
        mesh = mesh.uniform_refinement()
    centers = mesh.vertices[mesh.elements].mean(axis=1)
    attrib = np.where(np.linalg.norm(centers, axis=1) <= 1.0, 1, 2)
    return replace(mesh, attrib=attrib.astype(np.int64))


def embedded_demo(n=4, nref=1, n_parts=16, svd_tol=1e-9):
    """Material-aligned agglomeration + one H1 AMGe coarsening. Returns
    (topo, coarse_topo, seq, per-AE attribute array)."""
    mesh = embedded_ball_mesh(n, nref)
    topo = AgglomeratedTopology.from_mesh(mesh)
    part = material_partition(topo.local_element_element(), mesh.attrib,
                              n_parts)
    # shell-shaped material regions produce non-simply-connected
    # agglomerates; check_topology deagglomerates them (the reference's
    # MarkBadAgglomeratedEntities + DeAgglomerate path)
    coarse = topo.coarsen_local_partitioning(
        part, check_topology=True, preserve_material_interfaces=True)
    seq = DeRhamSequenceFE(topo, mesh)
    seq.set_upscaling_targets(0)
    seq.coarsen(svd_tol=svd_tol)

    AE_e = topo.AEntity_entity[0].tocsr()
    ae_attr = np.array(
        [np.unique(mesh.attrib[
            AE_e.indices[AE_e.indptr[i]:AE_e.indptr[i + 1]]])
         for i in range(AE_e.shape[0])], dtype=object)
    return topo, coarse, seq, ae_attr
