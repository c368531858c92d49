"""Random-permeability sample generation (HdivL2SampleGenerator analog).

Reference: examples/HdivL2SampleGenerator.cpp:218-388 — draw random
log-normal permeability realizations, build the inverse-permeability-weighted
Hdiv-L2 Darcy problem, and produce upscaled samples by solving on the coarse
AMGe spaces (the multilevel-Monte-Carlo use case of ParElag). Here a sampler
object owns the hierarchy topology and regenerates only the
coefficient-dependent pieces per sample.
"""

import numpy as np

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge.hybridization import HybridHdivL2
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.partitioning.partitioners import refined_mesh_partition


class HdivL2SampleGenerator:
    def __init__(self, nref=1, n_levels=2, seed=0, log_sigma=1.0,
                 corr_cells=2, svd_tol=1e-9):
        mesh = hex_grid_mesh(2, 2, 2)
        level_ne = []
        for _ in range(nref):
            level_ne.append(mesh.num_elements)
            mesh = mesh.uniform_refinement()
        level_ne = [mesh.num_elements] + level_ne[::-1]
        self.mesh = mesh
        self.topos = [AgglomeratedTopology.from_mesh(mesh)]
        for il in range(n_levels - 1):
            self.topos.append(self.topos[il].coarsen_local_partitioning(
                refined_mesh_partition(self.topos[il].num_entities(0),
                                       level_ne[il + 1])))
        self.n_levels = n_levels
        self.svd_tol = svd_tol
        self.rng = np.random.RandomState(seed)
        self.log_sigma = log_sigma
        self.corr = corr_cells
        self.vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])

    def draw_coefficient(self):
        """Smooth log-normal inverse permeability field sample."""
        ne = self.mesh.num_elements
        cent = self.mesh.vertices[self.mesh.elements].mean(axis=1)
        # low-rank smooth random field: random cosine features
        kmax = 3
        field = np.zeros(ne)
        for _ in range(8):
            k = self.rng.randint(1, kmax + 1, size=3)
            phase = self.rng.rand(3) * 2 * np.pi
            amp = self.rng.randn() / np.sqrt(8)
            field += amp * np.cos(
                2 * np.pi * (cent * k).sum(axis=1) + phase.sum())
        kinv_cells = np.exp(self.log_sigma * field)

        def kinv(p):
            # piecewise-constant per element; p is (ne, nq, 3)
            return np.broadcast_to(kinv_cells[:, None],
                                   p.shape[:-1]).copy()
        return kinv, kinv_cells

    def sample(self):
        """One (fine solution, coarse upscaled solution) Darcy sample.
        Returns dict with u/p per level and the upscaling error."""
        kinv, cells = self.draw_coefficient()
        seq0 = DeRhamSequenceFE(self.topos[0], self.mesh)
        seq0.jform_start = 2
        seq0.replace_mass_integrator(2, kinv)
        seq0.set_upscaling_targets(0)
        seqs = [seq0]
        for il in range(self.n_levels - 1):
            seqs.append(seqs[il].coarsen(svd_tol=self.svd_tol))

        rhs_u = [np.zeros(seqs[0].dof[2].ndofs)]
        rhs_p = [self.vols.copy()]
        for i in range(self.n_levels - 1):
            rhs_u.append(seqs[i].P[2].T @ rhs_u[i])
            rhs_p.append(seqs[i].P[3].T @ rhs_p[i])
        out = {"u": [], "p": [], "kinv": cells}
        for k in range(self.n_levels):
            hyb = HybridHdivL2(seqs[k])
            u, p = hyb.solve(rhs_u[k], rhs_p[k], solver="cg", rtol=1e-10,
                             rescale=True)
            out["u"].append(u)
            out["p"].append(p)
        hu = out["u"][-1]
        for j in range(self.n_levels - 1, 0, -1):
            hu = seqs[j - 1].P[2] @ hu
        M = seqs[0].compute_mass_operator(2)
        d = hu - out["u"][0]
        un = out["u"][0]
        out["u_l2_rel_err"] = float(
            np.sqrt(d @ (M @ d)) / np.sqrt(un @ (M @ un)))
        return out
