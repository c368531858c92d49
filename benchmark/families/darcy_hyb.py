"""The hybridized mixed Darcy family through HybridHdivL2.solve.

Operators: the hex mesh, its topology, the de Rham sequence's local
masses (mesh/, topology/, amge/fespace.py) and HybridHdivL2's batched
element elimination, as darcy_lane builds them; hierarchy:
HybridHdivL2._device_setup (the padded multiplier system, the facet
block-Jacobi smoother, solvers/sa_amg.build_device_sa_hierarchy),
timed on the first solve, which builds it.  A call is
HybridHdivL2.solve(0, f, solver="device", rtol, rescale=True): the
hybridization's host transform, the SA-AMG PCG on the card inside f64
host refinement, the recovery, and (u, p) on the host.

The right-hand sides: rhs_u = 0 and rhs_p = each cell's source
(traffic.source_pool) times the cell's volume.
"""

import numpy as np
import torch

from benchmark import port
from benchmark.roofline import Probe, csr_nnz


class Family:
    def __init__(self, config, mix, device, spans):
        from parelag_tpu_torch.amge import hexfe
        from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
        from parelag_tpu_torch.amge.hybridization import HybridHdivL2
        from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
        from parelag_tpu_torch.topology.topology import AgglomeratedTopology
        if int(mix["rhs_per_call"]) != 1:
            raise ValueError("HybridHdivL2.solve takes one right-hand "
                             "side a call")
        self.config, self.mix, self.device = config, mix, device
        self.n = n = int(config["cells_per_axis"])
        self.rtol = float(config["rtol"])
        port.load_kernels(device)
        with spans("setup.operators"):
            mesh = hex_grid_mesh(n, n, n)
            topo = AgglomeratedTopology.from_mesh(mesh)
            seq = DeRhamSequenceFE(topo, mesh)
            seq.jform_start = 2
            self.hyb = HybridHdivL2(seq)
            self.vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
        self.HybridHdivL2 = HybridHdivL2
        self.spans = spans
        self.rhs_u = np.zeros(self.hyb.nu)

    def load_inputs(self, seed):
        """The pool of sources from the seed, then two solves: the first
        builds the device set-up (timed as the hierarchy), the second
        must find it built."""
        from benchmark import traffic
        self.pool = [src.reshape(-1).double().cpu().numpy() * self.vols
                     for src in traffic.source_pool(
                         self.mix, seed, (self.n,) * 3, self.device)]
        hyb, spans = self.hyb, self.spans
        build = self.HybridHdivL2._device_setup.__get__(hyb)

        def timed(*a, **k):
            with spans("setup.hierarchy"):
                return build(*a, **k)

        hyb._device_setup = timed
        try:
            self.call(0)
        finally:
            del hyb._device_setup
        self.cache = hyb._dev_cache
        self.call(1)
        self.check_window()

    def call(self, i):
        hyb = self.hyb
        u, p = hyb.solve(self.rhs_u, self.pool[i % len(self.pool)],
                         solver="device", rtol=self.rtol, rescale=True,
                         device=self.device)
        info = hyb.last_device
        return dict(rhs=1, iters=int(info["iters"]),
                    converged=info["rel_res"] <= self.rtol, answer=(u, p))

    def check_window(self):
        """The window's solves ran on the set-up that the warm-up built."""
        if self.hyb._dev_cache is not self.cache:
            raise RuntimeError("HybridHdivL2 rebuilt its device set-up "
                               "after the warm-up")

    def sample(self, i, answer):
        u, p = answer or (None, None)
        return {"f": self.pool[i % len(self.pool)], "u": u, "p": p}

    def probes(self):
        """The operator the PCG applies (the padded, permuted multiplier
        system, f32) at the cell's shape; its nonzeros from a host CSR
        copy of the free multiplier block plus the identity padding."""
        hyb = self.hyb
        Hd = hyb.last_operator
        npad = int(hyb.last_device["npad"])
        keep = ~hyb.ess_mult
        nnz = csr_nnz(hyb.hybrid_system[keep][:, keep]) + npad - int(
            keep.sum())
        dtype = getattr(torch, hyb.last_device["dtype"])
        size = torch.empty((), dtype=dtype).element_size()
        x = torch.randn(npad, dtype=dtype, device=self.device)
        return {"a0_apply": Probe(lambda: Hd.matvec(x),
                                  (nnz + 2 * npad) * size)}

    def close(self):
        self.hyb = None
