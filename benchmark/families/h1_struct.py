"""The H1 structured family through the program's flagship path.

Operators: flagship.build_h1_structured (amge/structured.py's chain,
the boundary elimination and its Galerkin propagation); hierarchy:
flagship.build_solver (DIA operators, bf16 BCSR transfers, l1-Jacobi
V(2,2), the bf16 copy as the preconditioner) and flagship.compile_solve
(f32 PCG as one CUDA graph on the card).  A call solves one pool entry:
b (n,) or, with several right-hand sides a call, (n, s) by block PCG,
and waits for x on the device.

The right-hand sides: each cell's source f_c (traffic.source_pool)
assembled to the Q1 load vector, b_v = h^3 / 8 * sum of f_c over the
cells at vertex v, zero on the Dirichlet walls (x and y).
"""

import numpy as np
import torch

from benchmark import port
from benchmark.roofline import Probe, csr_nnz


def q1_load(src, n):
    """(s, n, n, n) cell sources [z, y, x] -> (N, s) load vectors with
    the x and y walls zeroed, N = (n+1)^3 (x fastest)."""
    s = src.shape[0]
    b = torch.zeros((s, n + 1, n + 1, n + 1), dtype=src.dtype,
                    device=src.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                b[:, dz:dz + n, dy:dy + n, dx:dx + n] += src
    b *= (1.0 / n) ** 3 / 8.0
    b[:, :, :, 0] = 0
    b[:, :, :, n] = 0
    b[:, :, 0, :] = 0
    b[:, :, n, :] = 0
    return b.reshape(s, -1).T.contiguous()


def _require(config, key, value):
    if config[key] != value:
        raise ValueError(f"configuration {key}={config[key]!r}, the "
                         f"program runs {value!r}")


class Family:
    def __init__(self, config, mix, device, spans):
        from parelag_tpu_torch import flagship
        self.flagship = flagship
        self.config, self.mix, self.device = config, mix, device
        self.n = n = int(config["cells_per_axis"])
        _require(config, "rtol", flagship.RTOL)
        _require(config, "maxiter", flagship.MAXITER)
        _require(config, "cycle", flagship.CYCLE)
        port.load_kernels(device)
        with spans("setup.operators"):
            A_levels, P_levels, _ = flagship.build_h1_structured(
                n, int(config["min_coarse_cells"]), np.float32, device)
        self.nnz0 = csr_nnz(A_levels[0])
        with spans("setup.hierarchy"):
            self.H, self.Hb = flagship.build_solver(A_levels, P_levels,
                                                    device)
        if len(self.H.levels) != int(config["levels"]):
            raise ValueError(f"{len(self.H.levels)} levels, the "
                             f"configuration states {config['levels']}")
        self.spans = spans
        self.compiled = None

    def load_inputs(self, seed):
        """The pool of right-hand sides from the seed, then the solve
        compiled for its shape and warmed up."""
        from benchmark import traffic
        s = int(self.mix["rhs_per_call"])
        self.pool = []
        for src in traffic.source_pool(self.mix, seed, (self.n,) * 3,
                                       self.device):
            b = q1_load(src, self.n)
            self.pool.append(b[:, 0].contiguous() if s == 1 else b)
        with self.spans("setup.hierarchy"):
            self.compiled = self.flagship.compile_solve(self.H, self.Hb,
                                                        self.pool[0])
        for i in range(2):
            self.call(i)

    def call(self, i):
        x, (it, _) = self.compiled(self.pool[i % len(self.pool)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(rhs=int(self.mix["rhs_per_call"]), iters=int(it),
                    converged=int(it) < self.flagship.MAXITER, answer=x)

    def check_window(self):
        pass

    def sample(self, i, x):
        return {"b": self.pool[i % len(self.pool)], "x": x}

    def probes(self):
        """The fine operator the PCG applies (f32) and one sweep of the
        bf16 preconditioner's fine smoother, at the cell's shape."""
        b = self.pool[0]
        cols = 1 if b.ndim == 1 else b.shape[1]
        n = b.shape[0]
        A0 = self.H.levels[0].A
        x = torch.randn_like(b)
        out = {"a0_apply": Probe(lambda: A0.matvec(x),
                                 self.nnz0 * 4 + 2 * n * cols * 4)}
        lvl = self.Hb.levels[0]
        if hasattr(lvl.A, "jacobi_sweeps") and hasattr(lvl.pre, "dinv"):
            dw = (lvl.pre.omega * lvl.pre.dinv).to(torch.bfloat16)
            xb, bb = x.to(torch.bfloat16), b.to(torch.bfloat16)
            out["a0_smooth"] = Probe(
                lambda: lvl.A.jacobi_sweeps(bb, xb, dw, 1),
                self.nnz0 * 2 + (3 * cols + 1) * n * 2)
        return out

    def close(self):
        self.H = self.Hb = self.compiled = None
