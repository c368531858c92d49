"""MultigridTest{0,1,2}Form equivalents: AMGe V-cycle solver drivers
(PyTorch).

Counterpart of parelag_tpu/models/multigrid.py (reference
examples/MultigridTest{0,1,2}Form.cpp): build the multilevel de Rham
hierarchy, assemble A = M + D^T W D for the form, build the AMGe
multigrid solver (V-cycle with smoothers; Hiptmair smoothing for forms
1/2) in f64 on the device, and solve there: solvers/cg.compile_pcg (on
the card one CUDA graph) with one cycle as the preconditioner, or the
plain cycle loop (use_pcg=False).  The
acceptance criteria are the JAX package's: convergence to rtol and a
bounded V-cycle convergence factor, with its golden iteration counts
(tests/test_solvers.py).
"""

from dataclasses import dataclass

import numpy as np
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.models.upscaling import (
    build_hierarchy as build_seq_hierarchy, mark_dofs_on_bndr,
    boundary_rhs, eliminate_rowcols)
from parelag_tpu_torch.solvers.amge_solver import build_amge_hierarchy
from parelag_tpu_torch.solvers.cg import compile_pcg


@dataclass
class MGResult:
    iterations: int
    final_residual: float
    conv_factor: float
    ndofs: int


def multigrid_test_form(form, nref=2, smoother=None, sweeps=2,
                        rtol=1e-6, atol=1e-12, mu=1,
                        use_pcg=True, device=None) -> MGResult:
    """MultigridTest<form>Form at nref refinements of the 2x2x2 cube, the
    hierarchy and the solve on `device` (None: the card)."""
    device = resolve_device(device)
    mesh, topos, seqs = build_seq_hierarchy(nref_parallel=nref)
    if smoother is None:
        smoother = "hiptmair" if form in (1, 2) else "l1jacobi"

    M = seqs[0].compute_mass_operator(form)
    W = seqs[0].compute_mass_operator(form + 1)
    D = seqs[0].D[form]
    A = (M + D.T @ W @ D).tocsr()
    ess = {2, 3, 4, 5}
    nat = {1: (1.0, 1.0, 1.0)} if form == 1 else {1: -1.0}
    b = boundary_rhs(seqs[0], form, nat)
    marker = mark_dofs_on_bndr(seqs[0], form, ess)
    A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))

    H, A_levels, _ = build_amge_hierarchy(
        seqs, form, A, smoother=smoother, sweeps=sweeps, mu=mu,
        device=device)
    A_dev = H.levels[0].A
    bt = torch.as_tensor(b).to(device)

    r0 = float(np.linalg.norm(b))
    if use_pcg:
        x, (it, nom) = compile_pcg(A_dev.matvec, bt, precond=H.apply,
                                   rtol=rtol, atol=atol, maxiter=200)(bt)
        res = float(np.linalg.norm(b - A @ x.cpu().numpy()))
        it = int(it)
        conv = (res / r0) ** (1.0 / max(it, 1))
    else:
        x = torch.zeros_like(bt)
        res_hist = [r0]
        it = 0
        while it < 200 and res_hist[-1] > rtol * r0:
            x = H.cycle(bt, x)
            res_hist.append(float(np.linalg.norm(b - A @ x.cpu().numpy())))
            it += 1
        res = res_hist[-1]
        conv = (res / r0) ** (1.0 / max(it, 1))
    return MGResult(it, res, conv, A.shape[0])
