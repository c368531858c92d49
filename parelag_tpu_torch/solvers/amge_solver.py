"""AMGe solver construction from a DeRhamSequence chain (PyTorch).

Counterpart of parelag_tpu/solvers/amge_solver.py, a rebuild of the
reference AMGeSolverFactory::_do_build_solver
(factories/ParELAG_AMGeSolverFactory.cpp:49-163) +
buildHierarchyFromDeRhamSequence (ParELAG_Hierarchy.cpp:282-385): walk the
sequence chain, P_l = seq_l.P[form], A_{l+1} = P^T A_l P with BC zero-row
fix, smoothers per level (l1-Jacobi, or Hiptmair for forms with a
potential space), dense direct solve at the coarsest level.  Each
smoother is built from its level's operator in the hierarchy's dtype, as
the JAX package's are on the TPU (the host RAP of an f32 A and an f64 P
is f64).  reorder="rcm" permutes every level (build_hierarchy) and
amge_pcg_solve solves in the permuted space.  compile_amge_pcg compiles
the solve once for many right-hand sides (on the card one CUDA graph).
"""

import numpy as np
import scipy.sparse as sp
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.solvers import smoothers as sm
from parelag_tpu_torch.solvers.cg import compile_pcg
from parelag_tpu_torch.solvers.hierarchy import build_hierarchy, rap


def build_amge_hierarchy(seqs, form, A_fine, smoother="l1jacobi",
                         sweeps=2, mu=1, dtype=np.float64,
                         cheby_degree=3, matrix_format="auto",
                         reorder=None, transfer_dtype=None, device=None):
    """seqs: list of DeRhamSequence levels (finest first); A_fine: assembled
    + BC-eliminated fine operator. Returns (Hierarchy, A_levels, P_levels)
    with the Hierarchy on `device` (None: the card).

    smoother: 'l1jacobi' | 'chebyshev' | 'hiptmair' (Hiptmair uses the
    potential-space derivative D[form-1] coarsened per level, the
    reference HiptmairSmootherFactory pattern); reorder='rcm' permutes
    every level (not with Hiptmair: its auxiliary derivative is not
    permuted)."""
    device = resolve_device(device)
    if smoother == "hiptmair" and reorder:
        raise ValueError("reorder folds into A/P only; the Hiptmair aux "
                         "derivative is not permuted")
    n_lev = len(seqs)
    A_levels = [sp.csr_matrix(A_fine)]
    P_levels = []
    for l in range(n_lev - 1):
        P = seqs[l].P[form]
        P_levels.append(P)
        A_levels.append(rap(A_levels[l], P))

    def factory(A, l):
        if smoother == "l1jacobi":
            return sm.make_l1_jacobi(sp.csr_matrix(A).astype(dtype),
                                     sweeps=sweeps, device=device)
        if smoother == "chebyshev":
            return sm.make_chebyshev(sp.csr_matrix(A).astype(dtype),
                                     degree=cheby_degree, device=device)
        if smoother == "hiptmair":
            D = seqs[l].D[form - 1]
            return sm.make_hiptmair(A, D, dtype=dtype, device=device)
        raise ValueError(smoother)

    H = build_hierarchy(A_levels, P_levels, factory, mu=mu, dtype=dtype,
                        matrix_format=matrix_format, reorder=reorder,
                        transfer_dtype=transfer_dtype, device=device)
    return H, A_levels, P_levels


def build_ml_hiptmair(seqs, form, A_fine, sweeps=1, mu=1,
                      dtype=np.float64, matrix_format="auto", device=None):
    """MLHiptmairSolver analog (reference ParELAG_MLHiptmairSolver.hpp:
    34-130, templated on problem type): multilevel MG on the `form` space
    with Hiptmair two-space smoothing at EVERY level — the auxiliary space
    reached through the potential derivative D[form-1] coarsened along the
    sequence chain. Template instances: form=1 (Hcurl, H1 potentials) and
    form=2 (Hdiv, Hcurl potentials). Returns (Hierarchy, A_levels,
    P_levels); solve with amge_pcg_solve."""
    if form < 1:
        raise ValueError("Hiptmair needs a potential space (form >= 1)")
    return build_amge_hierarchy(
        seqs, form, A_fine, smoother="hiptmair", sweeps=sweeps, mu=mu,
        dtype=dtype, matrix_format=matrix_format, device=device)


def compile_amge_pcg(H, A, b_like, rtol=1e-6, atol=1e-12, maxiter=500):
    """amge_pcg_solve compiled once for b_like's shape, dtype and device
    (solvers/cg.compile_pcg: on the card one CUDA graph with the loop on
    the device): PCG on A (A reordered H: its own level-0 operator) with
    one cycle of H as the preconditioner; the permutations stay outside
    the graph.  Returns solve(b) -> (x as numpy, (iterations, r.z)) with
    the CompiledPcg as solve.compiled."""
    if H.perm is not None:
        A = H.levels[0].A
    compiled = compile_pcg(A.matvec, b_like.to(A.dtype), precond=H.apply,
                           rtol=rtol, atol=atol, maxiter=maxiter)

    def solve(b):
        bt = torch.as_tensor(b).to(device=compiled.device, dtype=A.dtype)
        if H.perm is not None:
            bt = bt[H.perm]
        x, info = compiled(bt)
        if H.iperm is not None:
            x = x[H.iperm]
        return x.cpu().numpy(), info

    solve.compiled = compiled
    return solve


def amge_pcg_solve(H, A, b, rtol=1e-6, atol=1e-12, maxiter=500,
                   device=None):
    """PCG with one MG cycle of H as preconditioner (the reference's
    'Krylov + AMGe preconditioner' composition, CreateXFormParameterList)
    on the device operator A (e.g. H.levels[0].A), both on `device`
    (None: the card); b (n,) numpy or tensor, taken in A's dtype.  The
    solve is compiled for this b and run once (compile_amge_pcg), as the
    JAX version jits its solve.  A reordered H (H.perm) solves in its
    permuted space on its own level-0 operator (A is then not used):
    b[perm] in, x[iperm] out.  Returns (x as numpy, (iterations,
    r.z))."""
    device = resolve_device(device)
    bt = torch.as_tensor(b).to(device)
    return compile_amge_pcg(H, A, bt, rtol=rtol, atol=atol,
                            maxiter=maxiter)(bt)
