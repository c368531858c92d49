"""The XML solver library on the card: the reference example chain and
the compositions its example programs build from parameter lists.

    python -m parelag_tpu_torch.library_lane              # 64^3, 32^3
    python -m parelag_tpu_torch.library_lane --nref 3 --darcy-nref 2 \
        --device cpu

The chain is the example drivers' (models/upscaling.build_hierarchy):
hex_grid_mesh(2, 2, 2) refined nref times (nref 5: 64^3 cells, 6 levels;
274,625 H1, 811,200 H(curl) and 798,720 H(div) dofs before boundary
elimination), derefinement agglomerates, every level's pass 2 on the
device (backend 'device').  On it, the form-F problem of the examples
(A = M_F + D_F^T M_{F+1} D_F, natural data on attribute 1, essential on
2-5) is solved through solvers/library.SolverLibrary in f64 by each
composition of SCALAR: PCG + AMGe (V-cycle, PreSmoother Hypre L1
Gauss-Seidel with 2 sweeps, the composition of tests/test_library.py),
PCG + AMS (form 1) and PCG + ADS (form 2).  The Darcy saddle problem
(models/darcy.build_darcy_hierarchy at darcy_nref, derefinement
agglomerates, unit source) is solved by each of DARCY: GMRES + the
two-form blocked AMGe and Hybridization with the inner CG_PCG-AMG (PCG
+ BoomerAMG, an SA-AMG hierarchy on the multiplier system).

Each composition's record: setup_s (build_solver: host RAP and the
device hierarchy), iters, rel_res (the true f64 relative residual on the
host), first_solve_s (the first solve(), which also builds the Krylov
operator on the device) and solve_s (a second solve(); both by CUDA
events on the card, the host clock on the CPU), executed_on, kernels (the hand kernels launched by its setup and
solve), formats and transfers of its hierarchy's levels.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from parelag_tpu_torch import resolve_device, synchronize
from parelag_tpu_torch.ops import hopper_kernels
from parelag_tpu_torch.solvers.library import (
    Block2x2Operator, SolverLibrary, SolverState)

#: the reference example size: 2^3 cells refined 5 times
LIB_NREF = 5
#: the Darcy compositions' refinements: 32^3 cells
DARCY_NREF = 4
#: every composition's stop rule and cap
RTOL, MAXITER = 1e-8, 300


def _krylov(name, prec):
    return {"Type": "Krylov", "Solver Parameters": {
        "Solver name": name, "Preconditioner": prec,
        "Relative tolerance": RTOL, "Maximum iterations": MAXITER}}


#: composition name -> (form, library entries, the entry built)
SCALAR = {
    "PCG-AMGe-L1GS": (0, {
        "PCG-AMGe": _krylov("PCG", "AMGe-L1GS"),
        "AMGe-L1GS": {"Type": "AMGe", "Solver Parameters": {
            "PreSmoother": "L1GS", "PostSmoother": "L1GS",
            "Cycle type": "V-cycle"}},
        "L1GS": {"Type": "Hypre", "Solver Parameters": {
            "Type": "L1 Gauss-Seidel", "Sweeps": 2}},
    }, "PCG-AMGe"),
    "PCG-AMS": (1, {"PCG-AMS": _krylov("PCG", "AMS"),
                    "AMS": {"Type": "AMS", "Solver Parameters": {}}},
                "PCG-AMS"),
    "PCG-ADS": (2, {"PCG-ADS": _krylov("PCG", "ADS"),
                    "ADS": {"Type": "ADS", "Solver Parameters": {}}},
                "PCG-ADS"),
}
#: composition name -> (library entries, the entry built)
DARCY = {
    "GMRES-AMGe-Blk": ({
        "GMRES-AMGe": _krylov("GMRES", "AMGe-Blk"),
        "AMGe-Blk": {"Type": "AMGe", "Solver Parameters": {
            "Forms": [2, 3]}},
    }, "GMRES-AMGe"),
    "Hybridization-CG_PCG-AMG": ({
        "Hybridization": {"Type": "Hybridization", "Solver Parameters": {
            "Solver": "CG_PCG-AMG", "RescaleIteration": 1}},
        "CG_PCG-AMG": _krylov("PCG", "AMG"),
        "AMG": {"Type": "BoomerAMG", "Solver Parameters": {}},
    }, "Hybridization"),
}


def build_chain(nref, device=None):
    """The example chain with pass 2 on `device` (None: the card):
    (mesh, seqs, seconds)."""
    from parelag_tpu_torch.models.upscaling import build_hierarchy
    device = resolve_device(device)
    t0 = time.perf_counter()
    mesh, _, seqs = build_hierarchy(nref_parallel=nref, backend="device",
                                    device=device)
    return mesh, seqs, time.perf_counter() - t0


def scalar_problem(seqs, form):
    """The examples' form-`form` system on the finest level, essential
    dofs eliminated: (A, b)."""
    from parelag_tpu_torch.models.upscaling import (
        boundary_rhs, eliminate_rowcols, mark_dofs_on_bndr)
    s = seqs[0]
    A = (s.compute_mass_operator(form) + s.D[form].T
         @ s.compute_mass_operator(form + 1) @ s.D[form]).tocsr()
    nat = {1: (1.0, 1.0, 1.0)} if form == 1 else {1: -1.0}
    b = boundary_rhs(s, form, nat)
    marker = mark_dofs_on_bndr(s, form, {2, 3, 4, 5})
    return eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))


def darcy_problem(nref):
    """The Darcy saddle system [[M, B^T], [B, 0]] with a unit source on
    its derefinement chain: (Block2x2Operator, b, seqs, seconds)."""
    from parelag_tpu_torch.amge import hexfe
    from parelag_tpu_torch.models.darcy import build_darcy_hierarchy
    t0 = time.perf_counter()
    mesh, _, seqs = build_darcy_hierarchy(
        nref_parallel=nref, partition="derefine", aggressive_levels=0)
    s = seqs[0]
    M = s.compute_mass_operator(2)
    B = (s.compute_mass_operator(3) @ s.D[2]).tocsr()
    op = Block2x2Operator(M, B.T.tocsr(), B)
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    b = np.concatenate([np.zeros(M.shape[0]), vols])
    return op, b, seqs, time.perf_counter() - t0


def hierarchy_of(solver):
    """The device hierarchy a composition's cycles run (the Krylov
    preconditioner's, the hybridization's inner one's), or None."""
    for s in (solver, getattr(solver, "_inner_solver", None)):
        H = getattr(getattr(s, "_prec", None), "_H", None)
        if H is not None:
            return H
    return None


def _timed_solve(solver, b, dev):
    """(x in f64, seconds) of solver.solve(b): CUDA events on the card,
    the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x = solver.solve(b)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        x = solver.solve(b)
        secs = time.perf_counter() - t0
    return np.asarray(x, dtype=np.float64), secs


def run_composition(entries, entry, op, A, b, state):
    """Build and solve one composition: (record, solver, x)."""
    dev = state.device
    before = dict(hopper_kernels.LAUNCHES)
    t0 = time.perf_counter()
    solver = SolverLibrary.create_library(entries) \
        .get_solver_factory(entry).build_solver(op, state)
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    # the first solve builds the Krylov operator on the device
    # (_KrylovSolver._device_plan); the second is the solve itself
    (x, first_s), (x, solve_s) = (_timed_solve(solver, b, dev)
                                  for _ in range(2))
    H = hierarchy_of(solver)
    rec = dict(
        entry=entry, n=int(A.shape[0]), setup_s=setup_s,
        iters=int(solver.iterations), first_solve_s=first_s,
        solve_s=solve_s,
        rel_res=float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
        executed_on=solver.executed_on,
        kernels={k: hopper_kernels.LAUNCHES[k] - before[k]
                 for k in hopper_kernels.LAUNCHES},
        formats=None if H is None else [type(l.A).__name__
                                        for l in H.levels],
        transfers=None if H is None else [
            f"{type(l.P).__name__}/{type(l.R).__name__}"
            for l in H.levels if l.P is not None],
        level_sizes=None if H is None else [int(l.A.shape[0])
                                            for l in H.levels])
    return rec, solver, x


def lane_library(nref=LIB_NREF, device=None, darcy_nref=DARCY_NREF):
    """Every composition of SCALAR on the nref chain and of DARCY on the
    darcy_nref Darcy chain (0: none), on `device` (None: the card).
    Returns (record, solvers, solves): the solver objects and (b, x),
    the right-hand side and the f64 solution, by composition name."""
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()        # build the kernels outside setup
    mesh, seqs, chain_s = build_chain(nref, device)
    out = dict(metric="solver_library", nref=nref, cells=mesh.num_elements,
               levels=len(seqs), chain_s=chain_s, device=str(device),
               dims=[[int(s.dof[j].ndofs) for j in range(s.nforms)]
                     for s in seqs], compositions={})
    solvers, solves = {}, {}
    for name, (form, entries, entry) in SCALAR.items():
        A, b = scalar_problem(seqs, form)
        rec, solvers[name], x = run_composition(
            entries, entry, A, A, b, SolverState(seqs, [form],
                                                 device=device))
        solves[name] = (b, x)
        out["compositions"][name] = dict(form=form, **rec)
    del seqs
    if darcy_nref:
        op, b, dseqs, dchain_s = darcy_problem(darcy_nref)
        out.update(darcy_nref=darcy_nref, darcy_chain_s=dchain_s,
                   darcy_levels=len(dseqs))
        A = op.monolithic()
        for name, (entries, entry) in DARCY.items():
            rec, solvers[name], x = run_composition(
                entries, entry, op, A, b, SolverState(dseqs, [2, 3],
                                                      device=device))
            solves[name] = (b, x)
            out["compositions"][name] = dict(form=(2, 3), **rec)
    return out, solvers, solves


def kernel_operators(solvers):
    """The f64 operators of the lane that the hand kernels apply, as
    (label, matrix): every operator a cycle of the form-0 AMGe hierarchy
    applies (hierarchy.level_operators; on the card ELL where the format
    rule of build_hierarchy keeps it, BCSR elsewhere and for every
    transfer), and of the form-1 PCG + AMS composition the Hiptmair
    smoother's D0 and A_aux0 and the Krylov operator A0 (ELL)."""
    from parelag_tpu_torch.solvers.hierarchy import level_operators
    ams = solvers["PCG-AMS"]
    hip = ams._prec._H.levels[0].pre
    return [(f"form-0 {label}", M) for label, M in level_operators(
        solvers["PCG-AMGe-L1GS"]._prec._H)] + [
        ("form-1 Hiptmair D0", hip.D),
        ("form-1 Hiptmair A_aux0", hip.A_aux),
        ("form-1 Krylov A0", ams._A_dev)]
