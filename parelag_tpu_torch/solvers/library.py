"""SolverLibrary: named solver compositions resolved recursively from
config (PyTorch).

Counterpart of parelag_tpu/solvers/library.py (reference
ParELAG_SolverLibrary.hpp:69-273, ParELAG_SolverFactory.hpp:36-186,
factories/*): a library maps solver names to (Type, Solver Parameters)
entries; factories resolve nested solver names ("Preconditioner",
"PreSmoother", "A00 Inverse", ...) recursively at build time.  Solvers
are built against a SolverState (sequence chain + form(s) + essential
labels + the torch device, the ParELAG_SolverState.hpp:54 analog) and
expose solve(b) -> x / apply(r) on numpy vectors.

The host plane is the JAX module's: SolverState's fields, Block2x2Operator,
_as_matrix, SolverFactory.build_solver's type dispatch and every scipy
path.  The device plane is torch on SolverState.device (None: the card,
RuntimeError without one; the CPU only when the caller names it):

    Krylov            -> solvers/cg.py pcg / gmres (restart 50) / minres /
                         bicgstab on the device when the preconditioner
                         has a device_state ('Execution: auto'), else scipy
    AMGe              -> solvers/hierarchy V/W-cycle (two forms: the
                         blocked Darcy hierarchy of solvers/block.py)
    Hypre (L1 GS/Jacobi/Chebyshev) -> l1-Jacobi / Chebyshev smoothers
    Hiptmair          -> two-space smoother via D[form-1]
    BoomerAMG/AMS/ADS -> AMGe/Hiptmair hierarchy on the sequence chain, an
                         SA-AMG hierarchy above 2,000 rows, else sparse LU
    Direct            -> sparse LU (a dense inverse on the device for
                         n <= 4,096 inside a device Krylov loop)
    Block Jacobi / Block Gauss-Seidel -> 2x2 block solvers w/ Schur approx
    Block LDU / Bramble-Pasciak / MLDivFree -> solvers/saddle_extra.py
    Hybridization     -> HybridHdivL2 with the composed inner solver
    Stationary        -> fixed-point iteration wrapper

Where it differs from the JAX module:
  * no jitted program per composition (_jit_krylov): _KrylovSolver calls
    the Krylov loop of solvers/cg.py with the same arguments;
  * executed_on is "device" when that torch loop ran, on whichever
    device SolverState names (the CPU in the tests), "host" when scipy
    ran; _HybridizationSolver reports its inner solver's;
  * the MINRES / BiCGSTAB breakdown rescue is the JAX module's, which
    warns (RuntimeWarning) and sets executed_on = "host": a caller that
    asks for the device can see it;
  * _SmootherAdapter has no pytree protocol (tree_flatten).
"""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.utils.params import ParameterList


# ---------------------------------------------------------------------- #
# device plumbing: preconditioners expose (state, apply) through
# Solver.device_state(), apply(state, r) on tensors of the solver's
# device; _KrylovSolver runs the whole Krylov loop there with them.
# ---------------------------------------------------------------------- #
def _prec_apply_smoother(state, r):
    sm, A = state
    return sm.apply(A, r, torch.zeros_like(r))


def _prec_apply_hierarchy(H, r):
    return H.apply(r)


def _prec_apply_dense(inv, r):
    return inv @ r


def _krylov(kind, A_dev, pstate, apply_fn, b, rtol, atol, maxiter):
    """One Krylov solve of `kind` with the operator A_dev and the
    preconditioner apply_fn(pstate, r) (None: none), the arguments of
    the JAX module's _jit_krylov: GMRES restarts every 50 steps, at most
    ceil(maxiter / 50) cycles."""
    from parelag_tpu_torch.solvers.cg import bicgstab, gmres, minres, pcg
    pc = None if apply_fn is None else (lambda r: apply_fn(pstate, r))
    mv = A_dev.matvec
    if kind in ("GMRES", "FGMRES"):
        return gmres(mv, b, precond=pc, rtol=rtol, atol=atol, restart=50,
                     max_restarts=max(1, -(-maxiter // 50)))
    if kind == "MINRES":
        return minres(mv, b, precond=pc, rtol=rtol, atol=atol,
                      maxiter=maxiter)
    if kind == "BICGSTAB":
        return bicgstab(mv, b, precond=pc, rtol=rtol, atol=atol,
                        maxiter=maxiter)
    return pcg(mv, b, precond=pc, rtol=rtol, atol=atol, maxiter=maxiter)


def _vec(b, device):
    """A numpy (or any float) vector as an f64 tensor on `device`."""
    return torch.as_tensor(np.asarray(b, dtype=np.float64)).to(device)


def _np(t):
    """A tensor back on the host as a new numpy array (scipy's Krylov
    drivers write into preconditioner outputs)."""
    return t.detach().cpu().numpy().copy()


class SolverState:
    """Build context (ParELAG_SolverState.hpp:54) and the torch device
    every device-side object is built on (None: the card)."""

    def __init__(self, seqs=None, forms=None, level=0, ess_attrs=None,
                 w_weight=0.0, device=None):
        self.seqs = seqs or []
        self.forms = forms or []
        self.level = level
        self.ess_attrs = ess_attrs or set()
        self.w_weight = w_weight
        self.device = resolve_device(device)


class Block2x2Operator:
    """2x2 saddle-point operator usable BOTH as a monolithic matrix (Krylov,
    BoomerAMG-role direct solves — the reference's MonolithicBlockedOperator
    Factory, ParELAG_MonolithicBlockedOperatorFactory.cpp) and as blocks
    (Block Jacobi/GS/LDU, Bramble-Pasciak — MfemBlockOperator). Iterating
    yields (M, Bt, B, C) so existing tuple-unpacking factories work."""

    def __init__(self, M, Bt, B, C=None):
        self.M = sp.csr_matrix(M)
        self.Bt = sp.csr_matrix(Bt)
        self.B = sp.csr_matrix(B)
        self.C = None if C is None else sp.csr_matrix(C)

    def __iter__(self):
        return iter((self.M, self.Bt, self.B, self.C))

    def monolithic(self) -> sp.csr_matrix:
        return sp.bmat([[self.M, self.Bt], [self.B, self.C]],
                       format="csr")


def _as_matrix(op):
    """Monolithic view for scalar-matrix solver types."""
    if isinstance(op, Block2x2Operator):
        return op.monolithic()
    return op


class Solver:
    """Common interface: solve(b) and apply(r) (preconditioner action)."""

    def solve(self, b):
        raise NotImplementedError

    def apply(self, r):
        return self.solve(r)

    def device_state(self):
        """(state, apply) with apply(state, r) on tensors of the
        solver's device, for use inside a device Krylov loop, or None
        if this solver is host-only."""
        return None

    iterations = 0
    converged = True


class SolverLibrary:
    def __init__(self, params: ParameterList):
        """params: the 'Preconditioner Library' sublist."""
        self.params = params

    @classmethod
    def create_library(cls, params):
        if isinstance(params, dict):
            params = ParameterList("Preconditioner Library", params)
        return cls(params)

    def get_solver_factory(self, name):
        entry = self.params.sublist(name, create=False)
        return SolverFactory(self, name, entry)


class SolverFactory:
    def __init__(self, lib, name, entry):
        self.lib = lib
        self.name = name
        self.type = entry.get("Type")
        self.sp = entry.sublist("Solver Parameters")

    def _sub(self, pname):
        sub_name = self.sp.get(pname)
        if sub_name in (None, "None"):
            return None
        return self.lib.get_solver_factory(sub_name)

    # ------------------------------------------------------------------ #
    def build_solver(self, op, state: SolverState) -> Solver:
        t = self.type
        if t == "Krylov":
            return _KrylovSolver(self, op, state)
        if t == "AMGe":
            return _AMGeSolver(self, op, state)
        if t in ("Hypre", "L1 Jacobi", "Chebyshev"):
            return _SmootherSolver(self, op, state)
        if t == "Hiptmair":
            return _HiptmairSolver(self, op, state)
        if t == "Direct":
            return _DirectSolver(self, op, state)
        if t in ("BoomerAMG", "AMS", "ADS"):
            return _AuxAMGSolver(self, op, state)
        if t in ("Block Jacobi", "Block Gauss-Seidel", "Block GS"):
            return _BlockSolver(self, op, state)
        if t == "Block LDU":
            from parelag_tpu_torch.solvers.saddle_extra import Block2x2LDU
            M, Bt, B, Cblk = op
            return _CallableSolver(Block2x2LDU(
                M, B, None if Cblk is None else -Cblk).apply)
        if t == "Bramble-Pasciak":
            from parelag_tpu_torch.solvers.saddle_extra import (
                BramblePasciakCG)
            M, Bt, B, Cblk = op
            bp = BramblePasciakCG(M, B, None if Cblk is None else -Cblk)
            return _CallableSolver(
                lambda b: bp.solve(
                    b, rtol=self.sp.get("Relative tolerance", 1e-8),
                    maxiter=self.sp.get("Maximum iterations", 1000)))
        if t == "MLDivFree":
            from parelag_tpu_torch.solvers.saddle_extra import MLDivFree
            ml = MLDivFree(state.seqs, w_weight=state.w_weight,
                           device=state.device)

            def run(b):
                b = np.asarray(b)
                u, p = ml.solve(b[: ml.M.shape[0]], b[ml.M.shape[0]:])
                return np.concatenate([u, p])
            return _CallableSolver(run)
        if t == "Hybridization":
            return _HybridizationSolver(self, op, state)
        if t == "Stationary":
            return _StationarySolver(self, op, state)
        raise ValueError(f"Unknown solver type {t!r}")


# ---------------------------------------------------------------------- #
class _CallableSolver(Solver):
    def __init__(self, fn):
        self._fn = fn

    def solve(self, b):
        return self._fn(b)


def _dense_inverse(A, device):
    """The dense inverse of a small host matrix as an f64 tensor."""
    return torch.as_tensor(np.linalg.inv(A.toarray())).to(device)


class _DirectSolver(Solver):
    """Sparse LU (reference Direct/UMFPACK role: exact coarse solves)."""

    _DENSE_DEVICE_LIMIT = 4096

    def __init__(self, fac, op, state):
        op = _as_matrix(op)
        A = op.tocsc() if sp.issparse(op) else sp.csc_matrix(op)
        self._lu = spla.splu(A)
        self._A_host = A
        self._dinv = None
        self._device = state.device

    def solve(self, b):
        return self._lu.solve(np.asarray(b))

    def device_state(self):
        # small systems: dense inverse applied on the device, so Krylov
        # compositions with a Direct coarse/aux solve stay on the device
        n = self._A_host.shape[0]
        if n > self._DENSE_DEVICE_LIMIT:
            return None
        if self._dinv is None:
            self._dinv = _dense_inverse(self._A_host, self._device)
        return self._dinv, _prec_apply_dense


class _AuxAMGSolver(Solver):
    """Native AMGe/Hiptmair hierarchy backing the BoomerAMG / AMS / ADS
    XML types (reference ParELAG_HypreExtension.hpp:29-190 builds AMS/ADS
    from the sequence's D operators; here the same role is played by the
    AMGe hierarchy with Hiptmair smoothing for the 1- and 2-form). When no
    coarsening chain matches the operator — hypre's BoomerAMG is purely
    algebraic and accepts ANY matrix, e.g. the hybridized facet multiplier
    system ("CG_PCG-AMG", ParELAG_HybridizationSolverFactory.cpp:135-141)
    — a smoothed-aggregation hierarchy is built directly on the operator
    (solvers/sa_amg.py, f64); the exact-solve fallback remains only for
    small systems (the coarsest level of an outer AMGe composition).
    apply() is one V-cycle (preconditioner role, hypre maxiter=1
    semantics); solve() iterates cycles to tolerance (hypre solver
    semantics).  Every hierarchy is built in f64 on state.device."""

    _SA_MIN_SIZE = 2000          # below this a direct solve is cheaper

    def __init__(self, fac, op, state):
        from parelag_tpu_torch.solvers.hierarchy import build_hierarchy, rap
        from parelag_tpu_torch.solvers import smoothers as sm
        A = sp.csr_matrix(_as_matrix(op))
        self._A_host = A
        self._H = None
        self._direct = None
        self._dinv = None
        self._device = dev = state.device
        self._rtol = fac.sp.get("Relative tolerance", 1e-8)
        self._maxit = fac.sp.get("Maximum iterations", 100)
        seqs, level = state.seqs, state.level
        form = state.forms[0] if state.forms else 0
        if seqs and level < len(seqs) - 1 \
                and seqs[level].P[form] is not None \
                and seqs[level].P[form].shape[0] == A.shape[0]:
            A_levels = [A]
            P_levels = []
            for l in range(level, len(seqs) - 1):
                P = seqs[l].P[form]
                if P is None or P.shape[0] != A_levels[-1].shape[0]:
                    break
                P_levels.append(P)
                A_levels.append(rap(A_levels[-1], P))
            if len(A_levels) >= 2:
                hiptmair = fac.type in ("AMS", "ADS") and form >= 1

                def smoother_factory(A_l, l):
                    if hiptmair:
                        D = seqs[level + l].D[form - 1]
                        if D is not None and D.shape[0] == A_l.shape[0]:
                            return sm.make_hiptmair(A_l, D, device=dev)
                    return sm.make_l1_jacobi(A_l, sweeps=2, device=dev)

                self._H = build_hierarchy(A_levels, P_levels,
                                          smoother_factory,
                                          dtype=np.float64, device=dev)
        if self._H is None and A.shape[0] > self._SA_MIN_SIZE:
            from parelag_tpu_torch.solvers.sa_amg import (
                build_device_sa_hierarchy)
            self._H, _, _ = build_device_sa_hierarchy(
                A, dtype=np.float64, device=dev)
        if self._H is None:
            self._direct = spla.splu(A.tocsc())

    def apply(self, r):
        if self._H is None:
            return self._direct.solve(np.asarray(r))
        return _np(self._H.cycle(_vec(r, self._device)))

    def solve(self, b):
        if self._H is None:
            return self._direct.solve(np.asarray(b))
        b = np.asarray(b, dtype=np.float64)
        x = np.zeros_like(b)
        r0 = np.linalg.norm(b)
        self.iterations = 0
        self.converged = False
        for it in range(self._maxit):
            r = b - self._A_host @ x
            if np.linalg.norm(r) <= self._rtol * r0:
                self.converged = True
                break
            x = x + self.apply(r)
            self.iterations = it + 1
        else:
            self.converged = np.linalg.norm(
                b - self._A_host @ x) <= self._rtol * r0
        return x

    def device_state(self):
        if self._H is not None:
            return self._H, _prec_apply_hierarchy
        n = self._A_host.shape[0]
        if n > _DirectSolver._DENSE_DEVICE_LIMIT:
            return None
        if self._dinv is None:
            self._dinv = _dense_inverse(self._A_host, self._device)
        return self._dinv, _prec_apply_dense


class _SmootherSolver(Solver):
    def __init__(self, fac, op, state):
        from parelag_tpu_torch.solvers import smoothers as sm
        from parelag_tpu_torch.ops.device_sparse import from_scipy
        kind = fac.sp.get("Type", "L1 Gauss-Seidel")
        sweeps = fac.sp.get("Sweeps", 1)
        A = sp.csr_matrix(_as_matrix(op))
        dev = self._device = state.device
        self._A = from_scipy(A, dtype=np.float64, device=dev)
        if "Cheby" in kind or kind == "Chebyshev":
            self._sm = sm.make_chebyshev(
                A, degree=fac.sp.get("Cheby Poly Order", 3),
                ratio=fac.sp.get("Cheby Poly Fraction", 0.3), device=dev)
        else:
            # L1 Gauss-Seidel / L1 Jacobi / Jacobi -> l1-Jacobi
            self._sm = sm.make_l1_jacobi(
                A, sweeps=sweeps, omega=fac.sp.get("Damping Factor", 1.0),
                device=dev)

    def solve(self, b):
        bt = _vec(b, self._device)
        return _np(self._sm.apply(self._A, bt, torch.zeros_like(bt)))

    def device_state(self):
        return (self._sm, self._A), _prec_apply_smoother


class _HiptmairSolver(Solver):
    def __init__(self, fac, op, state):
        from parelag_tpu_torch.solvers import smoothers as sm
        from parelag_tpu_torch.ops.device_sparse import from_scipy
        form = state.forms[0]
        D = state.seqs[state.level].D[form - 1]
        dev = self._device = state.device
        self._sm = sm.make_hiptmair(sp.csr_matrix(op), D, device=dev)
        self._A = from_scipy(sp.csr_matrix(op), dtype=np.float64,
                             device=dev)

    def solve(self, b):
        bt = _vec(b, self._device)
        return _np(self._sm.apply(self._A, bt, torch.zeros_like(bt)))

    def device_state(self):
        return (self._sm, self._A), _prec_apply_smoother


class _KrylovSolver(Solver):
    """Krylov wrapper (reference ParELAG_KrylovSolver.hpp:25-144). By
    default the whole solve — operator matvec (an f64 ELL matrix),
    preconditioner, vector updates — runs in solvers/cg.py's loop on
    state.device whenever the preconditioner has a device_state
    ('Execution: auto'); 'host' forces the scipy path, 'device' raises
    where the device path is not available."""

    executed_on = None

    def __init__(self, fac, op, state):
        self._A = sp.csr_matrix(_as_matrix(op))
        self._rtol = fac.sp.get("Relative tolerance", 1e-6)
        self._atol = fac.sp.get("Absolute tolerance", 1e-12)
        self._maxit = fac.sp.get("Maximum iterations", 500)
        # name -> NAME like the reference (ParELAG_KrylovSolver.cpp:39-41)
        self._kind = fac.sp.get("Solver name", "PCG").upper()
        self._exec = fac.sp.get("Execution", "auto")
        self._device = state.device
        pf = fac._sub("Preconditioner")
        self._prec = pf.build_solver(op, state) if pf else None
        self._A_dev = None

    def _device_plan(self):
        """(A_dev, state, apply_fn) if this solve can run on the device."""
        if self._exec == "host":
            return None
        if self._kind not in ("PCG", "CG", "GMRES", "FGMRES", "MINRES",
                              "BICGSTAB"):
            return None
        if self._prec is None:
            ds = (None, None)
        else:
            ds = self._prec.device_state()
            if ds is None:
                return None
        if self._A_dev is None:
            from parelag_tpu_torch.ops.device_sparse import from_scipy
            self._A_dev = from_scipy(self._A, dtype=np.float64,
                                     device=self._device)
        return self._A_dev, ds[0], ds[1]

    def solve(self, b):
        plan = self._device_plan()
        if plan is not None:
            return self._solve_device(plan, b)
        if self._exec == "device":
            raise RuntimeError(
                "Execution='device' requested but the preconditioner "
                f"({type(self._prec).__name__}) is host-only")
        self.executed_on = "host"
        return self._solve_host(b)

    def _solve_device(self, plan, b):
        A_dev, pstate, apply_fn = plan
        x, (it, nom) = _krylov(self._kind, A_dev, pstate, apply_fn,
                               _vec(b, self._device), float(self._rtol),
                               float(self._atol), int(self._maxit))
        x = _np(x)
        self.iterations = int(it)
        self.converged = self.iterations < self._maxit
        self.executed_on = "device"
        # breakdown guard (one host SpMV): MINRES/BiCGSTAB can break down
        # on compositions outside their theory (e.g. an indefinite
        # preconditioner on a monolithic saddle system — the reference's
        # hypre MINRES produces NaNs there too). A plainly failed device
        # solve falls back to the host path, which carries the documented
        # GMRES rescue for exactly those lanes.
        if self._kind in ("MINRES", "BICGSTAB") and self._exec != "device":
            nb = np.linalg.norm(b)
            res = np.linalg.norm(b - self._A @ x)
            if not np.isfinite(res) or (nb > 0 and res > 0.5 * nb):
                import warnings
                warnings.warn(
                    f"device {self._kind} broke down "
                    f"(|r|/|b|={res / max(nb, 1e-300):.2e}); "
                    "falling back to the host solver", RuntimeWarning)
                self.executed_on = "host"
                return self._solve_host(b)
        return x

    def _solve_host(self, b):
        M = None
        if self._prec is not None:
            # scipy's LinearOperator dtype-probes matvec with an int8 zero
            # vector; cast so integer dtypes never reach the device solvers
            # (zeros_like would make x int and scatter-adds of floats fail).
            M = spla.LinearOperator(
                self._A.shape,
                matvec=lambda r: self._prec.apply(
                    np.asarray(r, dtype=np.float64)))
        it = [0]

        def cb(x):
            it[0] += 1

        if self._kind in ("PCG", "CG"):
            x, info = spla.cg(self._A, b, M=M, rtol=self._rtol,
                              atol=self._atol, maxiter=self._maxit,
                              callback=cb)
        elif self._kind == "MINRES":
            try:
                x, info = spla.minres(self._A, b, M=M, rtol=self._rtol,
                                      maxiter=self._maxit, callback=cb)
            except ValueError as e:
                # scipy's MINRES rejects indefinite/non-SPD
                # preconditioners that the reference's hypre MINRES
                # tolerates (e.g. AMG on a monolithic saddle system);
                # fall back to GMRES for exactly those compositions.
                msg = str(e).lower()
                if not ("definite" in msg or "precond" in msg
                        or "symmetric" in msg):
                    raise
                import warnings
                warnings.warn(
                    f"MINRES rejected the preconditioner ({e}); "
                    f"falling back to GMRES(50)", RuntimeWarning)
                it[0] = 0
                x, info = spla.gmres(self._A, b, M=M, rtol=self._rtol,
                                     atol=self._atol,
                                     maxiter=self._maxit, restart=50,
                                     callback=cb, callback_type="x")
        elif self._kind == "BICGSTAB":
            x, info = spla.bicgstab(self._A, b, M=M, rtol=self._rtol,
                                    atol=self._atol,
                                    maxiter=self._maxit, callback=cb)
        else:  # GMRES / FGMRES
            x, info = spla.gmres(self._A, b, M=M, rtol=self._rtol,
                                 atol=self._atol, maxiter=self._maxit,
                                 restart=50, callback=cb,
                                 callback_type="x")
        self.iterations = it[0]
        self.converged = (info == 0)
        if info != 0:
            import warnings
            warnings.warn(
                f"{self._kind} did not converge in {it[0]} iterations "
                f"(scipy info={info})", RuntimeWarning, stacklevel=2)
        return x


class _AMGeSolver(Solver):
    """One V/W-cycle of the AMGe hierarchy (used as preconditioner or via
    Stationary as a solver) — AMGeSolverFactory analog, in f64 on
    state.device."""

    def __init__(self, fac, op, state):
        from parelag_tpu_torch.solvers.hierarchy import build_hierarchy, rap
        self._device = state.device
        forms = fac.sp.get("Forms", None) or state.forms
        if len(forms) >= 2:
            # blocked saddle-point AMGe (the darcy XML "Forms 2 3" entry):
            # monolithic blocked hierarchy with the inexact-Uzawa smoother
            # standing in for the named Block Jacobi/GS smoother
            from parelag_tpu_torch.solvers.block import (
                build_darcy_amge_hierarchy)
            self._H, _, _ = build_darcy_amge_hierarchy(
                state.seqs, w_weight=state.w_weight, sweeps=3, omega=0.6,
                device=state.device)
            return
        form = state.forms[0]
        seqs = state.seqs
        max_lev = fac.sp.get("Maximum levels", -1)
        n_lev = len(seqs) if max_lev in (-1, None) else min(
            max_lev, len(seqs))
        A_levels = [sp.csr_matrix(_as_matrix(op))]
        P_levels = []
        for l in range(n_lev - 1):
            P = seqs[l].P[form]
            P_levels.append(P)
            A_levels.append(rap(A_levels[l], P))

        pre_fac = fac._sub("PreSmoother")
        self._host_only = False

        def smoother_factory(A, l):
            st = SolverState(seqs, [form], level=l,
                             ess_attrs=state.ess_attrs, device=state.device)
            s = pre_fac.build_solver(A, st)
            inner = getattr(s, "_sm", None)
            if inner is not None:
                # device-resident smoother: embed it directly so the
                # whole cycle stays on the device
                return inner
            self._host_only = True
            return _SmootherAdapter(s)

        cycle = fac.sp.get("Cycle type", "V-cycle")
        self._H = build_hierarchy(
            A_levels, P_levels, smoother_factory,
            mu=2 if cycle.startswith("W") else 1, dtype=np.float64,
            device=state.device)

    def solve(self, b):
        return _np(self._H.cycle(_vec(b, self._device)))

    def device_state(self):
        if getattr(self, "_host_only", False):
            return None
        return self._H, _prec_apply_hierarchy


class _SmootherAdapter:
    """Adapts a host library Solver to the Hierarchy smoother protocol
    (a hierarchy that holds one is host-only)."""

    def __init__(self, solver):
        self._solver = solver
        self._inner = getattr(solver, "_sm", None)

    def to(self, *args, **kwargs):
        """Nothing to move: build_hierarchy calls .to(device) on every
        smoother."""
        return self

    def apply(self, A, b, x):
        if self._inner is not None:
            return self._inner.apply(A, b, x)
        r = b - A @ x
        return x + torch.as_tensor(
            np.asarray(self._solver.apply(_np(r)))).to(x)


class _BlockSolver(Solver):
    """2x2 block-diagonal (Jacobi) / block lower-triangular (Gauss-Seidel)
    preconditioner with diagonal Schur approximation
    (ParELAG_BlockDiagonalSolver / BlockTriangularSolver,
    ParELAG_SchurComplementFactory.cpp)."""

    def __init__(self, fac, op, state):
        M, Bt, B, Cblk = op     # blocks of [[M, B^T], [B, C]]
        self._M = sp.csr_matrix(M)
        self._B = sp.csr_matrix(B)
        self._Bt = sp.csr_matrix(Bt)
        self._gs = fac.type in ("Block Gauss-Seidel", "Block GS")
        s_type = fac.sp.get("S Type", "Diagonal")
        dinv = 1.0 / self._M.diagonal()
        S = (self._B @ sp.diags(dinv) @ self._Bt).tocsr()
        if Cblk is not None:
            S = (S - sp.csr_matrix(Cblk)).tocsr()
        st = SolverState(state.seqs, state.forms[:1], state.level,
                         state.ess_attrs, device=state.device)
        f00 = fac._sub("A00 Inverse")
        f11 = fac._sub("A11 Inverse")
        self._inv00 = f00.build_solver(self._M, st)
        self._inv11 = f11.build_solver(S, st)
        self._n0 = self._M.shape[0]

    def solve(self, b):
        b = np.asarray(b)
        x0 = self._inv00.apply(b[: self._n0])
        r1 = b[self._n0:]
        if self._gs:
            r1 = r1 - self._B @ x0
        x1 = self._inv11.apply(r1)
        return np.concatenate([x0, x1])


class _HybridizationSolver(Solver):
    """Hybridized Hdiv-L2 solve with a COMPOSED inner solver on the facet
    multiplier system. The reference's factory builds the named "Solver"
    entry (e.g. "CG_PCG-AMG" = PCG preconditioned with BoomerAMG) on the
    hybridized system and respects "RescaleIteration"
    (ParELAG_HybridizationSolverFactory.cpp:135-141,
    examples/testing_helpers/CreateDarcyParameterList.hpp:60-80); both
    parameters are honored here.  The inner composition is built on
    state.device; without one the multipliers are solved on the host
    (facet block-Jacobi PCG).  executed_on is the inner solver's
    ("host" without one)."""

    def __init__(self, fac, op, state):
        from parelag_tpu_torch.amge.hybridization import HybridHdivL2
        seq = state.seqs[state.level]
        self._device = state.device
        self._hyb = HybridHdivL2(seq, W_weight=state.w_weight)
        self._nu = self._hyb.nu
        self._rescale = fac.sp.get("Rescale", True)
        ri = fac.sp.get("RescaleIteration", None)
        if ri is not None:
            # reference semantics: <= 0 disables the CG rescaling sweep
            self._rescale = int(ri) > 0
        self._inner = None
        self._inner_solver = None
        inner_fac = fac._sub("Solver")
        if inner_fac is not None:
            # build the named solver on the reduced (and rescaled, in the
            # same coordinates the outer solve uses) multiplier system
            keep = ~self._hyb.ess_mult
            Hff = self._hyb.hybrid_system[keep][:, keep].tocsr()
            if self._rescale:
                d = self._hyb.rescaling[keep]
                d = np.where(np.abs(d) > 0, d, 1.0)
                Hff = (sp.diags(d) @ Hff @ sp.diags(d)).tocsr()
            st = SolverState(state.seqs, [], state.level, state.ess_attrs,
                             device=state.device)
            self._inner_solver = inner_fac.build_solver(Hff, st)

            def inner(H, g, rtol):
                x = self._inner_solver.solve(g)
                return x, getattr(self._inner_solver, "iterations", 0)
            self._inner = inner

    @property
    def executed_on(self):
        if self._inner_solver is None:
            return "host"
        return getattr(self._inner_solver, "executed_on", None)

    def solve(self, b):
        b = np.asarray(b)
        u, p = self._hyb.solve(b[: self._nu], b[self._nu:],
                               solver="cg", rtol=1e-8,
                               rescale=self._rescale,
                               inner=self._inner, device=self._device)
        self.iterations = self._hyb.last_iterations
        return np.concatenate([u, p])


class _StationarySolver(Solver):
    def __init__(self, fac, op, state):
        A = _as_matrix(op)
        self._A = sp.csr_matrix(A) if sp.issparse(A) else A
        pf = fac._sub("Preconditioner") or fac._sub("Solver")
        self._prec = pf.build_solver(op, state)
        self._maxit = fac.sp.get("Maximum iterations", 20)
        self._rtol = fac.sp.get("Relative tolerance", 0.0)

    def solve(self, b):
        x = np.zeros_like(np.asarray(b))
        r0 = np.linalg.norm(b)
        for it in range(self._maxit):
            r = b - self._A @ x
            if self._rtol and np.linalg.norm(r) <= self._rtol * r0:
                break
            x = x + self._prec.apply(r)
        self.iterations = it + 1
        return x
