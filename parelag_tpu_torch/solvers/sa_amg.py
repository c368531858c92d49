"""Smoothed-aggregation AMG setup for scalar SPD systems (PyTorch).

Counterpart of parelag_tpu/solvers/sa_amg.py: the BoomerAMG role of the
reference's hybridized-Darcy solve ("CG_PCG-AMG",
ParELAG_HybridizationSolverFactory.cpp:135-141).  The host setup
(strength_filter, aggregate, _rho_dinv_a, build_sa_hierarchy with its
rule that structurally decoupled rows take no part in aggregation, and
HostVCycle) is the JAX package's numpy code, copied function for
function; build_device_sa_hierarchy assembles the port's Hierarchy on a
torch device.
"""

import numpy as np
import scipy.sparse as sp

from parelag_tpu_torch import resolve_device


def strength_filter(A, theta=0.08):
    """Symmetric strength-of-connection filter: keep off-diagonals with
    |a_ij| >= theta * sqrt(a_ii * a_jj); dropped entries are lumped onto
    the diagonal (standard SA filtering) so the filtered operator keeps
    the row sums that matter for the smoothing step."""
    A = sp.csr_matrix(A)
    d = A.diagonal()
    scale = np.sqrt(np.abs(d))
    scale = np.where(scale > 0, scale, 1.0)
    coo = A.tocoo()
    offdiag = coo.row != coo.col
    strong = np.abs(coo.data) >= theta * scale[coo.row] * scale[coo.col]
    keep = strong | ~offdiag
    Af = sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)
    # lump the dropped weak entries onto the diagonal
    dropped = ~keep
    if dropped.any():
        lump = np.zeros(A.shape[0])
        np.add.at(lump, coo.row[dropped], coo.data[dropped])
        Af = (Af + sp.diags(lump)).tocsr()
    S = sp.csr_matrix(
        (np.ones(int((strong & offdiag).sum())),
         (coo.row[strong & offdiag], coo.col[strong & offdiag])),
        shape=A.shape)
    return Af, S


def aggregate(S, seed=0):
    """Vectorized aggregation on the strength graph S (pattern CSR).

    Luby-style: deterministic pseudo-random priorities; roots are local
    maxima among strong neighbors; each root absorbs its strong
    neighborhood; remaining nodes attach to an adjacent aggregate over a
    few propagation rounds; leftovers become singletons.  Returns the
    (n,) aggregate id vector (contiguous ids)."""
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    S = sp.csr_matrix(S)
    rng = np.random.RandomState(seed)
    pri = rng.permutation(n).astype(np.int64)
    coo = S.tocoo()
    # max neighbor priority per node (0 if isolated)
    nb_max = np.zeros(n, np.int64)
    np.maximum.at(nb_max, coo.row, pri[coo.col])
    is_root = pri > nb_max
    agg = np.full(n, -1, np.int64)
    roots = np.nonzero(is_root)[0]
    agg[roots] = np.arange(roots.size)
    # absorb strong neighbors of roots (closest/any root wins via scatter)
    sel = is_root[coo.row] & (agg[coo.col] < 0)
    agg[coo.col[sel]] = agg[coo.row[sel]]
    # propagation rounds: unassigned nodes join a neighboring aggregate
    for _ in range(3):
        un = agg < 0
        if not un.any():
            break
        cand = un[coo.row] & (agg[coo.col] >= 0)
        # deterministic pick: the neighbor with max priority
        best = np.full(n, -1, np.int64)
        np.maximum.at(best, coo.row[cand], pri[coo.col[cand]])
        pick = cand & (pri[coo.col] == best[coo.row])
        agg[coo.row[pick]] = agg[coo.col[pick]]
    un = np.nonzero(agg < 0)[0]
    if un.size:
        agg[un] = roots.size + np.arange(un.size)
    # compact ids
    _, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int64)


def _rho_dinv_a(A, dinv, iters=12, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        lam = np.linalg.norm(y)
        if lam <= 0:
            return 1.0
        x = y / lam
    return float(lam)


def build_sa_hierarchy(A, theta=0.08, coarse_size=800, max_levels=12,
                       omega_scale=4.0 / 3.0, min_coarsen=1.5):
    """SA-AMG setup: returns (A_levels, P_levels) as scipy CSR chains,
    A_{l+1} = P_l^T A_l P_l.  Stops at `coarse_size` rows, `max_levels`,
    or when coarsening stalls (n_coarse > n/min_coarsen)."""
    A_levels = [sp.csr_matrix(A).astype(np.float64)]
    P_levels = []
    for _ in range(max_levels - 1):
        Al = A_levels[-1]
        n = Al.shape[0]
        if n <= coarse_size:
            break
        # Structurally decoupled rows (no off-diagonal nonzeros — the
        # identity padding of shape-bucketed device systems, eliminated
        # BC rows) take NO part in the coarse space: their exact
        # correction is the fine smoother's 1x1 block.  Letting them
        # become singleton aggregates drags the whole pad block down
        # every level and poisons the stall metric — measured on the
        # 131072-padded 95232-multiplier system: the chain stalled at
        # 44772 rows and the dense coarse inverse tried to allocate
        # 16 GB (r5; the lane hung for 20+ minutes).
        coo_al = Al.tocoo()
        off = (coo_al.row != coo_al.col) & (coo_al.data != 0)
        has_off = np.zeros(n, dtype=bool)
        has_off[coo_al.row[off]] = True
        has_off[coo_al.col[off]] = True
        n_active = int(has_off.sum())
        if n_active <= coarse_size:
            break
        # RAP'd coarse operators are denser with decayed off-diagonals;
        # a fixed theta can empty the strength graph (all-singleton
        # aggregation). Relax theta until the level coarsens.
        th = theta
        for _attempt in range(4):
            Af, S = strength_filter(Al, th)
            agg = aggregate(S)
            agg = np.where(has_off, agg, -1)
            used = np.unique(agg[agg >= 0])
            remap = np.full(int(agg.max()) + 1 if used.size else 0, -1,
                            np.int64)
            remap[used] = np.arange(used.size)
            agg = np.where(agg >= 0, remap[np.clip(agg, 0, None)], -1)
            nc = int(used.size)
            if nc and nc <= n_active / min_coarsen:
                break
            th *= 0.3
        if nc == 0 or nc > n_active / min_coarsen:
            break
        # tentative piecewise-constant prolongation, columns normalized;
        # decoupled rows get zero P rows (excluded above)
        sel = np.nonzero(agg >= 0)[0]
        cnt = np.bincount(agg[sel], minlength=nc).astype(np.float64)
        T = sp.csr_matrix(
            (1.0 / np.sqrt(cnt[agg[sel]]), (sel, agg[sel])),
            shape=(n, nc))
        d = Af.diagonal()
        dinv = 1.0 / np.where(d != 0, d, 1.0)
        rho = _rho_dinv_a(Af, dinv)
        omega = omega_scale / max(rho, 1e-12)
        P = (T - sp.diags(omega * dinv) @ (Af @ T)).tocsr()
        Ac = (P.T @ Al @ P).tocsr()
        Ac.sum_duplicates()
        A_levels.append(Ac)
        P_levels.append(P)
    return A_levels, P_levels


def build_device_sa_hierarchy(A, theta=0.08, coarse_size=800,
                              sweeps=2, dtype=None, mu=1,
                              fine_smoother=None,
                              matrix_format="auto", device=None):
    """SA setup + device Hierarchy assembly: the V-cycle preconditioner
    for an arbitrary scalar SPD operator (the BoomerAMG device role) on
    `device` (None: the card).  `fine_smoother` optionally replaces the
    level-0 l1-Jacobi (e.g. the facet block-Jacobi of the hybridized
    multiplier system, solvers.smoothers.BlockJacobiSmoother).  dtype
    None follows the device as the JAX one follows its backend: f32 on
    the card, f64 on the CPU.  Every floating buffer, the coarse inverse
    included, ends in that dtype (Hierarchy.cast(keep_coarse_inv=False)).
    Returns (Hierarchy, A_levels, P_levels)."""
    from parelag_tpu_torch.solvers.hierarchy import build_hierarchy
    from parelag_tpu_torch.solvers import smoothers as sm
    device = resolve_device(device)
    if dtype is None:
        dtype = np.float32 if device.type != "cpu" else np.float64
    A_levels, P_levels = build_sa_hierarchy(
        A, theta=theta, coarse_size=coarse_size)

    def factory(A_l, l):
        if l == 0 and fine_smoother is not None:
            return fine_smoother
        return sm.make_l1_jacobi(A_l, sweeps=sweeps, device=device)

    H = build_hierarchy(A_levels, P_levels, factory, mu=mu, dtype=dtype,
                        matrix_format=matrix_format, device=device)
    H = H.cast(dtype, keep_coarse_inv=False)
    return H, A_levels, P_levels


class HostVCycle:
    """Host V(sweeps,sweeps) l1-Jacobi cycle over an SA hierarchy — the
    scipy-side preconditioner (golden tests, host anchors, library CG)."""

    def __init__(self, A_levels, P_levels, sweeps=2):
        self.A = [sp.csr_matrix(a) for a in A_levels]
        self.P = [sp.csr_matrix(p) for p in P_levels]
        self.sweeps = sweeps
        self.dinv = []
        for a in self.A:
            d = np.asarray(np.abs(a).sum(axis=1)).ravel()
            self.dinv.append(1.0 / np.where(d > 0, d, 1.0))
        nc = self.A[-1].shape[0]
        if nc <= 1500:
            self.coarse_inv = np.linalg.inv(self.A[-1].toarray())
            self._coarse_solve = lambda b: self.coarse_inv @ b
        else:
            # a stalled chain can leave a large coarsest level; a dense
            # inverse there is O(n^3)/O(n^2 mem) — sparse LU instead
            import scipy.sparse.linalg as spla
            lu = spla.splu(self.A[-1].tocsc())
            self._coarse_solve = lu.solve

    def _smooth(self, l, b, x):
        for _ in range(self.sweeps):
            x = x + self.dinv[l] * (b - self.A[l] @ x)
        return x

    def _cycle(self, l, b):
        if l == len(self.A) - 1:
            return self._coarse_solve(b)
        x = self._smooth(l, b, np.zeros_like(b))
        r = b - self.A[l] @ x
        x = x + self.P[l] @ self._cycle(l + 1, self.P[l].T @ r)
        return self._smooth(l, b, x)

    def __call__(self, r):
        return self._cycle(0, np.asarray(r, dtype=np.float64))

    matvec = __call__
