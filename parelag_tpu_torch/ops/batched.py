"""Batched dense linear algebra for per-agglomerate work (PyTorch).

Counterpart of parelag_tpu/ops/batched.py.  The coarsening hot loops
(SURVEY.md §3.5: per-AE saddle-point factor+solve, per-AE SVD) are many
independent small dense problems of ragged sizes, grouped here by shape.
The host paths (stacked LAPACK / the native batched LU, the M-weighted
and plain SVDs) are the reference's, unchanged.  The 'device' backend
ships one f64 stack per shape group to a torch device and solves it
there with a batched LU (torch.linalg.solve_ex) or SVD.

The JAX module's TPU workarounds are not ported: the Newton-Schulz f32
inverse with on-device refinement (batched LU compiled for minutes per
shape on the TPU), the f32 downcast, and the padding of the batch and of
n, k to buckets (which only bounded XLA recompiles).  The residual check
and the host lstsq repair of bad members stay.
"""

import numpy as np
import torch

from parelag_tpu_torch import resolve_device


def batched_solve(systems, rhs, backend="auto", skip=None, device=None):
    """Solve systems[i] @ X[i] = rhs[i] for ragged lists of dense (n_i, n_i)
    matrices and (n_i, k_i) right-hand sides. Returns a list-compatible
    ragged.BlockList of (n_i, k_i) solutions.

    skip[i] truthy -> system i is not factored and out[i] = rhs[i]
    (passthrough for degenerate systems handled separately by the caller).

    backend 'host'  -> stacked LAPACK per shape group;
            'device'-> one batched f64 LU per shape group on `device`
                       (None: the card), see _device_solve;
            'auto'  -> host.
    """
    from parelag_tpu_torch.ops.ragged import BlockList
    if backend == "device":
        device = resolve_device(device)
    n_items = len(systems)
    if n_items == 0:
        return []
    rsz = np.fromiter((b.shape[0] for b in rhs), np.int64, n_items)
    csz = np.fromiter((b.shape[1] for b in rhs), np.int64, n_items)
    out_off = np.zeros(n_items + 1, np.int64)
    np.cumsum(rsz * csz, out=out_off[1:])
    out_cat = np.zeros(int(out_off[-1]), dtype=np.asarray(rhs[0]).dtype)
    out = BlockList(out_cat, out_off, rsz, csz)
    if skip is None:
        skip = (False,) * n_items
    if backend == "auto":
        # auto = host, as in the reference (made for a remote-attached
        # accelerator); pass backend="device" to route to the card
        backend = "host"

    def _scatter(idxs, X):
        """Vectorized write of same-shape solutions into the flat output."""
        idxs = np.asarray(idxs, np.int64)
        k = X.shape[1] * X.shape[2]
        flat = out_off[idxs][:, None] + np.arange(k, dtype=np.int64)
        out_cat[flat] = X.reshape(len(idxs), -1)

    pas = [i for i in range(n_items) if skip[i]]
    if pas:
        for i in pas:                     # passthrough: out[i] = rhs[i]
            out_cat[out_off[i]:out_off[i + 1]] = np.asarray(rhs[i]).ravel()

    # group identical shapes: one stacked solve per group (the shape
    # distribution is highly repetitive on quasi-uniform agglomerations)
    groups = {}
    for i, (A, b) in enumerate(zip(systems, rhs)):
        if skip[i] or A.shape[0] == 0 or b.shape[1] == 0:
            continue
        groups.setdefault((A.shape[0], b.shape[1]), []).append(i)
    for (n, k), idxs in groups.items():
        Ast = np.stack([systems[i] for i in idxs])
        Bst = np.stack([rhs[i] for i in idxs])
        if backend == "host":
            _scatter(idxs, _host_solve_stack(Ast, Bst))
        else:
            _scatter(idxs, _device_solve(Ast, Bst, device))
    return out


def solve_groups(As, Bs, backend="auto", skip=None, device=None):
    """Group-level batched solve: As[i] (m_i, n_i, n_i), Bs[i] (m_i, n_i,
    k_i) -> list of (m_i, n_i, k_i) solutions. skip[i] -> out[i] = Bs[i].
    The group-stacked twin of batched_solve (the setup engine produces
    shape-grouped stacks directly); backend="device" solves on `device`
    (None: the card)."""
    if backend == "device":
        device = resolve_device(device)
    if skip is None:
        skip = (False,) * len(As)
    if backend == "auto":
        backend = "host"     # see batched_solve; device is opt-in
    out = []
    for A, B, sk in zip(As, Bs, skip):
        if sk or A.shape[1] == 0 or B.shape[2] == 0:
            out.append(B)
            continue
        if backend == "host":
            out.append(_host_solve_stack(A, B))
        else:
            out.append(_device_solve(A, B, device))
    return out


def _host_solve_stack(A, B):
    """Stacked host solve with min-norm-lstsq repair of (near-)singular
    members. Routes through the native batched LU (f64 accumulation —
    LAPACK per-call overhead dominates at per-AE sizes and the f32 LAPACK
    path needed frequent lstsq redo passes) with np.linalg.solve as the
    fallback."""
    from parelag_tpu_torch.ops import native
    rtol_v = max(1e-8, 1e3 * float(np.finfo(A.dtype).eps))
    rc = 1e-12 if A.dtype == np.float64 else 1e-5
    if native.available():
        # fused solve + residual: the residual is computed in-kernel while
        # each system is cache-hot, saving the numpy batched-matmul pass
        X, hard_bad, res, bmax = native.batched_solve_res(A, B)
        scale = np.maximum(bmax, 1.0)
    else:
        hard_bad = None
        try:
            X = np.linalg.solve(A, B)
        except np.linalg.LinAlgError:
            X = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                          for a, b in zip(A, B)])
        res = np.abs(A @ X - B).max(axis=(1, 2))
        scale = np.maximum(np.abs(B).max(axis=(1, 2)), 1.0)
    bad = res > rtol_v * scale
    if hard_bad is not None:
        bad |= hard_bad
    for j in np.where(bad)[0]:
        X[j] = np.linalg.lstsq(A[j], B[j], rcond=rc)[0]
    return X


def _device_solve(A, B, device):
    """Stacked f64 solve on `device`: the stack shipped once, the
    reference's symmetric Jacobi equilibration D A D (d_i = 1 /
    sqrt(max_j |A_ij|)) there, a batched LU (torch.linalg.solve_ex, no
    error check on the card) and the residual computed there; only the
    unscaled solutions (row-major: the setup's native kernels read the
    stack so, and the LU returns column-major members) and one bad flag
    per member come back.  A member is bad when its LU reported a zero
    pivot (info != 0), its residual is not finite (a NaN never passes as
    a result), or the residual exceeds the reference's bound (2e-4 of
    the equilibrated right-hand side's scale); bad members are solved
    again on the host by min-norm lstsq of the equilibrated system, as
    the reference repairs them."""
    At = torch.from_numpy(np.ascontiguousarray(A, np.float64)).to(device)
    Bt = torch.from_numpy(np.ascontiguousarray(B, np.float64)).to(device)
    s = At.abs().amax(dim=2)
    d = 1.0 / torch.sqrt(torch.where(s > 0, s, torch.ones_like(s)))
    Aeq = At * d[:, :, None] * d[:, None, :]
    Beq = Bt * d[:, :, None]
    X, info = torch.linalg.solve_ex(Aeq, Beq, check_errors=False)
    res = (Beq - Aeq @ X).abs().amax(dim=(1, 2))
    scale = Beq.abs().amax(dim=(1, 2)).clamp(min=1.0)
    bad = (info != 0) | ~torch.isfinite(res) | (res > 2e-4 * scale)
    Y = (X * d[:, :, None]).contiguous().cpu().numpy()
    for j in np.flatnonzero(bad.cpu().numpy()):
        sj = np.abs(A[j]).max(axis=1)
        dj = 1.0 / np.sqrt(np.where(sj > 0, sj, 1.0))
        Y[j] = np.linalg.lstsq(A[j] * dj[:, None] * dj[None, :],
                               B[j] * dj[:, None], rcond=1e-12)[0] \
            * dj[:, None]
    return Y


def batched_svd_basis(mats, backend="auto", device=None):
    """Left singular vectors + singular values for a ragged list of (n_i, k)
    matrices (the trace/null SVD stage). Returns list of (U_i, s_i).

    backend 'device' runs one f64 torch.linalg.svd per shape group on
    `device` (None: the card; a member with a non-finite result is done
    again on the host); 'auto' takes the device only when a device is
    given, the batch holds >= 64 matrices and they are f32, as the
    reference's rule does on an accelerator backend."""
    n_items = len(mats)
    if n_items == 0:
        return []
    if backend == "auto":
        backend = "host"
        if (device is not None and n_items >= 64
                and all(m.dtype == np.float32 for m in mats[:1])):
            backend = "device"
    if backend == "host":
        out = []
        for T in mats:
            if T.shape[0] == 0 or T.shape[1] == 0:
                out.append((np.zeros((T.shape[0], 0)), np.zeros(0)))
            else:
                U, s, _ = np.linalg.svd(T, full_matrices=False)
                out.append((U, s))
        return out

    device = resolve_device(device)
    groups = {}
    for i, T in enumerate(mats):
        n, k = T.shape
        if n == 0 or k == 0:
            continue
        groups.setdefault((n, k), []).append(i)
    out = [(np.zeros((T.shape[0], 0)), np.zeros(0)) for T in mats]
    for (n, k), idxs in groups.items():
        Tb = np.stack([np.asarray(mats[i], np.float64) for i in idxs])
        U, s, _ = torch.linalg.svd(torch.from_numpy(Tb).to(device),
                                   full_matrices=False)
        ok = (torch.isfinite(U).all(dim=(1, 2))
              & torch.isfinite(s).all(dim=1)).cpu().numpy()
        U, s = U.cpu().numpy(), s.cpu().numpy()
        for j, i in enumerate(idxs):
            if ok[j]:
                out[i] = (U[j], s[j])
            else:
                Uh, sh, _ = np.linalg.svd(Tb[j], full_matrices=False)
                out[i] = (Uh, sh)
    return out


def weighted_svd_group(Mst, Tst):
    """Stacked M-weighted SVD: Mst (m,n,n), Tst (m,n,t) ->
    (U (m,n,min(n,t)), s (m,min(n,t))) with U^T M U = I per member.
    One stacked LAPACK call for the whole group (diagonal-M fast path)."""
    m, n, t = Tst.shape
    if t == 0 or n == 0:
        return np.zeros((m, n, 0)), np.zeros((m, 0))
    d = np.einsum("bii->bi", Mst)
    offd = Mst - d[:, :, None] * np.eye(n)
    if np.count_nonzero(offd) == 0:
        sc = np.sqrt(d)                            # (m, n)
        U, s, _ = np.linalg.svd(Tst * sc[:, :, None],
                                full_matrices=False)
        U = U / sc[:, :, None]
    else:
        w, V = np.linalg.eigh(Mst)
        w = np.maximum(w, 0.0)
        sq = np.sqrt(w)
        isq = 1.0 / np.sqrt(np.maximum(w, 1e-300))
        X = np.einsum("bij,bj,bkj->bik", V, sq, V)
        Xinv = np.einsum("bij,bj,bkj->bik", V, isq, V)
        U0, s, _ = np.linalg.svd(X @ Tst, full_matrices=False)
        U = Xinv @ U0
    return U, s


def batched_weighted_svd(Ms, Ts):
    """M-weighted SVD orthonormalization for ragged lists (the trace-stage
    hot loop): returns [(U_i, s_i)] with U^T M U = I. Groups identical
    shapes and runs ONE stacked LAPACK call per group (np.linalg batches in
    C), instead of one Python-level eigh/svd per agglomerate."""
    from parelag_tpu_torch.ops.ragged import take
    out = [None] * len(Ms)
    groups = {}
    for i, T in enumerate(Ts):
        if T.shape[1] == 0 or T.shape[0] == 0:
            out[i] = (np.zeros((T.shape[0], 0)), np.zeros(0))
            continue
        groups.setdefault(T.shape, []).append(i)
    for (n, t), idxs in groups.items():
        Mst = take(Ms, idxs, (n, n))                   # (m, n, n)
        Tst = np.stack([Ts[i] for i in idxs])          # (m, n, t)
        U, s = weighted_svd_group(Mst, Tst)
        for j, i in enumerate(idxs):
            out[i] = (U[j], s[j])
    return out


def batched_plain_svd(mats):
    """Thin-SVD (U, s) for a ragged list, one stacked LAPACK call per
    shape group (the null-bubble stage of the extensions)."""
    out = [None] * len(mats)
    groups = {}
    for i, B in enumerate(mats):
        if B.shape[0] == 0 or B.shape[1] == 0:
            out[i] = (np.zeros((B.shape[0], 0)), np.zeros(0))
            continue
        groups.setdefault(B.shape, []).append(i)
    for shape, idxs in groups.items():
        st = np.stack([mats[i] for i in idxs])
        U, sv, _ = np.linalg.svd(st, full_matrices=False)
        for j, i in enumerate(idxs):
            out[i] = (U[j], sv[j])
    return out
