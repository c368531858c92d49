"""Setup-phase compute on the rank axis: rank-batched dense work.

Counterpart of parelag_tpu/parallel/shard_setup.py.  The distributed
Coarsen (parallel.dist_coarsen) decomposes the setup into per-rank
patches whose heavy kernels are batched small dense problems (weighted
SVDs of trace targets, saddle-point solves of the extensions -- SURVEY.md
§3.5 hot loops 1-2).  The JAX package runs one rank's padded batch per
device under shard_map; here every rank's padded batch is one slice of
one stacked batch on the rank mesh's device (parallel.sharding.RankMesh),
solved by one batched torch.linalg call in the inputs' dtype (the JAX
package's jnp.linalg, no Pallas kernel).  In a process group each process
passes and solves the batches of the mesh.n_own ranks it holds (a
shard_map body has no collective here either).
"""

import numpy as np
import torch


def pad_rank_batches(batches, n_devices):
    """Stack per-rank (m_r, n, t) batches into one (n_devices * m_max, n, t)
    array (zero-padded), plus per-rank valid counts."""
    R = len(batches)
    assert R <= n_devices
    n, t = batches[0].shape[1], batches[0].shape[2]
    m_max = max(max(b.shape[0] for b in batches), 1)
    out = np.zeros((n_devices, m_max, n, t), dtype=batches[0].dtype)
    counts = np.zeros(n_devices, dtype=np.int64)
    for r, b in enumerate(batches):
        out[r, : b.shape[0]] = b
        counts[r] = b.shape[0]
    return out.reshape(n_devices * m_max, n, t), counts, m_max


def sharded_batched_svd(batches, mesh):
    """Thin SVD of every matrix in every rank's batch: one batched
    torch.linalg.svd over the padded (ndev * m_max, n, t) stack on
    mesh.device.  batches: list of (m_r, n, t) arrays, len <= mesh.n_own.
    Returns per-rank lists of (U, s) (padding removed)."""
    n_devices = mesh.n_own
    stacked, counts, m_max = pad_rank_batches(batches, n_devices)
    # padded (all-zero) members produce zero factors -- harmless
    U, s, _ = torch.linalg.svd(torch.as_tensor(stacked).to(mesh.device),
                               full_matrices=False)
    U = U.cpu().numpy().reshape(n_devices, m_max, *U.shape[1:])
    s = s.cpu().numpy().reshape(n_devices, m_max, -1)
    return [
        [(U[r, i], s[r, i]) for i in range(int(counts[r]))]
        for r in range(len(batches))]


def sharded_solve_groups(As, Bs, mesh):
    """Per-rank batched dense solves: As[r] (m_r, k, k), Bs[r] (m_r, k,
    s) -> Xs[r]; one batched torch.linalg.solve over the padded stack on
    mesh.device (the extension-stage saddle solves of dist_coarsen under
    device execution; len(As) <= mesh.n_own).  Padded members solve an
    identity system (harmless)."""
    n_devices = mesh.n_own
    R = len(As)
    k = As[0].shape[1]
    s = Bs[0].shape[2]
    m_max = max(max(a.shape[0] for a in As), 1)
    A = np.tile(np.eye(k, dtype=As[0].dtype), (n_devices, m_max, 1, 1))
    B = np.zeros((n_devices, m_max, k, s), dtype=Bs[0].dtype)
    counts = np.zeros(n_devices, dtype=np.int64)
    for r in range(R):
        A[r, : As[r].shape[0]] = As[r]
        B[r, : Bs[r].shape[0]] = Bs[r]
        counts[r] = As[r].shape[0]
    X = torch.linalg.solve(
        torch.as_tensor(A.reshape(-1, k, k)).to(mesh.device),
        torch.as_tensor(B.reshape(-1, k, s)).to(mesh.device))
    X = X.cpu().numpy().reshape(n_devices, m_max, k, s)
    return [X[r, : int(counts[r])] for r in range(R)]
