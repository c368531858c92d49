"""Distributed domain-decomposition execution on one device, the ranks
as a leading batch axis.

Counterpart of parelag_tpu/parallel/sharding.py.  The reference's
parallel model is one MPI rank per mesh subdomain with all communication
expressed through SharingMap/ParCSR halo exchanges
(src/structures/SharingMap.hpp:41-311, SURVEY.md §2.3); the JAX package
runs one rank per device of a `dd` mesh axis under shard_map.  The host
plan is the JAX package's, copied unchanged: dofs are assigned to the
rank owning their first adjacent element, and every sparse operator is
held as padded per-rank row blocks (ndev, n_loc, k) that index a virtual
global vector (rank * n_loc + slot).

The device half keeps every rank in ONE tensor on one device (a RankMesh:
the rank count and the torch device), a block (ndev, n_loc) per vector,
so each collective of the JAX step becomes an index op on that axis:

* all_gather(x).reshape(-1)        -> x.reshape(-1);
* psum(vdot(a, b))                 -> one dot over the whole block;
* psum_scatter of the restriction  -> one index_add_ of every rank's
  partial P^T r into the virtual coarse vector, reshaped (ndev, n_loc_c);
* ppermute by ring offset s        -> a gather of
  x[(d - s) % ndev, send_slots_s[(d - s) % ndev]] (all offsets at once:
  one index into the flattened block builds every rank's extended vector
  [own | ghosts of offset 0 | offset 1 | ...]);
* axis_index + dynamic_slice       -> a reshape.

Every local sparse product (the operator, the halo form's, the
prolongation's P rows) is the hand ell_spmv kernel
(ops/hopper_kernels.py) on one (ndev * n_loc, k) table whose column
indices point into the one flat vector, so a product is one launch.  The
restriction's scatter-add is index_add_, the coarsest solve a matmul, the
updates elementwise torch, as the JAX package leaves them to XLA.  The
CG scalars stay 0-d tensors: the step never reads the device on the host.

Across processes (the JAX package's multi-host runtime, the reference's
MPI ranks): make_dd_mesh inside a torch.distributed process group gives
each of the `world` processes ndev / world consecutive ranks, and the
L-level step (distributed_mg_l_step) keeps the same tables for those
ranks' rows only, with four verbs on the group (RankMesh.all_gather,
all_reduce, reduce_scatter and gather_host, the last for the setup's
numpy payloads) in place of JAX's collectives:

* the halo ppermutes  -> each process packs the send slots its ranks
  send (HaloPlan.send_slots), one all_gather of the packs, then the
  same extended-vector gather over [own blocks | gathered packs];
* psum(vdot)          -> the local dot, all_reduce;
* psum_scatter        -> the local index_add_, reduce_scatter into the
  process's coarse blocks;
* all_gather          -> all_gather (prolongation, coarsest level,
  gather_global).

In one process every verb is the identity, so the step is the
one-tensor step launch for launch.  Processes that share a card (and CPU
processes) use gloo, processes with a card each NCCL; on torch 2.11 both
take the card's tensors for all three device verbs, so none is staged
through host memory (RankMesh.staged).
"""

import os
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops.device_sparse import EllMatrix


@dataclass
class DistributedSystem:
    """Row-partitioned sparse operator + dof distribution plan."""
    ndev: int
    n_loc: int                   # padded owned dofs per device
    ndofs: int                   # true global dof count
    owner: np.ndarray            # (ndofs,) owning device
    slot: np.ndarray             # (ndofs,) local slot on owner
    virt: np.ndarray             # (ndofs,) = owner * n_loc + slot
    indices: np.ndarray          # (ndev, n_loc, k) virtual-global columns
    values: np.ndarray           # (ndev, n_loc, k)
    row_mask: np.ndarray         # (ndev, n_loc) 1 for real rows
    dinv: np.ndarray             # (ndev, n_loc) l1-Jacobi weights

    def to_local(self, x_global) -> np.ndarray:
        """Scatter a global vector to (ndev, n_loc) blocks."""
        out = np.zeros((self.ndev, self.n_loc), dtype=np.asarray(
            x_global).dtype)
        out[self.owner, self.slot] = np.asarray(x_global)
        return out

    def to_global(self, x_blocks) -> np.ndarray:
        return np.asarray(x_blocks)[self.owner, self.slot]


def owner_layout(owner, ndev):
    """(slot, n_loc, virt): padded per-device slot assignment in global
    dof order — THE virtual-global layout convention (owner * n_loc +
    slot) shared by distribute_system, dist_hierarchy.
    distribute_from_rank_rows and ghost.GhostMap."""
    owner = np.asarray(owner)
    n = owner.size
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=ndev)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.arange(n) - np.repeat(starts, counts)
    n_loc = max(int(counts.max()), 1) if n else 1
    return slot, n_loc, owner * n_loc + slot


def dof_partition(entity_dof_pattern, elem_partition) -> np.ndarray:
    """Owner of each dof = partition of its first adjacent element
    (owner-computes convention, SharingMap.hpp:52-66)."""
    de = sp.csr_matrix(entity_dof_pattern).T.tocsr()   # dof x element
    part = np.asarray(elem_partition)
    owner = np.zeros(de.shape[0], dtype=np.int64)
    nnz = np.diff(de.indptr)
    has = nnz > 0
    if de.nnz:
        owner[has] = np.minimum.reduceat(
            part[de.indices], de.indptr[:-1][has])
    return owner


def distribute_system(A, owner, ndev, dtype=np.float32) -> DistributedSystem:
    """Build the device-local padded row blocks of a global sparse matrix."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    owner = np.asarray(owner)
    slot, n_loc, virt = owner_layout(owner, ndev)

    nnz_per_row = np.diff(A.indptr)
    k = max(int(nnz_per_row.max()), 1)
    indices = np.zeros((ndev, n_loc, k), dtype=np.int32)
    values = np.zeros((ndev, n_loc, k), dtype=dtype)
    row_mask = np.zeros((ndev, n_loc), dtype=dtype)
    rows = np.repeat(np.arange(n), nnz_per_row)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
    indices[owner[rows], slot[rows], pos] = virt[A.indices]
    values[owner[rows], slot[rows], pos] = A.data
    row_mask[owner, slot] = 1.0
    l1 = np.abs(values).sum(axis=2)
    dinv = np.where(l1 > 0, 1.0 / np.maximum(l1, 1e-30), 0.0).astype(dtype)
    return DistributedSystem(ndev, n_loc, n, owner, slot, virt,
                             indices, values, row_mask, dinv)


# ---------------------------------------------------------------------- #
@dataclass
class HaloPlan:
    """Neighbor-only halo exchange plan (the SharingMap comm-pattern analog,
    SharingMap.hpp:41-311): instead of all_gather-ing the whole virtual
    vector, each device ships exactly the owned entries its neighbors read,
    one ppermute per device offset actually present in the sparsity.

    offsets:     static tuple of ring offsets s (receiver = sender + s)
    send_slots:  per offset, (ndev, m_s) local slots each device sends to
                 device (d + s) % ndev (padded with 0 — receivers never
                 read padded ghost positions)
    indices_ext: (ndev, n_loc, k) columns remapped into the extended local
                 vector [own block | ghosts of offset 0 | offset 1 | ...]
    """
    offsets: tuple
    send_slots: list
    indices_ext: np.ndarray


def build_halo_plan(system: "DistributedSystem") -> HaloPlan:
    ndev, n_loc = system.ndev, system.n_loc
    idx = system.indices.astype(np.int64)
    own = idx // n_loc

    # needs[d][src] = sorted unique remote slots device d reads from src
    needs = [dict() for _ in range(ndev)]
    for d in range(ndev):
        remote = own[d] != d
        srcs = own[d][remote]
        slots = idx[d][remote] % n_loc
        for s_dev in np.unique(srcs):
            needs[d][int(s_dev)] = np.unique(slots[srcs == s_dev])

    offsets = sorted({(d - src) % ndev
                      for d in range(ndev) for src in needs[d]})
    send_slots, widths = [], []
    for s in offsets:
        m_s = max((needs[(e + s) % ndev].get(e, np.zeros(0)).size
                   for e in range(ndev)), default=0)
        m_s = max(m_s, 1)
        tbl = np.zeros((ndev, m_s), dtype=np.int32)
        for e in range(ndev):
            sl = needs[(e + s) % ndev].get(e)
            if sl is not None:
                tbl[e, : sl.size] = sl
        send_slots.append(tbl)
        widths.append(m_s)

    # ghost layout per device: concatenated receive buffers in offset order
    base = n_loc + np.concatenate([[0], np.cumsum(widths)[:-1]]) \
        if offsets else np.zeros(0)
    ghost_pos = [dict() for _ in range(ndev)]
    for i, s in enumerate(offsets):
        for d in range(ndev):
            src = (d - s) % ndev
            sl = needs[d].get(src)
            if sl is not None:
                for p, slot in enumerate(sl):
                    ghost_pos[d][src * n_loc + int(slot)] = int(base[i]) + p

    indices_ext = np.empty_like(system.indices)
    for d in range(ndev):
        flat = idx[d].reshape(-1)
        out = np.empty(flat.size, dtype=np.int64)
        local = own[d].reshape(-1) == d
        out[local] = flat[local] % n_loc
        gp = ghost_pos[d]
        rem = np.where(~local)[0]
        for i in rem:
            out[i] = gp[int(flat[i])]
        indices_ext[d] = out.reshape(idx[d].shape).astype(
            system.indices.dtype)
    return HaloPlan(tuple(int(s) for s in offsets), send_slots, indices_ext)


@dataclass(frozen=True)
class RankMesh:
    """The `dd` axis of ndev ranks held as the leading batch axis of one
    tensor on `device` (the counterpart of a JAX Mesh over ndev
    devices).  In a process group of `world` processes this process
    (`rank`) holds the n_own = ndev / world consecutive ranks from lo;
    the verbs below are the group's collectives (the identity in one
    process) and add their calls and host seconds to `comm`."""
    ndev: int
    device: torch.device
    axis_names: tuple = ("dd",)
    world: int = 1
    rank: int = 0
    group: object = None
    comm: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_own(self):
        return self.ndev // self.world

    @property
    def lo(self):
        return self.rank * self.n_own

    @property
    def own(self):
        """This process's ranks, as a slice of the rank axis."""
        return slice(self.lo, self.lo + self.n_own)

    @property
    def backend(self):
        return dist.get_backend(self.group) if self.world > 1 else None

    @property
    def staged(self):
        """The verbs that go through host memory on this mesh's backend
        and device (STAGED)."""
        if self.world == 1 or self.device.type == "cpu":
            return []
        return list(STAGED[self.backend])

    def _timed(self, verb, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        calls, secs = self.comm.get(verb, (0, 0.0))
        self.comm[verb] = (calls + 1, secs + time.perf_counter() - t0)
        return out

    def all_gather(self, t):
        """Every process's t stacked along dim 0, in process order."""
        if self.world == 1:
            return t
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        self._timed("all_gather", dist.all_gather,
                    list(out.chunk(self.world)), t.contiguous(), self.group)
        return out

    def all_reduce(self, t):
        """The sum of every process's t."""
        if self.world == 1:
            return t
        t = t.clone()
        self._timed("all_reduce", dist.all_reduce, t, dist.ReduceOp.SUM,
                    self.group)
        return t

    def reduce_scatter(self, t):
        """Chunk p (of world equal chunks along dim 0) of the sum of
        every process's t, on process p."""
        if self.world == 1:
            return t
        chunks = list(t.contiguous().chunk(self.world))
        out = torch.empty_like(chunks[0])
        self._timed("reduce_scatter", dist.reduce_scatter, out, chunks,
                    dist.ReduceOp.SUM, self.group)
        return out

    def gather_host(self, arr):
        """Every process's numpy array, ragged along axis 0, as a list in
        process order (the sizes first, then one all_gather of the
        padded arrays; under NCCL, which takes only the card's tensors,
        through the card)."""
        arr = np.ascontiguousarray(arr)
        if self.world == 1:
            return [arr]
        dev = self.device if self.backend == "nccl" else "cpu"
        n = self.all_gather(torch.tensor([arr.shape[0]], device=dev)).cpu()
        m = max(int(n.max()), 1)
        buf = torch.zeros((m,) + arr.shape[1:],
                          dtype=torch.from_numpy(arr[:0]).dtype)
        buf[:arr.shape[0]] = torch.from_numpy(arr)
        got = self.all_gather(buf.to(dev)).cpu().numpy()
        return [got[p * m:p * m + int(n[p])] for p in range(self.world)]


#: the verbs each backend takes through host memory when the tensors are
#: on the card: none (on torch 2.11 gloo and NCCL take CUDA tensors for
#: all_gather, all_reduce and reduce_scatter, each checked on the H100)
STAGED = {"gloo": (), "nccl": ()}


def backend_for(device, cards, processes):
    """The process group's backend: "nccl" when every process of the
    host has a card of its own, else "gloo" (CPU processes, or
    processes that share a card, where NCCL refuses two ranks on one
    GPU)."""
    if torch.device(device).type == "cuda" and cards >= processes:
        return "nccl"
    return "gloo"


def ensure_distributed_initialized(device=None, init_method=None):
    """Start the torch.distributed process group of a multi-process run
    (the JAX package's multi-host runtime, the reference's mpi_session,
    src/utilities/mpiUtils.hpp:22-76) from the variables torchrun sets:
    WORLD_SIZE, RANK, LOCAL_RANK and MASTER_ADDR / MASTER_PORT, or an
    explicit init_method (e.g. "file:///tmp/store") in place of the last
    two.  A no-op in one process (no WORLD_SIZE, or 1) and once the
    group exists.  On the card each process takes cuda:LOCAL_RANK %
    device_count(); the backend is backend_for's (LOCAL_WORLD_SIZE
    processes on this host).  A WORLD_SIZE above 1 with a variable
    missing raises RuntimeError naming it: the run never quietly becomes
    one process."""
    if dist.is_initialized():
        return
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    need = ("RANK",) + (() if init_method else ("MASTER_ADDR", "MASTER_PORT"))
    missing = [k for k in need if k not in env]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {', '.join(missing)} "
                           "not set: a multi-process run needs each")
    rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend_for(dev, cards, local_world),
                            init_method=init_method or "env://",
                            world_size=world, rank=rank)


def make_dd_mesh(n_devices, device=None, group=None) -> RankMesh:
    """The `dd` rank axis of n_devices ranks on `device` (None: the card;
    RuntimeError without one).  In a process group (`group`, or the
    default one ensure_distributed_initialized starts from the
    environment) each process holds ndev / world consecutive ranks;
    n_devices must divide by the group's size."""
    ensure_distributed_initialized(device)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if n_devices % world:
        raise ValueError(f"{n_devices} ranks over {world} processes: the "
                         "rank count must divide by the process count")
    if world == 1:
        return RankMesh(int(n_devices), device)
    return RankMesh(int(n_devices), device, world=world,
                    rank=dist.get_rank(group), group=group)


def shard_blocks(mesh, blocks):
    """This process's (n_own, n_loc, ...) share of the (ndev, n_loc,
    ...) row blocks, on mesh.device."""
    return _put(np.asarray(blocks)[mesh.own], mesh)


def replicate_array(mesh, x):
    """x whole on mesh.device (every process holds the same copy)."""
    return _put(x, mesh)


def gather_global(x, mesh):
    """The host copy of the (ndev, ...) blocks whose rows mesh.own this
    process holds in x: every process's rows, on every process."""
    return mesh.all_gather(x).cpu().numpy()


def _put(x, mesh):
    return torch.as_tensor(np.ascontiguousarray(x)).to(mesh.device)


def _flat_table(indices, values, mesh, m, stride=0):
    """One (ndev * n_loc, k) EllMatrix of m columns from per-rank (ndev,
    n_loc, k) blocks whose columns index a per-rank vector of `stride`
    entries (stride 0: they already index one flat vector)."""
    ndev, n_loc, k = indices.shape
    idx = indices.astype(np.int64)
    if stride:
        idx = idx + (np.arange(ndev) * stride)[:, None, None]
    if m >= 2 ** 31:
        raise ValueError(f"{m} columns: the flat indices need more than "
                         "int32")
    return EllMatrix(
        _put(idx.reshape(ndev * n_loc, k).astype(np.int32), mesh),
        _put(values.reshape(ndev * n_loc, k), mesh), (ndev * n_loc, m))


def _ext_index(plan, n_loc, ndev):
    """The flat index that builds every rank's extended vector [own
    block | ghosts of offset 0 | offset 1 | ...] from the flattened
    (ndev, n_loc) block: rank d's ghosts of offset s are x[(d - s) %
    ndev, send_slots_s[(d - s) % ndev]] (the ppermute from d - s to d;
    padded send slots read slot 0 of the sender and are never read)."""
    d = np.arange(ndev)
    parts = [d[:, None] * n_loc + np.arange(n_loc)[None, :]]
    for s, tbl in zip(plan.offsets, plan.send_slots):
        src = (d - s) % ndev
        parts.append(src[:, None] * n_loc + tbl[src].astype(np.int64))
    ext = np.concatenate(parts, axis=1)
    return ext.shape[1], ext.reshape(-1)


def _ext_index_group(plan, n_loc, ndev, lo, m):
    """_ext_index for the m ranks from lo that this process holds: "send"
    packs, into one (m, W) block from the flattened (m, n_loc) block,
    the slots each of them sends (offset by offset, the send_slots
    widths concatenated), and the flat index "ext" builds their extended
    vectors from [own blocks | every rank's gathered pack (ndev, W)]:
    rank d's ghosts of offset s are the pack of rank (d - s) % ndev at
    that offset's columns."""
    e = np.arange(lo, lo + m)
    widths = [tbl.shape[1] for tbl in plan.send_slots]
    base = np.concatenate(([0], np.cumsum(widths)))
    W = int(base[-1])
    send = np.concatenate(
        [(e - lo)[:, None] * n_loc + tbl[e].astype(np.int64)
         for tbl in plan.send_slots] or [np.zeros((m, 0), np.int64)],
        axis=1)
    parts = [(e - lo)[:, None] * n_loc + np.arange(n_loc)[None, :]]
    for s, b0, w in zip(plan.offsets, base, widths):
        src = (e - s) % ndev
        parts.append(m * n_loc + src[:, None] * W + b0
                     + np.arange(w)[None, :])
    ext = np.concatenate(parts, axis=1)
    return ext.shape[1], ext.reshape(-1), send.reshape(-1)


def _level(system, mesh, plan=None, P_rows=None, n_coarse=None):
    """The device tables of one row-sharded operator: "A", the rows of
    every rank this process holds (mesh.own: all of them in one process)
    as one EllMatrix (halo form when `plan` is given: columns into the
    flat extended vectors, which "ext" gathers from x -- across processes
    from x and the gathered "send" packs; else into the virtual global
    vector), the "mask" and "dinv" blocks, and "P", P's rows (Pi, Pv) as
    one EllMatrix over the n_coarse coarse entries, with "Pt" its
    nonzeros (flat row, column, value) for the restriction."""
    ndev, n_loc, own = system.ndev, system.n_loc, mesh.own
    if plan is None:
        lv = dict(A=_flat_table(system.indices, system.values, mesh,
                                ndev * n_loc))
    elif mesh.world == 1:
        n_ext, ext = _ext_index(plan, n_loc, ndev)
        lv = dict(A=_flat_table(plan.indices_ext, system.values, mesh,
                                ndev * n_ext, n_ext), ext=_put(ext, mesh))
    else:
        m = mesh.n_own
        n_ext, ext, send = _ext_index_group(plan, n_loc, ndev, mesh.lo, m)
        lv = dict(A=_flat_table(plan.indices_ext[own], system.values[own],
                                mesh, m * n_ext, n_ext),
                  ext=_put(ext, mesh), send=_put(send, mesh))
    lv.update(mask=_put(system.row_mask[own], mesh),
              dinv=_put(system.dinv[own], mesh))
    if P_rows is not None:
        P_own = tuple(a[own] for a in P_rows)
        lv["P"] = _flat_table(*P_own, mesh, n_coarse)
        # the restriction scatters P's nonzeros only: the ELL padding
        # (column 0, value 0) would pile every padded slot's atomic add
        # onto one coarse entry
        Pi, Pv = (a.reshape(-1) for a in P_own)
        nz = np.flatnonzero(Pv)
        lv["Pt"] = (_put(nz // P_rows[0].shape[2], mesh),
                    _put(Pi[nz].astype(np.int64), mesh), _put(Pv[nz], mesh))
    return lv


def _one_process(mesh):
    """The Jacobi and two-level drivers run their ranks in one process,
    as the JAX package's (only the L-level step crosses processes)."""
    if mesh.world > 1:
        raise NotImplementedError(
            "this step runs in one process; across processes use "
            "distributed_mg_l_step / distributed_mg_l_pcg")


def _spmv(lv, x):
    """y = A x over every rank at once, all-gather form: the virtual
    global vector is the flattened block."""
    return (lv["A"] @ x.reshape(-1)).reshape(x.shape) * lv["mask"]


def _halo_spmv(lv, x, mesh=None):
    """y = A x, halo form: the neighbour exchange (one gather of every
    rank's ghosts; across processes, after one all_gather of the packed
    send slots) then the local product over [own | ghosts]."""
    xs = x.reshape(-1)
    if "send" in lv:
        packs = xs[lv["send"]].reshape(x.shape[0], -1)
        xs = torch.cat((xs, mesh.all_gather(packs).reshape(-1)))
    return (lv["A"] @ xs[lv["ext"]]).reshape(x.shape) * lv["mask"]


def _dot(a, b):
    """psum(vdot(a, b)): one sum over the whole (ndev, n_loc) block."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _safe(v):
    return torch.where(v != 0, v, torch.ones_like(v))


def _restrict(lv, res):
    """Every rank's partial P^T res summed into one coarse vector (the
    restriction's scatter-add and its psum / psum_scatter)."""
    rows, cols, vals = lv["Pt"]
    return torch.zeros(lv["P"].shape[1], dtype=res.dtype,
                       device=res.device).index_add_(
        0, cols, vals * res.reshape(-1)[rows])


def _prolong(lv, ec_flat, like):
    """The local rows of P applied to the gathered coarse vector."""
    return (lv["P"] @ ec_flat).reshape(like.shape) * lv["mask"]


def _cg_update(spmv, precond, x, r, z, d, dot=_dot):
    """One PCG iteration on the rank blocks (the JAX step's body, with
    its guarded divisions); dot the psum'd vdot."""
    Ad = spmv(d)
    rz = dot(r, z)
    dAd = dot(d, Ad)
    alpha = rz / _safe(dAd)
    x = x + alpha * d
    r = r - alpha * Ad
    z = precond(r)
    rz_new = dot(r, z)
    beta = rz_new / _safe(rz)
    d = z + beta * d
    return x, r, z, d


def distributed_pcg_step(mesh: RankMesh):
    """One Jacobi-preconditioned CG iteration over every rank (all-gather
    form); step(lv, x, r, z, d) with lv = _level(system, mesh)."""
    _one_process(mesh)

    def step(lv, x, r, z, d):
        return _cg_update(lambda v: _spmv(lv, v),
                          lambda v: lv["dinv"] * v * lv["mask"], x, r, z, d)

    return step


def distribute_rect(P, row_owner, ndev, n_loc, dtype=np.float64):
    """Row-distribute a rectangular operator (e.g. the interpolation P):
    local padded row blocks with REPLICATED columns (coarse dofs). Returns
    (indices (ndev, n_loc, k) into the coarse vector, values)."""
    P = sp.csr_matrix(P)
    n, nc = P.shape
    slot = np.zeros(n, dtype=np.int64)
    counts = np.zeros(ndev, dtype=np.int64)
    for d in range(n):
        slot[d] = counts[row_owner[d]]
        counts[row_owner[d]] += 1
    assert counts.max() <= n_loc
    k = max(int(np.diff(P.indptr).max()), 1)
    indices = np.zeros((ndev, n_loc, k), dtype=np.int32)
    values = np.zeros((ndev, n_loc, k), dtype=dtype)
    for r in range(n):
        a, b = P.indptr[r], P.indptr[r + 1]
        indices[row_owner[r], slot[r], : b - a] = P.indices[a:b]
        values[row_owner[r], slot[r], : b - a] = P.data[a:b]
    return indices, values


def _mg_pcg_step(spmv_of, nu, omega):
    """The two-level step of distributed_mg_pcg_step(_halo) around the
    fine product spmv_of(lv, x): step(lv, coarse_inv, x, r, z, d)."""

    def mg_apply(lv, coarse_inv, r):
        def smooth(x):
            return x + omega * lv["dinv"] * (r - spmv_of(lv, x)) * lv["mask"]

        # pre-smooth from zero: x = w D^{-1} r, then nu - 1 more sweeps
        x = omega * lv["dinv"] * r * lv["mask"]
        for _ in range(nu - 1):
            x = smooth(x)
        # residual + restriction (every rank's partial P^T r, summed)
        res = (r - spmv_of(lv, x)) * lv["mask"]
        ec = coarse_inv @ _restrict(lv, res)
        # interpolate + correct (local rows of P), post-smooth
        x = x + _prolong(lv, ec, x)
        for _ in range(nu):
            x = smooth(x)
        return x

    def step(lv, coarse_inv, x, r, z, d):
        return _cg_update(lambda v: spmv_of(lv, v),
                          lambda v: mg_apply(lv, coarse_inv, v), x, r, z, d)

    return step


def distributed_mg_pcg_step(mesh: RankMesh, nu=2, omega=1.0):
    """One PCG iteration preconditioned by a distributed two-level cycle:
    l1-Jacobi smoothing on the distributed fine level, the restriction
    summed over ranks into a REPLICATED coarse level solved by a dense
    inverse, local interpolation back (the JAX step's gathered-coarse-
    grid design).  step(lv, coarse_inv, x, r, z, d) with lv =
    _level(system, mesh, None, (Pi, Pv), n_coarse)."""
    _one_process(mesh)
    return _mg_pcg_step(_spmv, nu, omega)


def distributed_mg_pcg_step_halo(mesh: RankMesh, plan: HaloPlan, nu=2,
                                 omega=1.0):
    """distributed_mg_pcg_step with the neighbour-only halo exchange in
    every fine product (fine smoothing, residual, the CG matvec) instead
    of the all-gather: only the entries the neighbours read move.  lv =
    _level(system, mesh, plan, (Pi, Pv), n_coarse) carries the plan's
    tables."""
    _one_process(mesh)
    return _mg_pcg_step(_halo_spmv, nu, omega)


def distributed_mg_pcg(system: DistributedSystem, P_scipy, A_coarse,
                       b_global, mesh: RankMesh, iters=20,
                       dtype=np.float64, nu=2, omega=0.7, halo=False):
    """Distributed two-level MG-PCG solve; returns the global solution.
    halo=True uses the neighbour-only exchange (HaloPlan) instead of the
    all-gather."""
    Pi, Pv = distribute_rect(P_scipy, system.owner, system.ndev,
                             system.n_loc, dtype=dtype)
    coarse_inv = np.linalg.inv(np.asarray(
        A_coarse.todense() if sp.issparse(A_coarse) else A_coarse)
    ).astype(dtype)
    system = _cast(system, dtype)
    plan = build_halo_plan(system) if halo else None
    lv = _level(system, mesh, plan, (Pi, Pv), coarse_inv.shape[0])
    cinv = _put(coarse_inv, mesh)
    b = _put(system.to_local(np.asarray(b_global, dtype=dtype)), mesh)
    step = (distributed_mg_pcg_step_halo(mesh, plan, nu=nu, omega=omega)
            if halo else distributed_mg_pcg_step(mesh, nu=nu, omega=omega))
    # initialization trick: one step with d = 0 leaves (x, r) unchanged
    # and produces z = MG(r), d = z -- the correct PCG start
    x, r, z, d = torch.zeros_like(b), b, b, torch.zeros_like(b)
    x, r, z, d = step(lv, cinv, x, r, z, d)
    for _ in range(iters):
        x, r, z, d = step(lv, cinv, x, r, z, d)
    return system.to_global(x.cpu().numpy())


def _cast(system, dtype):
    """system with its floating blocks in dtype (the JAX drivers' arrays
    take the dtype of what they are given)."""
    if system.values.dtype == np.dtype(dtype):
        return system
    from dataclasses import replace
    return replace(system, values=system.values.astype(dtype),
                   row_mask=system.row_mask.astype(dtype),
                   dinv=system.dinv.astype(dtype))


# ---------------------------------------------------------------------- #
# Distributed L-level multigrid
# ---------------------------------------------------------------------- #
@dataclass
class DistributedHierarchy:
    """L-level distributed MG: every level's operator is row-sharded with
    its own HaloPlan; restriction reduces partial P^T r contributions with
    psum_scatter (reduce-scatter over ICI); prolongation all_gathers the
    (geometrically shrinking) coarse block; the coarsest level applies a
    replicated dense inverse. The reference's analog is hypre's parallel
    V-cycle over ParCSR operators (SURVEY.md §2.3)."""
    systems: list                # DistributedSystem per level 0..L-1
    plans: list                  # HaloPlan per level
    P_rows: list                 # (Pi, Pv) per level: row-sharded by fine
                                 # owner, columns = coarse VIRTUAL ids
    coarse_inv: np.ndarray       # replicated dense inverse of level L
    owners: list                 # dof owner per level


    def device_args(self, mesh: RankMesh):
        """The level tables on mesh.device, built once (_level) from the
        rows of the ranks this process holds (mesh.own): per level A in
        the halo form, the ext gather (and across processes the send
        packs), the mask and dinv blocks and, above the coarsest, P's
        rows; the replicated dense inverse of the coarsest level and g2v,
        the virtual index of each global coarsest dof.  Returns (levels,
        coarse_inv, g2v)."""
        lv = []
        n = len(self.systems)
        for l, (s, p) in enumerate(zip(self.systems, self.plans)):
            coarse = l < n - 1
            lv.append(_level(
                s, mesh, p, self.P_rows[l] if coarse else None,
                s.ndev * self.systems[l + 1].n_loc if coarse else None))
        g2v = replicate_array(mesh, self.systems[-1].virt.astype(np.int64))
        return lv, replicate_array(mesh, self.coarse_inv), g2v


def coarse_owner_from_P(P, fine_owner):
    """Owner of a coarse dof = owner of its first fine dof (owner-computes,
    the SharingMap convention for coarse SharingMaps)."""
    Pc = sp.csc_matrix(P)
    owner = np.zeros(Pc.shape[1], dtype=np.int64)
    for c in range(Pc.shape[1]):
        rows = Pc.indices[Pc.indptr[c]:Pc.indptr[c + 1]]
        owner[c] = fine_owner[rows].min() if rows.size else 0
    return owner


def build_distributed_hierarchy(A_levels, P_levels, fine_owner, ndev,
                                dtype=np.float64) -> DistributedHierarchy:
    """A_levels: host CSR per level (finest first, coarsest last);
    P_levels: interpolations; fine_owner: dof owner vector at level 0."""
    owners = [np.asarray(fine_owner)]
    for P_l in P_levels:
        owners.append(coarse_owner_from_P(P_l, owners[-1]))
    systems, plans, P_rows = [], [], []
    for l, P_l in enumerate(P_levels):
        s = distribute_system(A_levels[l], owners[l], ndev, dtype=dtype)
        systems.append(s)
        plans.append(build_halo_plan(s))
        # coarse layout (needed for virtual column ids of P)
        s_c = distribute_system(A_levels[l + 1], owners[l + 1], ndev,
                                dtype=dtype)
        P_csr = sp.csr_matrix(P_levels[l])
        Pv_virt = sp.csr_matrix(
            (P_csr.data, s_c.virt[P_csr.indices], P_csr.indptr),
            shape=(P_csr.shape[0], ndev * s_c.n_loc))
        Pi, Pv = distribute_rect(Pv_virt, owners[l], ndev, s.n_loc,
                                 dtype=dtype)
        P_rows.append((Pi, Pv))
        if l == len(P_levels) - 1:
            systems.append(s_c)
            plans.append(build_halo_plan(s_c))
    coarse_inv = np.linalg.inv(A_levels[-1].toarray()).astype(dtype)
    return DistributedHierarchy(systems, plans, P_rows, coarse_inv, owners)


def distributed_mg_l_step(mesh: RankMesh, hierarchy: DistributedHierarchy,
                          nu=2, omega=0.7):
    """One MG(L-level V-cycle)-preconditioned CG iteration over the
    ranks this process holds.  As in the JAX package it returns
    bind(levels_args) -> step; step(levels, coarse_inv, g2v, x, r, z, d)
    -> (x, r, z, d), levels from DistributedHierarchy.device_args, the
    vectors this process's (n_own, n_loc) blocks.  The collectives are
    mesh's verbs (the identity in one process)."""
    ndev, own = mesh.ndev, mesh.own
    n_levels = len(hierarchy.systems)
    n_locs = [s.n_loc for s in hierarchy.systems]

    def spmv(lv, x):
        return _halo_spmv(lv, x, mesh)

    def dot(a, b):
        return mesh.all_reduce(_dot(a, b))

    def smooth(lv, r, x):
        return x + omega * lv["dinv"] * (r - spmv(lv, x)) * lv["mask"]

    def vcycle(l, levels, coarse_inv, g2v, r):
        if l == n_levels - 1:
            # replicated coarse solve: the gathered coarse vector
            # (virtual layout) reordered to global, solved, scattered
            # back, this process's blocks kept
            e = coarse_inv @ mesh.all_gather(r).reshape(-1)[g2v]
            ep = torch.zeros(ndev * n_locs[l], dtype=r.dtype,
                             device=r.device)
            ep[g2v] = e
            return ep.reshape(ndev, n_locs[l])[own]
        lv = levels[l]
        x = omega * lv["dinv"] * r * lv["mask"]
        for _ in range(nu - 1):
            x = smooth(lv, r, x)
        res = (r - spmv(lv, x)) * lv["mask"]
        # restriction: the partial P^T res of this process's ranks in
        # the coarse VIRTUAL layout, summed over processes and split
        # into their coarse blocks
        rc = mesh.reduce_scatter(_restrict(lv, res)).reshape(
            -1, n_locs[l + 1])
        ec = vcycle(l + 1, levels, coarse_inv, g2v, rc)
        # prolongation: the gathered coarse vector, local P rows
        x = x + _prolong(lv, mesh.all_gather(ec).reshape(-1), x)
        for _ in range(nu):
            x = smooth(lv, r, x)
        return x

    def bind(levels_args):
        def step(levels, coarse_inv, g2v, x, r, z, d):
            return _cg_update(
                lambda v: spmv(levels[0], v),
                lambda v: vcycle(0, levels, coarse_inv, g2v, v), x, r, z, d,
                dot)

        return step

    return bind


def distributed_mg_l_pcg(hier: DistributedHierarchy, b_global,
                         mesh: RankMesh, iters=20, dtype=np.float64, nu=2,
                         omega=0.7):
    """Distributed L-level MG-PCG driver; returns the global solution on
    every process (the reference's analog is hypre's ParCSR V-cycle over
    an MPI world, ParELAG_Hierarchy.cpp:109-253)."""
    levels_args, cinv, g2v = hier.device_args(mesh)
    step = distributed_mg_l_step(mesh, hier, nu=nu, omega=omega)(
        levels_args)
    s0 = hier.systems[0]
    b = shard_blocks(mesh, s0.to_local(np.asarray(b_global, dtype=dtype)))
    x, r, z, d = torch.zeros_like(b), b, b, torch.zeros_like(b)
    # init step with d = 0: z becomes MG(r), (x, r) unchanged
    x, r, z, d = step(levels_args, cinv, g2v, x, r, z, d)
    for _ in range(iters):
        x, r, z, d = step(levels_args, cinv, g2v, x, r, z, d)
    return s0.to_global(gather_global(x, mesh))


def distributed_pcg(system: DistributedSystem, b_global, mesh: RankMesh,
                    iters=20, dtype=np.float32):
    """Run `iters` distributed PCG iterations; returns the global
    solution."""
    system = _cast(system, dtype)
    step = distributed_pcg_step(mesh)
    lv = _level(system, mesh)
    b = _put(system.to_local(np.asarray(b_global, dtype=dtype)), mesh)
    x = torch.zeros_like(b)
    r = b
    z = lv["dinv"] * r
    d = z
    for _ in range(iters):
        x, r, z, d = step(lv, x, r, z, d)
    return system.to_global(x.cpu().numpy())
