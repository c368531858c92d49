"""Multi-process runs of the distributed plane: several processes, each
holding its own ranks (parallel.sharding.make_dd_mesh in a
torch.distributed group).

    python -m parelag_tpu_torch.parallel.mp_worker --case solve --world 2 \
        --device cpu
    python -m parelag_tpu_torch.parallel.mp_worker --case dist --world 2 \
        --ny-per-rank 32                                    # on the card
    torchrun --nproc-per-node 2 -m parelag_tpu_torch.parallel.mp_worker \
        --case setup

Counterpart of the JAX package's tests/_mp_worker.py and
tests/_mp_setup_worker.py (the reference's mpirun -np 2 CTest lanes,
cmake/modules/ParELAGCMakeUtilities.cmake:422-436).  Run without the
process variables (RANK, WORLD_SIZE) the command is the launcher
(launch): it starts `--world` copies of itself with them set and prints
each process's record as a JSON line; a copy (or a process torchrun
started) runs the case and prints its record on a line of its own after
"MPREC ".  Cases:

* solve: the JAX worker's problem (8 x 8 x 4 hex grid, two 2 x 2 x 2
  coarsenings, 8 rank blocks, f64): the serial setup on every process,
  then 30 iterations of distributed_mg_l_pcg; err against spsolve, a
  digest of x and the sha256 of the level tables (solve_problem builds
  the same hierarchy in any process).
* setup: the JAX setup worker's problem (the same grid, 2 ranks: the
  x-halves of the 4 top-level agglomerates); each process coarsens only
  its own ranks' patches, the numbering metadata and the owner-published
  P and A triplets go through RankMesh.gather_host, and the assembled
  operators are held against the one-process distributed setup
  (A_err relative per level, P_err absolute).
* dist: the dist lane's shape (parallel.dist_bench.problem: 8 ranks, 4
  levels, M + D^T W D, f32) set up as in `setup`, the DistMLSetup fields
  rebuilt from the gathered payloads and build_hierarchy_from_setup,
  then WARMUP discarded and `--steps` timed L-level PCG steps
  (dist_bench.time_steps): setup_s, step_s, the collectives' calls and
  host seconds in the timed steps and their share of them, the timed
  steps' kernel launches, and `digest`, the sha256 of the level tables
  (equal to the one-process lane's, byte for byte); on the card also
  each process's device busy a step and idle share (torch.profiler).
* ghost: GhostMap's distribute / assemble and shard_setup's batched SVDs
  and solves on each process's ranks, against their host semantics.

Every record names world, rank, the backend, the staged verbs and the
whole run's kernel launches (`launches`); --x-out writes process 0's x.
Each process sets its torch thread count to its share of the host's
cores and never imports jax.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import hopper_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORM = 0
RANKS = 8            # the solve and dist cases' rank blocks
SETUP_RANKS = 2      # the setup case's (the JAX setup worker's)
GHOST_RANKS = 4      # the ghost case's (tests/test_ghost.py's)


def _digest(x):
    return float(np.dot(x, np.arange(x.size) % 97))


def _h1_operator(seq):
    M = seq.compute_mass_operator(FORM)
    W = seq.compute_mass_operator(FORM + 1)
    return (M + seq.D[FORM].T @ W @ seq.D[FORM]).tocsr()


def _patch_A(p):
    return _h1_operator(p.seqs[0])


def solve_problem():
    """The JAX _mp_worker's problem: (the f64 DistributedHierarchy over
    RANKS, the fine operator A0, the right-hand side b)."""
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.parallel.sharding import (
        build_distributed_hierarchy, dof_partition)
    from parelag_tpu_torch.partitioning.partitioners import (
        cartesian_partition)
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology

    m = hex_grid_mesh(8, 8, 4)
    topo = AgglomeratedTopology.from_mesh(m)
    topo.coarsen_local_partitioning(cartesian_partition((8, 8, 4),
                                                        (2, 2, 2)))
    topo.coarser.coarsen_local_partitioning(
        cartesian_partition((4, 4, 2), (2, 2, 2)))
    seqs = [DeRhamSequenceFE(topo, m)]
    seqs[0].set_upscaling_targets(0)
    seqs.append(seqs[0].coarsen())
    seqs.append(seqs[1].coarsen())
    A0 = _h1_operator(seqs[0])
    P_levels = [seqs[0].P[0].tocsr(), seqs[1].P[0].tocsr()]
    A_levels = [A0]
    for P in P_levels:
        A_levels.append((P.T @ A_levels[-1] @ P).tocsr())
    elem_part = cartesian_partition((8, 8, 4), (4, 4, 2))
    owner = dof_partition(seqs[0].dof[0].entity_dof_pattern(0), elem_part)
    hier = build_distributed_hierarchy(A_levels, P_levels, owner, RANKS)
    return hier, A0, np.random.RandomState(7).randn(A0.shape[0])


def case_solve(args, mesh):
    """The JAX _mp_worker's solve; `digest` of x and `tables`, the
    sha256 of the level tables (dist_bench.table_digest)."""
    import scipy.sparse.linalg as spla
    from parelag_tpu_torch.parallel import dist_bench
    from parelag_tpu_torch.parallel.sharding import distributed_mg_l_pcg

    hier, A0, b = solve_problem()
    t0 = time.perf_counter()
    x = distributed_mg_l_pcg(hier, b, mesh, iters=30, dtype=np.float64)
    solve_s = time.perf_counter() - t0
    xref = spla.spsolve(A0.tocsc(), b)
    err = float(np.abs(x - xref).max() / max(np.abs(xref).max(), 1.0))
    return dict(err=err, digest=_digest(x), solve_s=solve_s,
                tables=dist_bench.table_digest(hier),
                comm=dict(mesh.comm)), x


def group_setup(mesh, m, rank_of_elem, partitions, n_ranks, A_fn,
                rhs_fn=None, dim=3):
    """The distributed setup with each process coarsening only the
    patches of its own ranks (distributed_coarsen_multilevel(ranks=
    ...)), the JAX setup worker's protocol for mesh.n_own ranks a
    process: the fine owner (min adjacent element rank) from the
    gathered per-process minima, each level's numbering from the
    gathered owned metadata, the owner-published P triplets and every
    rank's owned operator rows gathered (RankMesh.gather_host, rank
    order).  Returns (setup, b): a DistMLSetup
    whose A_rows, owners, ndofs and P_published are every rank's (its
    numberings and fine_gids this process's), and the fine rhs summed
    from every process's owned entries (rhs_fn(patch), or None)."""
    from parelag_tpu_torch.parallel.dist_coarsen import (
        CoarseNumbering, fine_dof_gids)
    from parelag_tpu_torch.parallel.dist_hierarchy import (
        DistMLSetup, distributed_coarsen_multilevel, distributed_rhs,
        numbering_offsets_from_meta, patch_loc2glob_from_meta,
        patch_numbering_meta, rank_fine_rows, rank_operator_rows_level,
        rank_P_rows_level)

    gather = mesh.gather_host
    patches, gents = distributed_coarsen_multilevel(
        m, rank_of_elem, partitions, n_ranks, upscaling_order=0,
        ranks=list(range(mesh.lo, mesh.lo + mesh.n_own)))
    n_coarsen = len(patches[0].seqs) - 1
    fine_gids = [fine_dof_gids(p, gents, FORM, dim) for p in patches]
    n_fine = int(np.concatenate(gather(np.asarray(
        [g.max() for g in fine_gids], np.int64))).max()) + 1
    mine = np.full(n_fine, np.iinfo(np.int64).max, dtype=np.int64)
    for p, fg in zip(patches, fine_gids):
        pat = sp.csr_matrix(
            p.seqs[0].dof[FORM].entity_dof_pattern(0)).T.tocoo()
        ranks = np.asarray(rank_of_elem)[p.elem_gids]
        np.minimum.at(mine, fg[pat.row], ranks[pat.col])
    fine_owner = np.minimum.reduce(gather(mine[None, :]))[0]

    def gather_triplets(trips, with_rank=False):
        """Every rank's (rows, cols, vals) in rank order: one
        concatenation, or (with_rank) a list over ranks."""
        rc = [np.stack([np.full(r.size, p.rank), r, c], axis=1).astype(
            np.int64) for p, (r, c, _) in zip(patches, trips)]
        rc = np.concatenate(gather(np.concatenate(rc)))
        v = np.concatenate(gather(np.concatenate([t[2] for t in trips])))
        if not with_rank:
            return rc[:, 1], rc[:, 2], v
        return [(rc[rc[:, 0] == r, 1], rc[rc[:, 0] == r, 2],
                 v[rc[:, 0] == r]) for r in range(n_ranks)]

    max_codim = dim - FORM
    numberings, published = [], []
    num_prev = None
    for lvl in range(n_coarsen):
        metas = [patch_numbering_meta(p, gents, FORM, lvl + 1, dim)
                 for p in patches]
        # the owned rows: [rank, codim, rep, mcnt, msum, count]
        rows = [np.zeros((0, 6), np.int64)]
        for p, meta in zip(patches, metas):
            for codim, (reps, mcnt, msum, orank, counts) in meta.items():
                own = np.nonzero(orank == p.rank)[0]
                rows.append(np.stack([
                    np.full(own.size, p.rank), np.full(own.size, codim),
                    reps[own], mcnt[own], msum[own], counts[own]],
                    axis=1).astype(np.int64))
        got = np.concatenate(gather(np.concatenate(rows)))
        metas_by_rank = []
        for r in range(n_ranks):
            mat = got[got[:, 0] == r]
            md = {}
            for codim in range(max_codim, -1, -1):
                sel = mat[mat[:, 1] == codim]
                md[codim] = (sel[:, 2], sel[:, 3], sel[:, 4],
                             np.full(sel.shape[0], r, np.int64), sel[:, 5])
            metas_by_rank.append((r, md))
        ndofs, offset_of, sig_of, owner = numbering_offsets_from_meta(
            metas_by_rank, max_codim)
        loc2glob = {p.rank: patch_loc2glob_from_meta(
            p, meta, offset_of, sig_of, FORM, lvl + 1, dim)
            for p, meta in zip(patches, metas)}
        num = CoarseNumbering(ndofs, loc2glob, owner)
        published.append(gather_triplets([
            rank_P_rows_level(p, gents, num_prev, num, FORM, lvl, dim)
            for p in patches]))
        numberings.append(num)
        num_prev = num

    A_rows = [gather_triplets([
        rank_fine_rows(p, gents, FORM, A_fn, fine_owner, n_fine, dim)
        for p in patches], with_rank=True)]
    for lvl in range(1, n_coarsen + 1):
        A_rows.append(gather_triplets([
            rank_operator_rows_level(p, gents, published, numberings, FORM,
                                     lvl, A_fn, n_fine, dim)
            for p in patches], with_rank=True))
    setup = DistMLSetup(
        n_coarsen + 1, [n_fine] + [n.ndofs for n in numberings],
        [fine_owner] + [n.owner_of_global for n in numberings], A_rows,
        published, numberings, fine_gids)
    b = None
    if rhs_fn is not None:
        b = np.concatenate(gather(
            distributed_rhs(setup, patches, rhs_fn)[None, :])).sum(axis=0)
    return setup, b


def _assembled(rows_by_rank, n):
    rows, cols, vals = (np.concatenate([t[i] for t in rows_by_rank])
                        for i in range(3))
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def case_setup(args, mesh):
    """The JAX _mp_setup_worker's check: this run's per-process setup
    against the one-process distributed setup."""
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.parallel.dist_hierarchy import (
        compose_partitions, distributed_coarsen_multilevel,
        distributed_operator_setup)
    from parelag_tpu_torch.partitioning.partitioners import (
        cartesian_partition)

    m = hex_grid_mesh(8, 8, 4)
    partitions = [cartesian_partition((8, 8, 4), (2, 2, 2)),
                  cartesian_partition((4, 4, 2), (2, 2, 2))]
    comp = compose_partitions(partitions)
    rank_of_elem = (np.arange(int(comp[-1].max()) + 1)
                    % SETUP_RANKS)[comp[-1]]
    setup, _ = group_setup(mesh, m, rank_of_elem, partitions, SETUP_RANKS,
                           _patch_A)
    patches, gents = distributed_coarsen_multilevel(
        m, rank_of_elem, partitions, SETUP_RANKS, upscaling_order=0)
    ref = distributed_operator_setup(patches, gents, FORM, _patch_A,
                                     rank_of_elem)
    A_err, digest = [], 0.0
    for lvl in range(ref.n_levels):
        A = _assembled(setup.A_rows[lvl], setup.ndofs[lvl])
        A_ref = _assembled(ref.A_rows[lvl], ref.ndofs[lvl])
        d = abs(A - A_ref)
        A_err.append(float((d.max() if d.nnz else 0.0) / abs(A_ref).max()))
        digest += float(np.abs(A.data).sum())
    P_err, P_pattern = [], []
    for (r0, c0, v0), (r1, c1, v1) in zip(setup.P_published,
                                          ref.P_published):
        k0, k1 = np.lexsort((c0, r0)), np.lexsort((c1, r1))
        P_pattern.append(bool(np.array_equal(r0[k0], r1[k1])
                              and np.array_equal(c0[k0], c1[k1])))
        P_err.append(float(np.abs(v0[k0] - v1[k1]).max())
                     if P_pattern[-1] else float("inf"))
    return dict(levels=setup.n_levels, ndofs=list(map(int, setup.ndofs)),
                ref_ndofs=list(map(int, ref.ndofs)), A_err=A_err,
                P_err=P_err, P_pattern=P_pattern, digest=digest), None


def case_dist(args, mesh):
    """The dist lane with each process setting up its own ranks."""
    from parelag_tpu_torch.parallel import dist_bench
    from parelag_tpu_torch.parallel.dist_hierarchy import (
        build_hierarchy_from_setup)

    if mesh.device.type == "cuda":
        hopper_kernels.load()
    t0 = time.perf_counter()
    m, partitions, rank_of_elem, patch_A, rhs_fn = dist_bench.problem(
        RANKS, args.ny_per_rank)
    setup, b = group_setup(mesh, m, rank_of_elem, partitions, RANKS,
                           patch_A, rhs_fn)
    hier = build_hierarchy_from_setup(setup, RANKS, dtype=np.float32)
    setup_s = time.perf_counter() - t0
    x, dt, kernels, comm = dist_bench.time_steps(hier, b, mesh, args.steps)
    comm_s = sum(secs for _, secs in comm.values())
    rec = dist_bench.record(setup, b, x, n_devices=RANKS,
                            ny_per_rank=args.ny_per_rank, setup_s=setup_s,
                            step_s=dt, steps=args.steps, kernels=kernels,
                            device=mesh.device)
    rec.update(digest=dist_bench.table_digest(hier),
               comm={k: dict(calls=c, s=t) for k, (c, t) in comm.items()},
               comm_s_per_step=comm_s / args.steps,
               comm_share=comm_s / (dt * args.steps))
    if mesh.device.type == "cuda":
        rec.update(_device_busy(dist_bench.steps_from_zero(hier, b, mesh),
                                args.steps, dt))
    return rec, x


def _device_busy(run, steps, step_s):
    """This process's device time in the init step and `steps` more
    under torch.profiler (kernel_profile._profile; every process traces
    the same steps, so the collectives stay matched): busy seconds a
    step, the idle share against the timed step_s and the four largest
    entries; traced_launches below launches_profiled flags a trace that
    dropped device events.  Under NCCL the busy time holds the NCCL
    kernels' waits for their peers."""
    from parelag_tpu_torch.kernel_profile import _profile
    run(0)
    before = sum(hopper_kernels.LAUNCHES.values())
    _, by = _profile(lambda: run(steps), 1)
    # the process group's "gloo:..." / "nccl:..." ranges annotate the
    # stream; they are not device work of their own
    by = {k: v for k, v in by.items()
          if not k.startswith(("torch: gloo:", "torch: nccl:"))}
    busy = sum(v[0] for v in by.values()) / 1e6 / (steps + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:4]
    return dict(device_busy_s_per_step=busy, idle_share=1 - busy / step_s,
                device_top_ms_per_step={k: v[0] / 1e3 / (steps + 1)
                                        for k, v in top},
                traced_launches=sum(v[1] for k, v in by.items()
                                    if k in hopper_kernels.LAUNCHES),
                launches_profiled=sum(hopper_kernels.LAUNCHES.values())
                - before)


def case_ghost(args, mesh):
    """GhostMap's device verbs (tests/test_ghost.py's facet exchange:
    4^3 hexes on 4 ranks) and the rank-batched setup solves of
    shard_setup on this process's ranks, against the host semantics
    (GhostMap.distribute / assemble, numpy's SVD and solve): the max
    abs errors.  A padded ghost contribution of 1e3 must reach no
    entity."""
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.parallel import shard_setup
    from parelag_tpu_torch.parallel.ghost import GhostMap
    from parelag_tpu_torch.parallel.sharding import (
        gather_global, shard_blocks)
    from parelag_tpu_torch.partitioning.partitioners import (
        cartesian_partition)
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology

    B0 = AgglomeratedTopology.from_mesh(hex_grid_mesh(4, 4, 4)).B[0].tocsr()
    rank_of_elem = cartesian_partition((4, 4, 4), (2, 2, 4))
    owner = np.full(B0.shape[1], GHOST_RANKS, dtype=np.int64)
    coo = B0.tocoo()
    np.minimum.at(owner, coo.col, rank_of_elem[coo.row])
    gm = GhostMap.build(owner, [np.unique(B0[rank_of_elem == r].indices)
                                for r in range(GHOST_RANKS)])
    rng = np.random.RandomState(1)
    vals = rng.randn(owner.size)
    contribs = [rng.randn(g.size) for g in gm.ghosts]
    gvirt, dist_fn, asm_fn = gm.device_fns(mesh)
    blocks = shard_blocks(mesh, gm.to_blocks(vals))
    ghost = gather_global(dist_fn(blocks, gvirt), mesh)
    mask = gm.ghost_mask()
    dist_err = max(float(np.abs(ghost[r, :g.size] - ref).max(initial=0.0))
                   for r, (g, ref) in enumerate(zip(
                       gm.ghosts, gm.distribute(vals))))
    cpad = np.where(mask, 0.0, 1e3)
    for r, c in enumerate(contribs):
        cpad[r, :c.size] = c
    out = gather_global(asm_fn(blocks, shard_blocks(mesh, cpad), gvirt),
                        mesh)
    asm_err = float(np.abs(gm.from_blocks(out)
                           - gm.assemble(vals, contribs)).max())
    batches = [rng.randn(3 + r, 12, 4) for r in range(GHOST_RANKS)]
    svd_err = 0.0
    for b, per_rank in zip(batches[mesh.own], shard_setup.sharded_batched_svd(
            batches[mesh.own], mesh)):
        for a, (U, sv) in zip(b, per_rank):
            Uh, sh, _ = np.linalg.svd(a, full_matrices=False)
            svd_err = max(svd_err, float(np.abs(sv - sh).max()),
                          float(np.abs(np.abs(U.T @ Uh) - np.eye(4)).max()))
    As = [rng.randn(2 + r, 6, 6) + 6 * np.eye(6) for r in range(GHOST_RANKS)]
    Bs = [rng.randn(a.shape[0], 6, 3) for a in As]
    Xs = shard_setup.sharded_solve_groups(As[mesh.own], Bs[mesh.own], mesh)
    solve_err = max(float(np.abs(X - np.linalg.solve(a, b)).max())
                    for a, b, X in zip(As[mesh.own], Bs[mesh.own], Xs))
    return dict(distribute_err=dist_err, assemble_err=asm_err,
                svd_err=svd_err, solve_err=solve_err,
                n_batches=len(Xs)), None


#: case -> (function, rank count)
CASES = {"solve": (case_solve, RANKS), "setup": (case_setup, SETUP_RANKS),
         "dist": (case_dist, RANKS), "ghost": (case_ghost, GHOST_RANKS)}


def run_process(args):
    """One process of the group (RANK and WORLD_SIZE set): the case's
    record, printed after "MPREC "."""
    from parelag_tpu_torch.parallel.sharding import (
        ensure_distributed_initialized, make_dd_mesh)
    import torch.distributed as dist

    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    ensure_distributed_initialized(args.device, args.init_method)
    fn, n_ranks = CASES[args.case]
    mesh = make_dd_mesh(n_ranks, args.device)
    rec, x = fn(args, mesh)
    rec.update(case=args.case, world=mesh.world, rank=mesh.rank,
               backend=mesh.backend, staged=mesh.staged,
               device=str(mesh.device),
               launches=dict(hopper_kernels.LAUNCHES),
               imports_jax=sorted({k.split(".")[0] for k in sys.modules}
                                  & {"jax", "jaxlib", "parelag_tpu"}))
    if x is not None and args.x_out and mesh.rank == 0:
        np.save(args.x_out, x)
    print("MPREC " + json.dumps(rec), flush=True)
    dist.destroy_process_group()


def launch(world, case, ny_per_rank=4, device=None, steps=20,
           x_out=None, timeout=600):
    """Run `case` in `world` processes on `device` (None: the card;
    device="cpu" for CPU processes) joined through a file:// store in a
    temporary directory; returns each process's record, in rank order.
    A process that exits non-zero, or a run past `timeout` seconds
    (every process is then killed), raises."""
    device = resolve_device(device)
    if device.type == "cuda":
        hopper_kernels.load()        # the children load this build
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "parelag_tpu_torch.parallel.mp_worker",
               "--case", case, "--world", str(world), "--ny-per-rank",
               str(ny_per_rank), "--steps", str(steps), "--device",
               device.type, "--init-method",
               "file://" + os.path.join(tmp, "store")]
        if x_out:
            cmd += ["--x-out", str(x_out)]
        env = dict(os.environ, WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world),
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT,
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + timeout
        try:
            # until every process is done, one has failed (the others
            # would wait in a collective) or the time is up
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mp_worker --case {case} --world {world}: over "
                        f"{timeout} s\n" + _tails(logs))
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"mp_worker --case {case} --world {world}: "
                               f"process(es) {bad} failed\n" + _tails(logs))
        recs = []
        for log in logs:
            with open(log) as f:
                lines = [ln for ln in f if ln.startswith("MPREC ")]
            recs.append(json.loads(lines[-1][len("MPREC "):]))
    return recs


def _tails(logs, n=3000):
    out = []
    for r, log in enumerate(logs):
        with open(log) as f:
            out.append(f"--- process {r} ---\n{f.read()[-n:]}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--ny-per-rank", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--x-out", default=None)
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        run_process(args)
        return
    for rec in launch(args.world, args.case, args.ny_per_rank, args.device,
                      args.steps, args.x_out):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
