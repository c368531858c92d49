"""The port's example drivers (parelag_tpu_torch.models: multigrid,
upscaling, maxwell and the four host models) against the JAX package on
the CPU, with the JAX package's goldens.

Tolerances: multigrid_test_form gives the golden iterations exactly and
convergence factors within 0.02 of tests/test_solvers.py's; the
UpscalingGeneralForm and Upscaling2FormAMGe errors equal the goldens of
tests/test_golden_upscaling.py to their 4 printed digits;
upscaling_maxwell with the AMGe solver within 1e-8 relative of the JAX
run (both f64); the four copied host models equal the JAX outputs
within 1e-10 relative (the same numpy code run again).  The copies are
checked byte for byte against their sources (upscaling.py after
UPSCALING_EDITS, maxwell.py after MAXWELL_EDITS, and the engine's
amge/sequence.py and amge/fespace3d_ho.py after SEQUENCE_EDITS and
HO_EDITS, the distributed plane's parallel/ghost.py and
models/weak_scaling.py after GHOST_EDITS and WEAK_SCALING_EDITS)."""

import os
import re

import numpy as np
import pytest
import torch

from parelag_tpu_torch.models import multigrid as tmg
from parelag_tpu_torch.models import upscaling as tup

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fmt(x):
    return f"{x:.4e}"


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        np.abs(b).max(initial=0.0), 1e-300), (a, b)


@pytest.mark.parametrize("form,gold_iters,gold_conv", [
    (0, 4, 0.0356),
    (1, 7, 0.1495),
    (2, 9, 0.2400),
])
def test_multigrid_test_form_goldens(form, gold_iters, gold_conv):
    """tests/test_solvers.py:56-71's goldens, the hierarchy and the PCG
    on torch tensors."""
    r = tmg.multigrid_test_form(form, nref=2, device="cpu")
    assert r.iterations == gold_iters
    assert abs(r.conv_factor - gold_conv) < 0.02
    assert r.final_residual < 3e-5


def test_multigrid_cycle_loop_matches_jax():
    """use_pcg=False (the plain V-cycle loop) against the JAX driver."""
    from parelag_tpu.models.multigrid import multigrid_test_form as jmg
    rj = jmg(0, nref=1, use_pcg=False)
    rt = tmg.multigrid_test_form(0, nref=1, use_pcg=False, device="cpu")
    assert rt.iterations == rj.iterations and rt.ndofs == rj.ndofs
    _close(rt.final_residual, rj.final_residual, 1e-8)


@pytest.mark.parametrize("form,l2,energy", [
    (0, "1.8389e-02", "2.1485e-01"),
    (1, "3.1436e-02", "3.2016e-01"),
    (2, "9.1847e-03", "1.2515e-01"),
])
def test_upscaling_general_form_goldens(form, l2, energy):
    r = tup.upscaling_general_form(form, nref_parallel=1)
    assert _fmt(r.u_l2_errors[0]) == l2
    assert _fmt(r.u_energy_errors[0]) == energy


def test_upscaling_2form_amge_goldens():
    r = tup.upscaling_2form_amge()
    assert [_fmt(x) for x in r.u_l2_errors] == ["1.9010e-02", "3.9570e-03"]
    assert [_fmt(x) for x in r.u_energy_errors] == [
        "1.2883e-01", "5.7793e-02"]


def test_high_order_is_refused():
    """(Named when feorder > 0 was refused; the high-order spaces are
    ported now.)  feorder=1 builds the port's high-order hex sequence
    with the JAX package's dims on every level."""
    from parelag_tpu.models.upscaling import build_hierarchy as jbuild
    _, _, st = tup.build_hierarchy(nref_parallel=0, feorder=1)
    _, _, sj = jbuild(nref_parallel=0, feorder=1)
    assert type(st[0]).__name__ == "DeRhamSequence3DFE_HO"
    assert [[s.dof[j].ndofs for j in range(4)] for s in st] == \
        [[s.dof[j].ndofs for j in range(4)] for s in sj]


def test_device_backend_chain_matches_the_host_one():
    """build_hierarchy(backend='device') (pass 2 through torch, here on
    the CPU) keeps every level's dims of the host chain and P within
    5e-5 (the contract of tests/test_torch_generic.py)."""
    _, _, sh = tup.build_hierarchy(nref_parallel=2)
    _, _, sd = tup.build_hierarchy(nref_parallel=2, backend="device",
                                   device="cpu")
    assert len(sd) == len(sh) == 3
    for a, b in zip(sh, sd):
        assert [a.dof[j].ndofs for j in range(4)] == \
            [b.dof[j].ndofs for j in range(4)]
    for a, b in zip(sh[:-1], sd[:-1]):
        for j in range(4):
            _close(b.P[j].toarray(), a.P[j].toarray(), 5e-5)


def test_upscaling_maxwell_amge_matches_jax():
    """UpscalingMaxwell with the Hiptmair AMGe PCG on the fine level."""
    from parelag_tpu.models.maxwell import upscaling_maxwell as jmx
    from parelag_tpu_torch.models.maxwell import upscaling_maxwell as tmx
    rj = jmx(nref_parallel=1, use_amge_solver=True)
    rt = tmx(nref_parallel=1, use_amge_solver=True, device="cpu")
    assert rt.ndofs == rj.ndofs
    for k in ("u_l2_errors", "u_energy_errors", "u_norms"):
        _close(getattr(rt, k), getattr(rj, k), 1e-8)


def _models(side):
    pkg = "parelag_tpu" if side == "jax" else "parelag_tpu_torch"
    import importlib
    return {m: importlib.import_module(f"{pkg}.models.{m}")
            for m in ("electric_potential", "elasticity", "embedded",
                      "logical_demo")}


def _outputs(side, which):
    """Each copied model at its JAX test's size, as plain arrays."""
    m = _models(side)[which]
    if which == "electric_potential":
        r = m.electric_potential(nref=1, n=4, n_levels=2)
        return [r.ndofs_u, r.u_analytic_errors, r.p_analytic_errors,
                r.u_upscaling_errors, [r.u_norm]]
    if which == "elasticity":
        r = m.elasticity_upscaling(nref_parallel=1)
        return [r.ndofs, r.u_l2_errors, r.u_energy_errors, r.u_norms]
    if which == "embedded":
        topo, coarse, seq, ae_attr = m.embedded_demo(n=4, nref=1,
                                                     n_parts=16)
        return [[coarse.num_entities(0)],
                [len(a) for a in ae_attr],
                np.concatenate([np.asarray(a) for a in ae_attr]),
                [seq.dof[j].ndofs for j in range(4)]]
    r = m.logical_partitioner_demo()
    return [r.ndofs, r.u_l2_errors, r.u_energy_errors, r.u_norms]


@pytest.mark.parametrize("which", ["electric_potential", "elasticity",
                                   "embedded", "logical_demo"])
def test_copied_model_matches_jax(which):
    for a, b in zip(_outputs("port", which), _outputs("jax", which)):
        _close(a, b, 1e-10)


def _rewritten(text):
    return re.sub(r"(?m)^(\s*)from parelag_tpu\.", r"\1from parelag_tpu_torch.",
                  text)


# the documented edits of the port's models/upscaling.py: build_hierarchy
# takes backend= and device= for pass 2
UPSCALING_EDITS = [
    ("(ReduceAndOutputUpscalingErrors, src/utilities/UpscalingPieces.cpp:"
     "182-253).\n\"\"\"",
     "(ReduceAndOutputUpscalingErrors, src/utilities/UpscalingPieces.cpp:"
     "182-253).\n\n"
     "A copy of parelag_tpu/models/upscaling.py.  build_hierarchy also "
     "takes\n"
     "backend= and device= (pass 2 of every coarsen() on that backend, as\n"
     "generic_lane.build_h1 sets it).\n\"\"\""),
    ("from parelag_tpu_torch.mesh.mesh import hex_grid_mesh\n",
     "from parelag_tpu_torch import resolve_device\n"
     "from parelag_tpu_torch.mesh.mesh import hex_grid_mesh\n"),
    ("                    verbose=False, feorder=0):\n",
     "                    verbose=False, feorder=0, backend=None, "
     "device=None):\n"),
    ("    DeRhamSequence.cpp:2080-2083).\"\"\"\n",
     "    DeRhamSequence.cpp:2080-2083).\n\n"
     "    backend ('host' | 'device' | None: the sequence's default) is set\n"
     "    with device (None: the card) on each level before its coarsen()."
     "\"\"\"\n"),
    ("    for il in range(n_levels - 1):\n"
     "        with TimeManager.add_timer(\n"
     "                f\"DeRhamSequence Construction: level {il + 1}\"):\n",
     "    for il in range(n_levels - 1):\n"
     "        if backend is not None:\n"
     "            seqs[il].solve_backend = backend\n"
     "            seqs[il].solve_device = resolve_device(device)\n"
     "        with TimeManager.add_timer(\n"
     "                f\"DeRhamSequence Construction: level {il + 1}\"):\n"),
]

# the documented edits of the port's models/maxwell.py: upscaling_maxwell
# takes device= for the AMGe solve
MAXWELL_EDITS = [
    ("Hiptmair-smoothed AMGe V-cycle solves.\n\"\"\"",
     "Hiptmair-smoothed AMGe V-cycle solves.\n\n"
     "A copy of parelag_tpu/models/maxwell.py; upscaling_maxwell takes\n"
     "device= (None: the card, RuntimeError without one): with\n"
     "use_amge_solver the fine level's Hiptmair AMGe hierarchy and its "
     "PCG\n"
     "run there.\n\"\"\""),
    ("import numpy as np\n\n",
     "import numpy as np\n\nfrom parelag_tpu_torch import resolve_device\n"),
    ("                      use_amge_solver=False) -> UpscalingResult:\n",
     "                      use_amge_solver=False,\n"
     "                      device=None) -> UpscalingResult:\n"
     "    device = resolve_device(device)\n"),
    ("            H, _, _ = build_amge_hierarchy(seqs, 1, A2, "
     "smoother=smoother)\n"
     "            x, info = amge_pcg_solve(H, H.levels[0].A, b, rtol=1e-8)\n",
     "            H, _, _ = build_amge_hierarchy(seqs, 1, A2, "
     "smoother=smoother,\n"
     "                                           device=device)\n"
     "            x, info = amge_pcg_solve(H, H.levels[0].A, b, rtol=1e-8,\n"
     "                                     device=device)\n"),
]


# the documented edits of the port's amge/sequence.py: pass 2's torch
# device beside solve_backend, and Cst as two batched GEMMs (the
# three-operand einsum shares its batch index across all operands and
# falls back to numpy's c_einsum: 42.1 s of a 53.8 s coarsen() at 6^3)
SEQUENCE_EDITS = [
    ("        self.solve_backend = \"auto\"\n",
     "        self.solve_backend = \"auto\"\n"
     "        # the torch device of the 'device' backend (None: the card)\n"
     "        self.solve_device = None\n"),
    ("                Cst = np.einsum(\"bki,bkl,blj->bij\", D2i, W2st, D2i,\n"
     "                                optimize=True)\n",
     "                # two batched GEMMs: the einsum's batch index is shared\n"
     "                # by all three operands, which keeps it off BLAS\n"
     "                Cst = np.matmul(np.matmul(D2i.transpose(0, 2, 1), "
     "W2st),\n"
     "                                D2i)\n"),
    ("                          skip=[not g[\"do_solve\"] for g in groups])\n",
     "                          skip=[not g[\"do_solve\"] for g in groups],\n"
     "                          device=self.solve_device)\n"),
]

# the documented edit of the port's amge/fespace3d_ho.py: _metric_mass
# as one batched GEMM (nine broadcast temporaries took 9.3 s of the 6^3
# fine space)
HO_EDITS = [
    ("  geometry in M.\n\"\"\"\n",
     "  geometry in M.\n\n"
     "A copy of parelag_tpu/amge/fespace3d_ho.py with one edit: "
     "_metric_mass\n"
     "contracts in one batched GEMM instead of nine broadcast products.\n"
     "\"\"\"\n"),
    ("        as 9 batched GEMMs over the (a,b) pairs.\"\"\"\n"
     "        ne = G.shape[0]\n"
     "        ndof = E.shape[0]\n"
     "        M = np.zeros((ne, ndof, ndof))\n"
     "        for a in range(3):\n"
     "            for b in range(3):\n"
     "                Wab = w * G[:, :, a, b]                   # (ne, nq)\n"
     "                # (ne, ndof, nq) @ (nq, ndof)\n"
     "                M += (E[None, :, :, a] * Wab[:, None, :]) @ "
     "E[:, :, b].T\n",
     "        as one batched GEMM over the flattened (q, b) axis:\n"
     "        T[n,i,(q,b)] = sum_a E[i,q,a] w[n,q] G[n,q,a,b], then T @ "
     "E^T,\n"
     "        in chunks of cells that bound T to ~2^24 entries.\"\"\"\n"
     "        ne = G.shape[0]\n"
     "        ndof, nq = E.shape[0], E.shape[1]\n"
     "        WG = w[:, :, None, None] * G                      # (ne, nq, 3, "
     "3)\n"
     "        Ef = E.reshape(ndof, nq * 3)\n"
     "        M = np.empty((ne, ndof, ndof))\n"
     "        step = max(1, (1 << 24) // max(ndof * nq * 3, 1))\n"
     "        for s in range(0, ne, step):\n"
     "            W = WG[s:s + step]\n"
     "            T = sum(E[None, :, :, a, None] * W[:, None, :, a, :]\n"
     "                    for a in range(3))                    # (n, ndof, "
     "nq, 3)\n"
     "            M[s:s + step] = T.reshape(-1, ndof, nq * 3) @ Ef.T\n"),
]


# the documented edits of the port's parallel/ghost.py: GhostMap's device
# verbs on the rank axis of one tensor (a padded ghost reads a scratch
# zero: torch refuses the out-of-range index JAX clamps)
GHOST_EDITS = [
    ("* device execution — ONE shard_map collective each over the `dd` mesh\n"
     "  axis: distribute = all_gather + ghost-slot gather; assemble =\n"
     "  scatter-add into the virtual layout + psum (exactly\n"
     "  SharingMap.Assemble's additive reduction as a collective).\n",
     "* device execution — ONE index op each over the rank axis of a\n"
     "  parallel.sharding.RankMesh (the ranks as the leading axis of one\n"
     "  tensor): distribute = ghost-slot gather from the flattened blocks;\n"
     "  assemble = scatter-add into the virtual layout, summed over ranks\n"
     "  (SharingMap.Assemble's additive reduction).  Across processes each\n"
     "  holds its ranks' blocks: distribute = all_gather + ghost-slot gather;\n"
     "  assemble = scatter-add + all_reduce, this process's blocks kept.\n"),
    ("    def device_fns(self, mesh):\n"
     "        \"\"\"(gvirt, distribute_fn, assemble_fn) as jitted shard_map\n"
     "        collectives. Block layout: (ndev, n_loc) owned values; ghosts\n"
     "        padded to the max ghost count (validity mask from\n"
     "        `ghost_mask()`); padded contribution slots route to a scratch\n"
     "        slot and are discarded.\"\"\"\n"
     "        import jax\n"
     "        import jax.numpy as jnp\n"
     "        from jax.sharding import PartitionSpec as P\n"
     "        from parelag_tpu_torch.parallel.sharding import shard_map\n",
     "    def device_fns(self, mesh):\n"
     "        \"\"\"(gvirt, distribute_fn, assemble_fn) on mesh.device (a\n"
     "        parallel.sharding.RankMesh). Block layout: (ndev, n_loc) owned\n"
     "        values (the mesh.own rows of them in a process group); ghosts\n"
     "        padded to the max ghost count (validity mask from\n"
     "        `ghost_mask()`); padded slots point at a scratch slot: a padded\n"
     "        ghost reads 0, a padded contribution is discarded.\"\"\"\n"
     "        import torch\n"),
    ("        gvirt = jnp.asarray(gv)\n"
     "\n"
     "        @jax.jit\n"
     "        @lambda f: shard_map(f, mesh=mesh,\n"
     "                             in_specs=(P(\"dd\"), P(\"dd\")),\n"
     "                             out_specs=P(\"dd\"))\n"
     "        def distribute_fn(x_blk, gv_blk):\n"
     "            xg = jax.lax.all_gather(x_blk, \"dd\").reshape(-1)\n"
     "            return xg[gv_blk[0]][None, :]\n"
     "\n"
     "        @jax.jit\n"
     "        @lambda f: shard_map(f, mesh=mesh,\n"
     "                             in_specs=(P(\"dd\"), P(\"dd\"), P(\"dd\")),\n"
     "                             out_specs=P(\"dd\"))\n"
     "        def assemble_fn(x_blk, contrib_blk, gv_blk):\n"
     "            buf = jnp.zeros(ndev * n_loc + 1, x_blk.dtype).at[\n"
     "                gv_blk[0]].add(contrib_blk[0])[:ndev * n_loc]\n"
     "            tot = jax.lax.psum(buf.reshape(ndev, n_loc), \"dd\")\n"
     "            me = jax.lax.axis_index(\"dd\")\n"
     "            own = jax.lax.dynamic_slice_in_dim(\n"
     "                tot.reshape(-1), me * n_loc, n_loc)\n"
     "            return x_blk + own[None, :]\n",
     "        gvirt = torch.as_tensor(gv[mesh.own]).to(mesh.device)\n"
     "\n"
     "        def distribute_fn(x_blk, gv_blk):\n"
     "            xg = torch.cat([mesh.all_gather(x_blk).reshape(-1),\n"
     "                            x_blk.new_zeros(1)])\n"
     "            return xg[gv_blk]\n"
     "\n"
     "        def assemble_fn(x_blk, contrib_blk, gv_blk):\n"
     "            buf = x_blk.new_zeros(ndev * n_loc + 1).index_add_(\n"
     "                0, gv_blk.reshape(-1), contrib_blk.reshape(-1))\n"
     "            tot = mesh.all_reduce(buf[:ndev * n_loc])\n"
     "            return x_blk + tot.reshape(ndev, n_loc)[mesh.own]\n"),
]

# the documented edits of the port's models/weak_scaling.py: the rank
# mesh's device
WEAK_SCALING_EDITS = [
    ("                             iters=30, dtype=None):\n",
     "                             iters=30, dtype=None, device=None):\n"),
    ("    counts while dofs grow with ranks.\"\"\"\n",
     "    counts while dofs grow with ranks.  The ranks run as the batch axis\n"
     "    of a parallel.sharding.RankMesh on `device` (None: the card).\"\"\"\n"),
    ("        jmesh = make_dd_mesh(R)\n",
     "        jmesh = make_dd_mesh(R, device=device)\n"),
]


@pytest.mark.parametrize("path,edits", [
    ("models/upscaling.py", UPSCALING_EDITS),
    ("models/maxwell.py", MAXWELL_EDITS),
    ("amge/sequence.py", SEQUENCE_EDITS),
    ("amge/fespace3d_ho.py", HO_EDITS),
    ("parallel/ghost.py", GHOST_EDITS),
    ("models/weak_scaling.py", WEAK_SCALING_EDITS)],
    ids=["upscaling", "maxwell", "sequence", "fespace3d_ho", "ghost",
         "weak_scaling"])
def test_copied_driver_equals_its_source(path, edits):
    with open(os.path.join(ROOT, "parelag_tpu", path)) as f:
        src = _rewritten(f.read())
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    with open(os.path.join(ROOT, "parelag_tpu_torch", path)) as f:
        assert f.read() == src
