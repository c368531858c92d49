"""The PyTorch port stands alone: importing any of its modules (and the
chip smoke script) loads neither jax nor parelag_tpu, and CPU tensors
never reach the CUDA kernel loader."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parelag_tpu_torch.ops import build
from parelag_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import parelag_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    parelag_tpu_torch.__path__, "parelag_tpu_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "parelag_tpu"))
print(len(mods), bad)
assert not bad, bad
assert {"parelag_tpu_torch.parallel.mp_worker",
        "parelag_tpu_torch.utils.checkpoint"} <= set(mods), mods
assert parelag_tpu_torch.load_pytree and parelag_tpu_torch.save_pytree
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "parelag_tpu"))
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_parelag_tpu():
    """Every module of the port, imported in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[0])
    assert n_mods >= 10, r.stdout


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    """The whole CPU slice runs on the plain versions: no build, no
    library, every launch counter stays 0."""
    from parelag_tpu_torch import flagship as fl

    def refuse():
        raise AssertionError("the kernel library was loaded for CPU "
                             "tensors")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(hk, "_LIB", None)
    before = dict(hk.LAUNCHES)
    A_levels, P_levels, b = fl.build_h1_structured(8, min_coarse=8,
                                                   device="cpu")
    H, Hb = fl.build_solver(A_levels, P_levels, "cpu")
    x, (it, _) = fl.solve(H, Hb, torch.as_tensor(b.astype(np.float32)))
    assert it > 0 and torch.isfinite(x).all()
    D = H.levels[0].A
    v = torch.ones(D.shape[0])
    hk.dia_spmv(D.data, D.offs, v, D.shape[0])
    hk.dia_jacobi_sweep(D.data, D.offs, v, v, v)
    hk.bcsr_spmv(torch.tensor([0, 1], dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), torch.ones(1),
                 torch.ones(128), 1)
    assert hk.LAUNCHES == before
    assert hk._LIB is None


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA (or a mix) is
    refused, never run on a plain path."""
    data = torch.ones((1, 4), device="meta")
    x = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        hk.dia_spmv(data, (0,), x, 4)
    with pytest.raises(ValueError, match="devices"):
        hk.dia_spmv(torch.ones((1, 4)), (0,), x, 4)


def test_device_helper_never_falls_back_to_the_cpu():
    from parelag_tpu_torch import device
    if torch.cuda.is_available():
        assert device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device()


def _entry_points():
    """Every public entry point with a device argument, called without
    one, on tiny inputs (name -> thunk)."""
    import scipy.sparse as sp
    from parelag_tpu_torch import (
        convert, darcy_lane, entry, flagship, generic_lane, ho_lane,
        library_lane, maxwell_lane, spectral_lane)
    from parelag_tpu_torch.amge import (
        spectral, structured, structured_spectral, structured_spectral_ml)
    from parelag_tpu_torch.amge.hybridization import HybridHdivL2
    from parelag_tpu_torch.models import (
        maxwell, multigrid, upscaling, weak_scaling)
    from parelag_tpu_torch.parallel import dist_bench, mp_worker, sharding
    from parelag_tpu_torch.utils import checkpoint
    from parelag_tpu_torch.ops import batched, device_sparse as ds
    from parelag_tpu_torch.solvers import (
        amge_solver, autotune, block, cg, hierarchy, library, sa_amg,
        saddle_extra, smoothers)
    I = sp.identity(8, format="csr")
    D = sp.csr_matrix(np.ones((8, 2)))
    A1, B1 = np.eye(2)[None], np.ones((1, 2, 1))
    return {
        "amge_solver.build_amge_hierarchy":
            lambda: amge_solver.build_amge_hierarchy([], 0, I),
        "amge_solver.build_ml_hiptmair":
            lambda: amge_solver.build_ml_hiptmair([], 1, I),
        "amge_solver.amge_pcg_solve":
            lambda: amge_solver.amge_pcg_solve(None, None, np.ones(8)),
        "batched.solve_groups": lambda: batched.solve_groups(
            [A1], [B1], backend="device"),
        "batched.batched_solve": lambda: batched.batched_solve(
            [A1[0]], [B1[0]], backend="device"),
        "batched.batched_svd_basis": lambda: batched.batched_svd_basis(
            [np.ones((2, 1))], backend="device"),
        "entry.entry": lambda: entry.entry(),
        "generic_lane.build_h1": lambda: generic_lane.build_h1(2, "device"),
        "generic_lane.lane_generic": lambda: generic_lane.lane_generic(2),
        "flagship.structured_chain":
            lambda: flagship.structured_chain(4, min_coarse=8),
        "flagship.build_h1_structured":
            lambda: flagship.build_h1_structured(4, min_coarse=8),
        "flagship.build_solver": lambda: flagship.build_solver([I], []),
        "flagship.lane_h1": lambda: flagship.lane_h1(4),
        "maxwell_lane.build_maxwell": lambda: maxwell_lane.build_maxwell(2),
        "maxwell_lane.build_solver":
            lambda: maxwell_lane.build_solver([I], [], []),
        "maxwell_lane.lane_maxwell": lambda: maxwell_lane.lane_maxwell(2),
        "structured.fine_level": lambda: structured.fine_level((2, 2, 2)),
        "hierarchy.build_hierarchy": lambda: hierarchy.build_hierarchy(
            [I], [], autotune._factory(flagship.CYCLE, "cpu")),
        "smoothers.make_l1_jacobi": lambda: smoothers.make_l1_jacobi(I),
        "smoothers.make_hiptmair": lambda: smoothers.make_hiptmair(I, D),
        "autotune._factory":
            lambda: autotune._factory(flagship.CYCLE)(I, 0),
        "convert.hierarchy_from_numpy":
            lambda: convert.hierarchy_from_numpy(object()),
        "convert.structured_level_from_numpy":
            lambda: convert.structured_level_from_numpy(object()),
        "device_sparse.from_scipy": lambda: ds.from_scipy(I),
        "device_sparse.to_bcsr": lambda: ds.to_bcsr(I),
        "device_sparse.to_tilecoo": lambda: ds.to_tilecoo(I),
        "device_sparse.to_dia": lambda: ds.to_dia(I),
        "device_sparse.to_coo": lambda: ds.to_coo(I),
        "device_sparse.to_dia_ell": lambda: ds.to_dia_ell(I),
        "convert.matrix_from_numpy":
            lambda: convert.matrix_from_numpy(object()),
        "sa_amg.build_device_sa_hierarchy":
            lambda: sa_amg.build_device_sa_hierarchy(I),
        "cg.pcg_host": lambda: cg.pcg_host(I, np.ones(8)),
        "block.build_darcy_amge_hierarchy":
            lambda: block.build_darcy_amge_hierarchy([], 0),
        "spectral.compute_local_spectral_targets(device)":
            lambda: spectral.compute_local_spectral_targets(
                [np.eye(2)], 0.1, 1, backend="device"),
        "HybridHdivL2._device_setup":
            lambda: HybridHdivL2._device_setup(None, I),
        "darcy_lane.lane_darcy_hybridized":
            lambda: darcy_lane.lane_darcy_hybridized(2),
        "darcy_lane.lane_spe10": lambda: darcy_lane.lane_spe10((2, 2, 2)),
        "darcy_lane.lane_darcy_block":
            lambda: darcy_lane.lane_darcy_block(1),
        "smoothers.make_chebyshev": lambda: smoothers.make_chebyshev(I),
        "autotune.tune_cycle":
            lambda: autotune.tune_cycle([I], [], np.ones(8)),
        "flagship.lane_autotune": lambda: flagship.lane_autotune(4),
        "structured_spectral.spectral_coarsen_darcy":
            lambda: structured_spectral.spectral_coarsen_darcy(
                (2, 2, 2), (2, 2, 2), np.ones(8)),
        "structured_spectral_ml.fine_block_level":
            lambda: structured_spectral_ml.fine_block_level(
                (2, 2, 2), np.ones(8)),
        "structured_spectral_ml.spectral_coarsen_darcy_chain":
            lambda: structured_spectral_ml.spectral_coarsen_darcy_chain(
                (2, 2, 2), [(2, 2, 2)], np.ones(8)),
        "spectral_lane.lane_spe10_structured":
            lambda: spectral_lane.lane_spe10_structured((2, 2, 2)),
        "spectral_lane.lane_spe10_ml":
            lambda: spectral_lane.lane_spe10_ml((2, 2, 2)),
        "library.SolverState": lambda: library.SolverState([], [0]),
        "library_lane.build_chain": lambda: library_lane.build_chain(1),
        "library_lane.lane_library": lambda: library_lane.lane_library(1),
        "multigrid.multigrid_test_form":
            lambda: multigrid.multigrid_test_form(0, nref=1),
        "maxwell.upscaling_maxwell":
            lambda: maxwell.upscaling_maxwell(nref_parallel=1),
        "saddle_extra.MLDivFree": lambda: saddle_extra.MLDivFree([]),
        "ho_lane.build_ho": lambda: ho_lane.build_ho(2, 1),
        "ho_lane.build_solver": lambda: ho_lane.build_solver([], I),
        "ho_lane.lane_ho": lambda: ho_lane.lane_ho(2, 1),
        "upscaling.build_hierarchy(backend='device')":
            lambda: upscaling.build_hierarchy(nref_parallel=1,
                                              backend="device"),
        "sharding.make_dd_mesh": lambda: sharding.make_dd_mesh(2),
        "sharding.make_dd_mesh(group=)":
            lambda: sharding.make_dd_mesh(2, group=object()),
        "mp_worker.launch": lambda: mp_worker.launch(2, "solve"),
        "checkpoint.load_pytree":
            lambda: checkpoint.load_pytree("missing.pt"),
        "dist_bench.distributed_solve_bench":
            lambda: dist_bench.distributed_solve_bench(2),
        "entry.dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "weak_scaling.distributed_weak_scaling":
            lambda: weak_scaling.distributed_weak_scaling((1,),
                                                          base=(2, 2, 2)),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_the_card(name):
    """device=None means the card: without one, a call that names no
    device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
