"""The port's spans, timers and counters (parelag_tpu_torch/utils/
timing.py) and the solve calls that report them: HybridHdivL2.solve by
stage, solvers/cg.pcg, and CompiledPcg with its graph's device time.
This file imports neither jax nor parelag_tpu; its card test skips
without a CUDA device."""

import numpy as np
import pytest
import torch

from parelag_tpu_torch.utils.timing import TimeManager, counter, span


@pytest.fixture
def registry():
    TimeManager.clear()
    yield TimeManager
    TimeManager.clear()


def _count(name):
    return TimeManager.totals().get(name, (0.0, 0))[1]


def test_span_adds_seconds_and_counts(registry):
    for _ in range(3):
        with span("outer"):
            with span("inner"):
                sum(range(1000))
    with span("inner"):
        pass
    tot = registry.totals()
    assert tot["outer"][1] == 3 and tot["inner"][1] == 4
    assert tot["outer"][0] > 0 and tot["inner"][0] > 0
    assert registry.elapsed()["outer"] == tot["outer"][0]
    counter("bytes", 5)
    counter("bytes", 7)
    assert registry.counters() == {"bytes": 12}
    table = registry.summary()
    assert "outer" in table and "bytes" in table and "12" in table


def test_span_counts_a_block_that_raises(registry):
    with pytest.raises(ValueError):
        with span("raises"):
            raise ValueError
    assert _count("raises") == 1


def test_add_timer_counts_its_intervals(registry):
    for _ in range(2):
        with registry.add_timer("scope"):
            pass
    w = registry.get_timer("scope")
    assert w.count == 2 and w.elapsed() > 0
    w.reset()
    assert w.count == 0 and w.elapsed() == 0


def test_span_is_a_profiler_range_only_under_a_profiler(registry,
                                                        monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("stage.under_profiler"):
            torch.ones(4).sum()
    assert "stage.under_profiler" in {e.name for e in prof.events()}
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with span("stage.without"):
        pass
    assert entered == [] and _count("stage.without") == 1


@pytest.fixture(scope="module")
def darcy4():
    from parelag_tpu_torch.amge import hexfe
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
    from parelag_tpu_torch.amge.hybridization import HybridHdivL2
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology
    mesh = hex_grid_mesh(4, 4, 4)
    seq = DeRhamSequenceFE(AgglomeratedTopology.from_mesh(mesh), mesh)
    seq.jform_start = 2
    hyb = HybridHdivL2(seq)
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    f = np.random.RandomState(3).randn(vols.size) * vols
    return hyb, np.zeros(hyb.nu), f


def test_darcy_solve_reports_its_stages(registry, darcy4):
    """Two device solves on the CPU (f64, one pass each): the call's
    stages once a call, the refinement and the inner PCG at least once
    a pass, no bytes between host and card, and the answer of the
    direct solve."""
    hyb, rhs_u, f = darcy4
    for _ in range(2):
        u, p = hyb.solve(rhs_u, f, solver="device", rtol=1e-10,
                         rescale=True, device="cpu")
    passes = hyb.last_device["passes"]
    for name in ("hybrid.transform", "hybrid.reduce", "hybrid.recover"):
        assert _count(name) == 2, name
    assert _count("krylov.pcg") == 2 * passes >= 2
    assert _count("hybrid.refine") >= 2 * passes
    assert registry.counters() == {}
    u0, p0 = hyb.solve(rhs_u, f, solver="direct", rescale=True)
    assert np.abs(u - u0).max() < 1e-7 and np.abs(p - p0).max() < 1e-7


def test_darcy_f32_refinement_counts_each_pass(registry):
    """The card's f32 branch, forced on the CPU: one inner PCG a pass."""
    from parelag_tpu_torch import darcy_lane
    hyb, Hs, gf = darcy_lane.build_darcy_hyb(4)
    hyb._device_solve(Hs, gf, rtol=1e-10, device="cpu", dtype=np.float32)
    passes = hyb.last_passes
    assert passes >= 2 and _count("krylov.pcg") == passes
    assert _count("hybrid.refine") >= 2 * passes


def _poisson(n, device):
    from parelag_tpu_torch.ops.device_sparse import from_scipy
    import scipy.sparse as sp
    e = np.ones(n)
    A = sp.diags([2 * e, -e[:-1], -e[:-1]], [0, 1, -1], format="csr")
    return from_scipy(A, dtype=np.float32, device=device)


def test_compiled_pcg_on_the_cpu_has_no_graph_time(registry):
    from parelag_tpu_torch.solvers.cg import compile_pcg
    A = _poisson(64, "cpu")
    b = torch.ones(64)
    solve = compile_pcg(A.matvec, b, rtol=1e-6, atol=0.0)
    for _ in range(3):
        solve(b)
    assert _count("krylov.solve") == 3
    assert "krylov.graph" not in registry.totals()
    assert _count("krylov.pcg") == 0


@pytest.mark.cuda
def test_compiled_pcg_graph_time_on_the_card(registry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from parelag_tpu_torch.solvers.cg import compile_pcg
    dev = torch.device("cuda")
    A = _poisson(1 << 16, dev)
    b = torch.ones(1 << 16, device=dev)
    solve = compile_pcg(A.matvec, b, rtol=1e-6, atol=0.0, maxiter=200)
    TimeManager.clear()
    x, (it, _) = solve(b)
    tot = registry.totals()
    assert it > 0 and tot["krylov.solve"][1] == tot["krylov.graph"][1] == 1
    assert 0 < tot["krylov.graph"][0] <= tot["krylov.solve"][0]

