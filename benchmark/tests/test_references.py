"""Each plain reference against the program on tiny grids on the CPU,
and the control (the reference in the precision below the
configuration's, in the program's place) failing the configuration's
limit."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import darcy_hyb as RD
from benchmark.reference import h1_struct as RH

CPU = torch.device("cpu")
CONFIGS = {k: json.loads((harness.ROOT / f"benchmark/configs/{k}.json")
                         .read_text())
           for k in ("h1_struct_128", "darcy_hyb_64")}


def _darcy(n):
    from parelag_tpu_torch.amge import hexfe
    from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
    from parelag_tpu_torch.amge.hybridization import HybridHdivL2
    from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
    from parelag_tpu_torch.topology.topology import AgglomeratedTopology
    mesh = hex_grid_mesh(n, n, n)
    seq = DeRhamSequenceFE(AgglomeratedTopology.from_mesh(mesh), mesh)
    seq.jform_start = 2
    return (seq, HybridHdivL2(seq),
            hexfe.hex_volumes(mesh.vertices[mesh.elements]))


@pytest.mark.parametrize("n", [4, 6])
def test_h1_operator_equals_program(n):
    from parelag_tpu_torch import flagship
    A, _, _ = flagship.build_h1_structured(n, min_coarse=8,
                                           dtype=np.float64, device="cpu")
    x = np.random.RandomState(n).randn(A[0].shape[0], 3)
    y = RH.Operator(n, CPU).apply(torch.as_tensor(x)).numpy()
    assert np.abs(A[0] @ x - y).max() <= 1e-14 * np.abs(y).max()


@pytest.mark.parametrize("n", [3, 4])
def test_darcy_operators_equal_program(n):
    seq, hyb, _ = _darcy(n)
    M = seq.compute_mass_operator(2)
    pr = RD.Problem(n, CPU)
    rng = np.random.RandomState(n)
    u, p = rng.randn(M.shape[0]), rng.randn(hyb.B.shape[0])
    U = pr.from_program(torch.as_tensor(u))
    order, sign = pr.order.numpy(), pr.sign.numpy()

    def to_program(parts):
        out = np.empty_like(u)
        out[order] = torch.cat([t.reshape(-1) for t in parts]).numpy() * sign
        return out

    assert np.abs(M @ u - to_program(pr.mass(U))).max() < 1e-12
    assert np.abs(hyb.B @ u - pr.div(U).reshape(-1).numpy()).max() < 1e-12
    BtP = pr.div_t(torch.as_tensor(p).reshape(n, n, n))
    assert np.abs(hyb.B.T @ p - to_program(BtP)).max() < 1e-12


def test_darcy_program_direct_solve_passes():
    n = 4
    _, hyb, vols = _darcy(n)
    f = np.random.RandomState(1).randn(n ** 3) * vols
    u, p = hyb.solve(np.zeros(hyb.nu), f, solver="direct")
    assert max(RD.residuals(n, f, u, p, CPU)) < 1e-12


@pytest.mark.parametrize("name,n,dtype,sound", [
    ("h1_struct_128", 8, torch.float64, True),
    ("h1_struct_128", 8, torch.bfloat16, False),
    ("darcy_hyb_64", 4, torch.float64, True),
    ("darcy_hyb_64", 4, torch.float32, False),
])
def test_control_fails_the_limit(name, n, dtype, sound):
    """The reference's own solve, in the configuration's precision (f64
    here) it passes; in control_dtype, the precision below, it fails."""
    cfg = dict(CONFIGS[name], cells_per_axis=n)
    assert (dtype == getattr(torch, cfg["control_dtype"])) == (not sound)
    ref = RH if name.startswith("h1") else RD
    g = torch.Generator().manual_seed(3)
    if ref is RH:
        b = torch.randn((n + 1) ** 3, 2, generator=g, dtype=torch.float64)
        b = RH.Operator(n, CPU).apply(b)
        sample = {"b": b, "x": ref.solve(dict(cfg, rtol=1e-12), b, CPU,
                                          dtype)}
    else:
        f = torch.randn(n ** 3, generator=g, dtype=torch.float64)
        u, p = ref.solve(dict(cfg, rtol=1e-12), f, CPU, dtype)
        sample = {"f": f, "u": u, "p": p}
    res = ref.judge(cfg, [sample], CPU)["res_max"]
    limit = cfg["limits"]["res_max"]
    assert (res <= limit) == sound, (res, limit)
