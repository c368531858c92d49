"""The roofline's byte count from an operator's nonzeros."""

import numpy as np
import pytest
import scipy.sparse as sp
from benchmark import harness, roofline
from benchmark import trace as tracing
from conftest import CPU


def test_nnz_drops_explicit_zeros():
    A = sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 3.0, 0.0],
                                [4.0, 0.0, 5.0]]))
    A.data[1] = 0.0                       # an explicit zero stays stored
    assert A.nnz == 5 and roofline.csr_nnz(A) == 4 and A.nnz == 5


def test_h1_probe_bytes(spec):
    from parelag_tpu_torch import flagship
    cell = harness.resolve(spec, "tiny_h1.rhs16")
    Fam = harness.load_module("families", "h1_struct").Family
    fam = Fam(cell.config, cell.mix, CPU, harness.Spans(CPU))
    fam.load_inputs(5)
    n = (cell.config["cells_per_axis"] + 1) ** 3
    A, _, _ = flagship.build_h1_structured(cell.config["cells_per_axis"], 8,
                                           np.float32, "cpu")
    nnz = roofline.csr_nnz(A[0])
    probes = fam.probes()
    assert probes["a0_apply"].bytes == nnz * 4 + 2 * n * 16 * 4
    assert probes["a0_smooth"].bytes == nnz * 2 + (3 * 16 + 1) * n * 2
    probes["a0_apply"].fn()
    probes["a0_smooth"].fn()


def test_share_needs_a_card():
    p = roofline.Probe(lambda: None, 10 ** 9)
    assert roofline.share(p, CPU) is None
    assert roofline.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_peak("NVIDIA A100") is None


def test_device_time_is_the_union_of_the_device_intervals():
    # two launches of one apply with a host gap between them, and an
    # overlapping copy: the gap does not count, the overlap counts once
    dev = [(0.0, 10.0, "dia_spmv_row_kernel"), (30.0, 35.0, "ell_kernel"),
           (8.0, 12.0, "Memcpy DtoD")]
    merged = tracing.union(dev)
    assert merged == [[0.0, 12.0], [30.0, 35.0]]
    assert sum(e - s for s, e in merged) == 17.0
    assert tracing.union(dev, 5.0, 31.0) == [[5.0, 12.0], [30.0, 31.0]]


def test_timed_applies_lie_between_the_marks():
    dev = [(0.0, 3.0, "dia_spmv_row_kernel"), (4.0, 5.0, "spin_kernel(long)"),
           (6.0, 9.0, "dia_spmv_row_kernel"), (9.5, 12.0, "Memcpy DtoD"),
           (13.0, 14.0, "spin_kernel(long)"), (15.0, 18.0, "dia_spmv_row_kernel")]
    inner = roofline.between_marks(dev)
    assert [d[0] for d in inner] == [6.0, 9.5]
    assert tracing.hand_launches(inner) == 1
    assert roofline.between_marks(dev[:2]) is None


def test_a_short_trace_is_taken_again():
    # the profiler dropped one of the timed stretch's launches in the
    # first trace: that trace is read for nothing, the next one counts;
    # a probe whose every trace is short reads nothing
    whole = [(10.0 * i, 10.0 * i + 4.0, "dia_spmv_row_kernel")
             for i in range(roofline.TIMED_CALLS)]
    traces = iter([(whole[1:], len(whole)), (whole, len(whole))])
    seen = []

    def trace(fn, device):
        seen.append(1)
        return next(traces)

    s = roofline.device_seconds_per_call(lambda: None, CPU, trace)
    assert len(seen) == 2 and s == pytest.approx(4e-6)
    seen.clear()
    short = lambda fn, device: seen.append(1) or (whole[1:], len(whole))
    assert roofline.device_seconds_per_call(lambda: None, CPU, short) is None
    assert len(seen) == roofline.ATTEMPTS
