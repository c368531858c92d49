"""Parity of the port's structured AMGe setup with the JAX module, on the
CPU in f64: per level, every stage output, the coarse level's arrays,
the H1 prolongator P and the H1 operator A agree within 1e-10 relative
(both sides solve the same small dense systems with LAPACK, so only
rounding separates them); the chunk loop equals the whole-level run."""

import jax
import numpy as np
import pytest
import torch

from parelag_tpu.amge import structured as jst
from parelag_tpu_torch import convert
from parelag_tpu_torch.amge import structured as tst

torch.set_num_threads(1)

OUT_FIELDS = ("ptr3", "f3", "ptr2", "f2", "pint2", "d2c", "ptr1", "f1",
              "pf1", "pc1", "d1c", "pe0", "pf0", "pc0", "d0c")
LEVEL_FIELDS = ("m00", "m01", "m02", "m03", "m10", "m11", "m12", "m20",
                "m21", "d0", "d1", "d2", "t0", "t1", "t2", "t3")
TOL = 1e-10


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sprel(A, B):
    D = (A - B).tocsr()
    return (np.abs(D.data).max() if D.nnz else 0.0) / np.abs(B.data).max()


@pytest.fixture(scope="module", params=[8, 16], ids=["8^3", "16^3"])
def chains(request):
    shape = (request.param,) * 3
    jl, jo = jst.coarsen_chain(jst.fine_level(shape), 3, jform_start=0)
    tl, to = tst.coarsen_chain(tst.fine_level(shape, device="cpu"), 3)
    return (jl, jo), (tl, to)


def test_stage_outputs_match_jax(chains):
    (jl, jo), (tl, to) = chains
    for l, (a, b) in enumerate(zip(jo, to)):
        for f in OUT_FIELDS:
            assert _rel(getattr(b, f).numpy(), getattr(a, f)) < TOL, (l, f)
        for f in ("cc", "cf", "uedges", "uverts", "fuedges", "euverts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for l, (a, b) in enumerate(zip(jl, tl)):
        for f in LEVEL_FIELDS:
            assert _rel(getattr(b, f).numpy(), getattr(a, f)) < TOL, (l, f)


def test_P_and_A_per_level_match_jax(chains):
    (jl, jo), (tl, to) = chains
    for l, (a, b) in enumerate(zip(jo, to)):
        Pj = jst.materialize_P(a, jl[l].shape, 0)
        Pt = tst.materialize_P(b, tl[l].shape, 0)
        assert Pt.shape == Pj.shape and Pt.nnz == Pj.nnz
        assert _sprel(Pt, Pj) < TOL, l
    for l, (a, b) in enumerate(zip(jl, tl)):
        assert _sprel(tst.h1_stiffness(b), jst.h1_stiffness(a)) < TOL, l
    shape = jl[0].shape
    np.testing.assert_allclose(tst.h1_uniform_cell_block(shape),
                               jst.h1_uniform_cell_block(shape),
                               rtol=0, atol=1e-14)


def test_chunk_loop_equals_whole_level():
    """chunk=7 misaligns with every entity count (ragged last chunk);
    the stage math is per entity, so the results are bit-identical."""
    lvl0 = tst.fine_level((8, 8, 8), device="cpu")
    cw, ow = tst.coarsen_structured(lvl0, chunk=0)
    cc, oc = tst.coarsen_structured(lvl0, chunk=7)
    for f in OUT_FIELDS:
        assert torch.equal(getattr(ow, f), getattr(oc, f)), f
    for f in LEVEL_FIELDS:
        assert torch.equal(getattr(cw, f), getattr(cc, f)), f
    assert oc.bub_sv < 1e-9 and oc.max_rel_sv < 1e-9


def test_f32_chain_matches_jax():
    """The flagship's f32 setup: within f32 rounding (1e-5 relative:
    separate LU factorizations of 21x21 saddle blocks in f32)."""
    shape = (8, 8, 8)
    jl, jo = jst.coarsen_chain(jst.fine_level(shape, dtype=np.float32), 2)
    tl, to = tst.coarsen_chain(tst.fine_level(shape, dtype=np.float32,
                                                 device="cpu"), 2)
    assert to[0].pc0.dtype == torch.float32
    for f in OUT_FIELDS:
        assert _rel(getattr(to[0], f).numpy(), getattr(jo[0], f)) < 1e-5, f


def test_level_from_numpy_and_heterogeneity_guard():
    """convert.structured_level_from_numpy carries a JAX level across:
    the homogeneous fine level coarsens to the port's own result, and
    sub-agglomerate heterogeneity trips the static-structure guard."""
    shape = (4, 4, 4)
    lj = jax.tree_util.tree_map(np.asarray, vars(jst.fine_level(shape)))
    lvl = convert.structured_level_from_numpy(
        jst.StructuredLevel(**lj), device="cpu")
    _, oa = tst.coarsen_structured(lvl)
    _, ob = tst.coarsen_structured(tst.fine_level(shape, device="cpu"))
    for f in OUT_FIELDS:
        assert _rel(getattr(oa, f).numpy(), getattr(ob, f).numpy()) < TOL
    rng = np.random.default_rng(9)
    coeff = 10.0 ** rng.uniform(-2, 2, size=np.prod(shape))
    het = jax.tree_util.tree_map(
        np.asarray, vars(jst.fine_level(shape, coeff=coeff)))
    with pytest.raises(RuntimeError, match="bubble SVD kept a mode"):
        tst.coarsen_structured(convert.structured_level_from_numpy(
            jst.StructuredLevel(**het), device="cpu"))


def test_full_precision_restores_flags():
    prev = torch.backends.cuda.matmul.allow_tf32
    with tst.full_precision():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigvalsh_in_f64_keeps_the_dtype(dtype):
    """The guards' Gram eigenvalues: computed in f64, returned in G's
    dtype; an exactly-zero batch (the deflated trace of a homogeneous
    level) gives zeros, a random SPD batch numpy's eigenvalues."""
    zeros = tst._eigvalsh(torch.zeros((5, 3, 3), dtype=dtype))
    assert zeros.dtype == dtype and not zeros.any()
    a = np.random.RandomState(0).randn(5, 3, 3)
    g = a @ a.transpose(0, 2, 1)
    ev = tst._eigvalsh(torch.as_tensor(g, dtype=dtype))
    assert ev.dtype == dtype
    np.testing.assert_allclose(ev.double().numpy(), np.linalg.eigvalsh(g),
                               rtol=1e-6 if dtype == torch.float32
                               else 1e-12)
