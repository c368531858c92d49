"""The port's XML solver library (parelag_tpu_torch.solvers.library,
utils/params, solvers/saddle_extra) against the JAX package's on the
CPU: the same inline compositions on the same nref-1 matrices through
both libraries.

Tolerances: x within 1e-8 relative (both f64; the Krylov loops run the
same recurrences, summation order aside), iterations equal or within one
for the Krylov loops, the same executed_on.  Copies are checked byte for
byte against their JAX sources (saddle_extra.py after SADDLE_EDITS;
params.py in tests/test_torch_generic.py's VERBATIM list)."""

import os
import re
import warnings

import numpy as np
import pytest
import torch

from parelag_tpu.solvers import library as jlib
from parelag_tpu.utils.params import read_xml as jread_xml
from parelag_tpu_torch.solvers import library as tlib
from parelag_tpu_torch.utils.params import read_xml as tread_xml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XML = """
<ParameterList name="Default">
  <ParameterList name="Problem parameters">
    <Parameter name="Finite element order" type="int" value="0"/>
    <Parameter name="Linear solver" type="string" value="PCG-AMGe"/>
    <Parameter name="Deformation" type="bool" value="false"/>
    <Parameter name="Tol" type="double" value="1e-6"/>
    <Parameter name="Forms" type="vector(int)" value="2 3"/>
  </ParameterList>
</ParameterList>"""

_AMGE_L1GS = {
    "PCG-AMGe": {"Type": "Krylov", "Solver Parameters": {
        "Solver name": "PCG", "Preconditioner": "AMGe-L1J",
        "Relative tolerance": 1e-10, "Maximum iterations": 100}},
    "AMGe-L1J": {"Type": "AMGe", "Solver Parameters": {
        "PreSmoother": "L1J", "PostSmoother": "L1J",
        "Cycle type": "V-cycle"}},
    "L1J": {"Type": "Hypre", "Solver Parameters": {
        "Type": "L1 Gauss-Seidel", "Sweeps": 2}},
}


def _krylov(name, prec=None, rtol=1e-8, maxit=300, **extra):
    p = {"Solver name": name, "Relative tolerance": rtol,
         "Maximum iterations": maxit, **extra}
    if prec is not None:
        p["Preconditioner"] = prec
    return {"Type": "Krylov", "Solver Parameters": p}


# name -> (library entries, the entry built, problem, forms)
COMPOSITIONS = {
    "PCG-AMGe-L1GS": (_AMGE_L1GS, "PCG-AMGe", "scalar0", [0]),
    "PCG-AMGe-W-Cheby-2lev": ({
        "K": _krylov("PCG", "AMGe"),
        "AMGe": {"Type": "AMGe", "Solver Parameters": {
            "PreSmoother": "Ch", "Cycle type": "W-cycle",
            "Maximum levels": 2}},
        "Ch": {"Type": "Hypre", "Solver Parameters": {
            "Type": "Chebyshev", "Cheby Poly Order": 2}},
    }, "K", "scalar0", [0]),
    "PCG-AMS": ({"K": _krylov("PCG", "AMS"),
                 "AMS": {"Type": "AMS", "Solver Parameters": {}}},
                "K", "scalar1", [1]),
    "PCG-ADS": ({"K": _krylov("PCG", "ADS"),
                 "ADS": {"Type": "ADS", "Solver Parameters": {}}},
                "K", "scalar2", [2]),
    "PCG-Hiptmair": ({"K": _krylov("PCG", "H"),
                      "H": {"Type": "Hiptmair", "Solver Parameters": {}}},
                     "K", "scalar1", [1]),
    "GMRES-AMGe-Blk": ({
        "K": _krylov("GMRES", "AMGe-Blk"),
        "AMGe-Blk": {"Type": "AMGe", "Solver Parameters": {
            "Forms": [2, 3]}},
    }, "K", "block", [2, 3]),
    "MINRES": ({"K": _krylov("MINRES", rtol=1e-10, maxit=2000)},
               "K", "scalar0", [0]),
    "BiCGSTAB-L1J": ({
        "K": _krylov("BiCGSTAB", "S", rtol=1e-10, maxit=2000),
        "S": {"Type": "Hypre", "Solver Parameters": {"Type": "L1 Jacobi"}},
    }, "K", "scalar0", [0]),
    "PCG-Direct": ({"K": _krylov("PCG", "D", rtol=1e-10),
                    "D": {"Type": "Direct", "Solver Parameters": {}}},
                   "K", "scalar0", [0]),
    "Hybridization": ({"Hyb": {"Type": "Hybridization",
                               "Solver Parameters": {}}},
                      "Hyb", "block", [2, 3]),
    "Hybridization-CG_PCG-AMG": ({
        "Hyb": {"Type": "Hybridization", "Solver Parameters": {
            "Solver": "CG_PCG-AMG", "RescaleIteration": 1}},
        "CG_PCG-AMG": _krylov("PCG", "AMG"),
        "AMG": {"Type": "BoomerAMG", "Solver Parameters": {}},
    }, "Hyb", "block", [2, 3]),
    "GMRES-BlockJacobi": ({
        "K": _krylov("GMRES", "BJ"),
        "BJ": {"Type": "Block Jacobi", "Solver Parameters": {
            "A00 Inverse": "L1J", "A11 Inverse": "AMG"}},
        "L1J": {"Type": "Hypre", "Solver Parameters": {"Type": "L1 Jacobi"}},
        "AMG": {"Type": "BoomerAMG", "Solver Parameters": {}},
    }, "K", "block", [2, 3]),
    "GMRES-BlockGS": ({
        "K": _krylov("GMRES", "BGS"),
        "BGS": {"Type": "Block Gauss-Seidel", "Solver Parameters": {
            "A00 Inverse": "L1J", "A11 Inverse": "D"}},
        "L1J": {"Type": "Hypre", "Solver Parameters": {"Type": "L1 Jacobi"}},
        "D": {"Type": "Direct", "Solver Parameters": {}},
    }, "K", "block", [2, 3]),
    "GMRES-BlockLDU": ({
        "K": _krylov("GMRES", "LDU"),
        "LDU": {"Type": "Block LDU", "Solver Parameters": {}},
    }, "K", "block", [2, 3]),
    "Bramble-Pasciak": ({"BP": {"Type": "Bramble-Pasciak",
                                "Solver Parameters": {
                                    "Relative tolerance": 1e-8}}},
                        "BP", "block", [2, 3]),
    "MLDivFree": ({"ML": {"Type": "MLDivFree", "Solver Parameters": {}}},
                  "ML", "block", [2, 3]),
    "Stationary-AMGe": ({
        "St": {"Type": "Stationary", "Solver Parameters": {
            "Preconditioner": "AMGe-L1J", "Maximum iterations": 12}},
        **{k: v for k, v in _AMGE_L1GS.items() if k != "PCG-AMGe"},
    }, "St", "scalar0", [0]),
}
KRYLOV = {k for k, v in COMPOSITIONS.items()
          if v[0][v[1]]["Type"] == "Krylov"}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-300)


def _scalar(side, form):
    if side == "jax":
        from parelag_tpu.models import upscaling as up
    else:
        from parelag_tpu_torch.models import upscaling as up
    mesh, topos, seqs = up.build_hierarchy(nref_parallel=1)
    s = seqs[0]
    A = (s.compute_mass_operator(form) + s.D[form].T
         @ s.compute_mass_operator(form + 1) @ s.D[form]).tocsr()
    nat = {1: (1.0, 1.0, 1.0)} if form == 1 else {1: -1.0}
    b = up.boundary_rhs(s, form, nat)
    marker = up.mark_dofs_on_bndr(s, form, {2, 3, 4, 5})
    A, b = up.eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
    return A, A, b, seqs


def _block(side):
    if side == "jax":
        from parelag_tpu.amge import hexfe
        from parelag_tpu.models.darcy import build_darcy_hierarchy
        lib = jlib
    else:
        from parelag_tpu_torch.amge import hexfe
        from parelag_tpu_torch.models.darcy import build_darcy_hierarchy
        lib = tlib
    mesh, topos, seqs = build_darcy_hierarchy(
        nref_parallel=1, partition="derefine", aggressive_levels=0)
    s = seqs[0]
    M = s.compute_mass_operator(2)
    B = (s.compute_mass_operator(3) @ s.D[2]).tocsr()
    op = lib.Block2x2Operator(M, B.T.tocsr(), B)
    vols = hexfe.hex_volumes(mesh.vertices[mesh.elements])
    b = np.concatenate([np.zeros(M.shape[0]), vols])
    return op, op.monolithic(), b, seqs


@pytest.fixture(scope="module")
def problems():
    cache = {}

    def get(side, kind):
        if (side, kind) not in cache:
            cache[(side, kind)] = (_block(side) if kind == "block"
                                   else _scalar(side, int(kind[-1])))
        return cache[(side, kind)]
    return get


def _run(side, name, problems):
    entries, entry, kind, forms = COMPOSITIONS[name]
    op, A, b, seqs = problems(side, kind)
    if side == "jax":
        state = jlib.SolverState(seqs, list(forms))
        lib = jlib.SolverLibrary.create_library(entries)
    else:
        state = tlib.SolverState(seqs, list(forms), device="cpu")
        lib = tlib.SolverLibrary.create_library(entries)
    solver = lib.get_solver_factory(entry).build_solver(op, state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x = np.asarray(solver.solve(b), dtype=np.float64)
    return solver, x, A, b


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_composition_matches_jax(name, problems):
    sj, xj, A, b = _run("jax", name, problems)
    st, xt, _, _ = _run("port", name, problems)
    assert np.isfinite(xt).all()
    assert _rel(xt, xj) <= 1e-8, _rel(xt, xj)
    if name in KRYLOV:
        assert abs(st.iterations - sj.iterations) <= 1, (
            st.iterations, sj.iterations)
        assert st.executed_on == sj.executed_on
    if name.startswith("Hybridization"):
        assert st.iterations == sj.iterations
    res = np.linalg.norm(b - A @ xt) / np.linalg.norm(b)
    assert res <= (1.0 if name.startswith("Stationary") else 1e-4), res


def test_krylov_compositions_run_in_the_torch_loop(problems):
    """Every Krylov composition with a device-capable preconditioner
    runs in solvers/cg.py's loop on the state's device (the CPU here);
    host-only preconditioners (the block solvers) run scipy."""
    host_only = {"GMRES-BlockJacobi", "GMRES-BlockGS", "GMRES-BlockLDU"}
    for name in sorted(KRYLOV):
        st, _, _, _ = _run("port", name, problems)
        want = "host" if name in host_only else "device"
        assert st.executed_on == want, (name, st.executed_on)
    hyb, _, _, _ = _run("port", "Hybridization-CG_PCG-AMG", problems)
    assert hyb.executed_on == "device"
    assert hyb._inner_solver._A_dev.values.device.type == "cpu"


def test_read_xml_matches_jax():
    pj, pt = jread_xml(XML), tread_xml(XML)
    assert pt.to_dict() == pj.to_dict()
    assert pt.name == pj.name == "Default"
    pp = pt.sublist("Problem parameters")
    assert pp.get("Deformation") is False and pp.get("Forms") == [2, 3]


def test_execution_device_raises_on_host_only_prec(problems):
    """test_device_library.py's case: a Block Jacobi preconditioner has
    no device_state, so Execution='device' raises instead of running on
    the host."""
    op, _, b, seqs = problems("port", "block")
    lib = tlib.SolverLibrary.create_library({
        "K": {"Type": "Krylov", "Solver Parameters": {
            "Solver name": "MINRES", "Preconditioner": "BJ",
            "Execution": "device"}},
        "BJ": {"Type": "Block Jacobi", "Solver Parameters": {
            "A00 Inverse": "D", "A11 Inverse": "D"}},
        "D": {"Type": "Direct", "Solver Parameters": {}},
    })
    solver = lib.get_solver_factory("K").build_solver(
        op, tlib.SolverState(seqs, [2, 3], device="cpu"))
    with pytest.raises(RuntimeError, match="host-only"):
        solver.solve(b)


def test_minres_rescue_warns_and_reports_host(problems):
    """MINRES with the exact (indefinite) inverse of the saddle system as
    its preconditioner breaks down in the torch loop; the rescue warns
    and reports 'host', as the JAX library does, and solves there."""
    entries = {"K": _krylov("MINRES", "D"),
               "D": {"Type": "Direct", "Solver Parameters": {}}}
    out = []
    for side, lib in (("jax", jlib), ("port", tlib)):
        op, A, b, seqs = problems(side, "block")
        kw = {} if side == "jax" else {"device": "cpu"}
        solver = lib.SolverLibrary.create_library(entries) \
            .get_solver_factory("K").build_solver(
                op, lib.SolverState(seqs, [2, 3], **kw))
        with pytest.warns(RuntimeWarning, match="broke down"):
            x = solver.solve(b)
        out.append((solver.executed_on, x))
        assert np.linalg.norm(b - A @ x) <= 1e-4 * np.linalg.norm(b)
    (ej, xj), (et, xt) = out
    assert et == ej == "host"
    assert _rel(xt, xj) <= 1e-8


@pytest.mark.parametrize("name", ["PCG-AMGe-L1GS", "PCG-AMS", "PCG-ADS",
                                  "PCG-AMGe-W-Cheby-2lev"])
def test_convert_carries_a_library_hierarchy(name, problems):
    """The hierarchy a JAX library solver built (the preconditioner's
    _H: l1-Jacobi, Hiptmair or Chebyshev smoothers), carried across by
    convert.hierarchy_from_numpy: one cycle of it, of the port-built
    hierarchy and of the JAX one on the same seeded r agree within
    1e-12."""
    import jax
    from parelag_tpu_torch import convert
    entries, entry, kind, forms = COMPOSITIONS[name]
    hs = []
    for side, lib in (("jax", jlib), ("port", tlib)):
        op, A, b, seqs = problems(side, kind)
        kw = {} if side == "jax" else {"device": "cpu"}
        solver = lib.SolverLibrary.create_library(entries) \
            .get_solver_factory(entry).build_solver(
                op, lib.SolverState(seqs, list(forms), **kw))
        hs.append(solver._prec._H)
    Hj, Ht = hs
    Hc = convert.hierarchy_from_numpy(
        jax.tree_util.tree_map(np.asarray, Hj), device="cpu")
    r = np.random.RandomState(0).randn(A.shape[0])
    yj = np.asarray(Hj.cycle(jax.numpy.asarray(r)))
    for H in (Hc, Ht):
        assert _rel(H.cycle(torch.as_tensor(r)).numpy(), yj) <= 1e-12


def test_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlib.SolverState([], [0])


def _rewritten(text):
    return re.sub(r"(?m)^(\s*)from parelag_tpu\.", r"\1from parelag_tpu_torch.",
                  text)


# the documented edits of the port's solvers/saddle_extra.py: MLDivFree
# takes device= for its H(curl) AMGe solve and its HybridHdivL2 solve
SADDLE_EDITS = [
    ('  * MLDivFree (ParELAG_MLDivFree.hpp:24-150)\n"""',
     '  * MLDivFree (ParELAG_MLDivFree.hpp:24-150)\n\n'
     'A copy of parelag_tpu/solvers/saddle_extra.py; MLDivFree takes\n'
     'device= (None: the card) for its H(curl) AMGe solve and its\n'
     'HybridHdivL2 solve.\n"""'),
    ("import scipy.sparse.linalg as spla\n",
     "import scipy.sparse.linalg as spla\n\n"
     "from parelag_tpu_torch import resolve_device\n"),
    ('    the pressure is recovered from the momentum residual."""\n\n'
     "    def __init__(self, seqs, w_weight=0.0, rtol=1e-8):\n"
     "        self.seqs = seqs\n",
     "    the pressure is recovered from the momentum residual.  device:\n"
     "    where the H(curl) hierarchy is built and solved (None: the\n"
     '    card)."""\n\n'
     "    def __init__(self, seqs, w_weight=0.0, rtol=1e-8, device=None):\n"
     "        self.device = resolve_device(device)\n"
     "        self.seqs = seqs\n"),
    ("                                  rtol=self.rtol, rescale=True)",
     "                                  rtol=self.rtol, rescale=True,\n"
     "                                  device=self.device)"),
    ('                                           smoother="hiptmair")\n'
     "            phi, info = amge_pcg_solve(H, H.levels[0].A, g, "
     "rtol=self.rtol)",
     '                                           smoother="hiptmair",\n'
     "                                           device=self.device)\n"
     "            phi, info = amge_pcg_solve(H, H.levels[0].A, g, "
     "rtol=self.rtol,\n"
     "                                       device=self.device)"),
]


def test_saddle_extra_equals_its_source():
    """saddle_extra.py is a copy after SADDLE_EDITS (params.py is in
    test_torch_generic.py's VERBATIM list)."""
    path = "solvers/saddle_extra.py"
    with open(os.path.join(ROOT, "parelag_tpu", path)) as f:
        src = _rewritten(f.read())
    for old, new in SADDLE_EDITS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    with open(os.path.join(ROOT, "parelag_tpu_torch", path)) as f:
        assert f.read() == src


@pytest.mark.parametrize("name", ["SolverState", "Block2x2Operator",
                                  "_as_matrix", "_BlockSolver",
                                  "_StationarySolver"])
def test_library_host_plane_follows_its_source(name):
    """The host plane of library.py is the JAX module's: the same code
    once the device argument is threaded through."""
    import inspect
    src = _rewritten(inspect.getsource(getattr(jlib, name)))
    port = inspect.getsource(getattr(tlib, name))
    if name == "SolverState":
        src = src.replace('(ParELAG_SolverState.hpp:54)."""',
                          '(ParELAG_SolverState.hpp:54) and the torch device\n'
                          '    every device-side object is built on (None: the '
                          'card)."""')
        src = src.replace("w_weight=0.0):", "w_weight=0.0, device=None):")
        src = src.replace("        self.w_weight = w_weight\n",
                          "        self.w_weight = w_weight\n"
                          "        self.device = resolve_device(device)\n")
    if name == "_BlockSolver":
        src = src.replace("                         state.ess_attrs)",
                          "                         state.ess_attrs, "
                          "device=state.device)")
    assert port == src


def test_lane_library_on_the_cpu():
    """library_lane.lane_library at nref 2 (both chains) on the CPU:
    every composition runs its Krylov loop in torch, meets the rtol's
    reach, and the kernel phase's operators are the lane's f64 ones."""
    from parelag_tpu_torch import library_lane
    rec, solvers, solves = library_lane.lane_library(2, "cpu", 2)
    assert set(rec["compositions"]) == set(library_lane.SCALAR) | set(
        library_lane.DARCY)
    for name, c in rec["compositions"].items():
        assert c["executed_on"] == "device", name
        assert c["rel_res"] <= 1e-6, (name, c["rel_res"])
        assert np.isfinite(solves[name][1]).all()
    ops = library_lane.kernel_operators(solvers)
    assert [l for l, _ in ops][-3:] == [
        "form-1 Hiptmair D0", "form-1 Hiptmair A_aux0", "form-1 Krylov A0"]
    assert all(M.dtype == torch.float64 for _, M in ops)
