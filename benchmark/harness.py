"""The harness: a cell of BENCHMARK.json run once, driven by data.

A cell names a configuration and a mix.  The configuration's file
(benchmark/configs/<config>.json) names its family; the harness loads

    benchmark/families/<family>.py    builds the program's solver and
                                      exposes its calls (class Family)
    benchmark/reference/<family>.py   the plain reference (judge)
    benchmark/mixes/<mix>.json        the traffic's parameters
    benchmark/metrics/<metric>.py     one reader per metric (read(run))

by name, so a later configuration, mix or metric is new files and
entries, never an edit here.  A run: set-up (the family's operators,
hierarchy, input pool, capture and warm-up), a closed-loop window of
solve calls, then (traced runs) the per-layer readers; the program's
state is freed and the reference judges a sample of the window's
answers drawn from the seed.
"""

import importlib.util
import json
import math
import os
import re
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import traffic
from benchmark import trace as tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_spec(path=ROOT / "BENCHMARK.json"):
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """benchmark/<kind>/<name>.py, imported from its path (metric names
    hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    key = f"benchmark.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def resolve(spec, name):
    """The cell `name` of spec: its workload entry, configuration file,
    mix file and the metric entries it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(configs[w["config"]]["file"])
    mix = _json(Path("benchmark") / "mixes" / f"{w['traffic']}.json")
    mine = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if mine(m) and m["moves"] in reported]
    return Cell(w, config, mix, e2e, layer)


class Spans:
    """Host-clock spans of set-up stages, each closed by a synchronize
    of the device; a name used twice adds up."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@dataclass
class Call:
    seconds: float
    rhs: int
    iters: int
    converged: bool


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    device: torch.device
    setup_s: float
    spans: dict
    calls: list
    window_s: float
    peak_bytes: int
    trace: object = None
    probes: dict = field(default_factory=dict)


def window(fam, seconds, seed, mix):
    """Closed-loop calls for `seconds`: the next call starts when the
    last returns.  Returns (calls, window seconds: first call's start
    to the last call's end, the reservoir of judged answers)."""
    judged = traffic.Reservoir(mix["judged_calls"], seed)
    calls = []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        ans = fam.call(i)
        t1 = time.perf_counter()
        calls.append(Call(t1 - t0, ans["rhs"], ans["iters"],
                          ans["converged"]))
        judged.offer((i, ans["answer"]))
        i += 1
        if t1 - t_start >= seconds:
            return calls, t1 - t_start, judged


def device_info(device, peak, trace_summary):
    if device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1, memory_peak_bytes=int(peak))
    else:
        info = dict(platform=device.type, kind="cpu", count=1,
                    memory_peak_bytes=int(peak))
    if trace_summary is not None:
        info.update(busy_s=trace_summary.busy_s,
                    window_s=trace_summary.window_s)
    return info


#: a dotted part of a metric's name that names its tier: the widest
#: spread, in percent, that the cells of that tier showed between runs
TIER = re.compile(r"spread\d+")


def metric_reader(name):
    """The reader of metric `name`: benchmark/metrics/<name>.py, the name
    read without its tier (`rhs_per_s.spread3` reads as `rhs_per_s`,
    `kernels.spread3.a0_apply_roofline` as `kernels.a0_apply_roofline`):
    one quantity, under bounds that differ with the cells' spread."""
    base = ".".join(p for p in name.split(".") if not TIER.fullmatch(p))
    return load_module("metrics", base).read


def read_metrics(entries, run):
    out = {}
    for m in entries:
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(spec, workload, seed, seconds, trace, device, clock):
    """One run of `workload` on `device`; clock() gives seconds since
    the process started.  Returns the result line (a dict)."""
    cell = resolve(spec, workload)
    family = load_module("families", cell.config["family"])
    reference = load_module("reference", cell.config["family"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans(device)
    fam = family.Family(cell.config, cell.mix, device, spans)
    fam.load_inputs(seed)
    setup_s = clock()
    summary = tracing.stretch(fam) if trace else None
    calls, window_s, judged = window(fam, seconds, seed, cell.mix)
    fam.check_window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell, device, setup_s, dict(spans.seconds), calls, window_s,
              peak, summary, fam.probes() if trace else {})
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           run)
    samples = [fam.sample(i, answer) for i, answer in judged.items]
    fam.close()
    del fam, run, judged
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = reference.judge(cell.config, samples, device)
    limits = cell.config["limits"]
    correct = samples and all(
        math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits)
    result = dict(correct=bool(correct), attempted=len(calls),
                  failed=sum(not c.converged for c in calls),
                  metrics=metrics,
                  device=device_info(device, peak, summary))
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary.device_ops,
                                   idle_gaps=summary.idle_gaps)
        result["trace"] = dict(calls=summary.calls,
                               hand_traced=summary.hand_traced,
                               hand_counted=summary.hand_counted,
                               whole=summary.whole)
    result["judged"] = len(samples)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result


def forbidden_modules():
    """Modules of sys.modules whose top-level name is jax, jaxlib, flax
    or the JAX package (whole names: parelag_tpu_torch is allowed)."""
    banned = {"jax", "jaxlib", "flax", "parelag_tpu"}
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in banned)


def cache_dirs():
    """Fixed cache directories inside the checkout for every compiler
    cache a run could write (the program's own kernel library goes to
    parelag_tpu_torch/_build/, also inside the checkout)."""
    base = ROOT / "_bench_cache"
    return {"TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TRITON_CACHE_DIR": base / "triton",
            "CUDA_CACHE_PATH": base / "nv"}


def set_cache_dirs():
    for k, v in cache_dirs().items():
        os.environ[k] = str(v)
