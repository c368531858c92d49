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

A cell's `chips` is held to what its processes read of their cards:
every process of the cell (the measuring process, and those a
multi-card family starts) takes one card_reading when the window has
closed, and the result's `device` is worked out from those readings
alone (cards_used); a run whose work did not reach its cards, or one of
whose processes loaded JAX, gives no result (CardError).
"""

import importlib.util
import json
import math
import os
import re
import resource
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
    """What a metric reader reads (peak_bytes: the fullest card's)."""
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


def card_reading(device):
    """What one process of a cell reads of its card once the window has
    closed: the card (`card`: its UUID; `index`: as this process numbers
    it), its name, this process's peak of allocated device memory
    (torch.cuda.max_memory_allocated), its process id and the forbidden
    modules it has loaded.  On the CPU (the tests' rehearsals) the card is
    `cpu:<index>` and the peak the process's resident high-water mark."""
    if device.type == "cuda":
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        card = str(torch.cuda.get_device_properties(index).uuid)
        name = torch.cuda.get_device_name(index)
        peak = torch.cuda.max_memory_allocated(index)
    else:
        index = device.index or 0
        card, name = f"{device.type}:{index}", device.type
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return dict(card=card, index=index, name=name, peak_bytes=int(peak),
                pid=os.getpid(), forbidden=forbidden_modules())


def gather_readings(device):
    """Every process of a multi-card family's torch.distributed group
    calls this once, after the window has closed: each takes its
    card_reading, and rank 0 (the measuring process) gets them all in
    rank order; the other ranks get None."""
    import torch.distributed as dist
    reading = card_reading(device)
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(reading, out, dst=0)
    return out


def cell_readings(fam, device):
    """One card_reading a process of the cell: the measuring process's
    own on `device`, then those of the processes the family started
    (Family.cards(), where the family has it: one entry a process it
    started, None for one that gave none)."""
    cards = getattr(fam, "cards", None)
    return [card_reading(device)] + (list(cards()) if cards else [])


class CardError(RuntimeError):
    """A run whose processes did not do its work on the cards its cell
    asks for, or one of which loaded JAX: it prints no result, and the
    command exits with `code`."""

    def __init__(self, problems, code):
        super().__init__("; ".join(problems))
        self.code = code


def cards_used(readings, chips):
    """The cards that did a cell's work, from one reading a process of the
    cell (None for a process that gave none): (name, peak bytes) a card,
    in the processes' order.  A card did work where its process's peak is
    above 0.  Raises CardError naming every fault found: a reading
    missing, jax, jaxlib, flax or the JAX package loaded in a process
    (code 3), a card used by two processes, cards of different names, or
    another number of cards than `chips` (code 4 for the rest)."""
    problems = [f"no reading from process {i} of the cell's {len(readings)}"
                for i, r in enumerate(readings) if r is None]
    got = [r for r in readings if r is not None]
    loaded = [f"loaded in process {r['pid']}: {', '.join(r['forbidden'])}"
              for r in got if r["forbidden"]]
    problems += loaded
    by_card = {}
    for r in got:
        if r["peak_bytes"] > 0:
            by_card.setdefault(r["card"], []).append(r)
    for card, rs in by_card.items():
        if len(rs) > 1:
            problems.append(f"card {rs[0]['index']} ({card}) used by "
                            f"processes {[r['pid'] for r in rs]}: one "
                            "process a card")
    names = sorted({rs[0]["name"] for rs in by_card.values()})
    if len(names) > 1:
        problems.append(f"cards of different kinds: {names}")
    if len(by_card) != chips:
        problems.append(f"work reached {len(by_card)} card(s), the cell "
                        f"asks for {chips}")
    if problems:
        raise CardError(problems, 3 if loaded else 4)
    return [(rs[0]["name"], rs[0]["peak_bytes"]) for rs in by_card.values()]


def device_info(device, cards, trace_summary):
    """The result's `device`, from cards_used's cards: never from the
    cell's `chips`."""
    peaks = [peak for _, peak in cards]
    info = dict(platform="gpu" if device.type == "cuda" else device.type,
                kind=cards[0][0], count=len(cards),
                memory_peak_bytes=max(peaks),
                memory_peak_bytes_per_device=peaks)
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


def make_family(cell, device, spans):
    """The cell's family, built in the measuring process on `device`.  A
    cell of `chips` N > 1 also hands it `devices`, the cards 0 ... N-1 of
    device's type: the measuring process keeps the first, and the family
    starts its own processes on the others.  A one-card cell's family is
    built without it."""
    family = load_module("families", cell.config["family"])
    chips = int(cell.workload["chips"])
    more = {}
    if chips > 1:
        more["devices"] = [torch.device(device.type, i) for i in range(chips)]
    return family.Family(cell.config, cell.mix, device, spans, **more)


def run_cell(spec, workload, seed, seconds, trace, device, clock):
    """One run of `workload` on `device`; clock() gives seconds since
    the process started.  Returns the result line (a dict); raises
    CardError where the cell's cards do not hold (cards_used)."""
    cell = resolve(spec, workload)
    reference = load_module("reference", cell.config["family"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans(device)
    fam = make_family(cell, device, spans)
    try:
        fam.load_inputs(seed)
        setup_s = clock()
        summary = tracing.stretch(fam) if trace else None
        calls, window_s, judged = window(fam, seconds, seed, cell.mix)
        fam.check_window()
        cards = cards_used(cell_readings(fam, device),
                           int(cell.workload["chips"]))
        run = Run(cell, device, setup_s, dict(spans.seconds), calls,
                  window_s, max(peak for _, peak in cards), summary,
                  fam.probes() if trace else {})
        metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                               run)
        samples = [fam.sample(i, answer) for i, answer in judged.items]
    finally:
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
                  device=device_info(device, cards, summary))
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
