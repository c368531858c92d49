"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 also breakdown;
checks last); the last lines of standard error give each number the
reference compared beside its limit.  Without a card, with fewer cards
than the cell asks for, with the cell's work on other cards than it asks
for (harness.cards_used: exit 4), or with jax or the JAX package loaded
in a process of the cell when the window has closed (exit 3), it prints
no result and exits with a code other than 0.
"""

import time

_T_BOOT = time.clock_gettime(time.CLOCK_BOOTTIME)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _started_at():
    """CLOCK_BOOTTIME at this process's start (/proc/self/stat), or at
    this module's first line where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_BOOT


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = _started_at()

    import benchmark
    benchmark.pin_threads()
    from benchmark import harness
    harness.set_cache_dirs()
    import torch

    spec = harness.load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}: {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    clock = lambda: time.clock_gettime(time.CLOCK_BOOTTIME) - started
    try:
        result = harness.run_cell(spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace), device,
                                  clock)
    except harness.CardError as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return e.code
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
