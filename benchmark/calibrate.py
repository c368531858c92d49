"""Readings that the limits of `correct` are set from, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--out F]

Builds the cell's program once; for each seed of --seeds makes that
seed's input pool and runs a short closed-loop window as a run does,
then the reference judges the answers the run would judge (the lower
readings).  For each seed of --control-seeds the reference's own
solver, in the configuration's control_dtype (the precision below the
one it states), answers the same number of that seed's calls in the
program's place and is judged the same way (the upper readings).  One
JSON object a line; the benchmark's runs never run this.
"""

import argparse
import json
import sys
import time

import benchmark


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal on a tiny spec (--spec)")
    ap.add_argument("--spec", help="a BENCHMARK.json other than the root's")
    args = ap.parse_args(argv)
    benchmark.pin_threads()
    import torch
    from benchmark import harness
    harness.set_cache_dirs()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    spec = harness.load_spec(args.spec) if args.spec else harness.load_spec()
    cell = harness.resolve(spec, args.workload)
    reference = harness.load_module("reference", cell.config["family"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec.update(workload=args.workload,
                   card=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t0 = time.perf_counter()
    fam = harness.make_family(cell, device, harness.Spans(device))
    emit(dict(kind="setup", seconds=time.perf_counter() - t0))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        fam.load_inputs(seed)
        calls, window_s, judged = harness.window(fam, args.seconds, seed,
                                                 cell.mix)
        samples = [fam.sample(i, a) for i, a in judged.items]
        t = time.perf_counter()
        checks = reference.judge(cell.config, samples, device)
        emit(dict(kind="program", seed=seed, checks=checks,
                  judged=len(samples), calls=len(calls),
                  iters=sorted({c.iters for c in calls}),
                  failed=sum(not c.converged for c in calls),
                  rhs_per_s=sum(c.rhs for c in calls) / window_s,
                  judge_s=time.perf_counter() - t))
    dtype = getattr(torch, cell.config["control_dtype"])
    k = int(cell.mix["judged_calls"])
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        fam.load_inputs(seed)
        t = time.perf_counter()
        samples = []
        for i in range(k):
            s = fam.sample(i, None)
            rhs = s.get("b", s.get("f"))
            ans = reference.solve(cell.config, rhs, device, dtype)
            if "b" in s:
                s["x"] = ans
            else:
                s["u"], s["p"] = ans
            samples.append(s)
        solve_s = time.perf_counter() - t
        checks = reference.judge(cell.config, samples, device)
        emit(dict(kind="control", seed=seed, dtype=str(dtype),
                  checks=checks, judged=len(samples), solve_s=solve_s))
    fam.close()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
