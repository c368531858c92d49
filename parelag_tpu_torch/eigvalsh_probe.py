"""Probe of torch.linalg.eigvalsh on the card for the structured setup's
small Gram matrices (the trace and bubble guards of amge/structured.py).

    python -m parelag_tpu_torch.eigvalsh_probe [--chains 8] [--save DIR]
        [-- pytest arguments, e.g. tests/test_torch_cuda.py]

For the run, structured._eigvalsh is replaced by a checking version: each
batch G is checked for non-finite entries, and its eigenvalues are taken
four ways -- on the card in G's dtype (cuSOLVER, torch's default), on the
card through MAGMA, on the card in f64, on the host -- and the batches
whose result is not finite are counted for each way.  A batch whose card
result is not finite is solved again REPEAT times on the card (same
input: does it recur?) and, with --save, written to DIR as .npy.  The
host result is returned, so the chains run as the package runs them.

With pytest arguments, those tests run first under the probe; then
--chains flagship chains at 16^3 (f32, min_coarse 64, the card tests'
size) are built on the card, alternately bare (flagship.structured_chain)
and as the 4-RHS lane (flagship.lane_h1), which also launches the
kernels.  Prints one JSON line of counts.  Needs a card.
"""

import argparse
import json
import os
from collections import Counter

import numpy as np
import torch

from parelag_tpu_torch import device as pick_device, flagship
from parelag_tpu_torch.amge import structured

REPEAT = 20


def _bad(ev):
    return not bool(torch.isfinite(ev).all())


def _magma(G):
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        return torch.linalg.eigvalsh(G)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def install(counts, save=None):
    """Replace structured._eigvalsh by the checking version; counts
    collects {way: batches with a non-finite result}."""
    def probe(G):
        counts["batches"] += 1
        counts["matrices"] += G.shape[0]
        if _bad(G):
            counts["G_nonfinite"] += 1
        host = torch.linalg.eigvalsh(G.cpu())
        if G.device.type == "cuda":
            ways = {"card": lambda: torch.linalg.eigvalsh(G),
                    "card_magma": lambda: _magma(G),
                    "card_f64": lambda: torch.linalg.eigvalsh(G.double())}
            for way, fn in ways.items():
                if _bad(fn()):
                    counts[way + "_nonfinite"] += 1
                    if way == "card":
                        counts["card_recur"] += sum(
                            _bad(fn()) for _ in range(REPEAT))
                        if save:
                            os.makedirs(save, exist_ok=True)
                            np.save(os.path.join(
                                save, f"G_{counts['batches']}.npy"),
                                G.cpu().numpy())
        if _bad(host):
            counts["host_nonfinite"] += 1
        return host.to(G.device)

    structured._eigvalsh = probe


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--save", default=None,
                    help="write the batches with a non-finite card result "
                         "to this directory")
    ap.add_argument("pytest_args", nargs="*")
    args = ap.parse_args(argv)
    dev = pick_device()
    counts = Counter()
    install(counts, args.save)
    out = dict(card=torch.cuda.get_device_name(0), torch=torch.__version__,
               cuda=torch.version.cuda, chains=args.chains)
    if args.pytest_args:
        import pytest
        out["pytest_rc"] = int(pytest.main(args.pytest_args))
    for i in range(args.chains):
        if i % 2:
            flagship.lane_h1(16, dev, n_rhs=4, min_coarse=64)
        else:
            flagship.structured_chain(16, 64, np.float32, dev)
    out.update(counts)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
