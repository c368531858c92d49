"""What the benchmark takes from the program besides the system under
test: its launch counters and the names of its hand-written kernels."""

import functools
import os
import re


def load_kernels(device):
    """Build (first run in a checkout) and load the kernel library on
    the card: set-up work, done before the operators are built."""
    if device.type == "cuda":
        from parelag_tpu_torch.ops import hopper_kernels
        hopper_kernels.load()


def counters():
    """Hand-kernel launches so far, by name (a graph replay adds its
    init and body x iterations)."""
    from parelag_tpu_torch.ops import graph_loop
    return graph_loop.snapshot()


def launched(after, before):
    return sum(after[k] - before.get(k, 0) for k in after)


@functools.lru_cache(maxsize=None)
def kernel_names():
    """The __global__ functions of the program's CUDA sources."""
    from parelag_tpu_torch.ops import build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for f in sorted(os.listdir(build.CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(build.CSRC_DIR, f)) as fh:
                names.update(pat.findall(fh.read()))
    return frozenset(names)
