"""The one generator of inputs: a mix file's parameters and the seed give
a pool of cellwise sources, the same on every run of a seed.

A mix (benchmark/mixes/<name>.json) sets rhs_per_call (right-hand sides
a solve call takes), pool_calls (distinct calls in the pool; call i
takes pool[i % pool_calls]), judged_calls (the calls of a window that
the reference judges, drawn from the seed) and the source law (only
"cellwise_standard_normal" so far).  The family turns each source into
its right-hand side.
"""

import numpy as np
import torch

SOURCES = ("cellwise_standard_normal",)


def source_pool(mix, seed, cells, device):
    """pool_calls tensors of shape (rhs_per_call,) + cells, float32 on
    `device`, from a generator on that device seeded with `seed`."""
    if mix["source"] not in SOURCES:
        raise ValueError(f"unknown source law {mix['source']!r}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shape = (int(mix["rhs_per_call"]),) + tuple(cells)
    return [torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
            for _ in range(int(mix["pool_calls"]))]


class Reservoir:
    """A uniform sample of k calls of a window of unknown length, drawn
    from the seed (reservoir sampling): offer every call in order."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed), 0x6a75646765])
        self.items = []
        self.seen = 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
