"""The benchmark of parelag_tpu_torch on the H100: one cell a run.

    python3 -m benchmark.run --workload h1_struct_128.rhs1 --seed 7 \
        --seconds 30 --trace 0

See benchmark/README.md.  Nothing here imports jax or parelag_tpu.
"""

import os

#: host threads of the measured process: one rank a card, one thread a
#: rank, as MPI runs of the program are deployed (on the card's machine
#: the host-bound Darcy solves ran 2-11 % faster and no less steady
#: than with a thread pool a core)
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}


def pin_threads():
    """Set THREADS in the environment; call before numpy or torch is
    imported."""
    os.environ.update(THREADS)
