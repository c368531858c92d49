"""Process start to the first timed call: imports, loading the kernel
library, the operators, the hierarchy, the input pool, capture and
warm-up."""


def read(run):
    return run.setup_s
