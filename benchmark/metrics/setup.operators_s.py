"""Host-clock span around the family's operator build (ended by a
device synchronize)."""


def read(run):
    return run.spans.get("setup.operators")
