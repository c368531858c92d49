"""Host-clock span around the family's hierarchy build and the solve's
capture (ended by a device synchronize)."""


def read(run):
    return run.spans.get("setup.hierarchy")
