"""Right-hand sides solved to the configuration's tolerance in the
window, over the window's seconds (first call's start to the last
call's end); a call of s right-hand sides counts s."""


def read(run):
    return sum(c.rhs for c in run.calls if c.converged) / run.window_s
