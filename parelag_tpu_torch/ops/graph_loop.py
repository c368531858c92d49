"""The loop test of the device-resident PCG, and the CUDA graph capture
around it: the port's counterpart of jax.jit over a lax.while_loop.

The JAX package runs every timed solve as one device program: pcg's loop
is a lax.while_loop whose `cond` (parelag_tpu/solvers/cg.py:36-38),
any(nom > tol2) & (it < maxiter), XLA evaluates on the device.  Here:

  pcg_loop_test   csrc/loop.cu   the `cond`: bumps the int32 iteration
                                 counter by `step`, evaluates the test
                                 and sets a CUDA graph WHILE node's
                                 handle (no Pallas kernel: the JAX
                                 package leaves the test to XLA)
  loop_test_plain                its plain version, JAX's `cond`

capture_while(init, body, test, device) captures init(); test(0);
WHILE { body(); test(1) } as one graph.  PyTorch 2.11's CUDAGraph has
no conditional nodes, so while PyTorch captures the program, csrc/
loop.cu adds the WHILE node through the runtime API and captures the
body on a second stream straight into the node's body graph; that
stream's allocations go to a torch.cuda.MemPool of their own
(torch._C._cuda_beginAllocateCurrentStreamToPool), kept with the
program, so the body's temporaries live as long as the graph.  capture(fn) captures a plain
graph (the steps of make_pcg_stepper).  Neither falls back to eager
launches: a capture that fails raises.

Launch counts: a wrapper adds to its counter when it is called, and
under capture that is when the graph is recorded, not when it runs.  So
a capture measures the launches of each part, takes them back off the
counters, and each run adds them again: init + body x iterations
(count_run).  The counters are hopper_kernels.LAUNCHES (the ports of
the TPU kernels) and LAUNCHES here (pcg_loop_test).
"""

import ctypes
import time

import torch

from parelag_tpu_torch.ops import hopper_kernels as hk

LAUNCHES = {"pcg_loop_test": 0}

_TEST_DTYPES = {torch.float32: 0, torch.float64: 2}   # common.cuh codes


def loop_test_plain(nom, tol2, it, maxiter, step=0):
    """JAX's `cond` after `step` iterations: (go, it + step), go =
    any(nom > tol2) & (it + step < maxiter) as a 0-d bool tensor (a NaN
    in nom compares false)."""
    it = it + step
    return torch.any(nom > tol2) & (it < maxiter).reshape(()), it


def pcg_loop_test(nom, tol2, it, maxiter, step=0, go=None, handle=None):
    """The loop test in place: it += step (it a one-element int32
    tensor), then go = any(nom > tol2) & (it < maxiter), written to `go`
    (a one-element bool tensor) when given and, on the card, to the
    conditional `handle` when given (only inside a graph that owns it).
    nom, tol2: f32 or f64, at most 64 entries (one per column).  A CPU
    tensor runs loop_test_plain; a CUDA tensor launches csrc/loop.cu's
    kernel or raises.  Returns go (on the card: the `go` tensor, or
    None)."""
    if hk._on_cpu(*(t for t in (nom, tol2, it, go) if t is not None)):
        g, k = loop_test_plain(nom, tol2, it, maxiter, step)
        it.copy_(k)
        if go is not None:
            go.copy_(g)
        return g
    name = "pcg_loop_test"
    hk._check(name, nom.dtype in _TEST_DTYPES and tol2.dtype == nom.dtype
              and tol2.shape == nom.shape, f"nom {nom.dtype} "
              f"{tuple(nom.shape)}, tol2 {tol2.dtype} {tuple(tol2.shape)} "
              "(need equal f32 or f64)")
    hk._check(name, 1 <= nom.numel() <= hk.MAX_RHS,
              f"{nom.numel()} columns (1 to {hk.MAX_RHS})")
    hk._check(name, it.dtype == torch.int32 and it.numel() == 1
              and (go is None or (go.dtype == torch.bool
                                  and go.numel() == 1)),
              "it must be one int32, go one bool")
    hk._check(name, nom.is_contiguous() and tol2.is_contiguous(),
              "nom and tol2 must be contiguous")
    lib = hk.load()
    with torch.cuda.device(nom.device):
        rc = lib.pcg_loop_test_launch(
            _TEST_DTYPES[nom.dtype], hk._ptr(nom), hk._ptr(tol2),
            nom.numel(), hk._ptr(it),
            None if go is None else hk._ptr(go), int(step), int(maxiter),
            0 if handle is None else handle, int(handle is not None),
            hk._stream(nom))
    hk._raise_rc(name, rc)
    LAUNCHES[name] += 1
    return go


# --------------------------------------------------------------------- #
# launch bookkeeping
# --------------------------------------------------------------------- #

def reset_launches():
    LAUNCHES["pcg_loop_test"] = 0


def snapshot():
    """All launch counters, as one dict."""
    return {**hk.LAUNCHES, **LAUNCHES}


def delta(after, before):
    """Counter by counter, after - before (two snapshots)."""
    return {k: after[k] - before[k] for k in after}


def _restore(snap):
    for d in (hk.LAUNCHES, LAUNCHES):
        for k in d:
            d[k] = snap[k]


def _add(counts, times=1):
    for d in (hk.LAUNCHES, LAUNCHES):
        for k in d:
            d[k] += counts.get(k, 0) * times


# --------------------------------------------------------------------- #
# capture
# --------------------------------------------------------------------- #

def _rc(what, rc):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _sp(stream):
    return ctypes.c_void_p(stream.cuda_stream)


def graph_count(lib, graph):
    """(nodes, kernel nodes, kernel nodes of the hand-written kernels) of
    a cudaGraph_t and the child graphs in it."""
    out = (ctypes.c_longlong * 3)()
    _rc("loop_graph_count", lib.loop_graph_count(graph, out))
    return tuple(int(v) for v in out)


_STREAMS = {}


def _streams(device):
    """The two capture streams of a device, made once: the program's and
    the loop body's.  The warm-up runs on them too, so that cuBLAS's
    workspace for each stream is set up outside any capture."""
    if device not in _STREAMS:
        _STREAMS[device] = (torch.cuda.Stream(device),
                            torch.cuda.Stream(device))
    return _STREAMS[device]


def _on(stream, *fns):
    """Run fns on `stream`, ordered after the current stream's work, and
    wait for them."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    cur.wait_stream(stream)
    torch.cuda.synchronize(stream.device)


class GraphProgram:
    """A captured program: `graph` (torch.cuda.CUDAGraph), the launches
    of its parts (`init`, and `body` for a loop), `compile_s` (warm-up
    excluded: capture and instantiate, ending in a synchronize), `nodes`
    (all nodes of the graph, the loop body's included), `body_nodes`
    (graph_count of the loop body) and, for a loop, `events`: the two
    timing events recorded by the graph itself, before init and after
    the WHILE node."""

    def __init__(self, graph, init, body, compile_s, nodes, body_nodes,
                 events=None):
        self.graph, self.init, self.body = graph, init, body
        self.compile_s, self.nodes = compile_s, nodes
        self.body_nodes = body_nodes
        self.events = events

    def replay(self):
        self.graph.replay()

    def device_seconds(self):
        """The last run's seconds on the card, init to the loop's end,
        from the graph's own events (no host submission in them); the
        run must have ended."""
        start, end = self.events
        return start.elapsed_time(end) * 1e-3

    def count_run(self, iterations=0):
        """Add one run's launches to the counters: init + body x
        iterations."""
        _add(self.init)
        _add(self.body, iterations)


def _capture_body(lib, pool, stream, body_stream, handle, body, test):
    """Inside a capture on `stream`: a WHILE node on `handle`, its body
    captured on body_stream with that stream's allocations in `pool`, a
    torch.cuda.MemPool (PyTorch's allocator takes one recording a pool,
    and the program's capture holds the graph's own; the routing is
    torch.cuda.use_mem_pool's, by capturing stream instead of thread).
    Returns the body's cudaGraph_t."""
    dev = stream.device
    body_graph = ctypes.c_void_p()
    _rc("loop_while_begin", lib.loop_while_begin(
        _sp(stream), _sp(body_stream), handle, ctypes.byref(body_graph)))
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index,
                                                            pool.id)
            try:
                body()
                test(1, handle)
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool.id)
                torch._C._cuda_releasePool(dev.index, pool.id)
    except BaseException:
        lib.loop_while_end(_sp(body_stream))
        lib.loop_last_error()
        raise
    _rc("cudaStreamEndCapture", lib.loop_while_end(_sp(body_stream)))
    return body_graph


def _failed(lib, device, pool):
    """Clean up after a capture that raised: the runtime's last error,
    and the allocator's recording to the graph's pool, which PyTorch's
    capture_end leaves in place when the capture was invalidated (it
    raises before it ends it; a recording left open makes the allocator
    fail its next release of cached memory)."""
    lib.loop_last_error()
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass                         # capture_end had ended it


def capture_while(init, body, test, device):
    """Capture init(); test(0, h); WHILE { body(); test(1, h) } on
    `device` as one graph, h the WHILE node's conditional handle, which
    test(step, handle) hands to pcg_loop_test, between two timing
    events the graph records (GraphProgram.device_seconds).  The loop
    runs while the last test said go, as lax.while_loop(cond, body)
    does.  init and body run once each before the capture (warm-up).
    Returns a GraphProgram; raises if any part cannot be captured (a
    host read, a synchronize)."""
    lib = hk.load()
    stream, body_stream = _streams(device)
    _on(stream, init, lambda: test(0, None))
    _on(body_stream, body, lambda: test(1, None))
    t0 = time.perf_counter()
    snap = snapshot()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    pool = torch.cuda.graph_pool_handle()
    body_pool = torch.cuda.MemPool()
    # recorded by the graph: event-record nodes on the program's stream
    events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                   for _ in range(2))
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            events[0].record()
            init()
            handle = ctypes.c_ulonglong()
            _rc("cudaGraphConditionalHandleCreate",
                lib.loop_handle_create(_sp(stream), ctypes.byref(handle)))
            test(0, handle.value)
            after_init = snapshot()
            body_graph = _capture_body(lib, body_pool, stream,
                                       body_stream, handle.value, body,
                                       test)
            events[1].record()
            after_body = snapshot()
    except BaseException:
        _failed(lib, device, pool)
        raise
    finally:
        _restore(snap)
    body_nodes = graph_count(lib, body_graph)
    nodes = graph_count(lib, ctypes.c_void_p(graph.raw_cuda_graph()))[0]
    graph.instantiate()
    torch.cuda.synchronize(device)
    prog = GraphProgram(graph, delta(after_init, snap),
                        delta(after_body, after_init),
                        time.perf_counter() - t0, nodes + body_nodes[0],
                        body_nodes, events)
    prog.body_pool = body_pool       # as long as the graph
    return prog


def capture(fn, device):
    """Capture fn() on `device` as one graph (after one warm-up run);
    returns a GraphProgram whose `init` is fn's launches."""
    lib = hk.load()
    stream = _streams(device)[0]
    _on(stream, fn)
    t0 = time.perf_counter()
    snap = snapshot()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    pool = torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
            after = snapshot()
    except BaseException:
        _failed(lib, device, pool)
        raise
    finally:
        _restore(snap)
    nodes = graph_count(lib, ctypes.c_void_p(graph.raw_cuda_graph()))
    graph.instantiate()
    torch.cuda.synchronize(device)
    return GraphProgram(graph, delta(after, snap), {},
                        time.perf_counter() - t0, nodes[0], None)
