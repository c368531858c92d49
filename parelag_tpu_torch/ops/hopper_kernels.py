"""Hand-written Hopper kernels for the solve-phase hot ops, with their
plain PyTorch versions.

Counterpart of parelag_tpu/ops/pallas_kernels.py.  Every Pallas kernel
of the JAX package has a CUDA C++ counterpart for sm_90a here (sources
in csrc/, built by ops/build.py):

  dia_spmv                   csrc/dia.cu   replaces dia_spmv_pallas
  dia_jacobi_sweep           csrc/dia.cu   replaces dia_jacobi_sweep_pallas
                                           (both: a tile's x windows and,
                                           bf16 or a small grid, its
                                           table rows staged in shared
                                           memory by dia_row_plan)
  dia_spmv_multirhs          csrc/dia.cu   replaces dia_spmv_multirhs_pallas
  dia_jacobi_sweep_multirhs  csrc/dia.cu   replaces
                                           dia_jacobi_sweep_multirhs_pallas
                                           (both: X staged in shared memory
                                           by dia_stage_plan's windows)
  bcsr_spmv                  csrc/bcsr.cu  replaces bcsr_spmv_pallas
  bcsr_spmv_multirhs         csrc/bcsr.cu  BcsrMatrix.matvec on (m, s)
                                           (XLA in the JAX package)
  ell_spmv                   csrc/ell.cu   replaces ell_spmv_pallas
                                           (G lanes a row from
                                           ell_launch_plan; the row-group
                                           code of csrc/row_spmv.cuh, as
                                           bcsr_spmv)

Each plain version takes x of shape (m,) or (m, s), as the JAX formats
do; the multi-RHS wrappers use the same plain functions as the 1-RHS
ones.  Dispatch is by tensor device, never by a try/except: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises.
Each wrapper adds one to LAUNCHES[name] where it launches its kernel and
nowhere else, so a run can show which kernels it went through.  The
TPU-only machinery of the JAX module (the lowering probes, retry and
disable latches, the 1024-aligned x superblock, the transposed (s, n)
multi-RHS layout) has no counterpart.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

LAUNCHES = {"dia_spmv": 0, "dia_jacobi_sweep": 0, "dia_spmv_multirhs": 0,
            "dia_jacobi_sweep_multirhs": 0, "bcsr_spmv": 0,
            "bcsr_spmv_multirhs": 0, "ell_spmv": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

DIA_MAX_OFFS = 64            # csrc/dia.cu DIA_MAX_OFFS: the 1-RHS kernels
                             # (to_dia_ell keeps up to 64 offsets)
# the 1-RHS DIA kernels (dia_row_plan): rows a thread (1 or 2), each
# dtype's halved while there would be fewer than ROW_MIN_TILES tiles of
# ROW_THREADS threads (one for each SM of an H100) or the table rows of
# the least tile pass ROW_SMEM_BYTES; whether a tile's table rows are
# staged in shared memory (else each thread loads its coefficients from
# device memory; a grid under ROW_MIN_TILES tiles stages them in every
# dtype); threads a block (at most csrc/dia.cu kRowMaxThreads),
# halved down to ROW_MIN_THREADS while a tile's staged rows take more
# than ROW_SMEM_BYTES (the default dynamic shared memory limit,
# csrc/dia.cu kRowSmemBytes)
ROW_ROWS = {torch.float32: 2, torch.bfloat16: 2, torch.float64: 1}
ROW_TABLE_STAGED = {torch.float32: False, torch.bfloat16: True,
                    torch.float64: False}
ROW_THREADS = 256
ROW_MIN_THREADS = 32
ROW_MIN_TILES = 132
ROW_SMEM_BYTES = 49_152
DIA_STAGE_MAX_OFFS = 48      # csrc/dia.cu DIA_STAGE_MAX_OFFS: the staged
                             # multi-RHS kernels (the DIA format's 48)
MAX_RHS = 64                 # s limit of the multi-RHS kernels
                             # (DiaMatrix._MAX_RHS of the JAX module)
# the staged multi-RHS DIA kernels (dia_stage_plan): the row tile R each
# dtype starts from and the least R (rounded down, resp. up, to whole
# blocks of STAGE_ROW_BLOCK 16-byte runs of the table), and the dynamic
# shared bytes a plan aims under: two blocks, each with its 208 static
# bytes and the 1 KB the card reserves, fit an H100 SM's 228 KB
STAGE_ROWS = {torch.float32: 256, torch.bfloat16: 512, torch.float64: 256}
STAGE_MIN_ROWS = 32
STAGE_ROW_BLOCK = 3          # csrc/dia.cu kTR: rows per thread
STAGE_RUN = 3                # csrc/dia.cu kRun: the longest run
STAGE_TARGET_BYTES = 115_456
STAGE_MAX_BYTES = 232_192    # csrc/dia.cu kStageMaxBytes

_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from parelag_tpu_torch.ops import build
        _LIB = build.load()
    return _LIB


def acc_dtype(dtype):
    """Accumulator type of the kernels: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors on mixed or unsupported devices: "
                         f"{[str(t.device) for t in ts]}")
    return False


def _check(name, cond, what):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _rows(v, x):
    """v (n,) broadcast against x (n,) or (n, s)."""
    return v[:, None] if x.ndim == 2 else v


# --------------------------------------------------------------------- #
# DIA SpMV and the fused Jacobi sweep, 1 and s right-hand sides
# --------------------------------------------------------------------- #

def dia_spmv_plain(data, offs, x, n):
    """y[i] = sum_d data[d, i] * x[i + offs[d]] for i < n, x[j] = 0
    outside [0, m); x (m,) or (m, s) (every column at once).  The result
    takes the promoted dtype of data and x and accumulates in f32 (f64
    for f64), like the kernels."""
    m = x.shape[0]
    out = torch.promote_types(data.dtype, x.dtype)
    acc = acc_dtype(out)
    xa = x.to(acc)
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            y[lo:hi] += _rows(data[d, lo:hi].to(acc), x) \
                * xa[lo + off:hi + off]
    return y.to(out)


def dia_jacobi_sweep_plain(data, offs, x, b, dw):
    """One fused weighted-Jacobi sweep x + dw * (b - A x) of a square DIA
    operator (dw (n,) carries omega * dinv and is shared by the columns
    of a 2-D x), computed in f32 (f64 for f64) and stored in x's dtype,
    like the kernels."""
    n = x.shape[0]
    acc = acc_dtype(x.dtype)
    ax = dia_spmv_plain(data, offs, x.to(acc), n).to(acc)
    return (x.to(acc) + _rows(dw.to(acc), x) * (b.to(acc) - ax)
            ).to(x.dtype)


def _dia_args(name, data, offs, n, *ts, max_offs=DIA_MAX_OFFS):
    nd, ld = data.shape
    _check(name, data.dtype in DTYPE_CODES
           and all(t.dtype == data.dtype for t in ts),
           f"dtypes {data.dtype}/{[str(t.dtype) for t in ts]} (need "
           "equal f32, bf16 or f64)")
    _check(name, len(offs) == nd and 1 <= nd <= max_offs,
           f"{len(offs)} offsets for a table of {nd} rows (max "
           f"{max_offs})")
    _check(name, ld >= n, f"table width {ld} < n={n}")
    _check(name, data.is_contiguous() and all(t.is_contiguous()
                                              for t in ts),
           "tensors must be contiguous")
    return nd, ld


class DiaRowPlan(NamedTuple):
    """How the 1-RHS DIA kernels cut their work (csrc/dia.cu): a block of
    `threads` (T) threads owns a tile of R = `rows` T rows, thread t the
    rows t + r T (r < `rows`), `blocks` tiles.  `tstaged`: the block
    stages its nd table rows, each `tstride` = R + V elements (V = `vec`,
    16 bytes of items; `table_bytes` in all).  The sorted offsets merge
    into `windows` (lo, hi) at that tile (stage_windows); window k stages
    the x rows from the tile's row plus `lo[k]` (its lo rounded down to a
    multiple of V) on, `lens[k]` of them (R + hi - lo[k] + V - 1, rounded
    up to V: room for x's lead, the elements between the 16-byte boundary
    the copies start from and x's first element), from staged x element
    `base[k]` on: `stage_bytes` in all.  `staged` where they fit
    ROW_SMEM_BYTES beside the table rows (and x is not empty); then x[i +
    offs[d]] of the tile's row i - b sits at staged x element i - b +
    xo[d] + lead, and (`center` >= 0, offset 0 in a window) x[i] at i - b
    + center + lead; else x is read from device memory.  The sweep
    (`sweep`) also stages the tile's b and dw, R + V elements each
    (`vec_bytes`)."""
    offs: tuple
    vec: int
    rows: int
    threads: int
    blocks: int
    tstride: int
    tstaged: bool
    staged: bool
    windows: tuple
    lo: tuple
    lens: tuple
    base: tuple
    xo: tuple
    center: int
    table_bytes: int
    stage_bytes: int
    vec_bytes: int

    @property
    def smem_bytes(self):
        return ((self.table_bytes if self.tstaged else 0)
                + (self.stage_bytes if self.staged else 0) + self.vec_bytes)

    def tag(self):
        x = (f"x staged K={len(self.windows)}" if self.staged else
             f"x via L1/L2 (K={len(self.windows)} windows need "
             f"{self.stage_bytes} bytes)")
        table = "table staged" if self.tstaged else "table direct"
        return (f"RT={self.rows} T={self.threads} blocks={self.blocks} "
                f"{table} {x} smem={self.smem_bytes}")


def _row_layout(offs, tile, vec, item):
    """(tstride, windows, lo, lens, table bytes, window bytes) of a tile
    of `tile` rows."""
    wins = stage_windows(offs, tile)
    lo = tuple(w // vec * vec for w, _ in wins)
    lens = tuple(_ceil(tile + hi - l + vec - 1, vec) * vec
                 for l, (_, hi) in zip(lo, wins))
    tstride = tile + vec
    return (tstride, wins, lo, lens, len(offs) * tstride * item,
            sum(lens) * item)


@functools.lru_cache(maxsize=None)
def dia_row_plan(offs, n, m, dtype, sweep=False):
    """The plan of the 1-RHS DIA kernels for a table with offsets `offs`
    (a tuple), n rows, an x of m rows and `dtype`, for the SpMV or
    (`sweep`) the Jacobi sweep, from those shapes alone (it reads no
    tensor, so a captured CUDA graph can run through it).  The table
    rows are staged where ROW_TABLE_STAGED[dtype] says so or there are
    fewer than ROW_MIN_TILES tiles of ROW_THREADS threads.  RT starts at
    ROW_ROWS[dtype] and halves while there would be fewer than
    ROW_MIN_TILES tiles of ROW_THREADS threads or the table rows of a
    tile of ROW_MIN_THREADS exceed ROW_SMEM_BYTES; T starts at
    ROW_THREADS and halves, down to ROW_MIN_THREADS, while the tile's
    staged rows (table, b and dw, and, x not empty, the windows) exceed
    ROW_SMEM_BYTES.  Cached on its arguments: one plan per shape."""
    item = torch.empty((), dtype=dtype).element_size()
    vec = 16 // item
    tstaged = (ROW_TABLE_STAGED[dtype]
               or _ceil(n, ROW_THREADS * ROW_ROWS[dtype]) < ROW_MIN_TILES)

    def table(layout):
        return layout[4] if tstaged else 0

    def fits(layout, tile):
        return (table(layout) + (layout[5] if m > 0 else 0)
                + (2 * (tile + vec) * item if sweep else 0)
                <= ROW_SMEM_BYTES)

    rows = ROW_ROWS[dtype]
    while rows > 1 and (
            _ceil(n, ROW_THREADS * rows) < ROW_MIN_TILES
            or table(_row_layout(offs, ROW_MIN_THREADS * rows, vec, item))
            > ROW_SMEM_BYTES):
        rows //= 2
    threads = ROW_THREADS
    while threads > ROW_MIN_THREADS and not fits(
            _row_layout(offs, threads * rows, vec, item), threads * rows):
        threads //= 2
    tile = threads * rows
    layout = _row_layout(offs, tile, vec, item)
    tstride, wins, lo, lens, tbytes, sbytes = layout
    staged = m > 0 and fits(layout, tile)
    base = tuple(sum(lens[:k]) for k in range(len(wins)))
    which = [next(k for k, (a, b) in enumerate(wins) if a <= o <= b)
             for o in offs]
    xo = tuple(base[k] + o - lo[k] for o, k in zip(offs, which))
    k0 = next((k for k, (a, b) in enumerate(wins) if a <= 0 <= b), None)
    center = base[k0] - lo[k0] if staged and k0 is not None else -1
    return DiaRowPlan(tuple(offs), vec, rows, threads, _ceil(n, tile),
                      tstride, tstaged, staged, wins, lo, lens, base, xo,
                      center, tbytes, sbytes,
                      2 * (tile + vec) * item if sweep else 0)


class _DiaRow(ctypes.Structure):
    """ctypes mirror of csrc/dia.cu struct DiaRow."""
    _fields_ = [(f, ctypes.c_int) for f in ("threads", "rows", "tstride",
                                             "tstaged", "staged", "center",
                                             "nwin", "xlen")] \
        + [(f, ctypes.c_int * DIA_MAX_OFFS)
           for f in ("off", "xo", "lo", "len", "base")]


@functools.lru_cache(maxsize=None)
def _row_arg(plan):
    """The plan as the kernels take it."""
    p = _DiaRow(threads=plan.threads, rows=plan.rows, tstride=plan.tstride,
                tstaged=plan.tstaged, staged=plan.staged,
                center=plan.center, nwin=len(plan.windows),
                xlen=sum(plan.lens))
    for d, (o, xo) in enumerate(zip(plan.offs, plan.xo)):
        p.off[d], p.xo[d] = o, xo
    for k, (lo, ln, b) in enumerate(zip(plan.lo, plan.lens, plan.base)):
        p.lo[k], p.len[k], p.base[k] = lo, ln, b
    return p


def _row_plan(data, offs, n, m, sweep=False):
    offs = offs if type(offs) is tuple else tuple(int(o) for o in offs)
    return dia_row_plan(offs, n, m, data.dtype, sweep)


def dia_spmv(data, offs, x, n):
    """DIA SpMV (csrc/dia.cu on CUDA, dia_spmv_plain on CPU).  data
    (nd, ld) with ld >= n, row aligned; offs a tuple of nd ints; x (m,).
    On CUDA: nd <= 64 and x of the table's dtype; the launch is cut by
    dia_row_plan.  n = 0 launches nothing."""
    if _on_cpu(data, x):
        return dia_spmv_plain(data, offs, x, n)
    name = "dia_spmv"
    _check(name, x.ndim == 1, "x must be one-dimensional on CUDA")
    nd, ld = _dia_args(name, data, offs, n, x)
    y = torch.empty(n, dtype=data.dtype, device=x.device)
    if n == 0:
        return y
    m = x.shape[0]
    plan = _row_plan(data, offs, n, m)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.dia_spmv_launch(DTYPE_CODES[data.dtype], _ptr(data),
                                 _ptr(x), _ptr(y),
                                 ctypes.byref(_row_arg(plan)), nd, ld, n, m,
                                 _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return y


def dia_jacobi_sweep(data, offs, x, b, dw):
    """Fused DIA Jacobi sweep (csrc/dia.cu on CUDA, cut as dia_spmv); x,
    b, dw (n,) of the table's dtype, nd <= 64.
    Returns a new x; the input is not overwritten."""
    if _on_cpu(data, x, b, dw):
        return dia_jacobi_sweep_plain(data, offs, x, b, dw)
    name = "dia_jacobi_sweep"
    n = x.shape[0]
    _check(name, x.ndim == 1 and b.shape == x.shape and dw.shape == x.shape,
           f"shapes x{tuple(x.shape)} b{tuple(b.shape)} "
           f"dw{tuple(dw.shape)}")
    nd, ld = _dia_args(name, data, offs, n, x, b, dw)
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = _row_plan(data, offs, n, n, sweep=True)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.dia_jacobi_sweep_launch(
            DTYPE_CODES[data.dtype], _ptr(data), _ptr(x), _ptr(b), _ptr(dw),
            _ptr(out), ctypes.byref(_row_arg(plan)), nd, ld, n, _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return out


class DiaStagePlan(NamedTuple):
    """How the staged multi-RHS DIA kernels cut their work (csrc/dia.cu).
    A block stages tiles of `rows` (R) rows and `cols` (C) columns: the
    tile's nd table rows, each `tstride` = R + 16 bytes of elements (from
    the 16-byte boundary at or below the row's first entry), and the
    windows: window k holds the X rows [b + lo_k, b + R + hi_k) of the
    tile at row b, for windows[k] = (lo_k, hi_k), from staged X row
    base[k] on (row stride: the slice's columns).  window_of[d] is offset
    d's window, sh[d] the staged row of X[i + offs[d]] minus i's row in
    the tile, center the same for X[i] (the sweep; None unless asked
    for), and smem_bytes the block's shared memory for a full slice,
    table and windows.  period is P where the windows are equally long
    and P apart (the planes of a grid), else 0: then the tile at b + P
    takes windows 1..K-1 of the tile at b as its 0..K-2, and a block
    marching up the planes stages only the new top window.  runs cuts
    the offsets, in order, into (first d, length) runs of at most
    STAGE_RUN whose staged rows sh are consecutive (the c = -1, 0, 1 of
    a stencil line): a thread reads each X row of a run once."""
    rows: int
    cols: int
    tstride: int
    period: int
    windows: tuple
    window_of: tuple
    base: tuple
    sh: tuple
    center: int
    smem_bytes: int
    runs: tuple


def _ceil(a, b):
    return -(-a // b)


def stage_windows(offs, rows):
    """Merge offsets into windows (lo, hi), sorted and disjoint:
    neighbouring offsets share a window while their gap is below `rows`
    (then one window of rows + hi - lo rows costs less than two)."""
    wins = []
    for o in sorted(set(offs)):
        if wins and o - wins[-1][1] < rows:
            wins[-1][1] = o
        else:
            wins.append([o, o])
    return tuple((lo, hi) for lo, hi in wins)


@functools.lru_cache(maxsize=None)
def dia_stage_plan(offs, s, dtype, sweep=False):
    """The staging plan of the multi-RHS DIA kernels for a table with
    offsets `offs` (a tuple) and `dtype` and an X of s columns; for the
    sweep (sweep=True) the windows also cover offset 0, which it reads
    for X[i].  It starts from C = s and R = STAGE_ROWS[dtype] and, while
    table rows and windows take more than STAGE_TARGET_BYTES, doubles the
    column slices while a row of a slice is wider than 64 bytes (so the
    table is read once in all where a row of X fits 64 bytes), then
    halves R down to STAGE_MIN_ROWS, then doubles the slices down to one
    16-byte slice.  R stays a multiple of STAGE_ROW_BLOCK 16-byte runs
    of table entries (each thread takes STAGE_ROW_BLOCK rows; a table row
    is staged in 16-byte chunks) and C a multiple of 16 bytes where s
    allows, so a slice keeps the kernels' 16-byte path.  Cached on its
    arguments: one plan per shape."""
    item = torch.empty((), dtype=dtype).element_size()
    w16 = 16 // item
    unit = STAGE_ROW_BLOCK * w16
    step = w16 if s % w16 == 0 else 1
    need = set(offs) | ({0} if sweep else set())
    least = _ceil(STAGE_MIN_ROWS, unit) * unit
    rows = max(least, STAGE_ROWS[dtype] // unit * unit)
    slices, cols = 1, s

    def nbytes(r, c):
        return (sum(r + hi - lo for lo, hi in stage_windows(need, r)) * c
                + len(offs) * (r + w16)) * item

    def narrower():
        # twice the slices, each as even as the 16-byte step allows
        k = slices * 2
        return k, max(min(s, w16), _ceil(_ceil(s, k), step) * step)

    while nbytes(rows, cols) > STAGE_TARGET_BYTES:
        if cols * item > 64:
            slices, cols = narrower()
        elif rows > least:
            rows = max(least, rows // 2 // unit * unit)
        elif cols > min(s, w16):
            slices, cols = narrower()
        else:
            break
    wins = stage_windows(need, rows)
    base, acc = [], 0
    for lo, hi in wins:
        base.append(acc)
        acc += rows + hi - lo
    which = {o: k for k, (lo, hi) in enumerate(wins)
             for o in need if lo <= o <= hi}
    sh = tuple(base[which[o]] + o - wins[which[o]][0] for o in offs)
    spans = {hi - lo for lo, hi in wins}
    gaps = {wins[k + 1][0] - wins[k][0] for k in range(len(wins) - 1)}
    period = gaps.pop() if len(spans) == 1 and len(gaps) == 1 else 0
    runs = []
    for d, v in enumerate(sh):
        if runs and runs[-1][1] < STAGE_RUN and v == sh[d - 1] + 1:
            runs[-1][1] += 1
        else:
            runs.append([d, 1])
    return DiaStagePlan(
        rows, cols, rows + w16, period, wins,
        tuple(which[o] for o in offs), tuple(base), sh,
        base[which[0]] - wins[which[0]][0] if sweep else None,
        nbytes(rows, cols), tuple(map(tuple, runs)))


class _DiaStage(ctypes.Structure):
    """ctypes mirror of csrc/dia.cu struct DiaStage."""
    _fields_ = [(f, ctypes.c_int) for f in ("rows", "cols", "nwin",
                                             "sweep", "tstride", "period",
                                             "nrun")] \
        + [(f, ctypes.c_int * (DIA_STAGE_MAX_OFFS + 1))
           for f in ("lo", "len", "base", "sh", "wof", "run_d0", "run_len")]


@functools.lru_cache(maxsize=None)
def _stage_arg(plan):
    """The plan as the kernels take it; the sweep's X[i] rides as entry
    nd of sh and wof."""
    p = _DiaStage(rows=plan.rows, cols=plan.cols, nwin=len(plan.windows),
                  sweep=plan.center is not None, tstride=plan.tstride,
                  period=plan.period, nrun=len(plan.runs))
    for k, (lo, hi) in enumerate(plan.windows):
        p.lo[k], p.len[k], p.base[k] = lo, plan.rows + hi - lo, plan.base[k]
    sh, wof = plan.sh, plan.window_of
    if plan.center is not None:
        k0 = next(k for k, (lo, hi) in enumerate(plan.windows)
                  if lo <= 0 <= hi)
        sh, wof = sh + (plan.center,), wof + (k0,)
    for d, (v, k) in enumerate(zip(sh, wof)):
        p.sh[d], p.wof[d] = v, k
    for j, (d0, length) in enumerate(plan.runs):
        p.run_d0[j], p.run_len[j] = d0, length
    return p


def _plan(name, data, offs, s, sweep=False):
    plan = dia_stage_plan(tuple(int(o) for o in offs), s, data.dtype, sweep)
    _check(name, plan.smem_bytes <= STAGE_MAX_BYTES,
           f"staged windows of {plan.smem_bytes} bytes exceed "
           f"{STAGE_MAX_BYTES}")
    return plan


def dia_spmv_multirhs(data, offs, x, n):
    """DIA SpMV of s right-hand sides at once (csrc/dia.cu on CUDA,
    dia_spmv_plain on CPU): x (m, s) row-major, y (n, s); X staged in
    shared memory by the windows of dia_stage_plan, the table read once
    for each column slice.  On CUDA: 1 <= s <= 64, nd <= 48 and x of the
    table's dtype."""
    if _on_cpu(data, x):
        return dia_spmv_plain(data, offs, x, n)
    name = "dia_spmv_multirhs"
    _check(name, x.ndim == 2 and 1 <= x.shape[1] <= MAX_RHS,
           f"x{tuple(x.shape)} must be (m, s) with 1 <= s <= {MAX_RHS}")
    nd, ld = _dia_args(name, data, offs, n, x, max_offs=DIA_STAGE_MAX_OFFS)
    m, s = x.shape
    plan = _plan(name, data, offs, s)
    lib = load()
    y = torch.empty((n, s), dtype=data.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.dia_spmv_multirhs_launch(
            DTYPE_CODES[data.dtype], _ptr(data), _ptr(x), _ptr(y),
            ctypes.byref(_stage_arg(plan)), nd, ld, n, m, s, _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return y


def dia_jacobi_sweep_multirhs(data, offs, x, b, dw):
    """Fused DIA Jacobi sweep of s right-hand sides (csrc/dia.cu on
    CUDA, staged as dia_spmv_multirhs): x, b (n, s), dw (n,) shared by
    the columns, all of the table's dtype.  Returns a new x; the input is
    not overwritten."""
    if _on_cpu(data, x, b, dw):
        return dia_jacobi_sweep_plain(data, offs, x, b, dw)
    name = "dia_jacobi_sweep_multirhs"
    _check(name, x.ndim == 2 and 1 <= x.shape[1] <= MAX_RHS
           and b.shape == x.shape and dw.shape == x.shape[:1],
           f"shapes x{tuple(x.shape)} b{tuple(b.shape)} "
           f"dw{tuple(dw.shape)} (need (n, s), s <= {MAX_RHS}, and (n,))")
    n, s = x.shape
    nd, ld = _dia_args(name, data, offs, n, x, b, dw,
                       max_offs=DIA_STAGE_MAX_OFFS)
    plan = _plan(name, data, offs, s, sweep=True)
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.dia_jacobi_sweep_multirhs_launch(
            DTYPE_CODES[data.dtype], _ptr(data), _ptr(x), _ptr(b), _ptr(dw),
            _ptr(out), ctypes.byref(_stage_arg(plan)), nd, ld, n, s,
            _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------- #
# BCSR SpMV (row-compressed nonzeros), 1 and s right-hand sides
# --------------------------------------------------------------------- #

# (values, x) dtype pairs csrc/bcsr.cu is instantiated for
_BCSR_PAIRS = {
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float64, torch.float64)}


def group_width(nnz, n):
    """Lanes per row of the 1-RHS BCSR kernel: the power of two that
    covers the mean nonzeros per row, from 2 up to 16 (P0 of the
    flagship, ~3.3 -> 4; R0, ~26 -> 16).  Not 32: on rows of ~26
    nonzeros 16 lanes and a second pass beat one pass of 32 lanes, which
    leaves 6 idle and takes a fifth shuffle step (csrc/bcsr.cu)."""
    g = 2
    while g < 16 and g * max(n, 1) < nnz:
        g *= 2
    return g


def bcsr_spmv_plain(row_ptr, col_idx, values, x, n):
    """y = A @ x for the n-row matrix A held as row_ptr (n + 1), col_idx
    (nnz) and values (nnz), x (m,) or (m, s): row ids by repeat_interleave
    over row_ptr, a gather of x, the products in f32 (f64 for f64) and an
    index_add_ into y, returned in the promoted dtype of values and x."""
    out = torch.promote_types(values.dtype, x.dtype)
    acc = acc_dtype(out)
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), row_ptr.diff(),
        output_size=col_idx.numel())
    prod = _rows(values.to(acc), x) * x.to(acc)[col_idx]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
    y.index_add_(0, rows, prod)
    return y.to(out)


def _bcsr_args(name, row_ptr, col_idx, values, x, n):
    _check(name, row_ptr.shape == (n + 1,) and row_ptr.dtype == torch.int32
           and col_idx.dtype == torch.int32
           and col_idx.shape == values.shape and values.ndim == 1,
           f"row_ptr {tuple(row_ptr.shape)} {row_ptr.dtype}, col_idx "
           f"{tuple(col_idx.shape)} {col_idx.dtype}, values "
           f"{tuple(values.shape)} (need (n + 1,) int32, (nnz,) int32 and "
           f"(nnz,), n={n})")
    _check(name, (values.dtype, x.dtype) in _BCSR_PAIRS,
           f"dtypes values={values.dtype} x={x.dtype}")
    _check(name, all(t.is_contiguous() for t in (row_ptr, col_idx, values,
                                                  x)),
           "tensors must be contiguous")


def bcsr_spmv(row_ptr, col_idx, values, x, n):
    """BCSR SpMV (csrc/bcsr.cu on CUDA, bcsr_spmv_plain on CPU).  On CUDA
    x is (m,) and (values, x) is one of bf16/bf16, bf16|f32 x bf16|f32,
    f64/f64; the kernel takes group_width lanes per row."""
    if _on_cpu(row_ptr, col_idx, values, x):
        return bcsr_spmv_plain(row_ptr, col_idx, values, x, n)
    name = "bcsr_spmv"
    _check(name, x.ndim == 1, "x must be one-dimensional on CUDA")
    _bcsr_args(name, row_ptr, col_idx, values, x, n)
    lib = load()
    y = torch.empty(n, dtype=torch.promote_types(values.dtype, x.dtype),
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bcsr_spmv_launch(
            DTYPE_CODES[values.dtype], DTYPE_CODES[x.dtype], _ptr(row_ptr),
            _ptr(col_idx), _ptr(values), _ptr(x), _ptr(y), n, x.shape[0],
            group_width(col_idx.numel(), n), _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return y


def bcsr_spmv_multirhs(row_ptr, col_idx, values, x, n):
    """BCSR product with s right-hand sides (csrc/bcsr.cu on CUDA,
    bcsr_spmv_plain on CPU): x (m, s) row-major, y (n, s); each nonzero
    is read once for all s columns.  On CUDA 1 <= s <= 64 and the dtype
    pairs of bcsr_spmv."""
    if _on_cpu(row_ptr, col_idx, values, x):
        return bcsr_spmv_plain(row_ptr, col_idx, values, x, n)
    name = "bcsr_spmv_multirhs"
    _check(name, x.ndim == 2 and 1 <= x.shape[1] <= MAX_RHS,
           f"x{tuple(x.shape)} must be (m, s) with 1 <= s <= {MAX_RHS}")
    _bcsr_args(name, row_ptr, col_idx, values, x, n)
    m, s = x.shape
    lib = load()
    y = torch.empty((n, s), dtype=torch.promote_types(values.dtype,
                                                      x.dtype),
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bcsr_spmv_multirhs_launch(
            DTYPE_CODES[values.dtype], DTYPE_CODES[x.dtype], _ptr(row_ptr),
            _ptr(col_idx), _ptr(values), _ptr(x), _ptr(y), n, m, s,
            _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return y


# --------------------------------------------------------------------- #
# ELL SpMV
# --------------------------------------------------------------------- #

ELL_THREADS = 256            # csrc/row_spmv.cuh kThreads
ELL_MAX_LANES = 16           # G caps as group_width's
ELL_SLOT_CHOICES = (1, 2, 4)   # S the kernel is instantiated for
# slots a lane aims at: G starts from the least power of two with G *
# ELL_SLOTS >= k (kernel_profile --ell-slots times the others)
ELL_SLOTS = 4
ELL_MIN_BLOCKS = 132         # one block for each SM of an H100


class EllPlan(NamedTuple):
    """How csrc/ell.cu cuts an (n, k) ELL product: `lanes` (G) lanes a
    row, `slots` (S) entries a lane loads before it uses any, and the
    grid's `blocks` of ELL_THREADS threads (one row a group of lanes)."""
    lanes: int
    slots: int
    blocks: int

    def tag(self):
        return f"G={self.lanes} S={self.slots} blocks={self.blocks}"


@functools.lru_cache(maxsize=None)
def ell_launch_plan(n, k):
    """The launch plan of ell_spmv for n rows of k slots: G the least
    power of two with G * ELL_SLOTS >= k, doubled while the grid would
    have fewer than ELL_MIN_BLOCKS blocks and G < k (at most
    ELL_MAX_LANES), and S the least of ELL_SLOT_CHOICES with G * S >= k
    (a longer row's rest is looped).  Cached on (n, k)."""
    lanes = 1
    while lanes < ELL_MAX_LANES and (
            lanes * ELL_SLOTS < k
            or (_ceil(n * lanes, ELL_THREADS) < ELL_MIN_BLOCKS
                and lanes < k)):
        lanes *= 2
    slots = next((s for s in ELL_SLOT_CHOICES if lanes * s >= k),
                 ELL_SLOT_CHOICES[-1])
    return EllPlan(lanes, slots, _ceil(n * lanes, ELL_THREADS))


def ell_spmv_plain(indices, values, x):
    """y[i] = sum_k values[i, k] * x[indices[i, k]] (gather + row
    reduce, in the promoted dtype as the JAX ell_matvec); x (m,) or
    (m, s)."""
    dt = torch.promote_types(values.dtype, x.dtype)
    g = x.to(dt)[indices]
    if x.ndim == 2:
        return torch.einsum("nk,nks->ns", values.to(dt), g)
    return torch.einsum("nk,nk->n", values.to(dt), g)


# (values, x) dtype pairs csrc/ell.cu is instantiated for: y in the
# promoted dtype, summed in f32 (f64 for f64)
_ELL_PAIRS = {
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)}


def ell_spmv(indices, values, x):
    """ELL SpMV (csrc/ell.cu on CUDA, cut by ell_launch_plan): indices
    (n, k) int32, values (n, k), x (m,).  On CUDA x is one-dimensional,
    (values, x) is f32/f32, f64/f64, bf16/bf16 or bf16/f32 (y in the
    promoted dtype, the sum in f32, f64 for f64) and n * k < 2^31."""
    if _on_cpu(indices, values, x):
        return ell_spmv_plain(indices, values, x)
    name = "ell_spmv"
    n, k = values.shape
    _check(name, x.ndim == 1, "x must be one-dimensional on CUDA")
    _check(name, indices.shape == (n, k) and indices.dtype == torch.int32,
           f"indices {tuple(indices.shape)} {indices.dtype}")
    _check(name, (values.dtype, x.dtype) in _ELL_PAIRS,
           f"dtypes values={values.dtype} x={x.dtype} (need f32/f32, "
           "f64/f64, bf16/bf16 or bf16/f32)")
    _check(name, all(t.is_contiguous() for t in (indices, values, x)),
           "tensors must be contiguous")
    _check(name, n * k < 2 ** 31, f"{n} x {k} entries (need < 2^31)")
    plan = ell_launch_plan(n, k)
    lib = load()
    y = torch.empty(n, dtype=torch.promote_types(values.dtype, x.dtype),
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ell_spmv_launch(DTYPE_CODES[values.dtype],
                                 DTYPE_CODES[x.dtype], _ptr(indices),
                                 _ptr(values), _ptr(x), _ptr(y), n, k,
                                 x.shape[0], plan.lanes, plan.slots,
                                 _stream(x))
    _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return y
