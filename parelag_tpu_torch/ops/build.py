"""Build the hand-written CUDA kernels (csrc/*.cu) with nvcc and load them.

Each source compiles in its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface
(`extern "C"` launchers), loaded through ctypes — no PyTorch headers, so
a build takes seconds.  The library lands in `parelag_tpu_torch/_build/`
(listed in .gitignore) under a name keyed by the hash of the sources and
flags: a changed source rebuilds, an unchanged one loads the existing
file.  Nothing builds at import; `load()` builds at first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# sm_90a, not sm_90: the "a" target is the one that admits Hopper's
# wgmma/setmaxnreg, which later kernels will use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the shared CUDA runtime: the kernels launch through the process's
# libcudart (the one PyTorch loaded), where torch.profiler sees them; a
# statically linked runtime hides them from its traces; libdl for
# csrc/loop.cu's dladdr
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-cudart", "shared", "-ldl")

#: result of the last build: {"path", "seconds", "built"}
BUILD_INFO = {}


def nvcc_path():
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of parelag_tpu_torch build from source")


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _digest(paths):
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=CSRC_DIR)


def _wait(proc):
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(proc.args)}\n{out}")


def build():
    """Compile csrc/*.cu into _build/ unless the library for these exact
    sources exists; returns its path.  The compile goes to a temporary
    file that is renamed into place, so a concurrent loader never sees a
    half-written library."""
    srcs = _sources()
    lib = os.path.join(BUILD_DIR, f"libparelag_hopper_{_digest(srcs)}.so")
    if os.path.isfile(lib):
        BUILD_INFO.update(path=lib, seconds=0.0, built=False)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    tmp = os.path.join(tmpdir, "lib.so")
    nvcc = nvcc_path()
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in cus]
    t0 = time.perf_counter()
    procs = []
    try:
        # one nvcc per source, all started together, then one link
        for s, o in zip(cus, objs):
            procs.append(_nvcc([nvcc, *NVCC_FLAGS, "-c", s, "-o", o]))
        for p in procs:
            _wait(p)
        _wait(_nvcc([nvcc, *LINK_FLAGS, "-o", tmp, *objs]))
        os.replace(tmp, lib)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)
    BUILD_INFO.update(path=lib, seconds=time.perf_counter() - t0,
                      built=True)
    return lib


def load():
    """Build if needed and load the kernel library, with the ctypes
    signatures of its launchers declared."""
    lib = ctypes.CDLL(build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u64 = ctypes.c_ulonglong
    signatures = {
        # the DIA launchers take their plan struct by pointer
        "dia_spmv_launch": [i32, vp, vp, vp, vp, i32, i64, i32, i32, vp],
        "dia_jacobi_sweep_launch": [i32, vp, vp, vp, vp, vp, vp, i32, i64,
                                    i32, vp],
        "dia_spmv_multirhs_launch": [i32, vp, vp, vp, vp, i32, i64, i32,
                                     i32, i32, vp],
        "dia_jacobi_sweep_multirhs_launch": [i32, vp, vp, vp, vp, vp, vp,
                                             i32, i64, i32, i32, vp],
        "bcsr_spmv_launch": [i32, i32, vp, vp, vp, vp, vp, i32, i32, i32,
                             vp],
        "bcsr_spmv_multirhs_launch": [i32, i32, vp, vp, vp, vp, vp, i32,
                                      i32, i32, vp],
        "ell_spmv_launch": [i32, i32, vp, vp, vp, vp, i32, i32, i32, i32,
                            i32, vp],
        # csrc/loop.cu: the loop test and the graph helpers
        "pcg_loop_test_launch": [i32, vp, vp, i32, vp, vp, i32, i32, u64,
                                 i32, vp],
        "loop_handle_create": [vp, ctypes.POINTER(u64)],
        "loop_while_begin": [vp, vp, u64, ctypes.POINTER(vp)],
        "loop_while_end": [vp],
        "loop_last_error": [],
        "loop_graph_count": [vp, ctypes.POINTER(i64)],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    return lib
