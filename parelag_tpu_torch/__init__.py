"""parelag_tpu_torch — the PyTorch/CUDA port of parelag_tpu for NVIDIA
Hopper.

The JAX package (`parelag_tpu`) stays the reference; this package mirrors
its layout module by module (`amge/structured.py`, `ops/device_sparse.py`,
`solvers/hierarchy.py`, ...) so each counterpart is easy to find.  Plain
tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a CUDA C++ kernel for sm_90a (`csrc/`), built with nvcc at
first use (`ops/build.py`) and launched through `ops/hopper_kernels.py`.

Importing this package has no side effects: no allocator tuning, no
mlock, no CUDA initialisation, no kernel build.  It imports neither jax
nor parelag_tpu (the JAX package's import hooks were never tried in a
process that holds a CUDA context), so the few numpy host helpers the
ported path needs are carried here as copies.
"""

import torch

__version__ = "0.1.0"


def device():
    """The current CUDA device, or RuntimeError when there is no card: a
    measurement never falls back to the CPU.  (CPU tensors need no
    helper: every kernel wrapper runs its plain version on them.)"""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(dev=None):
    """The device argument of every entry point: None means device(),
    the card (RuntimeError without one); the CPU only when the caller
    names it (device="cpu")."""
    return device() if dev is None else torch.device(dev)


def synchronize(dev):
    """Wait for the work queued on `dev` (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the XML solver library and the checkpoint functions, loaded at first
# use (as the JAX package's lazy exports) so that importing the package stays light
_LAZY = {
    "SolverLibrary": ("parelag_tpu_torch.solvers.library", "SolverLibrary"),
    "SolverState": ("parelag_tpu_torch.solvers.library", "SolverState"),
    "ParameterList": ("parelag_tpu_torch.utils.params", "ParameterList"),
    "read_xml": ("parelag_tpu_torch.utils.params", "read_xml"),
    "save_pytree": ("parelag_tpu_torch.utils.checkpoint", "save_pytree"),
    "load_pytree": ("parelag_tpu_torch.utils.checkpoint", "load_pytree"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    mod, attr = _LAZY[name]
    return getattr(importlib.import_module(mod), attr)
