"""Cycle-shape configuration (PyTorch).

Counterpart of parelag_tpu/solvers/autotune.py.  This slice ports the
smoother factory's l1-Jacobi branch, the cycle the H1 flagship runs;
the Chebyshev branch and the measured `tune_cycle` search come later.
"""

from parelag_tpu_torch.solvers import smoothers as sm


def _factory(cfg, device=None):
    if cfg["smoother"] == "l1jacobi":
        return lambda A, l: sm.make_l1_jacobi(
            A, sweeps=cfg.get("sweeps", 1), device=device)
    raise ValueError(f"smoother {cfg['smoother']!r} is not ported yet")
