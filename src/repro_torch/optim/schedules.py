"""Learning-rate schedules (port of `repro.optim.schedules`). WSD
(warmup-stable-decay) is the schedule MiniCPM (arXiv:2404.06395) trains with.

Each schedule is a plain function of the host's int step. It returns, as a
python float, the float32 value the reference computes on the device: the
same float32 operations in the same order, in numpy float32. Only the
transcendental functions (cosine's cos, wsd's power) come from numpy's
float32 routines rather than XLA's, and may differ from them in the last bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.engine.spec import SCHEDULES

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def _warm(lr, step, warmup):
    return f32(lr) * np.minimum(step / f32(max(warmup, 1)), f32(1.0))


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        step = f32(step)
        if step < warmup:
            return float(_warm(lr, step, warmup))
        prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0.0), f32(1.0))
        # final_frac*lr and (1-final_frac)*lr*0.5 are python products, as in
        # the reference, rounded to float32 where they meet the array
        cos = f32(final_frac * lr) + f32((1 - final_frac) * lr * 0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(cos)

    return f


def wsd(lr: float, warmup: int, stable: int, decay: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, flat plateau, exponential-ish decay."""

    def f(step):
        step = f32(step)
        if step < warmup:
            return float(_warm(lr, step, warmup))
        if not step > f32(warmup + stable):
            return float(f32(lr))
        prog = np.clip((step - f32(warmup) - f32(stable)) / f32(max(decay, 1)),
                       f32(0.0), f32(1.0))
        return float(f32(lr) * np.power(f32(final_frac), prog))

    return f


def for_run(name: str, lr: float, warmup: int, n_steps: int):
    """Resolve a schedule name for a run of `n_steps` total steps, with the
    phases partitioning the run: for wsd the decay phase is the back (ceil)
    half of the post-warmup budget, so warmup + stable + decay == n_steps."""
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return cosine(lr, warmup, n_steps)
    if name == "wsd":
        rem = max(n_steps - warmup, 0)
        stable = rem // 2
        decay = rem - stable
        return wsd(lr, warmup, stable, decay)
    raise ValueError(f"unknown schedule {name!r}; known: {', '.join(SCHEDULES)}")
