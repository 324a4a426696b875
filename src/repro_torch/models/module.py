"""Parameter initializers and nested-dict helpers (port of `repro.models.module`).

Parameters are plain nested dicts of tensors shaped like the reference's
value tree (no logical-axis boxes: the port runs on one card). Draws come
from an explicit `torch.Generator` on the target device; they cannot match
`jax.random`'s bits, so tests carry the reference's weights across with
`models.convert.params_from_jax` instead.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.common import tree_map  # (re-exported: serve, transformer)


def tree_copy_(dst, src) -> None:
    """dst[...] = src for every leaf pair of two nested dicts of one structure."""
    tree_map(lambda d, s_: d.copy_(s_), dst, src)


# ---------------------------------------------------------------- initializers


def normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """scale * N(0, 1) drawn in float32, then cast (the reference's order)."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x.mul_(scale)).to(dtype)


def lecun(gen, shape, fan_in: int, dtype, device) -> torch.Tensor:
    return normal(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype, device)


def dense_param(gen, d_in: int, d_out, dtype, device) -> torch.Tensor:
    shape = (d_in,) + ((d_out,) if isinstance(d_out, int) else tuple(d_out))
    return lecun(gen, shape, d_in, dtype, device)


def stacked(n: int, init_fn: Callable[[], dict]) -> dict:
    """`n` draws of a sub-tree stacked on a leading dim (the reference's
    scan-over-layers layout). Filled layer by layer, so the peak is one
    layer above the stacked result."""
    first = init_fn()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    tree_copy_(tree_map(lambda x: x[0], out), first)
    for i in range(1, n):
        tree_copy_(tree_map(lambda x, i=i: x[i], out), init_fn())
    return out
