"""Carry the reference's parameters and train state into the port.

`params_from_jax` takes the reference's value tree as numpy arrays
(`split_params(model_init(...))[0]` mapped through `np.asarray`) and returns
the port's params: the same nested keys, shapes and dtypes (stacked leading
super-block dim, gated `wi` as (d, 2, f), a hybrid's f32 Mamba leaves
`A_log`, `dt_bias` and `D` kept f32), as tensors on `device`.

`train_state_from_jax` does the same for the mesh trainer's whole state,
(params, GuidedState), so both packages can start from one state: the
guided bookkeeping, `w_stale` and the optimizer state ({"m"}, {"r"} or
{"m", "v", "t"}, accumulators in float32), with the step and adam's `t` as
host ints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import tree_map
from repro_torch.core.guided import GuidedState
from repro_torch.models import transformer as T


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy owned by the tensor
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg, device="cuda", dtype=None) -> dict:
    """Numpy value tree of the reference -> port params on `device`. Raises
    if a key, shape or dtype differs from what the port's model_init builds
    (every leaf `dtype` instead, when given: an optimizer accumulator)."""
    want = T.model_init(None, cfg, device="meta")
    if dtype is not None:
        want = tree_map(lambda a: a.to(dtype), want)

    def walk(src, ref, path):
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                raise ValueError(f"{path or 'params'}: keys {sorted(src) if isinstance(src, dict) else type(src)}"
                                 f" != {sorted(ref)}")
            return {k: walk(src[k], ref[k], f"{path}/{k}") for k in ref}
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(ref.shape)}")
        out = _to_tensor(arr, device)
        if out.dtype != ref.dtype:
            raise ValueError(f"{path}: dtype {out.dtype} != {ref.dtype}")
        return out

    return walk(tree, want, "")


def train_state_from_jax(params, gstate, cfg, device="cuda"):
    """The reference's mesh train state as numpy — `params` (a value tree)
    and `gstate` (its GuidedState with every array mapped through
    np.asarray) — -> the port's (params, GuidedState) on `device`."""
    def vec(a):
        return _to_tensor(np.asarray(a, np.float32), device)

    opt_state = gstate.opt_state
    if isinstance(opt_state, dict):
        opt_state = {k: int(np.asarray(v)) if k == "t" else
                     params_from_jax(v, cfg, device, dtype=torch.float32)
                     for k, v in opt_state.items()}
    return params_from_jax(params, cfg, device), GuidedState(
        step=int(np.asarray(gstate.step)),
        score=vec(gstate.score),
        prev_worker_loss=vec(gstate.prev_worker_loss),
        prev_avg_loss=vec(gstate.prev_avg_loss),
        w_stale=(params_from_jax(gstate.w_stale, cfg, device)
                 if isinstance(gstate.w_stale, dict) else ()),
        opt_state=opt_state,
        extra=(),
    )
