"""Carry the reference's parameters into the port.

`params_from_jax` takes the reference's value tree as numpy arrays
(`split_params(model_init(...))[0]` mapped through `np.asarray`) and returns
the port's params: the same nested keys, shapes and dtypes (stacked leading
super-block dim, gated `wi` as (d, 2, f), a hybrid's f32 Mamba leaves
`A_log`, `dt_bias` and `D` kept f32), as tensors on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as T


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy owned by the tensor
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """Numpy value tree of the reference -> port params on `device`. Raises
    if a key, shape or dtype differs from what the port's model_init builds."""
    want = T.model_init(None, cfg, device="meta")

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
