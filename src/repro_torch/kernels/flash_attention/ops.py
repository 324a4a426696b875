"""Public wrapper of the flash attention kernel (csrc/flash_attention.cu).

CUDA tensors launch the kernel (or raise); CPU tensors run `attention_ref`.
`launches` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)  # the instantiations in csrc/flash_attention.cu
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]

launches = 0


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,dh), k/v (B,S,K,dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh:
        raise ValueError(f"self-attention only: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,dh); k,v: (B,S,K,dh) -> (B,S,H,dh) in q.dtype. Any S."""
    global launches
    _check(q, k, v)
    if not kernels.use_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window).to(q.dtype)
    B, S, H, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d_head in {HEAD_DIMS}, got {dh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    code = kernels.dtype_code(q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = kernels.kernel_fn("flash_attention_fwd", _ARGTYPES)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, k.shape[2], dh, int(bool(causal)), int(window),
                1.0 / math.sqrt(dh), code, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("flash_attention", rc)
    launches += 1
    return out
