"""Public wrapper of the two flash attention kernels.

- `wgmma` (csrc/flash_attention_wgmma.cu): bf16 at d_head 64 and 128, on the
  tensor cores; the serve paths' kernel.
- `simt` (csrc/flash_attention.cu): float32 at d_head 32/64/128 and bf16 at
  d_head 32, on the FMA pipes; it holds float32 to the reference's 3e-5 bar.

CUDA tensors launch the kernel that `variant(dtype, d_head)` names (or raise);
CPU tensors run `attention_ref`. `launches` counts kernel launches, and only
those; `launches_by_variant` splits the same count by kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import attention_ref

SIMT_HEAD_DIMS = (32, 64, 128)   # the instantiations in csrc/flash_attention.cu
WGMMA_HEAD_DIMS = (64, 128)      # the instantiations in csrc/flash_attention_wgmma.cu
_SIMT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]

launches = 0
launches_by_variant = {"wgmma": 0, "simt": 0}


def variant(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes (dtype, d_head): bf16 at 64 or 128 runs on the
    tensor cores; float32, or d_head 32, on the FMA pipes. Raises on what
    neither kernel takes."""
    if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in (torch.float32, torch.bfloat16) and dh in SIMT_HEAD_DIMS:
        return "simt"
    raise ValueError(f"no flash_attention kernel takes {dtype} at d_head {dh}: bf16 at d_head "
                     f"{WGMMA_HEAD_DIMS} (wgmma), or float32 / bf16 at d_head {SIMT_HEAD_DIMS} "
                     f"(simt)")


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
    _check(q, k, v)
    if not kernels.use_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window).to(q.dtype)
    return run_variant(q, k, v, causal=causal, window=window,
                       variant=variant(q.dtype, q.shape[3]))


def run_variant(q, k, v, *, causal: bool = True, window: int = 0, variant: str):
    """Launch one named kernel on CUDA tensors: `flash_attention`'s choice, or
    (for measurement) the other one."""
    global launches
    _check(q, k, v)
    if not kernels.use_kernel(q, k, v):
        raise ValueError("run_variant launches a kernel: it takes CUDA tensors only")
    kernels.refuse_autograd(f"flash_attention ({variant})", q, k, v)
    B, S, H, dh = q.shape
    if variant not in launches_by_variant:
        raise ValueError(f"unknown flash_attention variant {variant!r}")
    dims = WGMMA_HEAD_DIMS if variant == "wgmma" else SIMT_HEAD_DIMS
    if dh not in dims:
        raise ValueError(f"flash_attention {variant} kernel takes d_head in {dims}, got {dh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], dh,
            int(bool(causal)), int(window), 1.0 / math.sqrt(dh))
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            kernels.dtype_code(q.dtype, allowed=(torch.bfloat16,))
            if any(t.data_ptr() % 16 for t in (q, k, v)):
                raise ValueError("flash_attention wgmma kernel needs 16-byte aligned q, k, v")
            fn = kernels.kernel_fn("flash_attention_wgmma_fwd", _WGMMA_ARGTYPES)
            rc = fn(*args, stream)
        else:
            fn = kernels.kernel_fn("flash_attention_fwd", _SIMT_ARGTYPES)
            rc = fn(*args, kernels.dtype_code(q.dtype), stream)
    kernels.check_launch(f"flash_attention ({variant})", rc)
    launches += 1
    launches_by_variant[variant] += 1
    return out
