"""Public wrapper of the flash decode kernel (csrc/flash_decode.cu).

CUDA tensors launch the kernel (or raise); CPU tensors run `decode_ref`.
`launches` counts kernel launches (one per call: the kernel merges its
splits itself), and only those.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_decode.ref import decode_ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
HEAD_DIMS = (32, 64, 128)  # the instantiations in csrc/flash_decode.cu
CHUNK = 8                  # query heads one CTA serves; G = H/K > 8 takes ceil(G/8) chunks
TILE = 64                  # cache slots per ring stage of the kernel
CTAS_PER_SM = 2            # B*K*chunks*n_split ~ this many CTAs an SM: the bf16 kernel fits two,
                           # so the grid is one wave (each CTA pays a fence and an atomic)

launches = 0
_COUNTERS = {}             # (device, stream, B*K*chunks) -> int32 zeros the kernel leaves zero


def n_chunks(H: int, K: int) -> int:
    """Head chunks per kv head: the grid's CTAs for one (split, kv head, b)."""
    return -(-(H // K) // CHUNK)


def n_splits(B: int, K: int, S: int, sms: int, chunks: int = 1) -> int:
    """Splits per (b, kv head, chunk), from the pool capacity S and the card
    alone: enough CTAs to fill the card, no more splits than S has tiles. Each
    CTA takes its share of min(cache_len[b], S) on the device."""
    want = -(-CTAS_PER_SM * sms // (B * K * chunks))
    return max(1, min(want, -(-S // TILE)))


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's per-(b, kv head, chunk) arrival counters: zeroed once when first
    allocated, then reset by the kernel itself. One buffer per device, stream
    and B*K*chunks, so launches that may run at the same time never share one."""
    key = (device, stream, n)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _check(q, k_cache, v_cache, cache_len):
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,1,H,dh), caches (B,S,K,dh); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, dh = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != dh or H % k_cache.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches {tuple(k_cache.shape)}")
    if cache_len.shape != (B,):
        raise ValueError(f"cache_len must be ({B},), got {tuple(cache_len.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def flash_decode(q, k_cache, v_cache, cache_len):
    """q: (B,1,H,dh); caches: (B,S,K,dh); cache_len (B,) -> (B,1,H,dh) in
    q.dtype. Slot j is valid iff j < min(cache_len[b], S). Any S, any H/K."""
    global launches
    _check(q, k_cache, v_cache, cache_len)
    if not kernels.use_kernel(q, k_cache, v_cache, cache_len):
        return decode_ref(q, k_cache, v_cache, cache_len).to(q.dtype)
    kernels.refuse_autograd("flash_decode", q, k_cache, v_cache)
    B, _, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be int32, got {cache_len.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes d_head in {HEAD_DIMS}; got {dh}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, cache_len)):
        raise ValueError("flash_decode kernel needs contiguous q, caches and cache_len")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode kernel needs 16-byte aligned q and caches")
    code = kernels.dtype_code(q.dtype)
    nc = n_chunks(H, K)
    ns = n_splits(B, K, S, kernels.sm_count(q.device), nc)
    part_num = torch.empty((B, H, ns, dh), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, ns, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, B * K * nc)
    with torch.cuda.device(q.device):
        fn = kernels.kernel_fn("flash_decode_fwd", _ARGTYPES)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
                part_num.data_ptr(), part_ml.data_ptr(), counters.data_ptr(), out.data_ptr(),
                B, S, H, K, dh, ns, 1.0 / math.sqrt(dh), code, stream)
    kernels.check_launch("flash_decode", rc)
    launches += 1
    return out
