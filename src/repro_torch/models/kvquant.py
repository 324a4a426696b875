"""int8 KV-cache quantization (port of `repro.models.kvquant`).

Per-(token, kv-head) absmax quantization: k (B,S,K,dh) -> int8 values and one
f32 scale per (B,S,K), a scale floor of 1e-8, round half to even, clipped to
±127. An int8 attention cache takes 0.52x the bytes of a bf16 one at d_head
128. Plain torch, as the reference's is plain XLA (no Pallas kernel): the
decode step dequantizes the whole cache into a scratch of the compute dtype
and attends over it with `flash_decode`.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """x: (..., dh) float -> (int8 values (..., dh), f32 scales (...))."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of quantize_kv, in `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)
