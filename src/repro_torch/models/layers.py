"""Core layers (port of `repro.models.layers`, the dense serving path):
RMSNorm, RoPE, GQA attention (prefill and decode), SwiGLU/GELU FFN,
embedding and logits head.

Attention goes through the kernels' wrappers: on CUDA tensors the
hand-written flash_attention / flash_decode kernels run, on CPU tensors
their plain versions. Layouts are the reference's: (B, S, H, dh) heads,
`wi` of a gated FFN as (d, 2, f) with gate at index 0 and up at index 1.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models.module import dense_param, normal

# ------------------------------------------------------------------- norms


def rmsnorm_init(d: int, device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x, scale, eps: float = 1e-5):
    """Statistics in f32, cast to x's dtype, then scaled in that dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# -------------------------------------------------------------------- rope


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once: a pageable host->device copy blocks the host
    # until the stream drains, which would serialize every layer's launches
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def rope_tables(positions, d_head: int, theta: float):
    """(cos, sin) of the RoPE angles, (..., S, 1, d_head/2) in f32. They depend
    only on the positions, so a forward pass builds them once for all layers."""
    freqs = _rope_freqs_on(d_head, float(theta), positions.device)
    angles = positions.float()[..., None] * freqs  # (..., S, d/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x, rope):
    """Rotate-half on split halves, in f32, cast back to x's dtype."""
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, d_head); positions: (..., S) int."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------- attention


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Grouped-query self-attention. q: (B,S,H,dh); k, v: (B,S,K,dh) ->
    (B,S,H,dh). window > 0 is exact sliding-window attention."""
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token attention against a ring-buffer KV cache. q: (B,1,H,dh);
    caches: (B,S_c,K,dh); cache_len (B,) int32. Slot j is valid iff
    j < min(cache_len, S_c); RoPE is applied by the caller."""
    return flash_decode(q, k_cache, v_cache, cache_len)


# ---------------------------------------------------------------- attention block


def attn_init(gen, cfg, device) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.param_torch_dtype
    return {
        "wq": dense_param(gen, d, H * dh, dt, device),
        "wk": dense_param(gen, d, K * dh, dt, device),
        "wv": dense_param(gen, d, K * dh, dt, device),
        "wo": dense_param(gen, H * dh, d, dt, device),
    }


def qkv(p, x, cfg, rope):
    """Projections plus RoPE (`rope` = rope_tables of the positions):
    (q (B,S,H,dh), k (B,S,K,dh), v (B,S,K,dh))."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, K, dh)
    v = (x @ p["wv"]).reshape(B, S, K, dh)
    return rotate(q, rope), rotate(k, rope), v


def attn_apply(p, x, cfg, *, rope):
    """Prefill attention block. Returns (out, (k, v)): this call's post-RoPE
    K/V entries, which the caller writes into its caches."""
    B, S, _ = x.shape
    q, k, v = qkv(p, x, cfg, rope)
    out = attention(q, k, v, causal=cfg.causal,
                    window=cfg.sliding_window if cfg.causal else 0)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


# ----------------------------------------------------------------------- ffn


def ffn_init(gen, cfg, device, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = cfg.param_torch_dtype
    if not cfg.mlp_gated:  # non-gated GELU MLP
        return {"wi": dense_param(gen, d, f, dt, device), "wo": dense_param(gen, f, d, dt, device)}
    return {"wi": dense_param(gen, d, (2, f), dt, device), "wo": dense_param(gen, f, d, dt, device)}


def ffn_apply(p, x):
    wi = p["wi"]
    if wi.ndim == 2:  # GELU MLP (the reference's jax.nn.gelu is the tanh form)
        return F.gelu(x @ wi, approximate="tanh") @ p["wo"]
    d, _, f = wi.shape
    h = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
    return (F.silu(h[..., 0, :]) * h[..., 1, :]) @ p["wo"]


# ----------------------------------------------------------- embedding / head


def embed_init(gen, cfg, device) -> dict:
    dt = cfg.param_torch_dtype
    V, d = cfg.vocab_size, cfg.d_model
    out = {"table": normal(gen, (V, d), 0.02, dt, device)}
    if not cfg.tie_embeddings:
        out["head"] = dense_param(gen, d, V, dt, device)
    return out


def embed_lookup(p, tokens):
    return F.embedding(tokens, p["table"])


def logits_head(p, x):
    if "head" in p:
        return x @ p["head"]
    return x @ p["table"].T
