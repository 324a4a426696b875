"""Core layers (port of `repro.models.layers`): RMSNorm, RoPE, GQA
attention (prefill, decode and training), SwiGLU/GELU FFN, embedding,
logits head and the cross-entropy losses.

Attention dispatches on `impl`, as the reference does on `cfg.attn_impl`:
"pallas" goes through the flash_attention kernel's wrapper (the hand-written
kernel on CUDA tensors, its plain version on CPU tensors; no backward);
"xla" and "xla_chunked" are the reference's XLA formulations in plain torch
ops, which autograd differentiates. The serve paths ask for "pallas" (and
decode always runs flash_decode); training uses `cfg.attn_impl`, "xla" by
default, as the reference trains. Layouts are the reference's: (B, S, H, dh)
heads, `wi` of a gated FFN as (d, 2, f) with gate at index 0 and up at index 1.
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


NEG_INF = -1e30


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,K,G,dh), k/v: (B,Skv,K,dh), mask broadcastable to
    (B,K,G,Sq,Skv). Scores in f32 (the reference's preferred_element_type),
    probabilities cast to v's dtype for the second product."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _full_attention_xla(q, k, v, *, causal: bool, scale):
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        qi = torch.arange(Sq, device=q.device)
        kj = torch.arange(Skv, device=q.device)
        mask = (qi[:, None] >= kj[None, :])[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    return _sdpa(q, k, v, mask, scale)


def _swa_blocked_xla(q, k, v, *, window: int, scale):
    """Exact sliding-window causal attention, computed block-locally: each
    query block of size W attends only to itself and the previous block."""
    B, S, K, G, dh = q.shape
    W = window
    if S % W:
        raise ValueError(f"blocked sliding-window attention needs S % W == 0, got {S}, {W}")
    nb = S // W
    qb = q.reshape(B, nb, W, K, G, dh)
    kb = k.reshape(B, nb, W, K, dh)
    vb = v.reshape(B, nb, W, K, dh)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (B, nb, 2W, K, dh)
    v2 = torch.cat([v_prev, vb], dim=2)

    i = torch.arange(W, device=q.device)[:, None]
    j = torch.arange(2 * W, device=q.device)[None, :]
    # key j < W is the previous block (valid iff j > i), j >= W the current
    # one (valid iff j - W <= i); the first block has no previous one
    mask = torch.where(j < W, j > i, (j - W) <= i)
    first = torch.where(j < W, torch.zeros_like(mask), (j - W) <= i)
    full = mask.expand(nb, W, 2 * W).clone()
    full[0] = first
    full = full[None, :, None, None, :, :]  # (1, nb, 1, 1, W, 2W)

    logits = torch.einsum("bnqkgd,bnskd->bnkgqs", qb.float(), k2.float()) * scale
    logits = torch.where(full, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", probs, v2)
    return out.reshape(B, S, K, G, dh)


def _chunked_attention_xla(qg, k, v, *, causal: bool, scale, chunk: int = 1024):
    """Flash-style online-softmax attention as a loop over KV chunks: never
    holds the (Sq, Skv) score matrix, the working set is O(Sq * chunk)."""
    B, Sq, K, G, dh = qg.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    if Skv % chunk:
        raise ValueError(f"chunked attention needs Skv % chunk == 0, got {Skv}, {chunk}")
    qf = qg.float()
    rows = torch.arange(Sq, device=qg.device)[:, None]
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, K, G, Sq, dh), dtype=torch.float32, device=qg.device)
    for j in range(Skv // chunk):
        kc, vc = k[:, j * chunk:(j + 1) * chunk], v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float()) * scale
        if causal:
            cols = j * chunk + torch.arange(chunk, device=qg.device)[None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(rows >= cols, p, 0.0)
        alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)  # (B,Sq,K,G,dh)


def attention(q, k, v, *, causal: bool = True, window: int = 0, impl: str = "xla"):
    """Grouped-query self-attention. q: (B,S,H,dh); k, v: (B,S,K,dh) ->
    (B,S,H,dh). window > 0 is exact sliding-window causal attention. `impl`
    is the reference's: "pallas" (the flash_attention kernel), "xla"
    (einsums; blocked where the window makes that exact) or "xla_chunked"."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl not in ("xla", "xla_chunked"):
        raise ValueError(f"unknown attn_impl {impl!r}; known: xla, xla_chunked, pallas")
    scale = 1.0 / np.sqrt(dh)
    qg = q.reshape(B, Sq, K, H // K, dh)
    if impl == "xla_chunked" and not window and Sq == k.shape[1]:
        out = _chunked_attention_xla(qg, k, v, causal=causal, scale=scale)
    elif window and causal and Sq == k.shape[1] and Sq > 2 * window and Sq % window == 0:
        out = _swa_blocked_xla(qg, k, v, window=window, scale=scale)
    elif window and causal and Sq == k.shape[1]:
        # short sequence against the window: masked full attention
        i = torch.arange(Sq, device=q.device)
        m = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        out = _sdpa(qg, k, v, m[None, None, None], scale)
    else:
        out = _full_attention_xla(qg, k, v, causal=causal, scale=scale)
    return out.reshape(B, Sq, H, dh)


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


def attn_apply(p, x, cfg, *, rope, impl: str):
    """Full-sequence attention block (prefill or training). Returns (out,
    (k, v)): this call's post-RoPE K/V entries, which prefill writes into
    its caches."""
    B, S, _ = x.shape
    q, k, v = qkv(p, x, cfg, rope)
    out = attention(q, k, v, causal=cfg.causal,
                    window=cfg.sliding_window if cfg.causal else 0, impl=impl)
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


# ------------------------------------------------------------------- losses


def _nll(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - true


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits (B,S,V), labels (B,S) int."""
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def per_example_cross_entropy(logits, labels, mask=None):
    """(B,) mean CE per example — feeds the guided consistency statistics."""
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll, dim=-1)
    mask = mask.float()
    return torch.sum(nll * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
