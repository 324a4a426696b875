"""Plain PyTorch version of flash_attention (port of `attention_ref`):
GQA, causal, sliding-window, float32 math. Runs on any device."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,dh); k,v: (B,S,K,dh) -> (B,S,H,dh) float32."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window:
        mask &= (qi - kj) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, dh)
