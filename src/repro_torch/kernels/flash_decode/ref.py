"""Plain PyTorch version of flash_decode (port of `decode_ref`). Runs on any
device. Note: a row with no valid slot gives the mean of V here (uniform
softmax), where the kernel gives 0; the serve path never has one (clen >= 1)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, cache_len):
    """q: (B,1,H,dh); caches: (B,S,K,dh); cache_len: (B,) -> (B,1,H,dh) float32."""
    B, _, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q[:, 0].reshape(B, K, G, dh).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(dh)
    lens = torch.clamp(cache_len.to(torch.int64), max=S)
    valid = torch.arange(S, device=q.device)[None] < lens[:, None]
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, dh)
