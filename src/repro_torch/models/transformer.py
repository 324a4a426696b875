"""Model assembly (port of `repro.models.transformer`, dense archs).

API:
  model_init(gen, cfg, device)                        -> params (nested dict)
  init_caches(cfg, batch, total_len, device)          -> caches
  prefill(params, batch, cfg, total_len, prompt_lens, caches) -> (last logits, caches)
  decode_step(params, caches, tokens, t, cfg)         -> (logits, caches)

Layout is the reference's: layer parameters and caches are stacked on a
leading layer dim under `blocks["l0"]` / `caches["l0"]` (dense archs have a
period of one layer), and the stack runs as a Python loop over that dim in
place of `lax.scan`.

Caches are updated IN PLACE: `prefill` writes the caches it is given (or
fresh ones), `decode_step` writes slot `t mod S_c` of every row, and both
return the same tensors. Pass views of a larger pool (e.g. one batch row)
to prefill straight into it.

Not yet ported: MoE, Mamba (ssm/hybrid), xLSTM, audio/VLM frontends and the
int8 KV cache; those raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.module import stacked, tree_map


def check_ported(cfg) -> None:
    """Raise for any part of `cfg` whose path this port does not have yet."""
    missing = []
    if cfg.arch_type != "dense" or cfg.moe is not None or cfg.ssm is not None:
        missing.append(f"arch_type={cfg.arch_type!r}")
    if cfg.xlstm is not None:
        missing.append("xlstm")
    if cfg.audio_frontend or cfg.n_patches:
        missing.append("audio/vlm frontend")
    if cfg.kv_cache_dtype != "native":
        missing.append(f"kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not yet ported to repro_torch: "
                                  + ", ".join(missing))


def block_init(gen, cfg, device) -> dict:
    """One layer: {l0: {norm1, mixer, norm2, ffn}} (the reference's super-block)."""
    return {"l0": {
        "norm1": L.rmsnorm_init(cfg.d_model, device),
        "mixer": L.attn_init(gen, cfg, device),
        "norm2": L.rmsnorm_init(cfg.d_model, device),
        "ffn": L.ffn_init(gen, cfg, device),
    }}


def model_init(gen: Optional[torch.Generator], cfg, device="cuda") -> dict:
    """Random parameters drawn from `gen`, on `device`, which must be gen's
    device (`device="meta"` with gen=None gives shapes and dtypes only)."""
    check_ported(cfg)
    device = torch.device(device)
    if gen is not None and (gen.device.type != device.type or
                            device.index not in (None, gen.device.index)):
        raise ValueError(f"generator on {gen.device} cannot draw params on {device}")
    return {
        "final_norm": L.rmsnorm_init(cfg.d_model, device),
        "embed": L.embed_init(gen, cfg, device),
        "blocks": stacked(cfg.n_layers, lambda: block_init(gen, cfg, device)),
    }


# ------------------------------------------------------------------- caches


def cache_len_for(cfg, total_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, total_len)
    return total_len


def init_caches(cfg, batch: int, total_len: int, device) -> dict:
    """Zeroed native-dtype KV caches: {l0: {k, v}}, each (n_layers, batch, S_c, K, dh)."""
    check_ported(cfg)
    s_c = cache_len_for(cfg, total_len)
    shape = (cfg.n_layers, batch, s_c, cfg.n_kv_heads, cfg.d_head)
    return {"l0": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                   "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}


# ------------------------------------------------------------- block apply


def layer_apply(lp, x, cfg, rope, cache=None, slots=None):
    """One dense layer. `rope` is this pass's (cos, sin) tables. `cache`
    ({k, v} of this layer, (B, S_c, K, dh)) is written in place: at decode
    (`slots` = (rows, ring slot, cache_len) of the step) slot t mod S_c of
    each row; at prefill the last min(S, S_c) positions at slots
    arange(S-s_eff, S) mod S_c, with the rest zeroed. Returns x."""
    h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if slots is not None:
        B, S, _ = h.shape
        rows, slot, clen = slots
        q, k, v = L.qkv(lp["mixer"], h, cfg, rope)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        out = L.decode_attention(q, cache["k"], cache["v"], clen)
        att = out.reshape(B, S, -1) @ lp["mixer"]["wo"]
    else:
        att, (k, v) = L.attn_apply(lp["mixer"], h, cfg, rope=rope)
        if cache is not None:
            s_c = cache["k"].shape[1]
            S = k.shape[1]
            s_eff = min(S, s_c)  # window may truncate; cache may be larger
            ring = torch.remainder(torch.arange(S - s_eff, S, device=x.device), s_c)
            for name, new in (("k", k), ("v", v)):
                cache[name].zero_()
                cache[name][:, ring] = new[:, -s_eff:].to(cache[name].dtype)
    x = x + att
    h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + L.ffn_apply(lp["ffn"], h)


def block_apply(bp, x, cfg, rope, caches=None, slots=None):
    """One super-block: a dense arch's period is a single layer, "l0"."""
    return layer_apply(bp["l0"], x, cfg, rope, None if caches is None else caches["l0"], slots)


def _stack_apply(params, x, cfg, positions, caches=None, t=None):
    """The layer stack as a Python loop over the stacked leading dim. What
    every layer shares (RoPE tables, the decode step's ring slots) is built
    once, and the stacked leaves are split into per-layer views once."""
    rope = L.rope_tables(positions, cfg.d_head, cfg.rope_theta)
    slots = None
    if t is not None:
        s_c = caches["l0"]["k"].shape[2]
        rows = torch.arange(x.shape[0], device=x.device)
        slots = (rows, torch.remainder(t, s_c).long(), (t + 1).to(torch.int32))
    blocks = tree_map(lambda a: a.unbind(0), params["blocks"])
    layer_caches = None if caches is None else tree_map(lambda c: c.unbind(0), caches)
    for i in range(cfg.n_layers):
        bp = tree_map(lambda a, i=i: a[i], blocks)
        cache = None if caches is None else tree_map(lambda c, i=i: c[i], layer_caches)
        x = block_apply(bp, x, cfg, rope, cache, slots)
    return x


def _head(params, x, cfg):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_head(params["embed"], x)


def _embed(params, tokens, cfg):
    return L.embed_lookup(params["embed"], tokens).to(cfg.dtype)


@torch.no_grad()
def prefill(params, batch, cfg, total_len: int = 0, prompt_lens=None, caches=None):
    """Returns (last-position logits (B,V), caches). `batch["tokens"]` is
    (B,S) int. Caches are sized for max(total_len, S) unless given (then
    written in place). `prompt_lens` ((B,) host ints) gathers each row's logits at
    its last real position for right-padded prompts."""
    check_ported(cfg)
    if "patches" in batch:
        raise NotImplementedError("VLM patch embeddings are not yet ported")
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if caches is None:
        caches = init_caches(cfg, B, max(total_len, S), x.device)
    x = _stack_apply(params, x, cfg, positions, caches=caches)
    if prompt_lens is None:
        x_last = x[:, -1:]
    else:  # host ints: slicing needs no host->device copy
        x_last = torch.stack([x[b, min(max(int(n) - 1, 0), S - 1)]
                              for b, n in enumerate(prompt_lens)])[:, None]
    logits = _head(params, x_last, cfg)
    return logits[:, 0], caches


@torch.no_grad()
def decode_step(params, caches, tokens, t, cfg):
    """tokens: (B,1) int; t: (B,) int32 per-row positions (or a scalar shared
    by the batch). Writes the caches in place; returns (logits (B,V), caches)."""
    check_ported(cfg)
    x = _embed(params, tokens, cfg)
    B = x.shape[0]
    tv = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    if tv.ndim == 0:
        tv = tv.expand(B)
    x = _stack_apply(params, x, cfg, tv[:, None], caches=caches, t=tv)
    return _head(params, x, cfg)[:, 0], caches
