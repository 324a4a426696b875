"""Model assembly (port of `repro.models.transformer`: dense, hybrid and xLSTM archs).

API:
  model_init(gen, cfg, device)                        -> params (nested dict)
  forward_train(params, batch, cfg)                   -> (per_example_loss, aux, logits)
  init_caches(cfg, batch, total_len, device)          -> caches
  prefill(params, batch, cfg, total_len, prompt_lens, caches) -> (last logits, caches)
  decode_step(params, caches, tokens, t, cfg)         -> (logits, caches)

Layout is the reference's: a model is `n_super` super-blocks of `period`
layers (dense: 1 layer; jamba's hybrid: 8, attention at l4 and Mamba at the
others; xLSTM: 2, mLSTM then sLSTM, with no norm2 / ffn). Layer parameters
and caches live under `blocks["l{i}"]` / `caches["l{i}"]`, stacked on a
leading super-block dim, and the stack runs as a Python loop over that dim
in place of `lax.scan`. An attention layer's cache is {k, v}, a Mamba
layer's {conv, ssm}, an mLSTM layer's {conv, C, n, m} and an sLSTM layer's
{conv, h, c, n, m}.

Caches are updated IN PLACE: `prefill` writes the caches it is given (or
fresh ones) as the reference writes fresh caches: attention rows are zeroed,
Mamba layers start from zero states and xLSTM layers from their initial
states (m = -1e30, sLSTM's n = 1), whatever the given caches held.
`decode_step` writes slot `t mod S_c` of every attention row and the
recurrent states of every row; both return the same tensors. Pass views of a larger
pool (e.g. one batch row) to prefill straight into it.

The serve paths (`prefill`, `decode_step`) run under no_grad and ask for the
attention kernels explicitly (impl "pallas"); `forward_train` is
differentiable and attends with `cfg.attn_impl` ("xla" by default, as the
reference trains). With `cfg.remat == "full"` each super-block of the
training forward is checkpointed and recomputed in the backward, as the
reference's `jax.checkpoint` of its scan body.

With `cfg.kv_cache_dtype == "int8"` an attention layer's cache is {k, v}
int8 and {k_scale, v_scale} f32 (one scale per token and kv head,
`models.kvquant`): prefill attends with the full-precision k and v and
quantizes only what it writes into the ring; decode quantizes the token's k
and v into the ring, dequantizes the whole cache into a scratch of the
compute dtype, puts the token's exact k and v in its slot there, and runs
`flash_decode` on the scratch, as the reference does.

Not yet ported: MoE and the audio/VLM frontends; those raise
NotImplementedError (jamba is served with `moe=None`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import kvquant
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import xlstm as X
from repro_torch.models.module import stacked, tree_map


def check_ported(cfg) -> None:
    """Raise for any part of `cfg` whose path this port does not have yet."""
    missing = []
    if cfg.arch_type not in ("dense", "hybrid") and not (
            cfg.arch_type == "ssm" and cfg.xlstm is not None):
        missing.append(f"arch_type={cfg.arch_type!r}")
    if cfg.moe is not None:
        missing.append("MoE ffn (moe)")
    if cfg.audio_frontend or cfg.n_patches:
        missing.append("audio/vlm frontend")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not yet ported to repro_torch: "
                                  + ", ".join(missing))


# ----------------------------------------------------------- block structure


def period(cfg) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.attn_every
    if cfg.xlstm is not None:
        return len(cfg.xlstm.pattern)
    return 1


def n_super(cfg) -> int:
    p = period(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"the period {p}")
    return cfg.n_layers // p


def mixer_kind(cfg, i: int) -> str:
    """Kind of the i-th layer within a super-block: "attn", "mamba",
    "mlstm" or "slstm"."""
    if cfg.xlstm is not None:
        return "mlstm" if cfg.xlstm.pattern[i % len(cfg.xlstm.pattern)] else "slstm"
    if cfg.arch_type == "hybrid":
        return "attn" if cfg.layer_is_attn(i) else "mamba"
    return "attn"


def ffn_kind(cfg, i: int) -> Optional[str]:
    """None for xLSTM layers (they carry their own projections), else
    "dense" ("moe" is refused by check_ported)."""
    if cfg.xlstm is not None:
        return None
    return "moe" if cfg.layer_is_moe(i) else "dense"


def has_attention(cfg) -> bool:
    return any(mixer_kind(cfg, i) == "attn" for i in range(period(cfg)))


_MIXER_INIT = {"attn": L.attn_init, "mamba": M.mamba_init,
               "mlstm": X.mlstm_init, "slstm": X.slstm_init}


def block_init(gen, cfg, device) -> dict:
    """One super-block: {l0..l{P-1}}, each {norm1, mixer, norm2, ffn}, or
    {mixer} alone for an xLSTM layer (its block norms itself)."""
    out = {}
    for i in range(period(cfg)):
        mk = mixer_kind(cfg, i)
        lp = {}
        if mk in ("attn", "mamba"):
            lp["norm1"] = L.rmsnorm_init(cfg.d_model, device)
        lp["mixer"] = _MIXER_INIT[mk](gen, cfg, device)
        if ffn_kind(cfg, i) is not None:
            lp["norm2"] = L.rmsnorm_init(cfg.d_model, device)
            lp["ffn"] = L.ffn_init(gen, cfg, device)
        out[f"l{i}"] = lp
    return out


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
        "blocks": stacked(n_super(cfg), lambda: block_init(gen, cfg, device)),
    }


# ------------------------------------------------------------------- caches


def cache_len_for(cfg, total_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, total_len)
    return total_len


def layer_cache_init(cfg, i: int, batch: int, s_c: int, device) -> dict:
    """Fresh cache of layer i: attention {k, v} (batch, S_c, K, dh) zeros in
    the compute dtype, or int8 with {k_scale, v_scale} (batch, S_c, K) f32
    when cfg.kv_cache_dtype is "int8"; Mamba {conv (batch, dc-1, ed) in the
    compute dtype, ssm (batch, ed, n) f32} zeros; xLSTM its initial state
    (`xlstm.*_state_init`)."""
    mk = mixer_kind(cfg, i)
    if mk == "mlstm":
        conv, (C, n, m) = X.mlstm_state_init(cfg, batch, cfg.dtype, device)
        return {"conv": conv, "C": C, "n": n, "m": m}
    if mk == "slstm":
        conv, (h, c, n, m) = X.slstm_state_init(cfg, batch, cfg.dtype, device)
        return {"conv": conv, "h": h, "c": c, "n": n, "m": m}
    if mk == "attn":
        shape = (batch, s_c, cfg.n_kv_heads, cfg.d_head)
        if cfg.kv_cache_dtype == "int8":
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                    "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    conv, ssm = M.mamba_state_init(cfg, batch, cfg.dtype, device)
    return {"conv": conv, "ssm": ssm}


def init_caches(cfg, batch: int, total_len: int, device) -> dict:
    """Fresh caches {l0..l{P-1}}, each leaf stacked on a leading n_super dim."""
    check_ported(cfg)
    s_c = cache_len_for(cfg, total_len)
    ns = n_super(cfg)
    return {f"l{i}": tree_map(lambda c: c[None].repeat((ns,) + (1,) * c.ndim),
                              layer_cache_init(cfg, i, batch, s_c, device))
            for i in range(period(cfg))}


def _attn_cache_len(cfg, caches) -> int:
    """Ring size S_c, read from the first attention layer's cache."""
    for i in range(period(cfg)):
        if mixer_kind(cfg, i) == "attn":
            return caches[f"l{i}"]["k"].shape[2]
    raise ValueError(f"{cfg.name} has no attention layer")


# ------------------------------------------------------------- block apply


def _attn_layer(lp, h, cfg, rope, cache, slots, impl):
    """The attention mixer at prefill (slots None) or decode. `cache` ({k, v}
    of this layer, (B, S_c, K, dh), and {k_scale, v_scale} for an int8
    cache) is written in place: at decode (`slots` = (rows, ring slot,
    cache_len) of the step) slot t mod S_c of each row; at prefill the last
    min(S, S_c) positions at slots arange(S-s_eff, S) mod S_c, with the rest
    zeroed."""
    int8 = cache is not None and "k_scale" in cache
    if slots is not None:
        B, S, _ = h.shape
        rows, slot, clen = slots
        q, k, v = L.qkv(lp["mixer"], h, cfg, rope)
        if int8:
            full = {}
            for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
                cache[name][rows, slot], cache[f"{name}_scale"][rows, slot] = \
                    kvquant.quantize_kv(new)
                full[name] = kvquant.dequantize_kv(cache[name], cache[f"{name}_scale"], cfg.dtype)
                # this step attends to the token's exact k/v; the int8 copy
                # pays its quantization error from the next step on
                full[name][rows, slot] = new.to(cfg.dtype)
            k_att, v_att = full["k"], full["v"]
        else:
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            k_att, v_att = cache["k"], cache["v"]
        out = L.decode_attention(q, k_att, v_att, clen)
        return out.reshape(B, S, -1) @ lp["mixer"]["wo"]
    att, (k, v) = L.attn_apply(lp["mixer"], h, cfg, rope=rope, impl=impl)
    if cache is not None:
        s_c = cache["k"].shape[1]
        S = k.shape[1]
        s_eff = min(S, s_c)  # window may truncate; cache may be larger
        ring = torch.remainder(torch.arange(S - s_eff, S, device=h.device), s_c)
        for name, new in (("k", k), ("v", v)):
            new = new[:, -s_eff:]
            cache[name].zero_()
            if int8:  # attention above used the full-precision k/v
                new, scale = kvquant.quantize_kv(new)
                cache[f"{name}_scale"].zero_()
                cache[f"{name}_scale"][:, ring] = scale
            cache[name][:, ring] = new.to(cache[name].dtype)
    return att


def _mamba_layer(lp, h, cfg, cache, decode: bool):
    """The Mamba mixer. Prefill starts from zero states (the reference
    prefills into fresh caches), so a reused pool row never continues its
    last request; decode continues the row's states. `cache` ({conv, ssm}
    of this layer) is overwritten with the new states."""
    if decode:
        y, (conv, ssm) = M.mamba_decode(lp["mixer"], h, cfg, cache["conv"], cache["ssm"])
    else:
        y, (conv, ssm) = M.mamba_apply(lp["mixer"], h, cfg)
    if cache is not None:
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
    return y


_XLSTM = {"mlstm": (X.mlstm_apply, ("C", "n", "m")),
          "slstm": (X.slstm_apply, ("h", "c", "n", "m"))}


def _xlstm_layer(lp, x, cfg, kind, cache, decode: bool):
    """An mLSTM or sLSTM block (it norms its input and adds its residual).
    Prefill starts from the initial state (the reference prefills into fresh
    caches), so a reused pool row never continues its last request; decode
    continues the row's state. `cache` is overwritten with the new state."""
    apply, names = _XLSTM[kind]
    state = None
    if decode:
        state = (cache["conv"], tuple(cache[k] for k in names))
    x, (conv, inner) = apply(lp["mixer"], x, cfg, state)
    if cache is not None:
        cache["conv"].copy_(conv)
        for k, new in zip(names, inner):
            cache[k].copy_(new)
    return x


def layer_apply(lp, x, cfg, i, rope, cache, slots, impl):
    """Layer i of a super-block. `rope` is this pass's (cos, sin) tables;
    `slots` is None at prefill and in training, at decode the step's (rows,
    ring slot, cache_len), or () for a model with no attention layer; `impl`
    the full-sequence attention's. Returns x."""
    mk = mixer_kind(cfg, i)
    if mk in _XLSTM:
        return _xlstm_layer(lp, x, cfg, mk, cache, decode=slots is not None)
    h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if mk == "attn":
        x = x + _attn_layer(lp, h, cfg, rope, cache, slots, impl)
    else:
        x = x + _mamba_layer(lp, h, cfg, cache, decode=slots is not None)
    if ffn_kind(cfg, i) is None:
        return x
    h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + L.ffn_apply(lp["ffn"], h)


def block_apply(bp, x, cfg, rope, caches, slots, impl):
    """One super-block: its `period` layers in order."""
    for i in range(period(cfg)):
        x = layer_apply(bp[f"l{i}"], x, cfg, i, rope,
                        None if caches is None else caches[f"l{i}"], slots, impl)
    return x


def _stack_apply(params, x, cfg, positions, *, impl, caches=None, t=None, remat=False):
    """The stack as a Python loop over the stacked super-block dim. What
    every layer shares (RoPE tables, the decode step's ring slots) is built
    once, and the stacked leaves are split into per-block views once
    (`unbind`, whose backward stacks each leaf's gradient once). `remat`
    checkpoints each super-block (training only). A model with no attention
    layer builds no RoPE tables and no ring slots."""
    attn = has_attention(cfg)
    rope = L.rope_tables(positions, cfg.d_head, cfg.rope_theta) if attn else None
    slots = None
    if t is not None and not attn:
        slots = ()
    elif t is not None:
        s_c = _attn_cache_len(cfg, caches)
        rows = torch.arange(x.shape[0], device=x.device)
        slots = (rows, torch.remainder(t, s_c).long(), (t + 1).to(torch.int32))
    blocks = tree_map(lambda a: a.unbind(0), params["blocks"])
    block_caches = None if caches is None else tree_map(lambda c: c.unbind(0), caches)
    for j in range(n_super(cfg)):
        bp = tree_map(lambda a, j=j: a[j], blocks)
        cache = None if caches is None else tree_map(lambda c, j=j: c[j], block_caches)
        if remat:
            x = checkpoint(block_apply, bp, x, cfg, rope, cache, slots, impl,
                           use_reentrant=False)
        else:
            x = block_apply(bp, x, cfg, rope, cache, slots, impl)
    return x


def _head(params, x, cfg):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_head(params["embed"], x)


def _embed(params, tokens, cfg):
    return L.embed_lookup(params["embed"], tokens).to(cfg.dtype)


def _embed_inputs(params, batch, cfg):
    """Token embeddings of `batch["tokens"]` in the compute dtype (the audio
    and VLM frontends of the reference are not ported: check_ported)."""
    if "patches" in batch:
        raise NotImplementedError("VLM patch embeddings are not yet ported")
    return _embed(params, batch["tokens"], cfg)


def forward_train(params, batch, cfg):
    """Returns (per_example_loss (B,) f32, aux (), logits (B,S,V)): the
    differentiable full-sequence pass the mesh trainer takes gradients of.
    `batch` holds "tokens" and "labels" (B,S) and optionally "mask". aux is
    the MoE router loss of the reference, zero for the ported archs."""
    check_ported(cfg)
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = _stack_apply(params, x, cfg, positions, impl=cfg.attn_impl,
                     remat=cfg.remat == "full")
    logits = _head(params, x, cfg)
    per_ex = L.per_example_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return per_ex, torch.zeros((), dtype=torch.float32, device=x.device), logits


@torch.no_grad()
def prefill(params, batch, cfg, total_len: int = 0, prompt_lens=None, caches=None):
    """Returns (last-position logits (B,V), caches). `batch["tokens"]` is
    (B,S) int. Caches are sized for max(total_len, S) unless given (then
    written in place). `prompt_lens` ((B,) host ints) gathers each row's logits at
    its last real position for right-padded prompts."""
    check_ported(cfg)
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if caches is None:
        caches = init_caches(cfg, B, max(total_len, S), x.device)
    x = _stack_apply(params, x, cfg, positions, caches=caches, impl="pallas")
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
    x = _stack_apply(params, x, cfg, tv[:, None], caches=caches, t=tv, impl="pallas")
    return _head(params, x, cfg)[:, 0], caches
