"""Mamba-1 selective SSM block (port of `repro.models.mamba`), as jamba's
mamba mixer uses it.

Prefill (`mamba_apply`) runs the scan through `kernels.selective_scan`: the
hand-written CUDA kernel on CUDA tensors (the reference's `impl="pallas"`
branch), its plain version on CPU tensors. A decode step (`mamba_decode`) is
the reference's inline one-step recurrence (its `impl="xla"` branch) and
launches no kernel.

Parameter keys, shapes and dtypes are the reference's: `A_log`, `dt_bias`
and `D` are f32, the other weights `param_dtype`. States: the conv state
(B, d_conv-1, ed) is kept in `cfg.dtype`, the SSM state (B, ed, n) in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.module import normal


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or int(math.ceil(cfg.d_model / 16))


def mamba_init(gen, cfg, device) -> dict:
    d = cfg.d_model
    ed = cfg.ssm.expand * d
    n = cfg.ssm.d_state
    r = _dt_rank(cfg)
    dc = cfg.ssm.d_conv
    dt = cfg.param_torch_dtype
    f32 = torch.float32
    A = torch.arange(1, n + 1, dtype=f32, device=device).repeat(ed, 1)
    return {
        "in_proj": normal(gen, (d, 2 * ed), 1 / math.sqrt(d), dt, device),
        "conv_w": normal(gen, (dc, ed), 1 / math.sqrt(dc), dt, device),
        "conv_b": torch.zeros((ed,), dtype=dt, device=device),
        "x_proj": normal(gen, (ed, r + 2 * n), 1 / math.sqrt(ed), dt, device),
        "dt_proj": normal(gen, (r, ed), 1 / math.sqrt(r), dt, device),
        "dt_bias": torch.log(torch.expm1(torch.full((ed,), 0.01, dtype=f32, device=device))),
        "A_log": torch.log(A),
        "D": torch.ones((ed,), dtype=f32, device=device),
        "out_proj": normal(gen, (ed, d), 1 / math.sqrt(ed), dt, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over time. x: (B,S,ed), w: (dc,ed); conv_state:
    (B, dc-1, ed) trailing inputs of the previous segment (zeros if None).
    Returns (out, new conv_state), both in x's dtype."""
    dc = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+dc-1, ed)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]          # the reference's order: tap 0 first, bias last
    for i in range(1, dc):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(dc - 1):]


def _ssm_inputs(p, x, cfg, conv_state):
    """The projections shared by prefill and decode. x: (B,S,d) ->
    (xconv, z, dt (f32), A, Bc, Cc, new conv state)."""
    n, r = cfg.ssm.d_state, _dt_rank(cfg)
    x1, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xconv, new_conv = _causal_conv(x1, p["conv_w"], p["conv_b"], conv_state)
    xconv = F.silu(xconv)
    dt_in, Bc, Cc = torch.split(xconv @ p["x_proj"], [r, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"]).float()  # (B,S,ed)
    A = -torch.exp(p["A_log"])  # (ed, n)
    return xconv, z, dt, A, Bc, Cc, new_conv


def _out(p, x, ys, xconv, z):
    y = ys.to(x.dtype) + xconv * p["D"].to(x.dtype)
    return (y * F.silu(z)) @ p["out_proj"]


def mamba_apply(p, x, cfg, conv_state=None, ssm_state=None):
    """Full-sequence form. x: (B,S,d), any S >= 1. Returns (y,
    (conv_state, ssm_state)); states None start from zeros."""
    xconv, z, dt, A, Bc, Cc, new_conv = _ssm_inputs(p, x, cfg, conv_state)
    ys, new_ssm = selective_scan(xconv.float().contiguous(), dt.contiguous(), A.contiguous(),
                                 Bc.float().contiguous(), Cc.float().contiguous(), h0=ssm_state)
    return _out(p, x, ys, xconv, z), (new_conv, new_ssm)


def mamba_decode(p, x, cfg, conv_state, ssm_state):
    """Single-token step. x: (B,1,d); states as returned by mamba_apply (the
    SSM state f32). The recurrence is inline, as the reference's XLA step."""
    xconv, z, dt, A, Bc, Cc, new_conv = _ssm_inputs(p, x, cfg, conv_state)
    dt_t, x_t = dt[:, 0], xconv[:, 0].float()                     # (B, ed)
    dA = torch.exp(dt_t[:, :, None] * A)
    h = dA * ssm_state + (dt_t * x_t)[:, :, None] * Bc[:, 0, None, :].float()
    y_t = torch.sum(h * Cc[:, 0, None, :].float(), dim=-1)
    return _out(p, x, y_t[:, None], xconv, z), (new_conv, h)


def mamba_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    """Zeroed (conv state (B, dc-1, ed) in `dtype`, SSM state (B, ed, n) f32)."""
    ed = cfg.ssm.expand * cfg.d_model
    return (torch.zeros((batch, cfg.ssm.d_conv - 1, ed), dtype=dtype, device=device),
            torch.zeros((batch, ed, cfg.ssm.d_state), dtype=torch.float32, device=device))
