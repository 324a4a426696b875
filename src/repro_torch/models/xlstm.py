"""xLSTM blocks (port of `repro.models.xlstm`; Beck et al. 2024,
arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar memory,
exponential gating, recurrent mixing).

Both run their exact stabilised recurrences in f32, as a Python loop over
time steps in place of the reference's `lax.scan`. No TPU kernel runs on
this path. A chunkwise-parallel mLSTM would be later performance work, held
against this recurrence.

Parameter keys, shapes and dtypes are the reference's: `w_if`, `b_if`,
`r_gates` and `b_gates` are f32 inside a `param_dtype` model. States: the
conv state (B, 3, width) in the compute dtype; mLSTM's (C, n, m) and
sLSTM's (h, c, n, m) in f32, starting from m = -1e30 and sLSTM's n = 1
(`*_state_init`), not from zeros.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.models.mamba import _causal_conv
from repro_torch.models.module import normal

M_INIT = -1e30   # the stabiliser m before the first step


def _dense(gen, di: int, do, dtype, device) -> torch.Tensor:
    shape = (di,) + ((do,) if isinstance(do, int) else tuple(do))
    return normal(gen, shape, 1.0 / math.sqrt(di), dtype, device)


# ------------------------------------------------------------------ mLSTM


def _mlstm_dims(cfg):
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_init(gen, cfg, device) -> dict:
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    dt, f32 = cfg.param_torch_dtype, torch.float32
    return {
        "norm": rmsnorm_init(d, device),
        "w_up": _dense(gen, d, di, dt, device),
        "w_gate": _dense(gen, d, di, dt, device),
        "conv_w": normal(gen, (4, di), 0.5, dt, device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "wq": _dense(gen, di, di, dt, device),
        "wk": _dense(gen, di, di, dt, device),
        "wv": _dense(gen, di, di, dt, device),
        "w_if": _dense(gen, d, 2 * nh, f32, device),
        "b_if": torch.cat([torch.zeros((nh,), dtype=f32, device=device),
                           torch.full((nh,), 3.0, dtype=f32, device=device)]),
        "out_norm": rmsnorm_init(di, device),
        "w_down": _dense(gen, di, d, dt, device),
    }


def _mlstm_scan(q, k, v, log_i, log_f, state):
    """q, k, v: (B,S,nh,dh); log_i, log_f: (B,S,nh); state (C, n, m) or None.
    Returns h (B,S,nh,dh) f32 and the new state."""
    B, S, nh, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    if state is None:
        C, n, m = mlstm_inner_init(B, nh, dh, q.device)
    else:
        C, n, m = state
    # q is scaled step by step in the reference; scaling all steps at once
    # gives the same values with one launch
    qs_all, k, v = q.float() * scale, k.float(), v.float()
    log_i, log_f = log_i.float(), log_f.float()
    hs = []
    for s in range(S):
        qs, k_t, v_t, li_t, lf_t = qs_all[:, s], k[:, s], v[:, s], log_i[:, s], log_f[:, s]
        lfm = lf_t + m
        m_new = torch.maximum(lfm, li_t)
        i_p = torch.exp(li_t - m_new)
        f_p = torch.exp(lfm - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (v_t[..., :, None] * k_t[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * k_t
        num = (C @ qs[..., None])[..., 0]                      # (B,nh,dh_v)
        den = torch.maximum(torch.linalg.vecdot(n, qs).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_apply(p, x, cfg, state=None):
    """x: (B,S,d); state (conv_state, (C, n, m)) or None (the initial state).
    Returns (x + y, (conv_state, (C, n, m)))."""
    B, S, d = x.shape
    nh = cfg.n_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    a = xn @ p["w_up"]
    g = xn @ p["w_gate"]
    conv_state = state[0] if state is not None else None
    ac, new_conv = _causal_conv(a, p["conv_w"], p["conv_b"], conv_state)
    ac = F.silu(ac)
    di = a.shape[-1]
    dh = di // nh
    q = (ac @ p["wq"]).reshape(B, S, nh, dh)
    k = ((ac @ p["wk"]) / math.sqrt(dh)).reshape(B, S, nh, dh)
    v = (a @ p["wv"]).reshape(B, S, nh, dh)
    gates = xn.float() @ p["w_if"] + p["b_if"]
    log_i = gates[..., :nh]
    log_f = F.logsigmoid(gates[..., nh:])
    inner = state[1] if state is not None else None
    h, new_inner = _mlstm_scan(q, k, v, log_i, log_f, inner)
    h = h.reshape(B, S, di).to(x.dtype)
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    y = (h * F.silu(g)) @ p["w_down"]
    return x + y, (new_conv, new_inner)


def mlstm_inner_init(batch: int, nh: int, dh: int, device):
    f32 = torch.float32
    return (torch.zeros((batch, nh, dh, dh), dtype=f32, device=device),
            torch.zeros((batch, nh, dh), dtype=f32, device=device),
            torch.full((batch, nh), M_INIT, dtype=f32, device=device))


def mlstm_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    di, nh, dh = _mlstm_dims(cfg)
    return (torch.zeros((batch, 3, di), dtype=dtype, device=device),
            mlstm_inner_init(batch, nh, dh, device))


# ------------------------------------------------------------------ sLSTM


def slstm_init(gen, cfg, device) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    f = int(cfg.xlstm.slstm_proj_factor * d)
    dt, f32 = cfg.param_torch_dtype, torch.float32
    b_gates = torch.zeros((4, d), dtype=f32, device=device)
    b_gates[1] = 3.0
    return {
        "norm": rmsnorm_init(d, device),
        "conv_w": normal(gen, (4, d), 0.5, dt, device),
        "conv_b": torch.zeros((d,), dtype=dt, device=device),
        "w_gates": _dense(gen, d, 4 * d, dt, device),  # i, f, z, o stacked
        "r_gates": normal(gen, (4, nh, dh, dh), 1.0 / math.sqrt(dh), f32, device),
        "b_gates": b_gates,
        "out_norm": rmsnorm_init(d, device),
        "w_ff": _dense(gen, d, (2, f), dt, device),
        "w_ff_out": _dense(gen, f, d, dt, device),
    }


def _slstm_scan(wx, r, state):
    """wx: (B,S,4,nh,dh) input contributions (f32); r: (4,nh,dh,dh); state
    (h, c, n, m), each (B,nh,dh), or None. Returns h (B,S,nh,dh), new state."""
    B, S, _, nh, dh = wx.shape
    if state is None:
        state = slstm_inner_init(B, nh, dh, wx.device)
    h, c, n, m = state
    hs = []
    for s in range(S):
        rec = torch.einsum("ghkd,bhd->bghk", r, h)  # (B,4,nh,dh)
        pre = wx[:, s] + rec
        li = pre[:, 0]
        lf = F.logsigmoid(pre[:, 1])
        z_t = torch.tanh(pre[:, 2])
        o_t = torch.sigmoid(pre[:, 3])
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.exp(lfm - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def slstm_apply(p, x, cfg, state=None):
    """x: (B,S,d); state (conv_state, (h, c, n, m)) or None (the initial
    state). Returns (x + y, (conv_state, (h, c, n, m)))."""
    B, S, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    conv_state = state[0] if state is not None else None
    xc, new_conv = _causal_conv(xn, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    wx = (xc @ p["w_gates"]).float() + p["b_gates"].float().reshape(1, 1, 4 * d)
    wx = wx.reshape(B, S, 4, nh, dh)
    inner = state[1] if state is not None else None
    h, new_inner = _slstm_scan(wx, p["r_gates"], inner)
    h = h.reshape(B, S, d).to(x.dtype)
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    hf = torch.einsum("bsd,dtf->bstf", h, p["w_ff"])
    y = (F.silu(hf[..., 0, :]) * hf[..., 1, :]) @ p["w_ff_out"]
    return x + y, (new_conv, new_inner)


def slstm_inner_init(batch: int, nh: int, dh: int, device):
    z = torch.zeros((batch, nh, dh), dtype=torch.float32, device=device)
    return (z, z.clone(), z + 1.0, z + M_INIT)


def slstm_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    nh = cfg.n_heads
    return (torch.zeros((batch, 3, d), dtype=dtype, device=device),
            slstm_inner_init(batch, nh, d // nh, device))
