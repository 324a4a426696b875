"""Plain PyTorch versions of the fused guided update family (port of
`repro.kernels.guided_update.ref`). Run on any device.

Each computes at the compute dtype `promote(w.dtype, float32)` (f32 for
f32/bf16 weights, f64 on the scan backend) with the reference's op order and
rounding points: `lam*g*g*(w - ws)` left to right, hypers as python floats
(`(1 - beta)` and `(1 - b1)` formed in python, then rounded to the compute
dtype by the multiply), adam's bias corrections from `t` at the compute
dtype. Weights come back in `w.dtype`, accumulators at the compute dtype.
"""
from __future__ import annotations

import torch


def _ct(w):
    return torch.promote_types(w.dtype, torch.float32)


def guided_sgd_update_ref(w, g, w_stale, lr, lam):
    ct = _ct(w)
    wc, gc, wsc = (a.to(ct) for a in (w, g, w_stale))
    gt = gc + lam * gc * gc * (wc - wsc)
    return (wc - lr * gt).to(w.dtype)


def guided_momentum_update_ref(w, g, w_stale, m, lr, lam, beta, *, nesterov: bool = False):
    ct = _ct(w)
    wc, gc, wsc, mc = (a.to(ct) for a in (w, g, w_stale, m))
    gt = gc + lam * gc * gc * (wc - wsc)
    m_new = beta * mc + gt
    if nesterov:
        upd = -(lr * (beta * m_new + gt))
    else:
        upd = -lr * m_new
    return (wc + upd).to(w.dtype), m_new


def guided_rmsprop_update_ref(w, g, w_stale, r, lr, lam, beta, eps):
    ct = _ct(w)
    wc, gc, wsc, rc = (a.to(ct) for a in (w, g, w_stale, r))
    gt = gc + lam * gc * gc * (wc - wsc)
    r_new = beta * rc + (1 - beta) * gt * gt
    return (wc - lr * gt / torch.sqrt(r_new + eps)).to(w.dtype), r_new


def guided_adam_update_ref(w, g, w_stale, m, v, t, lr, lam, b1, b2, eps):
    """`t` is the already-incremented step, like the kernel."""
    ct = _ct(w)
    wc, gc, wsc, mc, vc = (a.to(ct) for a in (w, g, w_stale, m, v))
    gt = gc + lam * gc * gc * (wc - wsc)
    m_new = b1 * mc + (1 - b1) * gt
    v_new = b2 * vc + (1 - b2) * torch.square(gt)
    tct = torch.as_tensor(t, device=w.device).to(ct)
    bc1 = 1 - b1 ** tct
    bc2 = 1 - b2 ** tct
    step = m_new / bc1 / (torch.sqrt(v_new / bc2) + eps)
    return (wc - lr * step).to(w.dtype), m_new, v_new
