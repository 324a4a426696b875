"""Plain PyTorch version of selective_scan (port of the reference's
`selective_scan_ref`): the sequential recurrence in f32, a Python loop over
time. Runs on any device."""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, A, Bc, Cc, h0=None):
    """x, dt: (B,S,ed), S >= 1; A: (ed,n); Bc, Cc: (B,S,n); h0: (B,ed,n)
    or None (zeros). Returns (y (B,S,ed), h_final (B,ed,n)), both f32:

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
        y_t = sum_n h_t * C_t
    """
    B, S, ed = x.shape
    n = A.shape[1]
    x, dt, A, Bc, Cc = (a.float() for a in (x, dt, A, Bc, Cc))
    h = (torch.zeros((B, ed, n), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[:, :, None] * A)
        h = dA * h + (dt_t * x[:, t])[:, :, None] * Bc[:, t, None, :]
        ys.append(torch.sum(h * Cc[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1), h
