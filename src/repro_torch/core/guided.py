"""Guided delay-compensated parallel SGD: the configuration and the pieces
of `repro.core.guided` that the scan backend reaches.

`GuidedConfig` is a copy of the reference's dataclass (the strategies read
it); `GuidedState` is the state record the strategy hooks take;
`compensate_dc_asgd` is DC-ASGD's Taylor compensation
g~ = g + lambda * g ⊙ g ⊙ (W_t - w_stale) (Zheng et al. 2017).

The mesh trainer's bookkeeping (`update_scores`, `correction_weights`,
`advance`, `refresh_stale`, `core/consistency.py`) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

MODES = ("seq", "ssgd", "asgd", "dc_asgd")


@dataclasses.dataclass(frozen=True)
class GuidedConfig:
    mode: str = "ssgd"            # seq | ssgd | asgd | dc_asgd
    guided: bool = True           # the paper's g- prefix
    rho: int = 10                 # delay tolerance / correction period (paper: 10)
    max_consistent: int = 4       # paper: replay at most 4 mini-batches
    staleness: int = 0            # asgd/dc_asgd: w_stale refresh period (0 -> rho)
    dc_lambda: float = 0.04       # DC-ASGD Taylor coefficient
    correction: str = "fused"     # fused | two_pass
    correction_scale: float = 1.0
    magnitude_weight: float = 0.1

    def __post_init__(self):
        assert self.mode in MODES, self.mode

    @property
    def needs_stale(self) -> bool:
        return self.mode in ("asgd", "dc_asgd")

    @property
    def stale_period(self) -> int:
        return self.staleness or self.rho


class GuidedState(NamedTuple):
    step: Any                       # arrival index
    score: torch.Tensor             # (..., c)
    prev_worker_loss: torch.Tensor  # (..., c)
    prev_avg_loss: torch.Tensor     # (...)
    w_stale: Any                    # stale weights, or () when not needed
    opt_state: Any                  # inner optimizer state
    extra: Any = ()                 # strategy-owned state


def compensate_dc_asgd(grads, params, w_stale, lam: float):
    """DC-ASGD delay compensation: g + lam * g*g*(W - W_stale), computed in
    float32 whatever the gradients' dtype, as the reference does: on the f64
    scan path the result is the gradient rounded through f32."""
    g32 = grads.to(torch.float32)
    return (g32 + lam * g32 * g32 * (params.to(torch.float32)
                                     - w_stale.to(torch.float32))).to(grads.dtype)
