"""Guided delay-compensated parallel SGD (port of `repro.core.guided`).

The paper's parameter-server algorithm (Fig. 7) re-derived for data-parallel
training, as the mesh trainer (`repro_torch.engine.mesh`) runs it:

  * each slice of the batch is one of the paper's `c` workers;
  * synchronous mode (SSGD): the mean gradient plays the parameter server;
  * asynchronous mode (ASGD) is simulated staleness: gradients are taken at
    `w_stale`, a copy of the params refreshed every `staleness` steps;
  * DC-ASGD (Zheng et al. 2017): g~ = g + lambda * g ⊙ g ⊙ (W_t - w_stale);
  * the guided correction: consistency scores (core.consistency) accumulate
    per worker over a window of `rho` steps; at window end the <=4 most
    consistent workers' losses are replayed, weighted, in the step's own
    backward ("fused") or in a second backward ("two_pass").

Where the reference decides on the device (`jnp.where` on the step), the
port decides on the host: `GuidedState.step` is a python int, so a step
reads nothing back from the card. `refresh_stale` copies into `w_stale` in
place on the steps where it refreshes and leaves it alone on the others.
The scan backend uses `GuidedConfig`, `GuidedState` and `compensate_dc_asgd`
with the seeds as a leading dimension of one tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.core.consistency import consistency_increment

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
    step: Any                       # host int: train step (mesh), arrival (scan)
    score: torch.Tensor             # (..., c)
    prev_worker_loss: torch.Tensor  # (..., c)
    prev_avg_loss: torch.Tensor     # (...)
    w_stale: Any                    # stale weights, or () when not needed
    opt_state: Any                  # inner optimizer state
    extra: Any = ()                 # strategy-owned state


def guided_init(gcfg: GuidedConfig, params, opt, n_workers: int) -> GuidedState:
    """Step 0, zero scores, +inf previous losses (so the first step scores
    nothing), a copy of the params as w_stale when the mode needs one."""
    dev = tree_leaves(params)[0].device
    return GuidedState(
        step=0,
        score=torch.zeros((n_workers,), dtype=torch.float32, device=dev),
        prev_worker_loss=torch.full((n_workers,), float("inf"), device=dev),
        prev_avg_loss=torch.tensor(float("inf"), device=dev),
        w_stale=tree_map(torch.clone, params) if gcfg.needs_stale else (),
        opt_state=opt.init(params),
    )


def update_scores(state: GuidedState, gcfg: GuidedConfig, worker_loss, avg_loss):
    """Accumulate this step's consistency increments (resets handled by the
    caller at window end). The first step's previous losses are +inf, so its
    deltas would read as "both improve": masked off."""
    inc = consistency_increment(worker_loss, state.prev_worker_loss, avg_loss,
                                state.prev_avg_loss, gcfg.magnitude_weight)
    finite = torch.isfinite(state.prev_worker_loss) & torch.isfinite(state.prev_avg_loss)
    return state.score + torch.where(finite, inc, torch.zeros_like(inc))


def correction_weights(score, gcfg: GuidedConfig):
    """(c,) normalized weights over the top-k most consistent workers;
    all-zero scores give zero weights (no correction). Ties go to the lowest
    index, as lax.top_k breaks them. The total is clamped at 1e-9 exactly as
    the reference clamps it, so scores whose top-k sum to less than 1e-9
    get weights that do not sum to 1, as there."""
    k = min(gcfg.max_consistent, score.shape[0])
    top_vals, top_idx = torch.sort(score, descending=True, stable=True)
    w = torch.zeros_like(score).index_put((top_idx[:k],), top_vals[:k])
    total = torch.sum(w)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-9), torch.zeros_like(w))


def is_window_end(step: int, gcfg: GuidedConfig) -> bool:
    return (step + 1) % gcfg.rho == 0


def compensate_dc_asgd(grads, params, w_stale, lam: float):
    """DC-ASGD delay compensation: g + lam * g*g*(W - W_stale) per leaf,
    computed in float32 whatever the gradients' dtype, as the reference does:
    on the f64 scan path the result is the gradient rounded through f32."""
    def one(g, p, pb):
        g32 = g.to(torch.float32)
        return (g32 + lam * g32 * g32 * (p.to(torch.float32)
                                         - pb.to(torch.float32))).to(g.dtype)

    return tree_map(one, grads, params, w_stale)


def refresh_stale(state: GuidedState, gcfg: GuidedConfig, params):
    """Round-robin staleness model: w_stale := params every stale_period
    steps, copied in place; the same tree comes back."""
    if not gcfg.needs_stale:
        return ()
    if state.step % gcfg.stale_period == 0:
        with torch.no_grad():
            tree_map(lambda ws, p: ws.copy_(p), state.w_stale, params)
    return state.w_stale


def advance(state: GuidedState, gcfg: GuidedConfig, new_opt_state, params, worker_loss,
            avg_loss, extra=None, score=None) -> GuidedState:
    """Post-update bookkeeping: scores, window reset, stale refresh, step.
    `score` overrides the default consistency accumulation; `extra` replaces
    the strategy-owned state (None keeps it)."""
    if score is None:
        score = update_scores(state, gcfg, worker_loss, avg_loss)
    if is_window_end(state.step, gcfg):
        score = torch.zeros_like(score)
    return GuidedState(
        step=state.step + 1,
        score=score,
        prev_worker_loss=worker_loss,
        prev_avg_loss=avg_loss,
        w_stale=refresh_stale(state, gcfg, params),
        opt_state=new_opt_state,
        extra=state.extra if extra is None else extra,
    )
