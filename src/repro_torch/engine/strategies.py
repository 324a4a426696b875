"""Pluggable delay-compensation strategies (the `DelayCompensator` registry),
port of `repro.engine.strategies`.

The mesh trainer (repro_torch.engine.mesh) drives every strategy through the
reference's seams around one train step:

  init(params, n_workers)        -> strategy-owned extra state (())
  needs_correction               -> False when `correct` is the identity
  correction_weights(state, c)   -> (c,) weights folded into THIS backward
                                    pass as sum_i w_i * L_i ("fused" replay)
  compensate_grads(grads, params, state) -> adjusted gradients (post-backward)
  correct(params, state, lr, weighted_grad_fn) -> params after the optimizer
                                    step (the paper's literal second update)
  score(state, worker_loss, avg_loss) -> new (c,) consistency scores
  update_extra(state, grads)     -> next extra state

The reference decides on the device where the port decides on the host's
step (`jnp.where` / `lax.cond` on `is_window_end`): off a window end
`correction_weights` is zeros and `correct` returns the params untouched.

The scan backend (repro_torch.engine.delaysim) drives every strategy through
the same seams as the reference's scan body:

  sim_guided                 -> track per-arrival consistency, replay at window end
  sim_kernel_lambda()        -> DC-ASGD's lambda folded into the fused update kernel
  sim_kernel(optimizer, ...) -> the fused whole-update callable, or None for the
                                two-phase path (compensate_grads, then a lam=0 apply)
  compensate_grads(g, W, state) -> adjusted gradients
  sim_score(d_own, d_avg, prev_avg) -> one arrival's consistency score
  sim_replay(W, scores, grads, lr)  -> the window-end replay (paper Fig. 7)

Where the reference vmaps the hooks over the seeds, here the seeds are a
leading dimension: W and g are (S, P, k), window scores (S, rho), window
grads (S, rho, P, k), losses (S,). Every reduction inside a hook runs over
the non-seed dimensions only, so each seed sees what it sees under vmap.

A hook's `grads` / `params` are a tree on the mesh (nested dicts, one leaf
per parameter) and one seed-batched tensor on the scan backend.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.core import guided as G
from repro_torch.engine.spec import needs_stale_message


class DelayCompensator:
    """Base strategy: no compensation, paper-faithful consistency scoring."""

    name = "none"

    #: True -> the arrival loop tracks per-arrival consistency (loss-before /
    #: loss-after of the applied batch + verification loss) and calls
    #: sim_score / sim_replay; False skips that bookkeeping entirely.
    sim_guided = False

    def __init__(self, gcfg: G.GuidedConfig):
        self.gcfg = gcfg

    # ------------------------------------------------------------ mesh hooks
    def init(self, params, n_workers: int):
        """Initial strategy-owned state, stored in GuidedState.extra."""
        return ()

    @property
    def needs_correction(self) -> bool:
        """False when `correct` is the identity: the train step then never
        runs the second weighted forward+backward. A subclass that overrides
        `correct` needs it unless it also overrides this property."""
        return type(self).correct is not DelayCompensator.correct

    def correction_weights(self, state: G.GuidedState, c: int):
        """(c,) weights for the consistency-weighted loss term of THIS step's
        backward pass (zero except at window end for fused guided replay)."""
        return state.score.new_zeros((c,))

    def compensate_grads(self, grads, params, state: G.GuidedState):
        """Adjust freshly computed gradients (e.g. staleness Taylor terms)."""
        return grads

    def correct(self, params, state: G.GuidedState, lr, weighted_grad_fn: Callable):
        """Post-optimizer-step parameter correction. `weighted_grad_fn(p, w)`
        returns the gradient of the w-weighted per-worker loss at p."""
        return params

    def score(self, state: G.GuidedState, worker_loss, avg_loss):
        """New accumulated consistency scores (pre window-reset)."""
        return G.update_scores(state, self.gcfg, worker_loss, avg_loss)

    def update_extra(self, state: G.GuidedState, grads):
        """Next value of the strategy-owned extra state."""
        return state.extra

    # ------------------------------------------------------- scan-sim hooks

    def sim_kernel_lambda(self) -> float:
        """DC-ASGD Taylor coefficient folded directly into the fused apply
        kernel (g~ = g + lam*g*g*(W - W_stale)). Non-zero means the kernel
        performs the compensation and compensate_grads is skipped."""
        return 0.0

    def sim_kernel(self, optimizer: str, **hypers):
        """The fused whole-update callable (gradient → compensation →
        accumulator → weight, one launch) for this strategy × `optimizer`,
        or None when the loop must take the two-phase path (compensate_grads,
        then a plain lam=0 apply). Fusion is sound exactly when this
        strategy's compensation is the kernel's lam fold: compensate_grads
        is not overridden, or sim_kernel_lambda() is non-zero. Optimizers
        without a fused kernel (adagrad) get None too."""
        overridden = (type(self).compensate_grads
                      is not DelayCompensator.compensate_grads)
        if overridden and not self.sim_kernel_lambda():
            return None
        from repro_torch.kernels.guided_update.ops import FUSED_OPTIMIZERS, fused_update_for

        if optimizer not in FUSED_OPTIMIZERS:
            return None
        return fused_update_for(optimizer, **hypers)

    def sim_score(self, d_own, d_avg, prev_avg_err):
        """Paper Fig. 7 consistency score of ONE arrival per seed: the applied
        batch is consistent when the step moved both its own loss (d_own) and
        the verification-average loss (d_avg) downward; ranked by the
        relative average-error drop. 0 for inconsistent arrivals."""
        ok = torch.isfinite(prev_avg_err) & (d_own < 0) & (d_avg < 0)
        return torch.where(ok, -d_avg / (torch.abs(prev_avg_err) + 1e-12),
                           torch.zeros_like(d_avg))

    def sim_replay(self, W, window_scores, window_grads, lr):
        """Window-end replay (Fig. 7 line 8): re-apply the stored gradients of
        the <=max_consistent most consistent arrivals of the closing window,
        plain SGD style (W -= lr * g). Ties go to the lowest index (arrival
        order), as lax.top_k breaks them in the reference: a stable
        descending sort, per seed."""
        k = min(self.gcfg.max_consistent, window_scores.shape[1])
        top_v, top_i = torch.sort(window_scores, dim=1, descending=True, stable=True)
        top_v, top_i = top_v[:, :k], top_i[:, :k]
        sel = (top_v > 0).to(W.dtype)                                   # (S, k)
        seeds = torch.arange(W.shape[0], device=W.device)[:, None]
        picked = window_grads[seeds, top_i]                             # (S, k, P, c)
        return W - lr * torch.einsum("sj,sjpc->spc", sel, picked)


def sim_shim_state(i, Wf, prev_avg, c: int) -> G.GuidedState:
    """Minimal GuidedState for the compensate_grads signature on the scan
    backend: only w_stale is guaranteed (what compensate_grads reads); the
    window bookkeeping lives in the arrival loop."""
    z = Wf.new_zeros((Wf.shape[0], c))
    return G.GuidedState(step=i, score=z, prev_worker_loss=z,
                         prev_avg_loss=prev_avg, w_stale=Wf, opt_state=(), extra=())


def _fused_weights(state: G.GuidedState, gcfg: G.GuidedConfig, c: int):
    """(c,) top-k consistency weights at window end, zeros otherwise."""
    if G.is_window_end(state.step, gcfg):
        return G.correction_weights(state.score, gcfg)
    return state.score.new_zeros((c,))


def _two_pass_correct(params, state: G.GuidedState, gcfg: G.GuidedConfig, lr,
                      weighted_grad_fn):
    """The paper's literal Fig. 7 second sequential update at window end:
    p - lr * g of the weighted loss's gradient at the moved params, written
    into the params in place (one rounding to the params' dtype)."""
    if not G.is_window_end(state.step, gcfg):
        return params
    g2 = weighted_grad_fn(params, G.correction_weights(state.score, gcfg))
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(g2)):
            p.sub_(g.to(p.dtype), alpha=lr)
    return params


class GuidedFused(DelayCompensator):
    """The paper's guided replay, fused into the main backward pass:
    grad(sum_i w_i L_i) = sum_i w_i g_i, so replaying the <=max_consistent
    most consistent workers' gradients costs one weighted loss term. On the
    scan backend both guided flavours run the literal window-end replay."""

    name = "guided_fused"
    sim_guided = True

    def correction_weights(self, state: G.GuidedState, c: int):
        return _fused_weights(state, self.gcfg, c)


class GuidedTwoPass(DelayCompensator):
    """The paper's literal Fig. 7 second sequential update: every rho steps,
    a second backward of the consistency-weighted loss at the moved iterate."""

    name = "guided_two_pass"
    sim_guided = True

    def correct(self, params, state: G.GuidedState, lr, weighted_grad_fn):
        return _two_pass_correct(params, state, self.gcfg, lr, weighted_grad_fn)


class DcAsgd(DelayCompensator):
    """DC-ASGD (Zheng et al. 2017): g~ = g + lambda * g ⊙ g ⊙ (W_t - W_stale).
    Pure Taylor compensation; no guided replay (see DcAsgdGuided)."""

    name = "dc_asgd"

    def sim_kernel_lambda(self) -> float:
        return self.gcfg.dc_lambda

    def compensate_grads(self, grads, params, state: G.GuidedState):
        return G.compensate_dc_asgd(grads, params, state.w_stale, self.gcfg.dc_lambda)


class DcAsgdGuided(DcAsgd):
    """DC-ASGD composed with the paper's guided replay. The replay flavour
    follows gcfg.correction ("fused" folds the weights into the backward
    pass, "two_pass" runs the literal second update)."""

    name = "dc_asgd_guided"
    sim_guided = True

    @property
    def needs_correction(self) -> bool:
        return self.gcfg.correction == "two_pass"

    def correction_weights(self, state: G.GuidedState, c: int):
        if self.gcfg.correction != "fused":
            return state.score.new_zeros((c,))
        return _fused_weights(state, self.gcfg, c)

    def correct(self, params, state: G.GuidedState, lr, weighted_grad_fn):
        if self.gcfg.correction != "two_pass":
            return params
        return _two_pass_correct(params, state, self.gcfg, lr, weighted_grad_fn)


class GapAware(DelayCompensator):
    """Gap-Aware staleness dampening (Barkai et al. 2019, arXiv:1909.10802):
    each gradient coordinate is divided by 1 + |W_t - W_stale| / rms(g), rms
    taken over each leaf of a mesh tree, and per seed (over all but the
    leading dimension) of the scan backend's seed-batched tensor. Needs
    mode="asgd" (w_stale)."""

    name = "gap_aware"

    def __init__(self, gcfg: G.GuidedConfig):
        if not gcfg.needs_stale:
            raise ValueError(
                needs_stale_message("gap_aware", "dampens by |W - w_stale|", gcfg.mode)
            )
        super().__init__(gcfg)

    def compensate_grads(self, grads, params, state: G.GuidedState):
        per_seed = not isinstance(grads, dict)

        def one(g, p, ps):
            # compute dtype follows the gradients (>= f32)
            ct = torch.promote_types(g.dtype, torch.float32)
            gc = g.to(ct)
            gap = torch.abs(p.to(ct) - ps.to(ct))
            dims = tuple(range(1, gc.ndim)) if per_seed else tuple(range(gc.ndim))
            rms = torch.sqrt(torch.mean(torch.square(gc), dim=dims, keepdim=True) + 1e-12)
            return (gc / (1.0 + gap / torch.clamp(rms, min=1e-12))).to(g.dtype)

        return tree_map(one, grads, params, state.w_stale)


# ----------------------------------------------------------------- registry

_REGISTRY: Dict[str, Type[DelayCompensator]] = {}


def register_compensator(name: str):
    """Class decorator: `@register_compensator("my_scheme")` makes the scheme
    selectable by name from ExperimentSpec."""

    def deco(cls: Type[DelayCompensator]):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


for _cls in (DelayCompensator, GuidedFused, GuidedTwoPass, DcAsgd, DcAsgdGuided, GapAware):
    _REGISTRY[_cls.name] = _cls


def compensator_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def strategy_name_for(gcfg: G.GuidedConfig) -> str:
    """GuidedConfig flags -> registry name (the reference's legacy mapping)."""
    if gcfg.mode == "dc_asgd":
        return "dc_asgd_guided" if gcfg.guided else "dc_asgd"
    if gcfg.guided:
        return "guided_two_pass" if gcfg.correction == "two_pass" else "guided_fused"
    return "none"


def get_compensator(name: str, gcfg: G.GuidedConfig) -> DelayCompensator:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown delay-compensation strategy {name!r}; "
            f"registered: {', '.join(compensator_names())}"
        ) from None
    return cls(gcfg)
