"""The strategy-driven train step (port of `repro.engine.mesh`).

The paper's technique on a transformer (the reference's DESIGN.md §3):

  * per-worker losses E_i come from the per-example loss vector: each of
    the c equal slices of the batch is one of the paper's workers (on one
    card the c workers are emulated by slicing the batch);
  * the active `DelayCompensator` plugs into four seams: correction weights
    folded into the SAME backward pass (grad(sum w_i L_i) = sum w_i g_i),
    gradient compensation after the backward, a post-optimizer parameter
    correction, and the consistency-score update;
  * ASGD staleness is simulated through gstate.w_stale.

Where the strategy's compensation is the kernel's lam fold and the optimizer
has a fused kernel (sgd, momentum, adam with known hypers and no weight
decay), the update is ONE launch of the hand-written guided-update kernel
per parameter leaf, in place (`tree_fused_update`); otherwise it is the
two-phase compensate_grads + opt.update + tree_add in plain torch, as the
reference's XLA path does.

Every decision the reference makes on the device from the step counter
(window end, stale refresh, the lr schedule) is made here from the host's
int step, so a step reads nothing back from the card; its metrics stay on
the device until the fit loop records them. Gradients come from
`torch.autograd.grad` with respect to detached leaves that share the
params' storage, in the params' dtype (bf16 at full width; the fused kernel
widens to f32 inside), and the graph is gone before the update writes the
params in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import tree_add, tree_leaves, tree_map, tree_unflatten
from repro_torch.core import guided as G
from repro_torch.engine.strategies import DelayCompensator, get_compensator, strategy_name_for
from repro_torch.kernels.guided_update.ops import tree_fused_update
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer


def build_ctx(mesh_kind: str) -> str:
    """Mesh kind -> the port's context: "local" (one card, the train step
    needs nothing more). The sharded meshes wait for ROADMAP slice 7."""
    if mesh_kind == "local":
        return "local"
    raise NotImplementedError(
        f"mesh {mesh_kind!r} is not yet ported to repro_torch (ROADMAP slice 7: "
        f"sharding and launchers); ported: 'local'")


def resolve_strategy(gcfg: G.GuidedConfig, strategy=None) -> DelayCompensator:
    """Accept a DelayCompensator instance, a registry name, or None (derive
    the strategy the GuidedConfig flags imply)."""
    if isinstance(strategy, DelayCompensator):
        return strategy
    return get_compensator(strategy or strategy_name_for(gcfg), gcfg)


def init_train_state(gen: torch.Generator, cfg, gcfg: G.GuidedConfig, opt: Optimizer,
                     n_workers: int, strategy=None, device="cuda"):
    """Model params drawn from `gen` on `device`, and the GuidedState
    (strategy extra included). Returns (params, gstate)."""
    strategy = resolve_strategy(gcfg, strategy)
    params = T.model_init(gen, cfg, device)
    gstate = G.guided_init(gcfg, params, opt, n_workers)
    return params, gstate._replace(extra=strategy.init(params, n_workers))


def _microbatches(batch, n_micro: int, c: int):
    """Split (B, ...) -> (n_micro, B/n_micro, ...) keeping the worker
    structure: every microbatch holds an equal slice of every worker's rows,
    so per-worker losses stay well defined."""
    def one(x):
        B = x.shape[0]
        b = B // c
        xr = x.reshape(c, n_micro, b // n_micro, *x.shape[1:])
        return xr.movedim(1, 0).reshape(n_micro, B // n_micro, *x.shape[1:])

    return tree_map(one, batch)


def build_train_step(cfg, gcfg: G.GuidedConfig, opt: Optimizer, lr_schedule,
                     n_micro: int = 1, n_workers: int = 0, strategy=None):
    """Returns train_step(params, gstate, batch) -> (params, gstate, metrics).

    `lr_schedule(step)` maps the host int step to the float32 lr as a
    python float; `n_workers` is the paper's c (default 1 on the local
    mesh); n_micro > 1 accumulates f32 gradients over microbatches. The
    params are updated in place and returned; `metrics` holds device
    scalars ("loss", "worker_loss_var", "corr_weight_sum") and the host's
    "lr" and "step". `train_step(..., screen=s)` adds the host's "rejected"
    (see the module docstring); without a screen the step is unchanged."""
    strategy = resolve_strategy(gcfg, strategy)
    c = n_workers or 1

    # whole-update fusion: when the strategy's compensation is the kernel's
    # lam fold and the optimizer has a fused kernel, ONE launch per leaf
    # replaces compensate_grads + opt.update + tree_add; hypers must be known
    # and weight-decay free for it to match opt.update
    fused = None
    fused_lam = 0.0
    if opt.hypers is not None and opt.name in ("sgd", "momentum", "adam"):
        hy = dict(opt.hypers)
        if not hy.pop("weight_decay", 0.0):
            fused = strategy.sim_kernel(opt.name, **hy)
            fused_lam = float(strategy.sim_kernel_lambda())

    def losses(p, batch):
        per_ex, aux, _ = T.forward_train(p, batch, cfg)
        return per_ex.reshape(c, -1).mean(dim=1), aux

    def grads_and_losses(grad_at, batch, corr_w):
        """Gradients at `grad_at` (a tree in the params' dtypes), the (c,)
        worker losses and their mean, all detached."""
        mbs = [batch] if n_micro == 1 else [
            tree_map(lambda x, i=i: x[i], _microbatches(batch, n_micro, c))
            for i in range(n_micro)]
        g_sum, e_sum, l_sum = None, 0.0, 0.0
        for mb in mbs:
            leaves = [a.detach().requires_grad_() for a in tree_leaves(grad_at)]
            E_i, aux = losses(tree_unflatten(grad_at, leaves), mb)
            mean_loss = E_i.mean()
            total = mean_loss + aux + (corr_w * E_i).sum() * gcfg.correction_scale
            g = torch.autograd.grad(total, leaves)
            if n_micro == 1:
                return tree_unflatten(grad_at, g), E_i.detach(), mean_loss.detach()
            g_sum = ([gi.float() for gi in g] if g_sum is None
                     else [a + gi.float() for a, gi in zip(g_sum, g)])
            e_sum = e_sum + E_i.detach()
            l_sum = l_sum + mean_loss.detach()
        grads = [(gs / n_micro).to(p.dtype) for gs, p in zip(g_sum, tree_leaves(grad_at))]
        return tree_unflatten(grad_at, grads), e_sum / n_micro, l_sum / n_micro

    def weighted_grad_fn(batch):
        """grad of the consistency-weighted per-worker loss (uniform term
        off), handed to strategy.correct for the paper's second update."""
        def at(p, w):
            leaves = [a.detach().requires_grad_() for a in tree_leaves(p)]
            E_i, _ = losses(tree_unflatten(p, leaves), batch)
            return tree_unflatten(p, torch.autograd.grad((w * E_i).sum(), leaves))

        return at

    def train_step(params, gstate: G.GuidedState, batch, screen=None):
        step = gstate.step
        corr_w = strategy.correction_weights(gstate, c)
        grad_at = gstate.w_stale if gcfg.needs_stale else params
        grads, E_i, mean_loss = grads_and_losses(grad_at, batch, corr_w)
        metrics = {
            "loss": mean_loss,
            "worker_loss_var": torch.var(E_i, unbiased=False),
            "corr_weight_sum": torch.sum(corr_w),
            "lr": lr_schedule(step),
        }
        out_of_place = screen is not None and screen.out_of_place
        if screen is not None and not out_of_place and not screen.admit(
                mean_loss, gstate.prev_avg_loss):
            return params, gstate, {**metrics, "step": step, "rejected": 1}

        lr = metrics["lr"]
        # lr * c in float32, as the reference multiplies its f32 lr
        lr_eff = float(np.float32(lr) * np.float32(c)) if gcfg.mode != "seq" else lr
        if fused is not None:
            # the compensation rides inside the fused update as the lam fold
            # (identity for non-dc strategies: lam == 0)
            w_ref = gstate.w_stale if gcfg.needs_stale else params
            new_params, opt_state = tree_fused_update(fused, opt.name, params, grads, w_ref,
                                                      gstate.opt_state, lr_eff, fused_lam,
                                                      inplace=not out_of_place)
        else:
            grads = strategy.compensate_grads(grads, params, gstate)
            with torch.no_grad():
                updates, opt_state = opt.update(grads, gstate.opt_state, params, lr_eff)
                new_params = tree_add(params, updates)
            del updates
        # the strategy's next extra state reads this step's grads; take it now
        # so the grads are freed before a correcting strategy's second backward
        extra = strategy.update_extra(gstate, grads)
        del grads
        if strategy.needs_correction:
            new_params = strategy.correct(new_params, gstate, lr, weighted_grad_fn(batch))
        if out_of_place and not screen.admit(mean_loss, gstate.prev_avg_loss, new_params):
            return params, gstate, {**metrics, "step": step, "rejected": 1}

        gstate = G.advance(gstate, gcfg, opt_state, new_params, E_i, mean_loss, extra=extra,
                           score=strategy.score(gstate, E_i, mean_loss))
        metrics["step"] = gstate.step
        if screen is not None:
            metrics["rejected"] = 0
        return new_params, gstate, metrics

    return train_step
