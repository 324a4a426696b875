"""Tree optimizers (port of `repro.optim.optimizers`).

Each optimizer is an `Optimizer(init, update)` pair over the port's nested
dict params:
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, lr)
  params = tree_add(params, updates)          # updates already include -lr

The arithmetic, its order and its dtypes are the reference's: accumulators
in float32, the hypers python floats (rounded to float32 by the multiply),
`lr` the float32 value the schedule gives, as a python float. adam's step
`t` is a host int; its bias corrections are float32 tensor ops, as in the
fused update's plain version. The mesh trainer takes
this path for the optimizers and hypers that have no fused update
(rmsprop, adagrad, adam with weight decay) and for strategies with bespoke
gradient math (gap_aware).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.common import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, state)
    name: str = ""
    # the factory's hyperparameters, exposed so the fused whole-update kernels
    # (repro_torch.kernels.guided_update.ops.fused_update_for) bake the SAME
    # values the closures use; None means "unknown" and disables fusion
    hypers: dict = None


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: (-lr * g.float()).to(g.dtype), grads), state

    return Optimizer(init, update, "sgd", {})


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": _zeros(params)}

    def update(grads, state, params, lr):
        m = tree_map(lambda mi, g: beta * mi + g.float(), state["m"], grads)
        if nesterov:
            upd = tree_map(lambda mi, g: -(lr * (beta * mi + g.float())), m, grads)
        else:
            upd = tree_map(lambda mi: -lr * mi, m)
        return upd, {"m": m}

    return Optimizer(init, update, "momentum", {"beta": beta, "nesterov": nesterov})


def rmsprop(beta: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """Paper Fig. 11: r_t = beta r_{t-1} + (1-beta) v_t^2; W -= eta v/sqrt(r+eps)."""

    def init(params):
        return {"r": _zeros(params)}

    def update(grads, state, params, lr):
        r = tree_map(lambda ri, g: beta * ri + (1 - beta) * torch.square(g.float()),
                     state["r"], grads)
        upd = tree_map(lambda g, ri: -lr * g.float() / torch.sqrt(ri + eps), grads, r)
        return upd, {"r": r}

    return Optimizer(init, update, "rmsprop", {"beta": beta, "eps": eps})


def adagrad(eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"r": _zeros(params)}

    def update(grads, state, params, lr):
        r = tree_map(lambda ri, g: ri + torch.square(g.float()), state["r"], grads)
        upd = tree_map(lambda g, ri: -lr * g.float() / torch.sqrt(ri + eps), grads, r)
        return upd, {"r": r}

    return Optimizer(init, update, "adagrad", {"eps": eps})


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        tf = torch.tensor(float(t))
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf

        def upd(mi, vi, p):
            step = mi / bc1 / (torch.sqrt(vi / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam",
                     {"b1": b1, "b2": b2, "eps": eps, "weight_decay": weight_decay})


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adam": adam,
}


def get_optimizer(name: str, **kw) -> Optimizer:
    return _REGISTRY[name](**kw)
