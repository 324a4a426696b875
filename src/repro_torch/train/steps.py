"""Train / prefill / decode step builders (port of `repro.train.steps`).

`build_train_step` / `make_train_state` are thin deprecated shims over
`repro_torch.engine.mesh`, as in the reference; new code goes through
`repro_torch.engine.Trainer` / `engine.mesh.build_train_step` directly. The
serve-side step builders wrap `models.transformer.prefill` / `decode_step`.

The reference's sharding-tree helpers (`param_shardings`, `batch_shardings`,
`state_shardings`, `cache_shardings`) have no counterpart yet: they wait for
the port's sharding rules (ROADMAP Queue 1 item 11). The port runs on one
card, so no step here takes a sharding context.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.core import guided as G
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer


class TrainFns(NamedTuple):
    train_step: Callable
    init_fn: Callable


def make_train_state(gen, cfg, gcfg: G.GuidedConfig, opt: Optimizer, n_workers: int,
                     device="cuda"):
    """Deprecated shim over engine.mesh.init_train_state: (params, gstate)
    with params drawn from the torch Generator `gen` on `device`."""
    from repro_torch.engine import mesh as _engine

    return _engine.init_train_state(gen, cfg, gcfg, opt, n_workers, device=device)


def build_train_step(cfg, gcfg: G.GuidedConfig, opt: Optimizer, lr_schedule,
                     n_micro: int = 1, n_workers: int = 0):
    """Deprecated shim over engine.mesh.build_train_step: derives the
    DelayCompensator strategy the GuidedConfig flags imply and delegates."""
    from repro_torch.engine import mesh as _engine

    return _engine.build_train_step(cfg, gcfg, opt, lr_schedule,
                                    n_micro=n_micro, n_workers=n_workers)


def build_prefill_step(cfg):
    """Batched prompt prefill; pass total_len/prompt_lens through T.prefill
    directly when serving variable-length prompts (repro_torch.serve does)."""
    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg)

    return prefill_step


def build_decode_step(cfg):
    """One decode step; `t` is a scalar shared position or a (B,) per-request
    position vector (continuous batching, as repro_torch.serve runs it)."""
    def decode_step(params, caches, tokens, t):
        return T.decode_step(params, caches, tokens, t, cfg)

    return decode_step
