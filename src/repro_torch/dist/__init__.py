"""`repro_torch.dist` — the async parameter server (port of `repro.dist`).

The scan backend *simulates* delay; this package *has* delay: a chief
owning a versioned `ParameterStore` (weights + guided window state, float64
on the card), N real worker processes computing gradients in numpy and
pushing them with the version they read, over stdlib
`multiprocessing.connection` TCP. Staleness becomes an observed quantity
(`applied_version - read_version`), the same `DelayCompensator` strategies
drive the apply path through the hand-written guided-update kernels, and a
fault-injection layer (kill/restart/join, dropped updates, per-worker
slowdowns) exercises what no simulator can: surviving real process death.

Entry points:
  * `Trainer.from_spec(ExperimentSpec(backend="dist", ...)).fit(data)`
  * `python -m repro_torch.dist.worker --addr host:port` (spawned per worker)

This module resolves its exports lazily: worker processes import
`repro_torch.dist.worker` / `protocol` / `logreg` (numpy only) and must not
pay for the launcher's torch-importing dependency chain at startup.
"""
_EXPORTS = {
    "run_local": ("repro_torch.dist.launcher", "run_local"),
    "ParameterStore": ("repro_torch.dist.store", "ParameterStore"),
    "strategy_needs_fetch": ("repro_torch.dist.store", "strategy_needs_fetch"),
    "Scenario": ("repro_torch.dist.scenarios", "Scenario"),
    "Chief": ("repro_torch.dist.chief", "Chief"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.dist' has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod), attr)
