"""The mesh fit loop: chunked dispatch and prefetch (port of
`repro.engine.trainloop`).

  * `chunk_schedule` partitions the step range into dispatch chunks of at
    most `spec.chunk_steps` steps, split (never shifted) so every
    `ckpt_every` multiple lands on a chunk boundary;
  * `build_chunk_step` runs K train steps over a stacked `(K, ...)` batch
    block and stacks their metrics to `(K,)` tensors, so per-step history is
    kept while the host reads the card once per chunk;
  * the `repro_torch.data.prefetch` double buffer stages block i+1 (batch
    generation, stacking, the host-to-device copy) on a thread while chunk i
    computes.

Contracts, as the reference's:

  * `on_step(step, metrics, params)` fires once per chunk with the stacked
    `(k,)` device metrics and `step` = the LAST step index of the chunk;
    `chunk_steps=1` gives the per-step scalar contract. The params are the
    live ones, updated in place by the next step: read or copy them inside
    the callback;
  * `Report.compile_time_s` sums the first dispatch of every chunk size
    (nothing compiles here: it is the first dispatch, kernel build and
    first-touch allocations included, counted as the reference counts it),
    `warm_steps` counts the steps outside them and `warm_time_s` is the
    wall time of those warm dispatches alone.

Checkpointing (`spec.ckpt_dir`) and the divergence sentinel
(`spec.sentinel`) are not ported yet (ROADMAP slice 5): the fit refuses them.
The reference drains the in-flight chunk on SIGTERM only while it writes
checkpoints, so the port's fit leaves SIGTERM alone until they come.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from repro_torch.engine.spec import ExperimentSpec


def chunk_schedule(start: int, stop: int, chunk_steps: int,
                   ckpt_every: int = 0) -> List[int]:
    """Sizes of the consecutive dispatch chunks covering steps [start, stop).
    Each is at most `chunk_steps` long; every multiple of `ckpt_every` (when
    set) lands on a chunk boundary, and a `start` mid-cadence re-aligns at
    the next multiple."""
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1 (got {chunk_steps})")
    sizes = []
    s = start
    while s < stop:
        k = min(chunk_steps, stop - s)
        if ckpt_every:
            k = min(k, ckpt_every - s % ckpt_every)
        sizes.append(k)
        s += k
    return sizes


#: Report history record name -> raw metrics key
_METRIC_KEYS = (("loss", "loss"), ("worker_var", "worker_loss_var"),
                ("corr_w", "corr_weight_sum"))


def step_records(m, first: int) -> List[dict]:
    """Per-step history records from ONE dispatch's metrics: scalars
    (`chunk_steps=1`) or stacked `(k,)` tensors; `first` is the dispatch's
    first step. The dispatch's one device-to-host read happens here."""
    vals = torch.stack([m[key].reshape(-1) for _, key in _METRIC_KEYS]).cpu().tolist()
    arrs = dict(zip((name for name, _ in _METRIC_KEYS), vals))
    return [{"step": first + i, **{name: a[i] for name, a in arrs.items()}}
            for i in range(len(vals[0]))]


def build_chunk_step(step_fn: Callable) -> Callable:
    """`chunk_fn(params, gstate, stacked)`: `step_fn` over the leading axis
    of a `(K, ...)`-stacked batch block, metrics stacked to `(K,)` tensors
    (the host's "lr" and "step" too)."""
    def chunk_fn(params, gstate, stacked):
        k = next(iter(stacked.values())).shape[0]
        ms = []
        for i in range(k):
            params, gstate, m = step_fn(params, gstate, {n: x[i] for n, x in stacked.items()})
            ms.append(m)
        dev = ms[0]["loss"].device
        metrics = {n: (torch.stack([m[n] for m in ms]) if torch.is_tensor(ms[0][n])
                       else torch.tensor([m[n] for m in ms], device=dev))
                   for n in ms[0]}
        return params, gstate, metrics

    return chunk_fn


def synthetic_stream(spec: ExperimentSpec, cfg, c: int):
    """The per-step synthetic batch stream for `data=None` mesh fits: a
    deterministic function of (seed, number of draws)."""
    from repro_torch.data import synthetic_lm_batches

    return synthetic_lm_batches(cfg.vocab_size, spec.seq_len, spec.global_batch,
                                seed=spec.seed, n_corpora=c)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(spec: ExperimentSpec, strategy, data=None, steps: Optional[int] = None,
        on_step: Optional[Callable] = None, keep_history: bool = True,
        resume: bool = False, device="cuda"):
    """The mesh backend's fit loop (what `Trainer.fit` dispatches to): the
    params drawn from `spec.seed` on `device`, `steps` (default spec.steps)
    train steps over `data` (an iterable of batch dicts) or the synthetic
    LM stream. Returns a `Report`; see the module docstring for the chunk
    and prefetch contracts."""
    from repro_torch.data.prefetch import ChunkPrefetcher, batch_put, stack_blocks
    from repro_torch.engine import mesh as M
    from repro_torch.engine.trainer import Report
    from repro_torch.optim import for_run, get_optimizer

    if spec.ckpt_dir or spec.sentinel or resume:
        raise NotImplementedError(
            "checkpointing, resume and the divergence sentinel (spec.ckpt_dir, "
            "resume=True, spec.sentinel) are not yet ported to repro_torch "
            "(ROADMAP slice 5: checkpoint and resilience)")
    device = torch.device(device)
    n_steps = steps or spec.steps
    cfg = spec.model_config()
    M.build_ctx(spec.mesh)
    gcfg = spec.to_guided_config()
    opt = get_optimizer(spec.optimizer)
    lr = for_run(spec.schedule, spec.lr, spec.warmup, n_steps)

    c = spec.workers or 1
    if spec.global_batch % c != 0:
        raise ValueError(
            f"spec.global_batch={spec.global_batch} is not divisible by the "
            f"worker count c={c} (spec.workers={spec.workers}); the per-worker "
            f"loss reshape needs equal shards — adjust spec.global_batch or "
            f"spec.workers")
    gen = torch.Generator(device=device).manual_seed(spec.seed)
    params, gstate = M.init_train_state(gen, cfg, gcfg, opt, n_workers=c,
                                        strategy=strategy, device=device)
    step_fn = M.build_train_step(cfg, gcfg, opt, lr, n_micro=spec.micro,
                                 n_workers=c, strategy=strategy)
    chunked = spec.chunk_steps > 1
    dispatch = build_chunk_step(step_fn) if chunked else step_fn

    batches = iter(data) if data is not None else synthetic_stream(spec, cfg, c)
    sizes = chunk_schedule(0, n_steps, spec.chunk_steps, spec.ckpt_every)
    source = stack_blocks(batches, sizes) if chunked else batches
    put = batch_put(device)
    prefetcher = None
    if spec.prefetch:
        prefetcher = ChunkPrefetcher(source, put=put)
        source = prefetcher

    raw = []                   # (first_step, k, metrics) per dispatch
    m = None
    done = 0
    compile_time_s = 0.0
    compiled_steps = 0         # steps covered by first dispatches of a size
    seen_sizes = set()
    t_loop = time.perf_counter()
    try:
        for k in sizes:
            block = next(source) if spec.prefetch else put(next(source))
            is_new = k not in seen_sizes
            if is_new:
                _sync(device)  # queued warm work must not land in the window
                t_dispatch = time.perf_counter()
            params, gstate, m = dispatch(params, gstate, block)
            if is_new:
                _sync(device)
                compile_time_s += time.perf_counter() - t_dispatch
                compiled_steps += k
                seen_sizes.add(k)
            done += k
            if keep_history:
                raw.append((done - k, k, m))
            if on_step is not None:
                on_step(done - 1, m, params)
        _sync(device)
        warm_time_s = max(time.perf_counter() - t_loop - compile_time_s, 0.0)
    finally:
        if prefetcher is not None:
            prefetcher.close()
    if not keep_history and m is not None:
        last_k = m["loss"].shape[0] if chunked else 1
        raw = [(done - last_k, last_k, m)]

    history = []
    for first, _, mi in raw:
        history.extend(step_records(mi, first))
    if not keep_history:
        history = history[-1:]
    final = dict(history[-1]) if history else {}
    return Report(backend="mesh", spec=spec, history=history, final=final,
                  model=params, state=gstate, n_steps=done,
                  compile_time_s=compile_time_s, warm_time_s=warm_time_s,
                  warm_steps=max(done - compiled_steps, 0))
