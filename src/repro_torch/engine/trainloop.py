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

Checkpoints (`spec.ckpt_dir`), as the reference's:

  * a full-state snapshot (`repro_torch.checkpoint.snapshot`: params, the
    whole GuidedState, the data cursor) every `ckpt_every` steps, at a chunk
    boundary, and at the end; `AsyncCheckpointer.save` copies every tensor
    to the host before it returns, so the next dispatch may update the live
    tensors in place, and writes the archive on its own thread;
  * `resume=True` restores the newest intact snapshot straight into the
    freshly built state's tensors and replays the data cursor, so
    train(N) == train(k) + resume(N - k) leaf for leaf;
  * while it writes checkpoints (and only then, on the main thread) the fit
    handles SIGTERM: the chunk in flight drains, the state is snapshotted at
    its boundary, the fit returns `Report.interrupted=True`, and the
    previous handler is back in force.

The divergence sentinel (`spec.sentinel`) screens every step
(`repro_torch.resilience.wrap_step_sentinel`); the count of rejected steps is
read once, after the loop, into `Report.resilience`.
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


def step_records(m, first: int, indices=None) -> List[dict]:
    """Per-step history records from ONE dispatch's metrics: scalars
    (`chunk_steps=1`) or stacked `(k,)` tensors; `first` is the dispatch's
    first step. `indices` picks the in-chunk offsets to materialize (None:
    all), so a caller on a logging cadence reads only its log steps and an
    empty selection reads nothing. The dispatch's one device-to-host read
    happens here."""
    indices = list(range(m["loss"].numel()) if indices is None else indices)
    if not indices:
        return []
    vals = torch.stack([m[key].reshape(-1) for _, key in _METRIC_KEYS]).cpu().tolist()
    arrs = dict(zip((name for name, _ in _METRIC_KEYS), vals))
    return [{"step": first + i, **{name: a[i] for name, a in arrs.items()}}
            for i in indices]


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
    LM stream. Returns a `Report`; see the module docstring for the chunk,
    prefetch, checkpoint and sentinel contracts."""
    import signal
    import sys
    import threading

    from repro_torch import checkpoint as C
    from repro_torch.data.prefetch import ChunkPrefetcher, batch_put, stack_blocks
    from repro_torch.engine import mesh as M
    from repro_torch.engine.trainer import Report
    from repro_torch.optim import for_run, get_optimizer

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
    if spec.sentinel:
        from repro_torch.resilience import wrap_step_sentinel

        step_fn = wrap_step_sentinel(step_fn, spec.sentinel, spec.sentinel_factor)
    chunked = spec.chunk_steps > 1
    dispatch = build_chunk_step(step_fn) if chunked else step_fn

    start_step = 0
    if resume:
        if not spec.ckpt_dir:
            raise ValueError("fit(resume=True) needs spec.ckpt_dir to know "
                             "where the snapshots live")
        if C.latest_step(spec.ckpt_dir) is not None:
            # the freshly built state is the restore template (same tree, so
            # a checkpoint of another config fails loudly), written in place:
            # no second train state is ever held
            _, snap = C.restore_latest(spec.ckpt_dir, C.snapshot(params, gstate, 0))
            params, gstate = snap["params"], snap["gstate"]
            start_step = int(snap["data"]["cursor"])
            del snap
            if start_step > n_steps:
                raise ValueError(
                    f"checkpoint at step {start_step} is past this run's "
                    f"n_steps={n_steps}; nothing to resume")

    # constructed only once resume validation passed: a failed restore
    # must not strand the writer thread
    ckpt = None
    if spec.ckpt_dir:
        ckpt = C.AsyncCheckpointer(spec.ckpt_dir, keep_last=spec.keep_last,
                                   meta=C.spec_meta(spec))

    batches = iter(data) if data is not None else synthetic_stream(spec, cfg, c)
    for _ in range(start_step):  # replay the data cursor: the resumed steps
        next(batches)            # see the unbroken run's batches
    sizes = chunk_schedule(start_step, n_steps, spec.chunk_steps, spec.ckpt_every)
    source = stack_blocks(batches, sizes) if chunked else batches
    put = batch_put(device)
    prefetcher = None
    if spec.prefetch:
        prefetcher = ChunkPrefetcher(source, put=put)
        source = prefetcher

    # SIGTERM while checkpointing: drain the chunk in flight, snapshot, return
    stop = {"sig": None}
    old_handler, installed = None, False
    if ckpt is not None and threading.current_thread() is threading.main_thread():
        def _on_term(signum, frame):
            stop["sig"] = signum

        # the previous handler can be None (installed from C): track
        # installation separately so the restore still runs
        old_handler = signal.signal(signal.SIGTERM, _on_term)
        installed = True

    raw = []                   # (first_step, k, metrics) per dispatch
    rejected = []              # the sentinel's per-dispatch "rejected" metrics
    m = None
    done = start_step
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
            if spec.sentinel:
                rejected.append(m["rejected"])
            if keep_history:
                raw.append((done - k, k, m))
            if on_step is not None:
                on_step(done - 1, m, params)
            if ckpt is not None and spec.ckpt_every and done % spec.ckpt_every == 0:
                # the host copy happens here, at the chunk boundary, before
                # the next dispatch updates these tensors; serialization is
                # on the writer's thread
                ckpt.save(done, C.snapshot(params, gstate, done))
            if stop["sig"] is not None:
                break
        _sync(device)
        warm_time_s = max(time.perf_counter() - t_loop - compile_time_s, 0.0)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if installed:
            # a None previous handler cannot be re-registered through
            # signal.signal; SIG_DFL beats leaving our closure in place
            signal.signal(signal.SIGTERM,
                          old_handler if old_handler is not None else signal.SIG_DFL)
        if ckpt is not None:
            loop_failed = sys.exc_info()[0] is not None
            try:
                try:
                    # final full-state snapshot (dedupes against a periodic
                    # save that already covered `done`)
                    if done > start_step or C.latest_step(spec.ckpt_dir) is None:
                        ckpt.save(done, C.snapshot(params, gstate, done))
                finally:
                    ckpt.close()  # drain + join even if the save failed
            except Exception:
                # a training-loop exception outranks checkpoint teardown
                # noise; surface the writer error only on a clean loop
                if not loop_failed:
                    raise
    if not keep_history and m is not None:
        last_k = m["loss"].shape[0] if chunked else 1
        raw = [(done - last_k, last_k, m)]

    history = []
    for first, _, mi in raw:
        history.extend(step_records(mi, first))
    if not keep_history:
        history = history[-1:]
    final = dict(history[-1]) if history else {}
    resilience = {}
    if spec.sentinel:
        resilience = {"sentinel": spec.sentinel,
                      "rejected_steps": sum(int(torch.as_tensor(r).sum()) for r in rejected)}
    return Report(backend="mesh", spec=spec, history=history, final=final,
                  model=params, state=gstate, n_steps=done - start_step,
                  start_step=start_step, interrupted=stop["sig"] is not None,
                  compile_time_s=compile_time_s, warm_time_s=warm_time_s,
                  warm_steps=max(done - start_step - compiled_steps, 0),
                  resilience=resilience)
