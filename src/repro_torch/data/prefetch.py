"""Batch staging for the mesh fit loop (port of `repro.data.prefetch`).

  * `stack_blocks` turns a per-step batch stream into pre-stacked `(K, ...)`
    numpy blocks following a chunk schedule. It is a plain generator, so the
    generation cost runs wherever it is consumed: inline in the fit loop, or
    on the prefetch thread, where it overlaps the chunk in flight.
  * `batch_put` places a (stacked) batch on the device.
  * `ChunkPrefetcher` is the double buffer: a daemon thread pulls blocks
    from the source, puts them on the device and parks them in a bounded
    queue (depth 2: block i+1 stages while chunk i computes).

The prefetcher holds no lock: its attributes are set once in `__init__`,
and the worker hands items and its error to the consumer through the queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.common import tree_map


def stack_blocks(batches: Iterator[dict], sizes: Sequence[int]) -> Iterator[dict]:
    """Stack consecutive per-step batches into `(K, ...)` numpy blocks:
    `sizes[i]` batches for block i (the fit loop's chunk schedule), consumed
    in order and unmodified."""
    for k in sizes:
        rows = []
        for _ in range(k):
            try:
                rows.append(next(batches))
            except StopIteration:
                raise ValueError(
                    f"data stream exhausted mid-chunk (got {len(rows)} of {k} "
                    f"batches); a chunked fit needs n_steps batches — pass a "
                    f"long-enough stream or lower spec.steps") from None
        yield {key: np.stack([np.asarray(r[key]) for r in rows]) for key in rows[0]}


def batch_put(device) -> Callable:
    """Leaf-wise placement of a numpy (or tensor) batch tree on `device`."""
    def put(tree):
        return tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device), tree)

    return put


_DONE = object()


def _offer(q: queue.Queue, stop: threading.Event, item) -> None:
    """put() that close() can always unblock."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            continue


def _work(it: Iterator, put: Callable, q: queue.Queue, stop: threading.Event) -> None:
    """The prefetch thread: (item, None) per staged block, then (None, error)
    if the source or the transfer raised, then the end marker."""
    try:
        while not stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                break
            _offer(q, stop, (put(item), None))
    except Exception as e:  # surfaced at the consuming end, not swallowed
        _offer(q, stop, (None, e))
    _offer(q, stop, _DONE)


class ChunkPrefetcher:
    """Double-buffered staging of a batch/block stream on a daemon thread.
    Iterating yields the staged items in order; an exception raised by the
    source or the transfer re-raises at the consuming end. `close()` is
    idempotent and safe mid-stream: it unblocks and joins the worker
    without consuming the rest of the source."""

    def __init__(self, source: Iterable, put: Callable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1 (got {depth})")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_work, args=(iter(source), put, self._q, self._stop),
            name="chunk-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self) -> "ChunkPrefetcher":
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    item = _DONE  # worker gone, its marker dropped by close()
                    break
        if item is _DONE:
            raise StopIteration
        value, err = item
        if err is not None:
            raise err
        return value

    def close(self) -> None:
        """Stop the worker and join it; pending staged items are dropped."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
