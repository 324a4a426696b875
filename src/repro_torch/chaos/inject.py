"""Seeded fault injection for the self-healing layer (`repro_torch.chaos`),
a copy of `repro.chaos.inject`.

A `ChaosPlan` is a declarative, fully deterministic description of the faults
one run must survive — which worker dies at which store version, which
connection the chief drops, which worker's gradients go NaN or explode, when
the newest checkpoint gets torn. The plan is data, not callbacks, so the same
plan reproduces the same fault sequence on every run with the same seed and
can be shipped to worker processes inside the chief's `welcome` meta
(`worker_meta()`).

Fault surfaces and where each is injected:

  * kills          — launcher: SIGKILL the worker process at a store version
  * resets         — chief: drop the TCP connection mid-stream (RST-like)
  * corrupt_frame  — worker: send one garbage frame (bytes head, no verb)
  * nan_grad       — worker: every gradient non-finite from a version on
  * boom_grad      — worker: gradients * 1e12 (finite but divergent)
  * truncate_at    — launcher: truncate the newest checkpoint archive
  * slow_disk_s    — `slow_disk()` patch: every archive write sleeps first

A run under a plan must auto-recover: complete, land within loss tolerance
of a fault-free reference, and record in `Report.dist` the remediation that
did it (rejections/quarantines/rollbacks/respawns).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass


def _as_table(pairs) -> dict:
    """((wid, at_version), ...) | {wid: at_version} -> {int: int}."""
    if not pairs:
        return {}
    items = pairs.items() if isinstance(pairs, dict) else pairs
    return {int(w): int(v) for w, v in items}


@dataclass(frozen=True)
class ChaosPlan:
    """One deterministic fault schedule. Thresholds are store VERSIONS, not
    wall-clock times, so plans are timing-independent and reproducible."""

    seed: int = 0
    kills: tuple = ()            # ((wid, at_version), ...) SIGKILL the process
    resets: tuple = ()           # ((wid, at_version), ...) chief drops the conn
    nan_grad: tuple = ()         # ((wid, at_version), ...) persistent NaN pushes
    boom_grad: tuple = ()        # ((wid, at_version), ...) persistent 1e12x pushes
    corrupt_frame: tuple = ()    # ((wid, at_version), ...) one garbage frame
    truncate_at: int | None = None   # tear the newest archive at this version
    slow_disk_s: float = 0.0     # per-archive write latency (use slow_disk())

    def worker_meta(self) -> dict | None:
        """The worker-side slice of the plan, shipped in the chief's welcome
        meta as `meta["chaos"]` (None when no worker-side faults)."""
        out = {}
        for kind in ("nan_grad", "boom_grad", "corrupt_frame"):
            table = _as_table(getattr(self, kind))
            if table:
                out[kind] = table
        return out or None

    def kill_events(self) -> dict:
        return _as_table(self.kills)

    def reset_events(self) -> tuple:
        return tuple((int(w), int(v)) for w, v in _as_table(self.resets).items())


def truncate_newest(ckpt_dir: str, keep_fraction: float = 0.5):
    """Tear the newest manifest-recorded archive in place (keep the leading
    `keep_fraction` of its bytes) WITHOUT touching the manifest — exactly the
    on-disk state a power loss mid-write on a non-atomic filesystem leaves
    behind. Returns (step, path) of the torn archive, or None when the dir
    has no entries yet."""
    from repro_torch.checkpoint.npz import manifest_entries

    entries = manifest_entries(ckpt_dir)
    if not entries:
        return None
    entry = entries[0]
    path = os.path.join(ckpt_dir, entry["file"])
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * keep_fraction)))
    except FileNotFoundError:
        return None
    return entry["step"], path


@contextlib.contextmanager
def slow_disk(delay_s: float):
    """Patch every checkpoint archive write to sleep `delay_s` first — the
    slow-disk writer fault. Covers both the direct `npz.write_archive`
    callers and `checkpoint.writer`'s imported reference."""
    from repro_torch.checkpoint import npz, writer

    real = npz.write_archive

    def slow_write(ckpt_dir, step, flat):
        time.sleep(delay_s)
        return real(ckpt_dir, step, flat)

    npz.write_archive = slow_write
    writer.write_archive = slow_write
    try:
        yield
    finally:
        npz.write_archive = real
        writer.write_archive = real
