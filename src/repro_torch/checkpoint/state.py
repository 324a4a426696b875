"""Chief-side snapshots of the async parameter server (the dist half of
`repro.checkpoint.state`).

A snapshot is a flat dict of host arrays under one "dist" entry: the
authoritative weights, the store version, the observed staleness sequence,
and for rollback-capable stores the optimizer accumulator and the current
lr scale. The archive keys are the reference's (`['dist']/['W']`), so a
snapshot written by either package restores in the other. The mesh
trainer's full-state snapshots are not ported yet.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.checkpoint.npz import (
    CorruptCheckpointError,
    latest_step,
    manifest_entries,
    step_path,
    verify_entry,
)


def dist_snapshot(W, version: int, staleness, r=None, lr_scale: float = 1.0) -> dict:
    """Chief-side snapshot of the async parameter server (repro_torch.dist): the
    authoritative weights, the store version, the observed staleness sequence
    so far, plus — for rollback-capable stores — the
    optimizer accumulator `r` and the sentinel's current `lr_scale`, so a
    restored state resumes the exact optimizer trajectory. Same manifest
    format as the reference's chief snapshots, key for key."""
    d = {
        "W": np.asarray(W, np.float64),
        "version": np.asarray(version, np.int64),
        "staleness": np.asarray(staleness, np.int64),
        "lr_scale": np.asarray(lr_scale, np.float64),
    }
    if r is not None:
        d["r"] = np.asarray(r, np.float64)
    return {"dist": d}


def _dist_load(path: str, step) -> dict:
    """Decode one chief archive to {name: array}; corruption (truncated zip,
    bad CRC) surfaces as CorruptCheckpointError naming step and path."""
    try:
        data = np.load(path)
        out = {}
        for key in data.files:
            # keys look like ['dist']/['W']; strip the path syntax
            name = key.split("/")[-1].strip("[]'")
            out[name] = data[key]
        return out
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"chief snapshot step {step} at {path} cannot be read "
            f"({type(e).__name__}: {e}): the archive is corrupt or "
            f"truncated") from e


def dist_restore(ckpt_dir: str, step: int = None) -> dict:
    """Load a chief snapshot: {"W", "version", "staleness", ...} as numpy
    arrays (older archives may lack "r"/"lr_scale").

    With step=None this applies both reader-side disciplines of
    the reference's `npz.restore_latest`: re-read the manifest when the named step was pruned
    under us (retention race), and fall back through manifest history past
    entries whose SHA-256 or decode fails, to the newest intact step — the
    chief's rollback path (ParameterStore._rollback_locked) relies on this to
    never restore from a torn archive."""
    if step is not None:
        return _dist_load(step_path(ckpt_dir, step), step)
    for _ in range(8):
        entries = manifest_entries(ckpt_dir)
        if not entries:
            latest = latest_step(ckpt_dir)
            if latest is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
            entries = [{"step": latest,
                        "file": os.path.basename(step_path(ckpt_dir, latest))}]
        tried, raced = [], False
        for entry in entries:
            try:
                verify_entry(ckpt_dir, entry)
                return _dist_load(os.path.join(ckpt_dir, entry["file"]),
                                  entry["step"])
            except FileNotFoundError:
                raced = True  # pruned under us; re-read the manifest
                break
            except CorruptCheckpointError as e:
                tried.append(str(e))
        if raced:
            continue
        raise CorruptCheckpointError(
            f"no intact chief snapshot in {ckpt_dir}: every retained "
            f"manifest entry failed verification — " + " | ".join(tried))
    raise FileNotFoundError(
        f"chief snapshots in {ckpt_dir} kept vanishing across 8 "
        f"manifest reads; the dir is being deleted, not just pruned")
