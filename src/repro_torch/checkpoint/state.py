"""Full-state training snapshots and the chief's snapshots (port of
`repro.checkpoint.state`).

A checkpoint of the mesh trainer is not just the parameters: the guided
compensation is stateful — consistency scores accumulated over the current
rho-window, the `w_stale` copy the ASGD staleness model compensates against,
the inner optimizer accumulators and any strategy-owned `extra`. A snapshot
therefore covers

    {"params": <model tree>,
     "gstate": <GuidedState: step, score, prev losses, w_stale, opt_state, extra>,
     "data":   {"cursor": <batches consumed>}}

and its archive keys are the reference's (`['gstate']/.opt_state/['m']/...`),
so a snapshot written by either package restores in the other. The data
cursor is the stream position: the synthetic corpus is a deterministic
function of (seed, number of draws), so replaying `cursor` draws on resume
reproduces the batches exactly.

The chief's snapshot (`dist_snapshot`) is a flat dict of host arrays under
one "dist" entry: the authoritative weights, the store version, the
observed staleness sequence, and for rollback-capable stores the optimizer
accumulator and the current lr scale.

The reference's `train_state_shardings` (restore onto another mesh) waits
for sharding (ROADMAP Queue 1 item 11): the port restores onto one device.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.checkpoint.npz import (
    CorruptCheckpointError,
    _into,
    _items,
    _map,
    _open,
    _read,
    latest_step,
    manifest_entries,
    restore,
    step_path,
    verify_entry,
)


def snapshot(params, gstate, cursor: int) -> dict:
    """The canonical full-state snapshot tree (also the restore template:
    build it from a freshly initialized train state and restore into it)."""
    return {
        "params": params,
        "gstate": gstate,
        "data": {"cursor": np.asarray(cursor, np.int64)},
    }


def spec_meta(spec) -> dict:
    """Manifest metadata recorded next to every snapshot — enough to rebuild
    the model config (ServeEngine.from_checkpoint) and to see what run a
    checkpoint dir belongs to."""
    return {
        "arch": spec.arch,
        "reduced": spec.reduced,
        "model_overrides": [list(kv) for kv in spec.model_overrides],
        "mode": spec.mode,
        "strategy": spec.strategy,
        "optimizer": spec.optimizer,
        "seed": spec.seed,
        "steps": spec.steps,
    }


def model_config_from_manifest(ckpt_dir: str, step: int = None):
    """Rebuild the ModelConfig a snapshot was trained under from the manifest
    metadata (`spec_meta`), through the port's `configs.get_config` (which
    raises for an arch the port does not have). Raises if the manifest
    records no arch (e.g. a hand-written dir)."""
    from repro_torch.checkpoint.writer import manifest_meta
    from repro_torch.configs import get_config

    meta = manifest_meta(ckpt_dir, step)
    if "arch" not in meta:
        raise ValueError(
            f"checkpoint manifest in {ckpt_dir} records no arch metadata; "
            f"pass the model config explicitly")
    cfg = get_config(meta["arch"])
    if meta.get("reduced"):
        cfg = cfg.reduced()
    overrides = meta.get("model_overrides") or []
    if overrides:
        cfg = cfg.replace(**{k: v for k, v in overrides})
    return cfg


def restore_train_state(ckpt_dir: str, step: int, template: dict) -> dict:
    """Restore a full snapshot into `template` (a `snapshot()` of a freshly
    initialized train state, whose tensors are written in place)."""
    return restore(ckpt_dir, step, template)


def restore_subtree(ckpt_dir: str, step: int, entry: str, template):
    """Restore ONE top-level entry of a snapshot archive (e.g. entry="params"
    into a model tree, written in place) without reading the rest — how a
    serving process warm-starts from a training checkpoint. Also accepts v1
    archives that stored `{entry: tree}` directly (the key paths coincide)."""
    path = step_path(ckpt_dir, step)
    prefix = f"[{entry!r}]"
    with _open(path, step) as data:
        available = set(data.files)
        keys = {rest: f"{prefix}/{rest}" if rest else prefix for rest, _ in _items(template)}
        missing = sorted(k for k in keys.values() if k not in available)
        if missing:
            have = sorted(k for k in available if k.startswith(prefix))[:8]
            raise ValueError(
                f"checkpoint {path} has no {entry!r} subtree matching the template: "
                f"missing {missing[:8]}; archive has {have or 'no such keys'}")
        hint = " — was this snapshot written under a different model config?"
        return _map(lambda rest, leaf: _into(leaf, _read(data, path, step, keys[rest]), path,
                                              keys[rest], hint), template)


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
