"""Checkpoint archives and their manifest: the on-disk format of
`repro.checkpoint.npz`, without JAX.

Layout: <dir>/step_<N>.npz, one `np.savez` archive per snapshot, its keys
the reference's pytree key paths, so an archive written by either package
restores in the other. A key path spells a dict key `['name']`, a
NamedTuple field `.name` (a `GuidedState`'s) and a sequence index `[i]`,
joined by "/"; an empty tuple or None (an unused `w_stale` or `extra`) has
no key at all. numpy has no bfloat16: a bf16 tensor is written as float32
(exact, every bf16 value is an f32 value) and cast back on restore. A host
int (the port's `GuidedState.step`, adam's `t`) is written as int32 () and
read back as an int.

Which step is current is recorded by the MANIFEST.json that
`repro_torch.checkpoint.writer` writes (atomic, with retention); the v1
`save` writes the bare `LATEST` pointer instead, which `latest_step` still
understands. Writes are atomic (tmp + rename).

Restore goes leaf by leaf from the lazily loaded archive straight into the
template's tensors (`copy_` on their device), so neither the whole archive
in host memory nor a second copy of the state on the card is ever held.

Verification: every manifest entry records the archive's SHA-256 (`sha256`
key, hex); `verify_entry` recomputes and compares; `restore_latest` verifies
before restoring and falls back through the manifest's history past corrupt
archives to the newest intact step. Corruption surfaces as
`CorruptCheckpointError` (a ValueError) naming the step and path; a template
mismatch stays a plain ValueError and does not fall back: an older snapshot
of the wrong config is not a recovery.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
import torch

MANIFEST = "MANIFEST.json"


class CorruptCheckpointError(ValueError):
    """An archive that cannot be trusted: checksum mismatch, truncated or
    undecodable npz. Distinct from a template mismatch (plain ValueError) so
    a reader knows when falling back to an older step is sound."""


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key path part, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if tree is None:
        return []
    return None


def _items(tree, prefix: str = ""):
    """(key path, leaf) pairs of `tree`, depth first."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for part, child in kids:
        yield from _items(child, f"{prefix}/{part}" if prefix else part)


def _map(fn, tree, prefix: str = ""):
    """`tree` with every leaf replaced by fn(key path, leaf)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [_map(fn, child, f"{prefix}/{part}" if prefix else part) for part, child in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    if _is_namedtuple(tree):
        return type(tree)(*out)
    if tree is None:
        return None
    return type(tree)(out)


def _to_numpy(leaf) -> np.ndarray:
    """One leaf as the archive stores it: a tensor copied to the host (a copy
    on the CPU too, never a view of the live tensor; bf16 widened to f32
    there, on the host), a host int as int32 ()."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            host = host.float()
        return host.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    """{key path: np.ndarray} of a snapshot tree, the keys spelled as the
    reference's jax key paths. Tensors are copied to the host here, on the
    caller's thread: the copy has finished when this returns, so a later
    in-place update of the live tensors cannot reach the snapshot."""
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def write_archive(ckpt_dir: str, step: int, flat: dict) -> str:
    """Atomically write an already-flattened {key: np.ndarray} archive."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, step)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_manifest(ckpt_dir: str) -> dict | None:
    p = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def latest_step(ckpt_dir: str):
    """Newest checkpointed step: MANIFEST.json when present (the v2 atomic
    manifest), falling back to the v1 bare LATEST file. None if neither."""
    man = read_manifest(ckpt_dir)
    if man is not None:
        return man.get("latest")
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def manifest_entries(ckpt_dir: str) -> list:
    """Manifest entries newest-first ([] when there is no manifest)."""
    man = read_manifest(ckpt_dir)
    if man is None:
        return []
    return sorted(man.get("ckpts", []), key=lambda c: c["step"], reverse=True)


def verify_entry(ckpt_dir: str, entry: dict) -> None:
    """Recompute an entry's archive SHA-256 against the manifest record.
    Entries written before checksums were recorded pass vacuously; a
    mismatch raises CorruptCheckpointError naming the step and path."""
    want = entry.get("sha256")
    if want is None:
        return
    path = os.path.join(ckpt_dir, entry["file"])
    got = file_sha256(path)
    if got != want:
        raise CorruptCheckpointError(
            f"checkpoint step {entry['step']} at {path} fails its manifest "
            f"checksum (sha256 {got[:12]} != recorded {want[:12]}): the "
            f"archive is corrupt or truncated")


def save(ckpt_dir: str, step: int, tree) -> str:
    """Low-level synchronous save of one tree (v1 API). Keeps writing the
    legacy LATEST pointer; full-state training snapshots go through
    `repro_torch.checkpoint.writer`, which maintains MANIFEST.json instead."""
    path = write_archive(ckpt_dir, step, _flatten(tree))
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return path


def restore_latest(ckpt_dir: str, tree_like, attempts: int = 8):
    """Restore the newest INTACT snapshot, racing safely against retention.

    Two reader-side disciplines compose here:

      * retention race — the writer updates MANIFEST.json *before* unlinking
        a pruned archive, so a reader can never be pointed at a file about
        to disappear; a reader whose manifest read lost the race simply
        re-reads it (up to `attempts` times) and sees the retained step.
      * verification fallback — each candidate entry's SHA-256 is checked
        before the restore; a corrupt/truncated archive is skipped and the
        next-older manifest entry tried, down to the oldest retained step.

    Returns `(step, tree)`. Raises FileNotFoundError when the dir has no
    checkpoints (or keeps vanishing — a deleted dir, not a race) and
    CorruptCheckpointError when every retained entry fails verification.
    Template mismatches (plain ValueError) propagate immediately.
    """
    last = None
    for _ in range(attempts):
        entries = manifest_entries(ckpt_dir)
        if not entries:
            # v1 dir: a bare LATEST pointer names the single candidate
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
            entries = [{"step": step,
                        "file": os.path.basename(step_path(ckpt_dir, step))}]
        tried, raced = [], False
        for entry in entries:
            step = entry["step"]
            try:
                verify_entry(ckpt_dir, entry)
                return step, restore(ckpt_dir, step, tree_like)
            except FileNotFoundError as e:
                # pruned under us; the next manifest read sees its
                # replacement (manifest-before-unlink ordering in the writer)
                last, raced = e, True
                break
            except CorruptCheckpointError as e:
                tried.append(str(e))
        if raced:
            continue
        raise CorruptCheckpointError(
            f"no intact checkpoint in {ckpt_dir}: every retained manifest "
            f"entry failed verification — " + " | ".join(tried))
    raise FileNotFoundError(
        f"checkpoint archives in {ckpt_dir} kept vanishing across "
        f"{attempts} manifest reads (last: {last}); the dir is being "
        f"deleted, not just pruned")


def _mismatch_error(path: str, missing, unexpected, n_template: int, n_archive: int):
    def fmt(keys):
        keys = sorted(keys)
        head = ", ".join(keys[:8])
        return head + (f", ... ({len(keys)} total)" if len(keys) > 8 else "")

    parts = [f"checkpoint {path} does not match the restore template "
             f"({n_template} template leaves vs {n_archive} archived arrays)"]
    if missing:
        parts.append(f"missing from archive: {fmt(missing)}")
    if unexpected:
        parts.append(f"unexpected in archive: {fmt(unexpected)}")
    parts.append("was this checkpoint written by a different model/strategy/"
                 "optimizer configuration?")
    return ValueError("; ".join(parts))


def _open(path: str, step):
    """The archive, loaded lazily; an undecodable one raises
    CorruptCheckpointError naming the step and path."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint archive at {path}")
    try:
        return np.load(path)
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint step {step} at {path} cannot be read "
            f"({type(e).__name__}: {e}): the archive is corrupt or "
            f"truncated") from e


def _read(data, path: str, step, key: str) -> np.ndarray:
    try:
        return data[key]
    except Exception as e:
        # a flipped byte inside an entry surfaces here as a CRC/zlib error
        raise CorruptCheckpointError(
            f"checkpoint step {step} at {path}: entry {key!r} cannot be "
            f"decoded ({type(e).__name__}: {e}): the archive is corrupt "
            f"or truncated") from e


def _into(leaf, arr: np.ndarray, path: str, key: str, hint: str = ""):
    """Archived `arr` restored as template `leaf`: copied into the leaf's
    tensor on its device (cast on the host first: f32 -> bf16 is exact for
    values a bf16 tensor wrote), an int for an int, else numpy in the
    leaf's dtype."""
    shape = getattr(leaf, "shape", None)
    if shape is not None and tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has shape {tuple(arr.shape)} "
            f"but the restore template expects {tuple(shape)}{hint}")
    if isinstance(leaf, torch.Tensor):
        with torch.no_grad():
            leaf.copy_(torch.as_tensor(arr).to(leaf.dtype))
        return leaf
    if isinstance(leaf, int):
        return int(arr)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr).astype(leaf.dtype)
    return arr


def restore(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of `tree_like`: its tensors are written in
    place (so it must be a fresh template, e.g. a `state.snapshot` of a
    freshly initialized train state) and returned in the same tree.

    Tree/archive mismatches raise ValueError naming the missing and
    unexpected keys, so a checkpoint written by a different config fails
    with an actionable message. Archives that cannot be decoded raise
    CorruptCheckpointError naming the step and path."""
    path = step_path(ckpt_dir, step)
    with _open(path, step) as data:
        archived = set(data.files)
        keys = [k for k, _ in _items(tree_like)]
        missing = [k for k in keys if k not in archived]
        unexpected = sorted(archived - set(keys))
        if missing or unexpected:
            raise _mismatch_error(path, missing, unexpected, len(keys), len(archived))
        return _map(lambda key, leaf: _into(leaf, _read(data, path, step, key), path, key),
                    tree_like)
