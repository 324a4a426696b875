"""Checkpoint archives and their manifest: the on-disk format of
`repro.checkpoint.npz`, without JAX.

Layout: <dir>/step_<N>.npz, one `np.savez` archive per snapshot, its keys
the reference's pytree key paths (`['dist']/['W']`), so an archive written
by either package restores in the other. Which step is current is recorded
by the MANIFEST.json that `repro_torch.checkpoint.writer` writes (atomic,
with retention); `latest_step` also understands the v1 bare `LATEST` file.
Writes are atomic (tmp + rename).

Verification: every manifest entry records the archive's SHA-256 (`sha256`
key, hex); `verify_entry` recomputes and compares. Corruption surfaces as
`CorruptCheckpointError` (a ValueError) naming the step and path, so a
reader knows when falling back to an older step is sound.

The port's snapshots are flat dicts of arrays (`state.dist_snapshot`);
`_flatten` spells their keys as the reference's jax key paths. Mesh
snapshots (`save`, `restore`, `restore_latest`) are not ported yet.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

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


def _flatten(tree, prefix: str = "") -> dict:
    """{key path: np.ndarray} of a nested dict of arrays, the keys spelled as
    the reference's jax key paths (`['dist']/['W']`)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/['{k}']" if prefix else f"['{k}']"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


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
