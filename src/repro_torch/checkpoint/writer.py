"""Checkpoint writers (port of `repro.checkpoint.writer`): the synchronous
`save_train_state` and the `AsyncCheckpointer`, serialization off the
caller's thread, atomic MANIFEST.json + retention.

  * `save(step, tree)` — caller thread — copies every tensor of the snapshot
    tree to the host (`npz._flatten`; `.cpu()` returns once the copy is
    done, so the next train step may update the live tensors in place as
    soon as `save` returns) and enqueues the flat archive;
  * a single background thread serializes (atomic tmp+rename npz), updates
    MANIFEST.json atomically with the archive's SHA-256, and prunes archives
    beyond `keep_last`.

MANIFEST.json records every retained step with its file and metadata, so a
reader never observes a pointer to a half-written archive and `latest_step`
survives any kill point. Writer errors are captured and re-raised on the
next save/wait/close — a full disk fails the run instead of silently
dropping snapshots.
"""
from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time

from repro_torch.checkpoint.npz import (
    MANIFEST,
    _flatten,
    file_sha256,
    read_manifest,
    write_archive,
)


def _write_manifest(ckpt_dir: str, man: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(man, f, indent=1)
        os.replace(tmp, os.path.join(ckpt_dir, MANIFEST))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _update_manifest(ckpt_dir: str, step: int, fname: str, meta: dict,
                     keep_last: int, sha256: str = None) -> None:
    """Append/replace the entry for `step`, advance `latest`, prune beyond
    `keep_last` (0 keeps everything). Called only from the writer thread (or
    the sync path), so updates are serialized. `sha256` is the archive's
    content hash (npz.file_sha256) recorded for restore-time verification."""
    man = read_manifest(ckpt_dir) or {"version": 2, "latest": None, "ckpts": []}
    man["ckpts"] = [c for c in man["ckpts"] if c["step"] != step]
    entry = {"step": step, "file": fname, "time": time.time(), "meta": meta}
    if sha256 is not None:
        entry["sha256"] = sha256
    man["ckpts"].append(entry)
    man["ckpts"].sort(key=lambda c: c["step"])
    pruned = []
    if keep_last and len(man["ckpts"]) > keep_last:
        pruned, man["ckpts"] = man["ckpts"][:-keep_last], man["ckpts"][-keep_last:]
    man["latest"] = man["ckpts"][-1]["step"]
    _write_manifest(ckpt_dir, man)
    for c in pruned:  # after the manifest no longer references them
        try:
            os.unlink(os.path.join(ckpt_dir, c["file"]))
        except FileNotFoundError:
            pass


def manifest_meta(ckpt_dir: str, step=None) -> dict:
    """Metadata recorded with `step` (default: the latest entry)."""
    man = read_manifest(ckpt_dir)
    if man is None or not man.get("ckpts"):
        raise FileNotFoundError(f"no {MANIFEST} with entries in {ckpt_dir}")
    if step is None:
        step = man["latest"]
    for c in man["ckpts"]:
        if c["step"] == step:
            return c.get("meta", {})
    raise ValueError(f"step {step} not in {ckpt_dir}/{MANIFEST}: "
                     f"retained steps {[c['step'] for c in man['ckpts']]}")


def save_train_state(ckpt_dir: str, step: int, tree, meta: dict = None,
                     keep_last: int = 0) -> str:
    """Synchronous full-state save: archive + manifest in the caller's
    thread, for one-off snapshots outside a training loop."""
    path = write_archive(ckpt_dir, step, _flatten(tree))
    _update_manifest(ckpt_dir, step, os.path.basename(path), dict(meta or {}),
                     keep_last, sha256=file_sha256(path))
    return path


class AsyncCheckpointer:
    """One writer thread + bounded handoff of host-side snapshots.

        ckpt = AsyncCheckpointer(dir, keep_last=3, meta={...})
        ckpt.save(step, snapshot(params, gstate, step))   # the host copy only
        ...
        ckpt.close()                     # drain + join

    `save` on a step already enqueued/written last is a no-op (the final save
    at loop exit dedupes against the last periodic one). The queue depth of 2
    bounds host memory to <= 3 snapshots in flight; if the disk can't keep up
    the training loop backpressures rather than ballooning RAM.
    """

    def __init__(self, ckpt_dir: str, keep_last: int = 3, meta: dict = None):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self.meta = dict(meta or {})
        os.makedirs(ckpt_dir, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._lock = threading.Lock()   # guards _err and _last_step
        self._err: BaseException | None = None
        self._last_step: int | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    # ------------------------------------------------------------- caller side

    def save(self, step: int, tree, block: bool = False) -> bool:
        """Snapshot `tree` as `step`. The copy to the host happens here
        (caller thread, step boundary); serialization happens on the writer
        thread. Returns False when deduped (same step as the previous
        save)."""
        self._raise_pending()
        with self._lock:
            if step == self._last_step:
                return False
            self._last_step = step
        flat = _flatten(tree)  # every tensor copied to the host before return
        self._q.put((step, flat))
        if block:
            self.wait()
        return True

    def wait(self) -> None:
        """Block until every enqueued snapshot is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the writer thread, re-raise any pending write error."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def _raise_pending(self):
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError(
                f"checkpoint writer failed for {self.ckpt_dir}") from err

    # ------------------------------------------------------------- writer side

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, flat = item
                path = write_archive(self.ckpt_dir, step, flat)
                _update_manifest(self.ckpt_dir, step, os.path.basename(path),
                                 self.meta, self.keep_last,
                                 sha256=file_sha256(path))
            except BaseException as e:  # surfaced on the caller's next call
                with self._lock:
                    self._err = e
            finally:
                self._q.task_done()
