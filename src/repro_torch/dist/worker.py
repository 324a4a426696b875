"""Worker process: `python -m repro_torch.dist.worker --addr host:port [--wid N]`
(a copy of `repro.dist.worker`).

Pure numpy gradient computation (the literal `LogisticRegression.grad`
arithmetic, shared via `repro_torch.dist.logreg.grad`) — a worker imports
neither torch nor jax, so replay-mode runs reproduce the float64 reference
trajectory and process startup stays cheap. Everything a worker needs
arrives in the chief's `welcome` meta: the training set, batch size, lr, its
rng seed, the compute-time topology, and the execution mode.

Two loops:

  * replay — request/compute/push against the chief's scheduled grants. The
    chief decides which batch, at which fetch version; the worker's only job
    is to really compute the gradient in its own process.
  * live — free-running ASGD: sample a batch from this worker's strided
    shard, optionally sleep a sampled compute time (topology * time_scale,
    the fault injector's per-worker slowdown knob), push with the read
    version of the params the gradient was computed at. With
    `delayed_avg` (DaSGD-style) the worker overlaps the push RTT with the
    NEXT gradient at its optimistically-updated local params, then merges
    the server reply: W = (W_local + W_server) / 2. Each gradient carries
    the read version current AT ITS COMPUTE TIME, so observed staleness
    stays honest under the overlap.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from repro_torch.dist import protocol
from repro_torch.dist.logreg import _aug, grad


def _sample_rows(shard, bs, rng):
    replace = len(shard) < bs
    return np.asarray(rng.choice(shard, size=bs, replace=replace), np.int32)


def _chaos_at(chaos: dict, kind: str, wid: int):
    """Version threshold at which fault `kind` fires for this worker, or None.
    Keys may arrive as str or int depending on how the plan was serialized."""
    table = chaos.get(kind) or {}
    for k, v in table.items():
        if int(k) == wid:
            return int(v)
    return None


def run_replay(conn, wid: int, meta: dict):
    Xa = _aug(np.asarray(meta["Xtr"], np.float64))
    y = np.asarray(meta["ytr"])
    while True:
        conn.send(("pull", wid))
        msg = conn.recv()
        if msg[0] == "done":
            break
        _, W, fetch_v, rows = msg
        g = grad(W, Xa[rows], y[rows])
        conn.send(("push", wid, g, fetch_v))
        conn.recv()  # ("applied", staleness)
    conn.send(("bye", wid))


def run_live(conn, wid: int, meta: dict):
    from repro_torch.common.topologies import compute_time_sampler

    Xa = _aug(np.asarray(meta["Xtr"], np.float64))
    y = np.asarray(meta["ytr"])
    bs = meta["bs"]
    lr = meta["lr"]
    need_fetch = meta["need_fetch"]
    delayed_avg = meta["delayed_avg"]
    time_scale = meta["time_scale"]
    sampler = compute_time_sampler(meta["topology"])
    shard = np.arange(wid % max(meta["n_workers"], 1), len(y), max(meta["n_workers"], 1))
    rng = np.random.default_rng(meta["seed"] * 9973 + wid)

    # chaos injections (repro_torch.chaos): thresholds are store versions, so the
    # faults fire mid-run, after the sentinel's norm EMA has warmed up
    chaos = meta.get("chaos") or {}
    nan_at = _chaos_at(chaos, "nan_grad", wid)
    boom_at = _chaos_at(chaos, "boom_grad", wid)
    corrupt_at = _chaos_at(chaos, "corrupt_frame", wid)
    corrupt_fired = False

    def compute(W, read_v):
        rows = _sample_rows(shard, bs, rng)
        if time_scale:
            time.sleep(sampler(wid, rng) * time_scale)
        return grad(W, Xa[rows], y[rows]), rows, W, read_v

    # bootstrap pull
    conn.send(("step", wid, None, 0, None, None))
    msg = conn.recv()
    if msg[0] == "done":
        conn.send(("bye", wid))
        return
    _, W, read_v = msg
    pending = None
    while True:
        g, rows, w_at, rv = pending if pending is not None else compute(W, read_v)
        pending = None
        if nan_at is not None and rv >= nan_at:
            g = g + np.nan        # sick worker: every push non-finite
        elif boom_at is not None and rv >= boom_at:
            g = g * 1e12          # finite but divergent: slips a finite-only
            #                       screen, trips the DivergenceDetector
        if corrupt_at is not None and not corrupt_fired and rv >= corrupt_at:
            corrupt_fired = True
            conn.send((b"\xde\xad", wid))   # garbage frame, not a verb
            conn.recv()   # chief drops the link -> EOFError -> process dies
        conn.send(("step", wid, g, rv, rows, w_at if need_fetch else None))
        if delayed_avg:
            # optimistic local step, then overlap the RTT with the next grad
            W = W - lr * g
            pending = compute(W, read_v)
        msg = conn.recv()
        if msg[0] == "done":
            break
        _, W_srv, v = msg
        W = 0.5 * (W + W_srv) if delayed_avg else W_srv
        read_v = v
    conn.send(("bye", wid))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="repro_torch.dist worker process")
    ap.add_argument("--addr", required=True, help="chief address host:port")
    ap.add_argument("--wid", type=int, default=None,
                    help="worker id (omit to join elastically)")
    args = ap.parse_args(argv)

    authkey = os.environ.get("REPRO_DIST_AUTHKEY", "").encode() or protocol.AUTHKEY
    conn = protocol.connect(protocol.parse_addr(args.addr), authkey=authkey)
    try:
        conn.send(("hello", args.wid))
        verb, wid, meta = conn.recv()
        if verb != "welcome":
            raise RuntimeError(f"expected welcome, got {verb!r}")
        if meta["mode"] == "replay":
            run_replay(conn, wid, meta)
        else:
            run_live(conn, wid, meta)
    finally:
        try:
            conn.close()
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
