"""Wire protocol of the async parameter server (`repro_torch.dist`), a copy
of `repro.dist.protocol`: the same verbs, framing and AUTHKEY, so a worker
of either package talks to a chief of either.

Transport is `multiprocessing.connection` over TCP: length-framed, pickled,
HMAC-authenticated (AUTHKEY) — the stdlib's process-to-process channel, so the
subsystem adds no dependency. Messages are plain tuples whose first element
is the verb:

  worker -> chief                         chief -> worker
  ("hello", wid|None)                     ("welcome", wid, meta)
  ("pull", wid)              [replay]     ("work", W, fetch_version, rows)
                                          | ("done",)
  ("push", wid, g, read_v)   [replay]     ("applied", staleness)
  ("step", wid, g|None,      [live]       ("work", W, version)
      read_v, rows|None,                  | ("done",)
      w_fetch|None)
  ("bye", wid)                            (connection closed)

`meta` carries everything a worker needs to run headless: the training shard
(Xtr, ytr), batch size, lr, its rng seed, the scenario's compute-time
topology + time scale, whether the chief's strategy needs the fetched params
shipped back (`need_fetch` — DC-ASGD / Gap-Aware compensate against W_stale),
and the execution mode. Workers are deliberately numpy-only (no torch):
gradient math is the literal `LogisticRegression` arithmetic
(repro_torch.dist.logreg), so a replay-mode run reproduces the train_ps/scan
trajectory to float64 round-off.

In replay mode `read_v` IS the scheduled fetch version the chief granted; in
live mode it is the version of the last server params the worker merged, and
the chief's `applied_version - read_v` is the *observed* staleness.
"""
from __future__ import annotations

import random
import socket
import time
from multiprocessing.connection import Client, Listener

# Shared secret for the HMAC challenge of multiprocessing.connection: this
# authenticates peers (no unpickling from strangers) for processes WE spawn
# on one host; multi-host deployments should rotate it via REPRO_DIST_AUTHKEY.
AUTHKEY = b"repro-dist-ps-v1"

DEFAULT_HOST = "127.0.0.1"


def parse_addr(addr: str) -> tuple:
    """'host:port' -> (host, int(port))."""
    host, _, port = addr.rpartition(":")
    return (host or DEFAULT_HOST, int(port))


def format_addr(addr: tuple) -> str:
    return f"{addr[0]}:{addr[1]}"


# Connections the kernel queues while the chief's one accept thread runs a
# handshake. multiprocessing's default is 1: with ten workers connecting at
# once, a full queue drops a handshake's last ACK, and a worker can be left
# for good in a connection the chief never sees, waiting for a challenge.
BACKLOG = 128


def listen(host: str = DEFAULT_HOST, port: int = 0, authkey: bytes = AUTHKEY) -> Listener:
    """Bind the chief's listener. port=0 picks an ephemeral port; the bound
    address is `listener.address`."""
    return Listener((host, port), family="AF_INET", backlog=BACKLOG, authkey=authkey)


def connect(addr: tuple, authkey: bytes = AUTHKEY, timeout: float = 20.0,
            backoff_base: float = 0.02, backoff_cap: float = 1.0):
    """Connect to the chief, retrying while it boots (worker processes race
    the listener's bind, and a respawned worker races the chief's recovery).

    Retries back off exponentially from `backoff_base` up to `backoff_cap`
    seconds with full jitter — a respawning fleet must not hammer the
    listener in lockstep. On timeout the last transport error is re-raised
    wrapped in a ConnectionError recording elapsed time and attempt count.
    """
    deadline = time.monotonic() + timeout
    start = time.monotonic()
    attempts = 0
    delay = backoff_base
    while True:
        try:
            return Client(addr, family="AF_INET", authkey=authkey)
        except (ConnectionRefusedError, socket.timeout, OSError) as e:
            attempts += 1
            now = time.monotonic()
            if now >= deadline:
                raise ConnectionError(
                    f"could not connect to chief at {format_addr(addr)} "
                    f"after {attempts} attempts over {now - start:.1f}s "
                    f"(last error: {type(e).__name__}: {e})") from e
            # full jitter: sleep U(0, delay], never past the deadline
            time.sleep(min(random.random() * delay + 1e-3, deadline - now))
            delay = min(delay * 2, backoff_cap)
