"""Worker supervision (`repro_torch.resilience`), a copy of
`repro.resilience.supervisor` (DESIGN.md §14 has the state diagram).

Before this layer the only way a dead worker came back was a declarative
`Scenario` event that happened to say "restart" — a fault injector doubling
as the recovery path. The `Supervisor` makes recovery unconditional: a
polling thread owns the launcher's worker processes, detects death (process
exit, or a silent hang via heartbeat leases), respawns under capped
exponential backoff with jitter, and evicts a worker whose respawn streak
exhausts the budget — the run then finishes on whoever is still pushing.

Lease discipline (`LeaseTable`): every message a worker sends refreshes its
lease in the chief's connection thread; the supervisor treats a live process
with an expired lease as hung and kills it, which converts the hang into the
death path it already handles. Leases are opt-in (`spec.dist_lease_s`, 0 =
off) because wall-clock expiry on a loaded CI box would evict honest slow
workers; process-death detection is always on.

State machine per supervised worker (DESIGN.md §14 has the diagram):

    RUNNING --proc exit / lease expiry--> DOWN (streak += 1)
    DOWN --streak <= max_respawns, backoff elapsed--> RESPAWNED
    DOWN --streak >  max_respawns--> EVICTED (terminal)
    RESPAWNED --healthy (lease touch, or immediately without leases)-->
        RUNNING (streak resets, recovery time recorded)

Thread safety: `LeaseTable` has its own lock (touched from chief connection
threads); every mutable Supervisor attribute is guarded by `_lock`, shared
by the poll thread and the launcher's control calls. The only nesting is
Supervisor._lock -> LeaseTable._lock, so the lock order is acyclic.
"""
from __future__ import annotations

import random
import threading
import time


class LeaseTable:
    """Last-heartbeat table: chief connection threads `touch`, the
    supervisor asks `expired` / `touched_since`."""

    def __init__(self, lease_s: float):
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._last: dict = {}            # wid -> monotonic() of last message

    def touch(self, wid: int):
        with self._lock:
            self._last[wid] = time.monotonic()

    def drop(self, wid: int):
        with self._lock:
            self._last.pop(wid, None)

    def expired(self, wid: int, now: float = None) -> bool:
        """True when `wid` has a lease and it ran out (never-seen workers are
        NOT expired: they may still be connecting)."""
        if not self.lease_s:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last.get(wid)
        return last is not None and now - last > self.lease_s

    def touched_since(self, wid: int, t: float) -> bool:
        with self._lock:
            last = self._last.get(wid)
        return last is not None and last > t

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._last)


class Supervisor:
    """Owns the spawned worker processes of one live run and keeps them
    alive: respawn on death (capped exponential backoff + jitter), kill on
    lease expiry, evict after `max_respawns` consecutive failures.

        sup = Supervisor(spawn_fn, n_workers=2, max_respawns=3)
        sup.start()            # spawns the initial fleet + the poll thread
        ...
        sup.close()            # stop polling, kill + clean up every process

    `spawn_fn(wid)` returns a process handle with `alive()/kill()/cleanup()`
    (the launcher's `_WorkerProc`); `wid=None` spawns an elastic joiner.
    """

    def __init__(self, spawn_fn, n_workers: int, max_respawns: int = 3,
                 leases: LeaseTable = None, backoff_base: float = 0.05,
                 backoff_cap: float = 1.0, poll_s: float = 0.02,
                 seed: int = 0):
        self.spawn_fn = spawn_fn
        self.n_workers = int(n_workers)
        self.max_respawns = int(max_respawns)
        self.leases = leases
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.poll_s = float(poll_s)
        self._rng = random.Random(seed * 9973 + 17)
        self._lock = threading.Lock()      # guards every mutable attr below
        self._procs: dict = {}             # wid -> process handle
        self._extra: list = []             # elastic joiners (chief-owned wids)
        self._streak: dict = {}            # wid -> consecutive failures
        self._down_since: dict = {}        # wid -> monotonic() death detected
        self._respawn_at: dict = {}        # wid -> earliest respawn time
        self._heal_from: dict = {}         # wid -> (down_since, respawned_at)
        self._evicted: list = []           # terminal wids (stderr kept)
        self._respawns = 0
        self._expiries = 0                 # lease-expiry kills
        self._recoveries: list = []        # (wid, seconds death -> healthy)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dist-supervisor")

    # ------------------------------------------------------------- lifecycle

    def start(self):
        with self._lock:
            for wid in range(self.n_workers):
                self._procs[wid] = self.spawn_fn(wid)
        self._thread.start()

    def stop_polling(self):
        """Stop healing WITHOUT killing the fleet — the launcher calls this
        the moment the step budget is met, so workers exiting on 'done' are
        not mistaken for failures and respawned into a drained run."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def close(self):
        """Stop the poll thread, then kill and clean up every process (the
        launcher's finally — also the path that keeps `test_no_leaked_threads`
        honest)."""
        self.stop_polling()
        with self._lock:
            procs = list(self._procs.values()) + list(self._extra)
        for p in procs:
            if p.alive():
                p.kill()
            p.cleanup()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            self.poll()

    # ----------------------------------------------------------- supervision

    def _backoff(self, streak: int) -> float:
        base = min(self.backoff_cap, self.backoff_base * (2 ** (streak - 1)))
        return base * (1.0 + self._rng.random())   # full jitter: 1x..2x

    def poll(self, now: float = None):
        """One supervision pass (the poll thread's body; callable directly
        from tests). Detects deaths/expiries, respawns, records recoveries."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for wid in list(self._procs):
                if wid in self._evicted:
                    continue
                proc = self._procs[wid]
                if proc.alive():
                    if self.leases is not None and self.leases.expired(wid, now):
                        # hung, not dead: convert to the death path
                        self._expiries += 1
                        self.leases.drop(wid)
                        proc.kill()
                    elif wid in self._heal_from:
                        down, spawned = self._heal_from[wid]
                        if self.leases is None or \
                                self.leases.touched_since(wid, spawned):
                            self._recoveries.append((wid, now - down))
                            self._streak[wid] = 0
                            del self._heal_from[wid]
                    continue
                if wid not in self._down_since:
                    self._down_since[wid] = now
                    self._heal_from.pop(wid, None)
                    self._streak[wid] = self._streak.get(wid, 0) + 1
                    if self._streak[wid] > self.max_respawns:
                        self._evicted.append(wid)
                        continue
                    self._respawn_at[wid] = now + self._backoff(self._streak[wid])
                elif now >= self._respawn_at.get(wid, now):
                    proc.cleanup()
                    self._procs[wid] = self.spawn_fn(wid)
                    self._respawns += 1
                    self._heal_from[wid] = (self._down_since.pop(wid), now)
                    self._respawn_at.pop(wid, None)

    # ---------------------------------------------------- launcher control

    def kill(self, wid: int):
        """Fault injection: SIGKILL the process; the poll loop heals it."""
        with self._lock:
            if wid in self._procs:
                self._procs[wid].kill()

    def respawn_now(self, wid: int):
        """Scenario 'restart': deliberate kill + immediate replacement (no
        backoff, no streak — this is an injected op, not a failure)."""
        with self._lock:
            if wid in self._procs:
                self._procs[wid].kill()
                self._procs[wid].cleanup()
            self._procs[wid] = self.spawn_fn(wid)
            self._respawns += 1
            self._down_since.pop(wid, None)
            self._respawn_at.pop(wid, None)
            self._heal_from.pop(wid, None)

    def spawn_extra(self):
        """Scenario 'join': an elastic worker (chief assigns its wid); extras
        are drained and cleaned up but not respawned."""
        with self._lock:
            self._extra.append(self.spawn_fn(None))

    # -------------------------------------------------------------- queries

    def procs(self) -> list:
        with self._lock:
            return list(self._procs.values()) + list(self._extra)

    def stderr_tails(self, n: int = 5) -> dict:
        with self._lock:
            items = list(self._procs.items())
        return {w: p.stderr_tail(n) for w, p in items}

    def stats(self) -> dict:
        with self._lock:
            return {
                "respawns": self._respawns,
                "lease_expiries": self._expiries,
                "evicted": list(self._evicted),
                "recoveries": [(w, round(s, 4)) for w, s in self._recoveries],
            }
