"""The chief process: owns the `ParameterStore` and serves workers over TCP
(a copy of `repro.dist.chief`; the store applies on the card).

One accept thread + one thread per worker connection; every connection thread
funnels into the store's single lock, so applies are serialized (a parameter
server is sequential at the store) while gradient COMPUTATION runs in the
worker processes — the asynchrony the scan backend only simulates.

Worker lifecycle is connection-scoped: a dropped connection (kill -9, crash)
is recorded and tolerated; a reconnect with the same wid resumes that
worker's stream (restart), a hello without a wid is assigned the next free
id (elastic join). The chief never blocks on a dead worker in live mode —
the step budget is filled by whoever is still pushing.

Robustness: a malformed frame — unknown verb, wrong arity,
garbage payload — no longer kills the connection thread silently (leaving
the worker wedged in recv): it is counted in `store.bad_frames` and the
connection is dropped, so the worker dies with EOF and the supervisor
respawns it. Every message a worker sends refreshes its heartbeat lease
(when the launcher runs with `spec.dist_lease_s`), and `close()` reports
any connection thread that outlives its join timeout instead of leaking it
silently. A peer that drops during the authentication handshake does not
stop the accept thread.
"""
from __future__ import annotations

import threading
import warnings
from multiprocessing import AuthenticationError

import numpy as np

from repro_torch.dist import protocol
from repro_torch.dist.store import ParameterStore


class Chief:
    """Listener + connection threads around one ParameterStore."""

    def __init__(self, store: ParameterStore, meta: dict, host: str = protocol.DEFAULT_HOST,
                 port: int = 0, authkey: bytes = protocol.AUTHKEY,
                 leases=None, chaos_resets=()):
        self.store = store
        self.meta = meta
        self._authkey = authkey
        self.leases = leases                       # resilience.LeaseTable | None
        self._chaos_resets = tuple(chaos_resets)   # ((wid, at_version), ...)
        self.listener = protocol.listen(host, port, authkey)
        self.address = self.listener.address
        self._threads: list = []
        self._next_wid = int(meta.get("n_workers", 0))
        self._lock = threading.Lock()   # guards _next_wid/_threads/_fired/leaked
        self._fired_resets: set = set()
        self.leaked_threads: list = []  # populated by close() on leak
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dist-chief-accept", daemon=True)
        self._accept_thread.start()

    # ------------------------------------------------------------- lifecycle

    def _accept_loop(self):
        while True:
            try:
                conn = self.listener.accept()
            except (OSError, EOFError, AuthenticationError):
                if self._stop.is_set():
                    return  # listener closed
                # a peer that dropped or failed during the handshake (a worker
                # killed while connecting, a reset under load): keep
                # accepting, or every later connection, close()'s wake-up
                # included, waits forever for a challenge nobody sends
                continue
            if self._stop.is_set():
                conn.close()  # close()'s wake-up connection
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="dist-chief-conn", daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)

    def close(self, timeout: float = 5.0, strict: bool = False):
        """Stop accepting, join every thread, and REPORT stragglers: a
        connection thread that outlives `timeout` is recorded in
        `leaked_threads` and warned about (raised with strict=True) — a
        silent leak here is a wedged worker connection nobody notices until
        `test_no_leaked_threads` does."""
        self._stop.set()
        # closing a listener does NOT reliably unblock an accept() parked in
        # another thread; a throwaway connection is the portable wake-up, so
        # the accept thread can observe _stop and exit instead of leaking
        try:
            protocol.connect(self.address, self._authkey, timeout=1.0).close()
        except Exception:  # refused/auth/EOF — thread already gone, fine
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=timeout)
        with self._lock:
            threads = list(self._threads)
        for t in threads:     # join outside the lock: _serve threads take it
            t.join(timeout=timeout)
        leaked = [t.name for t in [self._accept_thread] + threads
                  if t.is_alive()]
        if leaked:
            with self._lock:
                self.leaked_threads = list(leaked)
            msg = (f"Chief.close() leaked {len(leaked)} unjoined thread(s) "
                   f"after {timeout:.1f}s joins: {leaked} — a connection "
                   f"thread is wedged (worker stuck mid-recv?)")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)

    def _assign_wid(self, requested):
        if requested is not None:
            return int(requested)
        with self._lock:
            wid = self._next_wid
            self._next_wid += 1
        self.store.record_join()  # outside _lock: never nest it with cond
        return wid

    # --------------------------------------------------------------- serving

    def _reset_due(self, wid) -> bool:
        """True once per (wid, at_version) chaos entry when the store reached
        `at_version`: the connection thread then drops the link mid-stream."""
        if not self._chaos_resets:
            return False
        v = self.store.progress()   # before _lock: never nest it with cond
        with self._lock:
            for i, (w, at_v) in enumerate(self._chaos_resets):
                if w == wid and v >= at_v and i not in self._fired_resets:
                    self._fired_resets.add(i)
                    return True
        return False

    def _check_gradient(self, g):
        """Reject garbage payloads before they reach the store: a gradient
        must be None or array-like of the parameter shape."""
        if g is None:
            return
        arr = np.asarray(g)
        if arr.dtype == object or arr.shape != self.store.shape:
            raise ValueError(
                f"gradient payload has shape {arr.shape}/dtype {arr.dtype}, "
                f"expected {self.store.shape} float")

    def _serve(self, conn):
        store = self.store
        wid = None
        try:
            verb, requested = conn.recv()
            if verb != "hello":
                store.record_bad_frame(wid, ValueError(f"expected hello, got {verb!r}"))
                return
            wid = self._assign_wid(requested)
            if self.leases is not None:
                self.leases.touch(wid)
            conn.send(("welcome", wid, self.meta))
            while True:
                msg = conn.recv()
                if self.leases is not None:
                    self.leases.touch(wid)
                if self._reset_due(wid):
                    store.record_reset()
                    return   # drop the link: worker sees EOF, supervisor heals
                try:
                    verb = msg[0]
                    if verb == "pull":
                        grant = store.replay_pull(wid)
                        if grant is None:
                            conn.send(("done",))
                        else:
                            W, fetch_v, rows = grant
                            conn.send(("work", W, fetch_v, rows))
                    elif verb == "push":
                        _, _, g, read_v = msg
                        self._check_gradient(g)
                        conn.send(("applied", store.replay_push(wid, g, read_v)))
                    elif verb == "step":
                        _, _, g, read_v, rows, w_fetch = msg
                        self._check_gradient(g)
                        out = store.live_step(wid, g, read_v, rows, w_fetch)
                        conn.send(("done",) if out is None else ("work",) + out)
                    elif verb == "bye":
                        break
                    else:
                        raise ValueError(f"unknown verb {verb!r} from worker {wid}")
                except (EOFError, ConnectionResetError, BrokenPipeError, OSError):
                    raise      # transport death: the outer handler counts it
                except Exception as e:
                    # malformed frame (unknown verb, bad arity, garbage
                    # payload): count it and drop the connection — the worker
                    # dies with EOF and supervision takes over, instead of
                    # this thread dying silently with the worker wedged
                    store.record_bad_frame(wid, e)
                    return
        except (EOFError, ConnectionResetError, BrokenPipeError, OSError):
            # worker died mid-stream (kill/crash): tolerated, counted
            store.record_worker_exit()
        finally:
            if self.leases is not None and wid is not None:
                self.leases.drop(wid)
            try:
                conn.close()
            except OSError:
                pass
