"""Launcher of the async parameter-server backend (`backend="dist"`), a copy
of `repro.dist.launcher` whose chief applies on `device` (the card unless the
caller asks for the CPU).

`run_local(spec, X, y, ...)` is the single-call orchestration the Trainer
facade dispatches to: it prepares data + schedule with the SAME rng protocol
as train_ps/scan (`prepare_run`), builds the chief (store + TCP listener) in
this process, spawns N real worker processes
(`python -m repro_torch.dist.worker`, the port's `src` root on their
PYTHONPATH),
drives the fault scenario against the store's version counter, and assembles
a result dict with the scan backend's contract plus the dist observability
(observed staleness sequence/histogram, drop/exit/join counters).

Worker processes are monitored, not trusted: replay mode (the deterministic
parity oracle) treats an unexpected worker death as fatal — the schedule
cannot complete without it — while live mode absorbs it and the watchdog only
fires if the VERSION counter stalls for `spec.dist_timeout` seconds (i.e.
nobody is pushing anymore). Worker stderr is captured to per-worker temp
files and surfaced in the failure message, not interleaved with the chief's.

Self-healing: live spawned runs hand their processes to a
`repro_torch.resilience.Supervisor` — death (or a heartbeat-lease expiry, with
`spec.dist_lease_s`) triggers respawn under capped exponential backoff, and
persistent failures are evicted. `spec.sentinel`/`spec.rollback` arm the
store's gradient screen and divergence rollback; an unrecoverable store
(`store.fatal_error()`) fails the run here, in the launcher's thread, with
the store's diagnosis. A `repro_torch.chaos.ChaosPlan` drives deterministic fault
injection through the same seams (`chaos=` argument).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.common.topologies import TOPOLOGY_SAMPLERS
from repro_torch.core.parameter_server import LogisticRegression, prepare_run
from repro_torch.dist import protocol
from repro_torch.dist.chief import Chief
from repro_torch.dist.scenarios import Scenario
from repro_torch.dist.store import ParameterStore
from repro_torch.resilience import LeaseTable, SentinelPolicy, Supervisor

#: the directory to put on the workers' PYTHONPATH (the parent of `repro_torch`)
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _worker_env() -> dict:
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    if SRC_ROOT not in pp.split(os.pathsep):
        env["PYTHONPATH"] = SRC_ROOT + (os.pathsep + pp if pp else "")
    return env


class _WorkerProc:
    """One spawned worker process + its captured stderr."""

    def __init__(self, wid, addr: str, env: dict):
        self.wid = wid
        self.errfile = tempfile.NamedTemporaryFile(
            mode="w+", suffix=f".dist-worker-{'new' if wid is None else wid}.err",
            delete=False)
        cmd = [sys.executable, "-m", "repro_torch.dist.worker", "--addr", addr]
        if wid is not None:
            cmd += ["--wid", str(wid)]
        self.proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                     stderr=self.errfile)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self):
        if self.alive():
            self.proc.kill()
        self.proc.wait()

    def stderr_tail(self, n: int = 20) -> str:
        try:
            self.errfile.flush()
            with open(self.errfile.name) as f:
                lines = f.readlines()
            return "".join(lines[-n:])
        except OSError:
            return "<stderr unavailable>"

    def cleanup(self):
        try:
            self.errfile.close()
            os.unlink(self.errfile.name)
        except OSError:
            pass


def run_local(spec, X, y, n_classes: int, Xtest=None, ytest=None,
              strategy=None, spawn: bool = True, port: int = 0,
              chaos=None, device="cuda") -> dict:
    """Run `spec` as a real multi-process async parameter server. Same result
    contract as delaysim.run (train/val losses, history, model, schedule,
    n_steps) plus: staleness_seq, staleness_hist, and a `dist` diagnostics
    dict (drops, late, worker_exits, joins, n_workers, mode, and — when the
    resilience layer is armed — rejections/rollbacks/supervisor counters).

    spawn=False runs the chief only (`--role chief`): the listener address is
    printed and externally launched `repro_torch.dist.worker` processes
    connect to it — lifecycle events that target spawned processes are then
    skipped. `device` holds the chief's state and runs its applies.

    `chaos` takes a `repro_torch.chaos.ChaosPlan` (live mode only): deterministic
    fault injection through the launcher (kills, checkpoint truncation), the
    chief (connection resets) and the workers (NaN/exploding gradients,
    garbage frames)."""
    if strategy is None:
        from repro_torch.engine.strategies import get_compensator

        strategy = get_compensator(spec.strategy, spec.to_guided_config())
    topology = spec.resolved_topology
    try:
        sampler = TOPOLOGY_SAMPLERS[topology]
    except KeyError:
        raise KeyError(
            f"unknown topology {topology!r}; known: {', '.join(TOPOLOGY_SAMPLERS)}"
        ) from None

    W0, train, val, schedule = prepare_run(
        X, y, n_classes, spec.to_schedule_config(),
        delay_sampler=sampler, topology=topology)
    T = schedule.n_steps
    if T == 0:
        return _empty_result(spec, W0, train, val, schedule, Xtest, ytest)

    replay = spec.dist_mode == "replay"
    scenario = Scenario.from_spec(spec)
    n_workers = schedule.n_workers if replay else (spec.workers or schedule.n_workers)

    checkpointer = None
    if spec.ckpt_dir:
        checkpointer = AsyncCheckpointer(
            spec.ckpt_dir, keep_last=spec.keep_last,
            meta={"backend": "dist", "mode": spec.mode, "strategy": spec.strategy,
                  "seed": spec.seed, "dist_mode": spec.dist_mode})

    policy = None
    if not replay:
        policy = SentinelPolicy.from_spec(spec)
        if not (policy.screening or policy.rollback):
            policy = None

    store = ParameterStore(
        spec, strategy, W0, train, val, total_steps=T,
        schedule=schedule if replay else None,
        drop_rate=scenario.drop_rate, seed=spec.seed,
        checkpointer=checkpointer, ckpt_every=spec.ckpt_every,
        policy=policy, device=device)

    meta = {
        "Xtr": np.asarray(train[0], np.float64),
        "ytr": np.asarray(train[1]),
        "bs": spec.batch_size,
        "lr": spec.lr,
        "seed": spec.seed,
        "mode": spec.dist_mode,
        "need_fetch": store.need_fetch,
        "delayed_avg": spec.delayed_avg,
        "topology": topology,
        "time_scale": scenario.time_scale,
        "n_workers": n_workers,
    }
    chaos_resets = ()
    chaos_kills: dict = {}
    truncate_at = None
    if chaos is not None and not replay:
        wm = chaos.worker_meta()
        if wm:
            meta["chaos"] = wm
        chaos_resets = chaos.reset_events()
        chaos_kills = dict(chaos.kill_events())
        truncate_at = chaos.truncate_at

    supervise = spawn and not replay and spec.dist_supervise
    leases = LeaseTable(spec.dist_lease_s) \
        if supervise and spec.dist_lease_s else None
    chief = Chief(store, meta, port=port, leases=leases,
                  chaos_resets=chaos_resets)
    addr = protocol.format_addr(chief.address)
    env = _worker_env()

    if not spawn:
        print(f"dist chief listening on {addr} "
              f"(workers: PYTHONPATH=src python -m repro_torch.dist.worker --addr {addr})",
              flush=True)
    sup = None
    procs: dict = {}
    if supervise:
        sup = Supervisor(lambda wid: _WorkerProc(wid, addr, env), n_workers,
                         max_respawns=spec.dist_max_respawns, leases=leases,
                         seed=spec.seed)
        sup.start()
    elif spawn:
        procs = {w: _WorkerProc(w, addr, env) for w in range(n_workers)}
    extra: list = []      # elastically joined workers (wid assigned by chief)
    fired = 0
    try:
        last_v, last_move = store.progress(), time.monotonic()
        while not store.done():
            fatal = store.fatal_error()
            if fatal is not None:
                raise RuntimeError(str(fatal))
            v = store.progress()
            if v != last_v:
                last_v, last_move = v, time.monotonic()
            for op, wid, _at in scenario.due(fired, v):
                fired += 1
                if op == "kill":
                    if sup is not None:
                        sup.kill(wid)
                    elif wid in procs:
                        procs[wid].kill()
                elif op == "restart":
                    if sup is not None:
                        sup.respawn_now(wid)
                    else:
                        if wid in procs:
                            procs[wid].kill()
                            procs[wid].cleanup()
                        procs[wid] = _WorkerProc(wid, addr, env)
                elif op == "join":
                    if sup is not None:
                        sup.spawn_extra()
                    else:
                        extra.append(_WorkerProc(None, addr, env))
            for wid in [w for w, at in chaos_kills.items() if v >= at]:
                del chaos_kills[wid]
                if sup is not None:
                    sup.kill(wid)
                elif wid in procs:
                    procs[wid].kill()
            if truncate_at is not None and v >= truncate_at and spec.ckpt_dir:
                from repro_torch.chaos import truncate_newest

                # retries until an archive exists to tear, then disarms
                if truncate_newest(spec.ckpt_dir) is not None:
                    truncate_at = None
            if replay:
                dead = [w for w, p in procs.items() if not p.alive()]
                if dead and not store.done():
                    w = dead[0]
                    raise RuntimeError(
                        f"replay worker {w} exited before its schedule drained "
                        f"(version {v}/{T}); stderr tail:\n{procs[w].stderr_tail()}")
            if time.monotonic() - last_move > spec.dist_timeout:
                tails = sup.stderr_tails(5) if sup is not None else \
                    {w: p.stderr_tail(5) for w, p in procs.items()}
                raise RuntimeError(
                    f"dist run stalled at version {v}/{T} for "
                    f"{spec.dist_timeout:.0f}s (mode={spec.dist_mode}); "
                    f"worker stderr tails: {tails}")
            time.sleep(0.01)
        # drain: workers learn "done" on their next request and exit. Stop
        # the supervisor FIRST: exits on a drained run are success, not
        # failures to heal.
        if sup is not None:
            sup.stop_polling()
        deadline = time.monotonic() + 10.0
        for p in (sup.procs() if sup is not None
                  else list(procs.values()) + extra):
            if p.alive():
                try:
                    p.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
    finally:
        if sup is not None:
            sup.close()     # kills + cleans whatever is still up
        for p in list(procs.values()) + extra:
            if p.alive():
                p.kill()
            p.cleanup()
        chief.close()
        store.final_snapshot()

    return _result(spec, store, train, val, schedule, Xtest, ytest,
                   n_workers=n_workers, sup=sup)


def _final_metrics(W, train, val, Xtest, ytest) -> dict:
    model = LogisticRegression.from_weights(np.asarray(W))
    out = {
        "train_loss": model.loss(*train),
        "val_loss": model.loss(*val),
        "model": model,
    }
    if Xtest is not None:
        out["test_accuracy"] = model.accuracy(Xtest, ytest)
    return out


def _result(spec, store: ParameterStore, train, val, schedule, Xtest, ytest,
            n_workers: int, sup=None) -> dict:
    out = _final_metrics(store.weights(), train, val, Xtest, ytest)
    out["history"] = [(t, float(e)) for t, e in store.history]
    out["n_steps"] = store.progress()
    out["schedule"] = schedule
    out["staleness_seq"] = np.asarray(store.staleness, np.int64)
    out["staleness_hist"] = store.staleness_hist()
    out["dist"] = {
        "mode": spec.dist_mode,
        "n_workers": n_workers,
        "drops": store.drops,
        "late": store.late,
        "worker_exits": store.worker_exits,
        "joins": store.joins,
    }
    out["dist"].update(store.resilience_counters())
    if sup is not None:
        out["dist"]["supervisor"] = sup.stats()
    return out


def _empty_result(spec, W0, train, val, schedule, Xtest, ytest) -> dict:
    out = _final_metrics(W0, train, val, Xtest, ytest)
    out.update(history=[], n_steps=0, schedule=schedule,
               staleness_seq=np.zeros((0,), np.int64), staleness_hist={},
               dist={"mode": spec.dist_mode, "n_workers": 0, "drops": 0,
                     "late": 0, "worker_exits": 0, "joins": 0})
    return out
