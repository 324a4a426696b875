"""`ParameterStore` — the chief's versioned parameter state + apply path, on
the card (port of `repro.dist.store`).

One store owns the authoritative weights W, the optimizer accumulator, and
the guided window state, as float64 tensors on `device`. Every applied push
increments `version`; the staleness of an update is OBSERVED, not scripted:

    staleness = version_at_apply - read_version_of_the_push

and the recorded sequence is what `Report.staleness_hist` summarizes. The
apply path is the scan backend's (repro_torch.engine.delaysim
`ArrivalLoop._apply`) with a seed axis of one: the strategy's fused update
(`sim_kernel`, else `fused_update_for`) is one launch of the hand-written
guided-update kernel per applied push — gt = g + lam*g*g*(W - W_fetch), then
the optimizer rule on gt — adagrad runs inline, and strategies whose
compensation is not the kernel's lambda fold (gap_aware) take the two-phase
path: `compensate_grads`, then a lam=0 launch. The guided consistency score
and window replay run through the strategy's torch hooks (`sim_score`,
`sim_replay`) on W[None], a (1, rho) score window and a (1, rho, P, k)
gradient window. So a replay-mode run lands on the scan/train_ps trajectory
to round-off.

Two grant disciplines share this apply path:

  * replay — the parity oracle. The chief holds the `DelaySchedule` extracted
    by `core.parameter_server.extract_schedule` (same seed -> same table as
    the scan backend) and sequences pulls/pushes against it: worker w's k-th
    pull blocks until `version >= fetch_version` and is served the weights AS
    OF that version (a small version ring keeps the last max_staleness+2
    copies, on the device); its push blocks until `version == arrival_step`.
    Real processes compute every gradient; only the interleaving is pinned,
    so the observed staleness sequence must equal the schedule's column.
  * live — free-running. Pushes apply in arrival order at wall-clock speed;
    `drop_rate` injects dropped updates; late pushes after the step budget
    are counted, not crashed on.

Host traffic: a push's gradient (and, live, its W_fetch) is copied to the
device; a grant hands the worker a numpy copy of W, one device-to-host copy;
an apply reads one float back, its validation loss (for `history`, the
divergence detector and nothing else: the guided score's inputs stay on the
device). A checkpoint copies W and r to the host.

Thread safety: one lock/condition serializes applies (the parameter server
is sequential by definition — the asynchrony lives between processes). The
kernel is bound in __init__, before the chief starts its connection threads
(the kernels' build cache is lock-free). W and r are never written in place
(every apply makes new tensors), so the version ring, the rollback target
and a grant's copy may hold them by reference.
"""
from __future__ import annotations

import copy
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import CorruptCheckpointError, dist_restore, dist_snapshot
from repro_torch.dist.logreg import _aug
from repro_torch.engine.delaysim import DTYPE, _loss, _one_hot
from repro_torch.engine.strategies import DelayCompensator, sim_shim_state
from repro_torch.kernels.guided_update import ops as gu_ops
from repro_torch.resilience import DivergenceDetector, GradScreen


def strategy_needs_fetch(strategy) -> bool:
    """True when the strategy compensates against the fetched weights
    (DC-ASGD Taylor term, Gap-Aware dampening): workers then ship W_fetch
    back with the push so the chief never needs an unbounded version ring."""
    return bool(strategy.sim_kernel_lambda()) or (
        type(strategy).compensate_grads is not DelayCompensator.compensate_grads
    )


class ParameterStore:
    """Versioned parameter state + the strategy-driven apply path on `device`."""

    def __init__(self, spec, strategy, W0, train, val, total_steps: int,
                 schedule=None, drop_rate: float = 0.0, seed: int = 0,
                 checkpointer=None, ckpt_every: int = 0, policy=None,
                 device="cuda"):
        self.spec = spec
        self.strategy = strategy
        self.device = dev = torch.device(device)
        W0 = np.asarray(W0, np.float64)
        self.shape = W0.shape
        k = W0.shape[1]
        self.W = torch.tensor(W0, dtype=DTYPE, device=dev)
        self.r = torch.zeros_like(self.W)          # rmsprop/adagrad accumulator
        self.Xa = torch.tensor(_aug(np.asarray(train[0], np.float64)), device=dev)
        self.y_oh = _one_hot(torch.tensor(np.asarray(train[1]), dtype=torch.int64,
                                          device=dev), k)
        self.Xva = torch.tensor(_aug(np.asarray(val[0], np.float64)), device=dev)
        self.yv_oh = _one_hot(torch.tensor(np.asarray(val[1]), dtype=torch.int64,
                                           device=dev), k)
        self.version = 0
        self.total = int(total_steps)
        self.lam = float(strategy.sim_kernel_lambda())
        self.guided = bool(strategy.sim_guided)
        self.need_fetch = strategy_needs_fetch(strategy)
        # the reference compensates whenever lam is 0; skip the call where
        # compensate_grads is the identity, as the scan backend does
        self.two_phase = not self.lam and (type(strategy).compensate_grads
                                           is not DelayCompensator.compensate_grads)
        self.kern = None                           # adagrad: inline
        if spec.optimizer != "adagrad":
            hypers = ({"beta": float(spec.rmsprop_beta), "eps": float(spec.eps)}
                      if spec.optimizer == "rmsprop" else {})
            # None -> two-phase: compensate_grads runs first, then a lam=0 apply
            self.kern = (strategy.sim_kernel(spec.optimizer, **hypers)
                         or gu_ops.fused_update_for(spec.optimizer, **hypers))
            if dev.type == "cuda":
                gu_ops.load(f"guided_{spec.optimizer}_update")
        rho = max(spec.rho, 1)
        self.rho = rho
        self.wscore = torch.zeros((rho,), dtype=DTYPE, device=dev)
        self.wgrads = torch.zeros((rho,) + self.shape, dtype=DTYPE, device=dev)
        self.prev_avg = torch.full((1,), float("inf"), dtype=DTYPE, device=dev)
        # ---- observability
        self.history: list = []          # (version, avg_err) per apply
        self.staleness: list = []        # observed per-apply staleness
        self.drops = 0                   # scenario-dropped pushes
        self.late = 0                    # pushes arriving after the budget
        self.joins = 0
        self.worker_exits = 0
        self.bad_frames = 0              # malformed/unparseable worker frames
        self.resets = 0                  # chaos-injected connection resets
        # ---- resilience: sentinel screen + rollback policy. The screen and
        # detector own no lock — every call happens under `cond`.
        self.policy = policy
        self.screen = None
        self.detector = None
        if policy is not None and policy.screening:
            self.screen = GradScreen(policy)
            if policy.rollback:
                self.detector = DivergenceDetector(policy.factor)
        self.lr_scale = 1.0              # cut by lr_backoff at every rollback
        self.rollbacks = 0
        self.rollback_log: list = []     # (version, restored_step|None, reason)
        self.diverged = 0                # post-apply divergences detected
        self.fatal: Exception | None = None   # set -> drain workers, launcher raises
        # last committed sane state: the rollback target when no verified
        # on-disk snapshot exists
        self._good = (self.W, self.r)
        # ---- concurrency
        self.cond = threading.Condition()
        self._drop_rng = np.random.default_rng(seed + 7919)
        self.drop_rate = float(drop_rate)
        # ---- checkpointing (chief-side snapshots)
        self._ckpt = checkpointer
        self._ckpt_every = int(ckpt_every)
        # ---- replay grant state
        self.schedule = schedule
        self._ring: dict = {0: self.W}             # version -> W (replay only)
        self._dispatch: dict = {}                  # wid -> deque of dispatches
        self._ring_keep = 2
        if schedule is not None:
            if schedule.worker is None:
                raise ValueError(
                    "replay mode needs a DelaySchedule with per-arrival worker "
                    "ids (re-extract with the current core.parameter_server)")
            self._ring_keep = int(schedule.max_staleness) + 2
            fetch = schedule.fetch_version
            for t in range(schedule.n_steps):
                w = int(schedule.worker[t])
                self._dispatch.setdefault(w, deque()).append(
                    (t, int(fetch[t]), schedule.batch_rows[t]))

    def to(self, device) -> "ParameterStore":
        """A copy of this store with its state copied to `device`: the same
        run continues there from the same version, independently of this one
        (without the checkpointer). chip_smoke.py's shadow check replays
        stretches of a card run on the CPU with it."""
        with self.cond:
            new = copy.copy(self)
            for key, val in vars(self).items():
                if isinstance(val, torch.Tensor):
                    setattr(new, key, val.to(device, copy=True))
            new.device = torch.device(device)
            new._good = tuple(x.to(device, copy=True) for x in self._good)
            new._ring = {v: w.to(device, copy=True) for v, w in self._ring.items()}
            new._dispatch = {w: deque(q) for w, q in self._dispatch.items()}
            new.history = list(self.history)
            new.staleness = list(self.staleness)
            new.rollback_log = list(self.rollback_log)
            new.screen = copy.deepcopy(self.screen)
            new.detector = copy.deepcopy(self.detector)
            new._drop_rng = copy.deepcopy(self._drop_rng)
            new._ckpt = None
            new.cond = threading.Condition()
        return new

    # ------------------------------------------------------------- numerics

    def _put(self, a):
        """A host array as a float64 tensor on the store's device (a copy)."""
        return torch.tensor(np.asarray(a, np.float64), dtype=DTYPE, device=self.device)

    def _update(self, g, w_fetch):
        """The optimizer step on gt = g + lam*g*g*(W - w_fetch) at lr * lr_scale:
        one launch of the fused kernel, or adagrad inline. Sets r; returns W'."""
        lr = float(self.spec.lr) * self.lr_scale   # lr_scale == 1.0 until a rollback
        if self.kern is None:      # adagrad, inline as the scan backend's
            gt = g + self.lam * g * g * (self.W - w_fetch)
            self.r = self.r + gt * gt
            return self.W - lr * gt / torch.sqrt(self.r + float(self.spec.eps))
        acc = (self.r,) if self.spec.optimizer == "rmsprop" else ()
        W2, acc = self.kern(self.W, g, w_fetch, acc, self.version + 1, lr, self.lam)
        if acc:
            (self.r,) = acc
        return W2

    def _apply_locked(self, g, read_version: int, rows, w_fetch,
                      wid: int = None) -> int:
        """One server step (caller holds the lock). Returns observed staleness.

        With a rollback-capable policy the post-apply validation loss is the
        divergence backstop: a finite-but-poisoned update that slipped the
        per-push screen trips here, the update is NOT committed (version does
        not advance — exactly-once applies and the staleness identity stay
        intact), and the store rolls back to the last verified state."""
        t = self.version
        s = t - int(read_version)
        g = self._put(g)
        # a fresh push (staleness 0) or a no-stale strategy compensates against W
        w_fetch = self.W if w_fetch is None else w_fetch
        if not isinstance(w_fetch, torch.Tensor):
            w_fetch = self._put(w_fetch)
        if self.two_phase:
            shim = sim_shim_state(t, w_fetch[None], self.prev_avg, self.spec.rho)
            g = self.strategy.compensate_grads(g[None], self.W[None], shim)[0]
        # the window stores the raw gradient when the kernel folds lam
        if self.guided:
            idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64).to(self.device)
            Xb, yb = self.Xa[idx][None], self.y_oh[idx][None]
            loss_before = _loss(self.W[None], Xb, yb)
        W2 = self._update(g, w_fetch)
        avg_t = _loss(W2[None], self.Xva[None], self.yv_oh[None])
        avg = avg_t.item()         # the apply's one host read
        if self.detector is not None and self.detector.update(avg):
            # poisoned trajectory: discard this update (the accumulator `r`
            # is restored by the rollback) and remediate
            self.diverged += 1
            self._rollback_locked(wid)
            return s
        if self.guided:
            d_avg = avg_t - self.prev_avg
            d_own = _loss(W2[None], Xb, yb) - loss_before
            pos = t % self.rho
            self.wscore[pos] = self.strategy.sim_score(d_own, d_avg, self.prev_avg)[0]
            self.wgrads[pos] = g
            if (t + 1) % self.rho == 0:
                W2 = self.strategy.sim_replay(W2[None], self.wscore[None],
                                              self.wgrads[None], self.spec.lr)[0]
                self.wscore.zero_()
        self.W = W2
        self.prev_avg = avg_t
        self.version = t + 1
        if self.schedule is not None:
            self._ring[self.version] = W2
            for old in [v for v in self._ring if v < self.version - self._ring_keep]:
                del self._ring[old]
        self.history.append((self.version, avg))
        self.staleness.append(s)
        if self.detector is not None:
            # the committed state is by construction sane: the in-memory
            # rollback target when no verified disk snapshot exists
            self._good = (self.W, self.r)
        if self._ckpt is not None and self._ckpt_every and self.version % self._ckpt_every == 0:
            self._snapshot()
        self.cond.notify_all()
        return s

    # ------------------------------------------------------------ resilience

    def _rollback_locked(self, wid=None):
        """Remediate a detected divergence (caller holds the lock): restore
        W/r from the newest VERIFIED checkpoint (sha-checked, falling back
        through manifest history) or the in-memory last-good copy, back the
        lr off, and quarantine the offending worker. The version counter is
        NEVER rewound — applies stay exactly-once and observed staleness
        stays `version - read_version`. Exhausting `max_rollbacks` marks the
        run fatal: workers drain on their next request, the launcher raises."""
        policy = self.policy
        self.rollbacks += 1
        if self.rollbacks > policy.max_rollbacks:
            self.fatal = RuntimeError(
                f"divergence persisted through {policy.max_rollbacks} "
                f"rollbacks (version {self.version}/{self.total}, "
                f"lr_scale {self.lr_scale:.3g}); the trajectory is not "
                f"recoverable by remediation")
            self.cond.notify_all()
            return
        restored_step = None
        W, r = self._good
        if self._ckpt is not None:
            try:
                snap = dist_restore(self.spec.ckpt_dir)
                W = self._put(snap["W"])
                r = self._put(snap["r"]) if "r" in snap else torch.zeros_like(self.W)
                restored_step = int(snap["version"])
            except (FileNotFoundError, CorruptCheckpointError):
                pass  # nothing intact on disk (yet): in-memory last-good
        self.W, self.r = W, r
        self.lr_scale *= policy.lr_backoff
        self.prev_avg = _loss(self.W[None], self.Xva[None], self.yv_oh[None])
        if self.detector is not None:
            self.detector.best = min(self.detector.best, self.prev_avg.item())
        # the guided consistency window scored a trajectory that no longer
        # exists; restart it rather than replaying stale corrections
        self.wscore.zero_()
        self.wgrads.zero_()
        if wid is not None and self.screen is not None:
            self.screen.quarantine(wid, self.version)
        self.rollback_log.append((self.version, restored_step,
                                  "post-apply divergence"))
        self.cond.notify_all()

    def record_bad_frame(self, wid, exc) -> None:
        """A malformed/unparseable frame arrived on a worker connection: the
        chief drops the connection, counts it, and the run continues."""
        with self.cond:
            self.bad_frames += 1
            self.cond.notify_all()

    def record_reset(self) -> None:
        """A chaos-injected connection reset (repro_torch.chaos): counted apart
        from organic worker exits so tests can assert the injection fired."""
        with self.cond:
            self.resets += 1
            self.cond.notify_all()

    def fatal_error(self):
        with self.cond:
            return self.fatal

    def resilience_counters(self) -> dict:
        """The sentinel/remediation half of the launcher's `dist` result
        (supervisor stats merge in at the launcher)."""
        with self.cond:
            out = {
                "bad_frames": self.bad_frames,
                "resets": self.resets,
                "rollbacks": self.rollbacks,
                "diverged": self.diverged,
                "lr_scale": self.lr_scale,
                "rollback_log": list(self.rollback_log),
            }
            if self.screen is not None:
                out.update(self.screen.counters())
            return out

    # ------------------------------------------------------------ snapshots

    def _snapshot(self):
        self._ckpt.save(self.version, dist_snapshot(
            self.W.cpu().numpy(), self.version, np.asarray(self.staleness, np.int64),
            r=self.r.cpu().numpy(), lr_scale=self.lr_scale))

    def final_snapshot(self):
        if self._ckpt is not None:
            with self.cond:
                self._snapshot()
            self._ckpt.close()

    # ---------------------------------------------------------- replay mode

    def replay_pull(self, wid: int):
        """Block until this worker's next scheduled fetch version exists, then
        serve (a host copy of) the weights AS OF that version. None -> no
        dispatches left."""
        q = self._dispatch.get(wid)
        with self.cond:
            if not q:
                return None
            t, fetch_v, rows = q[0]
            self.cond.wait_for(lambda: self.version >= fetch_v)
            W = self._ring[fetch_v]
        return W.cpu().numpy(), fetch_v, rows

    def replay_push(self, wid: int, g, read_version: int):
        """Block until the store reaches this dispatch's scheduled arrival
        step, then apply. Returns the observed staleness."""
        q = self._dispatch[wid]
        with self.cond:
            t, fetch_v, rows = q.popleft()
            self.cond.wait_for(lambda: self.version == t)
            w_fetch = self._ring[fetch_v] if self.need_fetch else None
            return self._apply_locked(g, read_version, rows, w_fetch)

    # ------------------------------------------------------------ live mode

    def live_step(self, wid: int, g, read_version: int, rows, w_fetch):
        """Apply a push (if any) and hand back (a host copy of) the freshest
        params. Returns (W, version) or None once the step budget is
        exhausted (or the run went fatal — remediation exhausted — and
        workers should drain).

        With a sentinel policy the push is screened first, on the host copy
        the worker sent: non-finite (and, at level "full", norm-exploded)
        gradients are rejected and counted per worker, never applied; a
        quarantined worker's pushes are ignored until its ban lifts, but it
        still receives fresh params — it may recover (a transient NaN
        source) without a respawn."""
        with self.cond:
            if self.fatal is not None:
                return None
            if g is not None:
                g = np.asarray(g, np.float64)
                if self.version >= self.total:
                    self.late += 1
                elif self.screen is not None and \
                        self.screen.admit(wid, g, self.version) is not None:
                    pass     # rejected/quarantined: counted by the screen
                elif self.drop_rate and self._drop_rng.random() < self.drop_rate:
                    self.drops += 1
                else:
                    self._apply_locked(g, read_version, rows, w_fetch, wid=wid)
            if self.fatal is not None or self.version >= self.total:
                return None
            W, version = self.W, self.version
        return W.cpu().numpy(), version

    # --------------------------------------------------------- worker counts

    def record_join(self):
        """An elastic worker joined (chief assigned it a fresh wid)."""
        with self.cond:
            self.joins += 1

    def record_worker_exit(self):
        """A worker connection died mid-stream (kill/crash): tolerated,
        counted, and waiters are woken so replay grants can re-examine."""
        with self.cond:
            self.worker_exits += 1
            self.cond.notify_all()

    # -------------------------------------------------------------- queries

    def done(self) -> bool:
        with self.cond:
            return self.version >= self.total

    def progress(self) -> int:
        with self.cond:
            return self.version

    def weights(self) -> np.ndarray:
        """A host copy of the current weights."""
        with self.cond:
            W = self.W
        return W.cpu().numpy()

    def staleness_hist(self) -> dict:
        with self.cond:
            staleness = list(self.staleness)
        counts = np.bincount(np.asarray(staleness, np.int64)) if staleness else []
        return {int(s): int(n) for s, n in enumerate(counts) if n}
