"""Literal event-driven parameter-server simulation of the paper's algorithms.

A numpy copy of `repro.core.parameter_server` (the port imports nothing of
the JAX package), kept equal to it bit for bit by
tests/test_torch_spec_copies.py: the same rng protocol draws W0, the
validation split and the delay schedule in both packages.

  * SGD   — Fig. 2: sequential mini-batch gradient descent.
  * SSGD  — Fig. 3/4: c workers compute gradients at the same W_t (barrier);
            the server applies the c arrivals one at a time, so arrivals 2..c
            are applied to weights that have already moved — the paper's delay.
  * ASGD  — lock-free: an event queue with random per-worker compute delays;
            each gradient is computed at the W the worker fetched and applied
            whenever it arrives (true heterogeneous staleness).
  * g-    — Fig. 7: the server tracks per-batch consistency and every rho
            arrivals replays the stored gradients of the <=4 most consistent
            batches: W -= eta * v(psi_i).
  * SRMSprop / SAdagrad — Fig. 11: the server-side update rule is swapped; the
            guided replay stays plain (exactly as printed in the paper).

`train_ps` is the port's `backend="sim"` and the oracle of its torch scan
backend (repro_torch.engine.delaysim), which replays the `DelaySchedule`
that `extract_schedule` records from the same rng protocol.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np


# ----------------------------------------------------------- logistic model


class LogisticRegression:
    """Multinomial logistic regression with bias, matching the paper's Section 5
    proof-of-concept model."""

    def __init__(self, n_features: int, n_classes: int, rng: np.random.Generator):
        self.W = 0.01 * rng.standard_normal((n_features + 1, n_classes))

    @staticmethod
    def _aug(X):
        return np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)

    def logits(self, X, W=None):
        W = self.W if W is None else W
        return self._aug(X) @ W

    def loss(self, X, y, W=None):
        z = self.logits(X, W)
        z = z - z.max(axis=1, keepdims=True)
        lse = np.log(np.exp(z).sum(axis=1))
        return float(np.mean(lse - z[np.arange(len(y)), y]))

    def grad(self, X, y, W=None):
        W = self.W if W is None else W
        z = self.logits(X, W)
        z = z - z.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(y)), y] -= 1.0
        return self._aug(X).T @ p / len(y)

    def accuracy(self, X, y) -> float:
        return float(np.mean(self.logits(X).argmax(axis=1) == y))

    @classmethod
    def from_weights(cls, W) -> "LogisticRegression":
        """Wrap an externally trained weight matrix (e.g. the scan backend's
        final W) so callers get the same loss/accuracy methods."""
        model = object.__new__(cls)
        model.W = np.asarray(W)
        return model


# ------------------------------------------------------------------- config


@dataclasses.dataclass
class PSConfig:
    mode: str = "ssgd"            # seq | ssgd | asgd
    guided: bool = False
    optimizer: str = "sgd"        # sgd | rmsprop | adagrad (server-side rule)
    lr: float = 0.2               # paper Table 1
    epochs: int = 50              # paper Table 1
    rho: int = 10                 # paper Table 1 (delay tolerance = #workers)
    batch_size: int = 16
    max_consistent: int = 4       # paper Section 4
    verification_frac: float = 0.2  # paper Table 1 (training:validation 80:20)
    rmsprop_beta: float = 0.9     # paper Fig. 11
    eps: float = 1e-8
    seed: int = 0

    @property
    def n_workers(self) -> int:
        return 1 if self.mode == "seq" else self.rho  # paper: c = rho


# ------------------------------------------------------------------- server


class _Server:
    """Parameter server: applies gradients with the configured rule and runs
    the guided consistency tracking + replay (Fig. 7 / Fig. 11)."""

    def __init__(self, model: LogisticRegression, cfg: PSConfig, Xv, yv, rng):
        self.model = model
        self.cfg = cfg
        self.Xv, self.yv = Xv, yv
        self.rng = rng
        self.r = np.zeros_like(model.W)  # rmsprop/adagrad accumulator
        self.t = 0
        self.prev_avg_err = np.inf
        self.recent: list = []        # deque of (batch_id, grad, loss_at_apply, X, y)
        self.psi: dict = {}           # batch_id -> (score, grad)
        self.history: list = []       # (t, avg_err) for progression plots

    def _apply(self, grad):
        cfg = self.cfg
        if cfg.optimizer == "sgd":
            self.model.W -= cfg.lr * grad
        elif cfg.optimizer == "rmsprop":
            self.r = cfg.rmsprop_beta * self.r + (1 - cfg.rmsprop_beta) * grad**2
            self.model.W -= cfg.lr * grad / np.sqrt(self.r + cfg.eps)
        elif cfg.optimizer == "adagrad":
            self.r = self.r + grad**2
            self.model.W -= cfg.lr * grad / np.sqrt(self.r + cfg.eps)
        else:
            raise ValueError(cfg.optimizer)

    def receive(self, grad, batch_id, Xb, yb):
        """One arrival at the parameter server (Fig. 4 body / Fig. 7 body)."""
        cfg = self.cfg
        loss_before = self.model.loss(Xb, yb)
        self._apply(grad)
        self.t += 1

        avg_err = self.model.loss(self.Xv, self.yv)  # approximateAvgError()
        self.history.append((self.t, avg_err))
        if not cfg.guided:
            self.prev_avg_err = avg_err
            return

        # collectConsistentBatches(d_i, d_{i-1}, d_{i-2}): a batch is consistent
        # when the step that applied its gradient moved BOTH its own loss and
        # the verification-average loss downward (the gradient "corresponds to
        # the true gradient" despite the delay, Fig. 1). Ranking uses the
        # average-error drop — getMostConsistentBatches(psi, E_t) keys on E_t.
        if np.isfinite(self.prev_avg_err):
            d_avg = avg_err - self.prev_avg_err
            d_own = self.model.loss(Xb, yb) - loss_before
            if d_own < 0 and d_avg < 0:
                score = -d_avg / (abs(self.prev_avg_err) + 1e-12)
                prev = self.psi.get(batch_id)
                if prev is None or score > prev[0]:
                    self.psi[batch_id] = (score, grad)
        self.recent.append((batch_id, grad, loss_before, Xb, yb))
        self.recent = self.recent[-3:]
        self.prev_avg_err = avg_err

        # max delay tolerance reached: replay the most consistent batches
        if self.t % cfg.rho == 0:
            best = sorted(self.psi.items(), key=lambda kv: -kv[1][0])[: cfg.max_consistent]
            for _, (_, g_stored) in best:       # getMostConsistentBatches
                self.model.W -= cfg.lr * g_stored  # plain replay (Fig. 7 line 8)
            self.psi.clear()


# --------------------------------------------------------------- main loops


def _minibatches(X, y, bs, rng):
    idx = rng.permutation(len(X))
    for s in range(0, len(X) - bs + 1, bs):
        sel = idx[s : s + bs]
        yield sel, X[sel], y[sel]


def train_ps(X, y, n_classes: int, cfg: PSConfig, Xtest=None, ytest=None):
    """Run one full training per the paper's protocol. Returns dict of results."""
    rng = np.random.default_rng(cfg.seed)
    n_val = max(8, int(cfg.verification_frac * len(X)))
    vidx = rng.choice(len(X), n_val, replace=False)
    mask = np.ones(len(X), bool)
    mask[vidx] = False
    Xtr, ytr = X[mask], y[mask]
    Xv, yv = X[vidx], y[vidx]

    model = LogisticRegression(X.shape[1], n_classes, rng)
    server = _Server(model, cfg, Xv, yv, rng)
    c = cfg.n_workers

    for _epoch in range(cfg.epochs):
        batches = list(_minibatches(Xtr, ytr, cfg.batch_size, rng))
        if cfg.mode == "seq":
            for bid, (sel, Xb, yb) in enumerate(batches):
                g = model.grad(Xb, yb)
                server.receive(g, (_epoch, bid), Xb, yb)

        elif cfg.mode == "ssgd":
            # barrier rounds: c gradients at the same W, applied sequentially
            # (the final round may be partial when the dataset is small)
            for r0 in range(0, len(batches), c):
                W_snapshot = model.W.copy()
                grads = [
                    (bid, model.grad(Xb, yb, W_snapshot), Xb, yb)
                    for bid, (sel, Xb, yb) in enumerate(batches[r0 : r0 + c], start=r0)
                ]
                for bid, g, Xb, yb in grads:
                    server.receive(g, (_epoch, bid), Xb, yb)

        elif cfg.mode == "asgd":
            # event-driven lock-free simulation with random compute delays
            heap: list = []
            it = iter(enumerate(batches))
            now = 0.0
            for w in range(c):
                try:
                    bid, (sel, Xb, yb) = next(it)
                except StopIteration:
                    break
                delay = rng.exponential(1.0) + 0.1
                heapq.heappush(heap, (now + delay, w, bid, model.W.copy(), Xb, yb))
            while heap:
                t_arr, w, bid, W_fetch, Xb, yb = heapq.heappop(heap)
                g = model.grad(Xb, yb, W_fetch)   # gradient at *stale* weights
                server.receive(g, (_epoch, bid), Xb, yb)
                try:
                    nbid, (sel, nXb, nyb) = next(it)
                except StopIteration:
                    continue
                delay = rng.exponential(1.0) + 0.1
                heapq.heappush(heap, (t_arr + delay, w, nbid, model.W.copy(), nXb, nyb))
        else:
            raise ValueError(cfg.mode)

    out = {
        "train_loss": model.loss(Xtr, ytr),
        "val_loss": model.loss(Xv, yv),
        "history": server.history,
        "n_steps": server.t,  # actual server steps (authoritative throughput count)
        "model": model,
    }
    if Xtest is not None:
        out["test_accuracy"] = model.accuracy(Xtest, ytest)
    return out


# ------------------------------------------------------- schedule extraction


@dataclasses.dataclass(frozen=True)
class DelaySchedule:
    """Precomputed arrival table for one training run: what the parameter
    server sees at every step, with the delay topology factored out of the
    training loop.

    Row t describes the t-th arrival (0-based server step): the mini-batch it
    carries (`batch_rows[t]` — row indices into the training set) and the
    staleness offset `staleness[t]` = s, meaning the gradient was computed at
    W_{t-s}, the weights as they stood s server steps before the arrival was
    applied. seq is all-zeros, ssgd is the sawtooth 0..c-1 per barrier round,
    asgd comes out of the event-queue simulation with pre-sampled compute
    times (any `delay_sampler` — exponential, constant, heavy-tail, ...).

    The scan backend (repro_torch.engine.delaysim) consumes this table with a ring
    buffer of the last `max_staleness+1` weight states; the numpy event loop
    above stays as the parity reference that defines these semantics.
    """

    batch_rows: np.ndarray   # (T, batch_size) int32, rows into the train set
    staleness: np.ndarray    # (T,) int32, s_t: gradient computed at W_{t-s_t}
    n_workers: int
    topology: str = "exp"
    worker: Optional[np.ndarray] = None  # (T,) int32, which worker delivered
                                         # arrival t (None for pre-dist tables)

    @property
    def n_steps(self) -> int:
        return len(self.staleness)

    @property
    def max_staleness(self) -> int:
        return int(self.staleness.max(initial=0))

    @property
    def fetch_version(self) -> np.ndarray:
        """(T,) server version each arrival's gradient was fetched at:
        f_t = t - s_t (the store had applied f_t updates at fetch time)."""
        return np.arange(self.n_steps, dtype=np.int64) - self.staleness


def _event_schedule(n_batches: int, c: int, rng, delay_sampler, t0: int):
    """One epoch of the ASGD event-queue simulation, gradient math elided.

    Mirrors the `mode == "asgd"` branch of train_ps arrival-for-arrival: same
    heap ordering, same rng draw order (one draw per dispatched batch, drawn
    only after the batch iterator yields). Returns (order, fetch) — the batch
    ids in arrival order and the global server step each gradient's weights
    were fetched at. `t0` is the global step count before this epoch.
    """
    heap: list = []
    it = iter(range(n_batches))
    order, fetch, whom = [], [], []
    t = t0
    for w in range(c):
        bid = next(it, None)
        if bid is None:
            break
        heapq.heappush(heap, (0.0 + delay_sampler(w, rng), w, bid, t0))
    while heap:
        t_arr, w, bid, f = heapq.heappop(heap)
        order.append(bid)
        fetch.append(f)
        whom.append(w)
        t += 1
        nbid = next(it, None)
        if nbid is not None:
            heapq.heappush(heap, (t_arr + delay_sampler(w, rng), w, nbid, t))
    return order, fetch, whom


def _exp_sampler(w: int, rng) -> float:
    """train_ps's literal compute-time draw (keep the rng call identical)."""
    return rng.exponential(1.0) + 0.1


def extract_schedule(cfg: PSConfig, n_train: int, rng, delay_sampler=None,
                     topology: str = "") -> DelaySchedule:
    """Replay train_ps's per-epoch rng protocol, recording arrivals instead of
    training: one `rng.permutation(n_train)` per epoch, then (asgd only) the
    event-queue delay draws in the loop's exact order. Call with an rng in the
    same state train_ps would have after the validation split and model init,
    and the recorded schedule reproduces the reference run arrival-for-arrival.
    """
    c = cfg.n_workers
    bs = cfg.batch_size
    delay_sampler = delay_sampler or _exp_sampler
    rows, stale, whom = [], [], []
    t = 0
    for _epoch in range(cfg.epochs):
        idx = rng.permutation(n_train)
        nb = (n_train - bs) // bs + 1 if n_train >= bs else 0
        epoch_rows = idx[: nb * bs].reshape(nb, bs)
        if cfg.mode == "seq":
            rows.extend(epoch_rows)
            stale += [0] * nb
            whom += [0] * nb
            t += nb
        elif cfg.mode == "ssgd":
            for r0 in range(0, nb, c):
                round_ = epoch_rows[r0:r0 + c]
                rows.extend(round_)
                stale += list(range(len(round_)))
                whom += list(range(len(round_)))
                t += len(round_)
        elif cfg.mode == "asgd":
            order, fetch, workers = _event_schedule(nb, c, rng, delay_sampler, t)
            rows += [epoch_rows[b] for b in order]
            stale += [t + i - f for i, f in enumerate(fetch)]
            whom += workers
            t += len(order)
        else:
            raise ValueError(cfg.mode)
    return DelaySchedule(
        batch_rows=np.asarray(rows, np.int32),
        staleness=np.asarray(stale, np.int32),
        n_workers=c,
        topology=topology or {"seq": "seq", "ssgd": "barrier"}.get(cfg.mode, "exp"),
        worker=np.asarray(whom, np.int32),
    )


def prepare_run(X, y, n_classes: int, cfg: PSConfig, delay_sampler=None,
                topology: str = ""):
    """The data-and-schedule half of train_ps: same rng protocol (validation
    split -> model init -> per-epoch permutations and delay draws), no
    training. Returns (W0, (Xtr, ytr), (Xv, yv), DelaySchedule); feeding these
    to any backend that honours DelaySchedule semantics reproduces the
    train_ps trajectory exactly."""
    rng = np.random.default_rng(cfg.seed)
    n_val = max(8, int(cfg.verification_frac * len(X)))
    vidx = rng.choice(len(X), n_val, replace=False)
    mask = np.ones(len(X), bool)
    mask[vidx] = False
    Xtr, ytr = X[mask], y[mask]
    Xv, yv = X[vidx], y[vidx]
    W0 = 0.01 * rng.standard_normal((X.shape[1] + 1, n_classes))
    schedule = extract_schedule(cfg, len(Xtr), rng, delay_sampler, topology)
    return W0, (Xtr, ytr), (Xv, yv), schedule


ALGO_NAMES = {
    ("seq", False, "sgd"): "SGD",
    ("seq", True, "sgd"): "gSGD",
    ("ssgd", False, "sgd"): "SSGD",
    ("ssgd", True, "sgd"): "gSSGD",
    ("asgd", False, "sgd"): "ASGD",
    ("asgd", True, "sgd"): "gASGD",
    ("ssgd", False, "rmsprop"): "SRMSprop",
    ("ssgd", True, "rmsprop"): "gSRMSprop",
    ("ssgd", False, "adagrad"): "SAdagrad",
    ("ssgd", True, "adagrad"): "gSAdagrad",
}

