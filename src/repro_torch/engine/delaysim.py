"""The scan delay-simulation backend (`ExperimentSpec(backend="scan")`), as a
torch arrival loop.

Port of `repro.engine.delaysim`. The reference runs one jitted lax.scan over
a precomputed arrival table and vmaps it over the seeds; here:

  1. **DelaySchedule** (core.parameter_server): which mini-batch arrives at
     each server step and how stale its gradient's weights are, precomputed
     by replaying train_ps's rng protocol with the gradient math elided.
  2. **One Python loop over the T arrivals**, the seeds a leading dimension
     of every tensor: weights (S, P, k), a ring of the last R weight states
     (S, R, P, k) serving the stale fetches, and one launch of the fused
     guided-update kernel per arrival covering every seed (the CPU runs the
     kernel's plain version). The guided consistency scoring and window
     replay run through the `DelayCompensator` registry's scan-sim hooks.
  3. Everything in float64, on either device. Nothing inside the loop reads
     a device value back: the window end is a Python test on the arrival
     index, and the per-arrival verification losses land in a preallocated
     (S, T) device tensor that is copied to the host once, at the end.

With the default topologies the trajectory reproduces train_ps to float64
round-off (tests/test_torch_delaysim.py). Nothing is compiled, so there is
no runner cache.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.common.topologies import TOPOLOGY_SAMPLERS
from repro_torch.core.parameter_server import LogisticRegression, prepare_run
from repro_torch.engine.spec import ExperimentSpec
from repro_torch.engine.strategies import DelayCompensator, get_compensator, sim_shim_state
from repro_torch.kernels.guided_update.ops import FUSED_ACC_ARITY, fused_update_for

DTYPE = torch.float64


# ----------------------------------------------------------- model math
# Transcriptions of core.parameter_server.LogisticRegression with the seeds
# as a leading dimension. Labels arrive as one-hot masks: `(z * y_oh).sum`
# selects the own logit exactly (the masked terms are exact zeros).


def _loss(W, Xa, y_oh):
    """W (S, P, k), Xa (S, n, P), y_oh (S, n, k) -> mean loss per seed (S,)."""
    z = torch.bmm(Xa, W)
    z = z - z.amax(dim=2, keepdim=True)
    lse = torch.log(torch.exp(z).sum(dim=2))
    own = (z * y_oh).sum(dim=2)
    return torch.mean(lse - own, dim=1)


def _grad(W, Xa, y_oh):
    z = torch.bmm(Xa, W)
    z = z - z.amax(dim=2, keepdim=True)
    p = torch.exp(z)
    p = p / p.sum(dim=2, keepdim=True)
    p = p - y_oh
    return torch.bmm(Xa.transpose(1, 2), p) / Xa.shape[1]


def _aug(X):
    return np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)


def _one_hot(y, k):
    return torch.nn.functional.one_hot(y, k).to(DTYPE)


# ----------------------------------------------------------- arrival loop


class ArrivalLoop:
    """The state of one scan-backend fit on `device`: the seeds' weights,
    stale-weight ring, accumulators and guided window. `advance(stop)` runs
    the arrivals up to `stop`; `run` drives it over all of them."""

    def __init__(self, spec: ExperimentSpec, strategy: DelayCompensator, preps, device):
        self.spec, self.strategy = spec, strategy
        schedules = [p[3] for p in preps]
        self.T = schedules[0].n_steps
        r_needed = max(s.max_staleness for s in schedules) + 1
        # ring size bucketed as the reference's (a few unused slots are free)
        self.R = R = max(16, 1 << (r_needed - 1).bit_length())
        self.c = schedules[0].n_workers
        dev = torch.device(device)
        S, k = len(preps), preps[0][0].shape[1]

        def put(a, dtype=DTYPE):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        W0 = put(np.stack([p[0] for p in preps]))                           # (S, P, k)
        Xa_all = put(np.stack([_aug(p[1][0]) for p in preps]))              # (S, n, P)
        rows = put(np.stack([s.batch_rows for s in schedules]), torch.int64)  # (S, T, bs)
        yb = put(np.stack([p[1][1][s.batch_rows] for p, s in zip(preps, schedules)]),
                 torch.int64)
        self.seeds = torch.arange(S, device=dev)
        # per-arrival batches, arrival-major so each step reads a contiguous block
        self.Xb = Xa_all[self.seeds[None, :, None], rows.transpose(0, 1)]   # (T, S, bs, P)
        self.yb_oh = _one_hot(yb.transpose(0, 1), k)                        # (T, S, bs, k)
        self.Xv = put(np.stack([_aug(p[2][0]) for p in preps]))
        self.yv_oh = _one_hot(put(np.stack([p[2][1] for p in preps]), torch.int64), k)
        stale = put(np.stack([s.staleness for s in schedules]), torch.int64)
        # ring slot each arrival's gradient is fetched from: (i - s) mod R
        self.fetch = torch.remainder(torch.arange(self.T, device=dev)[:, None] - stale.T, R)

        self.lam = float(strategy.sim_kernel_lambda())
        # the reference calls compensate_grads whenever lam is 0; skip the
        # call where it is the identity, so no shim state is built for it
        self.two_phase = not self.lam and (type(strategy).compensate_grads
                                           is not DelayCompensator.compensate_grads)
        optimizer = spec.optimizer
        self.kern = None
        if optimizer != "adagrad":
            hypers = {"rmsprop": dict(beta=float(spec.rmsprop_beta), eps=float(spec.eps)),
                      "momentum": dict(beta=0.9),
                      "adam": dict(b1=0.9, b2=0.999, eps=float(spec.eps))}.get(optimizer, {})
            # None -> two-phase: compensate_grads runs first, then a lam=0 apply
            self.kern = (strategy.sim_kernel(optimizer, **hypers)
                         or fused_update_for(optimizer, **hypers))
        n_acc = 1 if optimizer == "adagrad" else FUSED_ACC_ARITY[optimizer]
        self.rho_w = rho_w = max(spec.rho, 1)
        self.W = W0
        self.ring = W0[:, None].repeat(1, R, 1, 1).contiguous()             # (S, R, P, k)
        self.acc = tuple(torch.zeros_like(W0) for _ in range(n_acc))
        self.prev_avg = torch.full((S,), float("inf"), dtype=DTYPE, device=dev)
        self.wscore = torch.zeros((S, rho_w), dtype=DTYPE, device=dev)
        self.wgrads = torch.zeros((S, rho_w) + tuple(W0.shape[1:]), dtype=DTYPE, device=dev)
        self.avgs = torch.empty((S, self.T), dtype=DTYPE, device=dev)
        self.i = 0

    def to(self, device) -> "ArrivalLoop":
        """A copy of this loop, its state copied to `device`: the same fit
        continues there from the same arrival, independently of this one."""
        new = copy.copy(self)
        for key, val in vars(self).items():
            if isinstance(val, torch.Tensor):
                setattr(new, key, val.to(device, copy=True))
        new.acc = tuple(a.to(device, copy=True) for a in self.acc)
        return new

    def _apply(self, W, g, Wf, i):
        lr, lam = float(self.spec.lr), self.lam
        if self.kern is None:  # adagrad, inline as in the reference
            (r,) = self.acc
            gt = g + lam * g * g * (W - Wf)
            r = r + gt * gt
            return W - lr * gt / torch.sqrt(r + float(self.spec.eps)), (r,)
        # i+1 = the already-incremented adam step; ignored by the others
        return self.kern(W, g, Wf, self.acc, i + 1, lr, lam)

    def advance(self, stop: int) -> None:
        """Run arrivals self.i .. stop-1."""
        st, guided = self.strategy, self.strategy.sim_guided
        lr = float(self.spec.lr)
        W, prev_avg = self.W, self.prev_avg
        for i in range(self.i, min(stop, self.T)):
            Wf = self.ring[self.seeds, self.fetch[i]]
            Xa, yoh = self.Xb[i], self.yb_oh[i]
            g = _grad(Wf, Xa, yoh)
            if self.two_phase:
                g = st.compensate_grads(g, W, sim_shim_state(i, Wf, prev_avg, self.c))
            loss_before = _loss(W, Xa, yoh) if guided else None
            W2, self.acc = self._apply(W, g, Wf, i)
            avg = _loss(W2, self.Xv, self.yv_oh)
            self.avgs[:, i] = avg
            if guided:
                d_avg = avg - prev_avg
                d_own = _loss(W2, Xa, yoh) - loss_before
                pos = i % self.rho_w
                self.wscore[:, pos] = st.sim_score(d_own, d_avg, prev_avg)
                self.wgrads[:, pos] = g
                if (i + 1) % self.rho_w == 0:
                    W2 = st.sim_replay(W2, self.wscore, self.wgrads, lr)
                    self.wscore.zero_()
            W, prev_avg = W2, avg
            self.ring[:, (i + 1) % self.R] = W
            self.i = i + 1
        self.W, self.prev_avg = W, prev_avg


# ------------------------------------------------------------- entry point


def run(spec: ExperimentSpec, X, y, n_classes: int, Xtest=None, ytest=None,
        strategy: DelayCompensator = None, device="cuda") -> dict:
    """Run `spec` on the scan backend on `device`. Same contract as train_ps
    (plus seed batching): train/val losses, per-arrival (t, avg_err)
    history, final model(s) and optional test accuracy. n_seeds == 1 returns
    scalars; n_seeds > 1 returns (n_seeds,) arrays and a list of per-seed
    models. `strategy` reuses an already resolved DelayCompensator."""
    if strategy is None:
        strategy = get_compensator(spec.strategy, spec.to_guided_config())
    preps = prepare(spec, X, y, n_classes)
    if preps[0][3].n_steps == 0:
        # n_train < batch_size yields zero arrivals; mirror train_ps (which
        # returns the untouched init)
        return _empty_result(spec, preps, Xtest, ytest)
    loop = ArrivalLoop(spec, strategy, preps, device)
    loop.advance(loop.T)
    Wf = loop.W.cpu().numpy()
    avgs = loop.avgs.cpu().numpy()
    out = _final_metrics(spec, preps, Wf, Xtest, ytest)
    out["history"] = [(t + 1, float(avgs[0, t]) if spec.n_seeds == 1 else avgs[:, t])
                      for t in range(loop.T)]
    out["n_steps"] = loop.T
    out["schedule"] = preps[0][3] if spec.n_seeds == 1 else [p[3] for p in preps]
    return out


def prepare(spec: ExperimentSpec, X, y, n_classes: int) -> list:
    """prepare_run for each seed: [(W0, (Xtr, ytr), (Xv, yv), schedule)].
    Raises ValueError when the seeds' schedules differ in length."""
    topology = spec.resolved_topology
    try:
        sampler = TOPOLOGY_SAMPLERS[topology]
    except KeyError:
        raise KeyError(
            f"unknown topology {topology!r}; known: {', '.join(TOPOLOGY_SAMPLERS)}"
        ) from None
    preps = [
        prepare_run(X, y, n_classes, spec.to_schedule_config(seed=s),
                    delay_sampler=sampler, topology=topology)
        for s in range(spec.seed, spec.seed + spec.n_seeds)
    ]
    schedules = [p[3] for p in preps]
    T = schedules[0].n_steps
    if not all(s.n_steps == T for s in schedules):
        counts = {spec.seed + i: s.n_steps for i, s in enumerate(schedules)}
        raise ValueError(
            f"seeds disagree on arrival count under mode={spec.mode!r} "
            f"topology={topology!r} epochs={spec.epochs} "
            f"batch_size={spec.batch_size}: per-seed n_steps {counts}; the "
            f"scan backend needs equal-length schedules to batch "
            f"n_seeds={spec.n_seeds} (run seeds separately or use backend='sim')"
        )
    return preps


def _final_metrics(spec: ExperimentSpec, preps, Wf, Xtest, ytest) -> dict:
    """train/val losses, per-seed models and test accuracy from the final
    weights, computed with the numpy reference model. n_seeds == 1 unwraps
    to scalars / a single model."""
    models = [LogisticRegression.from_weights(Wf[i]) for i in range(len(preps))]
    train_loss = np.array([models[i].loss(*preps[i][1]) for i in range(len(preps))])
    val_loss = np.array([models[i].loss(*preps[i][2]) for i in range(len(preps))])
    single = spec.n_seeds == 1
    out = {
        "train_loss": float(train_loss[0]) if single else train_loss,
        "val_loss": float(val_loss[0]) if single else val_loss,
        "model": models[0] if single else models,
    }
    if Xtest is not None:
        acc = np.array([m.accuracy(Xtest, ytest) for m in models])
        out["test_accuracy"] = float(acc[0]) if single else acc
    return out


def _empty_result(spec: ExperimentSpec, preps, Xtest, ytest) -> dict:
    out = _final_metrics(spec, preps, np.stack([p[0] for p in preps]), Xtest, ytest)
    out["history"] = []
    out["n_steps"] = 0
    out["schedule"] = preps[0][3] if spec.n_seeds == 1 else [p[3] for p in preps]
    return out
