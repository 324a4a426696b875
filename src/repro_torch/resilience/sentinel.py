"""Divergence sentinel (port of `repro.resilience.sentinel`).

Delay-compensated training diverges exactly where the paper's problem lives:
a stale push lands on parameters it was not computed against, and one
non-finite or exploding gradient poisons W for every worker that pulls after
it. The sentinel screens before the apply on both execution paths.

Mesh — `wrap_step_sentinel(step_fn, level, factor)`. The reference keeps the
previous (params, gstate) carry with `jnp.where(ok, new, old)`. The port's
step writes the params, `w_stale` and the optimizer accumulators in place
(`tree_fused_update`, `core.guided.refresh_stale`), so no old carry is left
to keep; instead the step hands its screen (`StepScreen`) what it needs
before it commits anything, and a rejected step returns its input trees
untouched (the batch is consumed, the update is not):

  * "finite" rejects a step whose loss is not finite. The loss is known
    after the backward and before the update, so the screen reads it then
    (one host read a step) and the update stays in place: no memory beyond
    the unguarded step's.
  * "full" also rejects a step that leaves any updated parameter leaf
    non-finite, or whose loss exceeds `factor x |prev_avg_loss|` when that
    is finite. The leaf test needs the update's result, so at this level the
    update runs out of place: the fused kernels write new params and new
    optimizer accumulators (the two-phase path is out of place anyway), a
    correcting strategy's second update lands on those, and one host read
    of the loss, the spike test and every new leaf's min/max decides. On
    acceptance the step returns the new trees (nothing is copied back); on
    rejection it drops them. Extra memory: one params' worth of the params'
    dtype plus one of each f32 accumulator, for the length of the update
    (yi-9b at 48 layers with sgd: 17.7 GB).

Either way `GuidedState` (step, scores, previous losses, `w_stale`, optimizer
state, extra) of a rejected step is the input's, and `metrics["rejected"]`
is 1 (0 on an accepted step).

Dist chief — `GradScreen` vets each worker's push under the store lock, on the host
copy the worker sent (numpy float64): non-finite gradients are always
rejected; at level "full" a gradient whose l2 norm exceeds `factor x` the
EMA of accepted norms is rejected too. Consecutive rejections quarantine the
worker for `quarantine_steps` versions — it still gets served fresh params
(it may recover), its pushes just stop reaching W.

`DivergenceDetector` is the post-apply backstop the screens cannot provide:
a finite-but-poisoned update shows up as a validation-loss explosion one
apply later, and the store answers with a rollback to the last verified
snapshot (see `ParameterStore._rollback_locked`).

Thread safety: GradScreen/DivergenceDetector mutate plain attributes and are
only ever called by the store with `store.cond` held — they deliberately own
no lock of their own (one lock discipline, the store's).
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: accepted pushes before the norm EMA is trusted as a rejection threshold
NORM_WARMUP = 5


@dataclasses.dataclass(frozen=True)
class SentinelPolicy:
    """The spec's resilience knobs, resolved once (see ExperimentSpec)."""

    level: str = ""                # "" | "finite" | "full"
    factor: float = 10.0
    rollback: bool = False
    max_rollbacks: int = 3
    lr_backoff: float = 0.5
    quarantine_steps: int = 0
    quarantine_after: int = 3

    @classmethod
    def from_spec(cls, spec) -> "SentinelPolicy":
        return cls(level=spec.sentinel, factor=spec.sentinel_factor,
                   rollback=spec.rollback, max_rollbacks=spec.max_rollbacks,
                   lr_backoff=spec.lr_backoff,
                   quarantine_steps=spec.quarantine_steps,
                   quarantine_after=spec.quarantine_after)

    @property
    def screening(self) -> bool:
        return bool(self.level)

    @property
    def norm_screen(self) -> bool:
        return self.level == "full"


class GradScreen:
    """Per-worker gradient screening for the chief's push path.

    NOT internally locked: the store calls `admit` under its own condition
    lock, which also serializes the counters this object keeps."""

    def __init__(self, policy: SentinelPolicy):
        self.policy = policy
        self.norm_ema = 0.0
        self.accepts = 0
        self.rejections: dict = {}          # wid -> rejected pushes
        self.reasons: dict = {}             # reason -> count
        self.consecutive: dict = {}         # wid -> consecutive rejections
        self.quarantined_until: dict = {}   # wid -> version the ban lifts at
        self.quarantines = 0

    def admit(self, wid: int, g: np.ndarray, version: int):
        """None -> apply the push; otherwise the rejection reason (already
        counted). `version` is the store version the verdict is made at."""
        if version < self.quarantined_until.get(wid, -1):
            self._count(wid, "quarantined")
            return "quarantined"
        if not np.all(np.isfinite(g)):
            return self._reject(wid, version, "non-finite")
        if self.policy.norm_screen:
            n = float(np.linalg.norm(g))
            if self.accepts >= NORM_WARMUP and \
                    n > self.policy.factor * max(self.norm_ema, 1e-12):
                return self._reject(wid, version, "norm-exploded")
            self.norm_ema = (0.9 * self.norm_ema + 0.1 * n
                             if self.accepts else n)
        self.accepts += 1
        self.consecutive[wid] = 0
        return None

    def quarantine(self, wid: int, version: int):
        """Ban `wid`'s pushes until version + quarantine_steps (also the
        store's remedy after a rollback attributed to this worker)."""
        if self.policy.quarantine_steps:
            self.quarantined_until[wid] = version + self.policy.quarantine_steps
            self.quarantines += 1
            self.consecutive[wid] = 0

    def _reject(self, wid: int, version: int, reason: str) -> str:
        self._count(wid, reason)
        self.consecutive[wid] = self.consecutive.get(wid, 0) + 1
        if self.consecutive[wid] >= self.policy.quarantine_after:
            self.quarantine(wid, version)
        return reason

    def _count(self, wid: int, reason: str):
        self.rejections[wid] = self.rejections.get(wid, 0) + 1
        self.reasons[reason] = self.reasons.get(reason, 0) + 1

    def counters(self) -> dict:
        return {
            "rejections": sum(self.rejections.values()),
            "rejections_by_worker": dict(self.rejections),
            "rejection_reasons": dict(self.reasons),
            "quarantines": self.quarantines,
        }


class DivergenceDetector:
    """Post-apply trajectory check: the validation loss after an apply must
    stay finite and below `factor x` the best loss seen — a finite but
    poisoned update (huge-yet-representable gradient) trips here, one apply
    after it slipped past the per-push screen."""

    def __init__(self, factor: float):
        self.factor = float(factor)
        self.best = np.inf

    def update(self, avg: float) -> bool:
        """Record one post-apply validation loss; True -> diverged."""
        if not np.isfinite(avg):
            return True
        if np.isfinite(self.best) and avg > self.factor * max(self.best, 1e-12):
            return True
        self.best = min(self.best, float(avg))
        return False


class StepScreen:
    """The mesh train step's screen at `level` ("finite" | "full"); see the
    module docstring. `repro_torch.engine.mesh`'s train step calls `admit`
    once: before the update when `out_of_place` is False, after the
    out-of-place update (with its new params) when it is True."""

    def __init__(self, level: str, factor: float):
        if level not in ("finite", "full"):
            raise ValueError(f"sentinel level must be 'finite' or 'full', got {level!r}")
        self.level = level
        self.factor = float(factor)

    @property
    def out_of_place(self) -> bool:
        return self.level == "full"

    def admit(self, loss, prev_avg_loss, new_params=None) -> bool:
        """True -> commit the step. One host read."""
        import torch

        from repro_torch.common import tree_leaves

        ok = torch.isfinite(loss)
        if self.level == "full":
            spike = torch.isfinite(prev_avg_loss) & (
                loss > self.factor * torch.abs(prev_avg_loss).to(loss.dtype))
            ok = ok & ~spike
            for leaf in tree_leaves(new_params):
                # min and max are finite iff every element is (NaN propagates)
                lo, hi = torch.aminmax(leaf)
                ok = ok & torch.isfinite(lo) & torch.isfinite(hi)
        return bool(ok)


def wrap_step_sentinel(step_fn, level: str, factor: float):
    """Screen a mesh train step: `guarded(params, gstate, batch)` runs
    `step_fn` (a `repro_torch.engine.mesh.build_train_step` step, which takes
    a `screen`) and commits its update only when the step is sane; otherwise
    it returns the input params and gstate unchanged, the batch consumed.
    Adds `metrics["rejected"]` (0 or 1).

    level "finite" checks the step loss; "full" additionally checks every
    updated parameter leaf and rejects a loss above `factor x
    |prev_avg_loss|` (the GuidedState's previous average loss; its inf init
    passes the first steps through the isfinite gate)."""
    screen = StepScreen(level, factor)

    def guarded(params, gstate, batch):
        return step_fn(params, gstate, batch, screen=screen)

    return guarded
