"""`repro_torch.resilience` — the self-healing layer.

  * `wrap_step_sentinel` / `StepScreen` — the mesh train step's divergence
    sentinel: a rejected step leaves the params and the whole GuidedState
    as they were (sentinel.py);
  * `SentinelPolicy` / `GradScreen` / `DivergenceDetector` — divergence
    screening on the dist chief's push path, with rollback / lr-backoff /
    quarantine remediation (sentinel.py);
  * `LeaseTable` / `Supervisor` — chief-side heartbeat leases and the
    worker-process supervisor: respawn under capped backoff + jitter,
    eviction of persistent stragglers (supervisor.py).

Verified checkpoints live in `repro_torch.checkpoint`, the fault injectors
in `repro_torch.chaos`. Numpy and the standard library at import (the step
screen imports torch when it runs).
"""
from repro_torch.resilience.sentinel import (
    DivergenceDetector,
    GradScreen,
    SentinelPolicy,
    StepScreen,
    wrap_step_sentinel,
)
from repro_torch.resilience.supervisor import LeaseTable, Supervisor

__all__ = [
    "DivergenceDetector",
    "GradScreen",
    "LeaseTable",
    "SentinelPolicy",
    "StepScreen",
    "Supervisor",
    "wrap_step_sentinel",
]
