"""Fault-injection scenarios for the live async backend (a copy of
`repro.dist.scenarios`).

A `Scenario` is everything that makes a live run deviate from the happy path:
per-worker slowdowns (the compute-time topology scaled to wall-clock via
`time_scale`), dropped updates (the chief discards a seeded fraction of
pushes), and versioned lifecycle events — kill a worker's process when the
store reaches a version, restart it, or join a fresh elastic worker. Events
are keyed on store VERSION, not wall time, so scenarios are loosely
reproducible across machines of different speed.

The launcher polls the store and fires due events; the chief/store tolerate
every one of them by construction (a dead connection is counted, a reconnect
resumes the wid, the step budget is filled by whoever still pushes), which is
exactly the property tests/test_torch_dist.py and chip_smoke.py's
`dist_live` phase lock in.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative fault plan for one live run (see spec.DIST_EVENT_OPS)."""

    drop_rate: float = 0.0       # fraction of pushes the chief discards
    time_scale: float = 0.0      # seconds per sampled compute-time unit
    events: Tuple = ()           # ((op, wid, at_version), ...), version-sorted

    @classmethod
    def from_spec(cls, spec) -> "Scenario":
        return cls(
            drop_rate=spec.dist_drop_rate,
            time_scale=spec.dist_time_scale,
            events=tuple(sorted(spec.dist_events, key=lambda ev: ev[2])),
        )

    def due(self, fired: int, version: int):
        """Events [fired:] whose trigger version has been reached."""
        out = []
        for ev in self.events[fired:]:
            if version >= ev[2]:
                out.append(ev)
            else:
                break
        return out
