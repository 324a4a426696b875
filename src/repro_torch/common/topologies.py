"""Worker-speed / delay topologies: a copy of `repro.common.topologies`.

Per-dispatch compute-time samplers `sampler(worker_id, rng) -> float` shared
by the scan simulator's schedule generator (repro_torch.engine.delaysim
drives core.parameter_server._event_schedule with them to precompute a
DelaySchedule) and the live dist workers (repro_torch.dist.worker scales a
real worker's per-step sleep by the same draw, `compute_time_sampler`).
`None` keeps the reference loop's literal draw (rng.exponential(1.0) + 0.1),
preserving rng-stream parity with train_ps. "seq" and "barrier" are the
deterministic topologies of those execution modes and need no sampler.
tests/test_torch_spec_copies.py holds every sampler's draws equal to the
reference's. No torch: the dist workers import this module.
"""
from __future__ import annotations

TOPOLOGY_SAMPLERS = {
    "seq": None,
    "barrier": None,
    "exp": None,
    "constant": lambda w, rng: 1.0,
    "heavy_tail": lambda w, rng: 0.1 + rng.pareto(1.5),
    "straggler": lambda w, rng: (10.0 if w == 0 else 1.0) * rng.exponential(1.0) + 0.1,
    "hetero": lambda w, rng: rng.exponential(0.5 * (w + 2)) + 0.1,
}


def _exp_sampler(w: int, rng) -> float:
    """train_ps's literal compute-time draw (the `None` entries above)."""
    return rng.exponential(1.0) + 0.1


def compute_time_sampler(topology: str):
    """The sampler a REAL worker's compute time should follow for `topology`
    (the deterministic seq/barrier topologies fall back to the reference
    exponential draw — they describe arrival ordering, not speed)."""
    try:
        sampler = TOPOLOGY_SAMPLERS[topology]
    except KeyError:
        raise KeyError(
            f"unknown topology {topology!r}; known: {', '.join(TOPOLOGY_SAMPLERS)}"
        ) from None
    return sampler or _exp_sampler
