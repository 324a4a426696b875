"""Consistency statistics (port of `repro.core.consistency`, paper Section 4).

A worker's mini-batch is *consistent* at step t when its own loss delta moves
in the same (descending) direction as the average training loss. The score
accumulated over a delay-tolerance window rho is:
    +1 + mag * relative-improvement    if both worker and average loss improved
     0                                 otherwise
so ranking prefers workers that improved, tie-broken by how much.
"""
from __future__ import annotations

import torch


def consistency_increment(worker_loss, prev_worker_loss, avg_loss, prev_avg_loss,
                          magnitude_weight: float = 0.1):
    """worker_loss: (c,) current per-worker mini-batch losses.
    Returns (c,) score increments in [0, 1 + magnitude_weight]."""
    d_worker = worker_loss - prev_worker_loss
    d_avg = avg_loss - prev_avg_loss
    both_improve = (d_worker < 0) & (d_avg < 0)
    rel = torch.clamp(-d_worker / (torch.abs(prev_worker_loss) + 1e-8), 0.0, 1.0)
    return torch.where(both_improve, 1.0 + magnitude_weight * rel, torch.zeros_like(rel))
