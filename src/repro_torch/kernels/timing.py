"""Device time of one call on an NVIDIA GPU: the one method behind
chip_smoke.py's kernel times and `python -m repro_torch.kernels.bench`."""
from __future__ import annotations

import subprocess

import torch

SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3: the memory rate every bytes bound uses


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush: torch.Tensor, *, read_flush: bool = False) -> float:
    """Mean device time of fn() over `iters` calls, L2 flushed before each by
    writing `flush` (larger than the L2), or by reading it if `read_flush`:
    a write leaves the L2 full of dirty lines that fn's misses must write
    back, a read leaves it clean. A spin kernel queued ahead of the start
    event keeps the card busy while the host enqueues fn, so the wrapper's
    host time is not counted."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters
