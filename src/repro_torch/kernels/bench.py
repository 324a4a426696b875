"""Measurements of the serve-path attention kernels on one NVIDIA GPU, beyond
what chip_smoke.py reports.

    PYTHONPATH=src python -m repro_torch.kernels.bench decode-profile
    PYTHONPATH=src python -m repro_torch.kernels.bench decode-time

decode-profile: torch.profiler over `flash_decode` calls at the two serve
paths' decode shapes (B=8 over the 2112-slot pool, ragged lengths, bf16,
dh=128; yi-9b's 32/4 heads and jamba's 64/8). Each call is queued behind a
spin kernel, so everything it launches is already waiting when the card
reaches it, and the L2 cache is flushed before each (as chip_smoke.py times
kernels). Per call: the device time of every kernel the call launched, the
gaps between them, and the span from the first kernel's start to the last
one's end; medians over the calls.

decode-time: at the same shapes, flash_decode's time as chip_smoke.py takes
it (timing.time_ms: CUDA events around one call, L2 flushed by a write,
queued behind a spin kernel), beside scaled_dot_product_attention's on the
same inputs, a torch.sum over as many contiguous bytes as the valid K and V
rows hold (what reading those bytes fresh takes this way), and the method's
floor (one trivial kernel timed alike). The kernel, the sum and the floor
are timed again with the L2 flushed by a read, which leaves no dirty lines
for their misses to write back (`*_read_flush_ms`).

Each prints one JSON line per shape, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile

import torch

from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.timing import SPIN_CYCLES, nvidia_smi, time_ms

DEC_LENS = [2100, 1500, 900, 180, 2048, 1337, 640, 1030]  # chip_smoke's ragged decode rows
HEADS = {"serve": (32, 4), "serve_hybrid": (64, 8)}       # yi-9b, jamba


def device_kernels(prof) -> list:
    """(name, start us, duration us) of every device kernel in a profile, in
    start order, read from its chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ks = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
          if e.get("cat") == "kernel" and "dur" in e]
    return sorted(ks, key=lambda k: k[1])


def decode_profile(calls: int = 30) -> None:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    for path, (H, K) in HEADS.items():
        q, kc, vc, cl = decode_inputs(H, K, dev)
        B, S, dh = q.shape[0], kc.shape[1], q.shape[3]
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
        for _ in range(3):
            fd_ops.flash_decode(q, kc, vc, cl)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
                fd_ops.flash_decode(q, kc, vc, cl)
            torch.cuda.synchronize()
        # split the kernel stream at the spin kernels: what follows one is one call
        per_call, cur = [], None
        for name, ts, dur in device_kernels(prof):
            if "sleep" in name or "spin" in name:
                cur = []
                per_call.append(cur)
            elif cur is not None and "elementwise" not in name:  # not the L2 flush
                cur.append((name, ts, dur))
        per_call = [c for c in per_call if c]
        names = [n for n, _, _ in per_call[0]]
        kernels = [{"name": n[:60], "device_us": statistics.median(c[i][2] for c in per_call)}
                   for i, n in enumerate(names)]
        gaps = [statistics.median(c[i + 1][1] - (c[i][1] + c[i][2]) for c in per_call)
                for i in range(len(names) - 1)]
        span = statistics.median(c[-1][1] + c[-1][2] - c[0][1] for c in per_call)
        print(json.dumps({"bench": "decode-profile", "card": nvidia_smi(), "path": path,
                          "B": B, "S": S, "H": H, "K": K, "dh": dh, "cache_len": DEC_LENS,
                          "calls": len(per_call), "kernels_per_call": len(names),
                          "kernels": kernels, "gaps_us": gaps, "span_us": span}), flush=True)


def decode_inputs(H: int, K: int, dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, dh = len(DEC_LENS), 2112, 128
    q = torch.randn(B, 1, H, dh, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(B, S, K, dh, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, S, K, dh, generator=g, device=dev).to(torch.bfloat16)
    return q, kc, vc, torch.tensor(DEC_LENS, dtype=torch.int32, device=dev)


def decode_time(iters: int = 50) -> None:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sink = torch.empty(1, device=dev)
    for path, (H, K) in HEADS.items():
        q, kc, vc, cl = decode_inputs(H, K, dev)
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        mask = (torch.arange(kc.shape[1], device=dev)[None] < cl[:, None])[:, None, None, :]
        valid_bytes = 2 * int(torch.clamp(cl, max=kc.shape[1]).sum()) * K * kc.shape[3] * 2
        same_bytes = torch.zeros(valid_bytes // 4, device=dev)
        line = {"bench": "decode-time", "card": nvidia_smi(), "path": path, "H": H, "K": K,
                "valid_kv_bytes": valid_bytes,
                "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), iters, flush)}
        timed = {"flash_decode": lambda: fd_ops.flash_decode(q, kc, vc, cl),
                 "sum_same_bytes": lambda: same_bytes.sum(), "floor": lambda: sink.zero_()}
        for read_flush in (False, True):
            for name, fn in timed.items():
                key = f"{name}_read_flush_ms" if read_flush else f"{name}_ms"
                line[key] = time_ms(fn, iters, flush, read_flush=read_flush)
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("decode-profile", "decode-time"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; this script measures a GPU")
    if args.what == "decode-profile":
        decode_profile()
    else:
        decode_time()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
