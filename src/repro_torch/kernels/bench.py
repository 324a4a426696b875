"""Measurements of the port's kernels on one NVIDIA GPU, beyond what
chip_smoke.py reports.

    PYTHONPATH=src python -m repro_torch.kernels.bench decode-profile
    PYTHONPATH=src python -m repro_torch.kernels.bench decode-time
    PYTHONPATH=src python -m repro_torch.kernels.bench guided-profile

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

guided-profile: torch.profiler over calls of each of the four guided-update
kernels, queued and flushed as decode-profile's, at the training path's
shape (30 seeds x (31, 2) weights, f64) and at one yi-9b FFN leaf (4096 x
11008; f32, f64, bf16): the median device time of the kernel itself, beside
its time as chip_smoke.py takes it (timing.time_ms, whose floor is the
timing method's) and its bytes bound (w, g, w_stale read and w' written in
the leaf's dtype, each accumulator read and written at f32 or f64); and
the device time of a kernel that adds 1 to one float, timed alike.

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
from repro_torch.kernels.guided_update import ops as gu_ops
from repro_torch.kernels.timing import PEAK_BYTES_S, SPIN_CYCLES, nvidia_smi, time_ms

DEC_LENS = [2100, 1500, 900, 180, 2048, 1337, 640, 1030]  # chip_smoke's ragged decode rows
HEADS = {"serve": (32, 4), "serve_hybrid": (64, 8)}       # yi-9b, jamba
# guided kernel -> the accumulators it carries
GUIDED = {"guided_sgd_update": 0, "guided_momentum_update": 1, "guided_rmsprop_update": 1,
          "guided_adam_update": 2}


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


def split_calls(kernels: list) -> list:
    """`kernels` (as device_kernels gives them) split into calls: each call is
    queued behind a spin kernel, and the L2 flush of the next call comes last
    before the next spin kernel, so it is dropped. Empty calls are dropped."""
    groups = []
    for k in kernels:
        if "sleep" in k[0] or "spin" in k[0]:
            groups.append([])
        elif groups:
            groups[-1].append(k)
    return [g for g in [g[:-1] for g in groups[:-1]] + groups[-1:] if g]


def profile_calls(call, calls: int, flush: torch.Tensor) -> list:
    """The kernels (name, start us, duration us) that each of `calls` calls
    launched, each call queued behind a spin kernel with the L2 flushed
    before it, after three calls to warm up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            call()
        torch.cuda.synchronize()
    per_call = split_calls(device_kernels(prof))
    if len(per_call) != calls:
        raise RuntimeError(f"bench: kernels for {len(per_call)} calls after {calls} spin kernels")
    return per_call


def decode_profile(calls: int = 30) -> None:
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    for path, (H, K) in HEADS.items():
        q, kc, vc, cl = decode_inputs(H, K, dev)
        B, S, dh = q.shape[0], kc.shape[1], q.shape[3]
        per_call = profile_calls(lambda: fd_ops.flash_decode(q, kc, vc, cl), calls, flush)
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


def guided_call(name, w, g, ws, accs):
    """One call of guided kernel `name` at the training path's hypers: lr 0.2,
    DC-ASGD lambda 0.04, adam at step 7."""
    if name == "guided_sgd_update":
        return gu_ops.guided_sgd_update_raw(w, g, ws, 0.2, 0.04)
    if name == "guided_momentum_update":
        return gu_ops.guided_momentum_update_raw(w, g, ws, accs[0], 0.2, 0.04, 0.9)
    if name == "guided_rmsprop_update":
        return gu_ops.guided_rmsprop_update_raw(w, g, ws, accs[0], 0.2, 0.04, 0.9, 1e-8)
    return gu_ops.guided_adam_update_raw(w, g, ws, accs[0], accs[1], 7, 0.2, 0.04, 0.9,
                                         0.999, 1e-8)


def first_kernel_us(call, calls: int, flush: torch.Tensor) -> list:
    """Device time (us) of the first kernel `call` launches, once per call,
    as profile_calls takes it."""
    return [c[0][2] for c in profile_calls(call, calls, flush)]


def guided_profile(calls: int = 50) -> None:
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, device=dev)
    floor = first_kernel_us(lambda: sink.add_(1.0), calls, flush)  # a one-float kernel
    for shape, dtype in (((30, 31, 2), torch.float64), ((4096, 11008), torch.float32),
                         ((4096, 11008), torch.float64), ((4096, 11008), torch.bfloat16)):
        ct = torch.promote_types(dtype, torch.float32)
        gen = torch.Generator(device=dev).manual_seed(5)
        w = torch.randn(shape, generator=gen, device=dev, dtype=ct)
        g = 0.01 * torch.randn(shape, generator=gen, device=dev, dtype=ct)
        ws = w + 0.05 * torch.randn(shape, generator=gen, device=dev, dtype=ct)
        accs = [torch.rand(shape, generator=gen, device=dev, dtype=ct) * sc for sc in (0.1, 0.05)]
        w, g, ws = w.to(dtype), g.to(dtype), ws.to(dtype)
        line = {"bench": "guided-profile", "card": nvidia_smi(), "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "one_float_kernel_device_us": statistics.median(floor), "kernels": {}}
        for name, n_acc in GUIDED.items():
            call = lambda: guided_call(name, w, g, ws, accs)  # noqa: E731
            durs = first_kernel_us(call, calls, flush)
            nbytes = w.numel() * (4 * w.element_size() + 2 * n_acc * accs[0].element_size())
            line["kernels"][name] = {
                "device_us": statistics.median(durs), "device_us_min": min(durs),
                "time_ms": time_ms(call, calls, flush), "bytes": nbytes,
                "bound_us": nbytes / PEAK_BYTES_S * 1e6}
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("decode-profile", "decode-time", "guided-profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; this script measures a GPU")
    if args.what == "decode-profile":
        decode_profile()
    elif args.what == "guided-profile":
        guided_profile()
    else:
        decode_time()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
