#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      card name and power limit (nvidia-smi), torch and CUDA versions;
            TF32 is turned off for matmuls and cuDNN.
2. build    nvcc builds every kernel of the port from its .cu source (sm_90a).
3. kernels  each kernel against its plain PyTorch version on the card, at
            yi-9b's head shapes (H=32, K=4, dh=128), in bf16 and f32, ragged
            lengths included; max abs error beside its bar, kernel / plain /
            library (scaled_dot_product_attention, a yardstick only) times,
            and the least time the card could take (bytes or FLOPs bound).
4. serve    the main path: yi-9b at full width and depth (48 layers, bf16,
            random weights from --seed) behind ServeEngine(max_batch=8),
            16 staggered requests; every kernel launch counter is zeroed just
            before and read just after, and must match the path's structure.
5. parity   yi-9b at full width, 4 layers: a 1000-token prefill and 8 decode
            steps through the kernels against the same through the plain
            versions; logits compared at a bf16 bar.

Then a line with the card's name and power limit, a {"kernels": [...]} line,
and last {"ok": true, "device": {...}}. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_S = 3.35e12                     # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
              torch.float32: 67e12}        # f32 outside the tensor cores
BARS = {torch.bfloat16: 2e-2, torch.float32: 3e-5}   # the reference's kernel bars
# Path parity: both paths compute attention in f32 and round to bf16, so they
# differ only where the summation order flips a bf16 rounding of an attention
# output (1 ulp, 2^-8 relative); through 4 layers that moves logits of O(1)
# by at most a few bf16 ulps of their size.
PARITY_BAR = 0.1
SPIN_CYCLES = 2_000_000                     # ~1 ms at H100 clocks
ATTN_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DECODE_SRC = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of fn() over `iters` calls, L2 flushed before each.
    A spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues fn, so the wrapper's host time is not counted."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def attention_work(B, S, H, K, dh, window, dtype):
    """FLOPs and bytes of causal (sliding-window) attention: 4*dh FLOPs per
    visible (query, key) pair; q, k, v read once and the output written once."""
    seen = np.arange(1, S + 1)
    if window:
        seen = np.minimum(seen, window)
    elt = torch.tensor([], dtype=dtype).element_size()
    return 4 * dh * int(seen.sum()) * B * H, (2 * B * S * H * dh + 2 * B * S * K * dh) * elt


def decode_work(B, S, H, K, dh, lens, dtype):
    valid = int(np.minimum(lens, S).sum())
    elt = torch.tensor([], dtype=dtype).element_size()
    return 4 * dh * H * valid, (2 * B * H * dh + 2 * K * dh * valid) * elt + 4 * B


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phases


def check_attention(fa_ops, attention_ref, dev, flush, *, S, window, dtype, seed):
    import torch.nn.functional as F

    B, H, K, dh = 1, 32, 4, 128
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, K, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, K, dh, generator=g, device=dev).to(dtype)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = (out.float() - attention_ref(q, k, v, causal=True, window=window)).abs().max().item()
    ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True, window=window), 10, flush)
    plain = time_ms(lambda: attention_ref(q, k, v, causal=True, window=window), 3, flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    i = torch.arange(S, device=dev)
    mask = (i[:, None] >= i[None, :]) & ((i[:, None] - i[None, :]) < window) if window else None
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True), 10, flush)
    flops, nbytes = attention_work(B, S, H, K, dh, window, dtype)
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"kernel": "flash_attention", "dtype": str(dtype).replace("torch.", ""),
            "B": B, "S": S, "H": H, "K": K, "dh": dh, "causal": True, "window": window,
            "max_abs_err": err, "bar": BARS[dtype], "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}


def check_decode(fd_ops, decode_ref, dev, flush, *, S, lens, dtype, seed):
    import torch.nn.functional as F

    B, H, K, dh = len(lens), 32, 4, 128
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, dh, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, S, K, dh, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, S, K, dh, generator=g, device=dev).to(dtype)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = fd_ops.flash_decode(q, kc, vc, cl)
    torch.cuda.synchronize()
    err = (out.float() - decode_ref(q, kc, vc, cl)).abs().max().item()
    ms = time_ms(lambda: fd_ops.flash_decode(q, kc, vc, cl), 20, flush)
    plain = time_ms(lambda: decode_ref(q, kc, vc, cl), 5, flush)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    valid = torch.arange(S, device=dev)[None] < torch.clamp(cl, max=S)[:, None]
    mask = valid[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True), 20, flush)
    flops, nbytes = decode_work(B, S, H, K, dh, np.asarray(lens), dtype)
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"kernel": "flash_decode", "dtype": str(dtype).replace("torch.", ""),
            "B": B, "S": S, "H": H, "K": K, "dh": dh, "cache_len": list(lens),
            "max_abs_err": err, "bar": BARS[dtype], "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}


def serve_main_path(T, serve, fa_ops, fd_ops, cfg, dev, seed):
    rng = np.random.default_rng(seed)
    n_req = 16
    lens = rng.integers(128, 2049, n_req)
    lens[:4] = (128, 2048, 1000, 1337)        # both ends and two ragged lengths
    gens = rng.integers(32, 65, n_req)
    max_len = 2048 + 64
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.model_init(gen, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = serve.ServeEngine(params, cfg, max_batch=8, max_len=max_len)
    engine.run([serve.Request(rng.integers(0, cfg.vocab_size, 64).tolist(), max_new_tokens=4)])
    engine.reset_stats()

    reqs = []
    for i in range(n_req):
        sp = (serve.SamplingParams(method="topk", top_k=40, temperature=0.8, seed=seed + i)
              if i % 4 == 3 else serve.SamplingParams())
        reqs.append(serve.Request(rng.integers(0, cfg.vocab_size, int(lens[i])).tolist(),
                                  max_new_tokens=int(gens[i]), sampling=sp))
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0
    fd_ops.launches = 0
    for r in reqs:
        engine.submit(r)
    decode_ms, decode_tokens = [], 0
    while True:
        n_pre, n_slots = engine.prefill_calls, engine.slot_steps
        t = time.perf_counter()
        if not engine.step():
            break
        if engine.prefill_calls == n_pre:
            decode_ms.append((time.perf_counter() - t) * 1e3)
            decode_tokens += engine.slot_steps - n_slots
    launches = {"flash_attention": fa_ops.launches, "flash_decode": fd_ops.launches}
    stats = engine.stats()
    comps = engine.completions
    if len(comps) != n_req:
        raise RuntimeError(f"served {len(comps)} of {n_req} requests")
    for c in comps:
        r = reqs[c.request_id - 1]  # id 0 was the warm-up request
        if c.new_tokens != r.max_new_tokens or not all(0 <= x < cfg.vocab_size for x in c.tokens):
            raise RuntimeError(f"request {c.request_id}: bad completion {c.tokens[:8]}...")
    want = {"flash_attention": cfg.n_layers * stats["prefill_calls"],
            "flash_decode": cfg.n_layers * stats["decode_steps"]}
    if launches != want or min(launches.values()) <= 0:
        raise RuntimeError(f"kernel launches {launches} != one per layer per call {want}")
    prof = profile_decode(engine, serve, cfg, rng)
    result = {
        "phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.compute_dtype, "max_batch": 8, "max_len": max_len, "requests": n_req,
        "prompt_lens": [int(x) for x in lens], "new_tokens": [int(x) for x in gens],
        "init_s": init_s, "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "decode_tok_s": decode_tokens / (sum(decode_ms) / 1e3),
        "median_decode_step_ms": statistics.median(decode_ms),
        "mean_ttft_s": stats["mean_ttft_s"], "prefill_calls": stats["prefill_calls"],
        "decode_steps": stats["decode_steps"], "occupancy": stats["occupancy"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    emit(prof)
    del engine, params
    torch.cuda.empty_cache()
    return result


def engine_prefill(engine, tokens):
    """The prefill an admission runs, into fresh caches of the prompt's length."""
    from repro_torch.models import transformer as T

    return T.prefill(engine.params, {"tokens": tokens}, engine.cfg,
                     total_len=tokens.shape[1])


def profile_decode(engine, serve, cfg, rng, steps: int = 8):
    """torch.profiler over `steps` decode-only engine steps with all 8 slots
    busy (prompts of 1024 tokens): the card's busy share of the wall time
    and the kernels that take it; then one request's prefill time at three
    prompt lengths."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(engine.max_batch):
        engine.submit(serve.Request(rng.integers(0, cfg.vocab_size, 1024).tolist(),
                                    max_new_tokens=steps + 4))
    engine.step()  # admits all 8, then one decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run()
    prefill_ms = {}
    for n in (128, 1000, 2048):  # one request's prefill, wall clock, after a warm-up
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(engine.device)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine_prefill(engine, toks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms[str(n)] = statistics.median(times[1:])
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"phase": "profile", "decode_steps": steps, "active_slots": engine.max_batch,
            "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": dev_ms / steps,
            "device_busy_share": dev_ms / wall_ms, "prefill_ms": prefill_ms,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms_per_step": e.self_device_time_total / 1e3 / steps}
                            for e in top]}


def path_parity(T, L, refs, cfg, dev, seed):
    attention_ref, decode_ref = refs
    cfg4 = cfg.replace(n_layers=4)
    params = T.model_init(torch.Generator(device=dev).manual_seed(seed + 1), cfg4, dev)
    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1000))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1, 1))).to(dev)

    def run():
        logits, caches = T.prefill(params, {"tokens": prompt}, cfg4, total_len=1008)
        out = [logits.float()]
        for i in range(8):
            t = torch.tensor([1000 + i], dtype=torch.int32, device=dev)
            logits, caches = T.decode_step(params, caches, steps[i], t, cfg4)
            out.append(logits.float())
        return torch.stack(out)

    kernel = run()
    with mock.patch.object(L, "flash_attention", lambda q, k, v, causal, window: attention_ref(
            q, k, v, causal=causal, window=window).to(q.dtype)), \
         mock.patch.object(L, "flash_decode", lambda q, kc, vc, cl: decode_ref(
            q, kc, vc, cl).to(q.dtype)):
        plain = run()
    if not torch.isfinite(kernel).all():
        raise RuntimeError("non-finite logits through the kernels")
    err = (kernel - plain).abs().max().item()
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    res = {"phase": "parity", "n_layers": 4, "prefill_len": 1000, "decode_steps": 8,
           "max_abs_err": err, "bar": PARITY_BAR, "logit_absmax": plain.abs().max().item(),
           "argmax_agree": agree}
    if err > PARITY_BAR:
        raise RuntimeError(f"path parity: max abs logit diff {err} > {PARITY_BAR}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import kernels
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": os.path.relpath(path, HERE),
          "sources": [os.path.relpath(s, HERE) for s in kernels.sources()]})

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (1000, 4096):
            for window in (0, 1024):
                checks.append(check_attention(fa_ops, attention_ref, dev, flush, S=S,
                                              window=window, dtype=dtype, seed=S + window))
        for S in (1280, 8192):
            lens = [S, 3 * S + 17, 1, S // 2 + 3, 700, S - 1, 2 * S, 129]  # full, wrapped, ragged
            checks.append(check_decode(fd_ops, decode_ref, dev, flush, S=S, lens=lens,
                                       dtype=dtype, seed=S))
    # the shapes the main path gives each kernel: its longest prefill (2048
    # tokens, yi-9b's 8192 window) and a decode step over its 2112-slot pool
    main_attn = check_attention(fa_ops, attention_ref, dev, flush, S=2048, window=8192,
                                dtype=torch.bfloat16, seed=1)
    main_dec = check_decode(fd_ops, decode_ref, dev, flush, S=2112,
                            lens=[2100, 1500, 900, 180, 2048, 1337, 640, 1030],
                            dtype=torch.bfloat16, seed=2)
    checks += [dict(main_attn, main_path_shape=True), dict(main_dec, main_path_shape=True)]
    for c in checks:
        emit({"phase": "kernels", **c})
    bad = [c for c in checks if not c["max_abs_err"] <= c["bar"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain version: {bad}")

    cfg = get_config("yi-9b")
    served = serve_main_path(T, serve, fa_ops, fd_ops, cfg, dev, args.seed)
    emit(served)
    emit(path_parity(T, L, (attention_ref, decode_ref), cfg, dev, args.seed))

    entries = []
    for name, src, replaces, c in (
            ("flash_attention", ATTN_SRC, "src/repro/kernels/flash_attention/kernel.py:27",
             main_attn),
            ("flash_decode", DECODE_SRC, "src/repro/kernels/flash_decode/kernel.py:22", main_dec)):
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": served["launches"][name], "max_abs_err": c["max_abs_err"],
                        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(card, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
