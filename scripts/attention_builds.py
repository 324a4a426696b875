#!/usr/bin/env python3
"""Times builds of the bf16 flash_attention kernel that differ from the
shipped one by text edits of its source, on one NVIDIA GPU.

    python3 scripts/attention_builds.py

A measurement, not part of the port: the edits (BUILDS) are tied to the
text of src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu
and the script stops, naming the edit, when the source no longer holds it.
Each build is compiled with nvcc into a temporary directory (all at once)
and timed as chip_smoke.py times kernels, in turns (forward, then backward
order), at the two serve paths' prefill shapes (B=1, S=2048, causal, d_head
128; yi-9b's 32/4 heads and jamba's 64/8), beside the shipped kernel and
the SIMT kernel on the same inputs.

- rung1, rung2: the kernel as it was built up. rung1 has one consumer
  warpgroup (64 query rows a CTA) that issues its own TMA copies; rung2
  adds the producer warpgroup. The shipped kernel is the third rung (two
  consumer warpgroups). Their error against the plain version is printed.
- no_kv_copies (the consumers read whatever the ring holds), copies_only
  (no products, no softmax) and no_softmax: one part of the work taken
  out, so their times say what each part costs. Their outputs are wrong
  by design.

Prints one JSON line per shape, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.timing import nvidia_smi, time_ms  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "flash_attention", "csrc",
                   "flash_attention_wgmma.cu")
HEADS = {"serve": (32, 4), "serve_hybrid": (64, 8)}  # yi-9b, jamba

_ONE_CONSUMER = ("  static constexpr int NCONS = 2;", "  static constexpr int NCONS = 1;")
_QK = "      cs.issue_qk(sc, s);\n      wg_wait<0>();\n"
_PV = "      cs.issue_pv(s);\n      wg_wait<0>();\n"
_SOFTMAX = "      cs.softmax(sc, t.kv_begin + i * BK);\n      cs.rescale();\n"
# build -> edits (old text, new text) of flash_attention_wgmma.cu
BUILDS = {
    "rung1": [
        _ONE_CONSUMER,
        ("  static constexpr int THREADS = WG + NCONS * WG;",
         "  static constexpr int THREADS = NCONS * WG;"),
        ("  if (tid < WG) {\n", "  if (false) {\n"),
        ("    const int ctid = tid - WG;\n", "    const int ctid = tid;\n"),
        ("    mbar_wait(sm.q_full, 0);\n",
         "    if (ctid == 0) {\n"
         "      load_q<DH>(&tq, sm, t);\n"
         "      for (int i = 0; i < min(STAGES, t.n_tiles); ++i) load_kv<DH>(&tk, &tv, sm, t, i);\n"
         "    }\n"
         "    __syncwarp();\n"
         "    mbar_wait(sm.q_full, 0);\n"),
        ("      cs.release(&sm.v_empty[s]);\n",
         "      cs.release(&sm.v_empty[s]);\n"
         "      if (ctid == 0 && i + STAGES < t.n_tiles) load_kv<DH>(&tk, &tv, sm, t, i + STAGES);\n"
         "      __syncwarp();\n")],
    "rung2": [_ONE_CONSUMER],
    "no_kv_copies": [
        ("      for (int i = 0; i < t.n_tiles; ++i) load_kv<DH>(&tk, &tv, sm, t, i);\n", ""),
        ("      mbar_wait(&sm.k_full[s], ph);\n", ""), ("      mbar_wait(&sm.v_full[s], ph);\n", "")],
    "copies_only": [(_QK, "      wg_wait<0>();\n"), (_PV, "      wg_wait<0>();\n"),
                    (_SOFTMAX + "      cs.to_p(sc);\n", "")],
    "no_softmax": [(_SOFTMAX, "")],
}
CORRECT_BUILDS = ("rung1", "rung2")


def build_all(tmp: str) -> dict:
    """name -> the build's flash_attention_wgmma_fwd, compiled in parallel."""
    src = open(SRC).read()
    procs = {}
    for name, edits in BUILDS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the kernel source does not hold {old!r} once")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} build:\n{log}")
        fn = ctypes.CDLL(so).flash_attention_wgmma_fwd
        fn.argtypes, fn.restype = fa_ops._WGMMA_ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def main(iters: int = 20) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attention_builds: no CUDA device; this script measures a GPU")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(tmp)
        for path, (H, K) in HEADS.items():
            g = torch.Generator(device=dev).manual_seed(11)
            S, dh = 2048, 128
            q = torch.randn(1, S, H, dh, generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn(1, S, K, dh, generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn(1, S, K, dh, generator=g, device=dev).to(torch.bfloat16)
            ref = attention_ref(q, k, v, causal=True)
            stream = torch.cuda.current_stream().cuda_stream

            def build(fn, out):
                def run():
                    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, S, H, K,
                            dh, 1, 0, 1.0 / math.sqrt(dh), stream)
                    kernels.check_launch("flash_attention build", rc)
                    return out
                return run

            runs = {"simt": lambda: fa_ops.run_variant(q, k, v, causal=True, variant="simt"),
                    "kernel": lambda: fa_ops.run_variant(q, k, v, causal=True, variant="wgmma")}
            for name, fn in fns.items():
                runs[name] = build(fn, torch.empty_like(q))
            errs = {n: (runs[n]().float() - ref).abs().max().item()
                    for n in ("simt", "kernel", *CORRECT_BUILDS)}
            times = {n: [] for n in runs}
            for order in (list(runs), list(runs)[::-1]):
                for n in order:
                    times[n].append(time_ms(runs[n], iters, flush))
            flops = 4 * dh * (S * (S + 1) // 2) * H
            ms = {n: statistics.mean(t) for n, t in times.items()}
            print(json.dumps({"bench": "attention-builds", "card": nvidia_smi(), "path": path,
                              "B": 1, "S": S, "H": H, "K": K, "dh": dh, "causal": True,
                              "ms": ms, "ms_each_turn": times, "max_abs_err": errs,
                              "tflops": {n: flops / t / 1e9 for n, t in ms.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
