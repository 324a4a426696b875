#!/usr/bin/env python3
"""Times builds of the selective-scan kernel that differ from the shipped one
by text edits of its source, on one NVIDIA GPU.

    python3 scripts/scan_builds.py [--parent DIR]

A measurement, not part of the port: the edits (BUILDS) are tied to the
text of src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu, and
the script stops, naming the edit, when the source no longer holds it. With
--parent DIR (an earlier checkout, e.g. `git archive` of an earlier commit
unpacked under results/), that checkout's kernel, unedited, is built and
timed in the same turns as `parent_as_is`. Every build is compiled with
nvcc into a temporary directory (all at once) and timed as chip_smoke.py
times kernels (timing.time_ms, L2 flushed), in turns (forward, then
backward order), at the hybrid path's shape (B=1, S=2048, ed=16384, n=16,
inputs drawn as the model draws them).

- as_is: the source unedited; its error against the plain version is
  printed, and it is timed once more followed by a copy of y
  (`as_is+cat`), as is the parent's.
- no_exp: ex2 replaced by a multiply, so the special-function units are
  taken out.
- no_loads: device memory is read only at the start: the consumers reuse
  the first staged chunk.
- no_store: y is not written back to device memory.

The attribution builds' outputs are wrong by design. Prints one JSON line
with the card's name and power limit, and each build's registers and spills
as ptxas reports them for the n = 16 kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.timing import nvidia_smi, time_ms  # noqa: E402

REL = os.path.join("src", "repro_torch", "kernels", "selective_scan", "csrc", "selective_scan.cu")
SRC = os.path.join(HERE, os.pardir, REL)
B, S, ED, N = 1, 2048, 16384, 16

# build -> edits (old text, new text) of the shipped kernel's source
BUILDS = {
    "as_is": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));', "out = v * 0.5f;")],
    "no_loads": [
        ("    if (k + STAGES - 1 < chunks) load_chunk<R>(sm, a, b, e0, k + STAGES - 1);\n", ""),
        ("    const int s = k % STAGES, rows", "    const int s = 0, rows")],
    "no_store": [("    if (k > 0) store_chunk<R>(sm, a, b, e0, k - 1);\n", ""),
                 ("  store_chunk<R>(sm, a, b, e0, chunks - 1);\n", "")],
}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def start_builds(src_path: str, builds: dict, tag: str, tmp: str) -> dict:
    """name -> (library path, nvcc process), all started at once."""
    src = open(src_path).read()
    procs = {}
    for name, edits in builds.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{tag}{name}: the kernel source does not hold {old!r} once")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{tag}{name}.cu"), os.path.join(tmp, f"{tag}{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[tag + name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs: dict) -> tuple:
    """(name -> selective_scan_fwd, name -> ptxas's lines for the n = 16 kernel)."""
    fns, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} build:\n{log}")
        fn = ctypes.CDLL(so).selective_scan_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = fn
        # the kernel with the most registers is the one n = 16 runs (the most states a lane)
        used = re.findall(r"Used (\d+) registers.*", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        ptxas[name] = {"max_registers": max(map(int, used)) if used else None,
                       "max_spill_store_bytes": max(map(int, spills)) if spills else None}
    return fns, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="an earlier checkout whose kernel is timed beside this one")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_builds: no CUDA device; this script measures a GPU")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    g = torch.Generator(device=dev).manual_seed(100)
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x, Bc, Cc = r(B, S, ED), r(B, S, N), r(B, S, N)
    dt = torch.nn.functional.softplus(r(B, S, ED) + float(np.log(np.expm1(0.01))))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(ED, 1)
    yr, hr = selective_scan_ref(x, dt, A, Bc, Cc)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_builds(SRC, BUILDS, "", tmp)
        if args.parent:
            procs.update(start_builds(os.path.join(args.parent, REL), {"as_is": []},
                                      "parent_", tmp))
        fns, ptxas = finish_builds(procs)

        def build(fn):
            y, h = torch.empty_like(x), torch.empty(B, ED, N, device=dev)

            def run():
                rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                        None, y.data_ptr(), h.data_ptr(), B, S, ED, N, stream)
                kernels.check_launch("selective_scan build", rc)
                return y, h
            return run

        runs = {name: build(fn) for name, fn in fns.items()}
        for name in [n for n in runs if n.endswith("as_is")]:
            runs[name + "+cat"] = lambda run=runs[name]: torch.cat([run()[0]], 1)
        runs["kernel"] = lambda: ss_ops.selective_scan(x, dt, A, Bc, Cc)
        errs = {}
        for name in runs:
            if name in ("kernel", "as_is", "parent_as_is"):
                y, h = runs[name]()
                torch.cuda.synchronize()
                errs[name] = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        times = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                times[n].append(time_ms(runs[n], args.iters, flush))
    ms = {n: statistics.mean(t) for n, t in times.items()}
    exps, nbytes = B * S * ED * N, 4 * (3 * B * S * ED + 2 * B * S * N + ED * N + B * ED * N)
    print(json.dumps({"bench": "scan-builds", "card": nvidia_smi(), "B": B, "S": S, "ed": ED,
                      "n": N, "ms": ms, "ms_each_turn": times, "max_abs_err": errs,
                      "ptxas": ptxas, "exps": exps, "bytes": nbytes,
                      "gexp_per_s": {n: exps / t / 1e6 for n, t in ms.items()},
                      "tb_per_s": {n: nbytes / t / 1e9 for n, t in ms.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
