"""Hand-written Hopper kernels of the port, and the one policy that routes to them.

Device policy (replaces the reference's `default_interpret`): a wrapper given
CUDA tensors launches its kernel, or raises; given CPU tensors it runs the
kernel's plain PyTorch version (`ref.py` beside it). There is no fallback
from a failed launch to the plain version. No kernel has a backward (nor
has the TPU kernel it replaces): a wrapper refuses CUDA inputs that autograd
would have to differentiate through it (`refuse_autograd`).

Build: at first use on a card, every `kernels/*/csrc/*.cu` is compiled by
`nvcc` for sm_90a (one process per source, all started together), linked
into one shared library with a plain C interface, and loaded with ctypes.
The library lands in `<checkout>/build/kernels/`, named by a hash of the
sources and flags, so an edited source is rebuilt. Nothing is built or
loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LIB = None        # the loaded ctypes.CDLL, once built
_FNS = {}          # entry point name -> ctypes function with argtypes set


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on cuda or all on cpu, got {sorted(kinds)}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any input requires grad: the kernel's
    output would be silently cut from the graph and every gradient through
    it lost. Call it on the kernel's path, before the launch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the TPU kernel it "
            f"replaces), so autograd cannot differentiate through it; call it under "
            f"torch.no_grad() or on tensors that do not require grad (training "
            f"attention: cfg.attn_impl='xla')")


def sources() -> list:
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every kernel source in parallel and link one shared library.
    Returns its path; reuses a library built from identical sources."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *(str(o) for _, o, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


def kernel_fn(name: str, argtypes: list):
    """The C entry point `name` with its ctypes signature set (int return)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def dtype_code(dtype: torch.dtype, allowed=(torch.float32, torch.bfloat16)) -> int:
    """The C entry points' dtype argument: 0 = float32, 1 = bfloat16,
    2 = float64. `allowed` names the dtypes the caller's kernel is built for
    (the attention kernels: float32 and bfloat16)."""
    if dtype not in allowed:
        names = ", ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"kernel takes {names}, got {dtype}")
    return _DTYPE_CODES[dtype]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA `device`, read once per device (grids are sized
    per card, so a host with mixed cards sizes each launch for its own)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
