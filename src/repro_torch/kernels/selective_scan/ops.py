"""Public wrapper of the selective scan kernel (csrc/selective_scan.cu).

CUDA tensors launch the kernel (or raise); CPU tensors run
`selective_scan_ref`. `launches` counts kernel launches, and only those.
The kernel takes f32, contiguous inputs (aligned to 4 bytes at least), any
S >= 1 and any ed, and n <= 16.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

MAX_STATE = 16  # n the kernel takes: 2 lanes of at most 8 states per channel
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

launches = 0


def _check(x, dt, A, Bc, Cc, h0):
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"want x, dt (B,S,ed); got {tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, ed = x.shape
    if S < 1:
        raise ValueError("selective_scan needs S >= 1")
    if A.ndim != 2 or A.shape[0] != ed:
        raise ValueError(f"want A ({ed}, n); got {tuple(A.shape)}")
    n = A.shape[1]
    for name, a in (("Bc", Bc), ("Cc", Cc)):
        if a.shape != (B, S, n):
            raise ValueError(f"want {name} {(B, S, n)}; got {tuple(a.shape)}")
    if h0 is not None and h0.shape != (B, ed, n):
        raise ValueError(f"want h0 {(B, ed, n)}; got {tuple(h0.shape)}")


def selective_scan(x, dt, A, Bc, Cc, h0=None):
    """x, dt: (B,S,ed); A: (ed,n); Bc, Cc: (B,S,n); h0: (B,ed,n) or None
    (zeros). Returns (y (B,S,ed), h_final (B,ed,n)), both f32."""
    global launches
    _check(x, dt, A, Bc, Cc, h0)
    given = [a for a in (x, dt, A, Bc, Cc, h0) if a is not None]
    if not kernels.use_kernel(*given):
        return selective_scan_ref(x, dt, A, Bc, Cc, h0)
    kernels.refuse_autograd("selective_scan", *given)
    bad = sorted({str(a.dtype) for a in given if a.dtype != torch.float32})
    if bad:
        raise TypeError(f"selective_scan kernel takes float32 only, got {bad}")
    if not all(a.is_contiguous() for a in given):
        raise ValueError("selective_scan kernel needs contiguous inputs")
    B, S, ed = x.shape
    n = A.shape[1]
    if n > MAX_STATE or B > 65535:
        raise ValueError(f"selective_scan kernel takes n <= {MAX_STATE} and B <= 65535; "
                         f"got n={n}, B={B}")
    y = torch.empty_like(x)
    h = torch.empty((B, ed, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        fn = kernels.kernel_fn("selective_scan_fwd", _ARGTYPES)
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                B, S, ed, n, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("selective_scan", rc)
    launches += 1
    return y, h
