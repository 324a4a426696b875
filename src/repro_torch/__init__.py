"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

Paths and names mirror `repro` so each piece has an obvious counterpart.
This package imports `torch` and numpy only: never `jax`, never `repro`.
Entry points run on `device="cuda"` unless the caller asks for the CPU.
Hand-written CUDA kernels (under `kernels/*/csrc/`) are compiled with
`nvcc` at first use on a CUDA tensor; nothing is built at import time.
"""
