"""repro_torch's selective scan against repro.kernels.selective_scan.

The port's plain version (`selective_scan_ref`) and its wrapper
(`ops.selective_scan`, which runs that plain version on CPU tensors) against
the reference's `selective_scan_ref` and its Pallas kernel in interpret
mode, on the same numpy inputs, at atol 1e-4 (the reference's own bar in
tests/test_kernels.py: f32 recurrences over up to 128 steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro_torch.kernels.selective_scan import ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

torch.set_num_threads(1)

ATOL = 1e-4


def _inputs(seed, B, S, ed, n, with_h0=True):
    """The reference test's draws: x, B, C, h0 ~ N(0,1); dt = 0.1|N|; A = -|N|."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, dt = f(B, S, ed), np.abs(f(B, S, ed)) * 0.1
    A = -np.abs(f(ed, n))
    Bc, Cc = f(B, S, n), f(B, S, n)
    h0 = f(B, ed, n) if with_h0 else None
    return x, dt, A, Bc, Cc, h0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,ed,n,Q,be", [(2, 64, 128, 16, 16, 64), (1, 32, 64, 8, 8, 64),
                                           (2, 128, 256, 16, 32, 128), (1, 64, 64, 4, 64, 32)])
def test_scan_matches_the_reference_kernel_and_ref(B, S, ed, n, Q, be):
    arrays = _inputs(S + ed + n, B, S, ed, n)
    yk, hk = jax_selective_scan(*_jax(*arrays), chunk=Q, block_ed=be)   # Pallas, interpret
    yr, hr = jax_selective_scan_ref(*_jax(*arrays))
    n0 = ops.launches
    for fn in (selective_scan_ref, ops.selective_scan):
        y, h = fn(*_torch(*arrays))
        assert y.dtype == h.dtype == torch.float32
        assert y.shape == (B, S, ed) and h.shape == (B, ed, n)
        for want in ((yk, hk), (yr, hr)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=ATOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), atol=ATOL)
    assert ops.launches == n0  # CPU tensors run the plain version: no launch


def test_scan_state_chains_over_two_halves():
    x, dt, A, Bc, Cc, _ = _torch(*_inputs(5, 1, 64, 32, 8, with_h0=False))
    y_full, h_full = ops.selective_scan(x, dt, A, Bc, Cc)
    y1, h1 = ops.selective_scan(x[:, :32], dt[:, :32], A, Bc[:, :32], Cc[:, :32])
    y2, h2 = ops.selective_scan(x[:, 32:], dt[:, 32:], A, Bc[:, 32:], Cc[:, 32:], h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=ATOL)
    jy, jh = jax_selective_scan_ref(*_jax(*_inputs(5, 1, 64, 32, 8, with_h0=False)))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("S", [1, 24])
def test_scan_takes_lengths_the_tpu_tiling_refuses(S):
    """S = 1 and S = 24 (not a multiple of the TPU kernel's chunk of 16)
    against the reference's plain recurrence, with and without h0."""
    for with_h0 in (True, False):
        arrays = _inputs(S, 2, S, 48, 16, with_h0=with_h0)
        y, h = ops.selective_scan(*_torch(*arrays))
        yr, hr = jax_selective_scan_ref(*_jax(*arrays))
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=ATOL)


def test_scan_wrapper_refuses_mismatched_shapes():
    x, dt, A, Bc, Cc, h0 = _torch(*_inputs(0, 2, 8, 16, 4))
    with pytest.raises(ValueError, match="x, dt"):
        ops.selective_scan(x, dt[:, :4], A, Bc, Cc, h0)
    with pytest.raises(ValueError, match="A"):
        ops.selective_scan(x, dt, A[:8], Bc, Cc, h0)
    with pytest.raises(ValueError, match="Cc"):
        ops.selective_scan(x, dt, A, Bc, Cc[:, :, :2], h0)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(x, dt, A, Bc, Cc, h0[:1])
    with pytest.raises(ValueError, match="S >= 1"):
        ops.selective_scan(x[:, :0], dt[:, :0], A, Bc[:, :0], Cc[:, :0])


FLUSH, SPIN = ("elementwise_kernel<fill>", 0, 1.0), ("spin_kernel", 1, 1000.0)


@pytest.mark.parametrize("stream,calls", [
    # one kernel a call, each call's flush last before the next spin kernel
    ([FLUSH, SPIN, ("decode", 2, 9.0), FLUSH, SPIN, ("decode", 3, 8.0)],
     [[("decode", 2, 9.0)], [("decode", 3, 8.0)]]),
    # an elementwise kernel that is the call itself is kept
    ([FLUSH, SPIN, ("elementwise_kernel<add>", 2, 1.2), ("tail", 3, 1.0), FLUSH, SPIN,
      ("elementwise_kernel<add>", 4, 1.3)],
     [[("elementwise_kernel<add>", 2, 1.2), ("tail", 3, 1.0)],
      [("elementwise_kernel<add>", 4, 1.3)]]),
    # a call that launched nothing is dropped
    ([FLUSH, SPIN, FLUSH, SPIN, ("k", 5, 2.0)], [[("k", 5, 2.0)]]),
])
def test_bench_splits_a_profile_into_calls_at_the_spin_kernels(stream, calls):
    from repro_torch.kernels import bench

    assert bench.split_calls(stream) == calls


def test_measurement_scripts_refuse_to_run_without_a_card():
    import os
    import subprocess
    import sys

    from repro_torch.kernels import bench

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the scripts would measure it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["guided-profile"])
    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "scripts", "scan_builds.py")
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
