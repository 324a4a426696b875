"""The hand-written CUDA kernels on the card, against their plain versions.

The `cuda` fixture skips them without an NVIDIA GPU (the kernels have no
CPU mode). This file imports no JAX, so it runs on a card machine without the
reference installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_ref

F32_ATOL = 3e-5
BF16_ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(1000, 0), (1000, 256), (130, 0)])
def test_flash_attention_kernel_on_card(cuda, dtype, S, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, S, 32, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, S, 4, 128, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, S, 4, 128, generator=g, device=cuda).to(dtype)
    n0 = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    ref = attention_ref(q, k, v, causal=True, window=window)
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1280, 333, 8192])
def test_flash_decode_kernel_on_card(cuda, dtype, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(8, 1, 32, 128, generator=g, device=cuda).to(dtype)
    kc = torch.randn(8, S, 4, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(8, S, 4, 128, generator=g, device=cuda).to(dtype)
    lens = torch.randint(1, 2 * S, (8,), generator=g, device=cuda, dtype=torch.int32)
    lens[0], lens[1] = S, 1
    n0 = fd_ops.launches
    out = fd_ops.flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert fd_ops.launches == n0 + 1
    ref = decode_ref(q, kc, vc, lens)
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.parametrize("H,K,dh", [(8, 8, 32), (4, 1, 64), (8, 2, 128)])
def test_flash_decode_kernel_on_card_other_groups(cuda, H, K, dh):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(3, 1, H, dh, generator=g, device=cuda)
    kc = torch.randn(3, 300, K, dh, generator=g, device=cuda)
    vc = torch.randn(3, 300, K, dh, generator=g, device=cuda)
    lens = torch.tensor([1, 299, 1000], dtype=torch.int32, device=cuda)
    out = fd_ops.flash_decode(q, kc, vc, lens)
    assert (out - decode_ref(q, kc, vc, lens)).abs().max().item() <= F32_ATOL


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    qd = torch.zeros(1, 1, 16, 64, device=cuda)
    kc = torch.zeros(1, 32, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="query heads per kv head"):
        fd_ops.flash_decode(qd, kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        fd_ops.flash_decode(qd[:, :, :8], kc, kc, torch.ones(1, dtype=torch.int64, device=cuda))
