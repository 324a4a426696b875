"""repro_torch flash_attention / flash_decode against the JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX wrappers run
the Pallas kernels in interpret mode (as tests/test_kernels.py does). Inputs
are made with numpy from a seed and handed to both. Bars are the reference's
own: 3e-5 in float32, 2e-2 in bfloat16. The kernels themselves are tested
on the card by test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.kernel import flash_decode_raw
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_ref

# The suite runs in parallel worker processes: one intra-op thread keeps these
# small CPU tests from crowding the timing-sensitive tests running beside them.
torch.set_num_threads(1)

F32_ATOL = 3e-5
BF16_ATOL = 2e-2


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The same numpy arrays as jax arrays and torch (CPU) tensors of `dtype`."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(dtype) for a in arrays]


# ------------------------------------------------------------ flash attention


@pytest.mark.parametrize("B,S,H,K,dh", [(2, 256, 4, 2, 64), (1, 128, 8, 8, 32),
                                        (1, 256, 4, 1, 128), (2, 512, 2, 2, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 128)])
def test_flash_attention_matches_jax(B, S, H, K, dh, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_inputs(0, (B, S, H, dh), (B, S, K, dh), (B, S, K, dh)),
                                    torch.float32)
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=causal, window=window))
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dtypes_match_jax(dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, *[(1, 128, 2, 64)] * 3), dtype)
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=True), np.float32)
    got = fa_ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_flash_attention_matches_jax_block_shapes(bq, bk):
    """The port has one tiling; it agrees with every JAX tiling."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, *[(1, 256, 2, 32)] * 3), torch.float32)
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=True, bq=bq, bk=bk))
    got = fa_ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


# --------------------------------------------------------------- flash decode


@pytest.mark.parametrize("B,S,H,K,dh,bk", [(2, 512, 4, 2, 64, 256), (3, 256, 8, 1, 128, 64),
                                           (1, 1024, 2, 2, 32, 256)])
def test_flash_decode_matches_jax(B, S, H, K, dh, bk):
    arrays = _inputs(3, (B, 1, H, dh), (B, S, K, dh), (B, S, K, dh))
    lens = np.random.default_rng(4).integers(1, S + 1, (B,)).astype(np.int32)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    want = np.asarray(jax_flash_decode(jq, jk, jv, jnp.asarray(lens), bk=bk))
    got = fd_ops.flash_decode(q, k, v, torch.from_numpy(lens))
    assert got.shape == (B, 1, H, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("H,K,dh", [(48, 1, 128), (36, 36, 64)])
def test_decode_ref_any_group_size_matches_flash_decode_raw(H, K, dh):
    """The plain version at granite-20b's G = 48 (one kv head of 128) and
    minicpm-2b's G = 1 against the reference's Pallas kernel in interpret
    mode: S a multiple of its 256-slot block, ragged lengths (one past S, so
    a wrapped ring), f32."""
    B, S = 3, 512
    arrays = _inputs(6, (B, 1, H, dh), (B, S, K, dh), (B, S, K, dh))
    lens = np.array([1, 300, 900], np.int32)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    num, den = flash_decode_raw(jq, jk, jv, jnp.asarray(lens), interpret=True)
    want = np.asarray(num / jnp.maximum(den, 1e-30)[..., None])[:, None]
    got = decode_ref(q, k, v, torch.from_numpy(lens))
    assert got.shape == (B, 1, H, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_flash_decode_wrapped_ring_matches_jax():
    """cache_len past S (a wrapped ring buffer) means every slot is valid."""
    arrays = _inputs(5, (2, 1, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64))
    lens = np.array([700, 256], np.int32)
    (jq, jk, jv), (q, k, v) = _both(arrays, torch.float32)
    want = np.asarray(jax_flash_decode(jq, jk, jv, jnp.asarray(lens)))
    got = fd_ops.flash_decode(q, k, v, torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def test_flash_decode_full_cache_equals_attention_row():
    """Decode over a fully valid cache == last row of causal attention."""
    B, S, H, dh = 1, 256, 2, 64
    q_full, k, v = (torch.from_numpy(a) for a in _inputs(6, *[(B, S, H, dh)] * 3))
    full = fa_ops.flash_attention(q_full, k, v, causal=True)
    dec = fd_ops.flash_decode(q_full[:, -1:].contiguous(), k, v,
                              torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), atol=F32_ATOL)


# ---------------------------------------------------------------- dispatch


def test_cpu_tensors_reach_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers call the plain versions, launch nothing and
    never touch the kernel library."""
    calls = []

    def no_library(*a, **kw):
        raise AssertionError("kernel library requested for CPU tensors")

    monkeypatch.setattr(fa_ops.kernels, "library", no_library)
    monkeypatch.setattr(fa_ops, "attention_ref",
                        lambda *a, **kw: calls.append("attention") or attention_ref(*a, **kw))
    monkeypatch.setattr(fd_ops, "decode_ref",
                        lambda *a, **kw: calls.append("decode") or decode_ref(*a, **kw))
    n_fa, n_fd = fa_ops.launches, fd_ops.launches
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    fa_ops.flash_attention(q, k, k)
    fd_ops.flash_decode(q[:, :1], k, k, torch.tensor([3], dtype=torch.int32))
    assert calls == ["attention", "decode"]
    assert (fa_ops.launches, fd_ops.launches) == (n_fa, n_fd)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 32, "simt"), (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_flash_attention_variant_is_a_function_of_dtype_and_d_head(dtype, dh, want):
    """bf16 at d_head 64 or 128 runs on the tensor cores; float32, or d_head
    32, on the FMA pipes. Nothing else (shape, mask, device) enters the choice."""
    assert fa_ops.variant(dtype, dh) == want


@pytest.mark.parametrize("dtype,dh", [(torch.float16, 64), (torch.float64, 128),
                                      (torch.bfloat16, 48), (torch.float32, 256)])
def test_flash_attention_variant_refuses_what_no_kernel_takes(dtype, dh):
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa_ops.variant(dtype, dh)


def test_cpu_tensors_launch_no_variant_and_run_variant_needs_cuda():
    """On the CPU the wrapper runs the plain version for every dtype and counts
    no launch of either kernel; run_variant, which always launches, refuses."""
    before = dict(fa_ops.launches_by_variant)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 8, 4, 64, dtype=dtype)
        assert fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2]).dtype == dtype
    assert fa_ops.launches_by_variant == before
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.run_variant(q, q[:, :, :2], q[:, :, :2], variant="wgmma")


def test_mixed_devices_raise():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q.to("meta"), q)


def test_ragged_lengths_on_cpu_match_dense_reference():
    """The port takes any S (the Pallas wrappers need S % 128 / % 256 == 0)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, (1, 100, 4, 32), (1, 100, 2, 32),
                                                    (1, 100, 2, 32)))
    out = fa_ops.flash_attention(q, k, v, causal=True, window=30)
    np.testing.assert_allclose(out.numpy(), attention_ref(q, k, v, causal=True, window=30).numpy(),
                               atol=F32_ATOL)
    assert out.shape == (1, 100, 4, 32)


# ------------------------------------------- training attention (attn_impl)


@pytest.mark.parametrize("impl", ["xla", "xla_chunked"])
@pytest.mark.parametrize("S,causal,window", [(64, True, 0), (64, False, 0), (64, True, 16),
                                             (20, True, 16), (48, True, 16)])
def test_training_attention_and_its_gradient_match_jax(impl, S, causal, window):
    """The reference's XLA formulations, ported as plain torch ops: output
    and autograd's gradient against jax.grad of `layers.attention`, f32, at
    the reference's 3e-5 bar. (64, 16) and (48, 16) take the blocked
    sliding-window path, (20, 16) the masked full one."""
    import jax

    from repro.models import layers as JL
    from repro_torch.models import layers as L

    B, H, K, dh = 2, 4, 2, 32
    q, k, v, ct = _inputs(7, (B, S, H, dh), (B, S, K, dh), (B, S, K, dh), (B, S, H, dh))

    def jloss(q_, k_, v_):
        out = JL.attention(q_, k_, v_, n_kv_heads=K, causal=causal, window=window, impl=impl)
        return (out * ct).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.attention(tq, tk, tv, causal=causal, window=window, impl=impl)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=F32_ATOL)
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=F32_ATOL)


def test_attention_dispatch_reaches_the_kernel_only_for_pallas(monkeypatch):
    """"xla" never touches the kernel's wrapper (nor its plain version, which
    stays off the training path); "pallas" goes through it; anything else
    raises."""
    from repro_torch.models import layers as L

    calls = []
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or attention_ref(*a, **kw))
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **kw: pytest.fail("ref reached"))
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, (1, 32, 4, 32), (1, 32, 2, 32),
                                                     (1, 32, 2, 32)))
    L.attention(q, k, v, causal=True, window=0, impl="xla")
    assert calls == []
    L.attention(q, k, v, causal=True, window=8, impl="pallas")
    assert calls == [{"causal": True, "window": 8}]
    with pytest.raises(ValueError, match="unknown attn_impl"):
        L.attention(q, k, v, impl="flash")


def test_serve_paths_ask_for_the_kernel_whatever_attn_impl_says(monkeypatch):
    """prefill runs the flash_attention wrapper even though the config's
    attn_impl (the training path's) is "xla", and decode_step flash_decode."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config("yi_9b").reduced()
    assert cfg.attn_impl == "xla"
    seen = {"fa": 0, "fd": 0}
    fa, fd = L.flash_attention, L.flash_decode

    def count(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(L, "flash_attention", count("fa", fa))
    monkeypatch.setattr(L, "flash_decode", count("fd", fd))
    params = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    _, caches = T.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cfg,
                          total_len=10)
    T.decode_step(params, caches, torch.zeros((1, 1), dtype=torch.long), 8, cfg)
    assert seen == {"fa": cfg.n_layers, "fd": cfg.n_layers}


def test_forward_train_matches_jax():
    """The training forward's per-example losses (B,), f32 reduced yi-9b,
    from the reference's weights: the summation-order bar 1e-5, as the mesh
    parity tests hold it; with a mask too."""
    import jax

    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.models.module import split_params
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax

    jcfg, cfg = jget("yi_9b").reduced(), get_config("yi_9b").reduced()
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32),
             "mask": (rng.random((3, 24)) < 0.7).astype(np.float32)}
    for keys in (("tokens", "labels"), ("tokens", "labels", "mask")):
        jb = {k: jnp.asarray(batch[k]) for k in keys}
        tb = {k: torch.from_numpy(batch[k]) for k in keys}
        jper, _, _ = JT.forward_train(jparams, jb, jcfg)
        per, aux, logits = T.forward_train(params, tb, cfg)
        assert per.shape == (3,) and per.dtype == torch.float32 and float(aux) == 0.0
        assert logits.shape == (3, 24, cfg.vocab_size)
        np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=0, atol=1e-5)


def test_cross_entropy_matches_jax():
    """The mean token loss, with and without a mask, f32, at 1e-5."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    rng = np.random.default_rng(10)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        a = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        b = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(a), float(b), rtol=0, atol=1e-5)
