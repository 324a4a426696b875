"""repro_torch's dense transformer against repro.models.transformer.

yi-9b reduced, with 8 query heads over 2 kv heads so GQA runs, float32,
weights carried from the JAX package by `params_from_jax`. The JAX side runs
its Pallas kernels in interpret mode (attn_impl="pallas"); the port's CPU
path runs the kernels' plain versions. Logits and caches must agree to
atol 1e-4 (float32, a 2-layer stack of a few hundred-wide matmuls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.module import split_params
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

# The suite runs in parallel worker processes: one intra-op thread keeps these
# small CPU tests from crowding the timing-sensitive tests running beside them.
torch.set_num_threads(1)

ATOL = 1e-4
OVERRIDES = dict(n_heads=8, n_kv_heads=2)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("yi-9b").reduced().replace(attn_impl="pallas", **OVERRIDES)
    cfg = get_config("yi-9b").reduced().replace(**OVERRIDES)
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def test_prefill_and_decode_match_jax_through_ring_wrap(models):
    """Right-padded prefill (prompt_lens) then 8 decode steps with a per-row
    t vector, running past the reduced window of 64 so the ring wraps."""
    jcfg, jparams, cfg, params = models
    B, S, n_dec = 2, 60, 8
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([60, 52], np.int32)
    total = S + n_dec

    jl, jc = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, total_len=total,
                        prompt_lens=jnp.asarray(lens))
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg,
                       total_len=total, prompt_lens=lens.tolist())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc["l0"]["k"].shape == jc["l0"]["k"].shape == (cfg.n_layers, B, 64, 2, 32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["l0"][name].numpy(), np.asarray(jc["l0"][name]), atol=ATOL)

    t = lens.copy()
    for step in range(n_dec):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(t), jcfg)
        tl, tc = T.decode_step(params, tc, torch.from_numpy(nxt).long(), torch.from_numpy(t), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
        t = t + 1
    assert t.max() > 64  # the ring buffer wrapped
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["l0"][name].numpy(), np.asarray(jc["l0"][name]), atol=ATOL)


def test_prefill_into_given_caches_writes_in_place(models):
    _, _, cfg, params = models
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 20)))
    pool = T.init_caches(cfg, 3, 40, "cpu")
    row = {"l0": {n: c[:, 1:2] for n, c in pool["l0"].items()}}
    logits, out = T.prefill(params, {"tokens": toks}, cfg, total_len=40, caches=row)
    fresh_logits, fresh = T.prefill(params, {"tokens": toks}, cfg, total_len=40)
    assert out["l0"]["k"].data_ptr() == pool["l0"]["k"][:, 1:2].data_ptr()
    torch.testing.assert_close(pool["l0"]["k"][:, 1:2], fresh["l0"]["k"], atol=0, rtol=0)
    torch.testing.assert_close(logits, fresh_logits, atol=0, rtol=0)
    assert not pool["l0"]["k"][:, 0].any() and not pool["l0"]["k"][:, 2].any()


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_apply_matches_jax(gated):
    rng = np.random.default_rng(4)
    d, f = 32, 80
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    wi = (rng.standard_normal((d, 2, f) if gated else (d, f)) / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    want = np.asarray(JL.ffn_apply({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)}, jnp.asarray(x)))
    got = L.ffn_apply({"wi": torch.from_numpy(wi), "wo": torch.from_numpy(wo)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_params_from_jax_rejects_a_wrong_shape(models):
    _, jparams, cfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    tree["final_norm"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(tree, cfg, device="cpu")


def test_unported_paths_raise():
    cfg = get_config("yi-9b").reduced()
    # the int8 cache is ported: four leaves an attention layer, k/v int8, scales f32
    caches = T.init_caches(cfg.replace(kv_cache_dtype="int8"), 1, 8, "cpu")
    layer = caches["l0"]
    assert {k: (v.dtype, tuple(v.shape)) for k, v in layer.items()} == {
        "k": (torch.int8, (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.d_head)),
        "v": (torch.int8, (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.d_head)),
        "k_scale": (torch.float32, (cfg.n_layers, 1, 8, cfg.n_kv_heads)),
        "v_scale": (torch.float32, (cfg.n_layers, 1, 8, cfg.n_kv_heads))}
    with pytest.raises(NotImplementedError, match="moe"):
        T.model_init(torch.Generator(), cfg.replace(arch_type="moe"), "cpu")


def test_model_init_runs_on_the_card_unless_asked():
    """The default device is cuda: a CPU generator without device="cpu" raises
    instead of quietly building the params on the CPU."""
    cfg = get_config("yi-9b").reduced().replace(n_layers=1)
    with pytest.raises(ValueError, match="cannot draw params on cuda"):
        T.model_init(torch.Generator(), cfg)
    params = T.model_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
