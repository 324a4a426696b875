"""repro_torch's Mamba block and hybrid (jamba) stack against the reference.

Reduced jamba without experts (`.replace(moe=None).reduced()`: 8 layers,
attention at l4, d_model 256, ed 512, d_state 16), float32, weights carried
from the JAX package by `params_from_jax`. The reference runs with
attn_impl="pallas" (its Pallas scan and attention in interpret mode) and,
for the Mamba block alone, with its XLA scan too; the port's CPU path runs
the kernels' plain versions. Logits, outputs and states agree to atol 1e-4
(f32 through 8 layers of a few hundred-wide matmuls; the measured gap is
about 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.module import split_params
from repro_torch.configs import get_config
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-4
ARCH = "jamba_1_5_large_398b"


def _configs():
    jcfg = jax_get_config(ARCH).replace(moe=None).reduced().replace(attn_impl="pallas")
    return jcfg, get_config(ARCH).replace(moe=None).reduced()


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _configs()
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = _configs()
    jp = split_params(JM.mamba_init(jax.random.PRNGKey(1), jcfg))[0]
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, cfg, p


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, **kw)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_apply_matches_jax(block, impl, carried):
    jcfg, jp, cfg, p = block
    rng = np.random.default_rng(2)
    B, S, ed, n = 2, 32, 512, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv = ssm = None
    if carried:
        conv = rng.standard_normal((B, cfg.ssm.d_conv - 1, ed)).astype(np.float32)
        ssm = rng.standard_normal((B, ed, n)).astype(np.float32)
    jy, (jconv, jssm) = JM.mamba_apply(jp, jnp.asarray(x), jcfg,
                                       None if conv is None else jnp.asarray(conv),
                                       None if ssm is None else jnp.asarray(ssm), impl=impl)
    y, (c, s) = M.mamba_apply(p, torch.from_numpy(x), cfg,
                              None if conv is None else torch.from_numpy(conv),
                              None if ssm is None else torch.from_numpy(ssm))
    assert (y.dtype, c.dtype, s.dtype) == (torch.float32,) * 3
    _close(y, jy)
    _close(c, jconv)
    _close(s, jssm)


def test_mamba_decode_steps_match_jax(block):
    """A 9-token prefill, then 4 single-token steps carrying both states."""
    jcfg, jp, cfg, p = block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jy, jst = JM.mamba_apply(jp, jnp.asarray(x[:, :9]), jcfg)
    y, st = M.mamba_apply(p, torch.from_numpy(x[:, :9]), cfg)
    _close(y, jy)
    for t in range(9, 13):
        jy, jst = JM.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, *jst)
        y, st = M.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), cfg, *st)
        _close(y, jy, err_msg=f"step {t}")
        _close(st[0], jst[0])
        _close(st[1], jst[1])


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    for state in (None, st):
        jout, jnew = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     None if state is None else jnp.asarray(state))
        out, new = M._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                  None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def test_hybrid_prefill_and_decode_match_jax(models):
    """Prefill at a length the TPU scan takes (32), then 6 decode steps with a
    per-row t vector; logits and every layer's caches against the reference."""
    jcfg, jparams, cfg, params = models
    B, S, n_dec = 2, 32, 6
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    total = S + n_dec
    jl, jc = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, total_len=total)
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, total_len=total)
    _close(tl, jl)
    assert set(tc) == set(jc) == {f"l{i}" for i in range(8)}
    for name, layer in jc.items():
        assert set(tc[name]) == set(layer)
        for k, v in layer.items():
            assert tuple(tc[name][k].shape) == v.shape
            _close(tc[name][k], v)
    t = np.array([S, S], np.int32)
    for step in range(n_dec):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(t), jcfg)
        tl, tc = T.decode_step(params, tc, torch.from_numpy(nxt).long(), torch.from_numpy(t), cfg)
        _close(tl, jl, err_msg=f"step {step}")
        t = t + 1
    for name, layer in jc.items():
        for k, v in layer.items():
            _close(tc[name][k], v)


def test_prefill_into_a_used_pool_row_starts_from_zero_state(models):
    """A pool row that served another request holds its Mamba states and
    KV entries; prefilling into it must equal a prefill into fresh caches."""
    _, _, cfg, params = models
    rng = np.random.default_rng(6)
    pool = T.init_caches(cfg, 2, 40, "cpu")
    for layer in pool.values():
        for c in layer.values():
            c.copy_(torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32)))
    row = {k: {n: c[:, 1:2] for n, c in layer.items()} for k, layer in pool.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 19)))
    logits, out = T.prefill(params, {"tokens": toks}, cfg, total_len=40, caches=row)
    fresh_logits, fresh = T.prefill(params, {"tokens": toks}, cfg, total_len=40)
    torch.testing.assert_close(logits, fresh_logits, atol=0, rtol=0)
    for k, layer in fresh.items():
        for n, c in layer.items():
            assert out[k][n].data_ptr() == pool[k][n][:, 1:2].data_ptr()
            torch.testing.assert_close(pool[k][n][:, 1:2], c, atol=0, rtol=0)


@pytest.mark.parametrize("reduced", [False, True])
def test_jamba_config_equals_the_reference(reduced):
    ref, port = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.d_head, port.supports_decode) == (ref.d_head, ref.supports_decode)
    assert str(port.dtype).replace("torch.", "") == str(ref.dtype)
    for served in (False, True):  # as published, and as served (no experts)
        r, p = (ref.replace(moe=None), port.replace(moe=None)) if served else (ref, port)
        assert (T.period(p), T.n_super(p)) == (JT.period(r), JT.n_super(r))
        for i in range(T.period(p)):
            assert T.mixer_kind(p, i) == JT.mixer_kind(r, i)
            assert p.layer_is_moe(i) == (JT.ffn_kind(r, i) == "moe")


def test_check_ported_refuses_jamba_with_experts():
    cfg = get_config(ARCH)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.model_init(None, cfg.reduced(), device="meta")
    T.check_ported(cfg.replace(moe=None))
    with pytest.raises(ValueError, match="multiple of the period"):
        T.model_init(None, cfg.replace(moe=None, n_layers=12), device="meta")


def test_full_width_jamba_without_experts_holds_9b_parameters():
    """The card's configuration, on the meta device: 9.0B parameters, the
    reference's f32 Mamba leaves f32 and the rest bf16."""
    cfg = get_config(ARCH).replace(n_layers=8, moe=None)
    params = T.model_init(None, cfg, device="meta")
    leaves = []
    stack = [params]
    while stack:
        d = stack.pop()
        for v in d.values():
            (stack.append(v) if isinstance(v, dict) else leaves.append(v))
    assert 8.9e9 < sum(v.numel() for v in leaves) < 9.1e9
    mixer = params["blocks"]["l0"]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype == torch.float32} == {"A_log", "dt_bias", "D"}
    assert mixer["in_proj"].shape == (1, 8192, 2 * 16384)
    assert params["blocks"]["l4"]["mixer"]["wk"].shape == (1, 8192, 8 * 128)


def test_params_from_jax_refuses_another_dtype(models):
    jcfg, jparams, cfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"]["l0"]["mixer"]["A_log"] = tree["blocks"]["l0"]["mixer"]["A_log"].astype(
        np.float64)
    with pytest.raises(ValueError, match="A_log: dtype"):
        params_from_jax(tree, cfg, device="cpu")
