"""repro_torch's int8 KV cache against repro.models.kvquant and the JAX int8
serving path.

quantize_kv / dequantize_kv on the same numpy inputs as the reference's (bit
for bit: per-(token, kv-head) absmax, floor 1e-8, round half to even, clip
±127); the port's int8 prefill and decode logits against the reference's
int8 path (yi-9b reduced with 8 query heads over 2 kv heads, float32, the
reference's Pallas kernels in interpret mode, at test_torch_transformer.py's
atol 1e-4); and the port's counterparts of tests/test_kvquant.py: the
roundtrip error bound, the teacher-forced parity of int8 decode with the
native cache, and the cache bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import kvquant as JQ
from repro.models import transformer as JT
from repro.models.module import split_params
from repro_torch.configs import get_config
from repro_torch.data import make_batch_for
from repro_torch.models import kvquant as Q
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

ATOL = 1e-4
OVERRIDES = dict(n_heads=8, n_kv_heads=2, kv_cache_dtype="int8")


@pytest.mark.parametrize("shape,scale", [((2, 64, 4, 32), 1.0), ((3, 5, 2, 128), 40.0),
                                         ((1, 7, 1, 16), 0.0)],
                         ids=["normal", "wide", "zeros"])
def test_quantize_and_dequantize_equal_the_reference(shape, scale):
    """Same numpy inputs (half-way values included, and an all-zero row that
    hits the 1e-8 floor): the same int8 values and f32 scales, and the same
    dequantized f32 and bf16 values, bit for bit."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[::7] = np.round(x.reshape(-1)[::7] * 2) / 2  # exact .5 multiples
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    q, s = Q.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JQ.dequantize_kv(jq, js, jdt).astype(jnp.float32))
        got = Q.dequantize_kv(q, s, tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_quant_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    q, s = Q.quantize_kv(x)
    err = (Q.dequantize_kv(q, s, torch.float32) - x).abs().max().item()
    bound = x.abs().max().item() / 254 + 1e-6  # absmax int8: at most scale / 2
    assert err <= bound * 1.2, (err, bound)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("yi-9b").reduced().replace(attn_impl="pallas", **OVERRIDES)
    cfg = get_config("yi-9b").reduced().replace(**OVERRIDES)
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _int8_close(got: torch.Tensor, want, max_flips: float = 1e-3):
    """int8 caches from f32 k/v that agree to round-off: equal but for rare
    values sitting on a rounding boundary, which move by one step."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= max_flips, (d.max(), (d > 0).mean())


def _carry(jc) -> dict:
    """The reference's caches as the port's tensors."""
    return {layer: {n: torch.from_numpy(np.array(a)) for n, a in c.items()}
            for layer, c in jc.items()}


def test_int8_prefill_and_decode_match_jax_through_ring_wrap(models):
    """Right-padded prefill then 8 decode steps with a per-row t vector past
    the reduced window of 64 (the ring wraps), int8 caches on both sides.

    Prefill attends in full precision on both sides: logits to atol 1e-4,
    scales to f32 round-off, int8 values equal but for the rare value on a
    rounding boundary, which f32 round-off upstream moves by one step (one
    in 16384 here). Such a step moves later logits by about 1e-4 of their
    size, so each decode step starts both packages from the reference's
    caches: the step's logits to atol 1e-4, and what it writes to the same
    int8 bar."""
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
    assert set(tc["l0"]) == set(jc["l0"]) == {"k", "v", "k_scale", "v_scale"}

    def check_caches(tc, jc):
        for name in ("k", "v"):
            assert tc["l0"][name].dtype == torch.int8
            _int8_close(tc["l0"][name], jc["l0"][name])
            np.testing.assert_allclose(tc["l0"][f"{name}_scale"].numpy(),
                                       np.asarray(jc["l0"][f"{name}_scale"]), rtol=1e-5, atol=0)

    check_caches(tc, jc)
    t = lens.copy()
    for step in range(n_dec):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        tc = _carry(jc)
        jl, jc = JT.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(t), jcfg)
        tl, tc = T.decode_step(params, tc, torch.from_numpy(nxt).long(), torch.from_numpy(t), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
        check_caches(tc, jc)
        t = t + 1
    assert t.max() > 64  # the ring wrapped


def test_int8_cache_decode_parity():
    """The reference's bar on the port: decode logits with the int8 cache
    track the native cache. Teacher-forced (both consume the native run's
    greedy tokens); max relative gap below 0.05, and greedy argmax equal at
    every step whose native top-2 margin is decisive, with at least one."""
    cfg_fp = get_config("yi_9b").reduced()
    cfg_q = cfg_fp.replace(kv_cache_dtype="int8")
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jax_get_config("yi_9b").reduced()))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg_fp, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch_for(cfg_fp, 24, 1, seed=1).items()}

    last, caches = T.prefill(params, batch, cfg_fp, total_len=32)
    fp_logits = [last.numpy()]
    toks = [last.argmax(-1)[:, None]]
    for t in range(24, 28):
        lg, caches = T.decode_step(params, caches, toks[-1], torch.tensor(t, dtype=torch.int32),
                                   cfg_fp)
        fp_logits.append(lg.numpy())
        toks.append(lg.argmax(-1)[:, None])
    fp = np.stack(fp_logits)

    last, caches = T.prefill(params, batch, cfg_q, total_len=32)
    q_logits = [last.numpy()]
    for i, t in enumerate(range(24, 28)):
        lg, caches = T.decode_step(params, caches, toks[i], torch.tensor(t, dtype=torch.int32),
                                   cfg_q)
        q_logits.append(lg.numpy())
    q = np.stack(q_logits)

    rel = np.abs(fp - q).max() / (np.abs(fp).max() + 1e-9)
    assert rel < 0.05, rel
    top2 = np.sort(fp.reshape(fp.shape[0], -1), axis=-1)
    margin = top2[:, -1] - top2[:, -2]
    decisive = margin > 2 * np.abs(fp - q).reshape(fp.shape[0], -1).max(-1)
    assert decisive.any()
    assert np.array_equal(fp.argmax(-1)[decisive], q.argmax(-1)[decisive])


def test_int8_cache_halves_bytes():
    """yi-9b at full width (on the meta device: shapes only)."""
    cfg = get_config("yi_9b")
    c_fp = T.init_caches(cfg, 2, 1024, "meta")
    c_q = T.init_caches(cfg.replace(kv_cache_dtype="int8"), 2, 1024, "meta")

    def nbytes(c):
        return sum(x.numel() * x.element_size() for layer in c.values() for x in layer.values())

    assert nbytes(c_q) < 0.56 * nbytes(c_fp), (nbytes(c_q), nbytes(c_fp))


def test_engine_serves_an_int8_pool_with_slot_reuse(models):
    """The engine's pool rows carry the scale leaves: 3 requests through 2
    slots (one slot reused) give the tokens of each request served alone."""
    _, _, cfg, params = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (12, 7, 9)]
    eng = ServeEngine(params, cfg, max_batch=2, max_len=24)
    assert eng.caches["l0"]["k_scale"].shape[:3] == (cfg.n_layers, 2, 24)
    together = {c.request_id: c.tokens for c in
                eng.run([Request(p, max_new_tokens=5) for p in prompts])}
    for i, p in enumerate(prompts):
        alone = ServeEngine(params, cfg, max_batch=1, max_len=24).run(
            [Request(p, max_new_tokens=5)])
        assert alone[0].tokens == together[i]
