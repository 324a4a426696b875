"""repro_torch.serve against repro.serve, on weights carried from JAX.

The JAX engine runs its Pallas kernels in interpret mode
(attn_impl="pallas"); the port's engine runs on the CPU through the kernels'
plain versions. Greedy tokens are compared exactly. Stochastic draws cannot
match JAX's bits (different generators), so top-k is checked for staying in
the top k and for repeating under one seed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.module import split_params
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (Request, SamplingParams, ServeEngine, lockstep_generate,
                               sample_tokens)
from repro_torch.serve.engine import MIN_PREFILL_BUCKET

# The suite runs in parallel worker processes: one intra-op thread keeps these
# small CPU tests from crowding the timing-sensitive tests running beside them.
torch.set_num_threads(1)

OVERRIDES = dict(n_heads=8, n_kv_heads=2)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("yi-9b").reduced().replace(attn_impl="pallas", **OVERRIDES)
    cfg = get_config("yi-9b").reduced().replace(**OVERRIDES)
    jparams = split_params(JT.model_init(jax.random.PRNGKey(0), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def test_greedy_tokens_match_jax_engine_staggered(models):
    """3 staggered requests on a 2-slot pool: slots are recycled mid-run and
    one request decodes past the window of 64 (the ring wraps)."""
    jcfg, jparams, cfg, params = models
    prompts = _prompts(0, (9, 17, 50), cfg.vocab_size)
    gens = (12, 6, 20)
    jeng = JServeEngine(jparams, jcfg, max_batch=2, max_len=72)
    jout = jeng.run([JRequest(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    eng = ServeEngine(params, cfg, max_batch=2, max_len=72)
    out = eng.run([Request(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    want = {c.request_id: c.tokens for c in jout}
    got = {c.request_id: c.tokens for c in out}
    assert got == want
    assert [len(got[i]) for i in range(3)] == list(gens)
    s, js = eng.stats(), jeng.stats()
    assert set(s) == set(js)
    assert (s["decode_steps"], s["prefill_calls"], s["new_tokens"]) == (
        js["decode_steps"], js["prefill_calls"], js["new_tokens"])


def test_greedy_tokens_match_jax_engine_padded_buckets(models):
    """Without a sliding window the arch prefills at power-of-two buckets
    (right-padded prompts); tokens still equal the reference engine's."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.replace(sliding_window=0), cfg.replace(sliding_window=0)
    prompts = _prompts(4, (3, 9, 20), cfg.vocab_size)
    gens = (5, 8, 4)
    jeng = JServeEngine(jparams, jcfg, max_batch=2, max_len=40)
    jout = jeng.run([JRequest(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    eng = ServeEngine(params, cfg, max_batch=2, max_len=40)
    assert [eng.bucket_len(n) for n in (3, 9, 20, 39)] == [MIN_PREFILL_BUCKET, 16, 32, 40]
    out = eng.run([Request(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    assert {c.request_id: c.tokens for c in out} == {c.request_id: c.tokens for c in jout}


def test_greedy_tokens_match_jax_engine_hybrid_with_reused_slots():
    """Reduced jamba without experts (Mamba and attention layers): 4
    staggered requests of unequal prompt lengths on a 2-slot pool, so two
    slots are reused. A reused slot must not continue the Mamba state of the
    request it served before (prefill starts from zero state)."""
    arch = "jamba_1_5_large_398b"
    jcfg = jax_get_config(arch).replace(moe=None).reduced().replace(attn_impl="pallas")
    cfg = get_config(arch).replace(moe=None).reduced()
    jparams = split_params(JT.model_init(jax.random.PRNGKey(1), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(5, (12, 32, 32, 12), cfg.vocab_size)  # lengths the TPU scan takes
    gens = (9, 4, 7, 6)
    jeng = JServeEngine(jparams, jcfg, max_batch=2, max_len=48)
    jout = jeng.run([JRequest(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    eng = ServeEngine(params, cfg, max_batch=2, max_len=48)
    assert eng.bucket_len(12) == 12  # recurrent state: exact-length prefill
    out = eng.run([Request(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    assert {c.request_id: c.tokens for c in out} == {c.request_id: c.tokens for c in jout}
    assert [len(c.tokens) for c in sorted(out, key=lambda c: c.request_id)] == list(gens)
    assert eng.stats()["prefill_calls"] == 4 and {c.slot for c in out} == {0, 1}


def test_continuous_equals_lockstep_for_equal_lengths(models):
    _, _, cfg, params = models
    prompts = _prompts(1, (11, 11, 11, 11), cfg.vocab_size)
    mk = lambda: [Request(p, max_new_tokens=7) for p in prompts]  # noqa: E731
    eng = ServeEngine(params, cfg, max_batch=2, max_len=24)
    cont = {c.request_id: c.tokens for c in eng.run(mk())}
    lock, stats = lockstep_generate(eng, mk())
    assert {c.request_id: c.tokens for c in lock} == cont
    assert stats["n_completed"] == 4 and stats["decode_steps"] == 12


def test_streaming_callback_sees_every_token(models):
    _, _, cfg, params = models
    seen = []
    eng = ServeEngine(params, cfg, max_batch=2, max_len=32)
    comps = eng.run([Request(p, max_new_tokens=5, on_token=lambda rid, t: seen.append((rid, t)))
                     for p in _prompts(2, (4, 8, 6), cfg.vocab_size)])
    for c in comps:
        assert [t for rid, t in seen if rid == c.request_id] == c.tokens


def test_topk_draws_stay_in_top_k_and_repeat_for_a_seed():
    V, k = 50, 5
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((3, V)).astype(np.float32))
    top = torch.topk(logits, k).indices
    temp, topk = [1.5, 0.0, 1.5], [k, 0, k]

    def draw(seed):
        sp = SamplingParams(method="topk", top_k=k, temperature=1.5, seed=seed)
        gens = [sp.generator("cpu"), None, sp.generator("cpu")]
        return torch.stack([sample_tokens(logits, gens, temp, topk) for _ in range(40)])

    a, b = draw(7), draw(7)
    assert torch.equal(a, b)
    for row in (0, 2):
        assert set(a[:, row].tolist()) <= set(top[row].tolist())
        assert len(set(a[:, row].tolist())) > 1
    assert (a[:, 1] == torch.argmax(logits[1])).all()


def test_topk_keeps_ties_with_the_kth_logit():
    logits = torch.tensor([[3.0, 1.0, 1.0, 1.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    drawn = {sample_tokens(logits, [gen], [50.0], [2]).item() for _ in range(200)}
    assert drawn == {0, 1, 2, 3}


@pytest.mark.parametrize("kw,match", [
    (dict(method="beam"), "unknown sampling method"),
    (dict(method="temperature", temperature=-1.0), "temperature"),
    (dict(method="topk", top_k=0), "top_k"),
])
def test_sampling_params_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        SamplingParams(**kw)


def test_sampling_params_effective_values():
    assert SamplingParams().eff_temperature == 0.0
    assert SamplingParams(method="temperature", temperature=0.7, top_k=3).eff_top_k == 0
    assert SamplingParams(method="topk", top_k=3).eff_top_k == 3
    assert SamplingParams().generator("cpu") is None


def test_submit_validation(models):
    _, _, cfg, params = models
    eng = ServeEngine(params, cfg, max_batch=1, max_len=16)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request([]))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request([1] * 10, max_new_tokens=10))
    with pytest.raises(NotImplementedError, match="patch"):
        eng.submit(Request([1, 2, 3], max_new_tokens=2, patches=np.zeros((1, cfg.d_model), np.float32)))


def test_cli_runs_on_cpu(capsys):
    comps = serve_cli.main(["--arch", "yi-9b", "--reduced", "--device", "cpu", "--batch", "2",
                            "--requests", "3", "--prompt-len", "12", "--gen", "4", "--stagger",
                            "--sampling", "topk", "--top-k", "5"])
    out = capsys.readouterr().out
    assert len(comps) == 3 and "decode:" in out and "device: cpu" in out


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("hubert-xlarge")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert T.cache_len_for(get_config("yi-9b"), 100_000) == 8192
