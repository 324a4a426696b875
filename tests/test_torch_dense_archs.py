"""The archs ported in the ninth slice against the reference: granite-20b
(multi-query attention, 2-matrix GELU MLP), minicpm-2b (no grouping, tied
embeddings) and xlstm-350m (mLSTM and sLSTM blocks, no attention), reduced,
float32, weights carried from the JAX package by `params_from_jax`.

- `prefill` then `decode_step` (per-row positions): logits and every cache
  leaf at atol 1e-4, as test_torch_transformer.py (f32 through a few layers
  of a few hundred-wide matmuls);
- `ServeEngine` greedy tokens equal to the reference engine's, with reused
  slots;
- a mesh train step from one state (`train_state_from_jax`), 3 steps, every
  metric, param and w_stale within 1e-5, as test_torch_mesh.py.

The reference runs its Pallas kernels in interpret mode (attn_impl="pallas");
the port's CPU path runs the kernels' plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.module import split_params
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine
from torch_mesh_parity import compare, spec_kw

torch.set_num_threads(1)

ATOL = 1e-4
ARCHS = ("granite_20b", "minicpm_2b", "xlstm_350m")


def _models(arch, seed=0):
    jcfg = jax_get_config(arch).reduced()
    if JT.mixer_kind(jcfg, 0) == "attn":
        jcfg = jcfg.replace(attn_impl="pallas")
    cfg = get_config(arch).reduced()
    jparams = split_params(JT.model_init(jax.random.PRNGKey(seed), jcfg))[0]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0, **kw)


def _close_caches(tc, jc):
    assert set(tc) == set(jc)
    for name, layer in jc.items():
        assert set(tc[name]) == set(layer)
        for k, v in layer.items():
            assert tuple(tc[name][k].shape) == v.shape, (name, k)
            _close(tc[name][k], v, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 20 tokens, then 6 decode steps at per-row positions; the ring
    of granite's and minicpm's reduced window (64) is not reached."""
    jcfg, jparams, cfg, params = _models(arch)
    B, S, n_dec = 2, 20, 6
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    total = S + n_dec
    jl, jc = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, total_len=total)
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks).long()}, cfg, total_len=total)
    _close(tl, jl)
    _close_caches(tc, jc)
    t = np.array([S, S], np.int32)
    for step in range(n_dec):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(t), jcfg)
        tl, tc = T.decode_step(params, tc, torch.from_numpy(nxt).long(), torch.from_numpy(t), cfg)
        _close(tl, jl, err_msg=f"{arch} step {step}")
        t = t + 1
    _close_caches(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine_with_reused_slots(arch):
    """4 staggered requests of unequal lengths on a 2-slot pool: two slots
    are reused, so a recycled slot must start from the initial state (xLSTM)
    or an empty ring, not from the request it served before."""
    jcfg, jparams, cfg, params = _models(arch, seed=1)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in (12, 23, 7, 16)]
    gens = (9, 4, 7, 6)
    jout = JServeEngine(jparams, jcfg, max_batch=2, max_len=40).run(
        [JRequest(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    eng = ServeEngine(params, cfg, max_batch=2, max_len=40)
    out = eng.run([Request(p, max_new_tokens=g) for p, g in zip(prompts, gens)])
    assert {c.request_id: c.tokens for c in out} == {c.request_id: c.tokens for c in jout}
    assert [len(c.tokens) for c in sorted(out, key=lambda c: c.request_id)] == list(gens)
    assert eng.stats()["prefill_calls"] == 4 and {c.slot for c in out} == {0, 1}


def test_xlstm_prefill_into_a_used_pool_row_starts_from_the_initial_state():
    """A pool row that served another request holds its xLSTM states;
    prefilling into it must equal a prefill into fresh caches."""
    _, _, cfg, params = _models("xlstm_350m")
    rng = np.random.default_rng(6)
    pool = T.init_caches(cfg, 2, 40, "cpu")
    for layer in pool.values():
        for c in layer.values():
            c.copy_(torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32)))
    row = {k: {n: c[:, 1:2] for n, c in layer.items()} for k, layer in pool.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 11)))
    logits, out = T.prefill(params, {"tokens": toks}, cfg, total_len=40, caches=row)
    fresh_logits, fresh = T.prefill(params, {"tokens": toks}, cfg, total_len=40)
    torch.testing.assert_close(logits, fresh_logits, atol=0, rtol=0)
    for k, layer in fresh.items():
        for n, c in layer.items():
            assert out[k][n].data_ptr() == pool[k][n][:, 1:2].data_ptr()
            torch.testing.assert_close(pool[k][n][:, 1:2], c, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_reference(arch):
    """gSSGD from one state through 3 steps (window end at step 1 and 3)."""
    compare(spec_kw("guided_fused", "ssgd", "sgd", arch=arch, steps=3))


@pytest.mark.parametrize("arch,n_params", [("granite_20b", 20_315_756_544),
                                           ("minicpm_2b", 2_724_880_896),
                                           ("xlstm_350m", 443_143_264)])
def test_full_size_params_on_the_meta_device(arch, n_params):
    """Full width and depth, shapes only: the counts the card holds, and
    every leaf's dtype the reference's (bf16 but xLSTM's f32 gate leaves and
    the f32 norms)."""
    cfg = get_config(arch)
    params = T.model_init(None, cfg, device="meta")
    shapes = jax.eval_shape(lambda: split_params(
        JT.model_init(jax.random.PRNGKey(0), jax_get_config(arch)))[0])
    flat_ref = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    flat = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    assert flat == flat_ref
    assert sum(int(np.prod(s)) for s, _ in flat.values()) == n_params


def test_xlstm_train_state_crosses_the_archive_with_its_f32_leaves(tmp_path):
    """Reduced xlstm-350m in bf16, DC-ASGD (w_stale in the state): the
    reference's state through `train_state_from_jax` keeps the f32 gate
    leaves f32 and the rest bf16; the port's snapshot flattens to the
    reference's archive keys and values, and a save / restore into a fresh
    template is bitwise with every dtype kept."""
    from repro.checkpoint import snapshot as j_snapshot
    from repro.checkpoint.npz import _flatten as j_flatten
    from repro_torch import checkpoint as C
    from repro_torch.checkpoint import npz as N
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.models.convert import train_state_from_jax
    from torch_mesh_parity import jax_state

    bf16 = (("param_dtype", "bfloat16"), ("compute_dtype", "bfloat16"))
    kw = spec_kw("dc_asgd", "asgd", "sgd", arch="xlstm_350m", model_overrides=bf16)
    (jp, jg), (np_p, np_g) = jax_state(kw)
    cfg = get_config("xlstm_350m").reduced().replace(param_dtype="bfloat16",
                                                    compute_dtype="bfloat16")
    params, gstate = train_state_from_jax(np_p, np_g, cfg, device="cpu")
    for tree in (params, gstate.w_stale):
        mixers = [tree["blocks"][f"l{i}"]["mixer"] for i in range(2)]
        assert {n: mixers[0][n].dtype for n in ("w_if", "b_if", "w_up")} == \
            {"w_if": torch.float32, "b_if": torch.float32, "w_up": torch.bfloat16}
        assert {n: mixers[1][n].dtype for n in ("r_gates", "b_gates", "w_gates")} == \
            {"r_gates": torch.float32, "b_gates": torch.float32, "w_gates": torch.bfloat16}
    mine = N._flatten(C.snapshot(params, gstate, 3))
    ref = j_flatten(j_snapshot(jp, jg, 3))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].dtype, mine[k].shape) == (ref[k].dtype, ref[k].shape), k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    C.save(str(tmp_path), 3, C.snapshot(params, gstate, 3))
    like = C.snapshot(tree_map(torch.zeros_like, params),
                      gstate._replace(w_stale=tree_map(torch.zeros_like, gstate.w_stale)), 0)
    out = C.restore(str(tmp_path), 3, like)
    got = tree_leaves(out["params"]) + tree_leaves(out["gstate"].w_stale)
    want = tree_leaves(params) + tree_leaves(gstate.w_stale)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
