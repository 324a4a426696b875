"""The port's mesh fit loop and its data pipeline against the JAX
package's: the chunk schedule, the synthetic batch streams (bit-identical
numpy), the prefetcher, the chunked fit from one carried-over state, the
remat option, and the loop's contracts (on_step per chunk, SIGTERM left
alone, Report fields, the refused checkpoint and sentinel options)."""
import signal

import jax
import numpy as np
import pytest
import torch

from repro.data import make_batch_for as j_make_batch_for
from repro.data import synthetic_lm_batches as j_synthetic
from repro.engine import trainloop as JTL
from repro.engine.spec import ExperimentSpec as JSpec
from repro_torch.common import tree_leaves
from repro_torch.data import ChunkPrefetcher, batch_put, stack_blocks
from repro_torch.data import make_batch_for as p_make_batch_for
from repro_torch.data import synthetic_lm_batches as p_synthetic
from repro_torch.engine import ExperimentSpec, Trainer
from repro_torch.engine import mesh as PM
from repro_torch.engine import trainloop as PTL
from repro_torch.models.convert import train_state_from_jax

from torch_mesh_parity import jax_leaves_like, jax_state, spec_kw


@pytest.mark.parametrize("ckpt_every", [0, 1, 3, 4, 7])
def test_chunk_schedule_equals_the_reference(ckpt_every):
    for start in range(0, 9):
        for stop in range(start, 15):
            for k in (1, 2, 3, 5, 16):
                assert PTL.chunk_schedule(start, stop, k, ckpt_every) == \
                    JTL.chunk_schedule(start, stop, k, ckpt_every)
    with pytest.raises(ValueError, match="chunk_steps must be >= 1"):
        PTL.chunk_schedule(0, 4, 0)


@pytest.mark.parametrize("seed,n_corpora", [(0, 0), (3, 2), (11, 5)])
def test_synthetic_lm_batches_are_bit_identical(seed, n_corpora):
    a = p_synthetic(97, 12, 6, seed=seed, n_corpora=n_corpora)
    b = j_synthetic(97, 12, 6, seed=seed, n_corpora=n_corpora)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_make_batch_for_is_bit_identical():
    cfg = ExperimentSpec().model_config()
    for seed in (0, 5):
        x, y = p_make_batch_for(cfg, 16, 4, seed=seed), j_make_batch_for(cfg, 16, 4, seed=seed)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_stack_blocks_and_prefetcher_keep_the_stream():
    stream = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(7)]
    blocks = list(stack_blocks(iter(stream), [3, 3, 1]))
    assert [b["tokens"].shape for b in blocks] == [(3, 2, 3), (3, 2, 3), (1, 2, 3)]
    np.testing.assert_array_equal(np.concatenate([b["tokens"] for b in blocks]),
                                  np.stack([s["tokens"] for s in stream]))
    with ChunkPrefetcher(stack_blocks(iter(stream), [3, 3, 1]), put=batch_put("cpu")) as pf:
        got = list(pf)
    assert all(isinstance(b["tokens"], torch.Tensor) for b in got)
    for a, b in zip(got, blocks):
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])
    with pytest.raises(ValueError, match="exhausted mid-chunk"):
        list(ChunkPrefetcher(stack_blocks(iter(stream), [4, 4]), put=batch_put("cpu")))


def test_prefetcher_close_mid_stream_joins_its_thread():
    def endless():
        i = 0
        while True:
            yield {"x": np.asarray([i])}
            i += 1

    pf = ChunkPrefetcher(endless(), put=batch_put("cpu"))
    assert int(next(pf)["x"][0]) == 0
    pf.close()
    pf.close()  # idempotent
    assert not pf._thread.is_alive()


# --------------------------------------------------------------- the fit


def _carried(kw, monkeypatch):
    """Start the port's fit from the reference's initial state."""
    _, npstate = jax_state(kw)
    cfg = ExperimentSpec(**kw).model_config()
    state = train_state_from_jax(*npstate, cfg, device="cpu")
    monkeypatch.setattr(PM, "init_train_state", lambda *a, **k: state)


def test_chunked_fit_matches_the_references_chunked_fit(monkeypatch):
    """chunk_steps=2 over 5 steps (chunks 2, 2, 1) on the synthetic stream,
    against the reference's jitted lax.scan chunks: every history record
    and the final params within atol 1e-5 (float32 summation order; the
    reference's own chunked-vs-stepwise drift is 5.96e-8)."""
    kw = spec_kw("dc_asgd_guided", "asgd", "sgd", chunk_steps=2, prefetch=True)
    jrep = JTL.fit(JSpec(**kw), "dc_asgd_guided")
    _carried(kw, monkeypatch)
    seen = []
    prep = Trainer.from_spec(ExperimentSpec(**kw), device="cpu").fit(
        on_step=lambda step, m, params: seen.append((step, tuple(m["loss"].shape))))
    assert seen == [(1, (2,)), (3, (2,)), (4, (1,))]
    assert len(prep.history) == len(jrep.history) == 5
    for a, b in zip(prep.history, jrep.history):
        assert a["step"] == b["step"]
        for k in ("loss", "worker_var", "corr_w"):
            assert abs(a[k] - b[k]) <= 1e-5, (a, b)
    jp = jax.tree.map(np.asarray, jrep.model)
    for a, b in zip(tree_leaves(prep.model), jax_leaves_like(jp, prep.model)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    assert prep.state.step == 5 and prep.n_steps == 5
    assert prep.final_loss == prep.history[-1]["loss"]
    # chunks 2, 2, 1: the first of each size counts as the "compiling" dispatch
    assert prep.warm_steps == jrep.warm_steps == 2
    assert prep.compile_time_s > 0 and prep.steps_per_s > 0


def test_remat_full_gives_the_same_numbers_as_none():
    """Checkpointing each super-block recomputes its forward in the backward:
    the same operations on the same inputs, so the same losses and params
    bit for bit."""
    reps = {}
    for remat in ("none", "full"):
        spec = ExperimentSpec(**spec_kw("guided_two_pass", "ssgd", "sgd",
                                        model_overrides=(("remat", remat),)))
        assert spec.model_config().remat == remat
        reps[remat] = Trainer.from_spec(spec, device="cpu").fit()
    assert [h["loss"] for h in reps["full"].history] == [h["loss"] for h in reps["none"].history]
    for a, b in zip(tree_leaves(reps["full"].model), tree_leaves(reps["none"].model)):
        assert torch.equal(a, b)


def test_fit_leaves_sigterm_alone_without_checkpoints():
    """The reference installs its SIGTERM drain only while it writes
    checkpoints, and so does the port: without a ckpt_dir the handler a
    caller set stays in force through every chunk."""
    kw = spec_kw("guided_fused", "ssgd", "sgd", chunk_steps=2, steps=4)
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    rep = Trainer.from_spec(ExperimentSpec(**kw), device="cpu").fit(
        on_step=lambda step, m, params: seen.append(signal.getsignal(signal.SIGTERM)))
    assert seen == [before, before] and rep.n_steps == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_keep_history_false_keeps_the_last_record():
    kw = spec_kw("none", "ssgd", "sgd", chunk_steps=2, steps=3)
    full = Trainer.from_spec(ExperimentSpec(**kw), device="cpu").fit()
    last = Trainer.from_spec(ExperimentSpec(**kw), device="cpu").fit(keep_history=False)
    assert last.history == full.history[-1:]


@pytest.mark.parametrize("kw,match", [
    (dict(arch="llava_next_mistral_7b"), "not yet ported"),
    (dict(model_overrides=(("arch_type", "moe"),)), "arch_type=.moe."),
    (dict(mesh="host"), "ROADMAP slice 7"),
])
def test_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer.from_spec(ExperimentSpec(**spec_kw("none", "ssgd", "sgd", steps=1, **kw)),
                          device="cpu").fit()


def test_mesh_trainer_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_spec(ExperimentSpec(**spec_kw("none", "ssgd", "sgd")))


def test_global_batch_must_divide_by_the_workers():
    spec = ExperimentSpec(**spec_kw("none", "ssgd", "sgd", global_batch=7, steps=1))
    with pytest.raises(ValueError, match=r"global_batch=7.*c=2"):
        Trainer.from_spec(spec, device="cpu").fit()
