"""Checkpoint and resume of the port's mesh fit (repro_torch.engine.trainloop).

The port's counterparts of tests/test_resume.py's resume tests and
tests/test_trainloop.py's chunked-resume tests, each held against the port's
own unbroken run bit for bit:

    train(N)  ==  train(k) -> snapshot -> resume -> train(N - k)

leaf for leaf over the params and the whole GuidedState (scores, previous
losses, w_stale, the optimizer state, step), stepwise and chunked, on and
between chunk boundaries, through SIGTERM's drain. Then a snapshot the
reference's fit writes, resumed by the port, against the reference's own
resumed run (within 1e-5: float32 summation order).
"""
import os
import shutil
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro.engine import trainloop as JTL
from repro.engine.spec import ExperimentSpec as JSpec
from repro_torch import checkpoint as C
from repro_torch.common import tree_leaves
from repro_torch.engine import ExperimentSpec, Trainer
from repro_torch.engine import mesh as PM
from repro_torch.optim import get_optimizer

from torch_mesh_parity import jax_leaves_like

torch.set_num_threads(1)


def _spec(strategy="guided_fused", mode="ssgd", **kw):
    base = dict(backend="mesh", arch="yi_9b", reduced=True, mode=mode, strategy=strategy,
                rho=4, staleness=2, lr=5e-2, seed=0, steps=6, seq_len=16, global_batch=4,
                workers=2)
    base.update(kw)
    return ExperimentSpec(**base)


def _fit(spec, **kw):
    return Trainer.from_spec(spec, device="cpu").fit(**kw)


def _leaves(tree):
    return tree_leaves(tree) if isinstance(tree, dict) else []


def _state_leaves(state):
    """Every tensor of a GuidedState: scores, previous losses, w_stale, extra
    and the optimizer's accumulators."""
    opt = state.opt_state if isinstance(state.opt_state, dict) else {}
    return ([state.score, state.prev_worker_loss, state.prev_avg_loss]
            + _leaves(state.w_stale) + _leaves(state.extra)
            + [leaf for k in sorted(opt) if k != "t" for leaf in _leaves(opt[k])])


def _assert_runs_equal(a, b):
    """Params and GuidedState bit for bit, the host ints equal."""
    for x, y in zip(tree_leaves(a.model), tree_leaves(b.model)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    la, lb = _state_leaves(a.state), _state_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert a.state.step == b.state.step
    if isinstance(a.state.opt_state, dict):
        assert a.state.opt_state.get("t") == b.state.opt_state.get("t")


# every registered strategy under its natural mode (the reference's matrix),
# and the fused momentum, rmsprop and adam updates, whose accumulators (and
# adam's host int t) the snapshot must carry
STRATEGIES = [
    ("none", "ssgd", "sgd"),
    ("guided_fused", "ssgd", "sgd"),
    ("guided_two_pass", "ssgd", "sgd"),
    ("dc_asgd", "asgd", "sgd"),
    ("dc_asgd_guided", "asgd", "sgd"),
    ("gap_aware", "asgd", "sgd"),
    ("guided_fused", "ssgd", "momentum"),
    ("guided_fused", "ssgd", "rmsprop"),
    ("dc_asgd", "asgd", "adam"),
]


@pytest.mark.parametrize("strategy,mode,optimizer", STRATEGIES)
def test_bit_exact_resume(strategy, mode, optimizer, tmp_path):
    d = str(tmp_path / strategy)
    full = _fit(_spec(strategy, mode, optimizer=optimizer))
    # stop after k=3 of 6 steps: what a separate process would start from is
    # exactly what the final full-state snapshot holds
    part = _fit(_spec(strategy, mode, optimizer=optimizer, steps=3, ckpt_dir=d))
    assert part.n_steps == 3 and C.latest_step(d) == 3
    resumed = _fit(_spec(strategy, mode, optimizer=optimizer, ckpt_dir=d), resume=True)
    assert resumed.start_step == 3 and resumed.n_steps == 3
    _assert_runs_equal(full, resumed)
    assert resumed.state.step == 6
    # the cut was mid-window: the restored consistency scores were live state
    # (in the reference's matrix, all sgd)
    if strategy in ("guided_fused", "guided_two_pass", "dc_asgd_guided") and optimizer == "sgd":
        assert float(part.state.score.abs().sum()) > 0.0


def test_resume_with_explicit_data_stream(tmp_path):
    """Resume skips the already-consumed prefix of a caller-provided stream."""
    from repro_torch.data import make_batch_for

    d = str(tmp_path)
    spec = _spec()
    cfg = spec.model_config()
    batches = [make_batch_for(cfg, 16, 4, seed=i) for i in range(6)]
    full = _fit(spec, data=[dict(b) for b in batches])
    _fit(spec.replace(steps=3, ckpt_dir=d), data=[dict(b) for b in batches[:3]])
    resumed = _fit(spec.replace(ckpt_dir=d), data=[dict(b) for b in batches], resume=True)
    _assert_runs_equal(full, resumed)


def test_resume_past_end_raises_without_stranding_writer(tmp_path):
    d = str(tmp_path)
    _fit(_spec("none", "ssgd", steps=4, ckpt_dir=d))
    n0 = threading.active_count()
    with pytest.raises(ValueError, match="past this run's n_steps=2"):
        _fit(_spec("none", "ssgd", steps=2, ckpt_dir=d), resume=True)
    assert threading.active_count() == n0  # no stranded ckpt-writer thread


@pytest.mark.parametrize("ckpt", [True, False], ids=["empty_dir", "no_ckpt_dir"])
def test_resume_without_a_snapshot(tmp_path, ckpt):
    """An empty checkpoint dir starts fresh; resume without a ckpt_dir is an
    error naming the field."""
    if ckpt:
        r = _fit(_spec("none", "ssgd", ckpt_dir=str(tmp_path / "empty")), resume=True)
        assert r.start_step == 0 and r.n_steps == 6
    else:
        with pytest.raises(ValueError, match="needs spec.ckpt_dir"):
            _fit(_spec("none", "ssgd"), resume=True)


def test_resume_rejects_params_only_checkpoint(tmp_path):
    """A v1 params-only archive cannot silently restart compensation from
    scratch: the restore names what is missing."""
    spec = _spec()
    params, gstate = PM.init_train_state(
        torch.Generator().manual_seed(0), spec.model_config(), spec.to_guided_config(),
        get_optimizer("sgd"), n_workers=2, strategy=spec.strategy, device="cpu")
    d = str(tmp_path)
    C.save(d, 3, {"params": params})
    with pytest.raises(ValueError, match="missing from archive.*gstate"):
        C.restore_train_state(d, 3, C.snapshot(params, gstate, 0))


def test_sigterm_saves_full_state_and_resume_matches(tmp_path):
    """SIGTERM mid-run: the step in flight finishes, the full state is
    snapshotted, fit returns interrupted=True with the caller's handler back
    in force, and the resume completes bit for bit."""
    d = str(tmp_path)
    full = _fit(_spec())
    before = signal.getsignal(signal.SIGTERM)

    def kill_at_2(step, m, params):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    part = _fit(_spec(ckpt_dir=d), on_step=kill_at_2)
    assert part.interrupted and part.n_steps == 3
    assert C.latest_step(d) == 3
    assert signal.getsignal(signal.SIGTERM) is before
    resumed = _fit(_spec(ckpt_dir=d), resume=True)
    assert resumed.start_step == 3 and not resumed.interrupted
    _assert_runs_equal(full, resumed)


def test_periodic_async_checkpoints_and_retention(tmp_path):
    d = str(tmp_path)
    _fit(_spec(ckpt_dir=d, ckpt_every=2, keep_last=2))
    man = C.read_manifest(d)
    assert man["latest"] == 6
    assert [c["step"] for c in man["ckpts"]] == [4, 6]
    assert man["ckpts"][-1]["meta"]["strategy"] == "guided_fused"
    assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 2


# --------------------------------------------------------- chunked dispatch

TINY = (("n_layers", 1), ("d_model", 16), ("d_ff", 32), ("vocab_size", 128),
        ("n_heads", 2), ("n_kv_heads", 2))


def _tiny(**kw):
    base = dict(rho=3, staleness=2, seq_len=8, model_overrides=TINY)
    base.update(kw)
    return _spec(**base)


def test_chunked_checkpoints_land_on_stepwise_cadence(tmp_path):
    """ckpt_every=3 misaligned with chunk_steps=2: chunks split so snapshots
    land at exactly the steps the per-step loop writes, with equal archives."""
    da, db = str(tmp_path / "step"), str(tmp_path / "chunk")
    _fit(_tiny(ckpt_dir=da, ckpt_every=3, keep_last=0))
    _fit(_tiny(ckpt_dir=db, ckpt_every=3, keep_last=0, chunk_steps=2, prefetch=True))
    steps_a = [c["step"] for c in C.read_manifest(da)["ckpts"]]
    steps_b = [c["step"] for c in C.read_manifest(db)["ckpts"]]
    assert steps_a == steps_b == [3, 6]
    with np.load(os.path.join(da, "step_00000003.npz")) as A, \
            np.load(os.path.join(db, "step_00000003.npz")) as B:
        assert sorted(A.files) == sorted(B.files)
        for k in A.files:
            np.testing.assert_array_equal(A[k], B[k], err_msg=k)


@pytest.mark.parametrize("cut", [3, 4])
def test_chunked_resume_bit_exact_on_and_between_boundaries(cut, tmp_path):
    """Resume from a snapshot at step 3 (between chunk_steps=2 boundaries: only
    a ckpt split put one there) and at step 4 (on a natural boundary)."""
    d = str(tmp_path)
    full = _fit(_tiny())  # stepwise
    _fit(_tiny(chunk_steps=2, steps=cut, ckpt_dir=d))
    resumed = _fit(_tiny(chunk_steps=2, ckpt_dir=d, prefetch=True), resume=True)
    assert resumed.start_step == cut and resumed.n_steps == 6 - cut
    _assert_runs_equal(full, resumed)
    assert resumed.state.step == 6


def test_sigterm_mid_chunk_drains_and_resumes(tmp_path):
    """SIGTERM while a chunk is in flight: the chunk drains, the snapshot holds
    its boundary's step count, the resume is bit for bit, no thread leaks."""
    d = str(tmp_path)
    full = _fit(_tiny())
    n0 = threading.active_count()

    def kill_in_first_chunk(step, m, params):
        if step <= 3:  # fires at the first chunk's end (step 3 for k=4)
            os.kill(os.getpid(), signal.SIGTERM)

    part = _fit(_tiny(chunk_steps=4, prefetch=True, ckpt_dir=d), on_step=kill_in_first_chunk)
    assert part.interrupted and part.n_steps == 4
    assert C.latest_step(d) == 4
    resumed = _fit(_tiny(chunk_steps=4, ckpt_dir=d), resume=True)
    assert resumed.start_step == 4 and not resumed.interrupted
    _assert_runs_equal(full, resumed)
    assert threading.active_count() == n0


# ------------------------------------------- a reference snapshot, resumed


def test_port_resumes_a_reference_snapshot_as_the_reference_does(tmp_path):
    """The reference's fit stops at step 3 of 6 with a snapshot; the port
    resumes from it and the reference resumes from a copy of it. The two
    resumed runs agree within 1e-5 (the reference's own chunked drift is
    5.96e-8), every history record and the final params and w_stale."""
    kw = dict(backend="mesh", arch="yi_9b", reduced=True, mode="asgd",
              strategy="dc_asgd_guided", optimizer="momentum", rho=4, staleness=2,
              lr=5e-2, seed=0, steps=6, seq_len=16, global_batch=4, workers=2)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    JTL.fit(JSpec(**{**kw, "steps": 3}, ckpt_dir=dj), "dc_asgd_guided")
    shutil.copytree(dj, dp)
    jrep = JTL.fit(JSpec(**kw, ckpt_dir=dj), "dc_asgd_guided", resume=True)
    prep = _fit(ExperimentSpec(**kw, ckpt_dir=dp), resume=True)
    assert prep.start_step == jrep.start_step == 3 and prep.n_steps == 3
    for a, b in zip(prep.history, jrep.history):
        assert a["step"] == b["step"]
        for k in ("loss", "worker_var", "corr_w"):
            assert abs(a[k] - b[k]) <= 1e-5, (a, b)
    jp, jws = jax.tree.map(np.asarray, (jrep.model, jrep.state.w_stale))
    for a, b in zip(tree_leaves(prep.model), jax_leaves_like(jp, prep.model)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    for a, b in zip(tree_leaves(prep.state.w_stale), jax_leaves_like(jws, prep.state.w_stale)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    assert prep.state.step == int(jrep.state.step) == 6
