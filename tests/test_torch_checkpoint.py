"""repro_torch.checkpoint's mesh half against repro.checkpoint.

The port's counterparts of tests/test_checkpoint.py (the v1 npz roundtrips,
mismatch diagnostics, the manifest and async writer, subtree restore, the
SHA-256 verification and fall-back, the retention race), with cases that
repeat merged into parametrized tests, and the two crossings: a snapshot the
reference's mesh fit writes restores into the port, and one the port writes
restores through the reference. Archives hold torch tensors here (bf16
written as f32, host ints as int32 ()), so every comparison is bit for bit.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro.engine import mesh as JM
from repro.engine import trainloop as JTL
from repro.engine.spec import ExperimentSpec as JSpec
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import checkpoint as C
from repro_torch.checkpoint import npz as N
from repro_torch.common import tree_leaves
from repro_torch.core.guided import GuidedState
from repro_torch.engine import ExperimentSpec, Trainer
from repro_torch.engine import mesh as PM
from repro_torch.models.convert import train_state_from_jax
from repro_torch.optim import get_optimizer

torch.set_num_threads(1)


def _tree(v):
    return {"params": {"w": torch.full((4,), float(v))}, "step": int(v)}


def _w(out):
    return out["params"]["w"]


def _flip_middle_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


# ------------------------------------------------------------ v1: save/restore


@pytest.mark.parametrize("steps", [(7,), (1, 5)], ids=["roundtrip", "multiple_steps"])
def test_v1_save_restore_and_latest(tmp_path, steps):
    """v1 `save` writes the LATEST pointer and no manifest; restore fills the
    template's tensors (bf16 kept) and gives a host int back as an int."""
    d = str(tmp_path)
    for s in steps:
        tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) * s,
                           "b": torch.ones(3, dtype=torch.bfloat16)},
                "step": s}
        C.save(d, s, tree)
    assert C.read_manifest(d) is None
    assert C.latest_step(d) == steps[-1]
    like = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(3, dtype=torch.bfloat16)},
            "step": 0}
    out = C.restore(d, steps[-1], like)
    assert out["params"]["w"] is like["params"]["w"]  # written in place
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["step"] == steps[-1] and isinstance(out["step"], int)


def test_bf16_roundtrip_is_exact(tmp_path):
    """bf16 tensors archive as f32 (numpy has no bf16), widened on the host;
    the round trip is bit-preserving."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32)).bfloat16()
    tree = {"w": vals, "scale": torch.tensor(3.14159, dtype=torch.bfloat16)}
    C.save(str(tmp_path), 1, tree)
    with np.load(str(tmp_path / "step_00000001.npz")) as data:
        assert data["['w']"].dtype == np.float32
    out = C.restore(str(tmp_path), 1, {"w": torch.zeros(64, dtype=torch.bfloat16),
                                       "scale": torch.zeros((), dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), vals.view(torch.int16))
    assert torch.equal(out["scale"], tree["scale"])


def test_mismatch_raises_valueerror_naming_keys(tmp_path):
    C.save(str(tmp_path), 3, {"params": {"w": torch.zeros(2)}, "extra": torch.ones(1)})
    wrong = {"params": {"w": torch.zeros(2), "b": torch.zeros(3)}}
    with pytest.raises(ValueError) as ei:
        C.restore(str(tmp_path), 3, wrong)
    msg = str(ei.value)
    assert "missing from archive" in msg and "'b'" in msg
    assert "unexpected in archive" in msg and "extra" in msg
    assert "KeyError" not in msg


def test_shape_mismatch_raises_valueerror(tmp_path):
    C.save(str(tmp_path), 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match=r"\(2, 3\).*\(3, 2\)"):
        C.restore(str(tmp_path), 1, {"w": torch.zeros((3, 2))})


def test_missing_archive_is_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path), 9, {"w": torch.zeros(1)})


def test_key_paths_are_the_references(tmp_path):
    """The port spells a GuidedState's fields `.name`, dict keys `['k']`,
    skips an empty w_stale / extra, writes bf16 as f32 and host ints as
    int32 (): the same keys, dtypes and shapes as the reference's flatten of
    the same snapshot."""
    from repro.core.guided import GuidedState as JGuidedState
    from repro.checkpoint.npz import _flatten as j_flatten

    params = {"a": torch.ones(2, 3, dtype=torch.bfloat16)}
    gs = GuidedState(step=3, score=torch.zeros(4), prev_worker_loss=torch.zeros(4),
                     prev_avg_loss=torch.tensor(1.0), w_stale={"a": params["a"].clone()},
                     opt_state={"m": {"a": torch.zeros(2, 3)}, "t": 5})
    jp = {"a": jax.numpy.ones((2, 3), jax.numpy.bfloat16)}
    jgs = JGuidedState(step=jax.numpy.asarray(3, jax.numpy.int32),
                       score=jax.numpy.zeros(4), prev_worker_loss=jax.numpy.zeros(4),
                       prev_avg_loss=jax.numpy.float32(1.0), w_stale={"a": jp["a"]},
                       opt_state={"m": {"a": jax.numpy.zeros((2, 3))},
                                  "t": jax.numpy.asarray(5, jax.numpy.int32)},
                       extra=())
    mine = N._flatten(C.snapshot(params, gs, 3))
    ref = j_flatten(JC.snapshot(jp, jgs, 3))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].dtype, mine[k].shape) == (ref[k].dtype, ref[k].shape), k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


# ------------------------------------------------------------ v2: manifest


def test_sync_save_writes_manifest_and_retains(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        C.save_train_state(d, s, _tree(s), meta={"strategy": "guided_fused"}, keep_last=2)
    man = C.read_manifest(d)
    assert man["latest"] == 4
    assert [c["step"] for c in man["ckpts"]] == [3, 4]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "step_00000003.npz", "step_00000004.npz"]
    assert C.latest_step(d) == 4
    assert C.manifest_meta(d)["strategy"] == "guided_fused"
    assert torch.equal(_w(C.restore(d, 4, _tree(0))), torch.full((4,), 4.0))


def test_manifest_is_valid_json_and_atomic_layout(tmp_path):
    d = str(tmp_path)
    C.save_train_state(d, 7, _tree(7))
    with open(os.path.join(d, "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["version"] == 2
    assert man["ckpts"][0]["file"] == "step_00000007.npz"
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_async_writer_roundtrip_and_retention(tmp_path):
    d = str(tmp_path)
    ck = C.AsyncCheckpointer(d, keep_last=3, meta={"arch": "yi_9b"})
    for s in range(1, 7):
        assert ck.save(s, _tree(s))
    assert not ck.save(6, _tree(6))  # dedupe: same step as last save
    ck.close()
    man = C.read_manifest(d)
    assert man["latest"] == 6
    assert [c["step"] for c in man["ckpts"]] == [4, 5, 6]
    assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 3
    assert torch.equal(_w(C.restore(d, 5, _tree(0))), torch.full((4,), 5.0))
    assert C.manifest_meta(d, 5)["arch"] == "yi_9b"


def test_async_writer_snapshot_is_immune_to_in_place_updates(tmp_path, monkeypatch):
    """save() copies every tensor to the host on the caller's thread before it
    returns: the next step's in-place update of the live tensor (what the
    port's fused kernels do) never reaches the snapshot, even when the
    writer thread serializes it only afterwards."""
    d = str(tmp_path)
    gate = threading.Event()
    real = N.write_archive

    def held_write(ckpt_dir, step, flat):
        gate.wait(10.0)
        return real(ckpt_dir, step, flat)

    import repro_torch.checkpoint.writer as W

    monkeypatch.setattr(W, "write_archive", held_write)
    ck = C.AsyncCheckpointer(d, keep_last=0)
    w = torch.arange(8, dtype=torch.float32)
    ck.save(1, {"w": w})
    w.add_(100.0)  # the next step, in place, while the write is still pending
    gate.set()
    ck.close()
    out = C.restore(d, 1, {"w": torch.zeros(8)})
    assert torch.equal(out["w"], torch.arange(8, dtype=torch.float32))


def test_async_writer_surfaces_errors(tmp_path):
    import shutil

    d = os.path.join(str(tmp_path), "sub")
    ck = C.AsyncCheckpointer(d, keep_last=0)
    shutil.rmtree(d)
    with open(d, "w") as f:  # the ckpt "dir" is now a file: writes must fail
        f.write("in the way")
    try:
        ck.save(1, _tree(1))
        with pytest.raises(RuntimeError, match="checkpoint writer failed"):
            ck.wait()
    finally:
        os.unlink(d)
        ck.close()


def test_restore_subtree_params_only(tmp_path):
    d = str(tmp_path)
    full = C.snapshot({"w": torch.full((2, 2), 9.0), "b": torch.ones(2, dtype=torch.bfloat16)},
                      {"score": torch.zeros(4)}, cursor=12)
    C.save_train_state(d, 12, full)
    out = C.restore_subtree(d, 12, "params", {"w": torch.zeros((2, 2)),
                                              "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert torch.equal(out["w"], torch.full((2, 2), 9.0))
    assert out["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no 'params' subtree matching"):
        C.restore_subtree(d, 12, "params", {"nope": torch.zeros(1)})


# ----------------------------------------------------- verified checkpoints


def test_manifest_entries_record_sha256(tmp_path):
    d = str(tmp_path)
    C.save_train_state(d, 1, _tree(1))
    ck = C.AsyncCheckpointer(d, keep_last=0)
    ck.save(2, _tree(2))
    ck.close()
    entries = C.manifest_entries(d)
    assert [e["step"] for e in entries] == [2, 1]
    for e in entries:
        assert len(e["sha256"]) == 64
        assert e["sha256"] == C.file_sha256(os.path.join(d, e["file"]))


def test_truncated_archive_fails_verification_naming_step_and_path(tmp_path):
    d = str(tmp_path)
    C.save_train_state(d, 5, _tree(5))
    path = os.path.join(d, "step_00000005.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(C.CorruptCheckpointError) as ei:
        C.verify_entry(d, C.manifest_entries(d)[0])
    assert "step 5" in str(ei.value) and path in str(ei.value)


@pytest.mark.parametrize("corrupt", ["newest", "every"])
def test_restore_latest_falls_back_past_corrupt_archives(tmp_path, corrupt):
    """One flipped byte in the newest archive costs one retention interval:
    restore_latest skips it and restores the next-older intact entry. When
    every entry is torn it raises CorruptCheckpointError."""
    d = str(tmp_path)
    for s in (1, 2):
        C.save_train_state(d, s, _tree(s), keep_last=0)
    if corrupt == "newest":
        _flip_middle_byte(os.path.join(d, "step_00000002.npz"))
        step, out = C.restore_latest(d, _tree(0))
        assert step == 1 and torch.equal(_w(out), torch.full((4,), 1.0))
    else:
        for s in (1, 2):
            with open(os.path.join(d, f"step_0000000{s}.npz"), "r+b") as f:
                f.truncate(3)
        with pytest.raises(C.CorruptCheckpointError, match="no intact checkpoint"):
            C.restore_latest(d, _tree(0))


def test_undecodable_archive_is_corrupt_not_zipfile_internals(tmp_path):
    d = str(tmp_path)
    C.save(d, 3, {"w": torch.zeros(4)})
    p = os.path.join(d, "step_00000003.npz")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(C.CorruptCheckpointError, match="step 3"):
        C.restore(d, 3, {"w": torch.zeros(4)})


def test_template_mismatch_does_not_fall_back_to_older_steps(tmp_path):
    d = str(tmp_path)
    C.save_train_state(d, 1, _tree(1), keep_last=0)
    C.save_train_state(d, 2, _tree(2), keep_last=0)
    with pytest.raises(ValueError) as ei:
        C.restore_latest(d, {"something": {"else": torch.zeros(7)}})
    assert not isinstance(ei.value, C.CorruptCheckpointError)
    assert "step_00000002.npz" in str(ei.value)


# ---------------------------------------------- restore during retention


def test_manifest_never_names_a_pruned_archive(tmp_path):
    d = str(tmp_path)
    for s in range(1, 12):
        C.save_train_state(d, s, _tree(s), keep_last=2)
        for c in C.read_manifest(d)["ckpts"]:
            assert os.path.exists(os.path.join(d, c["file"])), (c["file"], s)


def test_restore_latest_retries_a_pruned_step(tmp_path, monkeypatch):
    d = str(tmp_path)
    C.save_train_state(d, 1, _tree(1), keep_last=2)
    C.save_train_state(d, 2, _tree(2), keep_last=2)
    real = N.manifest_entries
    calls = {"n": 0}

    def racing_entries(ckpt_dir):
        calls["n"] += 1
        if calls["n"] == 1:
            # we read entries naming step 2, then retention pruned it
            entries = real(ckpt_dir)
            C.save_train_state(ckpt_dir, 3, _tree(3), keep_last=1)
            return entries
        return real(ckpt_dir)

    monkeypatch.setattr(N, "manifest_entries", racing_entries)
    step, out = C.restore_latest(d, _tree(0))
    assert step == 3 and calls["n"] == 2
    assert torch.equal(_w(out), torch.full((4,), 3.0))


def test_restore_latest_gives_up_on_a_vanishing_dir(tmp_path):
    d = str(tmp_path)
    C.save_train_state(d, 1, _tree(1))
    os.unlink(os.path.join(d, "step_00000001.npz"))  # the manifest now dangles
    with pytest.raises(FileNotFoundError, match="kept vanishing"):
        C.restore_latest(d, _tree(0), attempts=3)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        C.restore_latest(str(tmp_path / "empty"), _tree(0))


def test_restore_races_live_retention(tmp_path):
    """A writer cycling keep_last=2 snapshots while a reader restore_latest()s
    in a loop: every restore succeeds and is consistent (w matches its step)."""
    d = str(tmp_path)
    C.save_train_state(d, 0, _tree(0), keep_last=2)
    stop = threading.Event()
    errs = []

    def writer():
        ck = C.AsyncCheckpointer(d, keep_last=2)
        try:
            for s in range(1, 60):
                ck.save(s, _tree(s))
        finally:
            ck.close()
        stop.set()

    def reader():
        try:
            while not stop.is_set():
                step, out = C.restore_latest(d, _tree(0))
                if not bool((_w(out) == float(step)).all()):
                    errs.append(f"step {step} restored w={_w(out)[0]}")
        except BaseException as e:  # surfaced below, not swallowed
            errs.append(repr(e))

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert errs == []


# --------------------------------------------- snapshots cross the packages

# reduced yi-9b cut to one narrow layer; DC-ASGD with momentum, so w_stale and
# the momentum accumulator are both in the snapshot
CROSS = dict(backend="mesh", arch="yi_9b", reduced=True, mode="asgd", strategy="dc_asgd",
             optimizer="momentum", rho=3, staleness=2, lr=5e-2, seed=0, steps=2,
             seq_len=8, global_batch=4, workers=2,
             model_overrides=(("n_layers", 1), ("d_model", 16), ("d_ff", 32),
                              ("vocab_size", 128), ("n_heads", 2), ("n_kv_heads", 2)))


def _port_template(kw):
    spec = ExperimentSpec(**kw)
    params, gstate = PM.init_train_state(
        torch.Generator().manual_seed(1), spec.model_config(), spec.to_guided_config(),
        get_optimizer(spec.optimizer), n_workers=2, strategy=spec.strategy, device="cpu")
    return C.snapshot(params, gstate, 0)


def _state_leaves(params, gstate):
    return (tree_leaves(params) + [gstate.score, gstate.prev_worker_loss, gstate.prev_avg_loss]
            + tree_leaves(gstate.w_stale) + tree_leaves(gstate.opt_state["m"]))


def test_a_reference_snapshot_restores_into_the_port(tmp_path):
    """The reference's mesh fit writes a full-state snapshot; the port's
    restore_train_state reads it into a port template, equal bit for bit to
    train_state_from_jax of the same final state."""
    d = str(tmp_path)
    jrep = JTL.fit(JSpec(**CROSS, ckpt_dir=d), "dc_asgd")
    assert C.latest_step(d) == 2
    snap = C.restore_train_state(d, 2, _port_template(CROSS))
    cfg = ExperimentSpec(**CROSS).model_config()
    want = train_state_from_jax(*jax.tree.map(np.asarray, (jrep.model, jrep.state)), cfg,
                                device="cpu")
    got = (snap["params"], snap["gstate"])
    assert got[1].step == want[1].step == 2 and int(snap["data"]["cursor"]) == 2
    for a, b in zip(_state_leaves(*got), _state_leaves(*want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_port_snapshot_restores_through_the_reference(tmp_path):
    """The port's mesh fit writes a snapshot; the reference's
    restore_train_state reads it into its own template with every leaf equal
    to the port's final state."""
    d = str(tmp_path)
    prep = Trainer.from_spec(ExperimentSpec(**CROSS, ckpt_dir=d), device="cpu").fit()
    js = JSpec(**CROSS)
    params, _, gstate = JM.init_train_state(
        jax.random.PRNGKey(0), js.model_config(), js.to_guided_config(),
        j_get_optimizer(js.optimizer), n_workers=2, strategy=js.strategy)
    snap = JC.restore_train_state(d, 2, JC.snapshot(params, gstate, 0))
    jp, jg = jax.tree.map(np.asarray, (snap["params"], snap["gstate"]))
    cfg = ExperimentSpec(**CROSS).model_config()
    back = train_state_from_jax(jp, jg, cfg, device="cpu")
    assert int(jg.step) == prep.state.step == 2 and int(snap["data"]["cursor"]) == 2
    for a, b in zip(_state_leaves(*back), _state_leaves(prep.model, prep.state)):
        assert torch.equal(a, b)
