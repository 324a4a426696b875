"""The port's async parameter server (repro_torch.dist, `Trainer(backend=
"dist", device="cpu")`): the reference's acceptance gates (tests/test_dist.py)
held on the port, on the same toy data and settings, plus the store driven
directly.

  * replay (2 real worker processes, scheduled interleaving) reproduces the
    port's scan backend — history within 1e-7, final losses within 1e-5 —
    and, where the numpy parameter server runs the fit, train_ps;
  * the chief's observed staleness sequence is the extracted schedule's;
  * chief checkpoints, live kill/restart, delayed averaging, no leaked
    threads, one source for the topologies;
  * the store called in-process: one call of the fused update per apply at
    the chief's (P, k) float64 shape, none launched on the CPU; rollback.
  * `python -m repro_torch.dist.worker` imports neither torch nor jax.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.parameter_server import PSConfig, train_ps
from repro_torch.core.parameter_server import prepare_run
from repro_torch.dist import launcher
from repro_torch.dist.logreg import _aug, grad
from repro_torch.dist.store import ParameterStore
from repro_torch.engine import ExperimentSpec, Trainer, get_compensator
from repro_torch.kernels.guided_update import ops
from repro_torch.resilience import SentinelPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's bars (tests/test_dist.py): history 1e-7, final losses 1e-5
HIST_ATOL = 1e-7
FINAL_ATOL = 1e-5


def _toy(n=120, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w = rng.standard_normal((d,))
    y = (X @ w > 0).astype(np.int64)
    return X, y, 2


# rho=2 -> c=2 worker processes; 3 epochs keeps the whole module a few seconds
COMMON = dict(mode="asgd", epochs=3, batch_size=16, rho=2, lr=0.2, seed=0)


def _fit(spec, data):
    return Trainer.from_spec(spec, device="cpu").fit(data)


def _hist(rep):
    return np.array([v for _, v in rep.history])


@pytest.fixture(scope="module")
def replay_run(tmp_path_factory):
    """One 2-worker replay run (guided strategy, chief-side checkpoints on),
    shared by the parity/staleness/checkpoint asserts below."""
    X, y, k = _toy()
    ckpt_dir = str(tmp_path_factory.mktemp("dist_ckpt"))
    spec = ExperimentSpec(backend="dist", dist_mode="replay",
                          strategy="guided_fused", ckpt_dir=ckpt_dir,
                          ckpt_every=10, **COMMON)
    report = _fit(spec, (X, y, k))
    return spec, report, (X, y, k), ckpt_dir


def _assert_same_trajectory(rep, ref):
    assert rep.n_steps == ref.n_steps > 0
    np.testing.assert_allclose(_hist(rep), _hist(ref), atol=HIST_ATOL, rtol=0)
    for key in ("train_loss", "val_loss"):
        assert abs(rep.final[key] - ref.final[key]) < FINAL_ATOL


def test_replay_matches_scan_backend(replay_run):
    """Real worker processes, scheduled interleaving -> the scan trajectory."""
    spec, report, data, _ = replay_run
    ref = _fit(ExperimentSpec(backend="scan", strategy="guided_fused", **COMMON), data)
    _assert_same_trajectory(report, ref)


@pytest.mark.parametrize("kw", [
    dict(strategy="dc_asgd"),
    dict(strategy="gap_aware"),
    dict(strategy="dc_asgd_guided", dc_lambda=0.3),
    dict(strategy="guided_fused", optimizer="rmsprop", mode="ssgd"),
    dict(strategy="guided_fused", optimizer="adagrad", mode="ssgd"),
    dict(strategy="none", mode="seq"),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_replay_matches_scan_backend_per_apply_path(kw):
    """Every apply path of the chief: the lambda fold, the two-phase
    gap_aware path, guided replay with lambda, the rmsprop kernel, adagrad
    inline, and a fresh (staleness 0) schedule."""
    data = _toy()
    base = {**COMMON, **kw}
    rep = _fit(ExperimentSpec(backend="dist", dist_mode="replay", **base), data)
    ref = _fit(ExperimentSpec(backend="scan", **base), data)
    _assert_same_trajectory(rep, ref)


@pytest.mark.parametrize("strategy,optimizer", [("none", "sgd"), ("guided_fused", "sgd"),
                                                ("guided_fused", "rmsprop")])
def test_replay_matches_train_ps(strategy, optimizer):
    """Where the numpy parameter server runs the fit, replay lands on its
    trajectory (the reference's train_ps, from the JAX package)."""
    X, y, k = _toy()
    spec = ExperimentSpec(backend="dist", dist_mode="replay", strategy=strategy,
                          optimizer=optimizer, **COMMON)
    rep = _fit(spec, (X, y, k))
    cfg = PSConfig(**dataclasses.asdict(spec.replace(backend="sim").to_ps_config()))
    legacy = train_ps(X, y, k, cfg)
    assert rep.n_steps == legacy["n_steps"]
    np.testing.assert_allclose(_hist(rep), [v for _, v in legacy["history"]],
                               atol=HIST_ATOL, rtol=0)
    assert abs(rep.final["train_loss"] - legacy["train_loss"]) < FINAL_ATOL
    assert abs(rep.val_loss - legacy["val_loss"]) < FINAL_ATOL


def test_observed_staleness_equals_extracted_schedule(replay_run):
    """The parity oracle: the chief's RECORDED staleness sequence (real
    process interleaving under replay grants) is the DelaySchedule's column."""
    spec, report, (X, y, k), _ = replay_run
    _, _, _, schedule = prepare_run(X, y, k, spec.to_schedule_config())
    assert [t for t, _ in report.history] == list(range(1, schedule.n_steps + 1))
    expect = {int(s): int(n) for s, n in
              zip(*np.unique(schedule.staleness, return_counts=True))}
    assert report.staleness_hist == expect
    res = launcher.run_local(spec.replace(ckpt_dir="", ckpt_every=0), X, y, k, device="cpu")
    np.testing.assert_array_equal(res["staleness_seq"], schedule.staleness)
    assert res["n_steps"] == schedule.n_steps


def test_chief_checkpoints_written(replay_run):
    """Chief-side snapshots: the manifest retains dist_snapshot archives and
    dist_restore returns the final store state."""
    from repro_torch.checkpoint import dist_restore, latest_step

    _, report, _, ckpt_dir = replay_run
    assert latest_step(ckpt_dir) == report.n_steps
    snap = dist_restore(ckpt_dir)
    assert int(snap["version"]) == report.n_steps
    assert len(snap["staleness"]) == report.n_steps
    np.testing.assert_array_equal(snap["W"], report.model.W)


def test_live_survives_kill_restart():
    """A free-running run with a worker killed and restarted mid-run
    completes its step budget, stays within 0.25 of the scan reference, and
    reports a nonempty observed-staleness histogram."""
    X, y, k = _toy()
    ref = _fit(ExperimentSpec(backend="scan", strategy="none", **COMMON), (X, y, k))
    # time_scale paces worker compute (~30ms a step) so a loaded host's
    # monitor, polling every 10ms, sees version 6 long before the 18-step
    # budget drains; dist_timeout bounds the test if a worker hangs
    spec = ExperimentSpec(backend="dist", dist_mode="live", strategy="none",
                          workers=2, dist_events=(("restart", 0, 6),),
                          dist_time_scale=0.03, dist_timeout=60.0, **COMMON)
    report = _fit(spec, (X, y, k))
    assert report.n_steps == ref.n_steps
    assert report.dist["worker_exits"] >= 1
    assert sum(report.staleness_hist.values()) == report.n_steps
    assert report.staleness_hist
    assert report.val_loss < 0.8 * 0.6931   # ~ln 2: the near-zero init on 2 classes
    assert abs(report.val_loss - ref.val_loss) < 0.25


def test_live_delayed_averaging_trains():
    """DaSGD-style overlap: pushes carry per-gradient read versions, the
    observed staleness grows accordingly, and the run still trains."""
    X, y, k = _toy()
    spec = ExperimentSpec(backend="dist", dist_mode="live", strategy="dc_asgd",
                          workers=2, delayed_avg=True, dist_timeout=60.0, **COMMON)
    report = _fit(spec, (X, y, k))
    assert report.n_steps > 0
    assert sum(report.staleness_hist.values()) == report.n_steps
    mean_stale = sum(s * n for s, n in report.staleness_hist.items()) / report.n_steps
    assert mean_stale > 0.5
    assert report.val_loss < 0.6


def test_spec_validation():
    with pytest.raises(ValueError, match="dist_mode"):
        ExperimentSpec(backend="dist", dist_mode="nope")
    with pytest.raises(ValueError, match="asgd"):
        ExperimentSpec(backend="dist", dist_mode="live", mode="ssgd")
    with pytest.raises(ValueError, match="live"):
        ExperimentSpec(backend="dist", dist_mode="replay", mode="asgd",
                       dist_events=(("kill", 0, 5),))
    with pytest.raises(ValueError, match="dist event"):
        ExperimentSpec(backend="dist", dist_mode="live", mode="asgd",
                       dist_events=(("explode", 0, 5),))
    with pytest.raises(ValueError, match="dist-backend"):
        ExperimentSpec(backend="scan", mode="asgd", delayed_avg=True)
    with pytest.raises(ValueError, match="drop_rate"):
        ExperimentSpec(backend="dist", dist_mode="live", mode="asgd",
                       dist_drop_rate=1.5)


def test_dist_runs_on_the_card_unless_asked():
    """device="cuda" is the default: without a card the Trainer raises, as
    the scan and mesh backends do; device="cpu" runs (the tests above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_spec(ExperimentSpec(backend="dist", **COMMON))


def test_no_leaked_threads(replay_run):
    """run_local joins everything it started — chief accept + connection
    threads, the supervisor and the async checkpoint writer."""
    for _ in range(100):  # close() joins with timeouts; allow a beat
        if threading.active_count() == 1:
            break
        time.sleep(0.05)
    assert [t.name for t in threading.enumerate()] == ["MainThread"]


def test_topologies_single_source():
    """TOPOLOGY_SAMPLERS lives in repro_torch.common.topologies; the
    delaysim name is the same dict, and the dist workers' compute-time
    sampler resolves from it."""
    from repro_torch.common.topologies import TOPOLOGY_SAMPLERS, compute_time_sampler
    from repro_torch.engine import delaysim

    assert delaysim.TOPOLOGY_SAMPLERS is TOPOLOGY_SAMPLERS
    assert compute_time_sampler("straggler") is TOPOLOGY_SAMPLERS["straggler"]
    rng = np.random.default_rng(0)
    assert compute_time_sampler("exp")(0, rng) > 0  # deterministic-topology fallback
    with pytest.raises(KeyError, match="unknown topology"):
        compute_time_sampler("warp")


# ------------------------------------------------------- the store, directly


def _store(spec, data, device="cpu", **kw):
    X, y, k = data
    W0, train, val, schedule = prepare_run(X, y, k, spec.to_schedule_config())
    strategy = get_compensator(spec.strategy, spec.to_guided_config())
    store = ParameterStore(spec, strategy, W0, train, val, total_steps=schedule.n_steps,
                           schedule=schedule, device=device, **kw)
    return store, schedule, (_aug(np.asarray(train[0], np.float64)), np.asarray(train[1]))


def _drive(store, schedule, train, stop):
    """The replay protocol in this process, arrival by arrival: the pull and
    push each scheduled worker makes, its gradient computed as a worker does."""
    Xa, y = train
    for t in range(store.progress(), stop):
        wid = int(schedule.worker[t])
        W, fetch_v, rows = store.replay_pull(wid)
        store.replay_push(wid, grad(W, Xa[rows], y[rows]), fetch_v)


@pytest.mark.parametrize("optimizer,kernel", [("sgd", "guided_sgd_update_raw"),
                                              ("rmsprop", "guided_rmsprop_update_raw"),
                                              ("adagrad", None)])
def test_store_applies_each_push_with_one_fused_update(monkeypatch, optimizer, kernel):
    """The card's apply path, held on the CPU: each applied push is one call
    of the fused guided update at the chief's (P, k) float64 shape (none for
    adagrad, inline), and the CPU launches no kernel."""
    spec = ExperimentSpec(backend="dist", strategy="dc_asgd", optimizer=optimizer, **COMMON)
    calls = []
    if kernel is not None:
        real = getattr(ops, kernel)

        def spy(w, *args, **kw):
            calls.append((tuple(w.shape), w.dtype, w.device.type))
            return real(w, *args, **kw)

        monkeypatch.setattr(ops, kernel, spy)
    store, schedule, train = _store(spec, _toy())
    n0 = dict(ops.launches)
    _drive(store, schedule, train, schedule.n_steps)
    assert store.progress() == schedule.n_steps
    assert ops.launches == n0
    want = [(store.shape, torch.float64, "cpu")] * schedule.n_steps if kernel else []
    assert calls == want
    assert store.shape == (6, 2)


def test_store_copy_continues_the_same_run():
    """ParameterStore.to: a copy continues from the same version, bit for
    bit as the original does, and leaves the original alone."""
    spec = ExperimentSpec(backend="dist", strategy="guided_fused", **COMMON)
    store, schedule, train = _store(spec, _toy())
    _drive(store, schedule, train, 7)
    copy = store.to("cpu")
    _drive(store, schedule, train, schedule.n_steps)
    assert copy.progress() == 7
    _drive(copy, schedule, train, schedule.n_steps)
    assert copy.history == store.history and copy.staleness == store.staleness
    assert torch.equal(copy.W, store.W)


def test_store_rolls_back_a_divergent_push():
    """Live with a rollback policy: a finite but exploding push trips the
    divergence detector; the update is not committed, the version does not
    advance, W returns to the last good state and the lr backs off."""
    spec = ExperimentSpec(backend="dist", dist_mode="live", strategy="none", sentinel="finite",
                          rollback=True, **COMMON)
    X, y, k = _toy()
    W0, train, val, schedule = prepare_run(X, y, k, spec.to_schedule_config())
    store = ParameterStore(spec, get_compensator("none", spec.to_guided_config()), W0, train,
                           val, total_steps=10, policy=SentinelPolicy.from_spec(spec),
                           device="cpu")
    Xa, yt = _aug(np.asarray(train[0], np.float64)), np.asarray(train[1])
    rows = np.arange(16)
    W, v = store.live_step(0, None, 0, None, None)
    for _ in range(3):
        W, v = store.live_step(0, grad(W, Xa[rows], yt[rows]), v, rows, None)
    good = store.weights()
    boom = np.zeros(store.shape)
    boom[:, 0] = 1e12                        # moves one class's logits only
    assert store.live_step(0, boom, v, rows, None)[1] == v == 3
    counters = store.resilience_counters()
    assert counters["rollbacks"] == counters["diverged"] == 1
    assert counters["lr_scale"] == 0.5
    np.testing.assert_array_equal(store.weights(), good)
    assert store.live_step(0, np.full(store.shape, np.nan), v, rows, None)[1] == v
    assert store.resilience_counters()["rejection_reasons"] == {"non-finite": 1}


def test_store_stays_exactly_once_under_thread_contention():
    """Many threads pushing into one live store at once (more threads than
    cores, a tiny switch interval): every push is either applied once or
    counted late, versions run 1..T without a gap, and each recorded
    staleness is the version at apply minus the version read."""
    spec = ExperimentSpec(backend="dist", dist_mode="live", strategy="dc_asgd", **COMMON)
    X, y, k = _toy()
    W0, train, val, _ = prepare_run(X, y, k, spec.to_schedule_config())
    total, n_threads, pushes = 120, 2 * (os.cpu_count() or 4), 20
    store = ParameterStore(spec, get_compensator(spec.strategy, spec.to_guided_config()), W0,
                           train, val, total_steps=total, device="cpu")
    Xa, yt = _aug(np.asarray(train[0], np.float64)), np.asarray(train[1])
    rows = np.arange(16)
    made = []

    def worker():
        out = store.live_step(0, None, 0, None, None)
        if out is None:
            return
        W, v = out
        for _ in range(pushes):
            made.append(1)
            out = store.live_step(0, grad(W, Xa[rows], yt[rows]), v, rows, W)
            if out is None:
                return
            W, v = out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert store.progress() == total == len(store.history) == len(store.staleness)
    assert [v for v, _ in store.history] == list(range(1, total + 1))
    assert len(made) == total + store.late and store.late > 0
    assert min(store.staleness) >= 0
    assert np.isfinite([e for _, e in store.history]).all()


def test_chief_keeps_accepting_after_a_peer_drops_mid_handshake():
    """A peer that connects and closes before answering the authentication
    challenge (a worker killed while connecting) used to end the chief's
    accept thread with EOFError: every later worker, and close()'s wake-up
    connection, then waited forever for a challenge. The accept loop now
    skips the failed handshake and serves the next peer."""
    import socket

    from repro_torch.dist import protocol
    from repro_torch.dist.chief import Chief

    result = {}

    def handshakes():  # in a thread: a regression fails the test instead of hanging it
        chief = Chief(None, {"n_workers": 1})
        try:
            for _ in range(3):
                socket.create_connection(chief.address, timeout=5).close()
            conn = protocol.connect(chief.address, timeout=5.0)
            conn.send(("hello", 0))
            result["welcome"] = conn.recv()[:2]
            conn.send(("bye",))
            conn.close()
        finally:
            chief.close(timeout=5.0, strict=True)
        result["accept_alive"] = chief._accept_thread.is_alive()

    t = threading.Thread(target=handshakes, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "the chief stopped accepting after a dropped handshake"
    assert result == {"welcome": ("welcome", 0), "accept_alive": False}


def test_listener_queues_every_worker_while_the_chief_handshakes():
    """Ten workers connecting at once to a chief whose accept thread is slow
    (a busy process): with multiprocessing's default backlog of 1, some of
    them were left for good in connections the chief never accepted (the
    dist replay fits stalled on the card); every one must get through."""
    from multiprocessing.connection import Client

    from repro_torch.dist import protocol

    listener = protocol.listen()
    accepted, connected = [], []

    def accept_slowly():
        for _ in range(10):
            time.sleep(0.2)
            accepted.append(listener.accept())

    def connect():
        connected.append(Client(listener.address, family="AF_INET",
                                authkey=protocol.AUTHKEY))

    threads = [threading.Thread(target=accept_slowly, daemon=True)] + [
        threading.Thread(target=connect, daemon=True) for _ in range(10)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30.0
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    try:
        assert len(connected) == len(accepted) == 10
    finally:
        for c in accepted + connected:
            c.close()
        listener.close()


def test_worker_imports_neither_torch_nor_jax():
    """A worker process pays for numpy and the port's protocol only."""
    code = ("import sys\n"
            "import repro_torch.dist.worker\n"
            "from repro_torch.common.topologies import compute_time_sampler\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=60,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
