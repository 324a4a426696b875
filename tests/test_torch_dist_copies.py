"""The port's copies of the dist slice's numpy and standard-library modules
equal the JAX package's on the same inputs: the dist and resilience spec
fields and every ValueError they raise, `DelaySchedule.fetch_version`,
`Scenario`, `ChaosPlan`, `GradScreen` / `DivergenceDetector` over one seeded
gradient stream, `LeaseTable` and `Supervisor` (with a fake spawn function
and a hand-driven clock), `compute_time_sampler`, and the chief's checkpoint
format, which crosses between the packages in both directions."""
import dataclasses
import os

import numpy as np
import pytest

from repro import chaos as JCHAOS
from repro import checkpoint as JCKPT
from repro import resilience as JRES
from repro.common import topologies as JTOP
from repro.core import parameter_server as JPS
from repro.dist import scenarios as JSCN
from repro.engine import spec as JSPEC
from repro.resilience import supervisor as JSUP
from repro_torch import chaos as CHAOS
from repro_torch import checkpoint as CKPT
from repro_torch import resilience as RES
from repro_torch.common import topologies as TOP
from repro_torch.core import parameter_server as PS
from repro_torch.dist import scenarios as SCN
from repro_torch.engine import spec as SPEC
from repro_torch.resilience import supervisor as SUP

LIVE = dict(backend="dist", dist_mode="live", mode="asgd")


# ------------------------------------------------------------------ spec


@pytest.mark.parametrize("kw", [
    dict(LIVE, delayed_avg=True, dist_drop_rate=0.1, dist_time_scale=0.01,
         dist_events=(("kill", 0, 5), ("join", 0, 9)), dist_timeout=30.0, workers=4),
    dict(LIVE, sentinel="full", sentinel_factor=7.0, rollback=True, max_rollbacks=2,
         lr_backoff=0.25, quarantine_steps=40, quarantine_after=4, dist_supervise=False,
         dist_lease_s=2.0, dist_max_respawns=5, ckpt_dir="d", ckpt_every=7, keep_last=0),
    dict(backend="dist", dist_mode="replay", mode="ssgd", optimizer="rmsprop"),
], ids=["faults", "resilience", "replay"])
def test_dist_spec_fields_equal_the_reference(kw):
    port, ref = SPEC.ExperimentSpec(**kw), JSPEC.ExperimentSpec(**kw)
    for f in dataclasses.fields(SPEC.ExperimentSpec):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(port.to_schedule_config()) == \
        dataclasses.asdict(ref.to_schedule_config())


REFUSED = [
    dict(backend="dist", dist_mode="nope"),
    dict(backend="dist", dist_mode="live", mode="ssgd"),
    dict(backend="dist", dist_mode="replay", mode="asgd", dist_events=(("kill", 0, 5),)),
    dict(backend="dist", dist_mode="replay", mode="asgd", delayed_avg=True),
    dict(LIVE, dist_events=(("explode", 0, 5),)),
    dict(LIVE, dist_events=(("kill", 0),)),
    dict(backend="scan", mode="asgd", delayed_avg=True),
    dict(backend="sim", dist_time_scale=0.1),
    dict(LIVE, dist_drop_rate=1.5),
    dict(LIVE, dist_drop_rate=-0.1),
    dict(backend="dist", optimizer="adam"),
    dict(LIVE, keep_last=-1),
    dict(LIVE, sentinel="paranoid"),
    dict(LIVE, sentinel="finite", sentinel_factor=1.0),
    dict(backend="scan", sentinel="finite"),
    dict(backend="dist", dist_mode="replay", sentinel="finite"),
    dict(backend="mesh", sentinel="finite", rollback=True),
    dict(LIVE, rollback=True),
    dict(LIVE, quarantine_steps=5),
    dict(LIVE, sentinel="finite", max_rollbacks=-1),
    dict(LIVE, sentinel="finite", quarantine_steps=-1),
    dict(LIVE, sentinel="finite", rollback=True, lr_backoff=0.0),
    dict(LIVE, sentinel="finite", rollback=True, lr_backoff=1.5),
    dict(LIVE, sentinel="finite", quarantine_after=0),
    dict(LIVE, dist_lease_s=-1.0),
    dict(LIVE, dist_max_respawns=-1),
]


@pytest.mark.parametrize("kw", REFUSED, ids=[str(i) for i in range(len(REFUSED))])
def test_dist_spec_refusals_equal_the_reference(kw):
    """Every construction-time check of the dist and resilience fields: the
    port raises where the reference does, with the reference's message."""
    with pytest.raises(ValueError) as ref:
        JSPEC.ExperimentSpec(**kw)
    with pytest.raises(ValueError) as port:
        SPEC.ExperimentSpec(**kw)
    assert str(port.value) == str(ref.value)


# ------------------------------------------ schedules, scenarios, topologies


@pytest.mark.parametrize("mode,topology", [("asgd", "exp"), ("asgd", "heavy_tail"),
                                           ("ssgd", "barrier"), ("seq", "seq")])
def test_fetch_version_equals_the_reference(mode, topology):
    rng = np.random.default_rng(3)
    X, y = rng.standard_normal((200, 4)), rng.integers(0, 3, 200)
    cfg = dict(mode=mode, epochs=2, rho=4, seed=5)
    sampler = TOP.TOPOLOGY_SAMPLERS[topology]
    port = PS.prepare_run(X, y, 3, PS.PSConfig(**cfg), delay_sampler=sampler,
                          topology=topology)[3]
    ref = JPS.prepare_run(X, y, 3, JPS.PSConfig(**cfg),
                          delay_sampler=JTOP.TOPOLOGY_SAMPLERS[topology], topology=topology)[3]
    assert port.fetch_version.dtype == ref.fetch_version.dtype == np.int64
    np.testing.assert_array_equal(port.fetch_version, ref.fetch_version)
    assert (port.fetch_version >= 0).all()


def test_scenario_equals_the_reference():
    kw = dict(LIVE, dist_drop_rate=0.2, dist_time_scale=0.05,
              dist_events=(("join", 0, 30), ("kill", 1, 10), ("restart", 1, 20)))
    port = SCN.Scenario.from_spec(SPEC.ExperimentSpec(**kw))
    ref = JSCN.Scenario.from_spec(JSPEC.ExperimentSpec(**kw))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for fired in range(4):
        for version in (0, 9, 10, 15, 20, 29, 30, 99):
            assert port.due(fired, version) == ref.due(fired, version)


def test_compute_time_sampler_equals_the_reference():
    for name in TOP.TOPOLOGY_SAMPLERS:
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        port, ref = TOP.compute_time_sampler(name), JTOP.compute_time_sampler(name)
        assert [port(w, a) for w in range(5)] == [ref(w, b) for w in range(5)]
    for mod in (TOP, JTOP):
        with pytest.raises(KeyError, match="unknown topology"):
            mod.compute_time_sampler("warp")


def test_chaos_plan_equals_the_reference():
    kw = dict(seed=3, kills=((0, 6),), resets={1: 5}, nan_grad=((0, 4),),
              boom_grad={2: 8}, corrupt_frame=((1, 3),), truncate_at=12, slow_disk_s=0.5)
    for plan_kw in (kw, {}):
        port, ref = CHAOS.ChaosPlan(**plan_kw), JCHAOS.ChaosPlan(**plan_kw)
        assert port.worker_meta() == ref.worker_meta()
        assert port.kill_events() == ref.kill_events()
        assert port.reset_events() == ref.reset_events()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# ------------------------------------------------------------- resilience


def _stream(seed=0, n=60):
    """A seeded stream of pushes: sane gradients, NaN and Inf ones, norm
    spikes, a worker that goes bad for a stretch, and recoveries."""
    rng = np.random.default_rng(seed)
    out = []
    for v in range(n):
        wid = int(rng.integers(0, 3))
        g = rng.standard_normal(6)
        kind = rng.random()
        if 20 <= v < 30 and wid == 2:
            g = g * np.nan
        elif kind < 0.08:
            g[int(rng.integers(0, 6))] = np.inf
        elif kind < 0.2:
            g = g * 1e4
        out.append((wid, g, v))
    return out


@pytest.mark.parametrize("policy", [
    dict(level="full", factor=10.0, quarantine_steps=8, quarantine_after=2),
    dict(level="finite", quarantine_steps=0, quarantine_after=1),
    dict(level="full", factor=3.0, quarantine_steps=20, quarantine_after=3),
])
def test_grad_screen_decisions_equal_the_reference(policy):
    port, ref = RES.GradScreen(RES.SentinelPolicy(**policy)), \
        JRES.GradScreen(JRES.SentinelPolicy(**policy))
    verdicts = []
    for wid, g, v in _stream():
        a, b = port.admit(wid, g, v), ref.admit(wid, g, v)
        assert a == b, (wid, v)
        verdicts.append(a)
        assert port.norm_ema == ref.norm_ema
    port.quarantine(1, 70)
    ref.quarantine(1, 70)
    assert port.counters() == ref.counters()
    assert port.quarantined_until == ref.quarantined_until
    seen = {"non-finite", None}
    if policy["level"] == "full":  # the stream trips the norm screen and a quarantine
        seen |= {"norm-exploded", "quarantined"}
    assert seen <= set(verdicts)


def test_divergence_detector_equals_the_reference():
    rng = np.random.default_rng(1)
    losses = list(0.7 * np.exp(-np.arange(30) / 10) + 0.01 * rng.random(30))
    losses[10:10] = [50.0, float("nan"), 3.0, float("inf")]
    port, ref = RES.DivergenceDetector(10.0), JRES.DivergenceDetector(10.0)
    trips = [port.update(x) for x in losses]
    assert trips == [ref.update(x) for x in losses]
    assert port.best == ref.best and sum(trips) == 4   # 50, nan, 3.0 (> 10 x 0.26), inf


def test_sentinel_policy_equals_the_reference():
    kw = dict(LIVE, sentinel="full", sentinel_factor=7.0, rollback=True, max_rollbacks=2,
              lr_backoff=0.25, quarantine_steps=40, quarantine_after=4)
    port = RES.SentinelPolicy.from_spec(SPEC.ExperimentSpec(**kw))
    ref = JRES.SentinelPolicy.from_spec(JSPEC.ExperimentSpec(**kw))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.screening, port.norm_screen) == (ref.screening, ref.norm_screen)


def test_lease_table_equals_the_reference():
    port, ref = RES.LeaseTable(0.5), JRES.LeaseTable(0.5)
    for table in (port, ref):
        table.touch(0)
        table.touch(1)
        table.drop(1)
    t0 = min(port.snapshot()[0], ref.snapshot()[0])
    for now in (t0, t0 + 0.4, t0 + 1.0, t0 + 100.0):
        for wid in (0, 1, 2):
            assert port.expired(wid, now) == ref.expired(wid, now)
            assert port.touched_since(wid, t0 - 1) == ref.touched_since(wid, t0 - 1)
    assert not RES.LeaseTable(0.0).expired(0, t0)


class _FakeProc:
    def __init__(self, wid, log):
        self.wid, self.dead = wid, False
        log.append(wid)

    def alive(self):
        return not self.dead

    def kill(self):
        self.dead = True

    def cleanup(self):
        pass

    def stderr_tail(self, n=5):
        return ""


def _drive_supervisor(mod, leases=None):
    """One scripted fault sequence on a supervisor with a fake spawn and a
    hand-driven clock; returns (spawn log, stats, backoffs)."""
    log = []
    sup = mod.Supervisor(lambda wid: _FakeProc(wid, log), n_workers=3, max_respawns=1,
                         leases=leases, seed=4)
    sup.start()
    sup.stop_polling()       # drive poll(now=...) by hand: a deterministic clock
    backoffs = [sup._backoff(s) for s in (1, 2, 3, 9)]
    procs = {p.wid: p for p in sup.procs()}
    t = 100.0
    procs[0].dead = True
    sup.poll(now=t)                         # death detected, backoff starts
    sup.poll(now=t + 10)                    # respawned
    sup.poll(now=t + 11)                    # healthy: recovery recorded
    sup.respawn_now(1)                      # an injected restart
    sup.spawn_extra()                       # an elastic join
    for p in sup.procs():
        if p.wid == 2:
            p.dead = True
    sup.poll(now=t + 20)
    sup.poll(now=t + 30)                    # streak 1: respawned
    for p in sup.procs():
        if p.wid == 2:
            p.dead = True
    sup.poll(now=t + 40)                    # streak 2 > budget 1: evicted
    sup.poll(now=t + 50)
    stats = sup.stats()
    sup.close()
    return log, stats, backoffs


def test_supervisor_equals_the_reference():
    port, ref = _drive_supervisor(SUP), _drive_supervisor(JSUP)
    assert port == ref
    log, stats, _ = port
    assert stats["evicted"] == [2] and stats["respawns"] == 3
    assert log == [0, 1, 2, 0, 1, None, 2]


def test_supervisor_lease_expiry_equals_the_reference():
    out = []
    for mod in (SUP, JSUP):
        leases = mod.LeaseTable(0.5)
        log = []
        sup = mod.Supervisor(lambda wid: _FakeProc(wid, log), n_workers=1, leases=leases)
        sup.start()
        sup.stop_polling()
        leases.touch(0)
        now = leases.snapshot()[0]
        sup.poll(now=now)                   # fresh lease: healthy
        sup.poll(now=now + 5.0)             # expired: hung -> killed
        out.append((log, sup.stats()["lease_expiries"], [p.dead for p in sup.procs()]))
        sup.close()
    assert out[0] == out[1] == ([0], 1, [True])


# ------------------------------------------------------------ checkpoints


def _snap(pkg, v):
    W = np.arange(6, dtype=np.float64).reshape(3, 2) * v
    return pkg.dist_snapshot(W, v, np.arange(v) % 3, r=W * 0.5, lr_scale=0.25 * v)


def _write(pkg, d, steps, keep_last=0):
    ckpt = pkg.AsyncCheckpointer(d, keep_last=keep_last, meta={"backend": "dist"})
    for v in steps:
        ckpt.save(v, _snap(pkg, v))
    ckpt.close()


def _assert_restored(out, v):
    want = _snap(CKPT, v)["dist"]
    assert sorted(out) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(out[key], val)
        assert out[key].dtype == val.dtype


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_chief_snapshots_cross_between_the_packages(tmp_path, writer, reader):
    pkgs = {"ref": JCKPT, "port": CKPT}
    d = str(tmp_path)
    _write(pkgs[writer], d, (2, 4, 6), keep_last=2)
    rd = pkgs[reader]
    assert rd.latest_step(d) == 6
    assert [e["step"] for e in rd.manifest_entries(d)] == [6, 4]
    for e in rd.manifest_entries(d):
        rd.verify_entry(d, e)
        assert e["sha256"] == rd.file_sha256(os.path.join(d, e["file"]))
    _assert_restored(rd.dist_restore(d), 6)
    _assert_restored(rd.dist_restore(d, step=4), 4)
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "step_00000004.npz",
                                     "step_00000006.npz"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_truncated_newest_falls_back_to_an_older_step(tmp_path, pkg):
    """A torn newest archive (chaos `truncate_newest`) fails its checksum and
    both packages' readers fall back to the older step; every entry torn is
    a CorruptCheckpointError."""
    write = {"ref": JCKPT, "port": CKPT}[pkg]
    d = str(tmp_path)
    _write(write, d, (3, 5))
    step, path = CHAOS.truncate_newest(d)
    assert step == 5 and os.path.getsize(path) > 0
    for rd in (CKPT, JCKPT):
        with pytest.raises(rd.CorruptCheckpointError, match="step 5"):
            rd.verify_entry(d, rd.manifest_entries(d)[0])
        _assert_restored(rd.dist_restore(d), 3)
    JCHAOS.truncate_newest(d, keep_fraction=0.999)   # a no-op on the torn 5
    entries = CKPT.manifest_entries(d)
    with open(os.path.join(d, entries[1]["file"]), "r+b") as f:
        f.truncate(10)
    for rd in (CKPT, JCKPT):
        with pytest.raises(rd.CorruptCheckpointError, match="no intact chief snapshot"):
            rd.dist_restore(d)


def test_empty_dir_restores_nothing(tmp_path):
    for rd, ch in ((CKPT, CHAOS), (JCKPT, JCHAOS)):
        assert rd.latest_step(str(tmp_path)) is None
        assert ch.truncate_newest(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            rd.dist_restore(str(tmp_path))
