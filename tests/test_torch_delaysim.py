"""The port's scan backend (repro_torch.engine.delaysim, through
`Trainer(backend="scan", device="cpu")`) against the JAX package:

  * trajectory parity with the numpy reference loop (repro's train_ps) for
    the paper's algorithms, at the reference's bar of 1e-5 on final losses
    and history (float64 gives ~1e-15);
  * parity with the JAX scan backend for what train_ps cannot run (dc_asgd,
    dc_asgd at lambda=0, gap_aware, momentum, adam, a heavy-tail topology).
    The JAX scan needs `jax.experimental.enable_x64`, which the installed jax
    no longer has; it runs in ONE subprocess per module that sets it before
    importing repro.engine, so this process never imports
    repro.engine.delaysim and no other test file sees the change;
  * the multi-seed batch equals independent single-seed fits bit for bit;
  * the scan-sim hooks reduce per seed, as the reference's do under vmap;
  * the reference's edge cases and validations.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.parameter_server import PSConfig, train_ps
from repro.data import load_dataset, train_test_split
from repro_torch.core.guided import GuidedConfig
from repro_torch.engine import ExperimentSpec, TOPOLOGIES, Trainer, get_compensator
from repro_torch.engine import delaysim
from repro_torch.engine.spec import needs_stale_message
from repro_torch.engine.strategies import sim_shim_state
from repro_torch.kernels.guided_update import ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cancer():
    X, y, k = load_dataset("cancer", seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=2)
    return Xtr[:260], ytr[:260], k, Xte, yte


@pytest.fixture(scope="module")
def thyroid():
    X, y, k = load_dataset("new_thyroid", seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=1)
    return Xtr, ytr, k, Xte, yte


def _fit(spec, data):
    return Trainer.from_spec(spec, device="cpu").fit(data)


def _hist(rep, seed=None):
    return np.array([h[1] if seed is None else h[1][seed] for h in rep.history])


# ------------------------------------------------------------ vs train_ps

ALGOS = ["SGD", "SSGD", "gSSGD", "ASGD", "gSGD", "gASGD", "SRMSprop", "gSAdagrad"]


@pytest.mark.parametrize("algo", ALGOS)
def test_scan_matches_train_ps(cancer, algo):
    """The reference's acceptance lock (test_delaysim.py:42-73) held on the
    port: same seed -> same schedule -> the numpy loop's trajectory."""
    Xtr, ytr, k, Xte, yte = cancer
    seed = 2 if algo in ALGOS[:4] else 3
    spec = ExperimentSpec.for_algo(algo, epochs=2, seed=seed, backend="scan")
    legacy = train_ps(Xtr, ytr, k, PSConfig(**dataclasses.asdict(spec.to_ps_config())),
                      Xte, yte)
    n0 = dict(ops.launches)
    rep = _fit(spec, (Xtr, ytr, k, Xte, yte))
    assert ops.launches == n0  # the CPU runs the kernels' plain versions
    assert rep.backend == "scan" and rep.n_steps == legacy["n_steps"]
    assert abs(rep.final_loss - legacy["train_loss"]) <= 1e-5
    assert abs(rep.val_loss - legacy["val_loss"]) <= 1e-5
    h_np = np.array([h[1] for h in legacy["history"]])
    assert _hist(rep).shape == h_np.shape
    np.testing.assert_allclose(_hist(rep), h_np, atol=1e-5, rtol=0)
    assert rep.test_accuracy == legacy["test_accuracy"]


def test_sim_backend_is_train_ps(cancer):
    Xtr, ytr, k, Xte, yte = cancer
    spec = ExperimentSpec.for_algo("gASGD", epochs=2, seed=1)
    rep = _fit(spec, (Xtr, ytr, k, Xte, yte))
    legacy = train_ps(Xtr, ytr, k, PSConfig(mode="asgd", guided=True, epochs=2, seed=1),
                      Xte, yte)
    assert rep.backend == "sim" and rep.history == legacy["history"]
    assert rep.final_loss == legacy["train_loss"] and rep.n_steps == legacy["n_steps"]


# ------------------------------------------------------ vs the JAX scan

JAX_CASES = {
    "dc_asgd": dict(mode="asgd", strategy="dc_asgd"),
    "dc_asgd_lambda0": dict(mode="asgd", strategy="dc_asgd", dc_lambda=0.0),
    "dc_asgd_guided": dict(mode="asgd", strategy="dc_asgd_guided", rho=4),
    "gap_aware": dict(mode="asgd", strategy="gap_aware"),
    "momentum": dict(mode="ssgd", strategy="guided_fused", optimizer="momentum", rho=4),
    "adam": dict(mode="asgd", strategy="dc_asgd", optimizer="adam", lr=0.01),
    "heavy_tail": dict(mode="asgd", strategy="guided_fused", topology="heavy_tail", rho=6),
}
JAX_COMMON = dict(epochs=3, seed=4, n_seeds=2)

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # the name the reference imports
    import numpy as np
    from repro.data import load_dataset, train_test_split
    from repro.engine import ExperimentSpec, Trainer

    cases, common, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
    X, y, k = load_dataset("cancer", seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=2)
    data = (Xtr[:260], ytr[:260], k, Xte, yte)
    res = {}
    for name, kw in cases.items():
        rep = Trainer.from_spec(ExperimentSpec(backend="scan", **common, **kw)).fit(data)
        res[name + "/history"] = np.array([h[1] for h in rep.history])
        res[name + "/train_loss"] = rep.final["train_loss"]
        res[name + "/val_loss"] = rep.final["val_loss"]
        res[name + "/W"] = np.stack([m.W for m in rep.model])
    np.savez(out, **res)
""")


def _one_cpu():
    """Keep the subprocess's XLA threads on one core, so it does not crowd
    the timing-sensitive tests that other workers run beside it."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:1])


@pytest.fixture(scope="module")
def jax_scan(tmp_path_factory):
    """Every JAX_CASES fit of the JAX scan backend, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_scan") / "scan.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(JAX_CASES),
                           json.dumps(JAX_COMMON), str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300,
                          preexec_fn=_one_cpu if hasattr(os, "sched_setaffinity") else None)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_scan_matches_jax_scan(cancer, jax_scan, case):
    rep = _fit(ExperimentSpec(backend="scan", **JAX_COMMON, **JAX_CASES[case]), cancer)
    h = np.stack([np.asarray(x[1]) for x in rep.history])
    assert h.shape == jax_scan[case + "/history"].shape
    np.testing.assert_allclose(h, jax_scan[case + "/history"], atol=1e-5, rtol=0)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(rep.final[key], jax_scan[f"{case}/{key}"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.stack([m.W for m in rep.model]), jax_scan[case + "/W"],
                               atol=1e-5, rtol=0)


def test_compensation_changes_the_trajectory(thyroid):
    base = ExperimentSpec(backend="scan", mode="asgd", strategy="none", epochs=2, seed=0)
    r0 = _fit(base, thyroid)
    for strat in ("dc_asgd", "gap_aware"):
        r = _fit(base.replace(strategy=strat), thyroid)
        assert np.isfinite(r.final_loss) and r.final_loss != r0.final_loss


# ------------------------------------------------------------ multi-seed


def test_multi_seed_batch_equals_independent_runs(thyroid):
    """n_seeds=4 returns, leaf for leaf, exactly what four n_seeds=1 fits
    return (test_delaysim.py:127)."""
    rep4 = _fit(ExperimentSpec.for_algo("gSSGD", epochs=3, seed=5, backend="scan", n_seeds=4),
                thyroid)
    assert rep4.final["train_loss"].shape == (4,)
    for i in range(4):
        r1 = _fit(ExperimentSpec.for_algo("gSSGD", epochs=3, seed=5 + i, backend="scan"),
                  thyroid)
        assert float(rep4.final["train_loss"][i]) == r1.final_loss
        assert float(rep4.final["val_loss"][i]) == r1.val_loss
        assert float(rep4.final["test_accuracy"][i]) == r1.test_accuracy
        assert all(float(h4[1][i]) == h1[1] for h4, h1 in zip(rep4.history, r1.history))
        np.testing.assert_array_equal(rep4.model[i].W, r1.model.W)


def test_arrival_loop_copy_continues_the_same_fit(thyroid):
    """ArrivalLoop.to(device) copies the whole state: the copy and the
    original continue identically and independently."""
    spec = ExperimentSpec(backend="scan", mode="asgd", strategy="dc_asgd_guided",
                          optimizer="rmsprop", epochs=3, rho=4, n_seeds=2)
    strategy = get_compensator(spec.strategy, spec.to_guided_config())
    loop = delaysim.ArrivalLoop(spec, strategy, delaysim.prepare(spec, *thyroid[:3]), "cpu")
    loop.advance(7)
    W7, ring7 = loop.W.clone(), loop.ring.clone()
    twin = loop.to("cpu")
    twin.advance(loop.T)
    assert loop.i == 7 and torch.equal(loop.W, W7) and torch.equal(loop.ring, ring7)
    loop.advance(loop.T)
    assert torch.equal(loop.avgs, twin.avgs) and torch.equal(loop.W, twin.W)
    rep = _fit(spec, thyroid)
    np.testing.assert_array_equal(_hist(rep, 1), loop.avgs[1].numpy())


def test_hooks_reduce_per_seed_like_the_vmapped_reference():
    """sim_replay (top-k with ties), sim_score and gap_aware's rms on a
    (S, ...) batch equal the reference hooks applied to each seed alone."""
    import jax
    import jax.numpy as jnp

    from repro.core.guided import GuidedConfig as JGuidedConfig
    from repro.engine.strategies import get_compensator as jget
    from repro.engine.strategies import sim_shim_state as jshim

    rng = np.random.default_rng(0)
    S, rho, P, k = 3, 6, 5, 2
    W = rng.standard_normal((S, P, k))
    Wf = W + 0.1 * rng.standard_normal((S, P, k))
    g = rng.standard_normal((S, P, k)) * np.array([1.0, 10.0, 0.1])[:, None, None]
    grads = rng.standard_normal((S, rho, P, k))
    scores = np.array([[0.0, 0.5, 0.5, 0.2, 0.5, 0.0],    # ties at the top
                       [0.0] * 6,                          # nothing consistent
                       [0.3, 0.1, 0.3, 0.3, 0.3, 0.3]])    # more ties than k
    d_own = rng.standard_normal(S)
    d_avg = rng.standard_normal(S)
    prev = np.array([np.inf, 2.0, -3.0])
    port_g = get_compensator("guided_fused", GuidedConfig(mode="asgd", max_consistent=4))
    port_ga = get_compensator("gap_aware", GuidedConfig(mode="asgd"))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    replay = port_g.sim_replay(t(W), t(scores), t(grads), 0.2).numpy()
    score = port_g.sim_score(t(d_own), t(d_avg), t(prev)).numpy()
    damped = port_ga.compensate_grads(t(g), t(W), sim_shim_state(
        0, t(Wf), t(prev), 4)).numpy()
    with jax.enable_x64(True):
        jg = jget("guided_fused", JGuidedConfig(mode="asgd", max_consistent=4))
        jga = jget("gap_aware", JGuidedConfig(mode="asgd"))
        for s in range(S):
            np.testing.assert_allclose(
                replay[s], np.asarray(jg.sim_replay(jnp.asarray(W[s]), jnp.asarray(scores[s]),
                                                    jnp.asarray(grads[s]), 0.2)),
                atol=1e-12, rtol=0)
            np.testing.assert_allclose(
                score[s], np.asarray(jg.sim_score(d_own[s], d_avg[s], prev[s])), atol=1e-12)
            np.testing.assert_allclose(
                damped[s], np.asarray(jga.compensate_grads(
                    jnp.asarray(g[s]), jnp.asarray(W[s]),
                    jshim(0, jnp.asarray(Wf[s]), prev[s], 4))), atol=1e-12, rtol=0)


@pytest.mark.parametrize("lam", [0.0, 0.04])
def test_dc_asgd_compensation_rounds_through_float32(lam):
    """compensate_dc_asgd computes in float32 even on f64 gradients, as the
    reference does; the scan backend's dc_lambda=0 path relies on it."""
    import jax
    import jax.numpy as jnp

    from repro.core.guided import compensate_dc_asgd as jcompensate
    from repro_torch.core.guided import compensate_dc_asgd

    rng = np.random.default_rng(1)
    g, W, Wf = (rng.standard_normal((3, 7, 2)) for _ in range(3))
    out = compensate_dc_asgd(*(torch.from_numpy(a) for a in (g, W, Wf)), lam).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jcompensate(*(jnp.asarray(a) for a in (g, W, Wf)), lam))
    assert out.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(out, out.astype(np.float32))   # f32 values
    assert not np.array_equal(out, g + lam * g * g * (W - Wf))    # not the f64 result
    if lam == 0.0:
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)


# ------------------------------------------------------ topologies, optimizers


@pytest.mark.parametrize("topology", ["constant", "heavy_tail", "straggler", "hetero"])
def test_event_topologies_run_and_are_causal(thyroid, topology):
    spec = ExperimentSpec(backend="scan", mode="asgd", strategy="guided_fused",
                          topology=topology, epochs=2, seed=0, rho=6)
    rep = _fit(spec, thyroid)
    assert np.isfinite(rep.final_loss)
    sched = delaysim.prepare(spec, thyroid[0], thyroid[1], thyroid[2])[0][3]
    assert sched.n_steps == rep.n_steps
    i = np.arange(sched.n_steps)
    assert (sched.staleness <= i).all() and (sched.staleness >= 0).all()
    assert sched.topology == topology


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
@pytest.mark.parametrize("strategy", ["guided_fused", "dc_asgd"])
def test_fused_optimizers_train(thyroid, optimizer, strategy):
    spec = ExperimentSpec(backend="scan", mode="asgd", strategy=strategy, epochs=2, seed=0,
                          rho=4, lr=0.01, optimizer=optimizer)
    rep = _fit(spec, thyroid)
    losses = _hist(rep)
    assert np.isfinite(rep.final_loss) and losses[-1] < losses[0]


# --------------------------------------------------------- edge cases


def test_zero_arrivals_return_the_init_like_train_ps(thyroid):
    """batch_size > n_train yields zero arrivals (test_delaysim.py:260)."""
    Xtr, ytr, k, Xte, yte = thyroid
    data = (Xtr[:20], ytr[:20], k, Xte, yte)
    spec = ExperimentSpec.for_algo("SSGD", epochs=2, seed=0, batch_size=64)
    ref = _fit(spec, data)
    rep = _fit(spec.replace(backend="scan"), data)
    assert rep.history == [] == ref.history
    assert rep.n_steps == 0
    assert rep.final_loss == ref.final_loss
    assert rep.test_accuracy == ref.test_accuracy


def test_seeds_with_unequal_schedules_are_refused(thyroid, monkeypatch):
    Xtr, ytr, k, _, _ = thyroid
    real = delaysim.prepare_run

    def short_for_seed_1(X, y, n_classes, cfg, **kw):
        W0, tr, va, sched = real(X, y, n_classes, cfg, **kw)
        if cfg.seed == 1:
            sched = type(sched)(sched.batch_rows[:-1], sched.staleness[:-1], sched.n_workers,
                                sched.topology, sched.worker[:-1])
        return W0, tr, va, sched

    monkeypatch.setattr(delaysim, "prepare_run", short_for_seed_1)
    spec = ExperimentSpec.for_algo("SSGD", epochs=1, seed=0, backend="scan", n_seeds=2)
    with pytest.raises(ValueError, match="seeds disagree on arrival count"):
        _fit(spec, (Xtr, ytr, k))


def test_report_has_timing_and_steps(thyroid):
    rep = _fit(ExperimentSpec.for_algo("SSGD", epochs=1, backend="scan", n_seeds=2), thyroid)
    assert rep.wall_time_s > 0 and rep.steps_per_s > 0
    assert rep.n_steps == len(rep.history) > 0


def test_trainer_errors_match_the_reference(thyroid):
    spec = ExperimentSpec.for_algo("SSGD", backend="scan")
    with pytest.raises(ValueError, match="scan backend needs data"):
        Trainer.from_spec(spec, device="cpu").fit()
    for kw in (dict(steps=3), dict(on_step=print), dict(resume=True)):
        with pytest.raises(ValueError, match="mesh backend"):
            Trainer.from_spec(spec, device="cpu").fit(thyroid, **kw)
    with pytest.raises(KeyError, match="registered:"):
        Trainer.from_spec(ExperimentSpec(backend="scan", strategy="nope"), device="cpu")
    # the mesh and dist backends are ported (tests/test_torch_mesh.py,
    # tests/test_torch_dist.py): they construct, and dist needs data as scan does
    assert Trainer.from_spec(ExperimentSpec(backend="mesh"), device="cpu").strategy.name == "none"
    dist = Trainer.from_spec(ExperimentSpec(backend="dist"), device="cpu")
    assert dist.strategy.name == "none"
    with pytest.raises(ValueError, match="dist backend needs data"):
        dist.fit()


def test_scan_runs_on_the_card_unless_asked(thyroid):
    """device defaults to "cuda"; without a card that raises, never a silent
    CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_spec(ExperimentSpec.for_algo("SSGD", backend="scan"))


# ------------------------------------------------------- spec validation


def test_spec_rejects_stale_strategies_without_asgd():
    for strat in ("gap_aware", "dc_asgd", "dc_asgd_guided"):
        with pytest.raises(ValueError, match="asgd"):
            ExperimentSpec(backend="scan", mode="ssgd", strategy=strat)
        with pytest.raises(ValueError, match="asgd"):
            ExperimentSpec(backend="mesh", mode="seq", strategy=strat)


def test_spec_validates_topology():
    with pytest.raises(ValueError, match="unknown topology"):
        ExperimentSpec(backend="scan", mode="asgd", topology="wormhole")
    with pytest.raises(ValueError, match="backend knob"):
        ExperimentSpec(backend="sim", mode="asgd", topology="heavy_tail")
    with pytest.raises(ValueError, match="defined for mode"):
        ExperimentSpec(backend="scan", mode="ssgd", topology="heavy_tail")
    ExperimentSpec(backend="scan", mode="ssgd", topology="barrier")
    ExperimentSpec(backend="scan", mode="asgd", topology="exp")
    assert ExperimentSpec(backend="scan", mode="ssgd").resolved_topology == "barrier"
    assert set(TOPOLOGIES) >= {"seq", "barrier", "exp", "constant", "heavy_tail",
                               "straggler", "hetero"}


def test_spec_validates_n_seeds_and_optimizers():
    with pytest.raises(ValueError, match="n_seeds"):
        ExperimentSpec(backend="scan", n_seeds=0)
    with pytest.raises(ValueError, match="scan"):
        ExperimentSpec(backend="sim", mode="ssgd", n_seeds=4)
    with pytest.raises(ValueError, match="scan"):
        ExperimentSpec(backend="mesh", n_seeds=2)
    for backend in ("sim", "dist"):
        for optimizer in ("momentum", "adam"):
            with pytest.raises(ValueError, match="backend"):
                ExperimentSpec(backend=backend, mode="asgd", optimizer=optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        ExperimentSpec(backend="scan", optimizer="lion")


def test_spec_and_registry_share_the_stale_message():
    with pytest.raises(ValueError) as spec_err:
        ExperimentSpec(backend="mesh", mode="ssgd", strategy="gap_aware")
    with pytest.raises(ValueError) as reg_err:
        get_compensator("gap_aware", GuidedConfig(mode="ssgd"))
    assert str(spec_err.value) == str(reg_err.value)
    assert "stale weights" in needs_stale_message("x", "y", "ssgd")
