"""The port's copies of the JAX package's numpy and config modules equal the
originals: the parameter-server simulation and its rng protocol, the delay
topologies, the UCI-analog datasets, and the ExperimentSpec tables, defaults
and lowerings that the sim and scan backends read."""
import dataclasses

import numpy as np
import pytest

from repro.common import topologies as JTOP
from repro.core import parameter_server as JPS
from repro.data import uci_analogs as JDATA
from repro.engine import spec as JSPEC
from repro_torch.common import topologies as TOP
from repro_torch.core import guided as G
from repro_torch.core import parameter_server as PS
from repro_torch.data import uci_analogs as DATA
from repro_torch.engine import spec as SPEC


def _assert_same(a, b):
    """Equal leaf for leaf: arrays bitwise, the rest by ==."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, z in zip(a, b):
            _assert_same(x, z)
    elif dataclasses.is_dataclass(a):
        _assert_same(dataclasses.astuple(a), dataclasses.astuple(b))
    else:
        assert a == b


@pytest.fixture(scope="module")
def thyroid():
    X, y, k = JDATA.load_dataset("new_thyroid", seed=0)
    Xtr, ytr, Xte, yte = JDATA.train_test_split(X, y, seed=1)
    return Xtr, ytr, k, Xte, yte


# ------------------------------------------------------------ datasets


@pytest.mark.parametrize("name", JDATA.DATASETS)
def test_datasets_equal_the_reference(name):
    for seed in (0, 3):
        _assert_same(DATA.load_dataset(name, seed=seed), JDATA.load_dataset(name, seed=seed))
    X, y, _ = JDATA.load_dataset(name)
    _assert_same(DATA.train_test_split(X, y, seed=2), JDATA.train_test_split(X, y, seed=2))


def test_dataset_tables_equal_the_reference():
    assert DATA.DATASETS == JDATA.DATASETS
    assert {k: dataclasses.asdict(v) for k, v in DATA.SPECS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JDATA.SPECS.items()}


# --------------------------------------------------- parameter server


@pytest.mark.parametrize("mode,guided,optimizer", [
    ("seq", False, "sgd"), ("ssgd", True, "sgd"), ("asgd", True, "sgd"),
    ("ssgd", False, "rmsprop"), ("ssgd", True, "adagrad")])
def test_train_ps_equals_the_reference(thyroid, mode, guided, optimizer):
    Xtr, ytr, k, Xte, yte = thyroid
    kw = dict(mode=mode, guided=guided, optimizer=optimizer, epochs=3, rho=4, seed=5)
    port = PS.train_ps(Xtr, ytr, k, PS.PSConfig(**kw), Xte, yte)
    ref = JPS.train_ps(Xtr, ytr, k, JPS.PSConfig(**kw), Xte, yte)
    for key in ("train_loss", "val_loss", "history", "n_steps", "test_accuracy"):
        _assert_same(port[key], ref[key])
    _assert_same(port["model"].W, ref["model"].W)


@pytest.mark.parametrize("topology", sorted(JTOP.TOPOLOGY_SAMPLERS))
def test_prepare_run_equals_the_reference(thyroid, topology):
    """W0, the validation split and the schedule: the same rng protocol."""
    Xtr, ytr, k, _, _ = thyroid
    mode = {"seq": "seq", "barrier": "ssgd"}.get(topology, "asgd")
    kw = dict(mode=mode, epochs=3, rho=5, seed=11)
    port = PS.prepare_run(Xtr, ytr, k, PS.PSConfig(**kw), TOP.TOPOLOGY_SAMPLERS[topology],
                          topology)
    ref = JPS.prepare_run(Xtr, ytr, k, JPS.PSConfig(**kw), JTOP.TOPOLOGY_SAMPLERS[topology],
                          topology)
    _assert_same(port, ref)
    assert port[3].max_staleness == ref[3].max_staleness


def test_topologies_and_algo_names_equal_the_reference():
    assert TOP.TOPOLOGY_SAMPLERS.keys() == JTOP.TOPOLOGY_SAMPLERS.keys()
    for name, sampler in TOP.TOPOLOGY_SAMPLERS.items():
        jsampler = JTOP.TOPOLOGY_SAMPLERS[name]
        assert (sampler is None) == (jsampler is None)
        if sampler is not None:
            a, b = np.random.default_rng(4), np.random.default_rng(4)
            assert [sampler(w, a) for w in range(6)] == [jsampler(w, b) for w in range(6)]
    assert PS.ALGO_NAMES == JPS.ALGO_NAMES
    assert dataclasses.asdict(PS.PSConfig()) == dataclasses.asdict(JPS.PSConfig())


# ------------------------------------------------------------- spec


def test_every_spec_field_default_equals_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JSPEC.ExperimentSpec)}
    port = dataclasses.fields(SPEC.ExperimentSpec)
    assert len(port) == 51
    for f in port:
        assert f.name in ref, f.name
        assert f.default == ref[f.name], f.name


def test_spec_tables_equal_the_reference():
    for name in ("ALGOS", "TOPOLOGIES", "OPTIMIZERS", "SIM_OPTIMIZERS", "BACKENDS", "MODES",
                 "SCHEDULES", "SENTINELS", "DIST_MODES", "DIST_EVENT_OPS"):
        assert getattr(SPEC, name) == getattr(JSPEC, name), name
    assert SPEC.needs_stale_message("a", "b", "ssgd") == JSPEC.needs_stale_message("a", "b", "ssgd")


def _spec_pairs():
    pairs = [(name, {}) for name in JSPEC.ALGOS]
    pairs += [(None, dict(mode="asgd", strategy="dc_asgd", dc_lambda=0.0)),
              (None, dict(mode="asgd", strategy="dc_asgd_guided", staleness=3)),
              (None, dict(mode="asgd", strategy="gap_aware", rho=6)),
              (None, dict(mode="ssgd", strategy="guided_two_pass", correction_scale=0.5)),
              (None, dict(mode="ssgd", strategy="guided_fused", optimizer="momentum")),
              (None, dict(mode="asgd", strategy="none", optimizer="adam", lr=0.01,
                          topology="heavy_tail", n_seeds=3))]
    return pairs


@pytest.mark.parametrize("name,kw", _spec_pairs(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_spec_lowerings_equal_the_reference(name, kw):
    if name is not None:
        port = SPEC.ExperimentSpec.for_algo(name, backend="scan", epochs=7, seed=3)
        ref = JSPEC.ExperimentSpec.for_algo(name, backend="scan", epochs=7, seed=3)
        assert SPEC.ExperimentSpec.for_algo(name).backend == JSPEC.ExperimentSpec.for_algo(
            name).backend
    else:
        port = SPEC.ExperimentSpec(backend="scan", **kw)
        ref = JSPEC.ExperimentSpec(backend="scan", **kw)
    assert dataclasses.asdict(port.to_schedule_config()) == \
        dataclasses.asdict(ref.to_schedule_config())
    assert dataclasses.asdict(port.to_schedule_config(seed=9)) == \
        dataclasses.asdict(ref.to_schedule_config(seed=9))
    gp, gr = port.to_guided_config(), ref.to_guided_config()
    assert dataclasses.asdict(gp) == dataclasses.asdict(gr)
    assert (gp.needs_stale, gp.stale_period) == (gr.needs_stale, gr.stale_period)
    assert (port.guided, port.resolved_topology) == (ref.guided, ref.resolved_topology)
    try:
        want = dataclasses.asdict(ref.to_ps_config())
    except ValueError as e:
        with pytest.raises(ValueError, match="no parameter-server simulation"):
            port.to_ps_config()
        assert "no parameter-server simulation" in str(e)
    else:
        assert dataclasses.asdict(port.to_ps_config()) == want


def test_guided_config_equals_the_reference():
    from repro.core.guided import GuidedConfig as JGuidedConfig

    assert dataclasses.asdict(G.GuidedConfig()) == dataclasses.asdict(JGuidedConfig())
    assert G.MODES == ("seq", "ssgd", "asgd", "dc_asgd")
    with pytest.raises(AssertionError):
        G.GuidedConfig(mode="bogus")


# --------------------------------------------------------- mesh knobs


def _mesh_pairs():
    return [dict(),
            dict(arch="yi_9b", reduced=False, strategy="guided_fused", steps=20),
            dict(mode="asgd", strategy="dc_asgd", staleness=3, dc_lambda=0.1, workers=4),
            dict(mode="asgd", strategy="dc_asgd_guided", schedule="wsd", warmup=2, micro=2),
            dict(strategy="guided_two_pass", correction_scale=0.5, magnitude_weight=0.3,
                 chunk_steps=3, prefetch=True, seq_len=64, global_batch=16),
            dict(model_overrides=(("n_layers", 16),), reduced=False, optimizer="adam",
                 schedule="cosine"),
            dict(model_overrides=(("remat", "none"), ("attn_impl", "xla_chunked")))]


@pytest.mark.parametrize("kw", _mesh_pairs(), ids=str)
def test_mesh_spec_lowerings_equal_the_reference(kw):
    """The mesh knobs: to_guided_config and model_config (field by field,
    dtype names included) as the reference lowers them."""
    port, ref = SPEC.ExperimentSpec(backend="mesh", **kw), JSPEC.ExperimentSpec(backend="mesh", **kw)
    for f in dataclasses.fields(SPEC.ExperimentSpec):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(port.to_guided_config()) == dataclasses.asdict(ref.to_guided_config())
    assert dataclasses.asdict(port.model_config()) == dataclasses.asdict(ref.model_config())


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="linear"), "unknown schedule"),
    (dict(chunk_steps=0), "chunk_steps must be >= 1"),
    (dict(ckpt_every=5), "needs ckpt_dir"),
    (dict(ckpt_every=-1, ckpt_dir="d"), "must be >= 0"),
    (dict(sentinel="loud"), "unknown sentinel"),
    (dict(sentinel="finite", backend="scan"), "screens the mesh carry"),
])
def test_mesh_spec_validations_equal_the_reference(kw, match):
    for mod in (SPEC, JSPEC):
        with pytest.raises(ValueError, match=match):
            mod.ExperimentSpec(**kw)
