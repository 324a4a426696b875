"""The mesh train step's divergence sentinel (repro_torch.resilience.
wrap_step_sentinel) against repro.resilience's.

The port's counterparts of tests/test_resilience.py's four mesh-sentinel
tests, on the port's real train step (its updates are in place, so "keeps
the previous carry" means the input tensors come back untouched, bit for
bit), and the lr-5000 divergence run held against the reference's stepwise
run: the same steps rejected.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic_lm_batches as j_synthetic
from repro.engine import mesh as JM
from repro.engine.spec import ExperimentSpec as JSpec
from repro.optim import for_run as j_for_run
from repro.optim import get_optimizer as j_get_optimizer
from repro.resilience import wrap_step_sentinel as j_wrap
from repro.sharding.rules import LOCAL_CTX
from repro_torch.common import tree_leaves, tree_map
from repro_torch.data import synthetic_lm_batches
from repro_torch.engine import ExperimentSpec, Trainer
from repro_torch.engine import mesh as PM
from repro_torch.models.convert import train_state_from_jax
from repro_torch.optim import for_run, get_optimizer
from repro_torch.resilience import StepScreen, wrap_step_sentinel

torch.set_num_threads(1)

TINY = (("n_layers", 1), ("d_model", 16), ("d_ff", 32), ("vocab_size", 128),
        ("n_heads", 2), ("n_kv_heads", 2))


def _kw(**kw):
    base = dict(backend="mesh", arch="yi_9b", reduced=True, mode="ssgd",
                strategy="guided_fused", rho=3, staleness=2, lr=5e-2, seed=0,
                steps=6, seq_len=8, global_batch=4, workers=2, model_overrides=TINY)
    base.update(kw)
    return base


def _fit(**kw):
    return Trainer.from_spec(ExperimentSpec(**_kw(**kw)), device="cpu").fit()


def _step_and_state(lr=5e-2, mode="ssgd", strategy="guided_fused", optimizer="sgd"):
    spec = ExperimentSpec(**_kw(lr=lr, mode=mode, strategy=strategy, optimizer=optimizer))
    cfg, gcfg, opt = spec.model_config(), spec.to_guided_config(), get_optimizer(optimizer)
    params, gstate = PM.init_train_state(torch.Generator().manual_seed(0), cfg, gcfg, opt, 2,
                                         strategy=strategy, device="cpu")
    step = PM.build_train_step(cfg, gcfg, opt, for_run("constant", lr, 0, 6), n_workers=2,
                               strategy=strategy)
    batch = {k: torch.from_numpy(v) for k, v in
             next(synthetic_lm_batches(cfg.vocab_size, 8, 4, seed=0, n_corpora=2)).items()}
    return step, params, gstate, batch


def _tensors(params, gstate):
    """Every tensor of the train state (params, scores, losses, w_stale,
    optimizer accumulators)."""
    opt = gstate.opt_state if isinstance(gstate.opt_state, dict) else {}
    out = tree_leaves(params) + [gstate.score, gstate.prev_worker_loss, gstate.prev_avg_loss]
    if isinstance(gstate.w_stale, dict):
        out += tree_leaves(gstate.w_stale)
    return out + [x for k in sorted(opt) if k != "t" for x in tree_leaves(opt[k])]


def _clone(tensors):
    return [t.clone() for t in tensors]


def _unchanged(before, params, gstate):
    return all(torch.equal(a, b) for a, b in zip(before, _tensors(params, gstate)))


def test_mesh_sentinel_keeps_the_previous_carry_on_a_bad_step():
    """A NaN loss (a NaN loss mask) at level "finite": the step is rejected
    and the in-place step leaves params, w_stale, the momentum accumulator,
    the scores, losses and step exactly as they were; a sane step after it
    is accepted and moves the params."""
    step, params, gstate, batch = _step_and_state(mode="asgd", strategy="dc_asgd",
                                                  optimizer="momentum")
    guarded = wrap_step_sentinel(step, "finite", 10.0)
    params, gstate, m = guarded(params, gstate, batch)
    assert m["rejected"] == 0 and gstate.step == 1
    before = _clone(_tensors(params, gstate))
    bad = dict(batch, mask=torch.full(batch["labels"].shape, float("nan")))
    p2, g2, m2 = guarded(params, gstate, bad)
    assert m2["rejected"] == 1 and not torch.isfinite(m2["loss"])
    assert g2.step == 1 and g2 is gstate and p2 is params
    assert _unchanged(before, p2, g2)
    p3, g3, m3 = guarded(p2, g2, batch)
    assert m3["rejected"] == 0 and g3.step == 2
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(p3)))


def test_mesh_sentinel_full_rejects_spikes_and_bad_leaves():
    """Level "full": a loss above 10 x |prev_avg_loss| is rejected before
    anything moves; an update that leaves a leaf non-finite (lr 1e38
    overflows) is rejected with the state untouched, where "finite" commits
    it; the inf prev_avg_loss of a fresh state passes the spike test."""
    step, params, gstate, batch = _step_and_state()
    full = wrap_step_sentinel(step, "full", 10.0)
    spiky = gstate._replace(prev_avg_loss=torch.tensor(1e-3))
    before = _clone(_tensors(params, spiky))
    p, g, m = full(params, spiky, batch)
    assert m["rejected"] == 1 and _unchanged(before, p, g) and g.step == 0

    step, params, gstate, batch = _step_and_state(lr=1e38)
    before = _clone(_tensors(params, gstate))
    p, g, m = wrap_step_sentinel(step, "full", 10.0)(params, gstate, batch)
    assert m["rejected"] == 1 and _unchanged(before, p, g)
    p, g, m = wrap_step_sentinel(step, "finite", 10.0)(params, gstate, batch)
    assert m["rejected"] == 0 and g.step == 1
    assert not all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))

    screen = StepScreen("full", 10.0)
    ones = {"w": torch.ones(2)}
    assert screen.admit(torch.tensor(2.0), torch.tensor(float("inf")), ones)
    assert not screen.admit(torch.tensor(2.0), torch.tensor(1.0),
                            {"w": torch.tensor([1.0, float("nan")])})
    with pytest.raises(ValueError, match="'finite' or 'full'"):
        StepScreen("", 10.0)


@pytest.mark.parametrize("level", ["finite", "full"])
def test_mesh_sentinel_is_bit_exact_on_a_clean_run(level):
    """Arming the sentinel does not perturb a healthy trajectory: the same
    params leaf for leaf, zero rejections."""
    off = _fit()
    on = _fit(sentinel=level)
    for a, b in zip(tree_leaves(off.model), tree_leaves(on.model)):
        assert torch.equal(a, b)
    assert on.resilience == {"sentinel": level, "rejected_steps": 0}
    assert off.resilience == {}


def test_mesh_sentinel_full_keeps_params_finite_through_divergence():
    """lr=5000 on the tiny LM blows up within a few steps; at level "full"
    every poisoning step is rejected, the final params stay finite, and
    chunked dispatch gives the same count and the same params."""
    r = _fit(lr=5000.0, steps=10, sentinel="full")
    assert r.resilience["rejected_steps"] >= 1
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(r.model))
    r2 = _fit(lr=5000.0, steps=10, sentinel="full", chunk_steps=4)
    assert r2.resilience["rejected_steps"] == r.resilience["rejected_steps"]
    for a, b in zip(tree_leaves(r.model), tree_leaves(r2.model)):
        assert torch.equal(a, b)


def test_divergence_rejects_the_steps_the_reference_rejects():
    """The lr-5000 run at level "full" (the reference's divergence test) from
    the reference's initial state on the same synthetic batches, stepwise
    through both packages' sentinels: the same step indices rejected, the
    port's state finite. (At level "finite" the two part at step 1: the
    reference's jitted attention returns NaN at logits near 6e12, where its
    own op-by-op evaluation and the port give a finite loss of 6.0e6.)"""
    level = "full"
    kw = _kw(lr=5000.0, steps=10)
    js = JSpec(**kw)
    cfg, gcfg, jopt = js.model_config(), js.to_guided_config(), j_get_optimizer("sgd")
    jparams, _, jg = JM.init_train_state(jax.random.PRNGKey(0), cfg, gcfg, jopt, n_workers=2,
                                         strategy=js.strategy)
    jstep = jax.jit(j_wrap(JM.build_train_step(cfg, gcfg, jopt, LOCAL_CTX,
                                               j_for_run("constant", 5000.0, 0, 10),
                                               n_workers=2, strategy=js.strategy),
                           level, 10.0))
    ps = ExperimentSpec(**kw)
    pcfg = ps.model_config()
    params, gstate = train_state_from_jax(*jax.tree.map(np.asarray, (jparams, jg)), pcfg,
                                          device="cpu")
    pstep = wrap_step_sentinel(PM.build_train_step(pcfg, ps.to_guided_config(),
                                                   get_optimizer("sgd"),
                                                   for_run("constant", 5000.0, 0, 10),
                                                   n_workers=2, strategy=ps.strategy),
                               level, 10.0)
    jrej, prej = [], []
    stream = j_synthetic(cfg.vocab_size, 8, 4, seed=0, n_corpora=2)
    for _ in range(10):
        batch = next(stream)
        jparams, jg, jm = jstep(jparams, jg, {k: jax.numpy.asarray(v) for k, v in batch.items()})
        params, gstate, pm = pstep(params, gstate, tree_map(torch.from_numpy, dict(batch)))
        jrej.append(int(jm["rejected"]))
        prej.append(pm["rejected"])
    assert prej == jrej
    assert sum(prej) >= 1
    assert gstate.step == int(jg.step) == 10 - sum(prej)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))
