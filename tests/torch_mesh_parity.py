"""Shared by the mesh parity tests (tests/test_torch_mesh*.py): run the JAX
package's mesh train step and the port's from one state on the same
batches, and collect what each step reports.

The reference's state comes from its own `init_train_state` (jax.random);
`repro_torch.models.convert.train_state_from_jax` carries it into the port,
so both start from one state. Both run in float32 on the CPU (the reduced
yi-9b: 2 layers, d_model 256, f32 params); the JAX step is jitted, the
port's runs eagerly on the plain versions of the kernels.
"""
import jax
import numpy as np
import torch

from repro.data import make_batch_for
from repro.engine import mesh as JM
from repro.engine.spec import ExperimentSpec as JSpec
from repro.optim import for_run as j_for_run
from repro.optim import get_optimizer as j_get_optimizer
from repro.sharding.rules import LOCAL_CTX
from repro_torch.common import tree_leaves
from repro_torch.engine import mesh as PM
from repro_torch.engine.spec import ExperimentSpec as PSpec
from repro_torch.models.convert import train_state_from_jax
from repro_torch.optim import for_run as p_for_run
from repro_torch.optim import get_optimizer as p_get_optimizer

METRICS = ("loss", "worker_loss_var", "corr_weight_sum")


def spec_kw(strategy, mode, optimizer, **kw):
    base = dict(backend="mesh", arch="yi_9b", reduced=True, mode=mode, strategy=strategy,
                optimizer=optimizer, rho=2, lr=1e-2, seed=3, steps=5, seq_len=16,
                global_batch=4, workers=2, schedule="constant")
    base.update(kw)
    return base


def jax_state(spec_kw_, c=2):
    """The reference's initial (params, gstate), and the same as numpy."""
    js = JSpec(**spec_kw_)
    cfg, gcfg, opt = js.model_config(), js.to_guided_config(), j_get_optimizer(js.optimizer)
    params, _, gstate = JM.init_train_state(jax.random.PRNGKey(js.seed), cfg, gcfg, opt,
                                            n_workers=c, strategy=js.strategy)
    return (params, gstate), jax.tree.map(np.asarray, (params, gstate))


def batches(cfg, spec_kw_):
    """One make_batch_for batch, fed at every step: trained on a fixed batch
    the worker and average losses fall together, so workers score as
    consistent and the guided correction fires at window ends (on fresh
    uniform-token batches the loss moves with the batch, not the steps)."""
    b = make_batch_for(cfg, spec_kw_["seq_len"], spec_kw_["global_batch"], seed=0)
    return [b] * spec_kw_["steps"]


def run_jax(spec_kw_, state, data, c=2):
    js = JSpec(**spec_kw_)
    cfg, gcfg, opt = js.model_config(), js.to_guided_config(), j_get_optimizer(js.optimizer)
    lr = j_for_run(js.schedule, js.lr, js.warmup, js.steps)
    step = jax.jit(JM.build_train_step(cfg, gcfg, opt, LOCAL_CTX, lr, n_micro=js.micro,
                                       n_workers=c, strategy=js.strategy))
    params, gstate = state
    hist = []
    for b in data:
        params, gstate, m = step(params, gstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
        hist.append({k: float(m[k]) for k in METRICS})
    return hist, jax.tree.map(np.asarray, (params, gstate))


def run_port(spec_kw_, state_np, data, c=2):
    ps = PSpec(**spec_kw_)
    cfg, gcfg, opt = ps.model_config(), ps.to_guided_config(), p_get_optimizer(ps.optimizer)
    lr = p_for_run(ps.schedule, ps.lr, ps.warmup, ps.steps)
    PM.build_ctx(ps.mesh)
    step = PM.build_train_step(cfg, gcfg, opt, lr, n_micro=ps.micro, n_workers=c,
                               strategy=ps.strategy)
    params, gstate = train_state_from_jax(*state_np, cfg, device="cpu")
    hist = []
    for b in data:
        params, gstate, m = step(params, gstate, {k: torch.from_numpy(v) for k, v in b.items()})
        hist.append({k: float(m[k]) for k in METRICS})
    return hist, (params, gstate)


def leaves_np(tree):
    """Port tree -> numpy leaves, in the port's (dict insertion) order."""
    return [t.detach().numpy() for t in tree_leaves(tree)]


def jax_leaves_like(jtree, ptree):
    """The reference's numpy tree's leaves, in the port tree's key order."""
    if isinstance(ptree, dict):
        return [leaf for k in ptree for leaf in jax_leaves_like(jtree[k], ptree[k])]
    return [np.asarray(jtree)]


def compare(spec_kw_, atol=1e-5, param_outliers=0.0, param_cap=None):
    """Run both packages from one state; hold every step's metrics and the
    final params and w_stale to `atol`. `param_outliers` is the share of
    param elements allowed past atol (each still within `param_cap`), for
    the adaptive optimizers (see test_torch_mesh_optimizers.py). Returns the
    reference's history."""
    jstate, npstate = jax_state(spec_kw_)
    data = batches(JSpec(**spec_kw_).model_config(), spec_kw_)
    jh, (jp, jg) = run_jax(spec_kw_, jstate, data)
    ph, (pp, pg) = run_port(spec_kw_, npstate, data)
    for i, (a, b) in enumerate(zip(jh, ph)):
        for k in METRICS:
            assert abs(a[k] - b[k]) <= atol, (i, k, a[k], b[k])
    pairs = list(zip(leaves_np(pp), jax_leaves_like(jp, pp)))
    if isinstance(jg.w_stale, dict):
        pairs += list(zip(leaves_np(pg.w_stale), jax_leaves_like(jg.w_stale, pg.w_stale)))
    else:
        assert pg.w_stale == ()
    n_off = sum(int((np.abs(a - b) > atol).sum()) for a, b in pairs)
    n_all = sum(a.size for a, _ in pairs)
    assert n_off <= param_outliers * n_all, (n_off, n_all)
    cap = atol if param_cap is None else param_cap
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=cap)
    assert pg.step == int(jg.step) == spec_kw_["steps"]
    np.testing.assert_allclose(pg.score.numpy(), np.asarray(jg.score), rtol=0, atol=atol)
    return jh
