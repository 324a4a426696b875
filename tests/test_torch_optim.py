"""The port's copies of the optimizers, schedules and the guided
bookkeeping against the JAX package's on the same numpy state, and the
fused guided update's tree form and in-place contract (on the CPU, where
the kernels' wrappers run their plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consistency as JC
from repro.core import guided as JG
from repro.kernels.guided_update import ops as JOPS
from repro.optim import for_run as j_for_run
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import kernels
from repro_torch.common import tree_add, tree_leaves, tree_map
from repro_torch.core import consistency as PC
from repro_torch.core import guided as PG
from repro_torch.kernels.guided_update import ops as POPS
from repro_torch.optim import for_run as p_for_run
from repro_torch.optim import get_optimizer as p_get_optimizer


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((7, 9))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(33)).astype(np.float32)}}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return [np.asarray(x) for x in tree_leaves(tree)] if isinstance(tree, dict) else \
        [np.asarray(tree)]


def _j(tree):
    return {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(tree["b"]["c"])}}


def _jleaves(tree):
    return [np.asarray(tree["a"]), np.asarray(tree["b"]["c"])]


OPTS = [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}), ("rmsprop", {}),
        ("adagrad", {}), ("adam", {}), ("adam", {"weight_decay": 0.01})]


@pytest.mark.parametrize("name,hy", OPTS, ids=lambda v: str(v))
def test_optimizer_equals_the_reference(name, hy):
    """Three updates from one numpy state: updates and state within one f32
    rounding of the weights' size (XLA may fuse a multiply-add where torch
    rounds twice)."""
    rng = np.random.default_rng(1)
    w = _tree(rng)
    jopt, popt = j_get_optimizer(name, **hy), p_get_optimizer(name, **hy)
    assert popt.name == jopt.name and popt.hypers == jopt.hypers
    jst, pst = jopt.init(_j(w)), popt.init(_t(w))
    for i in range(3):
        g = _tree(rng, 0.01)
        lr = 0.2 / (i + 1)
        jupd, jst = jopt.update(_j(g), jst, _j(w), jnp.asarray(lr, jnp.float32))
        pupd, pst = popt.update(_t(g), pst, _t(w), float(np.float32(lr)))
        for a, b in zip(_np(pupd), _jleaves(jupd)):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    if isinstance(jst, dict):
        for k in jst:
            if k == "t":
                assert pst["t"] == int(jst["t"]) == 3
            else:
                for a, b in zip(_np(pst[k]), _jleaves(jst[k])):
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,warmup,n", [("constant", 10, 30), ("cosine", 5, 40),
                                           ("wsd", 4, 30), ("wsd", 1, 5), ("cosine", 0, 7)])
def test_schedule_equals_the_reference(name, warmup, n):
    """The float32 value of every step: bit-equal for the constant schedule;
    within 1e-6 relative where numpy's float32 cos / power stand in for
    XLA's, whose results differ from them by an ulp or two."""
    j, p = j_for_run(name, 0.3, warmup, n), p_for_run(name, 0.3, warmup, n)
    for step in range(n + 2):
        a, b = p(step), float(j(jnp.asarray(step, jnp.int32)))
        assert isinstance(a, float) and a == float(np.float32(a))
        if name == "constant":
            assert a == b
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=str(step))


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        p_for_run("linear", 0.1, 0, 10)


# ------------------------------------------------ fused update, tree form


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_fused_update_at_lambda_zero_is_the_optimizer_bit_for_bit(name):
    """At lam = 0 the fused whole update (the mesh's one launch per leaf)
    equals opt.update + tree_add bit for bit in float32, as in the
    reference: the same operations, rounded at the same points."""
    rng = np.random.default_rng(2)
    w, g = _t(_tree(rng)), _t(_tree(rng, 0.01))
    opt = p_get_optimizer(name)
    st = opt.init(w)
    if name != "sgd":
        st = {**st, **{k: tree_map(lambda x: x.abs() * 0.1 + 0.01, st[k])
                       for k in st if k != "t"}}
    upd, st_r = opt.update(g, st, w, 0.2)
    want = tree_add(w, upd)
    hy = {k: v for k, v in opt.hypers.items() if k != "weight_decay"}
    fused = POPS.fused_update_for(name, **hy)
    st_copy = {k: v if k == "t" else tree_map(torch.clone, v) for k, v in st.items()} \
        if st else ()
    got_w, st_f = POPS.tree_fused_update(fused, name, tree_map(torch.clone, w), g, w,
                                         st_copy, 0.2, 0.0)
    for a, b in zip(tree_leaves(got_w), tree_leaves(want)):
        assert torch.equal(a, b)
    for k in st_r:
        if k == "t":
            assert st_f["t"] == st_r["t"] == 1
        else:
            for a, b in zip(tree_leaves(st_f[k]), tree_leaves(st_r[k])):
                assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["sgd", "momentum", "rmsprop", "adam"])
def test_tree_fused_update_equals_the_reference(name):
    """The port's tree_fused_update (in place) against the reference's, with
    DC-ASGD's lam = 0.04: the same plain arithmetic, f32, within 1e-6 as
    the reference's own kernel tests hold it."""
    rng = np.random.default_rng(3)
    w, g, ws = _tree(rng), _tree(rng, 0.01), _tree(rng)
    jopt = j_get_optimizer(name)
    hy = dict(jopt.hypers)
    hy.pop("weight_decay", None)
    jst = jopt.init(_j(w))
    pst = p_get_optimizer(name).init(_t(w))
    if name == "adam":
        jst = {**jst, "t": jnp.asarray(4, jnp.int32)}
        pst = {**pst, "t": 4}
    jw, jst2 = JOPS.tree_fused_update(JOPS.fused_update_for(name, impl="ref", **hy), name,
                                      _j(w), _j(g), _j(ws), jst, 0.2, 0.04)
    pw = _t(w)
    ids = [id(x) for x in tree_leaves(pw)]
    pw2, pst2 = POPS.tree_fused_update(POPS.fused_update_for(name, **hy), name, pw, _t(g),
                                       _t(ws), pst, 0.2, 0.04)
    assert [id(x) for x in tree_leaves(pw2)] == ids  # in place: the same tensors
    for a, b in zip(_np(pw2), _jleaves(jw)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for k in jst2:
        if k == "t":
            assert pst2["t"] == int(jst2["t"]) == 5
        else:
            for a, b in zip(_np(pst2[k]), _jleaves(jst2[k])):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_out_argument_writes_in_place(dtype):
    """out= (the inputs themselves included) gives the fresh-output result."""
    ct = torch.promote_types(dtype, torch.float32)
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(300, generator=gen, dtype=ct).to(dtype)
    g = (0.01 * torch.randn(300, generator=gen, dtype=ct)).to(dtype)
    m, v = torch.rand(300, generator=gen, dtype=ct), torch.rand(300, generator=gen, dtype=ct)
    fresh = POPS.guided_adam_update_raw(w, g, w, m, v, 3, 0.1, 0.04, 0.9, 0.999, 1e-8)
    w2, m2, v2 = w.clone(), m.clone(), v.clone()
    out = POPS.guided_adam_update_raw(w2, g, w2, m2, v2, 3, 0.1, 0.04, 0.9, 0.999, 1e-8,
                                      out=(w2, m2, v2))
    assert out[0] is w2 and out[1] is m2 and out[2] is v2
    for a, b in zip(out, fresh):
        assert torch.equal(a, b)
    s = POPS.guided_sgd_update_raw(w, g, w, 0.1, 0.0)
    w3 = w.clone()
    assert POPS.guided_sgd_update_raw(w3, g, w3, 0.1, 0.0, out=w3) is w3
    assert torch.equal(w3, s)
    with pytest.raises(ValueError, match="out must be"):
        POPS._outputs(torch.empty(5, dtype=dtype), (w,))


def test_refuse_autograd_raises_for_tensors_that_require_grad():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3)
    with pytest.raises(RuntimeError, match="guided_sgd_update: the CUDA kernel has no backward"):
        kernels.refuse_autograd("guided_sgd_update", b, a)
    kernels.refuse_autograd("guided_sgd_update", b, b)      # nothing requires grad
    with torch.no_grad():
        kernels.refuse_autograd("guided_sgd_update", a, b)  # grad mode off


# ----------------------------------------------------- guided bookkeeping


def test_consistency_increment_equals_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        wl, pwl = rng.uniform(0, 3, 6).astype(np.float32), rng.uniform(0, 3, 6).astype(np.float32)
        al, pal = np.float32(rng.uniform(0, 3)), np.float32(rng.uniform(0, 3))
        a = PC.consistency_increment(*map(torch.tensor, (wl, pwl, al, pal)), 0.1)
        b = JC.consistency_increment(*map(jnp.asarray, (wl, pwl, al, pal)), 0.1)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# score vectors: ties (lowest index wins), zeros, k < c, and falsifying
# examples of the 1e-9 clamp, whose weights do not sum to 1 in the reference
SCORES = [[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0, 1.0], [0.5, 2.0, 0.0, 2.0, 1.1, 0.3],
          [0.0, 0.0, 1e-12], [1e-10, 3e-10, 0.0, 2e-10], [0.0, 2.2, 1.05, 1.1]]


@pytest.mark.parametrize("score", SCORES, ids=str)
@pytest.mark.parametrize("max_consistent", [2, 4])
def test_correction_weights_equal_the_reference(score, max_consistent):
    s = np.asarray(score, np.float32)
    gp = PG.GuidedConfig(max_consistent=max_consistent)
    gj = JG.GuidedConfig(max_consistent=max_consistent)
    a = PG.correction_weights(torch.from_numpy(s), gp).numpy()
    b = np.asarray(JG.correction_weights(jnp.asarray(s), gj))
    np.testing.assert_array_equal(a, b)
    if score == [0.0, 0.0, 1e-12]:
        assert 0 < a.sum() < 1e-2  # the clamp: not normalized, as in the reference


def _jstate(step, score, pwl, pal):
    return JG.GuidedState(step=jnp.asarray(step, jnp.int32), score=jnp.asarray(score),
                          prev_worker_loss=jnp.asarray(pwl), prev_avg_loss=jnp.asarray(pal),
                          w_stale=(), opt_state=())


def _pstate(step, score, pwl, pal, w_stale=()):
    return PG.GuidedState(step=step, score=torch.tensor(score), prev_worker_loss=torch.tensor(pwl),
                          prev_avg_loss=torch.tensor(pal), w_stale=w_stale, opt_state=())


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 5])
def test_advance_and_window_equal_the_reference(step):
    """update_scores, the window-end reset, is_window_end and the stale
    refresh (rho 3, staleness 2), from +inf and from finite previous losses."""
    gj = JG.GuidedConfig(mode="asgd", rho=3, staleness=2)
    gp = PG.GuidedConfig(mode="asgd", rho=3, staleness=2)
    assert PG.is_window_end(step, gp) == bool(JG.is_window_end(jnp.asarray(step), gj))
    rng = np.random.default_rng(step)
    score = rng.uniform(0, 2, 4).astype(np.float32)
    wl = rng.uniform(0, 3, 4).astype(np.float32)
    al = np.float32(wl.mean())
    for pwl, pal in ((np.full(4, np.inf, np.float32), np.float32(np.inf)),
                     (rng.uniform(0, 3, 4).astype(np.float32), np.float32(1.7))):
        params = {"w": torch.tensor(rng.standard_normal(5).astype(np.float32))}
        w_stale = {"w": torch.zeros(5)}
        js = _jstate(step, score, pwl, pal)._replace(w_stale={"w": jnp.zeros(5)})
        ps = _pstate(step, score, pwl, pal, w_stale)
        jn = JG.advance(js, gj, (), {"w": jnp.asarray(params["w"].numpy())},
                        jnp.asarray(wl), jnp.asarray(al))
        pn = PG.advance(ps, gp, (), params, torch.tensor(wl), torch.tensor(al))
        assert pn.step == int(jn.step) == step + 1
        np.testing.assert_array_equal(pn.score.numpy(), np.asarray(jn.score))
        np.testing.assert_array_equal(pn.w_stale["w"].numpy(), np.asarray(jn.w_stale["w"]))
        assert pn.w_stale["w"] is w_stale["w"]  # refreshed in place, or left alone
        np.testing.assert_array_equal(pn.prev_worker_loss.numpy(), wl)


def test_guided_init_equals_the_reference():
    gp, gj = PG.GuidedConfig(mode="asgd"), JG.GuidedConfig(mode="asgd")
    w = {"a": np.ones((2, 3), np.float32)}
    ps = PG.guided_init(gp, _t(w), p_get_optimizer("adam"), 3)
    js = JG.guided_init(gj, {"a": jnp.asarray(w["a"])}, j_get_optimizer("adam"), 3)
    assert ps.step == int(js.step) == 0
    for f in ("score", "prev_worker_loss", "prev_avg_loss"):
        a, b = getattr(ps, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ps.w_stale["a"] is not None and torch.equal(ps.w_stale["a"], torch.ones(2, 3))
    assert ps.opt_state["t"] == 0 and ps.opt_state["m"]["a"].dtype == torch.float32
