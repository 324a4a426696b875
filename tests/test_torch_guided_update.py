"""repro_torch.kernels.guided_update against repro.kernels.guided_update.

On the CPU the port's wrappers run their plain versions (`ref.py`); these are
held against the JAX package's pure-jnp refs and its Pallas kernels in
interpret mode, on the same numpy inputs. Bars are the reference's own
(tests/test_kernels.py, DESIGN.md §11): 1e-6 in float32, 1e-12 in float64.
Float64 JAX runs inside `jax.enable_x64(True)` blocks only: the session's
x64 setting is never changed.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.guided_update import kernel as JK
from repro.kernels.guided_update import ops as JOPS
from repro.kernels.guided_update import ref as JR
from repro_torch.kernels.guided_update import ops
from repro_torch.kernels.guided_update import ref as R

torch.set_num_threads(1)

N = 37 * 129     # odd: the Pallas wrapper pads, the port masks nothing on the CPU
BARS = {"float32": 1e-6, "float64": 1e-12}
CASES = ["sgd", "momentum", "momentum_nesterov", "rmsprop", "adam_t1", "adam_t10"]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(N)
    return dict(w=w, g=0.01 * rng.standard_normal(N), ws=w + 0.05 * rng.standard_normal(N),
                m=np.abs(rng.standard_normal(N)) * 0.1, v=np.abs(rng.standard_normal(N)) * 0.05,
                r=np.abs(rng.standard_normal(N)) * 0.2)


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _port(case, a, lam):
    """The port's wrapper on CPU tensors (runs ref.py)."""
    w, g, ws, m, v, r = (a[k] for k in ("w", "g", "ws", "m", "v", "r"))
    if case == "sgd":
        return (ops.guided_sgd_update_raw(w, g, ws, 0.2, lam),)
    if case.startswith("momentum"):
        return ops.guided_momentum_update_raw(w, g, ws, m, 0.2, lam, 0.9,
                                              nesterov=case.endswith("nesterov"))
    if case == "rmsprop":
        return ops.guided_rmsprop_update_raw(w, g, ws, r, 0.2, lam, 0.9, 1e-8)
    t = int(case.split("_t")[1])
    return ops.guided_adam_update_raw(w, g, ws, m, v, t, 0.2, lam, 0.9, 0.999, 1e-8)


def _jax(case, a, lam, impl):
    """The JAX package's jnp ref (impl="ref") or Pallas kernel in interpret
    mode (impl="pallas") on the same inputs."""
    w, g, ws, m, v, r = (a[k] for k in ("w", "g", "ws", "m", "v", "r"))
    kw = dict(block=512, interpret=True) if impl == "pallas" else {}
    mod = JK if impl == "pallas" else JR
    sfx = "_raw" if impl == "pallas" else "_ref"
    if case == "sgd":
        return (getattr(mod, "guided_sgd_update" + sfx)(w, g, ws, 0.2, lam, **kw),)
    if case.startswith("momentum"):
        return getattr(mod, "guided_momentum_update" + sfx)(
            w, g, ws, m, 0.2, lam, 0.9, nesterov=case.endswith("nesterov"), **kw)
    if case == "rmsprop":
        return getattr(mod, "guided_rmsprop_update" + sfx)(w, g, ws, r, 0.2, lam, 0.9, 1e-8,
                                                            **kw)
    t = int(case.split("_t")[1])
    return getattr(mod, "guided_adam_update" + sfx)(w, g, ws, m, v, t, 0.2, lam, 0.9, 0.999,
                                                     1e-8, **kw)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("lam", [0.0, 0.04])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_guided_update(case, dtype, lam, impl):
    a = _inputs(2 * CASES.index(case) + (dtype == "float64"))
    n0 = dict(ops.launches)
    port = _port(case, {k: torch.from_numpy(x.astype(dtype)) for k, x in a.items()}, lam)
    assert ops.launches == n0  # CPU tensors: the plain version, no launch
    with _x64(dtype):
        want = _jax(case, {k: jnp.asarray(x.astype(dtype)) for k, x in a.items()}, lam, impl)
        want = [np.asarray(x) for x in want]
    assert len(port) == len(want)
    for p, j in zip(port, want):
        assert str(p.dtype).replace("torch.", "") == str(j.dtype) == dtype
        np.testing.assert_allclose(p.numpy(), j, atol=BARS[dtype], rtol=0)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "rmsprop", "adam"])
def test_fused_update_for_routes_to_the_same_update(optimizer):
    """The uniform f(w, g, ws, acc, t, lr, lam) seam equals the JAX package's
    fused_update_for (impl="ref") in float64."""
    a = _inputs(3)
    acc_keys = {"sgd": (), "momentum": ("m",), "rmsprop": ("r",), "adam": ("m", "v")}[optimizer]
    f = ops.fused_update_for(optimizer, beta=0.9, eps=1e-8)
    assert f.optimizer == optimizer
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    w2, acc2 = f(t["w"], t["g"], t["ws"], tuple(t[k] for k in acc_keys), 4, 0.2, 0.04)
    assert len(acc2) == ops.FUSED_ACC_ARITY[optimizer]
    with jax.enable_x64(True):
        jf = JOPS.fused_update_for(optimizer, beta=0.9, eps=1e-8, impl="ref")
        j = {k: jnp.asarray(x) for k, x in a.items()}
        jw2, jacc2 = jf(j["w"], j["g"], j["ws"], tuple(j[k] for k in acc_keys), 4, 0.2, 0.04)
        jw2, jacc2 = np.asarray(jw2), [np.asarray(x) for x in jacc2]
    np.testing.assert_allclose(w2.numpy(), jw2, atol=1e-12, rtol=0)
    for p, q in zip(acc2, jacc2):
        np.testing.assert_allclose(p.numpy(), q, atol=1e-12, rtol=0)


def test_fused_tables_equal_the_reference():
    assert ops.FUSED_OPTIMIZERS == JOPS.FUSED_OPTIMIZERS
    assert ops.FUSED_ACC_ARITY == JOPS.FUSED_ACC_ARITY
    with pytest.raises(KeyError, match="adagrad"):
        ops.fused_update_for("adagrad")


def test_bf16_weights_compute_in_f32_and_keep_their_dtype():
    """bf16 weights: f32 compute, weights back in bf16, accumulators in f32,
    as the reference's compute-dtype rule gives; equal to the JAX ref."""
    a = _inputs(5)
    tb = {k: torch.from_numpy(x.astype(np.float32)) for k, x in a.items()}
    w, g, ws = (tb[k].to(torch.bfloat16) for k in ("w", "g", "ws"))
    w2, r2 = R.guided_rmsprop_update_ref(w, g, ws, tb["r"], 0.2, 0.04, 0.9, 1e-8)
    assert w2.dtype == torch.bfloat16 and r2.dtype == torch.float32
    jw, jg, jws = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (w, g, ws))
    jw2, jr2 = JR.guided_rmsprop_update_ref(jw, jg, jws, jnp.asarray(tb["r"].numpy()), 0.2, 0.04,
                                            0.9, 1e-8)
    np.testing.assert_array_equal(w2.float().numpy(), np.asarray(jw2.astype(jnp.float32)))
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-6, rtol=0)


def test_mixed_devices_are_refused():
    w = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="must all be on cuda or all on cpu"):
        ops.guided_sgd_update_raw(w, w, torch.zeros(8, dtype=torch.float64, device="meta"),
                                  0.1, 0.0)
