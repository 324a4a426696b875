"""repro_torch's xLSTM blocks (mLSTM, sLSTM) against the reference.

Reduced xlstm-350m (`.reduced()`: 2 layers, mLSTM then sLSTM, d_model 256,
4 heads; mLSTM inner width 512, sLSTM feed-forward 341), float32. Each
block's parameters come from the reference's init as numpy. Outputs and
every state leaf agree to atol 1e-4 (f32, the exact stabilised recurrences
on both sides; the measured gap is about 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.models.module import split_params
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

torch.set_num_threads(1)

ATOL = 1e-4
ARCH = "xlstm_350m"
KINDS = {"mlstm": (JX.mlstm_init, JX.mlstm_apply, X.mlstm_apply),
         "slstm": (JX.slstm_init, JX.slstm_apply, X.slstm_apply)}


def _configs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _block(kind, seed):
    jcfg, cfg = _configs()
    jp = split_params(KINDS[kind][0](jax.random.PRNGKey(seed), jcfg))[0]
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, cfg, p


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0, **kw)


def _close_state(st, jst):
    conv, inner = st
    jconv, jinner = jst
    _close(conv, jconv)
    assert len(inner) == len(jinner)
    for a, b in zip(inner, jinner):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_whole_sequence_matches_jax(kind):
    jcfg, jp, cfg, p = _block(kind, 1)
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jy, jst = KINDS[kind][1](jp, jnp.asarray(x), jcfg)
    y, st = KINDS[kind][2](p, torch.from_numpy(x), cfg)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    _close(y, jy)
    _close_state(st, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_then_single_steps_match_jax(kind):
    """A 9-token call from the initial state, then 5 one-token calls, each
    carrying the previous call's states; outputs and states every step."""
    jcfg, jp, cfg, p = _block(kind, 3)
    x = np.random.default_rng(4).standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    jy, jst = KINDS[kind][1](jp, jnp.asarray(x[:, :9]), jcfg)
    y, st = KINDS[kind][2](p, torch.from_numpy(x[:, :9]), cfg)
    _close(y, jy)
    _close_state(st, jst)
    for t in range(9, 14):
        jy, jst = KINDS[kind][1](jp, jnp.asarray(x[:, t:t + 1]), jcfg, jst)
        y, st = KINDS[kind][2](p, torch.from_numpy(x[:, t:t + 1]), cfg, st)
        _close(y, jy, err_msg=f"{kind} step {t}")
        _close_state(st, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_initial_states_are_the_references(kind):
    """m starts at -1e30 and sLSTM's n at 1, not at zero; the conv state in
    the given dtype, the rest f32."""
    jcfg, cfg = _configs()
    init = {"mlstm": (JX.mlstm_state_init, X.mlstm_state_init),
            "slstm": (JX.slstm_state_init, X.slstm_state_init)}[kind]
    jconv, jinner = init[0](jcfg, 3, jnp.bfloat16)
    conv, inner = init[1](cfg, 3, torch.bfloat16)
    assert conv.dtype == torch.bfloat16 and tuple(conv.shape) == jconv.shape
    assert not bool(conv.any())
    for a, b in zip(inner, jinner):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("reduced", [False, True])
def test_xlstm_block_structure_equals_the_reference(reduced):
    """Period, layer kinds and every param leaf's path, shape and dtype
    (the config itself: test_torch_imports.py)."""
    ref, port = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert (T.period(port), T.n_super(port)) == (JT.period(ref), JT.n_super(ref)) == (2, port.n_layers // 2)
    for i in range(T.period(port)):
        assert T.mixer_kind(port, i) == JT.mixer_kind(ref, i)
        assert T.ffn_kind(port, i) is JT.ffn_kind(ref, i) is None
    shapes = jax.eval_shape(lambda: split_params(JT.model_init(jax.random.PRNGKey(0), ref))[0])
    params = T.model_init(None, port, device="meta")
    flat_ref = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    flat = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    assert flat == flat_ref
    # the f32 leaves of a bf16 model stay f32
    if not reduced:
        for kind, names in (("l0", ("w_if", "b_if")), ("l1", ("r_gates", "b_gates"))):
            for n in names:
                assert params["blocks"][kind]["mixer"][n].dtype == torch.float32
        assert params["blocks"]["l0"]["mixer"]["w_up"].dtype == torch.bfloat16
