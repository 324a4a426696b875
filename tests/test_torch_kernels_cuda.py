"""The hand-written CUDA kernels on the card, against their plain versions:
flash_attention (its tensor-core and SIMT kernels), flash_decode, the four
guided-update kernels (in place too, at a full-width yi-9b leaf) and the
selective scan; every wrapper's refusal of inputs that require grad; a short
scan-trainer fit, a short mesh-trainer fit and a short replay fit of the
async parameter server on the card against the same fits on the CPU; and
the reduced hybrid (jamba) stack through its kernels.

The `cuda` fixture skips them without an NVIDIA GPU (the kernels have no
CPU mode). This file imports no JAX, so it runs on a card machine without the
reference installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_ref

F32_ATOL = 3e-5
BF16_ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(1000, 0), (1000, 256), (130, 0)])
def test_flash_attention_kernel_on_card(cuda, dtype, S, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, S, 32, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, S, 4, 128, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, S, 4, 128, generator=g, device=cuda).to(dtype)
    n0 = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    ref = attention_ref(q, k, v, causal=True, window=window)
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (out.float() - ref).abs().max().item() <= atol


# bf16 prefill shapes for the tensor-core kernel: ragged S around its 64-row
# warpgroup tiles and 128-row kv tiles, windows only where S > window
WGMMA_CASES = [(S, w) for S in (1, 63, 64, 65, 130, 1000, 2048, 2049)
               for w in (0, 256, 1024) if w == 0 or S > w]


def _attention_inputs(cuda, S, H, K, dh, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(1, S, n, dh, generator=g, device=cuda).to(dtype) for n in (H, K, K)]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("H,K", [(32, 4), (64, 8)])
@pytest.mark.parametrize("S,window", WGMMA_CASES)
def test_flash_attention_wgmma_kernel_on_card(cuda, S, window, H, K, dh):
    q, k, v = _attention_inputs(cuda, S, H, K, dh, torch.bfloat16, seed=S + window)
    n0, w0 = fa_ops.launches, dict(fa_ops.launches_by_variant)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    assert fa_ops.launches_by_variant == {"wgmma": w0["wgmma"] + 1, "simt": w0["simt"]}
    ref = attention_ref(q, k, v, causal=True, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S,causal,window", [(300, True, 0), (1000, False, 0), (777, True, 128)])
def test_flash_attention_wgmma_unmasked_and_narrow_windows_on_card(cuda, dh, S, causal, window):
    """Without the causal mask, and with a window narrower than a kv tile."""
    q, k, v = _attention_inputs(cuda, S, 8, 2, dh, torch.bfloat16, seed=S)
    w0 = fa_ops.launches_by_variant["wgmma"]
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_variant["wgmma"] == w0 + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert (out.float() - ref).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64), (torch.float32, 128),
                                      (torch.bfloat16, 32)])
def test_flash_attention_simt_kernel_serves_f32_and_d_head_32(cuda, dtype, dh):
    q, k, v = _attention_inputs(cuda, 200, 4, 2, dh, dtype)
    w0 = dict(fa_ops.launches_by_variant)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_variant == {"wgmma": w0["wgmma"], "simt": w0["simt"] + 1}
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (out.float() - attention_ref(q, k, v, causal=True)).abs().max().item() <= atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1280, 333, 8192])
def test_flash_decode_kernel_on_card(cuda, dtype, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(8, 1, 32, 128, generator=g, device=cuda).to(dtype)
    kc = torch.randn(8, S, 4, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(8, S, 4, 128, generator=g, device=cuda).to(dtype)
    lens = torch.randint(1, 2 * S, (8,), generator=g, device=cuda, dtype=torch.int32)
    lens[0], lens[1] = S, 1
    n0 = fd_ops.launches
    out = fd_ops.flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert fd_ops.launches == n0 + 1
    ref = decode_ref(q, kc, vc, lens)
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.parametrize("H,K,dh", [(8, 8, 32), (4, 1, 64), (8, 2, 128)])
def test_flash_decode_kernel_on_card_other_groups(cuda, H, K, dh):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(3, 1, H, dh, generator=g, device=cuda)
    kc = torch.randn(3, 300, K, dh, generator=g, device=cuda)
    vc = torch.randn(3, 300, K, dh, generator=g, device=cuda)
    lens = torch.tensor([1, 299, 1000], dtype=torch.int32, device=cuda)
    out = fd_ops.flash_decode(q, kc, vc, lens)
    assert (out - decode_ref(q, kc, vc, lens)).abs().max().item() <= F32_ATOL


def _decode_inputs(cuda, B, S, H, K, dh, dtype, lens, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, 1, H, dh, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, S, K, dh, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, S, K, dh, generator=g, device=cuda).to(dtype)
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32, device=cuda)


def _decode_close(out, q, kc, vc, cl, atol):
    """Rows with a valid slot against decode_ref; rows with none give 0 (the
    kernel's num / max(den, 1e-30); decode_ref's uniform softmax differs there)."""
    ref = decode_ref(q, kc, vc, cl)
    empty = cl == 0
    assert bool((out[empty] == 0).all())
    if (~empty).any():
        assert (out.float() - ref)[~empty].abs().max().item() <= atol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lens", [
    [0, 2100, 1500, 900, 180, 2048, 1337, 640],        # a row with no valid slot
    [5000, 2112, 2113, 4224, 1, 2, 3, 64],             # cache_len > S: the ring has wrapped
    [1, 5, 17, 31, 32, 33, 63, 7],                     # every row shorter than one tile
    [2100], [0], [4 * 2112 + 9],                       # B = 1
])
def test_flash_decode_edge_rows_on_card(cuda, dtype, lens):
    q, kc, vc, cl = _decode_inputs(cuda, len(lens), 2112, 32, 4, 128, dtype, lens)
    out = fd_ops.flash_decode(q, kc, vc, cl)
    torch.cuda.synchronize()
    _decode_close(out, q, kc, vc, cl, BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL)


@pytest.mark.parametrize("H,K", [(32, 4), (64, 8), (48, 1)])
def test_flash_decode_is_deterministic_and_resets_its_counters(cuda, H, K):
    """Two calls give the same bits (the merge runs in split order, whichever
    CTA finishes last); back-to-back calls on one stream, with no sync between,
    both come out right, and the kernel leaves its arrival counters at zero."""
    lens = [2100, 1500, 900, 180, 2048, 1337, 640, 1030]
    q, kc, vc, cl = _decode_inputs(cuda, 8, 2112, H, K, 128, torch.bfloat16, lens)
    outs = [fd_ops.flash_decode(q, kc, vc, cl) for _ in range(4)]
    q2, kc2, vc2, cl2 = _decode_inputs(cuda, 8, 2112, H, K, 128, torch.bfloat16, lens[::-1], 3)
    other = fd_ops.flash_decode(q2, kc2, vc2, cl2)
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _decode_close(outs[-1], q, kc, vc, cl, BF16_ATOL)
    _decode_close(other, q2, kc2, vc2, cl2, BF16_ATOL)
    for buf in fd_ops._COUNTERS.values():
        assert int(buf.abs().sum().item()) == 0


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2), (32, 4)])
def test_flash_decode_bf16_group_sizes_on_card(cuda, dh, H, K):
    q, kc, vc, cl = _decode_inputs(cuda, 3, 300, H, K, dh, torch.bfloat16, [1, 299, 1000])
    _decode_close(fd_ops.flash_decode(q, kc, vc, cl), q, kc, vc, cl, BF16_ATOL)


# Group sizes past one chunk of 8 heads: granite-20b's multi-query attention
# (48 query heads on one kv head of 128), minicpm-2b's 36 heads of 64 with no
# grouping, and chunk counts that leave a partial last chunk (12, 20).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,K,dh", [(48, 1, 128), (36, 36, 64), (16, 1, 64), (12, 1, 128),
                                    (40, 2, 64), (32, 1, 32)])
@pytest.mark.parametrize("lens", [
    [2100, 1500, 0, 180, 2048, 1337, 640, 4 * 2112 + 9],  # ragged, an empty row, a wrapped ring
    [1, 63, 64, 65, 2112, 2, 700, 1999],
])
def test_flash_decode_any_group_size_on_card(cuda, dtype, H, K, dh, lens):
    q, kc, vc, cl = _decode_inputs(cuda, len(lens), 2112, H, K, dh, dtype, lens, seed=H + dh)
    n0 = fd_ops.launches
    out = fd_ops.flash_decode(q, kc, vc, cl)
    torch.cuda.synchronize()
    assert fd_ops.launches == n0 + 1 and out.shape == q.shape and out.dtype == dtype
    _decode_close(out, q, kc, vc, cl, BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    qh = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa_ops.flash_attention(qh, qh[:, :, :2], qh[:, :, :2])
    qb = torch.zeros(1, 64, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d_head"):
        fa_ops.run_variant(qb, qb[:, :, :2], qb[:, :, :2], variant="wgmma")
    qd = torch.zeros(1, 1, 16, 48, device=cuda)
    kc = torch.zeros(1, 32, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        fd_ops.flash_decode(qd, kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="does not fit"):
        k2 = torch.zeros(1, 32, 2, 64, device=cuda)   # 15 query heads on 2 kv heads
        fd_ops.flash_decode(torch.zeros(1, 1, 15, 64, device=cuda), k2, k2,
                            torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        fd_ops.flash_decode(qd[:, :, :8], kc, kc, torch.ones(1, dtype=torch.int64, device=cuda))


# ------------------------------------------------- guided update kernels

GUIDED_ATOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _guided_inputs(cuda, dtype, n, seed):
    from repro_torch.kernels.guided_update.ops import _ct

    g_ = torch.Generator(device=cuda).manual_seed(seed)
    ct = _ct(dtype)
    w = torch.randn(n, generator=g_, device=cuda, dtype=ct)
    g = 0.01 * torch.randn(n, generator=g_, device=cuda, dtype=ct)
    ws = w + 0.05 * torch.randn(n, generator=g_, device=cuda, dtype=ct)
    accs = [torch.rand(n, generator=g_, device=cuda, dtype=ct) * s for s in (0.1, 0.05)]
    return w.to(dtype), g.to(dtype), ws.to(dtype), accs


def _guided_close(out, ref, dtype):
    """Weights: within the dtype's bar, bf16 within one bf16 ulp of the plain
    version's value (both compute in f32; rmsprop's 1-beta and adam's bias
    corrections are rounded at different points, as in the reference).
    Accumulators (f32 at bf16 weights): the f32 bar."""
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.dtype == r.dtype and o.shape == r.shape
        if o.dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(r.float().abs().clamp(min=2**-126))) - 7)
            assert bool(((o.float() - r.float()).abs() <= ulp).all()), i
        else:
            err = (o - r).abs().max().item()
            assert err <= GUIDED_ATOL.get(o.dtype, 1e-6), (i, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov", "rmsprop", "adam"])
@pytest.mark.parametrize("n", [1860, 4096 * 257 + 3])
def test_guided_update_kernels_on_card(cuda, dtype, kind, n):
    from repro_torch.kernels.guided_update import ops
    from repro_torch.kernels.guided_update import ref as R

    w, g, ws, (a0, a1) = _guided_inputs(cuda, dtype, n, seed=n % 97)
    name = "guided_momentum_update" if kind == "nesterov" else f"guided_{kind}_update"
    n0 = ops.launches[name]
    if kind == "sgd":
        out = (ops.guided_sgd_update_raw(w, g, ws, 0.2, 0.04),)
        ref = (R.guided_sgd_update_ref(w, g, ws, 0.2, 0.04),)
    elif kind in ("momentum", "nesterov"):
        out = ops.guided_momentum_update_raw(w, g, ws, a0, 0.2, 0.04, 0.9,
                                             nesterov=kind == "nesterov")
        ref = R.guided_momentum_update_ref(w, g, ws, a0, 0.2, 0.04, 0.9,
                                           nesterov=kind == "nesterov")
    elif kind == "rmsprop":
        out = ops.guided_rmsprop_update_raw(w, g, ws, a0, 0.2, 0.04, 0.9, 1e-8)
        ref = R.guided_rmsprop_update_ref(w, g, ws, a0, 0.2, 0.04, 0.9, 1e-8)
    else:
        out = ops.guided_adam_update_raw(w, g, ws, a0, a1, 7, 0.2, 0.04, 0.9, 0.999, 1e-8)
        ref = R.guided_adam_update_ref(w, g, ws, a0, a1, 7, 0.2, 0.04, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert ops.launches[name] == n0 + 1
    _guided_close(out, ref, dtype)


def test_guided_update_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.guided_update import ops

    w = torch.zeros(64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="must match w"):
        ops.guided_sgd_update_raw(w, w.float(), w, 0.1, 0.0)
    with pytest.raises(ValueError, match="accumulators"):
        ops.guided_momentum_update_raw(w, w, w, w.float(), 0.1, 0.0, 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        ops.guided_sgd_update_raw(w[::2], w[::2], w[::2], 0.1, 0.0)
    with pytest.raises(TypeError):
        wh = w.half()
        ops.guided_sgd_update_raw(wh, wh, wh, 0.1, 0.0)


def test_every_kernel_wrapper_refuses_inputs_that_require_grad(cuda):
    """No kernel has a backward: with grad mode on, a CUDA input that
    requires grad raises (its output would be cut from the graph); under
    no_grad the same call launches."""
    from repro_torch.kernels.guided_update import ops
    from repro_torch.kernels.selective_scan import ops as ss_ops

    q, k, v = _attention_inputs(cuda, 64, 8, 2, 64, torch.bfloat16)
    q32 = q.float()
    calls = {
        "flash_attention (wgmma)": lambda r: fa_ops.flash_attention(r(q), k, v),
        "flash_attention (simt)": lambda r: fa_ops.flash_attention(r(q32), k.float(), v.float()),
        "flash_decode": lambda r: fd_ops.flash_decode(
            r(q[:, :1].contiguous()), k, v, torch.full((1,), 64, dtype=torch.int32, device=cuda)),
        "selective_scan": lambda r: ss_ops.selective_scan(
            r(torch.zeros(1, 8, 32, device=cuda)), torch.ones(1, 8, 32, device=cuda),
            -torch.ones(32, 4, device=cuda), torch.zeros(1, 8, 4, device=cuda),
            torch.zeros(1, 8, 4, device=cuda)),
    }
    w, g, ws, (a0, a1) = _guided_inputs(cuda, torch.float32, 100, seed=1)
    calls.update({
        "guided_sgd_update": lambda r: ops.guided_sgd_update_raw(r(w), g, ws, 0.1, 0.0),
        "guided_momentum_update": lambda r: ops.guided_momentum_update_raw(
            w, r(g), ws, a0, 0.1, 0.0, 0.9),
        "guided_rmsprop_update": lambda r: ops.guided_rmsprop_update_raw(
            w, g, ws, r(a0), 0.1, 0.0, 0.9, 1e-8),
        "guided_adam_update": lambda r: ops.guided_adam_update_raw(
            w, g, r(ws), a0, a1, 1, 0.1, 0.0, 0.9, 0.999, 1e-8),
    })
    for name, call in calls.items():
        with pytest.raises(RuntimeError,
                           match=re.escape(f"{name}: the CUDA kernel has no backward")):
            call(lambda t: t.detach().clone().requires_grad_())
        with torch.no_grad():
            call(lambda t: t.detach().clone().requires_grad_())
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_tree_fused_update_in_place_at_a_full_width_leaf(cuda, name):
    """yi-9b's embedding table (64000 x 4096 bf16, one leaf of the mesh
    trainer's params) through tree_fused_update in place, DC-ASGD's lam, one
    launch, against the plain version on fresh outputs: weights within one
    bf16 ulp, accumulators within the f32 bar."""
    from repro_torch.kernels.guided_update import ops
    from repro_torch.kernels.guided_update import ref as R

    w, g, ws, (a0, a1) = _guided_inputs(cuda, torch.bfloat16, 64000 * 4096, seed=5)
    shape = (64000, 4096)
    w, g, ws, a0, a1 = (t.view(shape) for t in (w, g, ws, a0, a1))
    hy = {"sgd": {}, "momentum": {"beta": 0.9}, "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8}}
    st = {"sgd": (), "momentum": {"m": {"t": a0.clone()}},
          "adam": {"m": {"t": a0.clone()}, "v": {"t": a1.clone()}, "t": 6}}[name]
    if name == "sgd":
        want = (R.guided_sgd_update_ref(w, g, ws, 0.2, 0.04),)
    elif name == "momentum":
        want = R.guided_momentum_update_ref(w, g, ws, a0, 0.2, 0.04, 0.9)
    else:
        want = R.guided_adam_update_ref(w, g, ws, a0, a1, 7, 0.2, 0.04, 0.9, 0.999, 1e-8)
    params = {"t": w.clone()}
    ptr = params["t"].data_ptr()
    key = f"guided_{name}_update"
    n0 = ops.launches[key]
    params, st = ops.tree_fused_update(ops.fused_update_for(name, **hy[name]), name, params,
                                       {"t": g}, {"t": ws}, st, 0.2, 0.04)
    torch.cuda.synchronize()
    assert ops.launches[key] == n0 + 1 and params["t"].data_ptr() == ptr
    got = (params["t"],) + tuple(st[k]["t"] for k in ("m", "v") if st and k in st)
    _guided_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("strategy,mode", [("dc_asgd", "asgd"), ("guided_two_pass", "ssgd")])
def test_mesh_trainer_on_card_matches_cpu(cuda, strategy, mode):
    """Five steps of the reduced yi-9b (f32, 2 layers) on the card and on
    the CPU from one state drawn on the CPU, on the same batches (DC-ASGD's
    lam fold; the two-pass strategy's second backward at window ends): one
    fused guided-update launch per param leaf and step on the card, nothing
    else launched, and the same losses within 1e-4 (float32; the card's
    cuBLAS sums in another order than the CPU, and 5 steps at lr 1e-2 grow
    that to a few ulps of losses of order 7)."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.engine import ExperimentSpec
    from repro_torch.engine import mesh as M
    from repro_torch.kernels.guided_update import ops
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.optim import constant, get_optimizer

    spec = ExperimentSpec(backend="mesh", mode=mode, strategy=strategy, rho=2, lr=1e-2,
                          steps=5, seq_len=16, global_batch=4, workers=2)
    cfg, gcfg, opt = spec.model_config(), spec.to_guided_config(), get_optimizer("sgd")
    stream = synthetic_lm_batches(cfg.vocab_size, 16, 4, seed=0, n_corpora=2)
    batches = [next(stream) for _ in range(5)]
    params, gstate = M.init_train_state(torch.Generator().manual_seed(0), cfg, gcfg, opt, 2,
                                        strategy=strategy, device="cpu")
    to = lambda t, dev: tree_map(lambda x: x.to(dev), t)  # noqa: E731
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        p = to(params, dev)
        g = gstate._replace(score=gstate.score.to(dev),
                            prev_worker_loss=gstate.prev_worker_loss.to(dev),
                            prev_avg_loss=gstate.prev_avg_loss.to(dev),
                            w_stale=to(gstate.w_stale, dev) if gcfg.needs_stale else ())
        step = M.build_train_step(cfg, gcfg, opt, constant(spec.lr), n_workers=2,
                                  strategy=strategy)
        before = (dict(ops.launches), fa_ops.launches, fd_ops.launches, ss_ops.launches)
        losses[dev.type] = []
        for b in batches:
            p, g, m = step(p, g, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses[dev.type].append(m["loss"].item())
        if dev.type == "cuda":
            assert (ops.launches["guided_sgd_update"] - before[0]["guided_sgd_update"]
                    == 5 * len(tree_leaves(p)))
            assert (fa_ops.launches, fd_ops.launches, ss_ops.launches) == before[1:]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0, atol=1e-4)


def test_scan_trainer_on_card_matches_cpu(cuda):
    """A short scan fit on the card: one guided-update launch per arrival
    covering every seed, the same trajectory as the CPU run."""
    from repro_torch.data import load_dataset, train_test_split
    from repro_torch.engine import ExperimentSpec, Trainer
    from repro_torch.kernels.guided_update import ops

    X, y, k = load_dataset("new_thyroid", seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=1)
    for optimizer in ("sgd", "rmsprop", "momentum", "adam"):
        spec = ExperimentSpec(backend="scan", mode="asgd", strategy="dc_asgd_guided",
                              optimizer=optimizer, lr=0.05, epochs=3, rho=4, n_seeds=3)
        n0 = sum(ops.launches.values())
        rep = Trainer.from_spec(spec).fit((Xtr, ytr, k, Xte, yte))
        assert sum(ops.launches.values()) - n0 == rep.n_steps > 0
        cpu = Trainer.from_spec(spec, device="cpu").fit((Xtr, ytr, k, Xte, yte))
        h = np.stack([x[1] for x in rep.history])
        hc = np.stack([x[1] for x in cpu.history])
        assert np.abs(h - hc).max() <= 1e-9


def test_dist_replay_on_card_matches_cpu(cuda):
    """A short replay fit of the async parameter server with the chief on
    the card: one guided-update launch per applied push and nothing else,
    the schedule's staleness, the same trajectory as the chief on the CPU."""
    from repro_torch.data import load_dataset, train_test_split
    from repro_torch.dist import run_local
    from repro_torch.engine import ExperimentSpec
    from repro_torch.kernels.guided_update import ops

    X, y, k = load_dataset("new_thyroid", seed=0)
    Xtr, ytr, _, _ = train_test_split(X, y, seed=1)
    for kw in (dict(mode="asgd", strategy="dc_asgd_guided"),
               dict(mode="ssgd", strategy="guided_fused", optimizer="rmsprop"),
               dict(mode="asgd", strategy="gap_aware")):
        spec = ExperimentSpec(backend="dist", dist_mode="replay", lr=0.05, epochs=3, rho=4,
                              **kw)
        n0 = dict(ops.launches)
        card = run_local(spec, Xtr, ytr, k)
        used = {n: ops.launches[n] - n0[n] for n in n0 if ops.launches[n] != n0[n]}
        assert used == {f"guided_{spec.optimizer}_update": card["n_steps"]}
        assert card["n_steps"] > 0
        cpu = run_local(spec, Xtr, ytr, k, device="cpu")
        np.testing.assert_array_equal(card["staleness_seq"], cpu["staleness_seq"])
        np.testing.assert_array_equal(card["staleness_seq"], card["schedule"].staleness)
        h = np.array([v for _, v in card["history"]])
        hc = np.array([v for _, v in cpu["history"]])
        assert np.abs(h - hc).max() <= 1e-9


# ------------------------------------------------------------ selective scan

SCAN_ATOL = 1e-4  # the reference's bar (tests/test_kernels.py)


def _scan_inputs(cuda, B, S, ed, n, seed, model_like=False):
    """Random draws, or (model_like) the model's: dt a softplus around
    log(expm1(0.01)) and A = -[1..n] on every channel."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    x, Bc, Cc, h0 = r(B, S, ed), r(B, S, n), r(B, S, n), r(B, ed, n)
    if model_like:
        dt = torch.nn.functional.softplus(r(B, S, ed) + float(np.log(np.expm1(0.01))))
        A = -torch.arange(1, n + 1, device=cuda, dtype=torch.float32).repeat(ed, 1)
    else:
        dt = 0.1 * r(B, S, ed).abs()
        A = -r(ed, n).abs()
    return x, dt, A, Bc, Cc, h0


SCAN_TC = 32  # time steps of one chunk of the kernel's shared-memory ring


def _assert_scan_matches(x, dt, A, Bc, Cc, h0):
    """One kernel call (one launch) against the plain version at SCAN_ATOL."""
    from repro_torch.kernels.selective_scan import ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    n0 = ops.launches
    y, h = ops.selective_scan(x, dt, A, Bc, Cc, h0)
    torch.cuda.synchronize()
    assert ops.launches == n0 + 1
    yr, hr = selective_scan_ref(x, dt, A, Bc, Cc, h0)
    assert (y - yr).abs().max().item() <= SCAN_ATOL
    assert (h - hr).abs().max().item() <= SCAN_ATOL


@pytest.mark.parametrize("B,S,ed,n,model_like", [
    (1, 1, 16384, 16, True), (1, 17, 1000, 16, False), (2, 1000, 4096, 16, True),
    (2, 64, 128, 16, False), (1, 64, 64, 4, False), (3, 33, 200, 8, False),
    (1, 9, 70, 13, False), (1, 5, 64, 12, False),
    # lengths at the chunk's edges
    *[(1, S, 256, 16, True) for S in (1, SCAN_TC - 1, SCAN_TC, SCAN_TC + 1, 2048 + 3)],
    # widths not a multiple of the block's 64 channels, or of 4 (no 16-byte rows)
    *[(2, 45, ed, 16, False) for ed in (4, 65, 70, 1000)],
    *[(1, 100, 192, n, False) for n in (1, 4, 8, 12, 13, 16)],
    (3, 77, 200, 16, True)])  # batch rows follow one another inside one launch
def test_selective_scan_kernel_on_card(cuda, B, S, ed, n, model_like):
    x, dt, A, Bc, Cc, h0 = _scan_inputs(cuda, B, S, ed, n, seed=S + ed, model_like=model_like)
    for h in (h0, None):
        _assert_scan_matches(x, dt, A, Bc, Cc, h)


@pytest.mark.parametrize("cut", [400, 13 * SCAN_TC])
def test_selective_scan_kernel_chains_h0(cuda, cut):
    """h0 carried from one call to the next, split inside a chunk (400) and
    on a chunk boundary (416); the single call matches the plain version."""
    from repro_torch.kernels.selective_scan import ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    x, dt, A, Bc, Cc, _ = _scan_inputs(cuda, 2, 777, 2048, 16, seed=3, model_like=True)
    y, h = ops.selective_scan(x, dt, A, Bc, Cc)
    yr, hr = selective_scan_ref(x, dt, A, Bc, Cc)
    assert (y - yr).abs().max().item() <= SCAN_ATOL
    assert (h - hr).abs().max().item() <= SCAN_ATOL
    y1, h1 = ops.selective_scan(x[:, :cut].contiguous(), dt[:, :cut].contiguous(), A,
                                Bc[:, :cut].contiguous(), Cc[:, :cut].contiguous())
    y2, h2 = ops.selective_scan(x[:, cut:].contiguous(), dt[:, cut:].contiguous(), A,
                                Bc[:, cut:].contiguous(), Cc[:, cut:].contiguous(), h0=h1)
    assert (torch.cat([y1, y2], 1) - y).abs().max().item() <= SCAN_ATOL
    assert (h2 - h).abs().max().item() <= SCAN_ATOL


@pytest.mark.parametrize("ed,n", [(1024, 16), (70, 13)])
def test_selective_scan_kernel_takes_4_byte_aligned_views(cuda, ed, n):
    """x, dt, B and C as contiguous views one float into their buffers:
    aligned to 4 bytes, not 16; the kernel takes them."""
    B, S = 2, 67

    def view(a):
        buf = torch.zeros(a.numel() + 1, device=cuda)
        buf[1:] = a.flatten()
        v = buf[1:1 + a.numel()].view(a.shape)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        return v

    x, dt, A, Bc, Cc, h0 = _scan_inputs(cuda, B, S, ed, n, seed=ed + n)
    _assert_scan_matches(view(x), view(dt), A, view(Bc), view(Cc), h0)


def test_selective_scan_kernel_is_deterministic(cuda):
    from repro_torch.kernels.selective_scan import ops

    x, dt, A, Bc, Cc, h0 = _scan_inputs(cuda, 2, 300, 2048, 16, seed=9, model_like=True)
    y1, h1 = ops.selective_scan(x, dt, A, Bc, Cc, h0)
    y2, h2 = ops.selective_scan(x, dt, A, Bc, Cc, h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_selective_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.selective_scan import ops

    x, dt, A, Bc, Cc, h0 = _scan_inputs(cuda, 2, 8, 64, 16, seed=0)
    for dtype in (torch.float16, torch.bfloat16, torch.float64):
        with pytest.raises(TypeError, match="float32"):
            ops.selective_scan(x.to(dtype), dt, A, Bc, Cc, h0)
        with pytest.raises(TypeError, match="float32"):
            ops.selective_scan(x, dt, A, Bc, Cc, h0.to(dtype))
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt, A, Bc, Cc)
    with pytest.raises(ValueError, match="x, dt"):
        ops.selective_scan(x, dt[:, :4], A, Bc, Cc)
    with pytest.raises(ValueError, match="n <= 16"):
        ops.selective_scan(x, dt, torch.zeros(64, 17, device=cuda), Bc.new_zeros(2, 8, 17),
                           Cc.new_zeros(2, 8, 17))
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        ops.selective_scan(x, dt, A.cpu(), Bc, Cc)


def test_hybrid_stack_on_card_matches_cpu(cuda):
    """Reduced jamba (f32) on the card through its kernels against the same
    weights on the CPU through the plain versions: prefill at an odd length,
    then 4 decode steps; 7 scans and 1 flash_attention per prefill. Logits
    (of size about 3) within 1e-4: f32 on both sides, only summation orders
    differ (the CPU port is within 1e-5 of the JAX reference)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.module import tree_map

    cfg = get_config("jamba_1_5_large_398b").replace(moe=None).reduced()
    params = T.model_init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    cpu = tree_map(lambda a: a.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(1))
    n0, a0 = ops.launches, fa_ops.launches
    lg, cg = T.prefill(params, {"tokens": toks.to(cuda)}, cfg, total_len=48)
    assert (ops.launches - n0, fa_ops.launches - a0) == (7, 1)
    lc, cc = T.prefill(cpu, {"tokens": toks}, cfg, total_len=48)
    assert (lg.cpu() - lc).abs().max().item() <= 1e-4
    t = torch.full((2,), 37, dtype=torch.int32)
    for _ in range(4):
        nxt = torch.argmax(lc, -1)[:, None]
        n0 = ops.launches
        lg, cg = T.decode_step(params, cg, nxt.to(cuda), t.to(cuda), cfg)
        lc, cc = T.decode_step(cpu, cc, nxt, t, cfg)
        assert ops.launches == n0  # a decode step runs no scan kernel
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4
        t += 1
