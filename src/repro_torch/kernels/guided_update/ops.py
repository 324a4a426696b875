"""Public wrappers of the fused guided update kernels (csrc/guided_update.cu),
the whole-update dispatch `fused_update_for` and its tree form
`tree_fused_update` (the mesh trainer's update: one launch per leaf).

CUDA tensors launch the kernel (or raise); CPU tensors run the plain version
in `ref.py`. There is no fallback from a failed launch. `launches` counts, per
kernel, the wrapper calls that launched it, and only those.

Kernel inputs: `w`, `g` and `w_stale` of one dtype (float64, float32 or
bfloat16) and one shape, contiguous; accumulators at the compute dtype
`promote(w.dtype, float32)`. Any element count: the kernels mask their own
tail. The scalars are rounded to the compute dtype here, on the host, as
`kernel.py` builds its scalar pack; adam's bias corrections come from the
Python step `t`, so nothing reads a device value back.

`out=` takes the tensors to write the results into (the new weights, then
each new accumulator), in place of fresh ones. They may be the inputs
themselves: each thread reads element i of every input before it writes
element i of any output, and no two threads share an element, so the mesh
trainer updates its weights and accumulators in place and holds no second
copy of a leaf.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.common import tree_leaves, tree_unflatten
from repro_torch.kernels.guided_update import ref as R

#: optimizers with a whole-update fused implementation (adagrad has none: the
#: scan backend keeps its inline update)
FUSED_OPTIMIZERS = ("sgd", "momentum", "rmsprop", "adam")
#: accumulator tuple arity per fused optimizer (what `acc` carries)
FUSED_ACC_ARITY = {"sgd": 0, "momentum": 1, "rmsprop": 1, "adam": 2}

_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_P, _I, _N, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = {  # ..., dtype code, SM count, stream
    "guided_sgd_update": [_P] * 4 + [_N, _D, _D, _I, _I, _P],
    "guided_momentum_update": [_P] * 6 + [_N, _D, _D, _D, _I, _I, _I, _P],
    "guided_rmsprop_update": [_P] * 6 + [_N, _D, _D, _D, _D, _I, _I, _P],
    "guided_adam_update": [_P] * 8 + [_N] + [_D] * 9 + [_I, _I, _P],
}

launches = dict.fromkeys(_ARGTYPES, 0)


def _ct(dtype):
    return torch.promote_types(dtype, torch.float32)


def _round(ct, *xs):
    """Python floats rounded to the compute dtype, held exactly as doubles."""
    np_t = np.float64 if ct == torch.float64 else np.float32
    return [float(np_t(x)) for x in xs]


def _check(w, g, w_stale, accs):
    for name, a in (("g", g), ("w_stale", w_stale)):
        if a.shape != w.shape or a.dtype != w.dtype:
            raise ValueError(f"{name} must match w {tuple(w.shape)} {w.dtype}; "
                             f"got {tuple(a.shape)} {a.dtype}")
    ct = _ct(w.dtype)
    for a in accs:
        if a.shape != w.shape or a.dtype != ct:
            raise ValueError(f"accumulators must be {tuple(w.shape)} {ct}; "
                             f"got {tuple(a.shape)} {a.dtype}")
    if not all(a.is_contiguous() for a in (w, g, w_stale, *accs)):
        raise ValueError("guided_update kernels need contiguous tensors")
    if w.numel() == 0:
        raise ValueError("guided_update kernels need at least one element")
    return ct


def _outputs(out, likes):
    """`out` checked against the outputs' shapes and dtypes, or fresh ones."""
    if out is None:
        return tuple(torch.empty_like(x) for x in likes)
    out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    if len(out) != len(likes):
        raise ValueError(f"out: want {len(likes)} tensors, got {len(out)}")
    for o, x in zip(out, likes):
        if o.shape != x.shape or o.dtype != x.dtype or not o.is_contiguous():
            raise ValueError(f"out must be contiguous {tuple(x.shape)} {x.dtype}; "
                             f"got {tuple(o.shape)} {o.dtype}")
    return out


def _into(out, result):
    """The plain version's result, copied into `out` when given."""
    if out is None:
        return result
    if isinstance(out, torch.Tensor):
        return out.copy_(result)
    for o, r in zip(out, result):
        o.copy_(r)
    return tuple(out)


def _launch(name, tensors, scalars, dtype, device, *flags):
    """Call C entry point `name` on the current stream; count the launch."""
    with torch.cuda.device(device):
        fn = kernels.kernel_fn(name, _ARGTYPES[name])
        rc = fn(*(t.data_ptr() for t in tensors), tensors[0].numel(), *scalars, *flags,
                kernels.dtype_code(dtype, _DTYPES), kernels.sm_count(device),
                torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(name, rc)
    launches[name] += 1


def load(name: str) -> None:
    """Build the kernels' library (first call) and bind entry point `name`
    now, on the calling thread. The build cache is lock-free, so a caller
    that launches from several threads (the dist chief's connection
    threads) loads its kernel here first, before it starts them."""
    kernels.kernel_fn(name, _ARGTYPES[name])


def guided_sgd_update_raw(w, g, w_stale, lr, lam, *, out=None):
    """g~ = g + lam*g*g*(w - w_stale); returns w - lr*g~ in w.dtype (in
    `out` when given)."""
    if not kernels.use_kernel(w, g, w_stale):
        return _into(out, R.guided_sgd_update_ref(w, g, w_stale, lr, lam))
    kernels.refuse_autograd("guided_sgd_update", w, g, w_stale)
    ct = _check(w, g, w_stale, ())
    (out,) = _outputs(out, (w,))
    _launch("guided_sgd_update", (w, g, w_stale, out), _round(ct, lr, lam), w.dtype, w.device)
    return out


def guided_momentum_update_raw(w, g, w_stale, m, lr, lam, beta, *, nesterov: bool = False,
                               out=None):
    """Fused compensate + momentum accumulate + apply. Returns (new w, new m),
    in `out` when given."""
    if not kernels.use_kernel(w, g, w_stale, m):
        return _into(out, R.guided_momentum_update_ref(w, g, w_stale, m, lr, lam, beta,
                                                       nesterov=nesterov))
    kernels.refuse_autograd("guided_momentum_update", w, g, w_stale, m)
    ct = _check(w, g, w_stale, (m,))
    out = _outputs(out, (w, m))
    _launch("guided_momentum_update", (w, g, w_stale, m, *out),
            _round(ct, lr, lam, beta), w.dtype, w.device, int(nesterov))
    return out


def guided_rmsprop_update_raw(w, g, w_stale, r, lr, lam, beta, eps, *, out=None):
    """Fused compensate + rmsprop accumulate + apply. Returns (new w, new r),
    in `out` when given."""
    if not kernels.use_kernel(w, g, w_stale, r):
        return _into(out, R.guided_rmsprop_update_ref(w, g, w_stale, r, lr, lam, beta, eps))
    kernels.refuse_autograd("guided_rmsprop_update", w, g, w_stale, r)
    ct = _check(w, g, w_stale, (r,))
    out = _outputs(out, (w, r))
    _launch("guided_rmsprop_update", (w, g, w_stale, r, *out),
            _round(ct, lr, lam, beta, eps), w.dtype, w.device)
    return out


def guided_adam_update_raw(w, g, w_stale, m, v, t, lr, lam, b1, b2, eps, *, out=None):
    """Fused compensate + adam moments + bias-corrected apply.

    `t` is the ALREADY-incremented step (a Python int); `b1`/`b2` are python
    floats, so the pre-rounded (1-b) factors match the reference's
    weak-typed promotion. Returns (new w, new m, new v), in `out` when given."""
    if not kernels.use_kernel(w, g, w_stale, m, v):
        return _into(out, R.guided_adam_update_ref(w, g, w_stale, m, v, t, lr, lam, b1, b2, eps))
    kernels.refuse_autograd("guided_adam_update", w, g, w_stale, m, v)
    ct = _check(w, g, w_stale, (m, v))
    np_t = np.float64 if ct == torch.float64 else np.float32
    bc1 = np_t(1.0) - np_t(b1) ** np_t(t)
    bc2 = np_t(1.0) - np_t(b2) ** np_t(t)
    out = _outputs(out, (w, m, v))
    _launch("guided_adam_update", (w, g, w_stale, m, v, *out),
            _round(ct, lr, lam, b1, 1.0 - b1, b2, 1.0 - b2, bc1, bc2, eps), w.dtype, w.device)
    return out


def fused_update_for(name: str, *, beta: float = 0.9, nesterov: bool = False,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One whole-update callable for optimizer `name`, uniform signature:

        f(w, g, w_stale, acc, t, lr, lam, inplace=False) -> (new_w, new_acc)

    `acc` is the accumulator tuple — () for sgd, (m,) for momentum, (r,) for
    rmsprop, (m, v) for adam — and `t` the already-incremented adam step
    (ignored by the others). `inplace` writes the new weights into `w` and
    the new accumulators into `acc`. Hypers are python floats/bools baked
    into the closure. Raises KeyError for optimizers with no fused form
    (adagrad)."""
    if name not in FUSED_OPTIMIZERS:
        raise KeyError(f"no fused whole-update for optimizer {name!r}; "
                       f"fused: {', '.join(FUSED_OPTIMIZERS)}")
    if name == "sgd":
        def f(w, g, ws, acc, t, lr, lam, inplace=False):
            return guided_sgd_update_raw(w, g, ws, lr, lam, out=w if inplace else None), acc
    elif name == "momentum":
        def f(w, g, ws, acc, t, lr, lam, inplace=False):
            w2, m2 = guided_momentum_update_raw(w, g, ws, acc[0], lr, lam, beta,
                                                nesterov=nesterov,
                                                out=(w, *acc) if inplace else None)
            return w2, (m2,)
    elif name == "rmsprop":
        def f(w, g, ws, acc, t, lr, lam, inplace=False):
            w2, r2 = guided_rmsprop_update_raw(w, g, ws, acc[0], lr, lam, beta, eps,
                                               out=(w, *acc) if inplace else None)
            return w2, (r2,)
    else:  # adam
        def f(w, g, ws, acc, t, lr, lam, inplace=False):
            w2, m2, v2 = guided_adam_update_raw(w, g, ws, acc[0], acc[1], t, lr, lam,
                                                b1, b2, eps,
                                                out=(w, *acc) if inplace else None)
            return w2, (m2, v2)
    f.optimizer = name
    return f


def tree_fused_update(fused, name: str, params, grads, w_stale, opt_state, lr, lam,
                      inplace: bool = True):
    """Apply a `fused_update_for` callable across a parameter tree: one call
    (one kernel launch on the card) per leaf. In place (the default) the new
    weights are written into `params` and the new accumulators into
    `opt_state`'s leaves; with `inplace=False` both come back as new trees
    and the inputs are left as they were. Maps the optimizer's state layout
    ({} for sgd, {"m"}, {"r"}, {"m", "v", "t"} with a host int `t`) onto
    the per-leaf acc tuples. Returns (params, new_opt_state), adam's `t`
    advanced."""
    keys = {"sgd": (), "momentum": ("m",), "rmsprop": ("r",), "adam": ("m", "v")}[name]
    t = opt_state["t"] + 1 if name == "adam" else None
    accs = [tree_leaves(opt_state[k]) for k in keys]
    new_w, new_accs = [], [[] for _ in keys]
    with torch.no_grad():
        for i, (w, g, ws) in enumerate(zip(tree_leaves(params), tree_leaves(grads),
                                           tree_leaves(w_stale))):
            w2, acc2 = fused(w, g, ws, tuple(a[i] for a in accs), t, lr, lam, inplace=inplace)
            new_w.append(w2)
            for lst, a in zip(new_accs, acc2):
                lst.append(a)
    # in place, these trees hold the input tensors themselves
    params = tree_unflatten(params, new_w)
    if keys:
        opt_state = {**opt_state, **{k: tree_unflatten(opt_state[k], lst)
                                     for k, lst in zip(keys, new_accs)}}
    if name == "adam":
        opt_state = {**opt_state, "t": t}
    return params, opt_state
