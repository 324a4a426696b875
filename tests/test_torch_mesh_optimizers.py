"""The port's mesh train step against the JAX package's for the other
optimizers: rmsprop on the two-phase path (no fused kernel on the mesh),
momentum and adam through the fused guided-update kernels' plain versions.
Setup and bars as tests/test_torch_mesh.py (atol 1e-5, summation order),
with two differences, each for a reason:

  * rmsprop and adam train at lr 1e-3. Their normalized updates move every
    weight by about lr * c * 3 a step whatever the gradient's size; at the
    sgd cases' 1e-2 that is 0.06 on weights of about 0.06, and the rmsprop
    fit turns unstable (loss 6.7 -> 10.8 in three steps) and amplifies
    round-off past any fixed bar.
  * adam's params: some gradients are zero in exact arithmetic and round-off
    noise of 1e-9 in either package (the query and key projections at the
    first position, where the softmax has one key). adam divides them by
    their own size, so each package steps them by +-lr_eff at its noise's
    sign. At most 1e-4 of the elements may therefore part by more than
    1e-5, none by more than 4 * lr_eff * steps; every step's metrics still
    agree within 1e-5.
"""
from torch_mesh_parity import compare, spec_kw


def test_mesh_two_phase_rmsprop_matches_the_reference():
    compare(spec_kw("none", "ssgd", "rmsprop", lr=1e-3))


def test_mesh_fused_momentum_matches_the_reference():
    hist = compare(spec_kw("guided_fused", "ssgd", "momentum"))
    assert max(h["corr_weight_sum"] for h in hist) > 0


def test_mesh_fused_adam_matches_the_reference():
    lr_eff = 1e-3 * 2
    compare(spec_kw("dc_asgd", "asgd", "adam", lr=1e-3), param_outliers=1e-4,
            param_cap=4 * lr_eff * 5)
