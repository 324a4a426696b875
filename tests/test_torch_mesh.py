"""The port's mesh train step against the JAX package's, step for step, for
the sgd paths of every registered strategy (the fused guided-update path
and the two-phase one), with microbatching and the wsd schedule.

Both packages start from the reference's `init_train_state` (carried over
with `repro_torch.models.convert.train_state_from_jax`) and take the same
batches: the reduced yi-9b (2 layers, f32), seq 16, global batch 4, c = 2
workers, rho = 2, 5 steps, lr 1e-2. Every step's loss, worker-loss variance
and correction-weight sum, and after the last step every param, w_stale and
the consistency scores, agree within atol 1e-5: both compute in float32 and
differ only in summation order (XLA's fused reductions against torch's),
about 1e-7 on losses of order 1 and on weights of order 0.1.
"""
import pytest

from torch_mesh_parity import compare, spec_kw


@pytest.mark.parametrize("strategy,mode", [
    ("guided_fused", "ssgd"),
    ("dc_asgd", "asgd"),
    ("dc_asgd_guided", "asgd"),
    ("guided_two_pass", "ssgd"),
    ("gap_aware", "asgd"),
])
def test_mesh_step_matches_the_reference_sgd(strategy, mode):
    hist = compare(spec_kw(strategy, mode, "sgd"))
    if strategy in ("guided_fused", "guided_two_pass"):
        # the fixed batch makes workers consistent: the correction fires
        # (folded into the backward: the weights sum to 1 at window end)
        fired = [h["corr_weight_sum"] for h in hist]
        assert (max(fired) > 0) == (strategy == "guided_fused"), fired


def test_mesh_step_matches_the_reference_with_microbatches():
    compare(spec_kw("guided_fused", "ssgd", "sgd", micro=2))


def test_mesh_step_matches_the_reference_under_wsd():
    # warmup 1 of 5 steps: step 0 warms (lr 0), steps 1-3 hold, step 4 decays
    compare(spec_kw("dc_asgd", "asgd", "sgd", schedule="wsd", warmup=1))
