"""The port's dist replay against the JAX package's: `repro.dist.launcher.
run_local` in replay mode (2 of its own worker processes) and the port's
`run_local(device="cpu")` on the same seed and data give the same observed
staleness sequence, the same step count, and histories within 1e-7 (the
reference's bar for replay against its scan backend, tests/test_dist.py).

The reference's chief folds the guided score through JAX under
`jax.experimental.enable_x64`, which the installed jax no longer has, so it
runs in ONE subprocess that sets it before importing repro.dist; nothing of
the JAX dist is imported into this process.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.dist import launcher
from repro_torch.engine import ExperimentSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_ATOL = 1e-7

CASES = {"guided_fused": dict(strategy="guided_fused"),
         "dc_asgd": dict(strategy="dc_asgd")}
COMMON = dict(backend="dist", dist_mode="replay", mode="asgd", epochs=3, batch_size=16,
              rho=2, lr=0.2, seed=0)


def _toy(n=120, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w = rng.standard_normal((d,))
    y = (X @ w > 0).astype(np.int64)
    return X, y, 2


_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # the name the reference imports
    import numpy as np
    from repro.dist import launcher
    from repro.engine import ExperimentSpec

    cases, common, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((120, 5))
    y = (X @ rng.standard_normal((5,)) > 0).astype(np.int64)
    res = {}
    for name, kw in cases.items():
        r = launcher.run_local(ExperimentSpec(**common, **kw), X, y, 2)
        res[name + "/history"] = np.array([v for _, v in r["history"]])
        res[name + "/staleness"] = r["staleness_seq"]
        res[name + "/n_steps"] = r["n_steps"]
        res[name + "/W"] = np.asarray(r["model"].W)
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def jax_dist(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dist") / "dist.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(CASES),
                           json.dumps(COMMON), str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_matches_the_jax_dist(jax_dist, case):
    X, y, k = _toy()
    res = launcher.run_local(ExperimentSpec(**COMMON, **CASES[case]), X, y, k, device="cpu")
    assert res["n_steps"] == int(jax_dist[case + "/n_steps"]) > 0
    np.testing.assert_array_equal(res["staleness_seq"], jax_dist[case + "/staleness"])
    hist = np.array([v for _, v in res["history"]])
    np.testing.assert_allclose(hist, jax_dist[case + "/history"], atol=HIST_ATOL, rtol=0)
    np.testing.assert_allclose(res["model"].W, jax_dist[case + "/W"], atol=HIST_ATOL, rtol=0)
