"""Serving's warm start from a training snapshot (ServeEngine.from_checkpoint,
`launch.serve --ckpt-dir`) against repro.serve's.

A snapshot the port's mesh fit writes serves the fit's own params; a
snapshot the reference's fit writes serves the same greedy tokens through
both packages' `from_checkpoint`, with prefill logits within the transformer
tests' atol 1e-4 (float32, reduced yi-9b); and the CLI serves a checkpoint
directory on the CPU, the config taken from its manifest.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import trainloop as JTL
from repro.engine.spec import ExperimentSpec as JSpec
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.common import tree_leaves
from repro_torch.engine import ExperimentSpec, Trainer
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(backend="mesh", arch="yi_9b", reduced=True, mode="ssgd", strategy="guided_fused",
          rho=4, lr=5e-2, seed=0, steps=2, seq_len=16, global_batch=4, workers=2)
PROMPTS = [[5, 3, 8, 1], [2, 9], [7, 7, 1, 4, 4, 2, 9]]


def _tokens(engine, request_cls):
    comps = engine.run([request_cls(p, max_new_tokens=6) for p in PROMPTS])
    return {c.request_id: c.tokens for c in comps}


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    rep = Trainer.from_spec(ExperimentSpec(**KW, ckpt_dir=d), device="cpu").fit()
    return d, rep


def test_from_checkpoint_serves_the_fits_own_params(port_ckpt):
    """Params subtree only, config rebuilt from the manifest: the restored
    params equal the fit's bit for bit, and so do the greedy tokens."""
    d, rep = port_ckpt
    eng_ckpt = ServeEngine.from_checkpoint(d, device="cpu", max_batch=2, max_len=32)
    assert eng_ckpt.cfg == ExperimentSpec(**KW).model_config()
    for a, b in zip(tree_leaves(eng_ckpt.params), tree_leaves(rep.model)):
        assert torch.equal(a, b)
    eng_live = ServeEngine(rep.model, ExperimentSpec(**KW).model_config(), max_batch=2,
                           max_len=32)
    assert _tokens(eng_ckpt, Request) == _tokens(eng_live, Request)


def test_serve_from_checkpoint_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint manifest"):
        ServeEngine.from_checkpoint(str(tmp_path / "nope"), device="cpu")


def test_a_reference_snapshot_serves_the_same_tokens_in_both_packages(tmp_path):
    """The reference's fit writes the snapshot; each package's
    from_checkpoint (config from the manifest) serves it: equal greedy
    tokens, and a prompt's prefill logits within 1e-4."""
    d = str(tmp_path)
    JTL.fit(JSpec(**KW, ckpt_dir=d), "guided_fused")
    jeng = JServeEngine.from_checkpoint(d, max_batch=2, max_len=32)
    peng = ServeEngine.from_checkpoint(d, device="cpu", max_batch=2, max_len=32)
    assert _tokens(peng, Request) == _tokens(jeng, JRequest)
    toks = np.asarray([PROMPTS[2]], np.int32)
    jl, _ = JT.prefill(jeng.params, {"tokens": jnp.asarray(toks)}, jeng.cfg, total_len=16)
    pl, _ = T.prefill(peng.params, {"tokens": torch.from_numpy(toks).long()}, peng.cfg,
                      total_len=16)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)


def test_cli_serves_a_checkpoint_dir(port_ckpt):
    """`--ckpt-dir` on the CPU: the manifest's reduced config takes the place
    of --arch yi-9b (full width), with the reference's notice."""
    d, _ = port_ckpt
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-9b", "--ckpt-dir", d,
         "--device", "cpu", "--batch", "2", "--requests", "2", "--prompt-len", "8",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "from the manifest over the CLI flags" in out.stdout
    assert f"serving training snapshot step 2 from {d}" in out.stdout
    assert "decode:" in out.stdout
