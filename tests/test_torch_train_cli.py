"""The port's train CLI (`repro_torch.launch.train`) and step shim against
the reference's (`repro.launch.train`, `repro.train`), on the CPU.

- both CLIs parse one argv to the same namespace and the same spec, for the
  mesh and the dist backends;
- `python -m repro_torch.launch.train --arch minicpm-2b --reduced --device
  cpu` exits 0, as tests/test_system.py runs the reference's;
- a mesh snapshot crosses between the CLIs: one package's CLI writes it, the
  other's `--resume` continues within 1e-5 (the mesh bar of
  test_torch_mesh.py) of the writer's own resumed run, chunk_steps 1 (the
  reference's chunked loop drifts, ROADMAP "State of the reference");
- `--backend dist --dist-mode replay` equals `Trainer(backend="dist")` on
  the same spec, and the `--role chief` / `--role worker` split replays bit
  for bit like `--role auto`;
- `step_records` with `indices` reads only the chosen steps, as the
  reference's does.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.engine import trainloop as JTL
from repro.launch import train as jtrain
from repro_torch.data import load_dataset, train_test_split
from repro_torch.engine import Trainer
from repro_torch.engine import trainloop as PTL
from repro_torch.launch import train as ptrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ENV = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}

MESH_ARGVS = [
    ["--arch", "yi-9b", "--reduced", "--steps", "6", "--mode", "ssgd", "--guided"],
    ["--arch", "granite-20b", "--layers", "12", "--mode", "dc_asgd", "--steps", "20",
     "--seq", "128", "--batch", "8", "--workers", "4", "--rho", "10"],
    ["--arch", "minicpm-2b", "--mode", "ssgd", "--guided", "--schedule", "wsd", "--steps", "20",
     "--seq", "128", "--batch", "8", "--workers", "4", "--rho", "10", "--chunk-steps", "4",
     "--prefetch", "--ckpt-dir", "/x", "--ckpt-every", "10", "--keep-last", "0"],
    ["--arch", "xlstm-350m", "--mode", "asgd", "--strategy", "gap_aware", "--optimizer", "adam",
     "--d-model", "512", "--d-ff", "1024", "--micro", "2", "--lr", "0.01", "--seed", "3"],
]
DIST_ARGVS = [
    ["--backend", "dist", "--dataset", "phishing", "--mode", "ssgd", "--guided",
     "--dist-mode", "replay", "--epochs", "50", "--lr", "0.2", "--rho", "10",
     "--batch-size", "16"],
    ["--backend", "dist", "--dataset", "pima", "--mode", "asgd", "--strategy", "dc_asgd",
     "--dist-mode", "live", "--dist-workers", "4", "--dist-events", "restart:0@50,join:0@80",
     "--time-scale", "0.005", "--drop-rate", "0.1", "--delayed-avg", "--topology", "hetero",
     "--dist-timeout", "30"],
]


# the reference's spec builders, kept before any test patches them
J_SPEC = {False: jtrain.spec_from_args, True: jtrain.dist_spec_from_args}


class _Captured(Exception):
    pass


def _reference_args(monkeypatch, argv, name):
    """The namespace the reference's main hands to `name` for argv."""
    seen = {}

    def capture(args):
        seen["args"] = args
        raise _Captured

    monkeypatch.setattr(jtrain, name, capture)
    with pytest.raises(_Captured):
        jtrain.main(argv)
    return seen["args"]


@pytest.mark.parametrize("argv", MESH_ARGVS + DIST_ARGVS)
def test_both_clis_parse_to_the_same_spec(monkeypatch, argv):
    dist = "dist" in argv
    jargs = _reference_args(monkeypatch, argv, "run_dist" if dist else "spec_from_args")
    pargs = ptrain.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(pargs).items() if k != "device"} == vars(jargs)
    assert pargs.device == "cuda"
    jspec = J_SPEC[dist](jargs)
    pspec = (ptrain.dist_spec_from_args if dist else ptrain.spec_from_args)(pargs)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    if dist:
        assert ptrain.parse_dist_events(pargs.dist_events) == \
            jtrain.parse_dist_events(jargs.dist_events)


def test_cli_refuses_what_the_port_does_not_run():
    with pytest.raises(SystemExit, match="one card"):
        ptrain.main(["--arch", "yi-9b", "--reduced", "--mesh", "host", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --arch"):
        ptrain.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --addr"):
        ptrain.main(["--role", "worker"])
    with pytest.raises(SystemExit, match="bad --dist-events"):
        ptrain.parse_dist_events("restart0@5")


def test_cli_exits_0_on_the_cpu(tmp_path):
    out = tmp_path / "hist.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm-2b",
                        "--reduced", "--device", "cpu", "--steps", "4", "--log-every", "1",
                        "--metrics-out", str(out)],
                       env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: final loss" in r.stdout
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)


RESUME_ARGV = ["--arch", "xlstm-350m", "--reduced", "--seq", "16", "--batch", "4",
               "--workers", "2", "--guided", "--rho", "2", "--lr", "0.01", "--log-every", "1",
               "--ckpt-every", "2", "--chunk-steps", "1", "--seed", "1"]


def _run(cli, ckpt, steps, out, resume=False, device=()):
    argv = RESUME_ARGV + ["--ckpt-dir", str(ckpt), "--steps", str(steps),
                          "--metrics-out", str(out)] + list(device)
    cli.main(argv + (["--resume"] if resume else []))
    return json.loads(out.read_text())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_crosses_between_the_clis(tmp_path, writer):
    """xlstm-350m reduced (its f32 gate leaves in a bf16-free f32 model):
    4 steps written by one CLI, resumed to 7 by both."""
    cli = {"reference": jtrain, "port": ptrain}
    cpu = {"reference": (), "port": ("--device", "cpu")}
    reader = "port" if writer == "reference" else "reference"
    first = tmp_path / "first"
    _run(cli[writer], first, 4, tmp_path / "a.json", device=cpu[writer])
    import shutil

    second = tmp_path / "second"
    shutil.copytree(first, second)
    own = _run(cli[writer], first, 7, tmp_path / "b.json", resume=True, device=cpu[writer])
    other = _run(cli[reader], second, 7, tmp_path / "c.json", resume=True, device=cpu[reader])
    assert [h["step"] for h in own] == [h["step"] for h in other] == [4, 5, 6]
    for a, b in zip(own, other):
        for k in ("loss", "worker_var", "corr_w"):
            assert abs(a[k] - b[k]) <= 1e-5, (a, b)


DIST_SMALL = ["--backend", "dist", "--dataset", "new_thyroid", "--mode", "ssgd", "--guided",
              "--dist-mode", "replay", "--epochs", "3", "--rho", "2", "--lr", "0.05",
              "--device", "cpu"]


def test_dist_replay_cli_equals_the_trainer(tmp_path):
    out = tmp_path / "m.json"
    res = ptrain.main(DIST_SMALL + ["--metrics-out", str(out)])
    args = ptrain.build_parser().parse_args(DIST_SMALL)
    X, y, k = load_dataset("new_thyroid", seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=0)
    rep = Trainer.from_spec(ptrain.dist_spec_from_args(args), device="cpu").fit(
        (Xtr, ytr, k, Xte, yte))
    assert res["n_steps"] == rep.n_steps > 0
    assert res["val_loss"] == rep.val_loss
    assert len(res["history"]) == len(rep.history)
    for a, b in zip(res["history"], rep.history):
        np.testing.assert_array_equal(np.asarray(a, dtype=object).astype(float),
                                      np.asarray(b, dtype=object).astype(float))
    saved = json.loads(out.read_text())
    assert saved["val_loss"] == res["val_loss"] and saved["n_steps"] == res["n_steps"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_chief_and_worker_roles_replay_like_auto(tmp_path):
    """The chief in one process (`--role chief --port p`), its 2 workers in
    two more (`--role worker --addr --wid`): the replay's metrics equal
    --role auto's bit for bit."""
    auto = tmp_path / "auto.json"
    ptrain.main(DIST_SMALL + ["--metrics-out", str(auto)])
    split = tmp_path / "split.json"
    port = _free_port()
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    chief = subprocess.Popen(cmd + DIST_SMALL + ["--role", "chief", "--port", str(port),
                                                 "--metrics-out", str(split)],
                             env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    workers = [subprocess.Popen(cmd + ["--role", "worker", "--addr", f"localhost:{port}",
                                       "--wid", str(w)],
                                env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True) for w in range(2)]
    try:
        out, err = chief.communicate(timeout=60)
        assert chief.returncode == 0, err[-2000:]
        for w in workers:
            w.communicate(timeout=60)
            assert w.returncode == 0
    finally:
        for p in [chief] + workers:
            if p.poll() is None:
                p.kill()
    assert "dist chief listening on" in out
    a, b = json.loads(auto.read_text()), json.loads(split.read_text())
    assert (b["n_steps"], b["val_loss"], b["test_accuracy"], b["staleness_hist"]) == \
        (a["n_steps"], a["val_loss"], a["test_accuracy"], a["staleness_hist"])


def test_worker_role_imports_no_torch():
    """`--role worker` is resolved before the parser that imports the engine."""
    code = ("import sys; from repro_torch.launch import train as t\n"
            "try:\n    t.main(['--role', 'worker'])\nexcept SystemExit:\n    pass\n"
            "print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stderr[-2000:]


@pytest.mark.parametrize("k,indices", [(1, None), (4, None), (4, [1, 3]), (4, []), (3, [0])])
def test_step_records_reads_the_chosen_steps(k, indices):
    rng = np.random.default_rng(k)
    vals = {key: rng.standard_normal(k).astype(np.float32) if k > 1
            else np.float32(rng.standard_normal())
            for key in ("loss", "worker_loss_var", "corr_weight_sum")}
    want = JTL.step_records({n: jax.numpy.asarray(v) for n, v in vals.items()}, 7, indices)
    got = PTL.step_records({n: torch.tensor(v) for n, v in vals.items()}, 7, indices)
    assert got == want
    assert [r["step"] for r in got] == [7 + i for i in (range(k) if indices is None else indices)]


def test_step_shim_equals_the_engine():
    """`repro_torch.train`: make_train_state / build_train_step delegate to
    engine.mesh (the same state and step bit for bit), and the serve-step
    builders to models.transformer."""
    from repro_torch.common import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.guided import GuidedConfig
    from repro_torch.data import make_batch_for
    from repro_torch.engine import mesh as PM
    from repro_torch.models import transformer as T
    from repro_torch.optim import constant, get_optimizer
    from repro_torch import train as shim

    cfg = get_config("granite-20b").reduced()
    gcfg, opt = GuidedConfig(rho=2), get_optimizer("sgd")

    def state(fn):
        return fn(torch.Generator().manual_seed(0), cfg, gcfg, opt, 2, device="cpu")

    (p1, g1), (p2, g2) = state(shim.make_train_state), state(PM.init_train_state)
    batch = {k: torch.from_numpy(v) for k, v in make_batch_for(cfg, 16, 4, seed=0).items()}
    out = [shim.build_train_step(cfg, gcfg, opt, constant(1e-2), n_workers=2)(p1, g1, batch),
           PM.build_train_step(cfg, gcfg, opt, constant(1e-2), n_workers=2)(p2, g2, batch)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])))
    assert float(out[0][2]["loss"]) == float(out[1][2]["loss"])
    toks = batch["tokens"][:2, :8].long()
    l1, c1 = shim.build_prefill_step(cfg)(out[0][0], {"tokens": toks})
    l2, c2 = T.prefill(out[0][0], {"tokens": toks}, cfg)
    assert torch.equal(l1, l2)
    nxt = toks[:, :1]
    d1, _ = shim.build_decode_step(cfg)(out[0][0], c1, nxt, 8)
    d2, _ = T.decode_step(out[0][0], c2, nxt, 8, cfg)
    assert torch.equal(d1, d2)
    assert isinstance(shim.TrainFns(train_step=None, init_fn=None), tuple)
