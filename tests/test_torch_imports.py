"""The port stands alone: repro_torch imports neither jax nor repro, and its
copied configuration equals the reference's."""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest

import repro_torch
from repro.configs import get_config as jax_get_config
from repro_torch.configs import PORTED, get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _port_modules()
    for must in ("repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.engine.delaysim", "repro_torch.engine.trainer",
                 "repro_torch.engine.strategies", "repro_torch.engine.spec",
                 "repro_torch.core.parameter_server", "repro_torch.core.guided",
                 "repro_torch.common.topologies", "repro_torch.data.uci_analogs",
                 "repro_torch.kernels.guided_update.ops",
                 "repro_torch.kernels.guided_update.ref", "repro_torch.models.mamba",
                 "repro_torch.kernels.selective_scan.ops",
                 "repro_torch.kernels.selective_scan.ref",
                 "repro_torch.configs.jamba_1_5_large_398b", "repro_torch.kernels.bench",
                 "repro_torch.kernels.timing", "repro_torch.common",
                 "repro_torch.core.consistency", "repro_torch.optim",
                 "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
                 "repro_torch.engine.mesh", "repro_torch.engine.trainloop",
                 "repro_torch.data.tokens", "repro_torch.data.prefetch",
                 "repro_torch.dist", "repro_torch.dist.protocol",
                 "repro_torch.dist.scenarios", "repro_torch.dist.logreg",
                 "repro_torch.dist.store", "repro_torch.dist.chief",
                 "repro_torch.dist.worker", "repro_torch.dist.launcher",
                 "repro_torch.resilience", "repro_torch.resilience.sentinel",
                 "repro_torch.resilience.supervisor", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.npz", "repro_torch.checkpoint.writer",
                 "repro_torch.checkpoint.state", "repro_torch.chaos",
                 "repro_torch.chaos.inject"):
        assert must in mods, must
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "scripts", "attention_builds.py")
    yield os.path.join(REPO, "scripts", "scan_builds.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("reduced", [False, True])
def test_yi_9b_config_equals_the_reference(reduced):
    ref, port = jax_get_config("yi-9b"), get_config("yi-9b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.d_head, port.supports_decode) == (ref.d_head, ref.supports_decode)
    assert str(port.dtype).replace("torch.", "") == str(ref.dtype)


@pytest.mark.parametrize("arch", list(PORTED) + ["paper_logreg"])
@pytest.mark.parametrize("reduced", [False, True])
def test_every_ported_config_equals_the_reference(arch, reduced):
    """Field by field, as published and `.reduced()`; paper_logreg has a copy
    for the paper pipeline though `get_config` does not serve it."""
    import importlib

    ref = jax_get_config(arch)
    port = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    if arch in PORTED:
        assert get_config(arch) is port
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.d_head, port.supports_decode) == (ref.d_head, ref.supports_decode)
    assert str(port.dtype).replace("torch.", "") == str(ref.dtype)


def test_port_registry_lists_the_reference_archs():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result."""
    if torch_cuda_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()
