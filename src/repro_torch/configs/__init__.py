"""Architecture registry of the port. Only the archs whose path is ported
have a module here; the reference's other archs raise "not yet ported"."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig  # noqa: F401

#: every arch of the reference registry (`repro.configs.ARCH_IDS`)
ARCH_IDS = [
    "llava_next_mistral_7b",
    "granite_20b",
    "minicpm_2b",
    "grok_1_314b",
    "xlstm_350m",
    "jamba_1_5_large_398b",
    "qwen3_moe_235b_a22b",
    "hubert_xlarge",
    "mistral_large_123b",
    "yi_9b",
    "paper_logreg",
]

#: the archs this port serves so far (jamba without its MoE layers); paper_logreg
#: has a module too, for the paper pipeline, which does not go through get_config
PORTED = ("yi_9b", "jamba_1_5_large_398b", "granite_20b", "minicpm_2b", "xlstm_350m")


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; ported: {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
