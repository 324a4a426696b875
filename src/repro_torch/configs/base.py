"""Model / run configuration (port of `repro.configs.base`).

A copy, not an import: the reference module imports jax. Fields, defaults
and `reduced()` are kept identical so a config compares equal field by field
with the reference's; only `dtype` returns a `torch.dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    topk: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # shared dense ffn alongside experts (qwen3 style shared expert): 0 = none
    d_shared_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # layer pattern: 1 = mLSTM, 0 = sLSTM; tiled across n_layers
    pattern: tuple = (1, 0)
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256


_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # attention
    rope_theta: float = 1e6
    sliding_window: int = 0          # 0 = full attention
    causal: bool = True              # False for encoder-only (hubert)

    # hybrid (jamba): attention mixer every `attn_every` layers (else mamba);
    # MoE ffn every `moe_every` layers (else dense d_ff)
    attn_every: int = 0
    moe_every: int = 0

    # modality frontend stubs
    n_patches: int = 0               # vlm: number of precomputed patch embeddings
    audio_frontend: bool = False     # audio: input is frame embeddings, not tokens

    # ffn style: gated SwiGLU (llama lineage) vs plain GELU MLP (GPT/BERT)
    mlp_gated: bool = True

    # KV-cache storage: "native" (compute dtype) | "int8" (models.kvquant)
    kv_cache_dtype: str = "native"

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention of the training forward: "xla" | "xla_chunked" (plain torch
    # ops, differentiable) | "pallas" (the flash_attention kernel, which has
    # no backward). The serve paths always run the kernels.
    attn_impl: str = "xla"
    # remat policy of the layer stack in training: "full" checkpoints every
    # super-block (recomputed in the backward), "none" keeps activations
    remat: str = "full"

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"{self.name}: d_model {self.d_model} not divisible "
                             f"by n_heads {self.n_heads}")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not divisible "
                             f"by n_kv_heads {self.n_kv_heads}")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """True if decode at 500k tokens is sub-quadratic/bounded-memory."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def layer_is_attn(self, i: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.arch_type == "hybrid":
            return i % self.attn_every == self.attn_every // 2
        return True

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.arch_type == "hybrid":
            return i % self.moe_every == self.moe_every - 1
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 256, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (same rule as the reference)."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        d_model = max(d_model, n_heads * 32)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4, topk=min(self.moe.topk, 2), d_shared_ff=0)
        period = max(self.attn_every, self.moe_every, 1)
        n_layers = max(n_layers, period if self.arch_type == "hybrid" else n_layers)
        if self.xlstm is not None:
            n_layers = max(n_layers, len(self.xlstm.pattern))
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=4 * d_model if self.d_ff else 0,
            vocab_size=vocab,
            moe=moe,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
