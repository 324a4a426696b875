"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE 16
experts top-2 on every other layer. [arXiv:2403.19887]

The port serves it without experts (`CONFIG.replace(moe=None)`): MoE is not
yet ported, so `check_ported` refuses the config as published."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, topk=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,            # 1 attention layer per 8 (1:7 attn:mamba)
    moe_every=2,             # MoE ffn on every other layer
    citation="arXiv:2403.19887",
)
