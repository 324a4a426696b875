"""granite-20b [dense] — IBM Granite 20B code model, llama architecture with
multi-query attention (kv=1). [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,        # BigCode/GPT-style 2-matrix GELU MLP
    sliding_window=8192,     # enables long_500k; full attention otherwise
    citation="arXiv:2405.04324",
)
