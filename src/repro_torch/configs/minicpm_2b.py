"""minicpm-2b [dense] — MiniCPM 2.4B, llama-like, trained with the WSD
(warmup-stable-decay) schedule which repro.optim.schedules implements.
[arXiv:2404.06395]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    sliding_window=8192,
    citation="arXiv:2404.06395",
)
