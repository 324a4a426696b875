"""xlstm-350m [ssm] — xLSTM with alternating sLSTM + mLSTM blocks.
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                  # xLSTM blocks carry their own projections
    vocab_size=50304,
    xlstm=XLSTMConfig(pattern=(1, 0)),  # (mLSTM, sLSTM) alternating
    citation="arXiv:2405.04517",
)
