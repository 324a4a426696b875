"""The paper's own experimental model: logistic regression trained with
(g)S/ASGD on tabular UCI-style datasets (Sharma 2021, Section 5)."""
from repro_torch.configs.base import ModelConfig

# Represented degenerately in ModelConfig terms; the paper-repro pipeline uses
# repro.core.parameter_server directly with a LogisticRegression model.
CONFIG = ModelConfig(
    name="paper-logreg",
    arch_type="dense",
    n_layers=1,
    d_model=8,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=2,
    param_dtype="float32",
    compute_dtype="float32",
    citation="doi:10.1016/j.asoc.2021.107084",
)
