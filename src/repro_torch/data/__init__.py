from repro_torch.data.uci_analogs import DATASETS, load_dataset, train_test_split  # noqa: F401
from repro_torch.data.tokens import make_batch_for, synthetic_lm_batches  # noqa: F401
from repro_torch.data.prefetch import ChunkPrefetcher, batch_put, stack_blocks  # noqa: F401
