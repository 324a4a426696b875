from repro_torch.data.uci_analogs import DATASETS, load_dataset, train_test_split  # noqa: F401
