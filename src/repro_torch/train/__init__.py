from repro_torch.train.steps import (  # noqa: F401
    TrainFns,
    build_decode_step,
    build_prefill_step,
    build_train_step,
    make_train_state,
)
