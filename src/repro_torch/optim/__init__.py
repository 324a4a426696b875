from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adam,
    get_optimizer,
    momentum,
    rmsprop,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine, for_run, wsd  # noqa: F401
