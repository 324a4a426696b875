"""repro_torch.engine — the Experiment/Trainer API over the ported backends
(sim: the numpy parameter server; scan: the torch arrival loop on the card).

    from repro_torch.engine import ExperimentSpec, Trainer

    report = Trainer.from_spec(ExperimentSpec.for_algo(
        "gSSGD", backend="scan", n_seeds=30)).fit((Xtr, ytr, n_classes, Xte, yte))
"""
from repro_torch.engine.spec import ALGOS, TOPOLOGIES, ExperimentSpec  # noqa: F401
from repro_torch.engine.strategies import (  # noqa: F401
    DelayCompensator,
    compensator_names,
    get_compensator,
    register_compensator,
)
from repro_torch.engine.trainer import Report, Trainer  # noqa: F401
