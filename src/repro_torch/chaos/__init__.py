"""Seeded chaos harness for the dist chief's self-healing layer."""
from repro_torch.chaos.inject import (  # noqa: F401
    ChaosPlan,
    slow_disk,
    truncate_newest,
)
