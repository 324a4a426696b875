"""Per-request token sampling for the serve engine (port of `repro.serve.sampling`).

`sample_tokens` handles the whole slot pool in one call: each row carries
its own temperature, top_k and `torch.Generator` (seeded from the request's
`SamplingParams.seed`, advanced once per sampled token of a stochastic row).
Greedy rows (temperature 0) take the f32 argmax and draw nothing.

The draws cannot match the reference's bits: `jax.random` keys and
`torch.Generator`s are different generators. Greedy tokens match exactly;
stochastic tokens match in distribution, and repeat for one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

SAMPLING_METHODS = ("greedy", "temperature", "topk")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    method: "greedy" | "temperature" | "topk". temperature applies to both
    stochastic methods; top_k > 0 restricts the draw to the k highest logits
    (required for method="topk"). seed seeds the request's generator.
    """

    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.method not in SAMPLING_METHODS:
            raise ValueError(
                f"unknown sampling method {self.method!r}; known: {SAMPLING_METHODS}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.method == "topk" and self.top_k <= 0:
            raise ValueError(f"method='topk' needs top_k > 0, got {self.top_k}")

    @property
    def eff_temperature(self) -> float:
        """Temperature as the sampler sees it: 0 selects greedy."""
        return 0.0 if self.method == "greedy" else self.temperature

    @property
    def eff_top_k(self) -> int:
        """top_k as the sampler sees it: 0 = full vocabulary."""
        return self.top_k if self.method == "topk" else 0

    def generator(self, device) -> Optional[torch.Generator]:
        """A fresh generator for this request (None for greedy)."""
        if self.eff_temperature <= 0:
            return None
        return torch.Generator(device=device).manual_seed(self.seed)


def sample_tokens(logits, generators: Sequence[Optional[torch.Generator]],
                  temperature: Sequence[float], top_k: Sequence[int]):
    """One token per pool row. logits (B, V) on the device; generators,
    temperature and top_k are per-row host values. Returns (B,) int64 on the
    logits' device, without a host sync.

    Per row: greedy is argmax in f32; otherwise logits below the top_k-th
    largest are masked (ties with it kept, top_k <= 0 keeps all), the rest
    divided by max(T, 1e-6) and one token drawn from the row's generator."""
    lg = logits.float()
    tokens = torch.argmax(lg, dim=-1)
    V = lg.shape[-1]
    for i, temp in enumerate(temperature):
        if temp <= 0.0:
            continue
        row = lg[i]
        k = int(top_k[i])
        if k > 0:
            kth = torch.topk(row, min(k, V)).values[-1]
            row = torch.where(row >= kth, row, torch.full_like(row, float("-inf")))
        probs = torch.softmax(row / max(float(temp), 1e-6), dim=-1)
        tokens[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    return tokens
