"""repro_torch.serve — continuous-batching serving engine on one card.

    from repro_torch.serve import Request, SamplingParams, ServeEngine

    engine = ServeEngine(params, cfg, max_batch=4, max_len=256)
    engine.submit(Request(prompt, max_new_tokens=32,
                          sampling=SamplingParams(method="topk", top_k=40,
                                                  temperature=0.8, seed=1)))
    completions = engine.run()
    engine.stats()["tokens_per_s"]

`lockstep_generate` is the fixed-batch barriered baseline the engine
replaces, kept for parity tests.
"""
from repro_torch.serve.engine import (  # noqa: F401
    Completion,
    Request,
    ServeEngine,
    lockstep_generate,
)
from repro_torch.serve.sampling import SAMPLING_METHODS, SamplingParams, sample_tokens  # noqa: F401
