"""Serving launcher: thin client over the continuous-batching ServeEngine.

Submits synthetic requests to `repro_torch.serve.ServeEngine` on one device
(`--device`, default cuda) with weights drawn from `--seed`, and prints
per-request streams plus aggregate throughput. `--stagger` varies prompt and
generation lengths across requests so slot recycling is visible;
`--lockstep` runs the fixed-batch barriered baseline instead. `--ckpt-dir`
serves the params of a training snapshot instead of random weights; the
config its manifest records takes the place of `--arch` / `--reduced`.

Example (one H100, full-width yi-9b):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --batch 8 --requests 16 --prompt-len 1024 --gen 64 --stagger
On the CPU, at smoke-test size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --reduced \
      --device cpu --batch 2 --prompt-len 16 --gen 8
Warm start from a mesh fit's checkpoint directory:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --ckpt-dir <dir> --requests 4 --gen 8
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import Request, SamplingParams, ServeEngine, lockstep_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    ap.add_argument("--batch", type=int, default=4, help="engine slot-pool size")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--stagger", action="store_true",
                    help="heterogeneous prompt/gen lengths across requests")
    ap.add_argument("--sampling", choices=("greedy", "temperature", "topk"),
                    default="greedy")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--lockstep", action="store_true",
                    help="run the fixed-batch barriered baseline instead")
    ap.add_argument("--ckpt-dir", default="",
                    help="warm-start from a training checkpoint (full-state "
                         "snapshot; only the params subtree is restored)")
    ap.add_argument("--ckpt-step", type=int, default=0,
                    help="checkpoint step to serve (default: latest manifest entry)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ckpt_dir:
        # the manifest's recorded config is authoritative for its snapshot:
        # serving a reduced-trained checkpoint must not build the full-size
        # model because a flag was forgotten
        from repro_torch.checkpoint import model_config_from_manifest

        try:
            ckpt_cfg = model_config_from_manifest(args.ckpt_dir, args.ckpt_step or None)
        except (FileNotFoundError, ValueError):
            ckpt_cfg = None  # v1 dir / no metadata: trust the flags
        if ckpt_cfg is not None:
            if (ckpt_cfg.name, ckpt_cfg.n_layers, ckpt_cfg.d_model) != (
                    cfg.name, cfg.n_layers, cfg.d_model):
                print(f"using checkpoint config {ckpt_cfg.name} "
                      f"(layers={ckpt_cfg.n_layers}, d_model={ckpt_cfg.d_model}) "
                      f"from the manifest over the CLI flags")
            cfg = ckpt_cfg
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode")
    device = torch.device(args.device)
    params = None if args.ckpt_dir else T.model_init(
        torch.Generator(device=device).manual_seed(args.seed), cfg, device)

    n_req = args.requests or args.batch
    rng = np.random.default_rng(args.seed)
    reqs = []
    max_prompt = 0
    for i in range(n_req):
        if args.stagger:
            L = int(rng.integers(max(1, args.prompt_len // 4), args.prompt_len + 1))
            gen_len = int(rng.integers(max(1, args.gen // 4), args.gen + 1))
        else:
            L, gen_len = args.prompt_len, args.gen
        max_prompt = max(max_prompt, L)
        sp = SamplingParams(method=args.sampling, temperature=args.temperature,
                            top_k=args.top_k, seed=args.seed + i)
        prompt = rng.integers(0, cfg.vocab_size, (L,)).tolist()
        reqs.append(Request(prompt, max_new_tokens=gen_len, sampling=sp))

    max_len = max(args.prompt_len, max_prompt) + args.gen
    if args.ckpt_dir:
        engine = ServeEngine.from_checkpoint(args.ckpt_dir, cfg, step=args.ckpt_step or None,
                                             device=device, max_batch=args.batch,
                                             max_len=max_len)
        from repro_torch.checkpoint import latest_step

        print(f"serving training snapshot step "
              f"{args.ckpt_step or latest_step(args.ckpt_dir)} from {args.ckpt_dir}")
    else:
        engine = ServeEngine(params, cfg, max_batch=args.batch, max_len=max_len)

    if args.lockstep:
        comps, stats = lockstep_generate(engine, reqs)
    else:
        comps = engine.run(reqs)
        stats = engine.stats()

    print(f"device: {device}, arch {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model})")
    print(f"prefill: {stats.get('prefill_calls', len(comps))} calls, "
          f"pool={args.batch} slots, max_len={max_len}")
    print(f"decode:  {stats['decode_steps']} steps in {stats['wall_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s, occupancy {stats['occupancy']:.2f})")
    for c in sorted(comps, key=lambda c: c.request_id)[:2]:
        print(f"  request {c.request_id} ({c.prompt_len}+{c.new_tokens}, "
              f"{c.finish_reason}): {c.tokens[:16]}...")
    return comps


if __name__ == "__main__":
    main()
