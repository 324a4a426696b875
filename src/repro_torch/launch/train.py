"""Training launcher over the port's engine API (port of `repro.launch.train`).

Every flag of the reference's CLI, plus `--device` (default cuda, as the
port's serve CLI has it). Two backends:

- `--backend mesh` (default) trains a transformer arch (full or `--reduced`)
  with a pluggable delay-compensation strategy through
  `Trainer.from_spec(spec_from_args(args))`. Checkpointing is the Trainer's:
  `--ckpt-dir/--ckpt-every/--keep-last` snapshot the full state (params and
  the guided compensation state), `--resume` restarts from the latest
  manifest entry. The port runs on one card: `--mesh` takes `local` only.
- `--backend dist` runs the real async parameter server on the paper's
  tabular datasets: a chief with its store on `--device` and worker
  processes. `--role chief` starts only the store and its listener (the
  address is printed; `--port` fixes it), `--role worker --addr host:port`
  runs one worker (`python -m repro_torch.dist.worker`, which imports no
  torch). A replay split needs every scheduled worker id, so the worker role
  also takes the worker's `--wid` (0 .. c-1); without it the chief takes the
  worker as an elastic join, which a replay schedule gives no work.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
      --device cpu --steps 6 --seq 16 --batch 4 --workers 2 --guided --rho 2 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-20b --layers 12 \
      --mode dc_asgd --steps 20 --seq 128 --batch 8 --workers 4 --rho 10
  PYTHONPATH=src python -m repro_torch.launch.train --backend dist --dataset phishing \
      --mode ssgd --guided --dist-mode replay --epochs 50 --lr 0.2 --rho 10 --batch-size 16

The worker role is resolved before anything that imports torch, so a worker
started through this CLI stays as light as `repro_torch.dist.worker`.
"""
from __future__ import annotations

import argparse
import json
import time

ROLES = ("auto", "chief", "worker")
MESHES = ("local", "host", "prod", "prod-multipod")


def parse_dist_events(text: str) -> tuple:
    """'op:wid@version,...' -> ((op, wid, version), ...); e.g.
    'restart:0@50,join:0@80' kills and respawns worker 0 at store version 50
    and joins an elastic worker at 80."""
    events = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        try:
            op, rest = part.split(":", 1)
            wid, at = rest.split("@", 1)
            events.append((op, int(wid), int(at)))
        except ValueError:
            raise SystemExit(
                f"bad --dist-events entry {part!r}; want op:wid@version "
                f"(e.g. restart:0@50)") from None
    return tuple(events)


def _resolve_strategy_mode(args):
    strategy = args.strategy
    mode = args.mode
    if mode == "dc_asgd":  # legacy spelling: execution mode asgd + Taylor strategy
        mode = "asgd"
        strategy = strategy or ("dc_asgd_guided" if args.guided else "dc_asgd")
    if not strategy:
        strategy = "guided_fused" if args.guided else "none"
    return strategy, mode


def dist_spec_from_args(args):
    from repro_torch.engine import ExperimentSpec

    strategy, mode = _resolve_strategy_mode(args)
    return ExperimentSpec(
        backend="dist",
        mode=mode,
        strategy=strategy,
        rho=args.rho,
        optimizer=args.optimizer,
        lr=args.lr,
        seed=args.seed,
        epochs=args.epochs,
        batch_size=args.batch_size,
        topology=args.topology,
        workers=args.dist_workers,
        dist_mode=args.dist_mode,
        delayed_avg=args.delayed_avg,
        dist_drop_rate=args.drop_rate,
        dist_time_scale=args.time_scale,
        dist_events=parse_dist_events(args.dist_events),
        dist_timeout=args.dist_timeout,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        keep_last=args.keep_last,
    )


def spec_from_args(args):
    from repro_torch.engine import ExperimentSpec

    strategy, mode = _resolve_strategy_mode(args)
    overrides = []
    if args.layers:
        overrides.append(("n_layers", args.layers))
    if args.d_model:
        overrides.append(("d_model", args.d_model))
    if args.d_ff:
        overrides.append(("d_ff", args.d_ff))
    return ExperimentSpec(
        backend="mesh",
        arch=args.arch,
        reduced=args.reduced,
        model_overrides=tuple(overrides),
        mode=mode,
        strategy=strategy,
        rho=args.rho,
        optimizer=args.optimizer,
        lr=args.lr,
        schedule=args.schedule,
        steps=args.steps,
        seq_len=args.seq,
        global_batch=args.batch,
        mesh=args.mesh,
        workers=args.workers,
        micro=args.micro,
        chunk_steps=args.chunk_steps,
        prefetch=args.prefetch,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        keep_last=args.keep_last,
    )


def run_dist(args):
    """The --backend dist path: real multi-process async training on the
    paper's tabular datasets. Returns the launcher's result dict."""
    from repro_torch.data import load_dataset, train_test_split
    from repro_torch.dist import launcher

    spec = dist_spec_from_args(args)
    X, y, n_classes = load_dataset(args.dataset, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, seed=spec.seed)
    t0 = time.time()
    res = launcher.run_local(spec, Xtr, ytr, n_classes, Xte, yte,
                             spawn=args.role == "auto", port=args.port, device=args.device)
    dt = time.time() - t0
    d = res["dist"]
    print(f"dist[{spec.dist_mode}] {args.dataset}: {res['n_steps']} server steps "
          f"in {dt:.1f}s ({res['n_steps'] / max(dt, 1e-9):.1f} steps/s), "
          f"val_loss {res['val_loss']:.4f}, test_acc "
          f"{res.get('test_accuracy', float('nan')):.4f}")
    print(f"observed staleness histogram: {res['staleness_hist']}")
    print(f"workers {d['n_workers']}, drops {d['drops']}, late {d['late']}, "
          f"exits {d['worker_exits']}, joins {d['joins']}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"n_steps": res["n_steps"], "val_loss": res["val_loss"],
                       "test_accuracy": res.get("test_accuracy"),
                       "staleness_hist": {str(k): v for k, v in res["staleness_hist"].items()},
                       "dist": d, "wall_time_s": dt}, f, indent=1)
    return res


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.engine import compensator_names
    from repro_torch.engine.spec import SCHEDULES

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="mesh", choices=["mesh", "dist"],
                    help="mesh: the transformer trainer (default); dist: real "
                         "multi-process async parameter server (repro_torch.dist)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer (mesh) or the chief's store (dist)")
    ap.add_argument("--arch", default="",
                    help="model architecture (required for --backend mesh)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", default="ssgd", choices=["seq", "ssgd", "asgd", "dc_asgd"])
    ap.add_argument("--guided", action="store_true",
                    help="shorthand for --strategy guided_fused")
    ap.add_argument("--strategy", default="",
                    help=f"delay-compensation strategy; registered: {', '.join(compensator_names())}")
    ap.add_argument("--rho", type=int, default=10)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--schedule", default="constant", choices=list(SCHEDULES))
    ap.add_argument("--mesh", default="local", choices=list(MESHES),
                    help="local only: the port runs on one card")
    ap.add_argument("--workers", type=int, default=0, help="logical worker count c (local mesh)")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help="K train steps a dispatch (one host read of the metrics a chunk)")
    ap.add_argument("--prefetch", action="store_true",
                    help="stage the next chunk's batches on a thread while the current one runs")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoint retention (manifest prunes older snapshots; 0 keeps all)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest manifest entry in --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    # ------------------------------------------- dist backend (repro_torch.dist)
    ap.add_argument("--role", default="auto", choices=list(ROLES),
                    help="auto: chief spawns its own workers; chief: listen "
                         "only (workers launched separately); worker: run one "
                         "worker against --addr")
    ap.add_argument("--addr", default="", help="chief address host:port (--role worker)")
    ap.add_argument("--port", type=int, default=0, help="chief listen port (0 = ephemeral)")
    ap.add_argument("--dataset", default="pima",
                    help="tabular dataset for --backend dist (repro_torch.data)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--topology", default="",
                    help="delay/worker-speed topology ('' = mode default)")
    ap.add_argument("--dist-mode", default="replay", choices=["replay", "live"],
                    help="replay: deterministic schedule-granted interleaving "
                         "(parity oracle); live: free-running asynchrony with "
                         "observed staleness + fault injection")
    ap.add_argument("--dist-workers", type=int, default=0,
                    help="worker processes (0 = the schedule's c = rho)")
    ap.add_argument("--delayed-avg", action="store_true",
                    help="DaSGD-style delayed averaging: overlap push/pull "
                         "with the next local step, merge on reply (live)")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="fraction of pushes the chief drops (live)")
    ap.add_argument("--time-scale", type=float, default=0.0,
                    help="seconds per sampled compute-time unit (live; 0 = full speed)")
    ap.add_argument("--dist-events", default="",
                    help="fault plan op:wid@version,... with op in "
                         "kill|restart|join (live), e.g. restart:0@50")
    ap.add_argument("--dist-timeout", type=float, default=120.0,
                    help="watchdog: max seconds without store progress")
    return ap


def _worker_role(argv):
    """(True, rc) when argv asks for --role worker, which then runs here
    without importing torch; (False, None) otherwise."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--role", default="auto", choices=list(ROLES))
    pre.add_argument("--addr", default="")
    pre.add_argument("--wid", type=int, default=None)
    known, _ = pre.parse_known_args(argv)
    if known.role != "worker":
        return False, None
    if not known.addr:
        raise SystemExit("--role worker needs --addr host:port")
    from repro_torch.dist.worker import main as worker_main

    wid = [] if known.wid is None else ["--wid", str(known.wid)]
    return True, worker_main(["--addr", known.addr] + wid)


def main(argv=None):
    is_worker, rc = _worker_role(argv)
    if is_worker:
        return rc
    args = build_parser().parse_args(argv)
    if args.backend == "dist":
        return run_dist(args)
    if not args.arch:
        raise SystemExit("--backend mesh needs --arch")
    if args.mesh != "local":
        raise SystemExit(f"--mesh {args.mesh}: the port runs on one card (engine.mesh.build_ctx "
                         "takes 'local' only); sharded meshes wait for the sharding rules")

    from repro_torch.engine import Trainer
    from repro_torch.engine.trainloop import step_records

    spec = spec_from_args(args)
    trainer = Trainer.from_spec(spec, device=args.device)

    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume needs --ckpt-dir")
        from repro_torch.checkpoint import latest_step

        at = latest_step(args.ckpt_dir)
        print(f"resuming from step {at} in {args.ckpt_dir}" if at is not None
              else f"no checkpoint in {args.ckpt_dir}; starting fresh")

    history = []
    t0 = time.time()

    def on_step(step, m, params):
        # m holds the dispatch's metrics: per-step scalars (chunk_steps=1) or
        # stacked (k,) tensors with step = the chunk's last step; only the log
        # steps inside the window are read to the host
        k = m["loss"].numel()
        first = step - k + 1
        logged = [i for i in range(k)
                  if (first + i) % args.log_every == 0 or first + i == args.steps - 1]
        for rec in step_records(m, first, logged):
            history.append(rec)
            print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                  f"worker_var {rec['worker_var']:.2e} "
                  f"corr_w {rec['corr_w']:.2f} ({time.time() - t0:.1f}s)")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            print(f"checkpoint enqueued at step {step + 1}")

    report = trainer.fit(on_step=on_step, keep_history=False, resume=args.resume)

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    if report.interrupted:
        print(f"interrupted by SIGTERM at step {report.start_step + report.n_steps}; "
              f"full state saved to {args.ckpt_dir} — rerun with --resume")
    if report.warm_steps:
        print(f"throughput: {report.steps_per_s:.1f} steps/s warm "
              f"(first dispatch of each chunk size: {report.compile_time_s:.2f}s)")
    if history:
        print(f"done: final loss {history[-1]['loss']:.4f}")
    else:  # resumed at (or past) the final step: nothing left to run
        print(f"done: no steps to run (resumed at step {report.start_step})")
    return history


if __name__ == "__main__":
    main()
