"""`Trainer` — the facade over the ported backends, `Report` — its result.

    spec = ExperimentSpec(backend="scan", mode="asgd", strategy="dc_asgd",
                          topology="heavy_tail", n_seeds=30)
    report = Trainer.from_spec(spec).fit((Xtr, ytr, n_classes, Xte, yte))
    report.val_loss, report.history, report.steps_per_s

    spec = ExperimentSpec(backend="mesh", arch="yi_9b", reduced=False,
                          strategy="guided_fused", steps=20)
    report = Trainer.from_spec(spec).fit()          # synthetic LM stream
    report.final_loss, report.history, report.steps_per_s

    spec = ExperimentSpec(backend="dist", dist_mode="live", mode="asgd",
                          strategy="guided_fused", workers=10)
    report = Trainer.from_spec(spec).fit((Xtr, ytr, n_classes, Xte, yte))
    report.staleness_hist, report.dist              # observed, not scripted

backend="scan" runs the torch arrival loop (repro_torch.engine.delaysim),
backend="mesh" the transformer trainer (repro_torch.engine.trainloop) and
backend="dist" the async parameter server's chief (repro_torch.dist, real
worker processes) on `device` ("cuda" unless the caller asks for the CPU; a
missing card raises, there is no silent CPU run). backend="sim" runs the
numpy parameter server (`train_ps`) on the host, whatever `device` says.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.parameter_server import train_ps
from repro_torch.engine import delaysim
from repro_torch.engine.spec import ExperimentSpec
from repro_torch.engine.strategies import get_compensator


@dataclasses.dataclass
class Report:
    """Result of a Trainer.fit run. history: per-step dicts on the mesh
    backend ({step, loss, worker_var, corr_w}); per-arrival (t, avg_err)
    pairs on sim/scan (scan with n_seeds > 1: avg_err is an (n_seeds,) array)."""

    backend: str
    spec: ExperimentSpec
    history: list
    final: dict
    model: Any = None          # sim/scan: LogisticRegression (scan n_seeds>1: a
                               # list of them); mesh: the final params
    state: Any = None          # mesh: the final GuidedState
    wall_time_s: float = 0.0   # wall time of fit()
    steps_per_s: float = 0.0   # mesh: warm steps / warm_time_s; sim/scan: server
                               # steps (x seeds on scan) per second of fit()
    compile_time_s: float = 0.0  # mesh: the first dispatch of each chunk size
    warm_steps: int = 0        # mesh: steps outside those dispatches
    warm_time_s: float = 0.0   # mesh: wall time of the warm dispatches alone
    n_steps: int = 0           # server steps this fit ran (per seed)
    start_step: int = 0        # mesh: step resumed from (0 = fresh run)
    interrupted: bool = False  # mesh: SIGTERM cut the run short (state saved)
    staleness_hist: dict = dataclasses.field(default_factory=dict)
                               # dist: OBSERVED staleness -> count over every
                               # applied update (applied_version - read_version)
    dist: dict = dataclasses.field(default_factory=dict)
                               # dist: run diagnostics (mode, n_workers, drops,
                               # late, worker_exits, joins; with the
                               # resilience layer armed also rejections/
                               # rollbacks/supervisor counters)
    resilience: dict = dataclasses.field(default_factory=dict)
                               # mesh: sentinel outcome ({sentinel,
                               # rejected_steps}) when spec.sentinel is set

    @property
    def final_loss(self) -> Optional[float]:
        if self.backend == "mesh":
            return self.final.get("loss")
        return self.final.get("train_loss")

    @property
    def val_loss(self) -> Optional[float]:
        return self.final.get("val_loss")

    @property
    def test_accuracy(self) -> Optional[float]:
        return self.final.get("test_accuracy")


class Trainer:
    """Facade dispatching an ExperimentSpec to its backend. Construction
    resolves the strategy (unknown names fail here, not mid-fit) and checks
    the device; data preparation and training happen inside fit()."""

    def __init__(self, spec: ExperimentSpec, device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.strategy = None
        if spec.backend in ("scan", "mesh", "dist"):
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"device='cuda' but no CUDA device is available; pass "
                    f"device='cpu' to run the {spec.backend} backend on the CPU")
            self.strategy = get_compensator(spec.strategy, spec.to_guided_config())
        else:
            spec.to_ps_config()  # validates mode/strategy for the simulator

    @classmethod
    def from_spec(cls, spec: ExperimentSpec, device="cuda") -> "Trainer":
        return cls(spec, device=device)

    def fit(self, data=None, steps: Optional[int] = None,
            on_step: Optional[Callable] = None, keep_history: bool = True,
            resume: bool = False) -> Report:
        """Run the experiment.

        sim/scan/dist: `data` is (X, y, n_classes[, Xtest, ytest]); `steps`,
        `on_step` and `resume` belong to the mesh backend and are refused,
        as the reference refuses them.
        mesh: `data` is an iterable of batch dicts (None: the synthetic LM
        stream); `steps` overrides spec.steps; `on_step(step, metrics,
        params)` fires after every dispatch (see repro_torch.engine.trainloop);
        keep_history=False keeps only the final step's record; resume=True
        continues from the newest snapshot in spec.ckpt_dir (a fresh run
        when there is none)."""
        t0 = time.perf_counter()
        if self.spec.backend == "mesh":
            from repro_torch.engine import trainloop

            report = trainloop.fit(self.spec, self.strategy, data=data, steps=steps,
                                   on_step=on_step, keep_history=keep_history,
                                   resume=resume, device=self.device)
            report.wall_time_s = time.perf_counter() - t0
            if report.warm_steps > 0 and report.warm_time_s > 0:
                report.steps_per_s = report.warm_steps / report.warm_time_s
            else:
                report.steps_per_s = report.n_steps / max(report.wall_time_s, 1e-9)
            return report
        if steps is not None or on_step is not None:
            raise ValueError(
                "steps/on_step apply to the mesh backend; the sim/scan/dist "
                "backends run the paper's epoch protocol (set spec.epochs)"
            )
        if resume:
            raise ValueError(
                "resume applies to the mesh backend; sim/scan/dist runs are "
                "single fit calls with nothing to resume into"
            )
        backend = self.spec.backend
        if data is None:
            raise ValueError(f"{backend} backend needs data=(X, y, n_classes[, Xtest, ytest])")
        X, y, n_classes, *rest = data
        Xtest, ytest = (rest + [None, None])[:2]
        if backend == "sim":
            res = train_ps(X, y, n_classes, self.spec.to_ps_config(), Xtest, ytest)
        elif backend == "dist":
            from repro_torch.dist import launcher

            res = launcher.run_local(self.spec, X, y, n_classes, Xtest, ytest,
                                     strategy=self.strategy, device=self.device)
        else:
            res = delaysim.run(self.spec, X, y, n_classes, Xtest, ytest,
                               strategy=self.strategy, device=self.device)
        final = {k: res[k] for k in ("train_loss", "val_loss", "test_accuracy") if k in res}
        report = Report(backend=backend, spec=self.spec, history=res["history"],
                        final=final, model=res["model"], n_steps=res["n_steps"],
                        staleness_hist=res.get("staleness_hist", {}),
                        dist=res.get("dist", {}))
        report.wall_time_s = time.perf_counter() - t0
        report.steps_per_s = report.n_steps * self.spec.n_seeds / max(report.wall_time_s, 1e-9)
        return report
