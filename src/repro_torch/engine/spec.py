"""`ExperimentSpec` — the fields of `repro.engine.spec.ExperimentSpec` that
the sim, scan, mesh and dist backends read, with the reference's names,
defaults and construction-time validation.

    backend="sim"  — the numpy event-driven parameter server
                     (`PSConfig` + `train_ps`, repro_torch.core.parameter_server);
    backend="scan" — the torch arrival loop (repro_torch.engine.delaysim):
                     the same trajectories as the sim to float64 round-off,
                     `n_seeds` seeds batched, delay topologies via `topology`;
    backend="mesh" — the strategy-hooked transformer trainer
                     (repro_torch.engine.mesh / trainloop) on one card;
    backend="dist" — the async parameter server (repro_torch.dist): a chief
                     applying real worker processes' pushes on the card,
                     replayed against the schedule or free-running (`dist_*`
                     fields), with the resilience knobs of its live mode.

`ckpt_dir`, `ckpt_every`, `keep_last` and `sentinel` are validated as the
reference validates them; the mesh fit and the dist chief honour them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.guided import GuidedConfig
from repro_torch.core.parameter_server import PSConfig

BACKENDS = ("mesh", "sim", "scan", "dist")
MODES = ("seq", "ssgd", "asgd")

# every optimizer the reference implements
OPTIMIZERS = ("sgd", "momentum", "rmsprop", "adagrad", "adam")
# the numpy parameter-server reference (_Server._apply) only implements these;
# the scan backend runs all of OPTIMIZERS (momentum/adam via the fused kernels)
SIM_OPTIMIZERS = ("sgd", "rmsprop", "adagrad")

# Delay topologies of the scan backend: name -> execution modes it is defined
# for. seq/barrier are the deterministic topologies implied by those modes;
# the event-queue ones need mode="asgd" (heterogeneous per-arrival staleness).
TOPOLOGIES = {
    "seq": ("seq",),
    "barrier": ("ssgd",),
    "exp": ("asgd",),          # train_ps's literal exponential compute times
    "constant": ("asgd",),     # fixed compute time -> round-robin, s = c-1
    "heavy_tail": ("asgd",),   # Pareto compute times (rare huge delays)
    "straggler": ("asgd",),    # one worker 10x slower than the rest
    "hetero": ("asgd",),       # per-worker mean compute time grows with rank
}

_DEFAULT_TOPOLOGY = {"seq": "seq", "ssgd": "barrier", "asgd": "exp"}

# mesh-backend lr schedules (resolved by repro_torch.optim.schedules.for_run)
SCHEDULES = ("constant", "wsd", "cosine")

# dist-backend execution disciplines (repro_torch.dist):
#   replay — real worker processes, scheduled interleaving: the chief grants
#            pulls/pushes against the extracted DelaySchedule, so the run is
#            deterministic and parity-checkable against backend="scan".
#   live   — free-running asynchrony: staleness is observed, not scripted;
#            the fault-injection knobs (events, drop rate, slowdowns) and
#            DaSGD delayed averaging only exist here.
DIST_MODES = ("replay", "live")

# fault-injection event verbs: ("kill", wid, at_version) terminates worker
# wid's process once the store reaches at_version; "restart" kills AND
# respawns it; "join" spawns an additional elastic worker (wid ignored).
DIST_EVENT_OPS = ("kill", "restart", "join")

# divergence-sentinel screening levels (repro_torch.resilience):
#   ""       — off (the default)
#   "finite" — reject non-finite gradients (NaN/Inf never reach W); on the
#              mesh, a step whose loss is not finite
#   "full"   — "finite" plus a norm-explosion screen (vs a running norm EMA)
#              on the chief; on the mesh, also a step that leaves a param
#              leaf non-finite or whose loss spikes past factor x the last
#              average loss
SENTINELS = ("", "finite", "full")

# algorithm names as printed in the paper's tables -> (mode, strategy, optimizer)
ALGOS = {
    "SGD": ("seq", "none", "sgd"),
    "gSGD": ("seq", "guided_fused", "sgd"),
    "SSGD": ("ssgd", "none", "sgd"),
    "gSSGD": ("ssgd", "guided_fused", "sgd"),
    "ASGD": ("asgd", "none", "sgd"),
    "gASGD": ("asgd", "guided_fused", "sgd"),
    "SRMSprop": ("ssgd", "none", "rmsprop"),
    "gSRMSprop": ("ssgd", "guided_fused", "rmsprop"),
    "SAdagrad": ("ssgd", "none", "adagrad"),
    "gSAdagrad": ("ssgd", "guided_fused", "adagrad"),
    "DC-ASGD": ("asgd", "dc_asgd", "sgd"),
}

_GUIDED_STRATEGIES = ("guided_fused", "guided_two_pass", "dc_asgd_guided")
_DC_STRATEGIES = ("dc_asgd", "dc_asgd_guided")

# Strategies that compensate against w_stale and therefore only make sense
# under asgd execution; the registry classes raise the same message.
_STALE_REQUIRED = {
    "dc_asgd": "compensates with the Taylor term g*g*(W - w_stale)",
    "dc_asgd_guided": "compensates with the Taylor term g*g*(W - w_stale)",
    "gap_aware": "dampens by |W - w_stale|",
}


def needs_stale_message(strategy: str, why: str, mode: str) -> str:
    """The one error message for strategy/mode incompatibility — shared by
    ExperimentSpec.__post_init__ and the DelayCompensator registry classes."""
    return (f"{strategy} {why} and needs stale weights: "
            f"use mode='asgd' (got mode={mode!r})")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment of the paper's algorithm family (sim, scan and mesh
    fields)."""

    backend: str = "mesh"          # mesh | sim | scan | dist
    # ------------------------------------------------- shared algorithm knobs
    mode: str = "ssgd"             # seq | ssgd | asgd (execution/delay model)
    strategy: str = "none"         # DelayCompensator registry name
    rho: int = 10                  # delay tolerance / correction period
    max_consistent: int = 4        # paper: replay at most 4 mini-batches
    optimizer: str = "sgd"
    lr: float = 0.2                # paper Table 1 default
    seed: int = 0
    # ------------------------------------------------------ sim / scan knobs
    epochs: int = 50
    batch_size: int = 16
    verification_frac: float = 0.2
    rmsprop_beta: float = 0.9
    eps: float = 1e-8
    topology: str = ""             # scan: TOPOLOGIES key ("" -> mode default)
    n_seeds: int = 1               # scan: batch seeds seed..seed+n_seeds-1
    # ------------------------------------------------------------ dist knobs
    dist_mode: str = "replay"      # replay | live (DIST_MODES)
    delayed_avg: bool = False      # live: DaSGD-style push/pull overlap + merge
    dist_drop_rate: float = 0.0    # live: chief drops this fraction of pushes
    dist_time_scale: float = 0.0   # live: seconds per sampled compute-time unit
                                   # (0 -> workers never sleep; full speed)
    dist_events: tuple = ()        # live: ((op, wid, at_version), ...) faults
    dist_timeout: float = 120.0    # watchdog: max seconds without progress
    # ------------------------------------------------------------ mesh knobs
    arch: str = "yi_9b"
    reduced: bool = True
    model_overrides: tuple = ()    # (("n_layers", 2), ...) applied to the cfg
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    schedule: str = "constant"     # constant | wsd | cosine
    warmup: int = 10
    mesh: str = "local"            # local (the others are not ported)
    workers: int = 0               # paper's c; 0 -> data shards of the mesh (1)
                                   # (dist: worker PROCESSES; 0 -> schedule's c)
    micro: int = 1                 # gradient-accumulation microbatches
    staleness: int = 0             # asgd: w_stale refresh period (0 -> rho)
    chunk_steps: int = 1           # K steps per dispatch (1 -> per-step loop)
    prefetch: bool = False         # stage the next batch block on a thread
    dc_lambda: float = 0.04
    correction_scale: float = 1.0
    magnitude_weight: float = 0.1
    # ------------------- checkpointing (the dist chief; mesh: not ported)
    ckpt_dir: str = ""             # "" -> checkpointing off
    ckpt_every: int = 0            # periodic snapshot cadence (steps)
    keep_last: int = 3             # manifest retention (0 -> keep everything)
    # --------------------------------- resilience (repro_torch.resilience)
    sentinel: str = ""             # SENTINELS level: "" | finite | full
    sentinel_factor: float = 10.0  # spike/norm explosion multiplier vs the
                                   # previous average loss (mesh) / norm EMA (dist)
    rollback: bool = False         # dist live: on post-apply divergence,
                                   # restore the last VERIFIED snapshot + lr
                                   # backoff instead of failing the run
    max_rollbacks: int = 3         # rollback budget before the run is fatal
    lr_backoff: float = 0.5        # lr scale multiplied in at every rollback
    quarantine_steps: int = 0      # dist live: versions a misbehaving worker's
                                   # pushes are ignored for (0 -> never)
    quarantine_after: int = 3      # consecutive rejections that trigger it
    dist_supervise: bool = True    # live: supervisor thread respawns dead
                                   # worker processes (capped backoff+jitter);
                                   # ignored by replay (death is fatal there)
    dist_lease_s: float = 0.0      # heartbeat lease: a worker silent this long
                                   # is presumed hung and killed/respawned
                                   # (0 -> process-death detection only)
    dist_max_respawns: int = 3     # per-worker respawn budget before eviction

    def __post_init__(self):
        assert self.backend in BACKENDS, self.backend
        assert self.mode in MODES, self.mode
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; known: {', '.join(SCHEDULES)}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}; known: {', '.join(OPTIMIZERS)}")
        if self.backend in ("sim", "dist") and self.optimizer not in SIM_OPTIMIZERS:
            raise ValueError(
                f"optimizer {self.optimizer!r} has no numpy server apply rule "
                f"(backend={self.backend!r} supports {', '.join(SIM_OPTIMIZERS)}); "
                f"use backend='mesh' or backend='scan' for momentum/adam")
        if self.ckpt_every < 0 or self.keep_last < 0:
            raise ValueError(
                f"ckpt_every/keep_last must be >= 0 "
                f"(got {self.ckpt_every}/{self.keep_last})")
        if self.ckpt_every and not self.ckpt_dir:
            raise ValueError(
                f"ckpt_every={self.ckpt_every} needs ckpt_dir (where should "
                f"the snapshots go?)")
        if self.chunk_steps < 1:
            raise ValueError(
                f"chunk_steps must be >= 1 (got {self.chunk_steps}); 1 runs "
                f"the per-step loop, K > 1 fuses K steps per dispatch")
        # strategy/mode compatibility fails here, at construction, with the
        # registry's message — not mid-fit.
        why = _STALE_REQUIRED.get(self.strategy)
        if why is not None and self.mode != "asgd":
            raise ValueError(needs_stale_message(self.strategy, why, self.mode))
        if self.n_seeds < 1:
            raise ValueError(f"n_seeds must be >= 1 (got {self.n_seeds})")
        if self.n_seeds > 1 and self.backend != "scan":
            raise ValueError(
                f"n_seeds={self.n_seeds} needs the batched scan backend; "
                f"backend={self.backend!r} runs one seed per fit"
            )
        if self.topology:
            if self.topology not in TOPOLOGIES:
                raise ValueError(
                    f"unknown topology {self.topology!r}; known: "
                    f"{', '.join(TOPOLOGIES)}"
                )
            if self.backend not in ("scan", "dist"):
                raise ValueError(
                    f"topology={self.topology!r} is a scan/dist-backend knob "
                    f"(backend={self.backend!r} hardcodes its delay model)"
                )
            if self.mode not in TOPOLOGIES[self.topology]:
                raise ValueError(
                    f"topology {self.topology!r} is defined for mode(s) "
                    f"{TOPOLOGIES[self.topology]}, got mode={self.mode!r}"
                )
        # ---- dist-backend rules: fail at construction, not mid-launch
        if self.dist_mode not in DIST_MODES:
            raise ValueError(
                f"unknown dist_mode {self.dist_mode!r}; known: {', '.join(DIST_MODES)}")
        faults = (self.delayed_avg or self.dist_drop_rate or self.dist_time_scale
                  or self.dist_events)
        if self.backend == "dist":
            if self.dist_mode == "live" and self.mode != "asgd":
                raise ValueError(
                    f"dist_mode='live' IS free-running asynchronous execution: "
                    f"use mode='asgd' (got mode={self.mode!r})")
            if faults and self.dist_mode != "live":
                raise ValueError(
                    "delayed_avg / dist_drop_rate / dist_time_scale / "
                    "dist_events need dist_mode='live' (replay is the "
                    "deterministic parity oracle — no faults there)")
            for ev in self.dist_events:
                if len(ev) != 3 or ev[0] not in DIST_EVENT_OPS:
                    raise ValueError(
                        f"bad dist event {ev!r}; want (op, wid, at_version) "
                        f"with op in {DIST_EVENT_OPS}")
            if not (0.0 <= self.dist_drop_rate < 1.0):
                raise ValueError(
                    f"dist_drop_rate must be in [0, 1) (got {self.dist_drop_rate})")
        elif faults:
            raise ValueError(
                "delayed_avg / dist_drop_rate / dist_time_scale / dist_events "
                f"are dist-backend knobs (backend={self.backend!r})")
        # ---- resilience rules
        if self.sentinel not in SENTINELS:
            raise ValueError(
                f"unknown sentinel {self.sentinel!r}; known: "
                f"{', '.join(repr(s) for s in SENTINELS)}")
        if self.sentinel_factor <= 1.0:
            raise ValueError(
                f"sentinel_factor must be > 1 (got {self.sentinel_factor}): "
                f"it multiplies the previous loss / norm EMA into a threshold")
        if self.sentinel and self.backend not in ("mesh", "dist"):
            raise ValueError(
                f"sentinel={self.sentinel!r} screens the mesh carry or the "
                f"dist chief's push path (backend={self.backend!r} has "
                f"neither)")
        if self.sentinel and self.backend == "dist" and self.dist_mode != "live":
            raise ValueError(
                "sentinel screening on the dist backend needs "
                "dist_mode='live' (replay is the deterministic parity "
                "oracle — rejecting pushes would break the schedule)")
        remediation = self.rollback or self.quarantine_steps
        if remediation and not (self.backend == "dist"
                                and self.dist_mode == "live"):
            raise ValueError(
                "rollback / quarantine_steps remediate the live chief's "
                f"store (backend={self.backend!r}, "
                f"dist_mode={self.dist_mode!r})")
        if remediation and not self.sentinel:
            raise ValueError(
                "rollback / quarantine_steps need a sentinel level to "
                "detect divergence first (set sentinel='finite' or 'full')")
        if self.max_rollbacks < 0 or self.quarantine_steps < 0:
            raise ValueError(
                f"max_rollbacks/quarantine_steps must be >= 0 "
                f"(got {self.max_rollbacks}/{self.quarantine_steps})")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1] (got {self.lr_backoff})")
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1 (got {self.quarantine_after})")
        if self.dist_lease_s < 0 or self.dist_max_respawns < 0:
            raise ValueError(
                f"dist_lease_s/dist_max_respawns must be >= 0 "
                f"(got {self.dist_lease_s}/{self.dist_max_respawns})")

    @property
    def resolved_topology(self) -> str:
        """The schedule topology this spec runs (mode default when unset)."""
        return self.topology or _DEFAULT_TOPOLOGY[self.mode]

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ conversions
    @property
    def guided(self) -> bool:
        return self.strategy in _GUIDED_STRATEGIES

    def to_ps_config(self) -> PSConfig:
        """Lower to the numpy simulator's config. Any guided_* strategy maps to
        the paper's literal replay (the sim has exactly one guided path);
        staleness-Taylor strategies have no sim equivalent."""
        if self.strategy not in ("none", "guided_fused", "guided_two_pass"):
            raise ValueError(
                f"strategy {self.strategy!r} has no parameter-server simulation; "
                "use backend='mesh' or backend='scan'"
            )
        return self.to_schedule_config()

    def to_schedule_config(self, seed: int = None) -> PSConfig:
        """PSConfig view for the scan backend's data prep + schedule
        extraction (core.parameter_server.prepare_run). Unlike to_ps_config
        this does NOT restrict the strategy: on the scan path the strategy
        stays a live DelayCompensator driving the apply hooks, only the
        protocol knobs (mode, epochs, batching, rho, seed) are lowered.
        `seed` overrides spec.seed for the multi-seed sweep."""
        return PSConfig(
            mode=self.mode,
            guided=self.guided,
            optimizer=self.optimizer,
            lr=self.lr,
            epochs=self.epochs,
            rho=self.rho,
            batch_size=self.batch_size,
            max_consistent=self.max_consistent,
            verification_frac=self.verification_frac,
            rmsprop_beta=self.rmsprop_beta,
            eps=self.eps,
            seed=self.seed if seed is None else seed,
        )

    def to_guided_config(self) -> GuidedConfig:
        """Lower to the strategies' config. strategy="dc_asgd" keeps the
        legacy mode="dc_asgd" spelling, as the reference does."""
        return GuidedConfig(
            mode="dc_asgd" if self.strategy in _DC_STRATEGIES else self.mode,
            guided=self.guided,
            rho=self.rho,
            max_consistent=self.max_consistent,
            staleness=self.staleness,
            dc_lambda=self.dc_lambda,
            correction="two_pass" if self.strategy == "guided_two_pass" else "fused",
            correction_scale=self.correction_scale,
            magnitude_weight=self.magnitude_weight,
        )

    def model_config(self):
        """Resolve arch + reduced + overrides to a ModelConfig (mesh backend)."""
        from repro_torch.configs import get_config

        cfg = get_config(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        if self.model_overrides:
            cfg = cfg.replace(**dict(self.model_overrides))
        return cfg

    @classmethod
    def for_algo(cls, name: str, **kw) -> "ExperimentSpec":
        """Spec for a paper-table algorithm name ('gSSGD', 'SRMSprop', ...).
        Defaults to the sim backend (the paper's own scale) except for
        strategies with no sim equivalent (DC-ASGD, which defaults to the
        reference's mesh); pass backend explicitly for the scan backend."""
        try:
            mode, strategy, optimizer = ALGOS[name]
        except KeyError:
            raise KeyError(f"unknown algorithm {name!r}; known: {', '.join(ALGOS)}") from None
        sim_ok = strategy in ("none", "guided_fused", "guided_two_pass")
        kw.setdefault("backend", "sim" if sim_ok else "mesh")
        return cls(mode=mode, strategy=strategy, optimizer=optimizer, **kw)
