"""Continuous-batching serve engine (port of `repro.serve.engine`).

`ServeEngine` owns a queue and a fixed pool of `max_batch` slots backed by
ONE persistent cache allocation (`T.init_caches(cfg, max_batch, max_len)`):

* every engine step advances ALL active slots with one `decode_step`
  carrying a per-slot position vector `t: (B,)`, then samples the pool in
  the same step; the sampled (B,) tokens are the step's one host sync;
* a finished slot (EOS / max_new_tokens) is freed at once and the next
  queued request is admitted: its prefill writes the slot's row of the pool
  caches in place (a view of the pool), and its first token is the
  admission's one host sync;
* prompts are right-padded to a power-of-two bucket only where the arch
  makes padding exact (full causal attention); sliding-window archs such as
  yi-9b and recurrent ones such as jamba's hybrid prefill at exact prompt
  length. An admission's prefill starts from fresh state (attention rows
  zeroed, Mamba states from zero), never from the slot's last request.

`ServeEngine.from_checkpoint` warm-starts serving from a training snapshot
(`repro_torch.checkpoint`): only the `params` subtree is read, and the model
config comes from the snapshot's manifest unless the caller gives one.

Left out in this port so far: sharding over a mesh (the engine runs on one
card) and VLM patch embeddings (a request with patches raises).

`lockstep_generate` is the fixed-batch barriered baseline, kept as the parity
oracle for equal-length requests.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.module import tree_map
from repro_torch.serve.sampling import SamplingParams, sample_tokens

MIN_PREFILL_BUCKET = 8  # smallest padded prefill length (full-causal archs only)


@dataclasses.dataclass
class Request:
    """One generation request. `on_token(request_id, token)` streams tokens as
    they are accepted (prefill's first token included). `patches` (VLM
    patch embeddings) is not yet ported: a request carrying it is refused."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    on_token: Optional[Callable[[int, int], None]] = None
    patches: Optional[np.ndarray] = None
    request_id: Optional[int] = None  # assigned at submit() if None


@dataclasses.dataclass
class Completion:
    """Result + latency record of one request."""

    request_id: int
    prompt_len: int
    tokens: List[int]              # generated tokens (EOS included if hit)
    finish_reason: str             # "eos" | "length"
    slot: int
    submitted_s: float             # perf_counter stamps
    admitted_s: float
    first_token_s: float
    finished_s: float

    @property
    def new_tokens(self) -> int:
        return len(self.tokens)

    @property
    def ttft_s(self) -> float:
        """Submit -> first token (queue wait + prefill)."""
        return self.first_token_s - self.submitted_s

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    prompt_len: int
    tokens: List[int]
    submitted_s: float
    admitted_s: float
    first_token_s: float


def _padded_prefill_ok(cfg) -> bool:
    """Right-padded prompts are exact only when every layer is full causal
    attention: recurrent state integrates pad junk, sliding windows let pads
    displace real tail tokens in the ring, and MoE capacity counts pad
    tokens. Those archs prefill at exact length instead."""
    return cfg.arch_type in ("dense", "vlm") and not cfg.sliding_window


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor -> `device` without blocking the host: a pageable copy to
    a CUDA device waits for the stream to drain, so it goes through pinned
    memory. The host buffer must not change until the stream has used it;
    the engine only writes its buffers after the step's one sync."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    t = torch.zeros(shape, dtype=dtype)
    return t.pin_memory() if device.type == "cuda" else t


def _pool_row(caches, slot: int):
    """Views of batch row `slot` of every layer's pool caches, e.g. attention
    k/v (n_super, 1, S_c, K, dh) and Mamba conv/ssm (n_super, 1, ...)."""
    return tree_map(lambda c: c[:, slot:slot + 1], caches)


class ServeEngine:
    """Continuous-batching serving over prefill/decode and the ring-buffer
    caches; runs on the device its params live on.

        engine = ServeEngine(params, cfg, max_batch=4, max_len=256)
        engine.submit(Request(prompt, max_new_tokens=32))
        completions = engine.run()          # or step() under your own loop
        engine.stats()["tokens_per_s"]
    """

    def __init__(self, params, cfg, *, max_batch: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only; nothing to serve")
        if max_batch < 1 or max_len < 2:
            raise ValueError(f"need max_batch >= 1 and max_len >= 2, "
                             f"got {max_batch}, {max_len}")
        T.check_ported(cfg)
        self.params, self.cfg = params, cfg
        self.device = params["embed"]["table"].device
        self.max_batch, self.max_len, self.eos_id = max_batch, max_len, eos_id
        self._padded = _padded_prefill_ok(cfg)

        self.caches = T.init_caches(cfg, max_batch, max_len, self.device)

        B = max_batch
        self.queue: "collections.deque[Request]" = collections.deque()
        self.completions: List[Completion] = []
        self._active: List[Optional[_Active]] = [None] * B
        self._n_active = 0
        # pinned host buffers (numpy views for the bookkeeping) feed each step
        self._tokens_h = _host_buffer((B, 1), torch.int64, self.device)
        self._t_h = _host_buffer((B,), torch.int32, self.device)
        self._tokens = self._tokens_h.numpy()
        self._t = self._t_h.numpy()
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int32)
        self._next_id = 0
        self.reset_stats()

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg=None, *, step: Optional[int] = None,
                        device="cuda", **engine_kw) -> "ServeEngine":
        """Warm-start serving from a training snapshot: restore the `params`
        subtree of the full-state checkpoint and build an engine around it on
        `device` — the guided and optimizer state stays on disk for the
        training job that owns it.

        `step=None` takes the newest manifest entry (or a v1 LATEST);
        `cfg=None` rebuilds the ModelConfig from the manifest metadata the
        trainer records (arch, reduced, model_overrides). The template is
        the model's shapes on the meta device, materialized on `device` and
        filled leaf by leaf from the archive."""
        from repro_torch import checkpoint as C

        if step is None:
            step = C.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint manifest (or v1 LATEST) in {ckpt_dir}")
        if cfg is None:
            cfg = C.model_config_from_manifest(ckpt_dir, step)
        device = torch.device(device)
        template = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=device),
                            T.model_init(None, cfg, device="meta"))
        params = C.restore_subtree(ckpt_dir, step, "params", template)
        return cls(params, cfg, **engine_kw)

    # -------------------------------------------------------------- public

    def bucket_len(self, prompt_len: int) -> int:
        """Prefill length for a prompt: next power of two where padding is
        exact for the arch, the exact length otherwise."""
        if not self._padded:
            return prompt_len
        b = max(MIN_PREFILL_BUCKET, 1 << (prompt_len - 1).bit_length())
        return min(b, self.max_len)

    @property
    def num_active(self) -> int:
        return self._n_active

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return self._n_active > 0 or bool(self.queue)

    def submit(self, req: Request) -> int:
        """Queue a request; returns its request_id."""
        L = len(req.prompt)
        if L < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if L + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {L} + max_new_tokens {req.max_new_tokens} exceeds "
                f"engine max_len {self.max_len}")
        if req.patches is not None:
            raise NotImplementedError("VLM patch embeddings are not yet ported to repro_torch")
        if req.request_id is None:
            req.request_id = self._next_id
        self._next_id = max(self._next_id, req.request_id) + 1
        req._submitted_s = time.perf_counter()
        self.queue.append(req)
        return req.request_id

    def step(self) -> bool:
        """One engine iteration: admit queued requests into free slots, then
        advance every active slot one token. Returns False once drained."""
        t0 = time.perf_counter()
        self._admit()
        if self._n_active == 0:
            self.run_wall_s += time.perf_counter() - t0
            return False
        dev = self.device
        logits, self.caches = T.decode_step(
            self.params, self.caches, _h2d(self._tokens_h, dev), _h2d(self._t_h, dev), self.cfg)
        toks = sample_tokens(logits, self._gens, self._temp, self._topk)
        toks = toks.tolist()  # the step's one host sync: (B,) sampled tokens
        self.decode_steps += 1
        self.slot_steps += self._n_active
        for slot in range(self.max_batch):
            st = self._active[slot]
            if st is None:
                continue
            self._t[slot] += 1
            self._accept(st, toks[slot])
        self.run_wall_s += time.perf_counter() - t0
        return True

    def run(self, requests: Optional[Sequence[Request]] = None) -> List[Completion]:
        """Submit `requests` (if given) and drain the engine. Returns the
        completions produced by this call, in finish order."""
        for r in requests or ():
            self.submit(r)
        n0 = len(self.completions)
        while self.step():
            pass
        return self.completions[n0:]

    def reset_stats(self):
        """Zero the aggregate counters (bench warmup); requires an idle engine."""
        if self._n_active or self.queue:
            raise ValueError("reset_stats on a busy engine")
        self.completions = []
        self.decode_steps = 0
        self.prefill_calls = 0
        self.slot_steps = 0
        self.run_wall_s = 0.0

    def stats(self) -> dict:
        """Aggregate throughput/latency over the completions so far."""
        new_tokens = sum(c.new_tokens for c in self.completions)
        out = {
            "n_completed": len(self.completions),
            "new_tokens": new_tokens,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "wall_s": self.run_wall_s,
            "tokens_per_s": new_tokens / self.run_wall_s if self.run_wall_s else 0.0,
            "occupancy": (self.slot_steps / (self.decode_steps * self.max_batch)
                          if self.decode_steps else 0.0),
        }
        if self.completions:
            out["mean_ttft_s"] = float(np.mean([c.ttft_s for c in self.completions]))
            out["mean_latency_s"] = float(np.mean([c.latency_s for c in self.completions]))
        return out

    # ------------------------------------------------------------ internals

    def _admit(self):
        slot = 0
        while self.queue:
            while slot < self.max_batch and self._active[slot] is not None:
                slot += 1
            if slot == self.max_batch:
                return
            self._prefill_into(slot, self.queue.popleft())

    def _prefill_into(self, slot: int, req: Request):
        L = len(req.prompt)
        Sb = self.bucket_len(L)
        toks = np.zeros((1, Sb), np.int64)
        toks[0, :L] = req.prompt
        sp = req.sampling
        gen = sp.generator(self.device)
        logits, _ = T.prefill(self.params, {"tokens": _h2d(torch.from_numpy(toks), self.device)},
                              self.cfg, total_len=self.max_len, prompt_lens=[L],
                              caches=_pool_row(self.caches, slot))
        tok = sample_tokens(logits, [gen], [sp.eff_temperature], [sp.eff_top_k])
        tok = tok.tolist()  # the admission's one host sync: its first token
        self.prefill_calls += 1
        now = time.perf_counter()
        st = _Active(req=req, slot=slot, prompt_len=L, tokens=[],
                     submitted_s=getattr(req, "_submitted_s", now),
                     admitted_s=now, first_token_s=now)
        self._active[slot] = st
        self._n_active += 1
        self._t[slot] = L            # position of the first generated token
        self._gens[slot] = gen
        self._temp[slot] = sp.eff_temperature
        self._topk[slot] = sp.eff_top_k
        self._accept(st, tok[0])

    def _accept(self, st: _Active, tok: int):
        if not st.tokens:
            st.first_token_s = time.perf_counter()
        st.tokens.append(tok)
        self._tokens[st.slot, 0] = tok
        if st.req.on_token is not None:
            st.req.on_token(st.req.request_id, tok)
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(st, "eos")
        elif len(st.tokens) >= st.req.max_new_tokens:
            self._finish(st, "length")

    def _finish(self, st: _Active, reason: str):
        self.completions.append(Completion(
            request_id=st.req.request_id, prompt_len=st.prompt_len,
            tokens=st.tokens, finish_reason=reason, slot=st.slot,
            submitted_s=st.submitted_s, admitted_s=st.admitted_s,
            first_token_s=st.first_token_s, finished_s=time.perf_counter()))
        self._active[st.slot] = None
        self._n_active -= 1
        self._t[st.slot] = 0
        self._tokens[st.slot, 0] = 0
        self._gens[st.slot] = None
        self._temp[st.slot] = 0.0
        self._topk[st.slot] = 0


# ----------------------------------------------------------------- baseline


def lockstep_generate(engine: ServeEngine, requests: Sequence[Request]):
    """The barriered baseline the engine replaces: requests are grouped in
    submission order into fixed batches of `engine.max_batch`; each batch
    prefills together with prompts right-padded to the batch max, then
    decodes with one shared position until the longest member finishes.

    Uses the engine's params, config and sampler on fresh caches; the
    engine's own pool is untouched. Returns (completions, stats_dict).
    """
    if any(r.patches is not None for r in requests):
        raise NotImplementedError("VLM patch embeddings are not yet ported to repro_torch")
    B, dev, cfg = engine.max_batch, engine.device, engine.cfg
    t0 = time.perf_counter()
    completions: List[Completion] = []
    decode_steps = 0
    slot_steps = 0
    for g0 in range(0, len(requests), B):
        group = list(requests[g0:g0 + B])
        sub_s = [getattr(r, "_submitted_s", t0) for r in group]
        admit_s = time.perf_counter()

        Lmax = max(len(r.prompt) for r in group)
        Sb = engine.bucket_len(Lmax)
        toks = np.zeros((B, Sb), np.int64)
        lens = np.ones((B,), np.int64)
        temp = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int32)
        gens: List[Optional[torch.Generator]] = [None] * B
        for i, r in enumerate(group):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
            temp[i] = r.sampling.eff_temperature
            topk[i] = r.sampling.eff_top_k
            gens[i] = r.sampling.generator(dev)

        logits, caches = T.prefill(engine.params, {"tokens": _h2d(torch.from_numpy(toks), dev)},
                                   cfg, total_len=engine.max_len, prompt_lens=lens.tolist())
        tok = sample_tokens(logits, gens, temp, topk).tolist()
        out = [[] for _ in group]
        done = [False] * len(group)
        first_s = [0.0] * len(group)
        finish_s = [0.0] * len(group)
        reason = ["length"] * len(group)

        def accept(i, tk):
            if done[i]:
                return
            if not out[i]:
                first_s[i] = time.perf_counter()
            out[i].append(tk)
            r = group[i]
            if r.on_token is not None:
                r.on_token(r.request_id if r.request_id is not None else g0 + i, tk)
            if engine.eos_id is not None and tk == engine.eos_id:
                done[i], reason[i] = True, "eos"
            elif len(out[i]) >= r.max_new_tokens:
                done[i] = True
            if done[i]:
                finish_s[i] = time.perf_counter()

        for i in range(len(group)):
            accept(i, tok[i])
        cur = np.zeros((B, 1), np.int64)
        cur[:len(group), 0] = tok[:len(group)]
        # one SHARED position for the whole batch: everyone decodes from the
        # padded Lmax, and the batch runs until its last member finishes
        t = Lmax
        while not all(done):
            slot_steps += sum(1 for d in done if not d)
            logits, caches = T.decode_step(
                engine.params, caches, _h2d(torch.from_numpy(cur), dev),
                torch.full((B,), t, dtype=torch.int32, device=dev), cfg)
            tok = sample_tokens(logits, gens, temp, topk).tolist()
            decode_steps += 1
            t += 1
            for i in range(len(group)):
                accept(i, tok[i])
            cur[:, 0] = tok

        for i, r in enumerate(group):
            completions.append(Completion(
                request_id=r.request_id if r.request_id is not None else g0 + i,
                prompt_len=len(r.prompt), tokens=out[i], finish_reason=reason[i],
                slot=i, submitted_s=sub_s[i], admitted_s=admit_s,
                first_token_s=first_s[i], finished_s=finish_s[i]))

    wall = time.perf_counter() - t0
    new_tokens = sum(c.new_tokens for c in completions)
    stats = {
        "n_completed": len(completions),
        "new_tokens": new_tokens,
        "decode_steps": decode_steps,
        "wall_s": wall,
        "tokens_per_s": new_tokens / wall if wall else 0.0,
        "occupancy": slot_steps / (decode_steps * B) if decode_steps else 0.0,
    }
    if completions:
        stats["mean_ttft_s"] = float(np.mean([c.ttft_s for c in completions]))
        stats["mean_latency_s"] = float(np.mean([c.latency_s for c in completions]))
    return completions, stats
