"""Continuous-batching coded serving: Poisson admission, per-step coded
rounds, pow2 slot bucketing.

Ports ``repro/runtime/serve_loop.py``: the standard continuous-batching
scheduler on top of the coded round machinery.

* **admission** — requests arrive on a (virtual-clock) Poisson timeline;
  any free slot admits the next arrival at the step boundary;
* **eviction** — a request leaves its slot the step it hits its ``gen``
  budget or emits EOS; survivors are compacted to the front;
* **bucketing** — the step only ever sees pow2 batch widths (active slots
  padded up to the bucket);
* **one coded round per step** — on the virtual transport every selected
  projection of every in-flight request runs inside ONE step
  (``models.coded.build_coded_step``) under ONE straggler plan and ONE
  decode mask per step, the spec's wait policy choosing the responder
  prefix.

Prefill rides the decode path: an admitted request is teacher-forced one
prompt token per step (its slot's ``pos`` trails the others), so a step
is always "one token for every in-flight slot".

Timing splits two clocks: the **virtual clock** (straggler waits + the
master's measured per-step wall) prices throughput and latency the way
every other round does; **busy wall** sums only the measured master
steps, so ``tok_s`` excludes admission idle by construction.

Differences from the reference, by design:

* **The KV cache** is a list of per-layer tensors written in place: a
  bucket's cache is a view of the leading slots (``_slice_cache``), so
  nothing is merged back; compaction after evictions is
  ``leaf.copy_(leaf[perm])`` and admission zeroes the slot's rows (for
  an SSM layer its float32 recurrent state, written in place the same
  way).
* **Timing.**  The reference runs a pure jitted step twice at a new
  bucket (compile, then timed).  The port's step writes the cache and
  compiles nothing, so each step is timed once between two device
  synchronizations.
* **``trace_count``** counts the buckets first run (the reference's jit
  traces).  The port's in-port contract is that churn rebuilds nothing:
  the kernels build once per process (``kernels._build.build_count``).
* **``RoundStats.dispatches``** counts the step's launches of the port's
  kernels, as every port round does: an ``instep`` step launches one
  ``berrut_combine`` per coded-site instance (1 for ``"unembed"``,
  4·L + 1 for ``"all"``) plus four ``mask_add`` per site under
  ``encrypt="real"``; 0 on the CPU and in ``plain`` mode.

``refuse_encoder_decoder`` is the serving entry points' refusal of the
encoder-decoder (whisper): the reference's loop, which slices a
``TransformerLM`` cache, fails on it (``KeyError: 'prelude'``), so neither
package has an encoder-decoder serve path.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.ops import kernel_launches
from .engine import RoundStats, _sync

__all__ = ["Request", "ServedRequest", "ServeResult", "poisson_workload",
           "refuse_encoder_decoder", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget."""
    rid: int
    prompt: np.ndarray               # (L,) int32 token ids, L >= 1
    gen: int                         # tokens to generate
    arrival_s: float = 0.0           # virtual arrival time


@dataclasses.dataclass
class ServedRequest:
    """One finished request with its timeline on the virtual clock."""
    rid: int
    arrival_s: float
    admitted_s: float
    first_token_s: float             # virtual time the first token decoded
    done_s: float
    n_prompt: int
    tokens: np.ndarray               # (gen'd,) int32

    @property
    def ttft_s(self) -> float:
        """Time to first token, measured from ARRIVAL (queueing included —
        this is what an admission policy is judged on)."""
        return self.first_token_s - self.arrival_s


@dataclasses.dataclass
class ServeResult:
    """One serve run: finished requests + per-step accounting."""
    requests: List[ServedRequest]
    step_stats: list                 # one RoundStats per step
    step_virtual_s: np.ndarray       # (n_steps,) virtual duration per step
    buckets: np.ndarray              # (n_steps,) batch width per step
    busy_wall_s: float               # Σ measured master step wall
    virtual_s: float                 # virtual makespan (last eviction)
    trace_count: int                 # buckets first run
    mode: str                        # "instep" | "round" | "plain"
    coded_fraction: float            # analytic coded share of step FLOPs
    step_wall_s: np.ndarray = dataclasses.field(   # (n_steps,) measured
        default_factory=lambda: np.zeros(0))       # master wall per step

    @property
    def n_steps(self) -> int:
        return len(self.step_virtual_s)

    @property
    def ttft_s(self) -> np.ndarray:
        return np.asarray([r.ttft_s for r in self.requests])

    @property
    def p50_step_s(self) -> float:
        return float(np.percentile(self.step_virtual_s, 50)) \
            if self.n_steps else 0.0

    @property
    def p99_step_s(self) -> float:
        return float(np.percentile(self.step_virtual_s, 99)) \
            if self.n_steps else 0.0

    @property
    def requests_per_s(self) -> float:
        """Served requests over the virtual makespan — the end-to-end
        serving throughput the admission policy is gated on."""
        return len(self.requests) / max(self.virtual_s, 1e-12)

    @property
    def generated(self) -> int:
        return sum(len(r.tokens) for r in self.requests)

    @property
    def tok_s(self) -> float:
        """Decode throughput over BUSY wall only — admission idle (the
        loop parked waiting for the next Poisson arrival) is excluded."""
        return self.generated / max(self.busy_wall_s, 1e-12)


def poisson_workload(n_requests: int, *, rate_rps: float, prompt_len: int,
                     gen: int, vocab: int, seed: int = 0,
                     ragged: bool = True) -> List[Request]:
    """A Poisson arrival trace of random-token requests.

    Inter-arrival gaps are exponential at ``rate_rps`` (0 = everything
    arrives at t=0); ``ragged`` draws per-request prompt lengths in
    [max(2, prompt_len/2), prompt_len] AND generation budgets in
    [max(1, gen/4), gen] instead of uniform shapes.  The reference's draw,
    number for number.
    """
    rng = np.random.default_rng(seed)
    if rate_rps > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
        arrivals -= arrivals[0]                     # first request at t=0
    else:
        arrivals = np.zeros(n_requests)
    reqs = []
    for i in range(n_requests):
        plen, g = prompt_len, gen
        if ragged:
            plen = int(rng.integers(max(2, prompt_len // 2), prompt_len + 1))
            g = int(rng.integers(max(1, gen // 4), gen + 1))
        prompt = rng.integers(1, vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, gen=g,
                            arrival_s=float(arrivals[i])))
    return reqs


@dataclasses.dataclass
class _Slot:
    req: Request
    admitted_s: float
    fed: int = 0                     # prompt tokens already in the cache
    last_tok: int = 0
    first_token_s: float = float("nan")
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False               # gated mode: finished but slot-bound


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def refuse_encoder_decoder(cfg) -> None:
    """Raise ``ValueError`` for an encoder-decoder config: the serve loop
    decodes decoder-only caches, and the reference's has no
    encoder-decoder path either."""
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: the reference's "
                         "serve loop has no encoder-decoder path, and "
                         "neither has the port's")


class ContinuousBatcher:
    """The continuous-batching serve loop over one engine + model.

    ``mode`` resolution, as the reference's:

    * ``coded_layers="none"`` → **plain**: the unmodified decode step,
      still continuously batched (the uncoded baseline);
    * virtual transport + a fused-capable scheme → **instep**: the whole
      step (all selected coded sites) runs under one straggler plan;
    * real transports (threads, the socket mesh) → **round**: the hidden
      state on the master, the unembed projection as one real
      ``engine.matmul`` round per step (spec validation already restricts
      real transports to ``coded_layers="unembed"``).

    The mode follows ``backend``, not the engine's transport: over a
    virtual engine, ``backend="threads"`` gives the virtual clock's round
    mode.  ``admission="gated"`` reproduces the static-batch scheduler
    (admit only into an EMPTY machine, hold finished requests in their
    slots until the whole batch drains).
    """

    def __init__(self, engine, model, *, coded_layers: str = "unembed",
                 max_slots: int = 8, eos_id: Optional[int] = None,
                 backend: str = "virtual", admission: str = "continuous",
                 round0: int = 0):
        if admission not in ("continuous", "gated"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.engine = engine
        self.model = model
        self.device = engine.device
        self.coded_layers = coded_layers
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        self.admission = admission
        self._round = round0
        self.trace_count = 0

        supports_fused = bool(getattr(engine.scheme, "supports_fused", False))
        if coded_layers == "none":
            self.mode = "plain"
        elif backend == "virtual" and supports_fused:
            self.mode = "instep"
        elif coded_layers == "unembed":
            self.mode = "round"
        else:
            raise ValueError(
                f"coded_layers={coded_layers!r} needs the in-step coded path "
                f"(virtual transport + a fused-capable scheme); "
                f"backend={backend!r} supports_fused={supports_fused}")

        from ..models.coded import (build_coded_step, coded_flop_fraction,
                                    encode_serving_weights)
        cfg = model.cfg
        if self.mode != "plain" and self.device.type == "cuda":
            # build the kernels now, not inside the first timed step
            from ..kernels import _build
            _build.library("berrut_combine")
        if self.mode == "instep":
            self.code = encode_serving_weights(engine.scheme, model,
                                               coded_layers)
            self.wire_params = engine.serve_wire_params()
            self._step = build_coded_step(model, engine.scheme, self.code,
                                          wire_params=self.wire_params)
            self.coded_fraction = coded_flop_fraction(cfg, coded_layers)
            self._t_comp: Dict[int, float] = {}
        elif self.mode == "round":
            emb = model.embedding
            with torch.no_grad():
                wt = emb["table"] if cfg.tie_embeddings else emb["unembed"].T
                self._wt = wt.detach().to(torch.float32).contiguous()
            self.coded_fraction = coded_flop_fraction(cfg, "unembed")
        else:
            self.coded_fraction = 0.0
        self._warm: set = set()              # buckets already run

    # ---------------------------------------------------------- cache ops
    @staticmethod
    def _slice_cache(cache, b):
        """The leading-``b``-slots views the bucketed step writes into."""
        return [{k: leaf[:b] for k, leaf in layer.items()} for layer in cache]

    @staticmethod
    def _merge_cache(cache, new):
        """Nothing to merge: the step wrote through the views.  Asserts
        that it did."""
        for full, nw in zip(cache, new):
            for k, leaf in full.items():
                assert nw[k].data_ptr() == leaf.data_ptr(), k
        return cache

    @staticmethod
    def _gather_cache(cache, perm):
        """Slot compaction after evictions: row ``i`` ← old row
        ``perm[i]``."""
        idx = None
        for layer in cache:
            for leaf in layer.values():
                if idx is None:
                    idx = torch.as_tensor(perm, dtype=torch.long,
                                          device=leaf.device)
                leaf.copy_(leaf[idx])
        return cache

    @staticmethod
    def _zero_slot(cache, i):
        """Admission reset: every leaf of slot ``i`` to zeros, as the
        reference's.  A KV cache's stale keys are unreachable anyway
        (reads are position-masked), but an SSM layer's recurrent state
        (rwkv's ``tm_x``/``cm_x``/``wkv``, mamba's ``conv``/``ssm``) is
        read whole at every step: without the reset a request admitted
        into a freed slot would start from its previous occupant's
        state."""
        for layer in cache:
            for leaf in layer.values():
                leaf[i].zero_()
        return cache

    # ----------------------------------------------------------- stepping
    def _site_t_comp(self, b: int) -> float:
        """Per-worker virtual compute of one step at bucket ``b`` — each
        worker runs every coded site's shard back-to-back."""
        if b not in self._t_comp:
            self._t_comp[b] = sum(
                self.engine.worker_time(lhs, rhs)
                for lhs, rhs in self.code.site_shapes(b))
        return self._t_comp[b]

    def _timed(self, b, fn, *args):
        """Run the step at bucket ``b`` between two device
        synchronizations: (out, wall_s, kernel launches)."""
        if b not in self._warm:
            self._warm.add(b)
            self.trace_count += 1
        launches0 = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(self.device)
        return out, time.perf_counter() - t0, kernel_launches() - launches0

    def _hidden(self, cache, tok, pos):
        with torch.no_grad():
            h, cache = self.model.decode_step(cache, tok, pos,
                                              return_hidden=True)
        return h[:, 0, :].to(torch.float32), cache

    def _plain(self, cache, tok, pos):
        with torch.no_grad():
            logits, cache = self.model.decode_step(cache, tok, pos)
        return logits[:, 0, :].argmax(dim=-1).to(torch.int32), cache

    def _run_step(self, cache, tok, pos, b):
        """One step at bucket ``b``: returns (next_tokens (b,) numpy,
        RoundStats, virtual_dur_s, wall_s)."""
        sliced = self._slice_cache(cache, b)
        tok_a = torch.as_tensor(tok[:b, None], dtype=torch.long,
                                device=self.device)
        pos_a = torch.as_tensor(pos[:b], dtype=torch.int32,
                                device=self.device)
        if self.mode == "instep":
            plan = self.engine.serve_round_plan(self._round,
                                                self._site_t_comp(b))
            self._round += 1
            crypto = 0.0
            mats = None
            if self.wire_params is not None:
                mats = self.code.step_materials(self.engine)
                crypto = self.engine.serve_crypto_time(
                    *self.code.wire_elems(b))
            (nxt, new_cache), wall, launches = self._timed(
                b, self._step, sliced, tok_a, pos_a,
                torch.from_numpy(plan.mask), mats)
            stats = self.engine._stats(
                plan.events, plan.wait_s, encode_s=wall,
                compute_wait_s=plan.wait_s, decode_s=0.0, crypto_s=crypto,
                n_waited=len(plan.responders), dispatches=launches)
            virt = stats.total_s
        elif self.mode == "round":
            (h, new_cache), wall, _ = self._timed(b, self._hidden, sliced,
                                                  tok_a, pos_a)
            t0 = time.perf_counter()
            prod, stats = self.engine.matmul(self._wt, h.T,
                                             round_idx=self._round)
            nxt = prod.T.argmax(dim=-1).to(torch.int32)
            _sync(self.device)
            wall += time.perf_counter() - t0
            self._round += 1
            virt = stats.total_s
        else:
            (nxt, new_cache), wall, launches = self._timed(
                b, self._plain, sliced, tok_a, pos_a)
            stats = RoundStats(encode_s=wall, compute_wait_s=0.0,
                               decode_s=0.0, policy="uncoded",
                               dispatches=launches)
            virt = wall
        self._merge_cache(sliced, new_cache)
        return nxt.cpu().numpy(), stats, virt, wall

    # --------------------------------------------------------------- loop
    def run(self, requests: Sequence[Request]) -> ServeResult:
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        max_len = max(len(r.prompt) + r.gen for r in reqs) + 1
        cache = self.model.init_cache(self.max_slots, max_len)
        pending = deque(reqs)
        slots: List[_Slot] = []
        served: List[ServedRequest] = []
        step_stats, virt_log, wall_log, bucket_log = [], [], [], []
        t_v = 0.0
        busy = 0.0
        tok = np.zeros(self.max_slots, np.int32)
        pos = np.zeros(self.max_slots, np.int32)

        while pending or slots:
            # ---- admission at the step boundary.  Continuous: any free
            # slot takes the next arrival.  Gated (the static-batch
            # baseline): only an EMPTY machine admits, so late arrivals
            # wait out the whole in-flight batch.
            if self.admission != "gated" or not slots:
                while (pending and len(slots) < self.max_slots
                       and pending[0].arrival_s <= t_v + 1e-12):
                    r = pending.popleft()
                    if r.gen <= 0:               # nothing to decode
                        served.append(ServedRequest(
                            rid=r.rid, arrival_s=r.arrival_s, admitted_s=t_v,
                            first_token_s=t_v, done_s=t_v,
                            n_prompt=len(r.prompt),
                            tokens=np.zeros(0, np.int32)))
                        continue
                    self._zero_slot(cache, len(slots))
                    slots.append(_Slot(req=r, admitted_s=t_v))
            if not slots:
                if not pending:                  # everything drained
                    break
                t_v = max(t_v, pending[0].arrival_s)   # idle: jump ahead
                continue

            # ---- assemble the bucketed step
            b = _next_pow2(len(slots))
            for i, s in enumerate(slots):
                plen = len(s.req.prompt)
                tok[i] = s.req.prompt[s.fed] if s.fed < plen else s.last_tok
                pos[i] = s.fed
            tok[len(slots):b] = 0                # padded slots: ignored rows
            pos[len(slots):b] = 0
            nxt, stats, virt, wall = self._run_step(cache, tok, pos, b)
            busy += wall
            t_v += virt
            step_stats.append(stats)
            virt_log.append(virt)
            wall_log.append(wall)
            bucket_log.append(b)

            # ---- consume outputs, evict finishers
            finished: List[int] = []
            for i, s in enumerate(slots):
                if s.done:
                    continue
                plen = len(s.req.prompt)
                if s.fed >= plen - 1:            # argmax is a generated token
                    t = int(nxt[i])
                    s.tokens.append(t)
                    s.last_tok = t
                    if len(s.tokens) == 1:
                        s.first_token_s = t_v
                    if (len(s.tokens) >= s.req.gen
                            or (self.eos_id is not None and t == self.eos_id)):
                        s.done = True
                        served.append(ServedRequest(
                            rid=s.req.rid, arrival_s=s.req.arrival_s,
                            admitted_s=s.admitted_s,
                            first_token_s=s.first_token_s, done_s=t_v,
                            n_prompt=plen,
                            tokens=np.asarray(s.tokens, np.int32)))
                        finished.append(i)
                s.fed += 1
            if self.admission == "gated":
                # finished requests hold their slots until the batch drains
                if all(s.done for s in slots):
                    slots = []
            elif finished:
                keep = [i for i in range(len(slots)) if i not in finished]
                perm = keep + [i for i in range(self.max_slots)
                               if i not in keep]
                self._gather_cache(cache, perm[:self.max_slots])
                slots = [slots[i] for i in keep]

        served.sort(key=lambda r: r.rid)
        return ServeResult(
            requests=served, step_stats=step_stats,
            step_virtual_s=np.asarray(virt_log),
            buckets=np.asarray(bucket_log, np.int64), busy_wall_s=busy,
            virtual_s=t_v, trace_count=self.trace_count, mode=self.mode,
            coded_fraction=self.coded_fraction,
            step_wall_s=np.asarray(wall_log))
