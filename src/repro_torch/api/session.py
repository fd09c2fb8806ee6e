"""``Session``: the context-managed runtime behind one ``ClusterSpec``.

Ports ``Session.__init__``, its lifecycle, ``Session.matmul``,
``Session.anytime_curve``, ``ServeReport`` and ``Session.serve``, and the
SPACDC-DL training step (paper
Algorithm 2: ``coded_mlp_init``, ``mlp_forward``, ``coded_mlp_step``,
``Session.init_mlp`` / ``train_step`` / ``mlp_accuracy``) of
``repro/api/session.py``:

    with Session(ClusterSpec.paper_fig3()) as s:       # on the card
        out, stats = s.matmul(a, b)                    # one coded round
        points = s.anytime_curve(a, b)                 # error vs latency
        s.init_mlp((784, 512, 10), lr=0.05)
        loss, elapsed = s.train_step(x, y)             # SPACDC-DL step
        report = s.serve(arch="qwen2-7b")              # coded serving

The device is the ``device=`` argument (``None`` = ``"cuda"``, which raises
without a CUDA device; the tests pass ``device="cpu"``), never a spec field.
``matmul`` returns the product as a tensor on that device, where the
reference returns a host numpy array: the host copy is left to the caller.
The MLP's state (weights, biases, activations, the backward ``delta``)
lives on the same device as float32 tensors; the uncoded products are
``torch.matmul`` in IEEE float32 (the package never turns TF32 on).  The
reference's state is float64 under numpy 2 (its float32 draw times a
float64 scale promotes); the port keeps float32, the reference's initial
weights rounded to float32 bit for bit.

Serving (``ServeReport``, ``Session.serve``) drives the continuous-batching
loop of ``runtime.serve_loop`` over a model built on the session's device
(``models.build_model`` from a seeded generator; ``arch`` may also be a
``ModelConfig``, e.g. one whose depth is cut): the dense GQA families
(qwen2-vl among them: its decode takes plain RoPE, as the reference's
serve loop decodes it) and deepseek-v2's MLA with its MoE FFN (MLA's
wq|w_dkv and wo sites coded, the MoE FFN uncoded, as in the reference),
and the SSM families (rwkv6, whose only coded site is the unembed, and
jamba, whose attention layers and dense FFNs are coded and whose mamba
mixers and MoE FFNs are not).  The encoder-decoder (whisper) is refused
with ``ValueError`` before anything is built: the reference's serve loop
has no encoder-decoder path (its ``Session.serve`` fails on it with
``KeyError: 'prelude'``).  As in the
reference, the serve loop reads neither ``FaultSpec`` nor
``AdaptiveSpec``.

Under an active ``FaultSpec`` or ``AdaptiveSpec(policy="adaptive")``,
``Session.health`` is the engine's ``WorkerHealth`` and
``Session.adaptive_report()`` the controller's JSON-ready state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime.engine import RoundEngine, RoundStats, resolve_device
from .spec import ClusterSpec

__all__ = ["Session", "ServeReport", "coded_mlp_init", "coded_mlp_step"]


# --------------------------------------------------------------------------
# the SPACDC-DL training step (Algorithm 2), functional form
# --------------------------------------------------------------------------

def coded_mlp_init(layer_sizes: Sequence[int], seed: int = 0, *,
                   device=None):
    """He-initialized MLP state: (weights, biases) as lists of float32
    tensors on ``device`` (``None`` = the card).  The draw is the
    reference's: numpy's ``default_rng(seed)``, a float32 standard normal
    scaled by sqrt(2 / fan_in), rounded to float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    weights = [torch.from_numpy(
        (rng.standard_normal((m, n)).astype(np.float32) *
         np.sqrt(2.0 / m)).astype(np.float32)).to(dev)
        for m, n in zip(layer_sizes[:-1], layer_sizes[1:])]
    biases = [torch.zeros(n, dtype=torch.float32, device=dev)
              for n in layer_sizes[1:]]
    return weights, biases


def _act(x):
    return torch.clamp_min(x, 0.0)


def _act_grad(x):
    return (x > 0).to(x.dtype)


def _on(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device, in ``dtype`` (default:
    ``like``'s)."""
    return torch.as_tensor(x, dtype=like.dtype if dtype is None else dtype,
                           device=like.device)


def mlp_forward(weights, biases, x):
    """ReLU MLP forward: returns (activations, pre-activations)."""
    x = _on(x, weights[0])
    acts, pre = [x], []
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        z = torch.matmul(h, w) + b
        pre.append(z)
        h = _act(z) if i < len(weights) - 1 else z
        acts.append(h)
    return acts, pre


def _mlp_accuracy(weights, biases, x, y) -> float:
    acts, _ = mlp_forward(weights, biases, x)
    y = _on(y, weights[0], torch.int64)
    return float((acts[-1].argmax(1) == y).to(torch.float32).mean())


def coded_mlp_step(weights, biases, matmul, x, y, lr: float = 0.05,
                   round0: int = 0):
    """One SGD step of SPACDC-DL (paper Algorithm 2), backward layer
    products distributed through ``matmul(a, b, round_idx) ->
    (product, RoundStats)`` — the coded job is Eq. 23's delta @ W^T,
    coded over W's rows.

    Mutates ``weights``/``biases`` in place (the master owns its state);
    ``x`` and ``y`` move to the weights' device.  The loss is the step's
    one host sync.  Returns (loss, elapsed_virtual_s, per_round_stats).
    """
    bsz = x.shape[0]
    y = _on(y, weights[0], torch.int64)
    rows = torch.arange(bsz, device=y.device)
    acts, pre = mlp_forward(weights, biases, x)
    logits = acts[-1]
    z = logits - logits.max(1, keepdim=True).values
    p = torch.exp(z)
    p /= p.sum(1, keepdim=True)
    loss = -torch.mean(torch.log(p[rows, y] + 1e-12))
    onehot = torch.zeros_like(p)
    onehot[rows, y] = 1.0
    delta = (p - onehot) / bsz                      # (B, n_out)

    elapsed = 0.0
    stats_out: List[RoundStats] = []
    grads_w, grads_b = [], []
    for l in reversed(range(len(weights))):
        grads_w.append(torch.matmul(acts[l].T, delta))
        grads_b.append(delta.sum(0))
        if l > 0:
            # the distributed job (Eq. 23): delta @ W^T, coded over W rows
            prod, stats = matmul(weights[l], delta.T,
                                 round_idx=round0 + len(stats_out))
            delta = prod.T * _act_grad(pre[l - 1])
            elapsed += stats.total_s
            stats_out.append(stats)
    grads_w, grads_b = grads_w[::-1], grads_b[::-1]
    for i in range(len(weights)):
        weights[i] -= lr * grads_w[i]
        biases[i] -= lr * grads_b[i]
    return float(loss), elapsed, stats_out


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeReport:
    """One coded serving run: what came out and what every step cost.

    The continuous-batching loop (``runtime.serve_loop``) serves requests
    off a (possibly Poisson) arrival timeline, so the report carries two
    clocks: the **virtual clock** (straggler waits + measured master
    walls — ``virtual_s``, ``step_latency_s``, per-request timelines) and
    **busy wall** (measured master steps only).  ``tok_s`` divides by busy
    wall, so admission idle never inflates decode throughput.
    """
    tokens: np.ndarray               # (n_requests, max_gen) ids, -1 padded
    step_stats: List[RoundStats]     # ONE coded round per decode step
    wall_s: float                    # busy wall of the serve loop
    tok_s: float                     # generated tokens / busy wall
    t_budget: Optional[float]        # the Deadline budget (None: no deadline)
    argmax_agreement: float          # fraction of coded tokens == uncoded
    # --- continuous-batching accounting ----------------------------------
    requests: list = dataclasses.field(default_factory=list)
    ttft_s: np.ndarray = dataclasses.field(           # per-request TTFT
        default_factory=lambda: np.zeros(0))          # (arrival → 1st token)
    step_latency_s: np.ndarray = dataclasses.field(   # per-step virtual
        default_factory=lambda: np.zeros(0))          # durations
    p50_step_s: float = 0.0
    p99_step_s: float = 0.0
    requests_per_s: float = 0.0      # served requests / virtual makespan
    virtual_s: float = 0.0           # virtual makespan of the run
    busy_wall_s: float = 0.0
    coded_fraction: float = 0.0      # analytic coded share of step FLOPs
    trace_count: int = 0             # buckets first run (a few pow2
                                     # buckets, however slots churn)
    mode: str = ""                   # "instep" | "round" | "plain"
    step_wall_s: np.ndarray = dataclasses.field(      # per-step measured
        default_factory=lambda: np.zeros(0))          # master wall

    @property
    def steps_within_budget(self) -> int:
        """Decode steps whose coded decode fired at/before the deadline
        (all of them, for a rateless scheme — SPACDC's minimum decodable
        prefix is 1)."""
        if self.t_budget is None:
            return len(self.step_stats)
        return sum(1 for s in self.step_stats
                   if s.decode_at_s <= self.t_budget + 1e-12)


class Session:
    """Context-managed front door over the ported stack.

    Everything is configured by the frozen :class:`~repro_torch.api.ClusterSpec`;
    ``device`` picks where rounds run.  ``straggler`` / ``policy`` accept
    pre-built instances (objects a spec can't express).
    """

    def __init__(self, spec: ClusterSpec, *, device=None, straggler=None,
                 policy=None):
        self.spec = spec
        self.engine = RoundEngine(spec, device=device, straggler=straggler,
                                  policy=policy)
        self._closed = False
        self._round = 0
        self._mlp = None
        self.round_stats: List[RoundStats] = []
        self._serve_models: dict = {}    # (arch, tiny, seed) -> model
        self._serve_batchers: dict = {}  # + (coded_layers, admission) ->
                                         # ContinuousBatcher (encoded
                                         # weights, warm buckets)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def close(self):
        """Tear the engine down — exactly once; later calls are no-ops."""
        if not self._closed:
            self._closed = True
            self.engine.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def health(self):
        """The engine's :class:`~repro_torch.runtime.faults.WorkerHealth`
        tracker (None unless the spec's ``FaultSpec`` is active or
        ``AdaptiveSpec`` is enabled): EWMA latency, crash/drop/corrupt
        counts, quarantine state per worker."""
        return self.engine.health

    def adaptive_report(self) -> dict:
        """JSON-ready snapshot of the adaptive controller's state: the
        fitted straggler model, the candidate space, every per-round
        :class:`~repro_torch.runtime.adaptive.Decision`, and the
        per-worker health (``WorkerHealth.to_dict``).  With
        ``policy="fixed"`` the report just says so, so callers
        (``launch/serve.py --report``) can dump it unconditionally."""
        eng = self.engine
        report = {
            "scheme": self.spec.code.scheme,
            "n_workers": self.spec.code.n_workers,
            "adaptive": self.spec.adaptive.enabled,
            "rounds_run": len(self.round_stats),
        }
        if eng.adaptive is not None:
            report.update(eng.adaptive.report())
            report["active"] = {
                "k_blocks": int(getattr(eng.scheme, "k_blocks", eng.k)),
                "policy": eng.policy.name,
                "fh_degree": int(eng.fh_degree),
            }
        else:
            report["policy"] = "fixed"
        if eng.health is not None:
            report["health"] = eng.health.to_dict()
        return report

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Session is closed")

    # -------------------------------------------------------------- rounds
    def matmul(self, a, b, round_idx: Optional[int] = None, *, noise=None
               ) -> Tuple[torch.Tensor, RoundStats]:
        """One coded A@B round under the spec's scheme/policy.
        ``round_idx`` defaults to an internal counter (each call is a new
        straggler draw); pass it explicitly to replay rounds.  ``noise``
        optionally supplies the (T, blk, d) noise blocks.  Returns the
        (m, n) product on the session's device and the round's stats."""
        self._check_open()
        if round_idx is None:
            round_idx = self._round
            self._round += 1
        out, stats = self.engine.matmul(a, b, round_idx=round_idx,
                                        noise=noise)
        self.round_stats.append(stats)
        return out, stats

    # ------------------------------------------------------------ training
    def init_mlp(self, layer_sizes: Sequence[int], lr: float = 0.05,
                 seed: int = 0) -> "Session":
        """Initialize the SPACDC-DL training state ``train_step`` advances,
        on the session's device."""
        self._check_open()
        w, b = coded_mlp_init(layer_sizes, seed, device=self.device)
        self._mlp = (w, b, lr)
        return self

    @property
    def mlp_weights(self):
        """The MLP's weights: float32 tensors on the session's device, the
        live state (``train_step`` updates them in place)."""
        return self._mlp[0] if self._mlp else None

    @property
    def mlp_biases(self):
        """The MLP's biases, as :attr:`mlp_weights`."""
        return self._mlp[1] if self._mlp else None

    def train_step(self, x, y) -> Tuple[float, float]:
        """One coded SGD step (Algorithm 2); backward layer products run
        as coded rounds under the session's policy.  Returns
        (loss, virtual_elapsed_s); per-round stats land in
        ``round_stats``."""
        self._check_open()
        if self._mlp is None:
            raise RuntimeError("call init_mlp(layer_sizes) first")
        w, b, lr = self._mlp
        loss, elapsed, stats = coded_mlp_step(
            w, b, self.engine.matmul, x, y, lr=lr, round0=self._round)
        self._round += len(stats)
        self.round_stats.extend(stats)
        return loss, elapsed

    def mlp_accuracy(self, x, y) -> float:
        self._check_open()
        if self._mlp is None:
            raise RuntimeError("call init_mlp(layer_sizes) first")
        return _mlp_accuracy(self._mlp[0], self._mlp[1], x, y)

    def anytime_curve(self, a, b, round_idx: int = 0, *, noise=None):
        """Error-vs-latency curve of one round (one ``coded_matmul`` and
        one ``berrut_combine`` launch); see
        :meth:`repro_torch.runtime.engine.RoundEngine.anytime_curve`.
        ``noise`` optionally supplies the (T, blk, d) noise blocks."""
        self._check_open()
        return self.engine.anytime_curve(a, b, round_idx=round_idx,
                                         noise=noise)

    # ------------------------------------------------------------- serving
    def serve(self, arch="qwen2-7b", *, tiny: bool = True,
              batch: Optional[int] = None, prompt_len: int = 16,
              gen: int = 32, seed: int = 0, check_agreement: bool = True,
              requests=None, arrival_rate: float = 0.0,
              ragged: bool = False,
              admission: str = "continuous") -> ServeReport:
        """Continuous-batching greedy decode with every selected
        projection run as coded rounds (``ServeSpec.coded_layers``).

        Requests are served off an arrival timeline by the scheduler in
        :mod:`repro_torch.runtime.serve_loop`: free slots admit arrivals at
        step boundaries, finished/EOS requests are evicted and their slots
        refilled, and the step only sees pow2 batch buckets.  On the
        virtual transport the WHOLE step — attention q/k/v/o, FFN
        up/down, unembed, per the spec's ``coded_layers`` — is ONE coded
        round under one straggler plan and the spec's wait policy; with
        ``WaitSpec(policy="deadline", t_budget=...)`` every step decodes
        at (or before) the budget from whatever responder prefix arrived.
        The real transports (``threads``, the ``socket`` mesh of worker
        processes) run the unembed as one real round per step.

        ``arch`` is an architecture name (``tiny`` picks its reduced
        config) or a ``ModelConfig``.  The model is built once per
        (arch, tiny, seed) on the session's device by
        ``models.build_model`` from a generator seeded with ``seed``.
        ``requests`` (a list of ``runtime.serve_loop.Request``) overrides
        the synthetic workload; otherwise ``batch`` requests of
        ``prompt_len``/``gen`` arrive Poisson at ``arrival_rate`` req/s
        (0 = all at t=0; with a uniform workload ``tokens`` is exactly
        (batch, gen)).  ``admission="gated"`` reproduces the static-batch
        baseline.  ``check_agreement`` replays the workload uncoded and
        reports the fraction of coded tokens that match.  An
        encoder-decoder config raises ``ValueError``.
        """
        self._check_open()
        from ..configs import get_config, tiny_config
        from ..models import build_model
        from ..runtime.serve_loop import (ContinuousBatcher, poisson_workload,
                                          refuse_encoder_decoder)

        mkey = (arch, tiny, seed)
        if mkey not in self._serve_models:
            if isinstance(arch, str):
                cfg = tiny_config(arch) if tiny else get_config(arch)
            else:
                cfg = arch
            refuse_encoder_decoder(cfg)
            self._serve_models[mkey] = build_model(cfg, device=self.device,
                                                   seed=seed)
        model = self._serve_models[mkey]
        cfg = model.cfg
        serve_spec = self.spec.serve
        n_req = batch if batch is not None else serve_spec.max_slots
        if requests is None:
            requests = poisson_workload(
                n_req, rate_rps=arrival_rate, prompt_len=prompt_len,
                gen=gen, vocab=cfg.vocab_size, seed=seed, ragged=ragged)

        def run_loop(coded_layers: str):
            # batchers are cached across serve() calls: encoded serving
            # weights and warm buckets are reused
            bkey = mkey + (coded_layers, admission)
            bat = self._serve_batchers.get(bkey)
            if bat is None:
                bat = ContinuousBatcher(
                    self.engine, model, coded_layers=coded_layers,
                    max_slots=serve_spec.max_slots, eos_id=serve_spec.eos_id,
                    backend=self.spec.transport.backend, admission=admission)
                self._serve_batchers[bkey] = bat
            bat._round = self._round
            res = bat.run(requests)
            self._round = bat._round
            return res

        res = run_loop(serve_spec.coded_layers)
        # token matrix, -1 padded for ragged generation lengths
        max_gen = max((len(r.tokens) for r in res.requests), default=0)
        tokens = np.full((len(res.requests), max_gen), -1, np.int32)
        for i, r in enumerate(res.requests):
            tokens[i, :len(r.tokens)] = r.tokens

        # fidelity diagnostic OUTSIDE the serve accounting: greedy tokens
        # of a request depend only on its own prompt, so the uncoded
        # reference is one plain continuous-batching replay of the same
        # workload.  Production-shaped callers pass check_agreement=False
        # (agreement reports NaN).
        agree = float("nan")
        if check_agreement:
            if res.mode == "plain":
                agree = 1.0
            else:
                ref = run_loop("none")
                match = total = 0
                for a, b_ in zip(res.requests, ref.requests):
                    n = min(len(a.tokens), len(b_.tokens))
                    match += int(np.sum(a.tokens[:n] == b_.tokens[:n]))
                    total += max(len(a.tokens), len(b_.tokens))
                agree = match / max(total, 1)
        self.round_stats.extend(res.step_stats)
        return ServeReport(
            tokens=tokens, step_stats=res.step_stats,
            wall_s=res.busy_wall_s, tok_s=res.tok_s,
            t_budget=self.spec.wait.t_budget, argmax_agreement=agree,
            requests=res.requests, ttft_s=res.ttft_s,
            step_latency_s=res.step_virtual_s, p50_step_s=res.p50_step_s,
            p99_step_s=res.p99_step_s, requests_per_s=res.requests_per_s,
            virtual_s=res.virtual_s, busy_wall_s=res.busy_wall_s,
            coded_fraction=res.coded_fraction, trace_count=res.trace_count,
            mode=res.mode, step_wall_s=res.step_wall_s)
