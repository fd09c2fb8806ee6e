"""The declarative front door: one frozen, serializable ``ClusterSpec``.

The paper's pitch is a *single* scheme buying resilience, privacy and
security simultaneously — the user-facing surface should read the same
way.  A :class:`ClusterSpec` names every choice the whole stack consumes
(coding scheme, privacy level, transmission crypto, wait policy,
straggler environment, transport backend) as nested frozen dataclasses
with validation and a lossless ``to_dict``/``from_dict`` round trip, so
one JSON blob pins down an entire experiment:

    spec = ClusterSpec(
        code=CodeSpec(scheme="spacdc", n_workers=20, k_blocks=5),
        privacy=PrivacySpec(t_colluding=2, noise_scale=0.05),
        wait=WaitSpec(policy="deadline", t_budget=0.005),
    )
    with Session(spec) as s:
        out, stats = s.matmul(a, b)

Every workload (matmul, anytime curves, MLP training, serving) and every
transport (virtual clock, threads, the socket mesh) plugs into
the same spec — swapping ``TransportSpec(backend="threads")`` for
``"virtual"`` changes nothing else.  The legacy ``DistributedMatmul``
constructor knobs map 1:1 onto spec fields via
:meth:`ClusterSpec.from_legacy_kwargs` (see the README migration table).

Ports ``repro/api/spec.py`` whole, so that any spec's ``to_dict()`` JSON
loads in both packages and compares equal.  The device a round runs on is
not a spec field (``from_dict`` rejects unknown keys, so a ``device`` field
would break loading the same JSON in the reference): it is the
``device=`` argument of ``repro_torch.api.Session``.  Validation builds the
scheme through the port's registry, which names only the schemes ported so
far.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

from ..runtime.wait_policy import (Deadline, ErrorTarget, FirstK,
                                   FixedQuantile, WaitPolicy)
from ..runtime.straggler import STRAGGLER_MODES, StragglerModel

__all__ = [
    "CodeSpec", "PrivacySpec", "CryptoSpec", "WaitSpec", "StragglerSpec",
    "TransportSpec", "FaultSpec", "ServeSpec", "AdaptiveSpec",
    "ClusterSpec",
]

def _transport_backends() -> tuple:
    """Registered transport backends, enumerated from the runtime's
    registry — a new transport registered in ``runtime.transport``
    is immediately a valid spec value (and CLI choice) with no spec
    edit."""
    from ..runtime.transport import available_backends
    return available_backends()


_CIPHER_MODES = ("stream", "paper")
_CODED_LAYERS = ("none", "unembed", "attn", "ffn", "all")
_ENCRYPT_MODES = (None, "modeled", "real")
_WAIT_POLICIES = ("fixed_quantile", "first_k", "deadline", "error_target")
_CORRUPT_MODES = ("scale", "bitflip")


def _as_dict(obj) -> Dict[str, Any]:
    """dataclasses.asdict, with Mapping fields coerced to plain dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = v.to_dict()
        elif isinstance(v, Mapping):
            v = dict(v)
        out[f.name] = v
    return out


def _from_dict(cls, d: Mapping, path: str):
    """Strict dataclass construction: unknown keys are an error (a typo'd
    spec field silently falling back to a default is how experiments lie)."""
    if not isinstance(d, Mapping):
        raise TypeError(f"{path}: expected a mapping, got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"{path}: unknown key(s) {unknown}; valid keys: "
                         f"{sorted(known)}")
    return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Which code runs the rounds, and at what block geometry.

    ``extra`` carries scheme-specific factory kwargs (``deg_f`` for LCC,
    ``p``/``q`` for Polynomial, encoder-side ``fh_degree`` for SPACDC, ...)
    straight through ``repro_torch.core.registry.build``.
    """
    scheme: str = "spacdc"
    n_workers: int = 8
    k_blocks: int = 4
    fused: Optional[bool] = None    # None = auto (fused when stable)
    use_kernel: Optional[bool] = None  # None = auto (Pallas on TPU)
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n_workers < 1 or self.k_blocks < 1:
            raise ValueError(f"code: need n_workers >= 1 and k_blocks >= 1, "
                             f"got N={self.n_workers}, K={self.k_blocks}")
        object.__setattr__(self, "extra", dict(self.extra))

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "CodeSpec":
        return _from_dict(cls, d, "code")


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """The paper's information-theoretic privacy knob: T noise blocks
    tolerate T colluding workers; ``noise_scale`` is their std (the
    field-uniform analogue — see ``core.privacy.gaussian_mi_bound``)."""
    t_colluding: int = 0
    noise_scale: float = 1.0

    def __post_init__(self):
        if self.t_colluding < 0:
            raise ValueError("privacy: t_colluding must be >= 0")
        if self.noise_scale < 0:
            raise ValueError("privacy: noise_scale must be >= 0")

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PrivacySpec":
        return _from_dict(cls, d, "privacy")


@dataclasses.dataclass(frozen=True)
class CryptoSpec:
    """Transmission security (MEA-ECC, paper §IV).

    ``encrypt``: ``None`` (off), ``"modeled"`` (cost priced from a measured
    per-element rate) or ``"real"`` (genuine limb-vectorized ciphertexts on
    every master↔worker transfer, measured ``crypto_s``).  ``cipher_mode``:
    ``"stream"`` (per-message nonces — the hardened default) or ``"paper"``
    (the paper-faithful single-mask construction).

    ``fused``: whether a ``"real"`` round runs as ONE jitted dispatch
    (keystream + mask-add inside the coded-matmul program — see
    ``kernels.encrypted_round``) or as the staged path split at its wire
    boundaries.  ``None`` (default) fuses whenever the round itself is
    fused (``code.fused`` resolution + virtual transport); ``True``
    demands it (validation rejects specs whose round can't fuse);
    ``False`` keeps the staged path.  Outputs are bit-identical either
    way."""
    encrypt: Optional[str] = None
    cipher_mode: str = "stream"
    fused: Optional[bool] = None

    def __post_init__(self):
        # accept the legacy DistributedMatmul spellings at the boundary
        mode = {False: None, True: "modeled"}.get(self.encrypt, self.encrypt)
        object.__setattr__(self, "encrypt", mode)
        if self.encrypt not in _ENCRYPT_MODES:
            raise ValueError(f"crypto: encrypt must be one of "
                             f"{_ENCRYPT_MODES}, got {self.encrypt!r}")
        if self.cipher_mode not in _CIPHER_MODES:
            raise ValueError(f"crypto: cipher_mode must be one of "
                             f"{_CIPHER_MODES}, got {self.cipher_mode!r}")
        if self.fused not in (None, True, False):
            raise ValueError(f"crypto: fused must be None, True or False, "
                             f"got {self.fused!r}")
        if self.fused is not None and self.encrypt != "real":
            raise ValueError(
                "crypto: fused only applies to encrypt='real' (the modeled "
                f"mode has no wire to fuse) — got encrypt={self.encrypt!r}")

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "CryptoSpec":
        return _from_dict(cls, d, "crypto")


@dataclasses.dataclass(frozen=True)
class WaitSpec:
    """When the master stops waiting and decodes — plus the decode-side
    Floater–Hormann degree, promoted here from an internal proxy detail.

    ``fh_degree`` is the blending degree of the *embedded-pair* decoder
    (the second, higher-order decode whose disagreement with the Berrut
    decode estimates its error in-trace).  Default 2: the BENCH_anytime
    parity-oscillation notes — raw Berrut per-prefix errors oscillate with
    responder-count parity, and the d=2 Floater–Hormann interpolant is the
    lowest degree whose disagreement tracks the oscillation envelope
    instead of riding it (d=0 is Berrut itself and estimates nothing;
    d=1 still inherits most of the parity swing).
    """
    policy: str = "fixed_quantile"
    k: Optional[int] = None            # first_k: decode at the k-th arrival
    t_budget: Optional[float] = None   # deadline: seconds from round start
    eps: Optional[float] = None        # error_target: proxy threshold
    min_prefix: int = 4                # error_target: proxy warm-up guard
    fh_degree: int = 2                 # embedded-pair proxy decoder degree

    def __post_init__(self):
        if self.policy not in _WAIT_POLICIES:
            raise ValueError(f"wait: policy must be one of {_WAIT_POLICIES}, "
                             f"got {self.policy!r}")
        if self.policy == "first_k" and (self.k is None or self.k < 1):
            raise ValueError("wait: first_k needs k >= 1")
        if self.policy == "deadline" and (self.t_budget is None or
                                          self.t_budget <= 0):
            raise ValueError("wait: deadline needs t_budget > 0 seconds")
        if self.policy == "error_target" and (self.eps is None or
                                              self.eps <= 0):
            raise ValueError("wait: error_target needs eps > 0")
        # a parameter belonging to a DIFFERENT policy is a typo'd spec
        # (e.g. policy="deadline" with eps set almost certainly meant
        # error_target) — reject it rather than silently ignore it
        owners = {"k": "first_k", "t_budget": "deadline",
                  "eps": "error_target"}
        for param, owner in owners.items():
            if getattr(self, param) is not None and self.policy != owner:
                raise ValueError(
                    f"wait: {param}= belongs to policy {owner!r}, not "
                    f"{self.policy!r}")
        if self.fh_degree < 0:
            raise ValueError("wait: fh_degree must be >= 0")
        if self.policy == "error_target" and self.fh_degree < 1:
            # d=0 Floater–Hormann IS Berrut: the embedded pair degenerates,
            # the proxy reads 0 everywhere, and ErrorTarget stops blindly
            raise ValueError("wait: error_target needs fh_degree >= 1 "
                             "(d=0 is the Berrut decode itself — the "
                             "embedded-pair proxy would estimate nothing)")

    def build(self) -> WaitPolicy:
        """The strategy object the round scheduler consumes."""
        if self.policy == "first_k":
            return FirstK(self.k)
        if self.policy == "deadline":
            return Deadline(self.t_budget)
        if self.policy == "error_target":
            return ErrorTarget(self.eps, min_prefix=self.min_prefix)
        return FixedQuantile()

    @classmethod
    def from_policy(cls, policy: WaitPolicy,
                    fh_degree: int = 2) -> Optional["WaitSpec"]:
        """Spec form of a known policy instance, or None for custom
        subclasses (which stay object-only and can't serialize)."""
        if type(policy) is FixedQuantile:
            return cls(fh_degree=fh_degree)
        if type(policy) is FirstK:
            return cls(policy="first_k", k=policy.k, fh_degree=fh_degree)
        if type(policy) is Deadline:
            return cls(policy="deadline", t_budget=policy.t_budget,
                       fh_degree=fh_degree)
        if type(policy) is ErrorTarget:
            return cls(policy="error_target", eps=policy.eps,
                       min_prefix=policy.min_prefix, fh_degree=fh_degree)
        return None

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "WaitSpec":
        return _from_dict(cls, d, "wait")


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """The injected straggler environment (paper §VII-B sleep() delays;
    ``pareto``/``markov`` are the beyond-paper heavy-tail/bursty modes,
    ``shifting_markov`` the non-stationary regime-schedule trace the
    adaptive controller is benchmarked against).  ``seed=None`` follows
    the cluster seed.

    Parameters are validated HERE (and again in ``StragglerModel``), so a
    typo'd probability or an α ≤ 1 Pareto tail (undefined mean) fails at
    spec construction instead of deep inside ``delays()`` mid-run."""
    n_stragglers: int = 0
    delay_s: float = 0.02
    jitter_scale: float = 0.002
    mode: str = "paper"
    pareto_shape: float = 1.5
    p_fail: float = 0.1
    p_recover: float = 0.5
    # shifting_markov: ((p_fail, p_recover), ...) cycled every regime_len
    # rounds; () = runtime.straggler.DEFAULT_SHIFT_REGIMES
    regimes: tuple = ()
    regime_len: int = 40
    seed: Optional[int] = None

    def __post_init__(self):
        if self.n_stragglers < 0:
            raise ValueError("straggler: n_stragglers must be >= 0")
        if self.mode not in STRAGGLER_MODES:
            raise ValueError(f"straggler: unknown mode {self.mode!r} "
                             f"({' | '.join(STRAGGLER_MODES)})")
        if self.delay_s < 0 or self.jitter_scale < 0:
            raise ValueError("straggler: delay_s and jitter_scale must "
                             "be >= 0")
        if not self.pareto_shape > 1.0:
            raise ValueError(
                f"straggler: pareto_shape must be > 1 (a tail index α ≤ 1 "
                f"has an undefined mean), got {self.pareto_shape!r}")
        for name in ("p_fail", "p_recover"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"straggler: {name} must be in [0, 1], "
                                 f"got {v!r}")
        if self.regime_len < 1:
            raise ValueError("straggler: regime_len must be >= 1")
        # JSON round trips lists; coerce back to tuples so frozen-spec
        # equality survives to_dict/from_dict
        regimes = tuple(tuple(float(p) for p in r) for r in self.regimes)
        for r in regimes:
            if len(r) != 2 or not all(0.0 <= p <= 1.0 for p in r):
                raise ValueError(
                    f"straggler: each regime must be a (p_fail, p_recover) "
                    f"pair in [0, 1]^2, got {r!r}")
        object.__setattr__(self, "regimes", regimes)

    def build(self, n_workers: int, seed: int) -> StragglerModel:
        return StragglerModel(
            n_workers, self.n_stragglers, delay_s=self.delay_s,
            jitter_scale=self.jitter_scale,
            seed=self.seed if self.seed is not None else seed,
            mode=self.mode, pareto_shape=self.pareto_shape,
            p_fail=self.p_fail, p_recover=self.p_recover,
            regimes=self.regimes, regime_len=self.regime_len)

    @classmethod
    def from_model(cls, m: StragglerModel) -> "StragglerSpec":
        return cls(n_stragglers=m.n_stragglers, delay_s=m.delay_s,
                   jitter_scale=m.jitter_scale, mode=m.mode,
                   pareto_shape=m.pareto_shape, p_fail=m.p_fail,
                   p_recover=m.p_recover, regimes=m.regimes,
                   regime_len=m.regime_len, seed=m.seed)

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "StragglerSpec":
        return _from_dict(cls, d, "straggler")


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """Which backend carries master↔worker rounds.

    ``"virtual"`` — the analytic virtual clock (benchmarks; Fig-3 sweeps
    in seconds).  ``"threads"`` — real thread workers with sleep()-injected
    delays behind the same event API (validates the clock).  ``"socket"``
    — a localhost TCP mesh of real worker *processes*
    (``runtime.socket_transport``): framed CRC-checked messages, per-worker
    heartbeats with liveness deadlines, automatic respawn/reconnect, and
    OS-level fault injection (``FaultSpec.os_level``).  Valid names come
    off the ``runtime.transport.TRANSPORTS`` registry.

    The socket knobs (ignored by the in-process backends):

    * ``heartbeat_s`` — worker PING period;
    * ``liveness_timeout_s`` — heartbeat silence after which a pending
      worker is written off for the round (must exceed ``heartbeat_s``);
    * ``connect_timeout_s`` — mesh start-up / worker-dial deadline;
    * ``max_respawns`` — relaunch budget per crashed worker;
    * ``bind`` — master listen address (``"127.0.0.1:0"`` = any port;
      bind a routable address to accept workers started by hand);
    * ``spawn_workers`` — False = only listen, workers are launched
      externally (``python -m repro_torch.launch.worker``).
    """
    backend: str = "virtual"
    heartbeat_s: float = 0.2
    liveness_timeout_s: float = 1.5
    connect_timeout_s: float = 60.0
    max_respawns: int = 3
    bind: str = "127.0.0.1:0"
    spawn_workers: bool = True

    def __post_init__(self):
        backends = _transport_backends()
        if self.backend not in backends:
            raise ValueError(f"transport: backend must be one of "
                             f"{backends}, got {self.backend!r}")
        if self.heartbeat_s <= 0 or self.liveness_timeout_s <= 0:
            raise ValueError("transport: heartbeat_s and liveness_timeout_s "
                             "must be > 0")
        if self.liveness_timeout_s <= self.heartbeat_s:
            raise ValueError("transport: liveness_timeout_s must exceed "
                             "heartbeat_s (a healthy worker must be able "
                             "to beat before its deadline)")
        if self.connect_timeout_s <= 0:
            raise ValueError("transport: connect_timeout_s must be > 0")
        if self.max_respawns < 0:
            raise ValueError("transport: max_respawns must be >= 0")

    def backend_options(self) -> Dict[str, Any]:
        """The backend-specific factory kwargs (socket mesh knobs; empty
        for the in-process backends)."""
        if self.backend != "socket":
            return {}
        return {"heartbeat_s": self.heartbeat_s,
                "liveness_timeout_s": self.liveness_timeout_s,
                "connect_timeout_s": self.connect_timeout_s,
                "max_respawns": self.max_respawns,
                "bind": self.bind,
                "spawn_workers": self.spawn_workers}

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "TransportSpec":
        return _from_dict(cls, d, "transport")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault *injection* and fault *handling*, both seeded and declarative.

    Injection (consumed by ``runtime.faults.FaultInjectingTransport``,
    which wraps either backend behind the unchanged transport protocol):
    per round, each worker independently crashes (no event ever arrives),
    drops (event arrives, ``result()`` raises), suffers a delay spike, or
    returns a corrupted payload — ``"scale"`` garbage or ``"bitflip"``
    sign/exponent flips, applied to the ciphertext limbs on
    ``encrypt="real"`` rounds.  ``seed=None`` follows the cluster seed;
    the fault plan for a given (seed, round) is reproducible across
    backends and runs.

    Handling (consumed by the engine's defended round runner when
    ``handle=True``): per-round worker deadline → re-dispatch of missing
    shard assignments to healthy workers with capped exponential backoff
    (``max_retries``, ``backoff_s``/``backoff_cap_s``); Byzantine
    screening — gross norm outliers (result norm > ``norm_factor ×``
    median responder norm, robust to many simultaneous corrupters) plus
    leave-one-out decode residuals (a responder whose result disagrees
    with the interpolation through the others by more than
    ``max(residual_threshold, residual_factor × median)`` is cleared
    from the decode mask); a ``WorkerHealth`` tracker quarantining
    repeat offenders (``quarantine_after`` strikes → ``quarantine_rounds``
    rounds out, doubling per relapse).
    """
    # --- injection rates (all 0.0 = no injection) ---
    crash_rate: float = 0.0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    delay_spike_rate: float = 0.0
    delay_spike_s: float = 0.1
    corrupt_mode: str = "scale"
    corrupt_scale: float = 1e3
    seed: Optional[int] = None
    # OS-level injection (socket backend only): the SAME seeded plan is
    # realized physically — crash → SIGKILL the worker PID mid-round,
    # delay spike → SIGSTOP/SIGCONT, drop → frame bytes tampered after
    # the CRC is computed (caught by the master's CRC check), corrupt →
    # the worker process perturbs its result with the simulated
    # injector's exact rng stream (screened by the Byzantine stages)
    os_level: bool = False
    # --- handling ---
    handle: bool = False
    max_retries: int = 2
    backoff_s: float = 0.005
    backoff_cap_s: float = 0.08
    worker_timeout_s: Optional[float] = None   # None = timeout_factor rule
    timeout_factor: float = 3.0
    screen: bool = True
    residual_threshold: float = 2.0
    residual_factor: float = 8.0
    norm_factor: float = 30.0
    quarantine_after: int = 2
    quarantine_rounds: int = 4

    def __post_init__(self):
        for name in ("crash_rate", "drop_rate", "corrupt_rate",
                     "delay_spike_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault: {name} must be in [0, 1], "
                                 f"got {v!r}")
        if self.delay_spike_s < 0:
            raise ValueError("fault: delay_spike_s must be >= 0")
        if self.corrupt_mode not in _CORRUPT_MODES:
            raise ValueError(f"fault: corrupt_mode must be one of "
                             f"{_CORRUPT_MODES}, got {self.corrupt_mode!r}")
        if self.corrupt_scale <= 0:
            raise ValueError("fault: corrupt_scale must be > 0")
        if self.max_retries < 0:
            raise ValueError("fault: max_retries must be >= 0")
        if self.backoff_s < 0 or self.backoff_cap_s < self.backoff_s:
            raise ValueError("fault: need 0 <= backoff_s <= backoff_cap_s")
        if self.worker_timeout_s is not None and self.worker_timeout_s <= 0:
            raise ValueError("fault: worker_timeout_s must be > 0 (or None "
                             "for the timeout_factor rule)")
        if self.timeout_factor <= 0:
            raise ValueError("fault: timeout_factor must be > 0")
        if self.residual_threshold <= 0 or self.residual_factor <= 0:
            raise ValueError("fault: residual_threshold and residual_factor "
                             "must be > 0")
        if self.norm_factor <= 1:
            raise ValueError("fault: norm_factor must be > 1 (clean coded "
                             "rows already spread above the median norm)")
        if self.quarantine_after < 1 or self.quarantine_rounds < 1:
            raise ValueError("fault: quarantine_after and quarantine_rounds "
                             "must be >= 1")

    @property
    def injects(self) -> bool:
        """True when any fault is actually injected."""
        return (self.crash_rate > 0 or self.drop_rate > 0 or
                self.corrupt_rate > 0 or self.delay_spike_rate > 0)

    @property
    def active(self) -> bool:
        """True when this spec changes round behavior at all — either
        injecting faults or running the defended round path."""
        return self.injects or self.handle

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultSpec":
        return _from_dict(cls, d, "fault")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Continuous-batching serving knobs (``Session.serve``).

    ``coded_layers`` selects which per-step projections run as coded
    work — the Eq.-23 layout generalizes from the unembed to every
    ``x @ W`` in the decode step:

    * ``"none"``    — plain local decode (the ``--uncoded`` baseline);
    * ``"unembed"`` — output projection only (the first coded-serving layout);
    * ``"attn"``    — attention q/k/v and o projections + unembed;
    * ``"ffn"``     — FFN up/(gate)/down projections + unembed;
    * ``"all"``     — attn + ffn + unembed (coded FLOP fraction → 1).

    All selected projections of a step are *stacked into one coded
    round*: one straggler plan, one decode mask, one dispatch.  Real
    transports (threads/socket) ship whole per-site rounds over the
    event loop and are restricted to ``"none"``/``"unembed"``; the
    fused whole-step stack is virtual-clock only.

    ``max_slots`` bounds the in-flight request batch of the continuous
    -batching loop (``runtime.serve_loop``); active slots are packed at
    the front and padded up to the next power of two so admission/
    eviction churn never retriggers compilation.  ``eos_id`` (optional)
    ends a request early when greedy decode emits it.
    """
    coded_layers: str = "unembed"
    max_slots: int = 8
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.coded_layers not in _CODED_LAYERS:
            raise ValueError(f"serve: coded_layers must be one of "
                             f"{_CODED_LAYERS}, got {self.coded_layers!r}")
        if self.max_slots < 1:
            raise ValueError("serve: max_slots must be >= 1")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError("serve: eos_id must be >= 0 (or None)")

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServeSpec":
        return _from_dict(cls, d, "serve")


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """The between-rounds redundancy controller (``runtime.adaptive``).

    ``policy="fixed"`` (default) changes nothing: the Session runs the
    hand-set K/N, wait policy and fh_degree forever, exactly as before.
    ``policy="adaptive"`` closes the loop: an online estimator fits the
    straggler model (markov transition rates, pareto tail, paper-mode
    shift/scale) from the arrival timestamps every round already records,
    and every ``retune_every`` rounds (after ``warmup_rounds`` of pure
    observation) the controller re-picks the redundancy N−K, the wait
    policy and ``fh_degree`` that minimize predicted latency at
    ``target_rel_err`` under the fitted model.  Candidate redundancy is
    bounded to [``min_redundancy``, ``max_redundancy``] (and at most
    ``max_candidates`` K values), so the fused-kernel cache warms once
    per candidate and retuning never recompiles per round.

    * ``latency_budget_s`` — optional hard budget: when the predicted
      wait at the error target exceeds it, the controller falls back to a
      ``Deadline`` round at the budget (best-effort accuracy).
    * ``window`` / ``cp_window`` / ``cp_threshold`` — estimator sliding
      window length and change-point detector: when the congested
      fraction over the last ``cp_window`` rounds jumps by more than
      ``cp_threshold`` vs the preceding ``cp_window``, the window resets
      so a regime shift is re-fit within a bounded number of rounds.
    * ``quantize_s`` — observation grid (seconds).  Arrival timestamps
      are quantized before fitting so the virtual clock and the real
      thread transport produce identical fits (and identical controller
      decisions) for the same trace + seed.
    """
    policy: str = "fixed"               # "fixed" | "adaptive"
    target_rel_err: float = 1e-2
    latency_budget_s: Optional[float] = None
    retune_every: int = 2
    warmup_rounds: int = 6
    min_redundancy: int = 1             # bounds on N − K
    max_redundancy: Optional[int] = None    # None = N − 1
    max_candidates: int = 5
    window: int = 64
    cp_window: int = 6
    cp_threshold: float = 0.25
    quantize_s: float = 1e-3

    def __post_init__(self):
        if self.policy not in ("fixed", "adaptive"):
            raise ValueError(f"adaptive: policy must be 'fixed' or "
                             f"'adaptive', got {self.policy!r}")
        if self.target_rel_err <= 0:
            raise ValueError("adaptive: target_rel_err must be > 0")
        if self.latency_budget_s is not None and self.latency_budget_s <= 0:
            raise ValueError("adaptive: latency_budget_s must be > 0 "
                             "(or None)")
        if self.retune_every < 1 or self.warmup_rounds < 0:
            raise ValueError("adaptive: need retune_every >= 1 and "
                             "warmup_rounds >= 0")
        if self.min_redundancy < 1:
            raise ValueError("adaptive: min_redundancy must be >= 1 "
                             "(a rateless round still needs headroom to "
                             "drop stragglers)")
        if (self.max_redundancy is not None and
                self.max_redundancy < self.min_redundancy):
            raise ValueError("adaptive: max_redundancy must be >= "
                             "min_redundancy (or None)")
        if self.max_candidates < 1:
            raise ValueError("adaptive: max_candidates must be >= 1")
        if self.window < 4:
            raise ValueError("adaptive: window must be >= 4 rounds")
        if self.cp_window < 2 or self.cp_window * 2 > self.window:
            raise ValueError("adaptive: need 2 <= cp_window <= window/2")
        if not 0.0 < self.cp_threshold < 1.0:
            raise ValueError("adaptive: cp_threshold must be in (0, 1)")
        if self.quantize_s <= 0:
            raise ValueError("adaptive: quantize_s must be > 0")

    @property
    def enabled(self) -> bool:
        return self.policy == "adaptive"

    def to_dict(self):
        return _as_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "AdaptiveSpec":
        return _from_dict(cls, d, "adaptive")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Everything a :class:`repro_torch.api.Session` needs, in one frozen value.

    ``validate()`` checks cross-field combinations the nested specs can't
    see (pair-coded scheme × fused, threads × fused/proxy policies); the
    Session runs it on entry, and ``from_dict`` re-checks after a
    round trip.
    """
    code: CodeSpec = dataclasses.field(default_factory=CodeSpec)
    privacy: PrivacySpec = dataclasses.field(default_factory=PrivacySpec)
    crypto: CryptoSpec = dataclasses.field(default_factory=CryptoSpec)
    wait: WaitSpec = dataclasses.field(default_factory=WaitSpec)
    straggler: StragglerSpec = dataclasses.field(
        default_factory=StragglerSpec)
    transport: TransportSpec = dataclasses.field(
        default_factory=TransportSpec)
    fault: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    adaptive: AdaptiveSpec = dataclasses.field(default_factory=AdaptiveSpec)
    seed: int = 0
    pipeline_encode: bool = False

    # ------------------------------------------------------------ validate
    def validate(self, scheme=None) -> "ClusterSpec":
        """Cross-field validation; returns self so call sites can chain.

        Builds the scheme through the registry (cheap — coding matrices at
        these N are tiny) to check combinations that depend on scheme
        capabilities rather than names; a caller that already built it
        passes it in.
        """
        if scheme is None:
            scheme = self.build_scheme()
        supports_fused = bool(getattr(scheme, "supports_fused", False))
        if self.code.fused and not supports_fused:
            raise ValueError(
                f"{self.code.scheme!r} has no fused round path (pair-coded "
                "or non-linear encode) — drop code.fused=True")
        if self.transport.backend != "virtual":
            # every real backend (threads, socket) runs the event-driven
            # loop round
            if self.code.fused:
                raise ValueError(
                    f"transport {self.transport.backend!r} runs the "
                    "event-driven loop round; the fused single-dispatch "
                    "path is virtual-clock only — drop code.fused=True")
            if self.wait.policy == "error_target":
                raise ValueError(
                    "error_target needs the virtual clock's batched prefix "
                    "pipeline (real backends validate the clock) — use "
                    "transport 'virtual'")
        if (self.transport.backend != "virtual" and
                self.serve.coded_layers not in ("none", "unembed")):
            raise ValueError(
                f"serve: coded_layers={self.serve.coded_layers!r} stacks "
                "every selected projection of a step into one fused "
                "dispatch, which is virtual-clock only; transport "
                f"{self.transport.backend!r} runs per-round wire traffic — "
                "use coded_layers 'none'/'unembed' or transport 'virtual'")
        if self.fault.os_level and self.transport.backend != "socket":
            raise ValueError(
                "fault: os_level=True needs real worker processes to "
                "signal — use transport 'socket' (the in-process backends "
                "simulate the same seeded plan with os_level=False)")
        if (self.wait.policy == "first_k" and
                self.wait.k > self.code.n_workers):
            raise ValueError(f"wait: first_k k={self.wait.k} exceeds "
                             f"n_workers={self.code.n_workers}")
        if self.fault.active:
            # the fault paths (envelope dispatch, LOO residual screening,
            # slot-indexed re-dispatch) ride on the linear fused-encoder
            # stack; pair-coded schemes have no per-worker encoder rows
            # to screen against
            if not supports_fused:
                raise ValueError(
                    f"fault: {self.code.scheme!r} is pair-coded (no "
                    "per-worker encoder rows) — the fault injection/"
                    "handling paths need a linear data-coded scheme")
            if self.wait.policy == "error_target":
                raise ValueError(
                    "fault: error_target's batched prefix pipeline does "
                    "not compose with injected/handled faults — use "
                    "fixed_quantile, first_k or deadline")
            if self.crypto.fused:
                raise ValueError(
                    "fault: crypto.fused=True runs the round as ONE "
                    "dispatch with no per-worker results to screen or "
                    "retry — drop crypto.fused or fault handling")
        if self.adaptive.enabled:
            # the controller retunes K by rebuilding the scheme through the
            # registry and predicts error from per-prefix decode profiles —
            # both need a linear data-coded scheme (per-worker encoder
            # rows); pair-coded schemes have neither
            if getattr(scheme, "pair_coded", False):
                raise ValueError(
                    f"adaptive: {self.code.scheme!r} is pair-coded — "
                    "redundancy retuning needs a linear data-coded scheme")
            n = self.code.n_workers
            max_red = (self.adaptive.max_redundancy
                       if self.adaptive.max_redundancy is not None
                       else n - 1)
            if self.adaptive.min_redundancy > n - 1:
                raise ValueError(
                    f"adaptive: min_redundancy={self.adaptive.min_redundancy}"
                    f" leaves no data blocks at n_workers={n}")
            if max_red > n - 1:
                raise ValueError(
                    f"adaptive: max_redundancy={max_red} exceeds "
                    f"n_workers-1={n - 1}")
        # NOTE: error_target × crypto "real" is a supported combination —
        # the anytime pipeline runs over genuine ciphertexts (fused: two
        # dispatches; staged: split at the wire boundaries).
        if self.crypto.fused:
            # crypto.fused=True demands the one-dispatch encrypted round,
            # which lives inside the fused round program — reject specs
            # whose round resolves to the loop path (mirrors the engine's
            # use_fused resolution)
            supports_fused = bool(getattr(scheme, "supports_fused", False))
            stable = bool(getattr(scheme, "fused_decode_stable", False))
            use_fused = ((supports_fused and stable)
                         if self.code.fused is None else bool(self.code.fused))
            if self.transport.backend != "virtual":
                raise ValueError(
                    "crypto.fused=True needs the virtual-clock fused round; "
                    f"transport {self.transport.backend!r} runs the "
                    "event-driven loop round — use transport 'virtual' or "
                    "drop crypto.fused")
            if not use_fused:
                raise ValueError(
                    "crypto.fused=True needs a fused round to fuse into, but "
                    f"this spec resolves to the loop path ({self.code.scheme!r}"
                    " unfused/unstable or code.fused=False) — set "
                    "code.fused=True on a linear data-coded scheme or drop "
                    "crypto.fused")
        return self

    def build_scheme(self):
        """Construct the coding scheme this spec names (via the registry)."""
        from ..core import registry
        return registry.build(
            self.code.scheme, n_workers=self.code.n_workers,
            k_blocks=self.code.k_blocks,
            t_colluding=self.privacy.t_colluding,
            noise_scale=self.privacy.noise_scale, seed=self.seed,
            use_kernel=self.code.use_kernel, **dict(self.code.extra))

    # --------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return _as_dict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ClusterSpec":
        if not isinstance(d, Mapping):
            raise TypeError(f"ClusterSpec.from_dict: expected a mapping, "
                            f"got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"ClusterSpec: unknown key(s) {unknown}; "
                             f"valid keys: {sorted(known)}")
        nested = {"code": CodeSpec, "privacy": PrivacySpec,
                  "crypto": CryptoSpec, "wait": WaitSpec,
                  "straggler": StragglerSpec, "transport": TransportSpec,
                  "fault": FaultSpec, "serve": ServeSpec,
                  "adaptive": AdaptiveSpec}
        kw = {}
        for key, val in d.items():
            sub = nested.get(key)
            kw[key] = sub.from_dict(val) if sub is not None else val
        # deserialized configs are untrusted — reject cross-field-invalid
        # combinations here, not at first use
        return cls(**kw).validate()

    @classmethod
    def from_json(cls, s: str) -> "ClusterSpec":
        return cls.from_dict(json.loads(s))

    # -------------------------------------------------------------- legacy
    @classmethod
    def from_legacy_kwargs(cls, scheme_name: str, n_workers: int,
                           k_blocks: int, t_colluding: int = 0,
                           straggler: Optional[StragglerModel] = None,
                           n_stragglers: int = 0,
                           encrypt: Any = False, seed: int = 0,
                           fused: Optional[bool] = None,
                           cipher_mode: str = "stream",
                           wait_policy: Any = None,
                           pipeline_encode: bool = False,
                           proxy_fh_degree: int = 2,
                           **scheme_kwargs) -> "ClusterSpec":
        """The old 14-knob ``DistributedMatmul`` surface, spec-ified.

        This is the migration table in executable form (README "Public
        API"): every legacy kwarg lands in exactly one spec field.  A
        custom ``WaitPolicy`` subclass has no spec form — callers keep
        passing the instance alongside (see ``DistributedMatmul``).
        """
        scheme_kwargs = dict(scheme_kwargs)
        noise_scale = scheme_kwargs.pop("noise_scale", 1.0)
        code = CodeSpec(scheme=scheme_name, n_workers=n_workers,
                        k_blocks=k_blocks, fused=fused,
                        use_kernel=scheme_kwargs.pop("use_kernel", None),
                        extra=scheme_kwargs)
        if straggler is not None:
            stragg = StragglerSpec.from_model(straggler)
        else:
            stragg = StragglerSpec(n_stragglers=n_stragglers)
        if isinstance(wait_policy, WaitSpec):
            # already declarative — keep it verbatim (resolve_policy would
            # round-trip through the built policy object and lose
            # fh_degree, which policy instances don't carry)
            wait = wait_policy
        else:
            from ..runtime.wait_policy import resolve_policy
            wait = WaitSpec.from_policy(resolve_policy(wait_policy),
                                        fh_degree=proxy_fh_degree)
            if wait is None:
                wait = WaitSpec(fh_degree=proxy_fh_degree)
        return cls(code=code,
                   privacy=PrivacySpec(t_colluding=t_colluding,
                                       noise_scale=noise_scale),
                   crypto=CryptoSpec(encrypt=encrypt,
                                     cipher_mode=cipher_mode),
                   wait=wait, straggler=stragg,
                   transport=TransportSpec(), seed=seed,
                   pipeline_encode=pipeline_encode)

    # -------------------------------------------------------------- presets
    @classmethod
    def paper_fig3(cls, n_stragglers: int = 7) -> "ClusterSpec":
        """The paper's Fig-3 training apparatus: N=30, K=24, T=3 SPACDC
        under S injected stragglers (S ∈ {0, 3, 5, 7} in the figure)."""
        return cls(code=CodeSpec(scheme="spacdc", n_workers=30, k_blocks=24),
                   privacy=PrivacySpec(t_colluding=3),
                   straggler=StragglerSpec(n_stragglers=n_stragglers))

    @classmethod
    def anytime_bench(cls, n_stragglers: int = 7) -> "ClusterSpec":
        """The BENCH_anytime SPACDC operating point: N=30, K=6, T=2,
        noise 0.05 — the error-vs-latency curve's smooth-workload trace."""
        return cls(code=CodeSpec(scheme="spacdc", n_workers=30, k_blocks=6),
                   privacy=PrivacySpec(t_colluding=2, noise_scale=0.05),
                   straggler=StragglerSpec(n_stragglers=n_stragglers))

    @classmethod
    def serve_deadline(cls, t_budget: float = 0.008, n_workers: int = 8,
                       k_blocks: int = 4, t_colluding: int = 1,
                       n_stragglers: int = 2, backend: str = "virtual",
                       coded_layers: str = "unembed",
                       max_slots: int = 8,
                       eos_id: Optional[int] = None) -> "ClusterSpec":
        """Deadline-bounded coded serving: every generation step's
        coded projections decode at (or before) ``t_budget`` seconds."""
        return cls(code=CodeSpec(scheme="spacdc", n_workers=n_workers,
                                 k_blocks=k_blocks),
                   privacy=PrivacySpec(t_colluding=t_colluding,
                                       noise_scale=0.05),
                   wait=WaitSpec(policy="deadline", t_budget=t_budget),
                   straggler=StragglerSpec(n_stragglers=n_stragglers),
                   transport=TransportSpec(backend=backend),
                   serve=ServeSpec(coded_layers=coded_layers,
                                   max_slots=max_slots, eos_id=eos_id))
