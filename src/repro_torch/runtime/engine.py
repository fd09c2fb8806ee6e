"""The coded-round engine behind ``repro_torch.api.Session``.

Ports ``RoundStats``, ``WorkerPool`` and the rounds of
``repro/runtime/engine.py``: ``RoundEngine.__init__`` with its crypto
setup, the latency model (``_worker_compute_time``,
``_round_compute_time``, ``_virtual_round_plan``), the encode-pipelining
credit, and these round paths on the engine's device:

* **fused** (``_matmul_fused``): encode → all N worker matmuls → masked
  decode, one ``coded_matmul`` and one ``berrut_combine`` launch of the
  port's CUDA kernels (their plain PyTorch versions on the CPU).  With
  ``encrypt="modeled"`` it also prices ``crypto_s`` from a measured
  per-element MEA-ECC rate (``_crypto_overhead_elems``).
* **fused real** (``_matmul_real_fused``, the default of
  ``encrypt="real"``): the same round with the MEA-ECC wire inside it
  (``kernels.ops.encrypted_coded_matmul``): on the card one
  ``berrut_combine`` encode, four ``mask_add`` launches (encrypt and
  decrypt of the shards out and of the results back), one ``coded_matmul``
  and the ``berrut_combine`` decode.  ``crypto_s`` is the wire work timed
  alone once per shape class (``_fused_crypto_time``).
* **staged real** (``crypto.fused=False``, ``_matmul_real``): the round
  split at its wire boundaries; every shard and every responder's result
  crosses as a genuine ``MEAECC`` ciphertext (``_wire``), two ``mask_add``
  launches per transfer.
* **anytime** (proxy-driven policies, ``ErrorTarget``; ``_matmul_anytime``
  and ``anytime_curve``): stage 1 is encode + all N worker products in one
  ``coded_matmul``; stage 2 decodes EVERY arrival prefix, Berrut and its
  Floater–Hormann embedded pair, in one ``kernels.ops.prefix_decode``
  (one ``berrut_combine`` over 2·E·K weight rows), then reassembles every
  prefix, takes the embedded-pair error proxies and, for a curve, the true
  errors against ``torch.matmul(a, b)``.  The policy stops at the earliest
  prefix whose proxy meets its target.
* **anytime real**: the anytime round over the MEA-ECC wire, fused
  (``_matmul_anytime_real_fused``: stage 1 is the fused real round's
  ``encrypted_coded_matmul``) or staged (``_matmul_anytime_real``: encode,
  every shard wired out, the products, stage 2, and only the arrivals up
  to the stop prefix wired back).  Proxies, stop and output are the plain
  anytime round's, bit for bit.
* **loop** (``_matmul_loop``: pair-coded schemes, ``code.fused=False``,
  linear schemes whose masked decode is not stable in float32, e.g. mds at
  K=24, and every real transport): the scheme's ``encode`` /
  ``encode_pair`` (``berrut_combine``), one ``torch.matmul`` per worker
  (``runtime.tasks``, IEEE float32), the scheme's exact ``decode``
  (``berrut_combine`` with float64-inverted weights) and
  ``reconstruct_matmul``.  On the virtual clock only the responders'
  products run, except under a proxy-driven policy, whose float64 proxies
  (``_loop_round``) need every worker's product.  On the ``threads``
  transport (``WorkerPool.run_round_real``) every worker's product runs on
  a thread and a CUDA stream of its own and the policy consumes real
  completions.  On the ``socket`` mesh (``runtime.socket_transport``)
  every worker's product runs in a worker process of its own and the
  policy consumes real completions the same way.  ``encrypt="real"``
  wires every shard out and every responder's result back through
  ``_wire``; on the mesh the round is **sealed** instead: every shard
  leaves the master as a genuine ciphertext (one encrypt each, plus a
  reply nonce), the worker process decrypts, multiplies and encrypts its
  product back (``tasks.SealedMatmulTask``, ``mask_add`` launches in the
  worker), and the master decrypts the responders' products.
  ``encrypt="modeled"`` prices ``crypto_s`` as the fused round does.

* **fault round** (``_matmul_faulted``, any active ``FaultSpec``): the
  transport is wrapped by ``runtime.faults.FaultInjectingTransport``; work
  travels in ``(worker, slot, payload[, nonce])`` envelopes
  (``runtime.tasks.EnvelopeMatmulTask``, one ``torch.matmul`` per
  dispatched worker, the shards and results on the device; on the mesh
  they cross as host bytes and come back on the device).  Defended
  rounds (``FaultSpec.handle``) screen the clean set
  (``scheduler.screen_responders``: float64 norms and leave-one-out
  predictions on the device), record offenders in ``WorkerHealth`` and
  re-dispatch missing slots with jittered backoff; exhausted rateless
  rounds decode the surviving prefix (``degraded``, with the embedded-pair
  ``achieved_rel_err`` in float64 on the device), exhausted threshold
  rounds raise ``DegradedRoundError`` with their partial state on the
  device.  The encode and the decode are the scheme's (``berrut_combine``
  launches); ``encrypt="real"`` wires every envelope out and every result
  back through ``MEAECC`` (``mask_add`` launches), the reply nonce drawn by
  the master and carried in the envelope.  Under ``FaultSpec.os_level``
  the mesh realizes the seeded plan on its live processes
  (``runtime.faults``).
* **adaptive** (``AdaptiveSpec(policy="adaptive")``): ``matmul`` brackets
  every round with ``_adaptive_retune`` (the controller may swap the
  scheme, wait policy and ``fh_degree``) and ``_adaptive_observe`` (the
  consumed arrivals fed back).  A candidate at another K runs the same
  kernels at other shapes; nothing is rebuilt.

* **serving hooks** (``worker_time``, ``serve_round_plan``,
  ``serve_wire_params``, ``serve_wire_material``, ``serve_crypto_time``):
  the continuous-batching loop (``runtime.serve_loop``) prices, plans and
  wires each decode step as one coded round through them.

Differences from the reference, by design:

* **No jit.**  PyTorch runs eagerly, so the reference's per-shape-class
  LRU of jitted rounds (``_fused_fn``, the anytime stages) and its
  ``trace_count`` are not ported; ``_scheme_token`` is kept for parity
  (the adaptive controller's active candidate).  The kernels are built
  once per process (``kernels._build``); a new straggler mask, arrival
  order, shape or retuned scheme is a kernel argument, never a new build.
* **The device** is the ``device=`` argument (``None`` = ``"cuda"``; with
  no CUDA device that raises rather than quietly running on the CPU), never
  a spec field.  The loop round's shards and results stay on it, where the
  reference pulls them to host numpy.
* **The output** stays on the device: ``matmul`` returns a tensor, where
  the reference returns a host numpy array.  The host copy is the caller's,
  so the round's timer does not include it.
* **``RoundStats.dispatches``** counts the round's launches of the port's
  own kernels (the reference counts jitted dispatches, 0 on its loop
  path).  On the card: 2 on the fused and the anytime paths, 7 on the
  fused real path and the fused real anytime path, 3 + 2·(N + responders)
  on the staged real path (the anytime one: 3 + 2·(N + stop)).  On the
  loop path, ``berrut_combine`` launches: 2 for mds and unfused spacdc
  (encode, decode), 0 for unfused conv (a reshape and a reorder), 3 for
  matdot and polynomial (two encodes, one decode); ``encrypt="real"`` adds
  two ``mask_add`` launches per shard part sent and per result returned,
  2·(N + responders) for a data-coded scheme and 2·(2N + responders) for a
  pair-coded one; on the socket mesh only the master's side is counted,
  one ``mask_add`` per shard part sealed and per result opened (N +
  responders, data-coded), the workers' launches happen in their own
  processes.  On the fault path: the encode and the decode (2 for
  spacdc), plus two ``mask_add`` launches per envelope sent and per result
  returned under ``encrypt="real"``.  0 on the CPU.
* **The virtual clock** prices a worker by timing one batched
  ``torch.matmul`` whose right factor is broadcast over the N workers; the
  reference gives every worker its own right factor, which only pair-coded
  schemes have.  Arrival order, responders and ``n_waited`` do not depend
  on it; arrival times embed measured seconds in both packages.
* **The cipher** follows the spec's ``code.use_kernel`` like the schemes do
  (the reference's ``MEAECC`` always took its own default), and the
  ``crypto_s`` probe times the wire the round runs (the reference timed
  its fast wires when ``use_kernel`` was unset).
* The timers synchronise the device before each stop, where the reference
  calls ``block_until_ready``.
* The loop round's float64 proxies, the fault round's screening scores
  and its degraded-decode error estimate are computed on the engine's
  device, where the reference's run in numpy on the host.
* ``DegradedRoundError.results`` is a tensor on the engine's device (the
  reference's is a host array).
* On the socket mesh the workers compute on the engine's device (``cuda``:
  one CUDA context per worker process), where the reference's workers run
  jax on the CPU (``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Optional

import numpy as np
import torch

from ..kernels.ops import kernel_launches
from .faults import (_BACKOFF_STREAM, DegradedRoundError,
                     FaultInjectingTransport, ResultDropped, WorkerHealth,
                     retry_round_index)
from .scheduler import (EncodePipeline, assemble_curve, plan_round,
                        retry_backoff, screen_responders, virtual_events)
from .tasks import (EnvelopeMatmulTask, MatmulTask, PairMatmulTask,
                    SealedMatmulTask)
from .transport import ThreadTransport, VirtualClockTransport, build_transport
from .wait_policy import (RoundContext, WaitPolicy, resolve_policy,
                          scheme_min_responders)

__all__ = ["RoundStats", "WorkerPool", "RoundEngine", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the card by "
            "default; pass device='cpu' to run the plain versions on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RoundStats:
    encode_s: float
    compute_wait_s: float
    decode_s: float
    crypto_s: float = 0.0
    n_waited: int = 0
    crypto_modeled_s: float = 0.0
    # --- event-driven round timeline (scheduler) -------------------------
    policy: str = "fixed_quantile"   # wait policy that picked the prefix
    arrivals: tuple = ()             # ((virtual_t_s, worker), ...) sorted
    decode_at_s: float = 0.0         # virtual time the decode fired
    pipelined_s: float = 0.0         # encode wall time hidden in the
                                     # previous round's wait window
    # launches of the port's own CUDA kernels this round (counted by the
    # wrappers; the module docstring lists them per path): 2 for a fused
    # or an anytime round on the card (coded_matmul + berrut_combine), 7
    # for an encrypted fused or fused anytime round, 3 + 2·(N + n_waited)
    # for a staged encrypted round, 0-3 berrut_combine launches for a loop
    # round by scheme, the encode and the decode (+ 2 mask_add per wire)
    # for a fault round; 0 on the CPU, where the plain versions run
    dispatches: int = 0
    # --- fault-tolerant round (runtime.faults; FaultSpec.handle) ---------
    retries: int = 0                 # re-dispatch attempts this round
    excluded: tuple = ()             # workers evicted by residual screening
    quarantined: tuple = ()          # workers quarantined at round start
    degraded: bool = False           # decoded below the policy's target
    achieved_rel_err: Optional[float] = None   # embedded-pair estimate of
                                     # a degraded decode's error (rateless)
    decode_mask: tuple = ()          # (N,) 0/1 — slots that entered decode

    @property
    def total_s(self):
        return (self.encode_s + self.compute_wait_s + self.decode_s +
                self.crypto_s - self.pipelined_s)


class WorkerPool:
    """N simulated workers behind the event-driven round API.

    A facade over the transports (``runtime.transport``): the analytic
    virtual clock, the real-thread backend with one long-lived executor,
    and the socket process mesh.  ``real_threads`` is a flippable property
    consulted per round, so callers can flip a pool between the virtual
    clock and real threads mid-life.  The mesh is built once, when first
    used (its workers start at its first round), from
    ``transport_options`` (the socket knobs and the ``device``), and is
    closed with the pool.
    """

    def __init__(self, n_workers: int, straggler, real_threads: bool = False,
                 *, backend: Optional[str] = None, transport_options=None):
        self.n = n_workers
        self.straggler = straggler
        self._backend = backend if backend is not None else \
            ("threads" if real_threads else "virtual")
        self._options = dict(transport_options or {})
        self._virtual = VirtualClockTransport(straggler)
        self._threads = ThreadTransport(n_workers, straggler)
        self._socket = None

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def real_threads(self) -> bool:
        """True when rounds run on a real (non-virtual) backend."""
        return self._backend != "virtual"

    @real_threads.setter
    def real_threads(self, value) -> None:
        # legacy flip: True selects threads, False the virtual clock
        if bool(value):
            if self._backend == "virtual":
                self._backend = "threads"
        else:
            self._backend = "virtual"

    @property
    def transport(self):
        """The backend the next round runs on."""
        if self._backend == "socket":
            if self._socket is None:
                self._socket = build_transport("socket", self.n,
                                               self.straggler,
                                               **self._options)
            return self._socket
        return self._threads if self._backend == "threads" else self._virtual

    @property
    def _executor(self):
        # the thread transport's executor, None when closed / never used
        return self._threads._executor

    def close(self):
        """Shut the real transports down (stragglers of the last round
        included, worker processes terminated, each within its bounded
        ``join_timeout_s``); surfaces any failure an unconsumed straggler
        hit after its round.  Idempotent."""
        try:
            self._threads.close()
        finally:
            if self._socket is not None:
                self._socket.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def run_round(self, shards, f, round_idx: int, wait_for: int,
                  t_compute: Optional[float] = None):
        """shards: list of per-worker inputs (or (a,b) tuples).  Returns
        (responder_indices, results_in_responder_order, wait_seconds).

        ``t_compute`` is the virtual-clock per-task compute time (the
        caller owns the latency model): ignored on real threads, required
        otherwise.  On the virtual clock only the selected responders'
        work runs: stragglers the policy never picks cost nothing.
        """
        if self.real_threads:
            events, done, elapsed = self.run_round_real(
                shards, f, round_idx, stop_after=wait_for)
            resp = np.sort(np.asarray([e.worker for e in events[:wait_for]],
                                      dtype=np.int64))
            return resp, [done[i] for i in resp], elapsed
        if t_compute is None:
            raise ValueError("virtual-clock run_round needs t_compute "
                             "(see RoundEngine._worker_compute_time)")
        handle = self._virtual.submit_round(shards, f, round_idx,
                                            t_compute=t_compute)
        events = list(itertools.islice(handle.events(), int(wait_for)))
        resp = np.sort(np.asarray([e.worker for e in events],
                                  dtype=np.int64))
        return resp, [handle.result(i) for i in resp], float(events[-1].t)

    def run_round_real(self, shards, f, round_idx: int,
                       policy: Optional[WaitPolicy] = None, scheme=None,
                       n_stragglers: int = 0,
                       stop_after: Optional[int] = None):
        """Event-driven round on a real transport (threads or the mesh).

        Drains the transport's completion stream until
        ``policy.satisfied``, or after ``stop_after`` arrivals when given.
        Returns (events_consumed, {worker: result}, elapsed_s); stragglers
        the policy never waited for keep running and are discarded.
        Policies that need per-prefix error proxies (ErrorTarget) run on
        the virtual clock: real threads exist to validate the clock.
        """
        if policy is not None and policy.needs_proxy:
            raise NotImplementedError(
                f"{policy.name}: proxy-driven policies run on the virtual "
                "clock (real-thread mode validates the clock)")
        budget = getattr(policy, "t_budget", None)
        min_ready = scheme_min_responders(scheme) if scheme is not None else 1
        # a direct caller on a virtual pool gets the thread transport
        transport = self.transport if self.real_threads else self._threads
        handle = transport.submit_round(shards, f, round_idx, budget=budget,
                                        min_ready=min_ready)
        events = []
        try:
            for ev in handle.events():
                events.append(ev)
                if stop_after is not None:
                    if len(events) >= max(int(stop_after), 1):
                        break
                    continue
                if policy is not None and len(events) >= min_ready:
                    ctx = RoundContext(scheme=scheme,
                                       n_stragglers=n_stragglers,
                                       events=events, min_ready=min_ready)
                    if policy.satisfied(ctx):
                        break
        finally:
            elapsed = handle.finish()
        done = {e.worker: handle.result(e.worker) for e in events}
        return events, done, elapsed


class RoundEngine:
    """Coded A@B rounds for one ``ClusterSpec`` on one device (see module
    docstring).  ``straggler`` / ``policy`` accept pre-built instances for
    callers holding objects the spec can't express."""

    def __init__(self, spec, *, device=None, straggler=None, policy=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.name = spec.code.scheme
        self.n = spec.code.n_workers
        self.k = spec.code.k_blocks
        self.encrypt = spec.crypto.encrypt
        self.straggler = straggler if straggler is not None else \
            spec.straggler.build(self.n, spec.seed)
        self.scheme = spec.build_scheme()
        spec.validate(scheme=self.scheme)
        self.policy = resolve_policy(policy if policy is not None
                                     else spec.wait.build())
        # the embedded-pair proxy decoder's Floater–Hormann degree
        self.fh_degree = spec.wait.fh_degree
        # the socket knobs and the device reach the mesh (the in-process
        # backends ignore them)
        self.pool = WorkerPool(
            self.n, self.straggler, backend=spec.transport.backend,
            transport_options={**spec.transport.backend_options(),
                               "device": self.device})
        # encode-of-next-round pipelining (opt-in, virtual-clock credit)
        self._pipeline = EncodePipeline() if spec.pipeline_encode else None
        supports = bool(getattr(self.scheme, "supports_fused", False))
        stable = bool(getattr(self.scheme, "fused_decode_stable", False))
        fused = spec.code.fused
        self.use_fused = (supports and stable) if fused is None else bool(fused)
        if spec.transport.backend != "virtual":
            self.use_fused = False
        # fault injection / handling (runtime.faults): the injecting
        # transport wraps whichever backend the pool selected (protocol
        # unchanged), and the round runs the slot-envelope path (screening
        # and re-dispatch act on per-worker results, which the one-launch
        # fused round does not have)
        self.fault = spec.fault
        self.health: Optional[WorkerHealth] = None
        self._fault_transport = None
        if self.fault.active:
            fseed = (self.fault.seed if self.fault.seed is not None
                     else spec.seed)
            self._fault_seed = fseed        # jittered-backoff rng root
            self._fault_transport = FaultInjectingTransport(
                self.pool.transport, self.fault, fseed)
            self.health = WorkerHealth(
                self.n, quarantine_after=self.fault.quarantine_after,
                quarantine_rounds=self.fault.quarantine_rounds)
            self.use_fused = False
        self._worker_t = {}                 # shapes -> per-worker seconds
        self._encode_t = {}                 # shapes -> encode-only seconds
        # adaptive redundancy (runtime.adaptive): the active candidate's
        # identity, kept for parity with the reference's jit cache keys
        self._scheme_token = ("base",)
        self.adaptive = None
        if spec.adaptive.enabled:
            from .adaptive import AdaptiveController
            self.adaptive = AdaptiveController(
                spec.adaptive, self.n, self.scheme,
                self._build_candidate_scheme, seed=spec.seed)
            if self.health is None:
                # the controller blends per-worker EWMA latency into its
                # fits; outside fault mode nothing else creates the tracker
                self.health = WorkerHealth(self.n)
        self._crypto = None
        self._crypto_per_elem = {}          # (dtype, mode) -> seconds/element
        mode = self.encrypt
        use_kernel = self.scheme.use_kernel
        if mode is not None:
            from ..crypto import MEAECC, generate_keypair
            # per-element rate sample for the modeled estimate (in "real"
            # mode it rides along as a cross-check)
            self._crypto = (MEAECC(mode=spec.crypto.cipher_mode,
                                   use_kernel=use_kernel, device=self.device),
                            generate_keypair())
        if mode == "real":
            from ..crypto.ecc import shared_secret
            # the transport cipher: lossless bits codec + static session
            # keys, so decrypt(encrypt(x)) is bit-identical to x and the
            # per-message EC cost is one cached shared-point lookup
            self._mea = MEAECC(mode=spec.crypto.cipher_mode, codec="bits",
                               use_kernel=use_kernel, device=self.device)
            self._master_kp = generate_keypair()
            self._worker_kps = [generate_keypair() for _ in range(self.n)]
            self._nonce = itertools.count(1)
            # ECDH is symmetric: one cached shared point per worker covers
            # both directions of the fused round's wires
            self._shared_pts = [shared_secret(self._mea.curve,
                                              self._master_kp, kp.pk)
                                for kp in self._worker_kps]
            cf = spec.crypto.fused
            self._crypto_fused = self.use_fused if cf is None else bool(cf)
            if spec.crypto.cipher_mode == "paper":
                # paper mode: one static Ψ per channel, reused every round
                self._psi_limbs = np.stack(
                    [self._mea._mask_material(pt, None, "paper")
                     for pt in self._shared_pts])
            self._fused_crypto_t = {}       # shapes -> measured wire seconds

    def close(self):
        """Release the pool's long-lived executor.  Idempotent: the
        Session calls this once on exit, a second call is safe."""
        self.pool.close()

    # ------------------------------------------------------- latency model
    def _worker_compute_time(self, lhs_shape, rhs_shape) -> float:
        """Virtual-clock per-worker latency: time ONE batched matmul of the
        per-worker operand shapes on the engine's device (once per shape,
        cached) and divide by N — the N workers run concurrently.  A timing
        probe, so it may use ``torch.matmul``.  The right factor is
        broadcast over the N workers, not copied N times (the reference
        gives each worker its own, which matters for pair-coded schemes
        only; the loop round passes its per-worker shapes here)."""
        key = (tuple(lhs_shape), tuple(rhs_shape))
        if key not in self._worker_t:
            lhs = torch.zeros((self.n,) + tuple(lhs_shape), device=self.device)
            rhs = torch.zeros(tuple(rhs_shape), device=self.device)
            torch.matmul(lhs, rhs)                       # warm-up
            _sync(self.device)
            t0 = time.perf_counter()
            torch.matmul(lhs, rhs)
            _sync(self.device)
            self._worker_t[key] = (time.perf_counter() - t0) / self.n
        return self._worker_t[key]

    def _round_compute_time(self, a_shape, b_shape):
        """(block rows, per-worker virtual compute seconds) for this job."""
        split = getattr(self.scheme, "k_blocks", self.n)
        blk = -(-a_shape[0] // split)
        return blk, self._worker_compute_time((blk, a_shape[1]),
                                              (a_shape[1], b_shape[-1]))

    def _virtual_round_plan(self, a_shape, b_shape, round_idx: int):
        """Virtual clock: the round's arrival timeline and the prefix the
        wait policy consumes."""
        blk, t_comp = self._round_compute_time(a_shape, b_shape)
        plan = plan_round(self.scheme, self.policy,
                          self.straggler.delays(round_idx), t_comp,
                          self.straggler.n_stragglers)
        return blk, plan

    def _encode_only_time(self, a_shape) -> float:
        """Measured wall seconds of ONE encode at this shape (cached):
        caps the pipelining credit, since only the encode can overlap the
        previous round's wait window."""
        key = tuple(a_shape)
        if key not in self._encode_t:
            z = torch.zeros(tuple(a_shape), device=self.device)
            self.scheme.encode(z)                        # warm-up
            _sync(self.device)
            t0 = time.perf_counter()
            self.scheme.encode(z)
            _sync(self.device)
            self._encode_t[key] = time.perf_counter() - t0
        return self._encode_t[key]

    def _account_encode(self, encode_s: float, wait_s: float) -> float:
        """Encode-pipelining credit: how much of this round's encode hid
        in the previous round's wait window (and bank this round's)."""
        if self._pipeline is None:
            return 0.0
        _, hidden = self._pipeline.charge(encode_s)
        self._pipeline.credit(wait_s)
        return hidden

    def _stats(self, events, decode_at_s: float, **kw) -> RoundStats:
        kw.setdefault("policy", self.policy.name)
        kw.setdefault("arrivals", tuple((e.t, e.worker) for e in events))
        kw.setdefault("decode_at_s", decode_at_s)
        return RoundStats(**kw)

    # ------------------------------------------------------------- crypto
    def _crypto_cost_per_elem(self, dtype) -> float:
        """MEA-ECC seconds per matrix element, measured once per (dtype,
        mode) on a 64×64 sample on the engine's device and cached.  A
        warm-up round trip runs first so one-time costs (the EC tables, the
        kernel build) never leak into the extrapolated rate."""
        mea, kp = self._crypto
        key = (str(dtype), mea.mode)
        if key not in self._crypto_per_elem:
            m = torch.zeros((64, 64), dtype=dtype, device=self.device)
            mea.decrypt(mea.encrypt(m, kp.pk), kp)      # warm
            _sync(self.device)
            t0 = time.perf_counter()
            mea.decrypt(mea.encrypt(m, kp.pk), kp)
            _sync(self.device)
            self._crypto_per_elem[key] = (time.perf_counter() - t0) / m.numel()
        return self._crypto_per_elem[key]

    def _crypto_overhead_elems(self, total_elems: int, dtype) -> float:
        """Modeled MEA-ECC cost: master encrypt + worker decrypt + result
        encrypt (3 passes) over ``total_elems`` shard elements."""
        if not self._crypto:
            return 0.0
        return self._crypto_cost_per_elem(dtype) * total_elems * 3

    def _wire(self, arr: torch.Tensor, sender_kp, recipient_kp) -> torch.Tensor:
        """One real master↔worker transfer: MEA-ECC encrypt to the
        recipient's public key, decrypt with its private key at the other
        end (two ``mask_add`` launches on the card).  The bits codec makes
        the round trip bit-identical."""
        ct = self._mea.encrypt(arr, recipient_kp.pk, sender=sender_kp,
                               nonce=next(self._nonce))
        return self._mea.decrypt(ct, recipient_kp)

    def _mask_material_host(self):
        """(material_out, material_back) as host numpy: each (N, 8) PRF
        seed words (stream — a fresh nonce per channel per direction, from
        the same nonce stream the staged ``_wire`` draws from) or the
        static (N, L) Ψ limb stack (paper)."""
        from ..crypto.field import seed_words
        if self._mea.mode == "paper":
            return self._psi_limbs, self._psi_limbs
        out = np.stack([seed_words(pt.x, pt.y, next(self._nonce))
                        for pt in self._shared_pts])
        back = np.stack([seed_words(pt.x, pt.y, next(self._nonce))
                         for pt in self._shared_pts])
        return out, back

    def _fused_mask_material(self):
        """Per-round mask material for the fused encrypted round
        (:meth:`_mask_material_host`) as ``torch.uint32`` on the engine's
        device."""
        from ..crypto.field import as_u32_tensor
        out, back = self._mask_material_host()
        return (as_u32_tensor(out, self.device),
                as_u32_tensor(back, self.device))

    def _fused_crypto_time(self, blk: int, d: int, n_out: int) -> float:
        """Measured wall seconds of the round's wire work alone: the two
        cipher applications (shards out, results back) at this round's
        payload shapes, through the wire the round runs (the ``mask_add``
        kernel on the card), timed once per shape class and cached.  The
        fused round's ``crypto_s``: its wires have no timer of their own,
        so the cost is measured where it can be isolated.  The round that
        calls this has just run the same shapes, so nothing is left to
        warm up."""
        key = (blk, d, n_out)
        if key not in self._fused_crypto_t:
            from ..kernels.encrypted_round import wire_roundtrip
            from ..kernels.ops import _use_kernel
            mode = self._mea.mode
            q = self._mea.curve.q
            mat_out, mat_back = self._fused_mask_material()
            x_out = torch.zeros((self.n, blk, d), device=self.device)
            x_back = torch.zeros((self.n, blk, n_out), device=self.device)
            kern = _use_kernel(x_out, self.scheme.use_kernel)
            _sync(self.device)
            t0 = time.perf_counter()
            wire_roundtrip(x_out, mat_out, q=q, mode=mode, use_kernel=kern)
            wire_roundtrip(x_back, mat_back, q=q, mode=mode, use_kernel=kern)
            _sync(self.device)
            self._fused_crypto_t[key] = time.perf_counter() - t0
        return self._fused_crypto_t[key]

    # ------------------------------------------------------------- serving
    # Minimal public hooks the continuous-batching serve loop
    # (``runtime.serve_loop``) builds on.  The loop owns its step (a whole
    # decode step, every coded site, is one coded round), but prices
    # workers, plans rounds, draws wire material and attributes crypto
    # time through the same machinery as every other round, so serve
    # RoundStats stay comparable with matmul rounds.

    def worker_time(self, lhs_shape, rhs_shape) -> float:
        """Per-worker virtual seconds for one coded site's matmul."""
        return self._worker_compute_time(lhs_shape, rhs_shape)

    def serve_round_plan(self, round_idx: int, t_comp: float):
        """Straggler plan for one serve step treated as ONE coded round.
        ``t_comp`` is the per-worker compute of every coded site in the
        step, summed — each worker runs all of its site shards
        back-to-back before replying."""
        return plan_round(self.scheme, self.policy,
                          self.straggler.delays(round_idx), t_comp,
                          self.straggler.n_stragglers)

    def serve_wire_params(self):
        """(q, cipher_mode) for in-step ``wire_roundtrip`` calls, or None
        when this spec doesn't run real encryption."""
        if getattr(self, "_mea", None) is None:
            return None
        return self._mea.curve.q, self._mea.mode

    def serve_wire_material(self, count: int):
        """``count`` fresh (out, back) wire-material pairs — one pair per
        coded site instance in a serve step (stream mode draws fresh
        nonces per site per step from the same nonce stream as the staged
        wire; paper mode returns the static Ψ stack).  Each side is
        (count, N, W) ``torch.uint32`` on the engine's device."""
        from ..crypto.field import as_u32_tensor
        outs, backs = zip(*(self._mask_material_host()
                            for _ in range(count)))
        return (as_u32_tensor(np.stack(outs), self.device),
                as_u32_tensor(np.stack(backs), self.device))

    def serve_crypto_time(self, elems_out: int, elems_back: int) -> float:
        """Measured wall seconds of ONE serve step's wire work alone: the
        per-channel payloads of every coded site, flattened to (N, elems),
        through the wire the step runs (two ``mask_add`` launches per
        round trip on the card), once to warm up and once timed between
        two ``torch.cuda.synchronize()`` calls, cached per element-count
        class (the serve analogue of :meth:`_fused_crypto_time` — the
        in-step wire has no boundary to put a timer on)."""
        key = ("serve", elems_out, elems_back)
        if key not in self._fused_crypto_t:
            from ..kernels.encrypted_round import wire_roundtrip
            from ..kernels.ops import _use_kernel
            mode = self._mea.mode
            q = self._mea.curve.q
            mat_out, mat_back = self._fused_mask_material()
            x_out = torch.zeros((self.n, max(elems_out, 1)),
                                device=self.device)
            x_back = torch.zeros((self.n, max(elems_back, 1)),
                                 device=self.device)
            kern = _use_kernel(x_out, self.scheme.use_kernel)

            def wires():
                wire_roundtrip(x_out, mat_out, q=q, mode=mode,
                               use_kernel=kern)
                wire_roundtrip(x_back, mat_back, q=q, mode=mode,
                               use_kernel=kern)
            wires()                                      # warm-up
            _sync(self.device)
            t0 = time.perf_counter()
            wires()
            _sync(self.device)
            self._fused_crypto_t[key] = time.perf_counter() - t0
        return self._fused_crypto_t[key]

    # --------------------------------------------------------------- rounds
    def _matmul_fused(self, a: torch.Tensor, b: torch.Tensor, round_idx: int,
                      noise=None):
        blk, plan = self._virtual_round_plan(a.shape, b.shape, round_idx)
        mask = torch.from_numpy(plan.mask)
        launches0 = kernel_launches()
        # master math (encode + worker products + decode + reassembly)
        _sync(self.device)
        t0 = time.perf_counter()
        decoded = self.scheme.fused_round(a, b, mask, noise=noise)
        out = self.scheme.reconstruct_matmul(decoded, a.shape[0], b.shape[-1])
        _sync(self.device)
        t_master = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        crypto_s = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                               torch.float32)
        hideable = (0.0 if self._pipeline is None else
                    min(t_master, self._encode_only_time(a.shape)))
        stats = self._stats(plan.events, plan.wait_s, encode_s=t_master,
                            compute_wait_s=plan.wait_s, decode_s=0.0,
                            crypto_s=crypto_s, n_waited=len(plan.responders),
                            dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             plan.wait_s))
        return out, stats

    def _matmul_real_fused(self, a: torch.Tensor, b: torch.Tensor,
                           round_idx: int, noise=None):
        """The encrypted round with the wire inside the fused round: encode
        → wire-out → worker products → wire-back → masked decode
        (``kernels.ops.encrypted_coded_matmul`` + the scheme's masked
        decode).  The bits-codec wire is lossless, so the output equals the
        plain fused round's.  ``crypto_s`` is the wire work timed alone
        (:meth:`_fused_crypto_time`) and taken out of the master's time;
        the modeled estimate rides along in ``crypto_modeled_s``."""
        from ..kernels.ops import encrypted_coded_matmul
        scheme = self.scheme
        blk, plan = self._virtual_round_plan(a.shape, b.shape, round_idx)
        mat_out, mat_back = self._fused_mask_material()
        mask = torch.from_numpy(plan.mask)
        launches0 = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        dec = scheme.decode_matrix_masked(mask).to(a.device)
        results = encrypted_coded_matmul(
            scheme.fused_encoder_matrix(), scheme.fused_blocks(a, noise), b,
            mat_out, mat_back, q=self._mea.curve.q, mode=self._mea.mode,
            force_kernel=scheme.use_kernel)
        decoded = scheme._combine(dec, results)
        del results
        out = scheme.reconstruct_matmul(decoded, a.shape[0], b.shape[-1])
        _sync(self.device)
        t_master = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        crypto_s = min(self._fused_crypto_time(blk, a.shape[1], b.shape[-1]),
                       t_master)
        modeled = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                              torch.float32)
        encode_s = t_master - crypto_s
        hideable = (0.0 if self._pipeline is None else
                    min(encode_s, self._encode_only_time(a.shape)))
        stats = self._stats(plan.events, plan.wait_s, encode_s=encode_s,
                            compute_wait_s=plan.wait_s, decode_s=0.0,
                            crypto_s=crypto_s, n_waited=len(plan.responders),
                            crypto_modeled_s=modeled, dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             plan.wait_s))
        return out, stats

    def _staged_stage1(self, a, b, noise=None):
        """Encode, wire every coded shard to its worker (MEA-ECC), run the
        worker products on the decrypted (bit-identical) shards through
        ``coded_matmul`` with identity weights.  Returns (results,
        master_compute_s, crypto_out_s); responder slots of ``results`` are
        overwritten in place with their wired-back values."""
        from ..kernels.ops import coded_matmul
        _sync(self.device)
        t0 = time.perf_counter()
        enc = self.scheme.encode(a, noise)               # (N, blk, d)
        _sync(self.device)
        t_enc = time.perf_counter() - t0
        # wire out: each worker receives (and decrypts) its coded shard
        t0 = time.perf_counter()
        shards = torch.stack([self._wire(enc[i], self._master_kp,
                                         self._worker_kps[i])
                              for i in range(self.n)])
        _sync(self.device)
        crypto_out = time.perf_counter() - t0
        del enc
        t0 = time.perf_counter()
        eye = torch.eye(self.n, dtype=torch.float32, device=self.device)
        results = coded_matmul(eye, shards, b,
                               force_kernel=self.scheme.use_kernel)
        _sync(self.device)
        t_enc += time.perf_counter() - t0
        return results, t_enc, crypto_out

    def _matmul_real(self, a: torch.Tensor, b: torch.Tensor, round_idx: int,
                     noise=None):
        """The staged encrypted round: every shard is MEA-ECC-encrypted to
        its worker and decrypted there, every responder's product is
        encrypted back to the master — ``crypto_s`` is the measured wall
        time of those transfers (the modeled estimate rides along in
        ``crypto_modeled_s``).  The output equals the plain fused round's.
        """
        blk, plan = self._virtual_round_plan(a.shape, b.shape, round_idx)
        resp, wait_s = plan.responders, plan.wait_s
        launches0 = kernel_launches()
        results, t_enc, crypto_s = self._staged_stage1(a, b, noise)
        # wire back: the responders' products return encrypted (stragglers
        # never answer; their slots carry weight 0 in the masked decode)
        t0 = time.perf_counter()
        for i in resp:
            results[i] = self._wire(results[i], self._worker_kps[i],
                                    self._master_kp)
        _sync(self.device)
        crypto_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = self.scheme.decode_matrix_masked(
            torch.from_numpy(plan.mask)).to(a.device)
        out = self.scheme.reconstruct_matmul(
            self.scheme._combine(dec, results), a.shape[0], b.shape[-1])
        _sync(self.device)
        t_dec = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        modeled = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                              torch.float32)
        hideable = (0.0 if self._pipeline is None else
                    min(t_enc, self._encode_only_time(a.shape)))
        stats = self._stats(plan.events, wait_s, encode_s=t_enc,
                            compute_wait_s=wait_s, decode_s=t_dec,
                            crypto_s=crypto_s, n_waited=len(resp),
                            crypto_modeled_s=modeled, dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             wait_s))
        return out, stats

    def _loop_round(self, shards, f, round_idx: int, t_comp: float):
        """The unfused round's worker phase under the wait policy.

        Returns (responders, results_in_responder_order, wait_s, events).
        Virtual clock: the policy picks the prefix off the analytic
        timeline and ONLY the selected responders' work runs, except under
        a proxy-driven policy, whose error proxy needs every worker's
        result.  Real threads: the event loop in
        ``WorkerPool.run_round_real`` consumes completions until the
        policy is satisfied.
        """
        pool, policy, scheme = self.pool, self.policy, self.scheme
        if pool.real_threads:
            events, done, _ = pool.run_round_real(
                shards, f, round_idx, policy=policy, scheme=scheme,
                n_stragglers=self.straggler.n_stragglers)
            ctx = RoundContext(scheme=scheme,
                               n_stragglers=self.straggler.n_stragglers,
                               events=events,
                               min_ready=scheme_min_responders(scheme))
            stop = int(policy.stop_index(ctx))
            resp = np.sort(np.asarray([e.worker for e in events[:stop]],
                                      dtype=np.int64))
            return resp, [done[i] for i in resp], \
                float(events[stop - 1].t), events
        proxy_fn = None
        results_all = None
        if policy.needs_proxy:
            # the proxy needs every worker's output: run them all (the
            # anytime pipeline of the fused round is the fast path)
            results_all = [f(s) for s in shards]
            stack = torch.stack(results_all).reshape(
                len(results_all), -1).double()
            fh_degree = self.fh_degree

            def proxy_fn(events):
                order = [e.worker for e in events]
                w_lo, ready = scheme.prefix_decode_weights(order)
                pw = scheme.anytime_proxy_weights(order, fh_degree=fh_degree)
                if pw is None:
                    return np.where(ready, 0.0, np.inf)
                w_hi, valid = pw
                lo = torch.einsum("ekn,nf->ekf",
                                  torch.from_numpy(w_lo).to(stack), stack)
                hi = torch.einsum("ekn,nf->ekf",
                                  torch.from_numpy(w_hi).to(stack), stack)
                num = torch.linalg.vector_norm(lo - hi, dim=(1, 2))
                den = torch.linalg.vector_norm(hi, dim=(1, 2))
                prox = (num / torch.clamp(den, min=1e-12)).cpu().numpy()
                return np.where(ready & valid, prox, np.inf)

        plan = plan_round(scheme, policy, self.straggler.delays(round_idx),
                          t_comp, self.straggler.n_stragglers,
                          proxy_fn=proxy_fn)
        resp = plan.responders
        if results_all is not None:
            results = [results_all[i] for i in resp]
        else:
            results = [f(shards[i]) for i in resp]
        return resp, results, plan.wait_s, plan.events

    def _matmul_loop(self, a: torch.Tensor, b: torch.Tensor, round_idx: int,
                     noise=None):
        """The loop round: encode (pair-coded: both factors), the wire out
        (``encrypt="real"``; sealed on the socket mesh), one product per
        responder, the wire back, the scheme's exact decode and reassembly.
        The bits-codec wire is lossless, so the encrypted round's output
        equals the plain one's."""
        scheme = self.scheme
        real = self.encrypt == "real"
        launches0 = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        if scheme.pair_coded:
            ea, eb = scheme.encode_pair(a, b)
            shards = [(ea[i], eb[i]) for i in range(self.n)]
            f = PairMatmulTask()
            lhs_shape, rhs_shape = ea.shape[1:], eb.shape[1:]
        else:
            enc = scheme.encode(a, noise)
            shards = [enc[i] for i in range(self.n)]
            f = MatmulTask(b)
            lhs_shape, rhs_shape = enc.shape[1:], b.shape
        _sync(self.device)
        t_enc = time.perf_counter() - t0

        crypto_s = 0.0
        sealed = real and self.pool.backend == "socket"
        if real and not sealed:
            # in-process wire: every worker decrypts bit-identical shard
            # bytes, round-tripped master-side
            t0 = time.perf_counter()
            shards = [
                tuple(self._wire(part, self._master_kp, self._worker_kps[i])
                      for part in s) if isinstance(s, tuple)
                else self._wire(s, self._master_kp, self._worker_kps[i])
                for i, s in enumerate(shards)]
            _sync(self.device)
            crypto_s += time.perf_counter() - t0
        elif sealed:
            # the mesh's wire: shards leave the master SEALED (genuine
            # ciphertext limbs cross the socket), the worker process
            # decrypts, multiplies and encrypts its product back under the
            # reply nonce drawn here
            t0 = time.perf_counter()
            f = SealedMatmulTask(self._mea, self._worker_kps,
                                 self._master_kp.pk,
                                 b=None if scheme.pair_coded else b)
            shards = [
                (i,
                 tuple(self._mea.encrypt(part, self._worker_kps[i].pk,
                                         sender=self._master_kp,
                                         nonce=next(self._nonce))
                       for part in (s if isinstance(s, tuple) else (s,))),
                 next(self._nonce))          # the worker's reply nonce
                for i, s in enumerate(shards)]
            _sync(self.device)
            crypto_s += time.perf_counter() - t0

        t_comp = self._worker_compute_time(lhs_shape, rhs_shape)
        resp, results, wait_s, events = self._loop_round(shards, f,
                                                         round_idx, t_comp)
        _sync(self.device)              # the responders' products
        if sealed:
            # the responders' products arrive sealed to the master's key
            t0 = time.perf_counter()
            results = [self._mea.decrypt(ct, self._master_kp)
                       for ct in results]
            _sync(self.device)
            crypto_s += time.perf_counter() - t0
        elif real:
            # wire back: responders encrypt their products to the master
            t0 = time.perf_counter()
            results = [self._wire(r, self._worker_kps[i], self._master_kp)
                       for i, r in zip(resp, results)]
            _sync(self.device)
            crypto_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = scheme.decode(torch.stack(results), list(resp))
        out = scheme.reconstruct_matmul(dec, a.shape[0], b.shape[-1])
        _sync(self.device)
        t_dec = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        # the reference's modeled estimate counts each shard's first part
        modeled = self._crypto_overhead_elems(self.n * math.prod(lhs_shape),
                                              torch.float32)
        stats = self._stats(events, wait_s, encode_s=t_enc,
                            compute_wait_s=wait_s, decode_s=t_dec,
                            crypto_s=crypto_s if real else modeled,
                            n_waited=len(resp),
                            crypto_modeled_s=modeled if real else 0.0,
                            dispatches=launches,
                            pipelined_s=self._account_encode(t_enc, wait_s))
        return out, stats

    # ------------------------------------------------- fault-tolerant path
    def _fault_policy_target(self) -> int:
        """Clean-responder count the defended round drives toward (the
        count-based policies' target; Deadline rounds are budget-bounded
        instead and only need the scheme's minimum decodable prefix)."""
        min_ready = scheme_min_responders(self.scheme)
        ctx = RoundContext(scheme=self.scheme,
                           n_stragglers=self.straggler.n_stragglers,
                           events=[], min_ready=min_ready)
        try:
            tgt = int(self.policy.target(ctx))
        except NotImplementedError:
            tgt = min_ready
        return max(min(tgt, self.n), min_ready)

    def _degraded_rel_err(self, slots, stack) -> Optional[float]:
        """Embedded-pair estimate of a degraded decode's error: the
        disagreement between the scheme's decode and its higher-order
        proxy decode over the surviving slots, in float64 on the stack's
        device (rateless schemes; None when the pair is unavailable at
        this prefix)."""
        order = list(slots)
        hi = self.scheme.anytime_proxy_weights(order,
                                               fh_degree=self.fh_degree)
        if hi is None:
            return None
        w_lo, ready = self.scheme.prefix_decode_weights(order)
        if not bool(np.asarray(hi[1])[-1]) or not bool(np.asarray(ready)[-1]):
            return None
        flat = stack.reshape(len(order), -1).double()

        def last(w):       # the whole prefix's (K, |slots|) weights
            return torch.from_numpy(np.asarray(w[-1], np.float64)[:, order]
                                    ).to(flat.device)
        lo_d = last(w_lo) @ flat
        hi_d = last(hi[0]) @ flat
        den = max(float(torch.linalg.vector_norm(hi_d)), 1e-12)
        return float(torch.linalg.vector_norm(lo_d - hi_d)) / den

    def _matmul_faulted(self, a: torch.Tensor, b: torch.Tensor,
                        round_idx: int, noise=None):
        """The fault round: injected faults (via the wrapping transport)
        and/or engine-side defenses (``FaultSpec.handle``).

        Work travels in ``(worker, slot, payload)`` envelopes: slot s is
        encoder row s, so a re-dispatch hands the SAME coded shard to a
        different worker and the decode stays slot-indexed.  Defended
        rounds drain arrivals, screen the accumulated clean set with
        leave-one-out residuals (corrupted responders' mask bits are
        cleared, their producers recorded in ``WorkerHealth``), and
        re-dispatch missing slots to the healthiest workers with capped,
        jittered exponential backoff until the policy's target is met, the
        retry budget runs out, or no healthy workers remain.  Exhausted
        rateless rounds decode the surviving prefix (``degraded=True`` with
        the embedded-pair ``achieved_rel_err``); exhausted threshold rounds
        raise :class:`~repro_torch.runtime.faults.DegradedRoundError`
        carrying the partial state (its ``results`` on the device).
        Undefended rounds (injection only) dispatch once and decode
        whatever arrives, corrupt results included.
        """
        scheme, fault = self.scheme, self.fault
        real = self.encrypt == "real"
        handle_faults = fault.handle
        min_ready = scheme_min_responders(scheme)
        budget = getattr(self.policy, "t_budget", None)
        needed = min_ready if budget is not None else \
            self._fault_policy_target()
        launches0 = kernel_launches()

        _sync(self.device)
        t0 = time.perf_counter()
        enc = scheme.encode(a, noise)                   # (N, blk, d)
        _sync(self.device)
        t_enc = time.perf_counter() - t0
        blk, t_comp = self._round_compute_time(a.shape, b.shape)
        n_out = int(b.shape[-1])
        crypto_s = 0.0
        transport, health = self._fault_transport, self.health
        worker_fn = EnvelopeMatmulTask(
            b, mea=self._mea if real else None,
            worker_kps=self._worker_kps if real else None,
            master_pk=self._master_kp.pk if real else None)

        def dispatch(assign: dict, attempt: int):
            nonlocal crypto_s
            envs = [None] * self.n
            if real:
                tw = time.perf_counter()
                for w, slot in assign.items():
                    envs[w] = (w, slot, self._mea.encrypt(
                        enc[slot], self._worker_kps[w].pk,
                        sender=self._master_kp, nonce=next(self._nonce)),
                        next(self._nonce))
                _sync(self.device)
                crypto_s += time.perf_counter() - tw
            else:
                for w, slot in assign.items():
                    envs[w] = (w, slot, enc[slot])
            rid = retry_round_index(round_idx, attempt)
            return transport.submit_round(envs, worker_fn, rid,
                                          t_compute=t_comp, budget=budget,
                                          min_ready=min_ready)

        clean: dict = {}                   # slot -> (worker, result tensor)
        arrivals: list = []                # (cumulative t, worker)
        excluded_workers: list = []
        offenders: set = set()
        quarantined0 = tuple(health.quarantined(round_idx)) \
            if (handle_faults and health is not None) else ()
        wait_total, retries, attempt = 0.0, 0, 0
        # full-jitter backoff, seeded off the round's fault SeedSequence
        backoff_rng = np.random.default_rng(np.random.SeedSequence(
            [int(self._fault_seed), int(round_idx), _BACKOFF_STREAM]))
        if handle_faults and health is not None:
            avail = [w for w in range(self.n)
                     if not health.is_quarantined(w, round_idx)]
        else:
            avail = list(range(self.n))
        assign = {w: w for w in avail}

        def garbage():
            return torch.full((blk, n_out), float("nan"), device=self.device)

        while True:
            handle = dispatch(assign, attempt)
            targets = set(assign)
            seen: set = set()
            observed_t = 0.0
            try:
                for ev in handle.events():
                    if ev.worker not in targets:
                        continue           # stray slot from an earlier plan
                    seen.add(ev.worker)
                    observed_t = max(observed_t, float(ev.t))
                    try:
                        slot, payload = handle.result(ev.worker)
                    except ResultDropped:
                        offenders.add(ev.worker)
                        if handle_faults and health is not None:
                            health.record_drop(ev.worker, round_idx)
                        continue
                    if real:
                        tw = time.perf_counter()
                        try:
                            arr = self._mea.decrypt(
                                payload, self._master_kp).to(torch.float32)
                        except Exception:
                            # a tampered ciphertext that fails to decode at
                            # all is still a response: screening evicts the
                            # non-finite row before scoring
                            arr = garbage()
                        _sync(self.device)
                        crypto_s += time.perf_counter() - tw
                    else:
                        arr = payload
                    if tuple(arr.shape) != (blk, n_out):
                        arr = garbage()
                    clean[int(slot)] = (int(ev.worker), arr)
                    arrivals.append((wait_total + float(ev.t),
                                     int(ev.worker)))
                    if handle_faults and health is not None:
                        health.record_ok(ev.worker, float(ev.t))
                    if budget is None and len(clean) >= needed:
                        break
            finally:
                handle.finish()
            if handle_faults and fault.screen and clean:
                slots = sorted(clean)
                results = torch.zeros((self.n, blk, n_out),
                                      device=self.device)
                mask = np.zeros(self.n, np.float32)
                for sl in slots:
                    results[sl] = clean[sl][1]
                    mask[sl] = 1.0
                _, evicted, _ = screen_responders(
                    scheme, results, mask,
                    threshold=fault.residual_threshold,
                    factor=fault.residual_factor,
                    norm_factor=fault.norm_factor,
                    max_exclude=max(0, len(slots) - min_ready))
                del results
                for sl in evicted:
                    w = clean[sl][0]
                    excluded_workers.append(w)
                    offenders.add(w)
                    if health is not None:
                        health.record_corrupt(w, round_idx)
                    del clean[sl]
            if len(clean) >= needed:
                wait_total += observed_t
                break
            # target missed: charge what the master actually waited: the
            # deadline budget, or the per-worker timeout on the crashed
            # assignments (the stream exhausted without them)
            if budget is not None:
                wait_total += float(budget)
            else:
                timeout = (fault.worker_timeout_s
                           if fault.worker_timeout_s is not None
                           else fault.timeout_factor * max(observed_t,
                                                           t_comp))
                wait_total += max(observed_t, timeout)
                if handle_faults and health is not None:
                    for w in sorted(targets - seen):
                        offenders.add(w)
                        health.record_crash(w, round_idx)
            attempt += 1
            if not handle_faults or attempt > fault.max_retries:
                break
            missing = [sl for sl in range(self.n) if sl not in clean]
            cands = (health.ranked(round_idx, exclude=offenders)
                     if health is not None else
                     [w for w in range(self.n) if w not in offenders])
            if not cands:
                break
            wait_total += retry_backoff(attempt, fault.backoff_s,
                                        fault.backoff_cap_s,
                                        rng=backoff_rng)
            retries += 1
            assign = dict(zip(cands, missing))

        slots = sorted(clean)
        degraded = len(clean) < needed
        achieved = None
        if degraded:
            stack = (torch.stack([clean[sl][1] for sl in slots])
                     if slots else None)
            if not slots or len(slots) < min_ready:
                raise DegradedRoundError(
                    f"round {round_idx}: {len(slots)} clean result(s) "
                    f"after {retries} re-dispatch(es), scheme needs "
                    f"{min_ready} (policy target {needed})",
                    clean_slots=slots, results=stack,
                    excluded=excluded_workers, retries=retries,
                    needed=needed)
            achieved = self._degraded_rel_err(slots, stack)
        _sync(self.device)
        t0 = time.perf_counter()
        stack = torch.stack([clean[sl][1] for sl in slots])
        dec = scheme.decode(stack, list(slots))
        out = scheme.reconstruct_matmul(dec, a.shape[0], b.shape[-1])
        _sync(self.device)
        t_dec = time.perf_counter() - t0
        modeled = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                              torch.float32)
        stats = RoundStats(
            encode_s=t_enc, compute_wait_s=wait_total, decode_s=t_dec,
            crypto_s=crypto_s if real else modeled, n_waited=len(slots),
            crypto_modeled_s=modeled if real else 0.0,
            policy=self.policy.name, arrivals=tuple(arrivals),
            decode_at_s=wait_total,
            pipelined_s=self._account_encode(t_enc, wait_total),
            dispatches=kernel_launches() - launches0,
            retries=retries, excluded=tuple(excluded_workers),
            quarantined=quarantined0, degraded=degraded,
            achieved_rel_err=achieved,
            decode_mask=tuple(1 if sl in clean else 0
                              for sl in range(self.n)))
        return out, stats

    # ---------------------------------------------------- anytime pipeline
    def _proxy_stop(self, events, prox) -> int:
        """The proxy-driven policy's stop prefix for one round timeline."""
        ctx = RoundContext(scheme=self.scheme,
                           n_stragglers=self.straggler.n_stragglers,
                           events=events,
                           min_ready=scheme_min_responders(self.scheme),
                           proxies=prox)
        return int(self.policy.stop_index(ctx))

    def _anytime_results(self, a, b, noise=None):
        """Stage 1 of the anytime round: encode + ALL N worker products in
        one ``coded_matmul`` (no decode: the stop prefix is not known
        yet)."""
        from ..kernels.ops import coded_matmul
        scheme = self.scheme
        return coded_matmul(scheme.fused_encoder_matrix(),
                            scheme.fused_blocks(a, noise), b,
                            force_kernel=scheme.use_kernel)

    def _anytime_results_real(self, a, b, noise=None):
        """Stage 1 of the fused encrypted anytime round: encode, wire out,
        all N worker products and wire back (``encrypted_coded_matmul``).
        Every worker's product crosses the wire, where the staged round
        wires back only what the policy consumed."""
        from ..kernels.ops import encrypted_coded_matmul
        scheme = self.scheme
        mat_out, mat_back = self._fused_mask_material()
        return encrypted_coded_matmul(
            scheme.fused_encoder_matrix(), scheme.fused_blocks(a, noise), b,
            mat_out, mat_back, q=self._mea.curve.q, mode=self._mea.mode,
            force_kernel=scheme.use_kernel)

    def _anytime_curve(self, results, w_lo, w_hi, valid, a, b,
                       with_ref: bool):
        """Stage 2: EVERY responder prefix decoded, Berrut and its
        embedded pair, in one ``kernels.ops.prefix_decode`` (one
        ``berrut_combine`` over 2·E·K weight rows), every prefix
        reassembled, the embedded-pair error proxies and, for a curve, the
        true relative errors against ``torch.matmul(a, b)`` (IEEE float32:
        the package never turns TF32 on).  Returns (products (E, m, n)
        viewing the decode, proxies (E,), rel_errs (E,) or None), on the
        device."""
        from ..kernels.ops import prefix_decode
        scheme = self.scheme
        m, n_out = a.shape[0], b.shape[-1]
        e = w_lo.shape[0]
        dec = prefix_decode(torch.cat([w_lo, w_hi]), results,
                            force_kernel=scheme.use_kernel)
        recon = torch.func.vmap(
            lambda d: scheme.reconstruct_matmul(d, m, n_out))(dec)
        prod, prod_hi = recon[:e], recon[e:]
        diff = torch.linalg.vector_norm(prod - prod_hi, dim=(1, 2))
        den = torch.linalg.vector_norm(prod_hi, dim=(1, 2))
        prox = torch.where(valid > 0, diff / torch.clamp(den, min=1e-12),
                           torch.full_like(diff, float("inf")))
        if not with_ref:
            return prod, prox, None
        ref = torch.matmul(a, b)
        rel = (torch.linalg.vector_norm(prod - ref[None], dim=(1, 2)) /
               torch.clamp(torch.linalg.vector_norm(ref), min=1e-12))
        return prod, prox, rel

    def _prefix_weight_stacks(self, events):
        """Host-side per-prefix decode weights for one round's arrival
        order, moved to the engine's device: (w_lo, ready, w_hi, valid).
        Rateless schemes supply a genuine embedded pair (Berrut +
        Floater–Hormann at the WaitSpec's ``fh_degree``); threshold
        schemes have no second decoder, so w_hi repeats w_lo with
        ``valid`` 0 and the proxy reports inf.  ``ready`` stays numpy."""
        order = [e.worker for e in events]
        w_lo, ready = self.scheme.prefix_decode_weights(order)
        pw = self.scheme.anytime_proxy_weights(order,
                                               fh_degree=self.fh_degree)
        if pw is None:
            w_hi, valid = w_lo, np.zeros(len(order), np.float32)
        else:
            w_hi, valid = pw[0], np.asarray(pw[1], np.float32)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return dev(w_lo), np.asarray(ready, bool), dev(w_hi), dev(valid)

    def _prefix_postprocess(self, ready, prox, valid):
        """Shared proxy cleanup, on the host: not-ready prefixes are inf;
        threshold schemes (no embedded pair anywhere) are exact once
        decodable."""
        prox = np.where(ready, prox.cpu().numpy().astype(np.float64), np.inf)
        if not bool((valid > 0).any()):
            prox = np.where(ready, 0.0, np.inf)
        return prox

    def _anytime_prefix_eval(self, a, b, round_idx: int, with_ref: bool,
                             noise=None):
        """The shared prefix pipeline behind ErrorTarget rounds and
        ``anytime_curve``: stage 1 (encode + all worker products), stage 2
        (every prefix decoded + embedded-pair proxies, optionally the true
        errors).  Returns (events, ready, proxies, products,
        rel_errs-or-None)."""
        _, t_comp = self._round_compute_time(a.shape, b.shape)
        events = virtual_events(self.straggler.delays(round_idx), t_comp)
        w_lo, ready, w_hi, valid = self._prefix_weight_stacks(events)
        results = self._anytime_results(a, b, noise)
        prod, prox, rel = self._anytime_curve(results, w_lo, w_hi, valid,
                                              a, b, with_ref)
        return events, ready, self._prefix_postprocess(ready, prox, valid), \
            prod, rel

    @staticmethod
    def _prefix_output(prod, stop: int) -> torch.Tensor:
        """The stop prefix's product, copied out of the whole decode so
        that the decode's memory is freed with the round."""
        return prod[stop - 1].clone(memory_format=torch.contiguous_format)

    def _matmul_anytime(self, a, b, round_idx: int, noise=None):
        """The proxy-driven round (ErrorTarget): run all workers' math,
        decode every prefix in one batched launch, stop at the earliest
        prefix whose embedded error estimate meets the target.  One
        ``coded_matmul`` and one ``berrut_combine`` launch per round."""
        blk, _ = self._round_compute_time(a.shape, b.shape)
        launches0 = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        events, ready, prox, prod, _ = self._anytime_prefix_eval(
            a, b, round_idx, with_ref=False, noise=noise)
        stop = self._proxy_stop(events, prox)
        out = self._prefix_output(prod, stop)
        del prod
        _sync(self.device)
        t_master = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        wait_s = float(events[stop - 1].t)
        crypto_s = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                               torch.float32)
        hideable = (0.0 if self._pipeline is None else
                    min(t_master, self._encode_only_time(a.shape)))
        stats = self._stats(events, wait_s, encode_s=t_master,
                            compute_wait_s=wait_s, decode_s=0.0,
                            crypto_s=crypto_s, n_waited=stop,
                            dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             wait_s))
        return out, stats

    def _matmul_anytime_real_fused(self, a, b, round_idx: int, noise=None):
        """The encrypted anytime round, stage 1 with the wire inside
        (:meth:`_anytime_results_real`), stage 2 as in the plain round.
        The bits-codec wire is lossless, so proxies, stop index and output
        equal the plain anytime round's; ``crypto_s`` is the wire work
        timed alone (:meth:`_fused_crypto_time`)."""
        blk, t_comp = self._round_compute_time(a.shape, b.shape)
        events = virtual_events(self.straggler.delays(round_idx), t_comp)
        launches0 = kernel_launches()
        _sync(self.device)
        t0 = time.perf_counter()
        results = self._anytime_results_real(a, b, noise)
        w_lo, ready, w_hi, valid = self._prefix_weight_stacks(events)
        prod, prox, _ = self._anytime_curve(results, w_lo, w_hi, valid, a, b,
                                            with_ref=False)
        del results
        prox = self._prefix_postprocess(ready, prox, valid)
        stop = self._proxy_stop(events, prox)
        out = self._prefix_output(prod, stop)
        del prod
        _sync(self.device)
        t_master = time.perf_counter() - t0
        launches = kernel_launches() - launches0
        crypto_s = min(self._fused_crypto_time(blk, a.shape[1], b.shape[-1]),
                       t_master)
        modeled = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                              torch.float32)
        wait_s = float(events[stop - 1].t)
        encode_s = t_master - crypto_s
        hideable = (0.0 if self._pipeline is None else
                    min(encode_s, self._encode_only_time(a.shape)))
        stats = self._stats(events, wait_s, encode_s=encode_s,
                            compute_wait_s=wait_s, decode_s=0.0,
                            crypto_s=crypto_s, n_waited=stop,
                            crypto_modeled_s=modeled, dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             wait_s))
        return out, stats

    def _matmul_anytime_real(self, a, b, round_idx: int, noise=None):
        """The proxy-driven round over genuine ciphertexts, split at its
        wire boundaries: encode → every shard wired out → the worker
        products (:meth:`_staged_stage1`); stage 2 picks the stop prefix,
        and only the consumed arrivals' results cross the wire back.  The
        bits codec is lossless, so decoding the pre-wire results equals
        decoding the wired ones, which lets the stop prefix be computed
        before the wire back.  ``crypto_s`` is the measured wire time of
        what the master consumed: all N shards out, the stop prefix's
        results back."""
        blk, t_comp = self._round_compute_time(a.shape, b.shape)
        events = virtual_events(self.straggler.delays(round_idx), t_comp)
        launches0 = kernel_launches()
        results, t_enc, crypto_out_s = self._staged_stage1(a, b, noise)
        t0 = time.perf_counter()
        w_lo, ready, w_hi, valid = self._prefix_weight_stacks(events)
        prod, prox, _ = self._anytime_curve(results, w_lo, w_hi, valid, a, b,
                                            with_ref=False)
        prox = self._prefix_postprocess(ready, prox, valid)
        stop = self._proxy_stop(events, prox)
        out = self._prefix_output(prod, stop)
        del prod
        _sync(self.device)
        t_dec = time.perf_counter() - t0
        # wire back the consumed arrivals (the decrypted bits are the
        # sent bits; the measured time is the real cost)
        t0 = time.perf_counter()
        for ev in events[:stop]:
            results[ev.worker] = self._wire(results[ev.worker],
                                            self._worker_kps[ev.worker],
                                            self._master_kp)
        _sync(self.device)
        crypto_s = crypto_out_s + time.perf_counter() - t0
        launches = kernel_launches() - launches0
        wait_s = float(events[stop - 1].t)
        modeled = self._crypto_overhead_elems(self.n * blk * a.shape[1],
                                              torch.float32)
        hideable = (0.0 if self._pipeline is None else
                    min(t_enc, self._encode_only_time(a.shape)))
        stats = self._stats(events, wait_s, encode_s=t_enc,
                            compute_wait_s=wait_s, decode_s=t_dec,
                            crypto_s=crypto_s, n_waited=stop,
                            crypto_modeled_s=modeled, dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             wait_s))
        return out, stats

    def anytime_curve(self, a, b, round_idx: int = 0, *, noise=None):
        """The full error-vs-latency curve of one virtual-clock round: for
        every arrival prefix, the virtual time and the decode's true
        relative error (inf where the scheme can't decode yet), plus the
        embedded-pair proxy and the monotone ``best_err`` envelope.  One
        ``coded_matmul`` and one ``berrut_combine`` launch per curve,
        however many points it has.  ``noise`` optionally supplies the
        scheme's (T, blk, d) noise blocks.

        Returns a list of :class:`~repro_torch.runtime.scheduler.AnytimePoint`.
        """
        if not getattr(self.scheme, "supports_fused", False):
            raise NotImplementedError(
                f"{self.name!r}: anytime curves need a linear data-coded "
                "scheme (prefix decode stacks)")
        a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        events, ready, prox, _, rel = self._anytime_prefix_eval(
            a, b, round_idx, with_ref=True, noise=noise)
        return assemble_curve(events, rel.cpu().numpy().astype(np.float64),
                              ready, prox)

    # ------------------------------------------------------------ adaptive
    def _build_candidate_scheme(self, **overrides):
        """Registry-backed scheme construction for the adaptive
        controller's candidates: the spec's own build, with ``k_blocks``
        (or a scheme-specific knob like GLCC's ``n_groups``) overridden."""
        from ..core import registry
        code = self.spec.code
        kwargs = dict(n_workers=code.n_workers, k_blocks=code.k_blocks,
                      t_colluding=self.spec.privacy.t_colluding,
                      noise_scale=self.spec.privacy.noise_scale,
                      seed=self.spec.seed, use_kernel=code.use_kernel,
                      **dict(code.extra))
        kwargs.update(overrides)
        return registry.build(code.scheme, **kwargs)

    def _adaptive_retune(self, round_idx: int) -> None:
        """Apply the controller's decision (if one is due) BEFORE the
        round runs: swap scheme / wait policy / fh_degree."""
        dec = self.adaptive.maybe_decide(round_idx, health=self.health)
        if dec is None:
            return
        scheme = self.adaptive.scheme_for(dec)
        if scheme is not self.scheme:
            self.scheme = scheme
            self.k = int(dec.k_blocks)
            self._scheme_token = self.adaptive._key(dec.overrides)
            supports = bool(getattr(scheme, "supports_fused", False))
            stable = bool(getattr(scheme, "fused_decode_stable", False))
            fused = self.spec.code.fused
            self.use_fused = (supports and stable) if fused is None \
                else bool(fused)
            if self.spec.transport.backend != "virtual" or self.fault.active:
                self.use_fused = False
        self.policy = self.adaptive.policy_for(dec)
        self.fh_degree = dec.fh_degree

    def _adaptive_observe(self, round_idx: int, stats: RoundStats) -> None:
        """Feed the round's consumed arrivals back to the estimator and
        the health tracker.  Only the consumed prefix is observed: the
        real transports never see past what the policy waited for."""
        consumed = tuple(stats.arrivals[: max(stats.n_waited, 1)])
        self.adaptive.observe(round_idx, consumed,
                              k_blocks=int(getattr(self.scheme, "k_blocks",
                                                   self.k)))
        if self.health is not None and not self.fault.active:
            for t, w in consumed:
                self.health.record_ok(int(w), float(t))

    def matmul(self, a, b, round_idx: int = 0, *, noise=None):
        """Returns (result (m, n) on the engine's device, RoundStats).

        On the fused path encode/compute/decode run as one unit, so the
        whole master-side wall time is reported as ``encode_s`` and
        ``decode_s`` is 0; on the loop and fault paths ``encode_s`` and
        ``decode_s`` are the master's encode and decode.
        ``compute_wait_s`` is the virtual-clock wait either way.  ``noise``
        optionally supplies the scheme's (T, blk, d) noise blocks (the
        parity tests hand in the reference's).

        Under ``AdaptiveSpec(policy="adaptive")`` each round is bracketed
        by the controller: retune (maybe) before, observe arrivals after;
        the round itself runs the unchanged paths.
        """
        if self.adaptive is not None:
            self._adaptive_retune(round_idx)
            out, stats = self._matmul_inner(a, b, round_idx, noise=noise)
            self._adaptive_observe(round_idx, stats)
            return out, stats
        return self._matmul_inner(a, b, round_idx, noise=noise)

    def _matmul_inner(self, a, b, round_idx: int = 0, *, noise=None):
        a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        if self.fault.active:
            return self._matmul_faulted(a, b, round_idx, noise)
        if not self.use_fused:
            return self._matmul_loop(a, b, round_idx, noise)
        if self.policy.needs_proxy:
            if self.encrypt == "real":
                if self._crypto_fused:
                    return self._matmul_anytime_real_fused(a, b, round_idx,
                                                           noise)
                return self._matmul_anytime_real(a, b, round_idx, noise)
            return self._matmul_anytime(a, b, round_idx, noise)
        if self.encrypt == "real":
            if self._crypto_fused:
                return self._matmul_real_fused(a, b, round_idx, noise)
            return self._matmul_real(a, b, round_idx, noise)
        return self._matmul_fused(a, b, round_idx, noise)
