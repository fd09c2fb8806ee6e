"""The coded-round engine behind ``repro_torch.api.Session``.

Ports the plain fused round of ``repro/runtime/engine.py``: ``RoundStats``,
``RoundEngine.__init__``, the virtual-clock latency model
(``_worker_compute_time``, ``_round_compute_time``,
``_virtual_round_plan``), the encode-pipelining credit and
``_matmul_fused``.  One round is encode → all N worker matmuls → masked
decode on the engine's device: one ``coded_matmul`` launch and one
``berrut_combine`` launch of the port's CUDA kernels (their plain PyTorch
versions on the CPU).

Differences from the reference, by design:

* **No jit.**  PyTorch runs eagerly, so the reference's per-shape-class
  LRU of jitted rounds (``_fused_fn``) and its ``trace_count`` are not
  ported.  The kernels are built once per process (``kernels._build``);
  a new straggler mask or shape is a kernel argument, never a new build.
* **The device** is the ``device=`` argument (``None`` = ``"cuda"``; with
  no CUDA device that raises rather than quietly running on the CPU), never
  a spec field.
* **The output** stays on the device: ``matmul`` returns a tensor, where
  the reference returns a host numpy array.  The host copy is the caller's,
  so the round's timer does not include it.
* **``RoundStats.dispatches``** counts the round's launches of the port's
  own kernels: 2 on the fused path on the card, 0 on the CPU.
* The timers synchronise the device before each stop, where the reference
  calls ``block_until_ready``.

Every other path of the reference (loop rounds, real transports, anytime,
encryption, fault handling, adaptive redundancy) raises
``NotImplementedError`` until its slice is ported (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..kernels.ops import kernel_launches
from .scheduler import EncodePipeline, plan_round
from .wait_policy import resolve_policy

__all__ = ["RoundStats", "RoundEngine", "resolve_device"]


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
    # wrappers): 2 for a fused round on the card (coded_matmul +
    # berrut_combine), 0 on the CPU, where the plain versions run
    dispatches: int = 0
    # --- fault-tolerant round fields (kept for parity; a later slice) ----
    retries: int = 0
    excluded: tuple = ()
    quarantined: tuple = ()
    degraded: bool = False
    achieved_rel_err: Optional[float] = None
    decode_mask: tuple = ()

    @property
    def total_s(self):
        return (self.encode_s + self.compute_wait_s + self.decode_s +
                self.crypto_s - self.pipelined_s)


class RoundEngine:
    """Coded A@B rounds for one ``ClusterSpec`` on one device (see module
    docstring).  ``straggler`` / ``policy`` accept pre-built instances for
    callers holding objects the spec can't express."""

    def __init__(self, spec, *, device=None, straggler=None, policy=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.name = spec.code.scheme
        self.n = spec.code.n_workers
        self.encrypt = spec.crypto.encrypt
        self.straggler = straggler if straggler is not None else \
            spec.straggler.build(self.n, spec.seed)
        self.scheme = spec.build_scheme()
        spec.validate(scheme=self.scheme)
        self.policy = resolve_policy(policy if policy is not None
                                     else spec.wait.build())
        # encode-of-next-round pipelining (opt-in, virtual-clock credit)
        self._pipeline = EncodePipeline() if spec.pipeline_encode else None
        supports = bool(getattr(self.scheme, "supports_fused", False))
        stable = bool(getattr(self.scheme, "fused_decode_stable", False))
        fused = spec.code.fused
        self.use_fused = (supports and stable) if fused is None else bool(fused)
        if spec.transport.backend != "virtual":
            self.use_fused = False
        self.fault = spec.fault
        self._worker_t = {}                 # shapes -> per-worker seconds
        self._encode_t = {}                 # shapes -> encode-only seconds

    def close(self):
        """Nothing long-lived to release on the virtual clock.  Idempotent."""

    # ------------------------------------------------------- latency model
    def _worker_compute_time(self, lhs_shape, rhs_shape) -> float:
        """Virtual-clock per-worker latency: time ONE batched matmul of the
        per-worker operand shapes on the engine's device (once per shape,
        cached) and divide by N — the N workers run concurrently.  A timing
        probe, so it may use ``torch.matmul``.  The right factor is
        broadcast over the N workers, not copied N times."""
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
        hideable = (0.0 if self._pipeline is None else
                    min(t_master, self._encode_only_time(a.shape)))
        stats = self._stats(plan.events, plan.wait_s, encode_s=t_master,
                            compute_wait_s=plan.wait_s, decode_s=0.0,
                            n_waited=len(plan.responders),
                            dispatches=launches,
                            pipelined_s=self._account_encode(hideable,
                                                             plan.wait_s))
        return out, stats

    def _unported_path(self) -> Optional[str]:
        """The reference path this spec would take that the port lacks."""
        if self.fault.active:
            return "fault injection and handling (FaultSpec)"
        if self.spec.adaptive.enabled:
            return "the adaptive redundancy controller (AdaptiveSpec)"
        if self.spec.transport.backend != "virtual":
            return f"transport {self.spec.transport.backend!r}"
        if self.encrypt is not None:
            return f"encrypt={self.encrypt!r}"
        if not self.use_fused:
            return f"the loop round ({self.name!r}, not fused)"
        if self.policy.needs_proxy:
            return f"the anytime pipeline ({self.policy.name})"
        return None

    def matmul(self, a, b, round_idx: int = 0, *, noise=None):
        """Returns (result (m, n) on the engine's device, RoundStats).

        On the fused path encode/compute/decode run as one unit, so the
        whole master-side wall time is reported as ``encode_s`` and
        ``decode_s`` is 0; ``compute_wait_s`` stays the virtual-clock wait.
        ``noise`` optionally supplies the scheme's (T, blk, d) noise blocks
        (the parity tests hand in the reference's).
        """
        return self._matmul_inner(a, b, round_idx, noise=noise)

    def _matmul_inner(self, a, b, round_idx: int = 0, *, noise=None):
        what = self._unported_path()
        if what is not None:
            raise NotImplementedError(
                f"{what} comes in a later slice of the port; see ROADMAP.md")
        a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        return self._matmul_fused(a, b, round_idx, noise)
