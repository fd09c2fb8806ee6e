"""Fault injection and fault bookkeeping for coded rounds.

Ports ``repro/runtime/faults.py`` (its own copy: the port imports nothing
of the reference):

* :func:`plan_faults`: the seeded, per-round-reproducible fault draw:
  which workers crash / drop / corrupt / spike this round, deterministic
  per ``(seed, round_idx)`` exactly like ``StragglerModel.delays``, and
  the same numpy draws as the reference, so the plans are identical;
* :class:`FaultInjectingTransport`: wraps any transport (the protocol is
  unchanged) and injects the planned faults:
  a crashed worker's completion event never arrives, a dropped worker's
  ``result()`` raises :class:`ResultDropped`, a delay spike flows through
  the wrapped transport's own ``StragglerModel``, and a corrupted worker's
  result is perturbed in transit (scaled garbage or sign/exponent bit
  flips on float results, bit-flipped payload limbs on MEA-ECC
  ``Ciphertext``s);
* :class:`WorkerHealth`: per-worker EWMA latency and crash/drop/corrupt
  counts with quarantine and probation re-admission;
* :class:`DegradedRoundError`: what a threshold scheme raises when too
  few clean results survive.

**Corruption on the device.**  The reference perturbs host numpy copies.
The port draws from the same ``np.random.Generator`` in the same order
(``standard_normal(shape)`` for "scale", ``choice(size, k,
replace=False)`` for "bitflip", ``choice`` then ``integers`` for
ciphertext limbs) and applies the draw to the tensor where it lies:
"scale" as two float32 products and one sum (``out*scale +
scale*noise``, no fused multiply-add), "bitflip" as an XOR of the
float32 bits with 0x84000000 through an int32 view, the limbs through
the int64 masking of ``crypto.field.to_i64``/``to_u32`` (torch has no
uint32 arithmetic).  Results are bit-identical to the reference's
(numpy values, as the transport tests hand in, go through a CPU tensor
and come back as numpy).

**OS-level injection** (``FaultSpec.os_level``, the socket mesh only): the
same seeded plan is armed on the mesh (``SocketTransport.
schedule_os_faults``) and the raw handle is returned: crashes are SIGKILLed
worker processes, drops are CRC failures of tampered frames, corruption
runs inside the worker process on its device through
:func:`corrupt_value` on the same stream, and delay spikes are SIGSTOP /
SIGCONT.  On the virtual clock and on threads the flag has no effect, as
in the reference (spec validation requires the socket backend for it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from .wait_policy import ArrivalEvent

__all__ = [
    "FaultPlan", "plan_faults", "retry_round_index", "corrupt_value",
    "ResultDropped", "WorkerCrashed", "DegradedRoundError",
    "FaultInjectingTransport", "WorkerHealth", "WorkerState",
]

# fault draws use a stream index distinct from the straggler model's
# ([seed, round]) and the markov-state ([seed, round, 1]) streams
_FAULT_STREAM = 2
_CORRUPT_STREAM = 3
_BACKOFF_STREAM = 4     # the engine's jittered re-dispatch backoff draws

# sign plus a ×2^±8-ish exponent shift of a float32, as a signed int32
_BITFLIP = int(np.array(0x84000000, np.uint32).view(np.int32))


class ResultDropped(RuntimeError):
    """The worker completed but its result was lost in transit (drop
    fault): the arrival event exists, ``result()`` raises this."""


class WorkerCrashed(RuntimeError):
    """Internal guard: ``result()`` was called for a worker whose round
    crashed — its event was never delivered, so a correct consumer can
    only hit this through a bookkeeping bug."""


class DegradedRoundError(RuntimeError):
    """A round ended below the scheme's minimum decodable clean prefix.

    Structured degradation for threshold schemes (and fully-failed
    rateless rounds): the caller gets the partial state — which shard
    slots have clean results (``clean_slots``), their stacked results
    (``results``: a float32 tensor on the engine's device, slot order, or
    None when no slot survived), what was excluded, how many retries ran
    and how many clean results the round needed.
    """

    def __init__(self, msg: str, *, clean_slots: Sequence[int] = (),
                 results=None, excluded: Sequence[int] = (),
                 retries: int = 0, needed: int = 0):
        super().__init__(msg)
        self.clean_slots = tuple(int(s) for s in clean_slots)
        self.results = results
        self.excluded = tuple(int(w) for w in excluded)
        self.retries = int(retries)
        self.needed = int(needed)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One round's fault assignment: per-worker boolean draws + spike
    seconds.  Crash/drop/corrupt are mutually exclusive per worker (a
    crashed worker has no result to drop or corrupt)."""
    crash: np.ndarray       # (n,) bool — no completion event ever arrives
    drop: np.ndarray        # (n,) bool — event arrives, result() raises
    corrupt: np.ndarray     # (n,) bool — result perturbed in transit
    spike_s: np.ndarray     # (n,) float64 — extra injected latency

    @property
    def any_fault(self) -> bool:
        return bool(self.crash.any() or self.drop.any() or
                    self.corrupt.any() or (self.spike_s > 0).any())


def plan_faults(fault, seed: int, round_idx: int, n: int) -> FaultPlan:
    """The deterministic fault draw for one round.  ``fault`` is a
    ``FaultSpec`` (anything with the rate fields).  Same ``(seed,
    round_idx)`` → identical plan, on any backend."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(round_idx), _FAULT_STREAM]))
    # fixed draw order so adding a fault type never reshuffles the others
    u_crash = rng.random(n)
    u_drop = rng.random(n)
    u_corrupt = rng.random(n)
    u_spike = rng.random(n)
    crash = u_crash < fault.crash_rate
    drop = ~crash & (u_drop < fault.drop_rate)
    corrupt = ~crash & ~drop & (u_corrupt < fault.corrupt_rate)
    spike = np.where(u_spike < fault.delay_spike_rate,
                     float(fault.delay_spike_s), 0.0)
    return FaultPlan(crash=crash, drop=drop, corrupt=corrupt, spike_s=spike)


def retry_round_index(round_idx: int, attempt: int) -> int:
    """Synthetic round index for re-dispatch attempt ``attempt`` ≥ 1 of
    ``round_idx``: a fresh, deterministic draw for both the straggler
    model and the fault plan (retries are NOT fault-free), far outside the
    range of real round indices."""
    if attempt == 0:
        return int(round_idx)
    return (int(round_idx) + 1) * 1_000_003 + int(attempt)


# --------------------------------------------------------------------------
# corruption
# --------------------------------------------------------------------------

def _corrupt_tensor(t: torch.Tensor, rng: np.random.Generator, mode: str,
                    scale: float) -> torch.Tensor:
    """Corrupt a float result on its device with the reference's draws,
    bit-identically: "scale" gives scaled plus dense garbage (decisively
    wrong but finite), "bitflip" flips the sign and a mid-exponent bit
    (0x84000000) of a random ~25% of float32 elements; other dtypes get
    sign flips."""
    if mode == "scale":
        noise = rng.standard_normal(tuple(t.shape))
        if t.dtype != torch.float64:
            noise = noise.astype(np.float32)
        noise = torch.from_numpy(noise).to(device=t.device, dtype=t.dtype)
        return t * scale + scale * noise
    out = t.clone(memory_format=torch.contiguous_format)
    flat = out.reshape(-1)
    if out.dtype == torch.float32 and flat.numel():
        k = max(1, flat.numel() // 4)
        idx = torch.from_numpy(rng.choice(flat.numel(), size=k,
                                          replace=False)).to(t.device)
        bits = flat.view(torch.int32)
        bits[idx] = bits[idx] ^ _BITFLIP
    else:                                    # non-f32 fallback: sign flips
        flat.neg_()
    return out


def _corrupt_ciphertext(ct, rng: np.random.Generator):
    """Tamper an MEA-ECC ``Ciphertext`` on the wire: xor random bits into
    a subset of its payload limbs (``torch.uint32``, on its device).  The
    bits codec decodes the mangled field elements into garbage floats,
    which residual screening must catch on ``encrypt="real"`` rounds."""
    from ..crypto.field import to_i64, to_u32
    payload = ct.payload
    n = payload.numel()
    k = max(1, n // 8)
    idx = rng.choice(n, size=k, replace=False)
    vals = rng.integers(1, np.iinfo(np.uint32).max, size=k, dtype=np.uint32)
    flat = to_i64(payload.reshape(-1))               # a copy, int64
    dev = flat.device
    flat[torch.from_numpy(idx).to(dev)] ^= torch.from_numpy(
        vals.astype(np.int64)).to(dev)
    return dataclasses.replace(ct, payload=to_u32(flat).reshape(
        payload.shape))


def corrupt_value(value, rng: np.random.Generator, mode: str = "scale",
                  scale: float = 1e3):
    """Corrupt one worker result in transit.

    Handles the shapes the engine moves: float tensors (plain results, on
    their device), MEA-ECC ``Ciphertext``s (``encrypt="real"`` results —
    payload limbs bit-flipped), tuples (the engine's ``(slot, payload)``
    envelope — the payload is corrupted, the routing metadata is not) and,
    as in the reference, float numpy arrays.  Unknown types pass through
    unchanged.
    """
    if isinstance(value, tuple):
        if not value:
            return value
        return value[:-1] + (corrupt_value(value[-1], rng, mode, scale),)
    if hasattr(value, "payload") and hasattr(value, "ephemeral"):
        return _corrupt_ciphertext(value, rng)
    if torch.is_tensor(value):
        if value.is_floating_point():
            return _corrupt_tensor(value, rng, mode, scale)
        return value
    try:
        arr = np.asarray(value)
    except Exception:                         # pragma: no cover - exotic type
        return value
    if np.issubdtype(arr.dtype, np.floating):
        return _corrupt_tensor(torch.from_numpy(np.array(arr)), rng, mode,
                               scale).numpy()
    return value


# --------------------------------------------------------------------------
# the injecting transport
# --------------------------------------------------------------------------

class _SpikedStraggler:
    """A ``StragglerModel`` wrapper adding the fault plan's delay spikes.

    Spikes flow through the wrapped transport's OWN latency source (the
    virtual clock builds its timeline from ``straggler.delays``, the thread
    backend sleeps them), so both backends see identical spike timing."""

    def __init__(self, base, fault, seed: int):
        self._base = base
        self._fault = fault
        self._seed = int(seed)

    def __getattr__(self, name):
        return getattr(self._base, name)

    def delays(self, round_idx: int) -> np.ndarray:
        d = np.array(self._base.delays(round_idx), copy=True)
        plan = plan_faults(self._fault, self._seed, round_idx,
                           self._base.n_workers)
        return d + plan.spike_s[: d.size]


class _FaultyRoundHandle:
    """Wraps an inner round handle, applying one round's fault plan:
    crashed workers' events are swallowed, dropped workers' ``result()``
    raises, corrupted workers' results are perturbed deterministically."""

    def __init__(self, inner, plan: FaultPlan, fault, seed: int,
                 round_idx: int):
        self._inner = inner
        self._plan = plan
        self._fault = fault
        self._seed = int(seed)
        self._round_idx = int(round_idx)
        self._cache: Dict[int, object] = {}

    def events(self) -> Iterator[ArrivalEvent]:
        crash = self._plan.crash
        for ev in self._inner.events():
            if ev.worker < crash.size and crash[ev.worker]:
                continue                      # no event ever arrives
            yield ev

    def result(self, worker: int):
        plan = self._plan
        if worker < plan.crash.size and plan.crash[worker]:
            raise WorkerCrashed(
                f"worker {worker} crashed in round {self._round_idx} — "
                "its completion event was never delivered")
        if worker < plan.drop.size and plan.drop[worker]:
            raise ResultDropped(
                f"worker {worker}'s result of round {self._round_idx} "
                "was lost in transit")
        if worker in self._cache:
            return self._cache[worker]
        res = self._inner.result(worker)
        if worker < plan.corrupt.size and plan.corrupt[worker]:
            rng = np.random.default_rng(np.random.SeedSequence(
                [self._seed, self._round_idx, _CORRUPT_STREAM, int(worker)]))
            res = corrupt_value(res, rng, self._fault.corrupt_mode,
                                self._fault.corrupt_scale)
        self._cache[worker] = res
        return res

    def finish(self) -> float:
        return self._inner.finish()


class FaultInjectingTransport:
    """A transport decorator injecting seeded faults (see the module
    docstring).  Protocol-identical to the wrapped backend, so any round
    consumer works unchanged; ``close()`` delegates."""

    def __init__(self, inner, fault, seed: int):
        self.inner = inner
        self.fault = fault
        self.seed = int(seed)
        self.name = f"faulty+{inner.name}"
        # OS-level mode: the inner mesh realizes the plan (SIGKILL, SIGSTOP
        # + SIGCONT, worker-side corrupt and frame tamper) instead of this
        # wrapper simulating it on the event stream
        self.os_level = (bool(getattr(fault, "os_level", False)) and
                         hasattr(inner, "schedule_os_faults"))
        if fault.delay_spike_rate > 0 and not self.os_level:
            # route spikes through the inner transport's own latency model
            inner.straggler = _SpikedStraggler(inner.straggler, fault, seed)

    @property
    def straggler(self):
        return self.inner.straggler

    def submit_round(self, shards, f, round_idx, *, t_compute=None,
                     budget=None, min_ready=1):
        plan = plan_faults(self.fault, self.seed, round_idx, len(shards))
        if self.os_level:
            # the same seeded plan, with real consequences: arm the mesh and
            # return the RAW handle
            self.inner.schedule_os_faults(round_idx, plan, self.fault,
                                          self.seed)
            return self.inner.submit_round(shards, f, round_idx,
                                           t_compute=t_compute,
                                           budget=budget,
                                           min_ready=min_ready)
        handle = self.inner.submit_round(shards, f, round_idx,
                                         t_compute=t_compute, budget=budget,
                                         min_ready=min_ready)
        return _FaultyRoundHandle(handle, plan, self.fault, self.seed,
                                  round_idx)

    def close(self) -> None:
        self.inner.close()


# --------------------------------------------------------------------------
# worker health
# --------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerState:
    """One worker's health record (see :class:`WorkerHealth`)."""
    ewma_latency_s: float = float("nan")
    n_ok: int = 0
    n_crash: int = 0
    n_drop: int = 0
    n_corrupt: int = 0
    strikes: int = 0                 # offenses since last quarantine/reset
    n_quarantines: int = 0
    quarantined_until: int = -1      # round index (exclusive); -1 = never
    ok_streak: int = 0               # clean results since release


class WorkerHealth:
    """Per-worker health: EWMA latency, fault counters, quarantine with
    probation re-admission.

    ``quarantine_after`` offenses (crash / drop / corrupt) quarantine a
    worker for ``quarantine_rounds`` rounds, doubling per quarantine
    (capped at 16×).  A released worker is on *probation*: one offense
    before ``probation_ok`` clean results re-quarantines it immediately.
    The engine feeds this tracker and excludes quarantined workers from
    dispatch; the adaptive controller consumes the same signals.
    """

    def __init__(self, n_workers: int, *, quarantine_after: int = 2,
                 quarantine_rounds: int = 4, ewma_alpha: float = 0.3,
                 probation_ok: int = 2):
        self.n = int(n_workers)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.quarantine_rounds = max(int(quarantine_rounds), 1)
        self.ewma_alpha = float(ewma_alpha)
        self.probation_ok = max(int(probation_ok), 1)
        self.workers: List[WorkerState] = [WorkerState()
                                           for _ in range(self.n)]

    # ---------------------------------------------------------- recording
    def record_ok(self, worker: int, latency_s: float) -> None:
        st = self.workers[worker]
        st.n_ok += 1
        st.ok_streak += 1
        lat = float(latency_s)
        if np.isnan(st.ewma_latency_s):
            st.ewma_latency_s = lat
        else:
            a = self.ewma_alpha
            st.ewma_latency_s = a * lat + (1.0 - a) * st.ewma_latency_s

    def _on_probation(self, st: WorkerState, round_idx: int) -> bool:
        return (st.quarantined_until >= 0 and
                round_idx >= st.quarantined_until and
                st.ok_streak < self.probation_ok)

    def _offense(self, worker: int, round_idx: int) -> None:
        st = self.workers[worker]
        st.strikes += 1
        if (st.strikes >= self.quarantine_after or
                self._on_probation(st, round_idx)):
            dur = min(self.quarantine_rounds * (2 ** st.n_quarantines),
                      16 * self.quarantine_rounds)
            st.quarantined_until = int(round_idx) + dur
            st.n_quarantines += 1
            st.strikes = 0
            st.ok_streak = 0

    def record_crash(self, worker: int, round_idx: int) -> None:
        self.workers[worker].n_crash += 1
        self._offense(worker, round_idx)

    def record_drop(self, worker: int, round_idx: int) -> None:
        self.workers[worker].n_drop += 1
        self._offense(worker, round_idx)

    def record_corrupt(self, worker: int, round_idx: int) -> None:
        self.workers[worker].n_corrupt += 1
        self._offense(worker, round_idx)

    # ----------------------------------------------------------- querying
    def is_quarantined(self, worker: int, round_idx: int) -> bool:
        return round_idx < self.workers[worker].quarantined_until

    def quarantined(self, round_idx: int) -> List[int]:
        return [w for w in range(self.n)
                if self.is_quarantined(w, round_idx)]

    def ranked(self, round_idx: int,
               exclude: Sequence[int] = ()) -> List[int]:
        """Healthy workers best-first: not quarantined, not excluded,
        sorted by EWMA latency (never-measured workers after measured
        ones)."""
        skip = set(int(w) for w in exclude)
        cands = [w for w in range(self.n)
                 if w not in skip and not self.is_quarantined(w, round_idx)]

        def key(w):
            lat = self.workers[w].ewma_latency_s
            return (1, 0.0) if np.isnan(lat) else (0, lat)

        return sorted(cands, key=key)

    def ewma_latencies(self) -> np.ndarray:
        """(N,) EWMA latency seconds per worker, NaN where never measured
        (the per-worker signal the adaptive estimator blends in)."""
        return np.asarray([st.ewma_latency_s for st in self.workers],
                          np.float64)

    def snapshot(self) -> dict:
        """JSON-able health summary."""
        return {
            "ewma_latency_s": [None if np.isnan(st.ewma_latency_s)
                               else round(st.ewma_latency_s, 6)
                               for st in self.workers],
            "n_ok": [st.n_ok for st in self.workers],
            "n_crash": [st.n_crash for st in self.workers],
            "n_drop": [st.n_drop for st in self.workers],
            "n_corrupt": [st.n_corrupt for st in self.workers],
            "n_quarantines": [st.n_quarantines for st in self.workers],
            "quarantined_until": [st.quarantined_until
                                  for st in self.workers],
        }

    def to_dict(self) -> dict:
        """Fully JSON-serializable health snapshot, one record per worker;
        every value a plain int/float/None."""
        return {
            "n_workers": int(self.n),
            "quarantine_after": int(self.quarantine_after),
            "quarantine_rounds": int(self.quarantine_rounds),
            "ewma_alpha": float(self.ewma_alpha),
            "probation_ok": int(self.probation_ok),
            "workers": [
                {
                    "worker": int(w),
                    "ewma_latency_s": (None if np.isnan(st.ewma_latency_s)
                                       else float(st.ewma_latency_s)),
                    "n_ok": int(st.n_ok),
                    "n_crash": int(st.n_crash),
                    "n_drop": int(st.n_drop),
                    "n_corrupt": int(st.n_corrupt),
                    "strikes": int(st.strikes),
                    "n_quarantines": int(st.n_quarantines),
                    "quarantined_until": int(st.quarantined_until),
                    "ok_streak": int(st.ok_streak),
                }
                for w, st in enumerate(self.workers)
            ],
        }
