"""Pluggable wait policies — when does the master stop waiting and decode?

Ports ``repro/runtime/wait_policy.py`` verbatim (numpy only).

The paper's central runtime claim (§V, §VII) is that SPACDC "does not
impose strict constraints on the minimum number of results required to be
waited for": the master may decode at *any* responder prefix, trading
error against latency.  The seed runtime hard-coded one point on that
curve (wait for ``scheme.wait_policy(n_stragglers)`` responders, decode
once).  Here the choice becomes a strategy object consumed by the
event-driven round scheduler (``runtime.scheduler``): worker completions
are timestamped :class:`ArrivalEvent`s, and the policy decides — from the
events (and optionally a per-prefix error proxy) — how many arrivals the
master consumes before decoding.

Policies:

* :class:`FixedQuantile` — the seed behaviour (default everywhere):
  consume exactly ``scheme.wait_policy(n_stragglers)`` arrivals.  The
  scheduler reproduces the seed's responder selection bit-identically.
* :class:`FirstK` — consume the first ``k`` arrivals (clamped up to the
  scheme's minimum decodable prefix).
* :class:`Deadline` — consume every arrival with ``t <= t_budget``; if
  that prefix is below the scheme's minimum, extend to the earliest
  decodable prefix (an un-decodable round is worth less than a late one).
* :class:`ErrorTarget` — consume arrivals until a cheap per-prefix error
  proxy drops below ``eps``.  The proxy is the *embedded pair* estimate
  computed by the scheduler's anytime pipeline: the disagreement between
  the scheme's decode and a higher-order Floater–Hormann decode of the
  same prefix (the classic embedded-error trick; both decodes come out of
  one batched dispatch, see ``kernels.ops.prefix_decode``).

Every policy is a frozen dataclass, so configs can embed them, and
``resolve_policy`` accepts instances, names ("fixed_quantile") or None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

__all__ = [
    "ArrivalEvent", "RoundContext", "WaitPolicy", "FixedQuantile",
    "FirstK", "Deadline", "ErrorTarget", "resolve_policy",
    "scheme_min_responders",
]


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One worker completion on the round clock (virtual or wall)."""
    t: float            # seconds since round start
    worker: int         # worker index


def scheme_min_responders(scheme) -> int:
    """Smallest responder prefix the scheme can decode at all."""
    mr = getattr(scheme, "min_responders", None)
    if mr is not None:
        return int(mr)
    if getattr(scheme, "rateless", False):
        return 1
    return int(scheme.recovery_threshold)


@dataclasses.dataclass
class RoundContext:
    """What a policy sees when deciding: the scheme, the arrivals so far
    (sorted by time), and — for proxy-driven policies — the per-prefix
    error proxy (``proxies[p-1]`` estimates the decode error after ``p``
    arrivals; ``inf`` where unknown/not decodable)."""
    scheme: Any
    n_stragglers: int
    events: Sequence[ArrivalEvent]
    min_ready: int
    proxies: Optional[np.ndarray] = None

    def clamp(self, stop: int) -> int:
        return max(min(stop, len(self.events)), min(self.min_ready,
                                                    len(self.events)))


class WaitPolicy:
    """Strategy base.  Count-based policies implement :meth:`target`;
    richer ones override :meth:`stop_index` (plan over a full virtual
    timeline) and :meth:`satisfied` (incremental check as real-thread
    events stream in)."""

    name = "base"
    needs_proxy = False     # scheduler must supply per-prefix error proxies

    def target(self, ctx: RoundContext) -> int:
        """Raw arrival count the policy wants (count-based policies)."""
        raise NotImplementedError

    def stop_index(self, ctx: RoundContext) -> int:
        """How many of ``ctx.events`` (a FULL round timeline) the master
        consumes before decoding.  Always in [min_ready, n_events]."""
        return ctx.clamp(self.target(ctx))

    def satisfied(self, ctx: RoundContext) -> bool:
        """Incremental form: ``ctx.events`` holds arrivals *so far*; True
        stops consuming.  Uses the UNclamped target — a prefix that merely
        exhausts what has arrived so far is not a reason to stop."""
        return len(ctx.events) >= max(self.target(ctx), ctx.min_ready)

    def __repr__(self):
        fields = getattr(self, "__dataclass_fields__", {})
        args = ", ".join(f"{k}={getattr(self, k)!r}" for k in fields)
        return f"{type(self).__name__}({args})"


@dataclasses.dataclass(frozen=True, repr=False)
class FixedQuantile(WaitPolicy):
    """The seed behaviour: wait for ``scheme.wait_policy(n_stragglers)``
    responders (rateless schemes: everyone who isn't straggling; threshold
    schemes: the recovery threshold), decode once."""

    name = "fixed_quantile"

    def target(self, ctx: RoundContext) -> int:
        return int(ctx.scheme.wait_policy(ctx.n_stragglers))


@dataclasses.dataclass(frozen=True, repr=False)
class FirstK(WaitPolicy):
    """Decode at the first ``k`` arrivals (raised to the scheme's minimum
    decodable prefix when k is below it)."""

    k: int
    name = "first_k"

    def target(self, ctx: RoundContext) -> int:
        return int(self.k)


@dataclasses.dataclass(frozen=True, repr=False)
class Deadline(WaitPolicy):
    """Decode at the latest prefix arriving within ``t_budget`` seconds of
    round start — deadline-bounded serving.  Extends past the budget only
    as far as the scheme's minimum decodable prefix."""

    t_budget: float
    name = "deadline"

    def stop_index(self, ctx: RoundContext) -> int:
        within = sum(1 for e in ctx.events if e.t <= self.t_budget)
        return ctx.clamp(within)

    def satisfied(self, ctx: RoundContext) -> bool:
        if not ctx.events:
            return False
        return (len(ctx.events) >= ctx.min_ready and
                ctx.events[-1].t >= self.t_budget)


@dataclasses.dataclass(frozen=True, repr=False)
class ErrorTarget(WaitPolicy):
    """Decode at the earliest prefix whose error proxy is ≤ ``eps``.

    The proxy is supplied by the scheduler (``needs_proxy``): for rateless
    schemes the embedded Berrut-vs-Floater–Hormann disagreement (a genuine
    out-of-band error estimate, computed for every prefix in one batched
    dispatch), for threshold schemes 0 once decodable (their decode is
    exact) and ``inf`` below threshold.  ``min_prefix`` guards the
    degenerate first arrivals where any proxy is meaningless."""

    eps: float
    min_prefix: int = 4
    name = "error_target"
    needs_proxy = True

    def stop_index(self, ctx: RoundContext) -> int:
        if ctx.proxies is None:
            raise ValueError("ErrorTarget needs per-prefix proxies "
                             "(scheduler must run the anytime pipeline)")
        lo = max(ctx.min_ready, self.min_prefix)
        prox = np.asarray(ctx.proxies, dtype=np.float64)
        for p in range(lo, len(ctx.events) + 1):
            if p - 1 < prox.size and prox[p - 1] <= self.eps:
                return ctx.clamp(p)
        return ctx.clamp(len(ctx.events))

    def satisfied(self, ctx: RoundContext) -> bool:
        p = len(ctx.events)
        if p < max(ctx.min_ready, self.min_prefix) or ctx.proxies is None:
            return False
        prox = np.asarray(ctx.proxies, dtype=np.float64)
        return p - 1 < prox.size and bool(prox[p - 1] <= self.eps)


_NAMED = {
    "fixed_quantile": FixedQuantile,
    "fixed": FixedQuantile,
}


def resolve_policy(policy) -> WaitPolicy:
    """None -> FixedQuantile (the seed default); str -> by name; instances
    pass through; spec objects (``repro.api.WaitSpec`` — anything with a
    ``build()`` yielding a WaitPolicy) are built, so every policy-taking
    surface accepts the declarative form too."""
    if policy is None:
        return FixedQuantile()
    if isinstance(policy, WaitPolicy):
        return policy
    build = getattr(policy, "build", None)
    if callable(build):
        built = build()
        if isinstance(built, WaitPolicy):
            return built
    if isinstance(policy, str):
        key = policy.lower()
        if key in _NAMED:
            return _NAMED[key]()
        raise KeyError(f"unknown wait policy {policy!r}; named policies: "
                       f"{sorted(_NAMED)} (Deadline/FirstK/ErrorTarget take "
                       f"parameters — construct them directly)")
    raise TypeError(f"wait policy must be None, str or WaitPolicy, "
                    f"got {type(policy).__name__}")
