"""Event-driven round scheduler: worker completions are timestamped events,
the master decodes at any responder prefix a wait policy picks.

Ports ``plan_round``, ``RoundPlan``, ``virtual_events``, ``AnytimePoint``,
``assemble_curve`` and ``EncodePipeline`` of ``repro/runtime/scheduler.py``
(numpy only): the same delays give exactly the reference's timeline,
responders and mask.  ``screen_responders`` comes with the fault paths
(see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from .wait_policy import (ArrivalEvent, RoundContext, WaitPolicy,
                          resolve_policy, scheme_min_responders)

__all__ = ["RoundPlan", "AnytimePoint", "EncodePipeline", "virtual_events",
           "plan_round", "assemble_curve"]


@dataclasses.dataclass
class RoundPlan:
    """One planned round: the consumed prefix and its timeline."""
    stop: int                       # arrivals consumed before decoding
    responders: np.ndarray          # sorted worker indices of the prefix
    wait_s: float                   # virtual wait (time of last consumed event)
    events: List[ArrivalEvent]      # the FULL round timeline, sorted by t
    mask: np.ndarray                # (N,) float32 responder mask

    @property
    def arrival_order(self) -> np.ndarray:
        """Worker indices in arrival order (the whole timeline)."""
        return np.asarray([e.worker for e in self.events], dtype=np.int64)


@dataclasses.dataclass
class AnytimePoint:
    """One point of an error-vs-latency curve: what decoding after the
    ``n_responders``-th arrival (at virtual ``t_s``) would have cost."""
    n_responders: int
    worker: int                     # the worker whose arrival this is
    t_s: float
    ready: bool                     # scheme can decode this prefix at all
    rel_err: float                  # raw decode error at this prefix
    best_err: float                 # monotone envelope: min error up to here
    proxy: float = float("inf")     # embedded-pair error estimate here


def virtual_events(delays: np.ndarray, t_compute: float) -> List[ArrivalEvent]:
    """Sorted arrival timeline of the virtual clock (the transport seam's
    :func:`~.transport.virtual_timeline`, re-exported for the planners)."""
    from .transport import virtual_timeline
    return virtual_timeline(delays, t_compute)


def plan_round(scheme, policy: Optional[WaitPolicy], delays: np.ndarray,
               t_compute: float, n_stragglers: int,
               proxy_fn: Optional[Callable[[List[ArrivalEvent]],
                                           np.ndarray]] = None) -> RoundPlan:
    """Plan one virtual-clock round: build the event timeline, let the
    policy pick the stop prefix, return responders/wait/mask.

    ``proxy_fn(events) -> (E,) per-prefix error proxies`` is only invoked
    for policies that declare ``needs_proxy`` (ErrorTarget).
    """
    policy = resolve_policy(policy)
    events = virtual_events(delays, t_compute)
    min_ready = scheme_min_responders(scheme)
    proxies = None
    if policy.needs_proxy:
        if proxy_fn is None:
            raise ValueError(f"{policy.name} needs a proxy_fn")
        proxies = np.asarray(proxy_fn(events), dtype=np.float64)
    ctx = RoundContext(scheme=scheme, n_stragglers=n_stragglers,
                       events=events, min_ready=min_ready, proxies=proxies)
    stop = int(policy.stop_index(ctx))
    if not (1 <= stop <= len(events)):
        raise ValueError(f"{policy.name}: stop index {stop} outside round "
                         f"of {len(events)} workers")
    prefix = [e.worker for e in events[:stop]]
    responders = np.sort(np.asarray(prefix, dtype=np.int64))
    mask = np.zeros(len(events), np.float32)
    mask[responders] = 1.0
    return RoundPlan(stop=stop, responders=responders,
                     wait_s=float(events[stop - 1].t), events=events,
                     mask=mask)


def assemble_curve(events: Sequence[ArrivalEvent], rel_errs: np.ndarray,
                   ready: np.ndarray,
                   proxies: Optional[np.ndarray] = None) -> List[AnytimePoint]:
    """Zip a round timeline with per-prefix decode errors into the anytime
    curve, adding the monotone envelope (``best_err``: the error of the
    best decode the master has seen so far; raw Berrut errors oscillate
    with node parity, the envelope is what an anytime consumer tracks)."""
    rel_errs = np.asarray(rel_errs, dtype=np.float64)
    ready = np.asarray(ready, dtype=bool)
    points: List[AnytimePoint] = []
    best = float("inf")
    for p, ev in enumerate(events):
        err = float(rel_errs[p]) if ready[p] else float("inf")
        best = min(best, err)
        points.append(AnytimePoint(
            n_responders=p + 1, worker=ev.worker, t_s=ev.t,
            ready=bool(ready[p]), rel_err=err, best_err=best,
            proxy=float(proxies[p]) if proxies is not None else float("inf")))
    return points


class EncodePipeline:
    """Virtual-clock accounting for encode/wait overlap.

    The master is idle while it waits for workers; the encode of round
    r+1 runs in that window on the real system.  ``credit(wait_s)`` banks
    round r's wait window; ``charge(encode_s)`` splits round r+1's encode
    wall time into (charged, hidden) against the banked window.  The bank
    never carries further than one round.
    """

    def __init__(self):
        self._window = 0.0

    def credit(self, wait_s: float) -> None:
        self._window = max(float(wait_s), 0.0)

    def charge(self, encode_s: float) -> tuple:
        hidden = min(max(float(encode_s), 0.0), self._window)
        self._window = 0.0
        return float(encode_s) - hidden, hidden
