"""Event-driven round scheduler: worker completions are timestamped events,
the master decodes at any responder prefix a wait policy picks.

Ports ``plan_round``, ``RoundPlan``, ``virtual_events``, ``AnytimePoint``,
``assemble_curve``, ``EncodePipeline``, ``observed_delays``,
``screen_responders``, ``retry_backoff`` and ``policy_mask_fn`` of
``repro/runtime/scheduler.py``: the same delays give exactly the
reference's timeline, responders and mask.  ``screen_responders`` reads
the round's results where they lie (a tensor on the engine's device): the
finite check and the row norms (float64) run there, the eviction loop on
the host, and the leave-one-out stage calls the scheme's
``decode_residuals`` (one float64 product per pass on that device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .wait_policy import (ArrivalEvent, RoundContext, WaitPolicy,
                          resolve_policy, scheme_min_responders)

__all__ = ["RoundPlan", "AnytimePoint", "EncodePipeline", "virtual_events",
           "plan_round", "assemble_curve", "screen_responders",
           "retry_backoff", "observed_delays", "policy_mask_fn"]


def observed_delays(arrivals, n_workers: int,
                    quantize_s: float = 1e-3) -> np.ndarray:
    """Per-worker delay observations off one round's recorded arrival
    timestamps (``RoundStats.arrivals``: ((t, worker), ...)).

    The round's fastest arrival is the baseline (subtracting it removes
    the shared compute time and, on real transports, the wall-clock
    offset); results are snapped to the ``quantize_s`` grid so sub-grid
    scheduling noise on real threads cannot desynchronize the adaptive
    estimator's fits across transports.  Unobserved workers are NaN.
    """
    obs = np.full(int(n_workers), np.nan, np.float64)
    if not arrivals:
        return obs
    base = min(float(t) for t, _ in arrivals)
    for t, w in arrivals:
        w = int(w)
        if 0 <= w < n_workers:
            d = float(t) - base
            obs[w] = round(d / quantize_s) * quantize_s
    return obs


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


def screen_responders(scheme, results, mask, *, threshold: float = 2.0,
                      factor: float = 8.0, norm_factor: float = 30.0,
                      max_exclude: int = 0):
    """Byzantine screening over one round's responder set, three stages:

    1. **Non-finite pre-screen**: rows with NaN/inf (a tampered ciphertext
       that decrypted to garbage) are evicted first.
    2. **Robust norm screen**: rows whose float64 norm exceeds
       ``norm_factor ×`` the median responder norm are evicted,
       worst-first; the median is robust up to 50% corrupters, the regime
       where leave-one-out alone fails.  Only the high side is screened.
    3. **Leave-one-out residuals**: the scheme's ``decode_residuals``
       catches subtler tampering; the worst scorer is evicted until every
       survivor is below ``max(threshold, factor × median(scores))``.

    ``results`` (N, ...) is a tensor (on the engine's device) or an array.
    The eviction budget ``max_exclude`` caps total evictions across all
    stages.  Returns ``(clean_mask, excluded, scores)``: the float32 mask
    with offenders cleared, evicted worker indices in eviction order, and
    the final residual scores.
    """
    mask = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask,
                      dtype=np.float32).copy()
    flat = torch.as_tensor(results).reshape(mask.size, -1)
    excluded: List[int] = []
    if max_exclude <= 0:
        return mask, excluded, np.zeros(mask.size, np.float64)
    # stage 1: non-finite rows
    finite = torch.isfinite(flat).all(dim=1).cpu().numpy()
    for i in np.flatnonzero(mask):
        if len(excluded) >= max_exclude:
            break
        if not finite[i]:
            mask[i] = 0.0
            excluded.append(int(i))
    # stage 2: gross norm outliers (robust to many corrupters)
    norms_all = torch.linalg.vector_norm(flat, dim=1,
                                         dtype=torch.float64).cpu().numpy()
    while len(excluded) < max_exclude:
        resp = np.flatnonzero(mask)
        if resp.size < 3:
            break
        norms = norms_all[resp]
        cut = float(norm_factor) * max(float(np.median(norms)), 1e-12)
        worst = int(np.argmax(norms))
        if norms[worst] <= cut:
            break
        mask[resp[worst]] = 0.0
        excluded.append(int(resp[worst]))
    scores = np.zeros(mask.size, np.float64)
    while len(excluded) < max_exclude:
        resp = np.flatnonzero(mask)
        if resp.size < 3:   # LOO says nothing below 3 responders
            break
        scores = np.asarray(scheme.decode_residuals(results, mask),
                            np.float64)
        med = float(np.median(scores[resp]))
        cut = max(float(threshold), float(factor) * med)
        worst = resp[int(np.argmax(scores[resp]))]
        if scores[worst] <= cut:
            break
        mask[worst] = 0.0
        excluded.append(int(worst))
    return mask, excluded, scores


def retry_backoff(attempt: int, base: float, cap: float,
                  rng: Optional[np.random.Generator] = None) -> float:
    """Capped exponential backoff before re-dispatch ``attempt``
    (1-based).  With ``rng``, *full jitter*: a uniform draw in
    ``[0, min(base·2^(attempt-1), cap)]``, reproducible when the generator
    is seeded (the engine seeds one per round); without, the cap itself."""
    ceil = float(min(base * (2.0 ** max(attempt - 1, 0)), cap))
    if rng is None:
        return ceil
    return float(rng.uniform(0.0, ceil))


def policy_mask_fn(scheme, straggler, policy=None, t_compute: float = 0.0,
                   proxy_fn=None) -> Callable[[int], np.ndarray]:
    """Per-round responder masks for the coded train step:
    ``mask_fn(round_idx) -> (N,) float32`` numpy.

    ``scheme`` is any registered scheme (for gradient coding, the
    ``BerrutGradientCode``'s underlying SPACDC code); ``straggler`` a
    ``StragglerModel`` over the same N.  For ErrorTarget without an
    explicit ``proxy_fn`` the proxy is *decode-weight stability*: the L1
    change of the scheme's masked decode weights between consecutive
    prefixes (float64 on the host), which needs no worker results: the
    decoded gradient is ``weights @ results``, so once the weights stop
    moving the decode has converged.
    """
    policy = resolve_policy(policy)
    n = straggler.n_workers

    def _weight_stability(events):
        prox = np.full(len(events), np.inf)
        prev = None
        mask = np.zeros(n, np.float32)
        for p, ev in enumerate(events):
            mask[ev.worker] = 1.0
            w = scheme.decode_matrix_masked(mask).cpu().numpy().astype(
                np.float64)
            if prev is not None:
                prox[p] = (np.abs(w - prev).sum() /
                           max(np.abs(w).sum(), 1e-12))
            prev = w
        return prox

    def mask_fn(round_idx: int) -> np.ndarray:
        plan = plan_round(scheme, policy, straggler.delays(round_idx),
                          t_compute, straggler.n_stragglers,
                          proxy_fn=proxy_fn or _weight_stability)
        return plan.mask

    return mask_fn
