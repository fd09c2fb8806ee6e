"""The transport seam: how one coded round's work reaches N workers and
how their completions stream back.

Ports the virtual clock of ``repro/runtime/transport.py``:
:func:`virtual_timeline` and :class:`VirtualClockTransport` (per-worker
latency = representative compute time + injected straggler delay, the
arrival timeline known upfront, and only the events a consumer drains ever
run their work).  The thread and socket backends come in later slices;
:func:`available_backends` still names every backend the reference
registers, so one ``ClusterSpec`` JSON validates in both packages; the
engine raises for the ones not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from .straggler import StragglerModel
from .wait_policy import ArrivalEvent

__all__ = ["VirtualClockTransport", "available_backends", "virtual_timeline"]

# the reference's TRANSPORTS registry keys
_REFERENCE_BACKENDS = ("socket", "threads", "virtual")


def virtual_timeline(delays: np.ndarray, t_compute: float) -> List[ArrivalEvent]:
    """Sorted arrival timeline of the virtual clock.

    Latency model and tie-breaking are EXACTLY the reference's
    (``np.argsort(delays + t_compute)``), so responder selection is
    identical.
    """
    lat = np.asarray(delays, dtype=np.float64) + float(t_compute)
    order = np.argsort(lat)
    return [ArrivalEvent(t=float(lat[i]), worker=int(i)) for i in order]


class _VirtualRoundHandle:
    def __init__(self, shards, f, events, budget, min_ready):
        self._shards, self._f = shards, f
        self._events = events
        self._budget = budget
        self._min_ready = max(int(min_ready), 1)
        self._cache = {}

    def events(self) -> Iterator[ArrivalEvent]:
        for i, ev in enumerate(self._events):
            if (self._budget is not None and ev.t > self._budget and
                    i >= self._min_ready):
                return          # the deadline fired; prefix is decodable
            yield ev

    def result(self, worker: int):
        if worker not in self._cache:
            self._cache[worker] = self._f(self._shards[worker])
        return self._cache[worker]

    def finish(self) -> float:
        return 0.0


class VirtualClockTransport:
    """Analytic arrivals; work runs lazily for drained events only."""

    name = "virtual"

    def __init__(self, straggler: StragglerModel):
        self.straggler = straggler

    def submit_round(self, shards, f, round_idx, *, t_compute=None,
                     budget=None, min_ready=1) -> _VirtualRoundHandle:
        if t_compute is None:
            raise ValueError("virtual-clock rounds need t_compute (the "
                             "representative per-worker compute seconds)")
        events = virtual_timeline(self.straggler.delays(round_idx), t_compute)
        return _VirtualRoundHandle(shards, f, events, budget, min_ready)

    def close(self) -> None:
        pass


def available_backends() -> tuple:
    """Sorted names of every transport backend the reference registers."""
    return _REFERENCE_BACKENDS

