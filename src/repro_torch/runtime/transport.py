"""The transport seam: how one coded round's work reaches N workers and
how their completions stream back.

Ports ``repro/runtime/transport.py``: its protocols, its registry and
its in-process backends.  A :class:`Transport`'s ``submit_round(...)``
returns a :class:`RoundHandle` whose ``events()`` iterator streams
timestamped :class:`~.wait_policy.ArrivalEvent` completions in arrival
order and whose ``result(worker)`` fetches that worker's output; the
consumer drains as many events as its wait policy wants and then calls
``finish()``.  The backends:

* :class:`VirtualClockTransport` — the analytic clock: per-worker latency
  = representative compute time + injected straggler delay, the arrival
  timeline known upfront, and only the events a consumer drains ever run
  their work;
* :class:`ThreadTransport` — real threads sleeping real injected delays
  behind ONE long-lived executor of 2N threads; completions are consumed
  as they land, unconsumed stragglers keep running with their results
  dropped, and a late failure is tagged with its round and surfaces on
  that round's ``finish()`` or the next submit; ``close`` is bounded by
  ``join_timeout_s``.

:func:`build_transport` maps ``TransportSpec.backend`` to a class through
the ``TRANSPORTS`` registry, as the reference's does; the third backend,
the socket mesh of worker processes, is ``runtime.socket_transport``
(imported only when it is built).

**Threads on CUDA.**  The reference's worker blocks on ``np.asarray``, so
its arrival is a finished product.  A PyTorch call on a CUDA tensor
returns when the kernel is queued, and every thread shares the default
stream, so each executor thread runs its products on a CUDA stream of its
own: the stream first waits for an event the master recorded at submit
(behind the encode and the wire out), the worker queues its product and
waits for an event recorded behind it before it reports arrival, and
:meth:`_ThreadRoundHandle.result` makes the master's stream wait for that
event (and records the result on it for the caching allocator).  A thread's
first CUDA call creates its cuBLAS handle and the workspace of its
(handle, stream) pair while holding the interpreter lock, which would
stall every other worker's arrival; so before the first CUDA round the
transport starts all 2N threads and makes each initialise its stream and
cuBLAS state with a tiny product (:meth:`ThreadTransport.warm`), as a
worker process would at start-up.  PyTorch keeps a cuBLAS workspace for
every (handle, stream) pair it has seen, 32 MiB each on the H100, so the
open transport holds about 2N of them; ``close`` releases them once every
thread has been joined.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import (Callable, Iterator, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np
import torch

from .straggler import StragglerModel
from .wait_policy import ArrivalEvent

__all__ = ["RoundHandle", "Transport", "VirtualClockTransport",
           "ThreadTransport", "TRANSPORTS", "available_backends",
           "build_transport", "virtual_timeline"]


def virtual_timeline(delays: np.ndarray, t_compute: float) -> List[ArrivalEvent]:
    """Sorted arrival timeline of the virtual clock.

    Latency model and tie-breaking are EXACTLY the reference's
    (``np.argsort(delays + t_compute)``), so responder selection is
    identical.
    """
    lat = np.asarray(delays, dtype=np.float64) + float(t_compute)
    order = np.argsort(lat)
    return [ArrivalEvent(t=float(lat[i]), worker=int(i)) for i in order]


@runtime_checkable
class RoundHandle(Protocol):
    """One in-flight round: stream its completions, fetch its results."""

    def events(self) -> Iterator[ArrivalEvent]:
        """Completions in arrival order.  Stops early when the round's
        deadline budget fires (after ``min_ready`` arrivals)."""

    def result(self, worker: int):
        """The worker's output (computed lazily on the virtual clock)."""

    def finish(self) -> float:
        """Stop consuming: drop or cancel stragglers, return the elapsed
        wall seconds (real transports) or 0.0 (virtual: the event times
        are the clock).  Idempotent; always call it when done draining."""


@runtime_checkable
class Transport(Protocol):
    """A backend that can carry rounds.  Implementations own whatever
    long-lived resources rounds share (executors, CUDA streams, sockets,
    worker processes) and release them in ``close()``."""

    name: str

    def submit_round(self, shards: Sequence, f: Callable, round_idx: int, *,
                     t_compute: Optional[float] = None,
                     budget: Optional[float] = None,
                     min_ready: int = 1) -> RoundHandle:
        ...

    def close(self) -> None:
        ...


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


# --------------------------------------------------------------------------
# real threads
# --------------------------------------------------------------------------

def _tensors(x) -> list:
    """The tensors of a shard or result (a tensor, an MEA-ECC ciphertext's
    limbs, or a tuple of them: the fault round's envelopes)."""
    parts = x if isinstance(x, tuple) else (x,)
    parts = [getattr(t, "payload", t) for t in parts]
    return [t for t in parts if isinstance(t, torch.Tensor)]


def _cuda_device(shards) -> Optional[torch.device]:
    """The CUDA device the round's shards live on, or None."""
    for shard in shards:
        for t in _tensors(shard):
            if t.is_cuda:
                return t.device
    return None


class _ThreadRoundHandle:
    def __init__(self, transport: "ThreadTransport", shards, f,
                 delays: np.ndarray, budget, min_ready,
                 round_idx: int = -1):
        self._tr = transport
        self._budget = budget
        self._min_ready = max(int(min_ready), 1)
        self._round_idx = int(round_idx)
        self._done = {}
        self._consumed = 0
        self._finished_at: Optional[float] = None
        dev = _cuda_device(shards)
        ready = None
        if dev is not None:
            transport.warm(dev)
            # every product runs after the master's queued work
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._dev = dev
        self._finished_events = {}
        self._t0 = time.perf_counter()

        def work(i):
            time.sleep(delays[i])
            if ready is None:
                return i, f(shards[i]), None
            stream = transport.thread_stream(dev)
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                res = f(shards[i])
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()          # arrival = the product finished
            return i, res, done

        self._pending = {transport.executor.submit(work, i)
                         for i in range(len(delays))}

    def events(self) -> Iterator[ArrivalEvent]:
        arrived: List[ArrivalEvent] = []
        while self._pending or arrived:
            while arrived:
                self._consumed += 1
                yield arrived.pop(0)
            if not self._pending:
                return
            timeout = None
            if self._budget is not None and self._consumed >= self._min_ready:
                timeout = max(self._budget -
                              (time.perf_counter() - self._t0), 0.0)
            finished, self._pending = wait(self._pending, timeout=timeout,
                                           return_when=FIRST_COMPLETED)
            if self._budget is not None and not finished:
                return          # woke AT the budget, not at a straggler
            for fu in finished:
                i, res, done = fu.result()
                self._done[i] = res
                self._finished_events[i] = done
                arrived.append(ArrivalEvent(
                    t=time.perf_counter() - self._t0, worker=int(i)))

    def result(self, worker: int):
        res = self._done[worker]
        done = self._finished_events.get(worker)
        if done is not None:
            # the master's later work (the decode) reads the product
            master = torch.cuda.current_stream(self._dev)
            master.wait_event(done)
            for t in _tensors(res):
                if t.is_cuda:
                    t.record_stream(master)
        return res

    def finish(self) -> float:
        if self._finished_at is None:
            self._finished_at = time.perf_counter() - self._t0
            for fu in self._pending:
                # queued-but-unstarted work is dropped; a running straggler
                # that fails later is recorded, tagged with THIS round's
                # index, and surfaced on this round's next finish()/submit
                if not fu.cancel():
                    fu.add_done_callback(
                        functools.partial(self._tr._stray, self._round_idx))
            self._pending = set()
        # a worker of THIS round that already failed points at the real
        # culprit here, not at whatever round submits next
        self._tr._raise_stray("a worker failed during its round",
                              round_idx=self._round_idx)
        return self._finished_at


class ThreadTransport:
    """Real thread workers behind ONE long-lived executor."""

    name = "threads"

    # bounded close: how long close() waits for in-flight worker threads
    # before abandoning them (a never-arriving future must not deadlock
    # Session shutdown)
    join_timeout_s: float = 2.0

    def __init__(self, n_workers: int, straggler: StragglerModel):
        self.n = n_workers
        self.straggler = straggler
        self._executor: Optional[ThreadPoolExecutor] = None
        self._stray_errors: list = []
        self._local = threading.local()     # each thread's CUDA streams
        self._warm = set()                  # devices the threads are warm on

    @property
    def executor(self) -> ThreadPoolExecutor:
        """The transport's single executor (lazily created).

        Sized 2N, not N: an early-stopped round leaves up to N-1
        stragglers sleeping on their threads, and the next round's N
        submissions must all start immediately or their arrival
        timestamps would include queueing delay the straggler model never
        injected."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=2 * self.n)
        return self._executor

    def thread_stream(self, device: torch.device):
        """The calling thread's CUDA stream on ``device`` (made once)."""
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        key = str(device)
        if key not in streams:
            streams[key] = torch.cuda.Stream(device=device)
        return streams[key]

    def warm(self, device: torch.device) -> None:
        """Start all 2N executor threads and have each make its stream on
        ``device`` and run one tiny product there (its cuBLAS handle and
        workspace), once per device.  The tasks meet at a barrier, so each
        runs on a thread of its own."""
        key = str(device)
        if key in self._warm:
            return
        n = 2 * self.n
        barrier = threading.Barrier(n)

        def init():
            barrier.wait(timeout=60.0)
            stream = self.thread_stream(device)
            with torch.cuda.stream(stream):
                x = torch.ones((8, 8), device=device)
                torch.matmul(x, x)
            stream.synchronize()

        for fu in [self.executor.submit(init) for _ in range(n)]:
            fu.result()
        self._warm.add(key)

    def _stray(self, round_idx, fu):
        if not fu.cancelled() and fu.exception() is not None:
            self._stray_errors.append((int(round_idx), fu.exception()))

    def _raise_stray(self, msg: str,
                     round_idx: Optional[int] = None) -> None:
        """Surface recorded stray failures.  With ``round_idx``, only
        failures originating in that round raise (a round's ``finish()``
        should not steal a later round's error); without, any recorded
        failure raises.  The raised message names the originating round."""
        if not self._stray_errors:
            return
        if round_idx is not None:
            hits = [(r, e) for r, e in self._stray_errors if r == round_idx]
            if not hits:
                return
        else:
            hits = self._stray_errors
        rid, err = hits[0]
        self._stray_errors.clear()
        tag = f" (originating round {rid})" if rid >= 0 else ""
        raise RuntimeError(msg + tag) from err

    def submit_round(self, shards, f, round_idx, *, t_compute=None,
                     budget=None, min_ready=1) -> _ThreadRoundHandle:
        # surface a worker the previous round never consumed dying —
        # better than silently running on a broken pool
        self._raise_stray("a straggler worker of an earlier round failed "
                          "after its round decoded")
        delays = self.straggler.delays(round_idx)
        return _ThreadRoundHandle(self, shards, f, delays, budget, min_ready,
                                  round_idx=round_idx)

    def close(self) -> None:
        """Shut the executor down without deadlocking on stragglers:
        cancel queued work, then join worker threads with a bounded
        per-close deadline (``join_timeout_s``); a thread still sleeping
        or blocked past the deadline is abandoned (its result was never
        going to be consumed).  Surfaces any failure an unconsumed
        straggler hit after its round.  Idempotent."""
        if self._executor is not None:
            ex = self._executor
            self._executor = None
            warmed, self._warm = self._warm, set()  # new executor, new threads
            ex.shutdown(wait=False, cancel_futures=True)
            deadline = time.perf_counter() + float(self.join_timeout_s)
            threads = list(getattr(ex, "_threads", ()))
            for th in threads:
                th.join(max(deadline - time.perf_counter(), 0.0))
            if warmed and not any(th.is_alive() for th in threads):
                # the workspaces of the gone threads' (handle, stream)
                # pairs; PyTorch makes the live ones anew when next used
                clear = getattr(torch._C, "_cuda_clearCublasWorkspaces",
                                None)
                if clear is not None:
                    clear()
        self._raise_stray("a straggler worker failed after its round "
                          "decoded")


def _build_socket(n_workers: int, straggler: StragglerModel, **options):
    # lazy import: the process mesh (and its subprocess machinery) loads
    # only when a socket backend is built
    from .socket_transport import SocketTransport
    return SocketTransport(n_workers, straggler, **options)


#: backend name -> factory(n_workers, straggler, **options).  Spec
#: validation and the CLI's ``--transport`` choices enumerate this dict.
TRANSPORTS = {
    "virtual": lambda n, straggler, **options: VirtualClockTransport(
        straggler),
    "threads": lambda n, straggler, **options: ThreadTransport(n, straggler),
    "socket": _build_socket,
}


def available_backends() -> tuple:
    """Sorted names of every registered transport backend."""
    return tuple(sorted(TRANSPORTS))


def build_transport(backend: str, n_workers: int,
                    straggler: StragglerModel, **options):
    """``TransportSpec.backend`` -> transport instance.  ``options`` are the
    socket mesh's knobs (``TransportSpec.backend_options()``) and its
    ``device``; the in-process backends accept and ignore them."""
    factory = TRANSPORTS.get(backend)
    if factory is None:
        raise ValueError(f"unknown transport backend {backend!r} (expected "
                         f"one of: {' | '.join(available_backends())})")
    return factory(n_workers, straggler, **options)
