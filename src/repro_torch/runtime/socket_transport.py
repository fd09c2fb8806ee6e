"""The third transport: a localhost TCP mesh of real worker processes.

Ports ``repro/runtime/socket_transport.py``.  ``SocketTransport`` speaks
the same ``submit_round → RoundHandle`` streamed-completion protocol as the
virtual clock and the thread backend (the engine cannot tell them apart),
but each of the N workers is an OS process (``python -m
repro_torch.launch.worker``) connected over a socket.  Work crosses the
wire as framed messages (``runtime.wire``): length-prefixed, CRC-32 per
frame, shards and MEA-ECC ciphertexts as their raw tensor and limb bytes.

Robustness, as in the reference:

* **Heartbeats and liveness**: workers PING every ``heartbeat_s`` from a
  thread of their own (they keep beating while computing) and the master
  timestamps every frame.  A pending worker silent past
  ``liveness_timeout_s`` is written off for the round: a SIGSTOPped or
  wedged process delays a round, it never hangs one.
* **Crash detection**: a dead worker's connection EOFs; every round with
  that worker pending is told at once, so the engine's crash accounting
  (``targets - seen`` → ``WorkerHealth.record_crash`` → re-dispatch) runs
  against a real dead PID.
* **Respawn and re-registration**: spawned workers that die are relaunched
  (capped exponential backoff with full jitter, at most ``max_respawns``
  per worker) and re-register over a fresh connection; a worker that lost
  only its socket redials and re-HELLOs itself.
* **Orphan reaping**: results addressed to a finished round are counted
  and dropped by submission id, never routed to a later round.
* **Bounded close**: ``close()`` sends SHUTDOWN, then terminates, then
  kills, within ``join_timeout_s`` in all (SIGKILL reaps stopped children).

OS-level fault injection (``FaultSpec.os_level``): the fault layer arms
:meth:`SocketTransport.schedule_os_faults` with the round's seeded
``FaultPlan`` and the mesh realizes it: ``crash`` → SIGKILL the worker
right after its own TASK is sent (the reference signals after the whole
dispatch, which on the card lets a fast worker's result arrive first: a
worker computes a shard in a millisecond, and the master takes tens of
them to frame the other workers' tasks); a delay spike → SIGSTOP now,
SIGCONT ``spike_s`` later; ``drop`` → the worker flips payload bytes after
computing the frame's CRC (the master's CRC check fails); ``corrupt`` →
the worker perturbs its result on the injector's own seeded stream, so the
screening sees the same bits on every backend.

**Devices.**  The transport has the engine's ``device``.  Workers are
started with ``--device`` set to it (``cuda`` → every worker makes a CUDA
context of its own on the card and loads the kernel libraries that the
master builds before it spawns them; ``cpu`` → the plain versions), and
results come back bound to it (``wire.to_device``).  A worker that cannot
make its device ready fails the start loudly (its ERROR frame is raised
here), never quietly computing on the CPU.  On CUDA the N workers are N
contexts time-sharing one card (no MPS), each holding its own context
memory.

**Starting workers.**  A worker is ``repro_torch.launch.worker``'s main
loop in a process of its own.  The transport forks it from
``multiprocessing``'s fork server, which imports torch and the worker
module once (and makes no CUDA context), so a worker's start is its
context, not an interpreter and a torch import: on the H100 machine's
host, 30 workers each started as ``python -m repro_torch.launch.worker``
took 54.3 s to register (``import torch`` alone 35 s each with 30 at
once), forked ones 17.4 s.  Respawns are forked the same way.  Given
``python=``, each worker is ``python -m repro_torch.launch.worker`` under
that interpreter instead.
"""

from __future__ import annotations

import collections
import io
import itertools
import os
import pickle
import queue as queue_mod
import signal
import socket
import subprocess
import sys
import threading
import time
from multiprocessing import forkserver, popen_forkserver, spawn
from multiprocessing import process as mp_process
from multiprocessing import util as mp_util
from multiprocessing.context import (ForkServerProcess, reduction,
                                     set_spawning_popen)
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from . import wire
from .engine import resolve_device
from .faults import ResultDropped
from .scheduler import retry_backoff
from .straggler import StragglerModel
from .wait_policy import ArrivalEvent

__all__ = ["SocketTransport"]

# seed stream for the transport's own jittered retries (distinct from the
# fault streams 2/3 and the engine's backoff stream 4 in runtime.faults)
_RETRY_STREAM = 9176


class _WorkerConn:
    """One registered worker connection (a worker that reconnects gets a
    fresh ``_WorkerConn`` with ``generation + 1``)."""

    __slots__ = ("wid", "sock", "generation", "lock", "last_seen", "alive")

    def __init__(self, wid: int, sock: socket.socket, generation: int):
        self.wid = wid
        self.sock = sock
        self.generation = generation
        self.lock = threading.Lock()        # serializes sends
        self.last_seen = time.perf_counter()
        self.alive = True


class _SocketRoundHandle:
    """One in-flight round on the mesh: receiver threads post results and
    death notices into a queue; ``events()`` drains it under the round's
    budget and the workers' liveness deadlines."""

    def __init__(self, transport: "SocketTransport", sub: int,
                 targets, budget, min_ready: int):
        self._tr = transport
        self._sub = int(sub)
        self._pending = set(int(w) for w in targets)
        self._budget = budget
        self._min_ready = max(int(min_ready), 1)
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._results = {}
        # worker -> the kernel launches its RESULT reported ({name: n})
        self.worker_launches: dict = {}
        # the live workers written off by the liveness deadline, in order
        self.written_off: list = []
        self._consumed = 0
        self._finished_at: Optional[float] = None
        self._t0 = time.perf_counter()

    # -- called from receiver / monitor threads ---------------------------
    def _post_result(self, worker: int, outcome, launches=None) -> None:
        if launches is not None:
            self.worker_launches[int(worker)] = launches
        self._queue.put(("result", int(worker), outcome,
                         time.perf_counter() - self._t0))

    def _post_dead(self, worker: int) -> None:
        self._queue.put(("dead", int(worker), None,
                         time.perf_counter() - self._t0))

    # -- RoundHandle protocol ---------------------------------------------
    def events(self) -> Iterator[ArrivalEvent]:
        while self._pending:
            now = time.perf_counter()
            deadlines = []
            if self._budget is not None and self._consumed >= self._min_ready:
                deadlines.append(self._t0 + float(self._budget))
            live = self._tr._liveness_deadline(self._pending)
            if live is not None:
                deadlines.append(live)
            timeout = (max(min(deadlines) - now, 0.0) + 1e-3
                       if deadlines else None)
            try:
                kind, w, outcome, t = self._queue.get(timeout=timeout)
            except queue_mod.Empty:
                now = time.perf_counter()
                if (self._budget is not None and
                        self._consumed >= self._min_ready and
                        now - self._t0 >= float(self._budget)):
                    return          # woke AT the budget, not at an arrival
                for w in self._tr._stale_workers(self._pending):
                    # heartbeat silence past the liveness deadline: the
                    # worker is suspended or wedged; write it off for this
                    # round (the engine sees a crash, not a hang)
                    self._pending.discard(w)
                    self.written_off.append(w)
                    self._tr.stats["liveness_expired"] += 1
                continue
            if w not in self._pending:
                continue            # duplicate / stale-generation frame
            self._pending.discard(w)
            if kind == "dead":
                continue            # no completion event ever arrives
            self._results[w] = outcome
            self._consumed += 1
            yield ArrivalEvent(t=float(t), worker=int(w))

    def result(self, worker: int):
        """The worker's result, on the transport's device."""
        kind, value = self._results[worker]
        if kind == "ok":
            return wire.to_device(value, self._tr.device)
        if kind == "dropped":
            raise ResultDropped(value)
        raise RuntimeError(value)

    def finish(self) -> float:
        if self._finished_at is None:
            self._finished_at = time.perf_counter() - self._t0
            self._tr._finish_round(self._sub)
        return self._finished_at


# what the fork server imports once, so that a forked worker starts
# without importing them (torch alone took 7.2 s of a worker's start on
# the H100 machine's host, and 35 s each with 30 workers starting at once)
_FORK_PRELOAD = ("torch", "repro_torch.launch.worker")


def _forked_worker_main(argv, env, quiet: bool) -> None:
    """A worker forked from the fork server: the master's environment as
    it was at the spawn, stdout and stderr to /dev/null unless
    ``SPACDC_WORKER_DEBUG`` is set, then the worker's main loop."""
    os.environ.clear()
    os.environ.update(env)
    if quiet:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        os.dup2(devnull, 2)
    from ..launch import worker
    sys.exit(worker.main(argv))


class _NoMainPopen(popen_forkserver.Popen):
    """The standard library's fork-server launch (Python 3.12) with the
    preparation data's main-module entries left out: a forked worker runs
    a function of this package and needs nothing of the program that
    started it, whose main script need not guard itself with ``if
    __name__ == "__main__"``."""

    def _launch(self, process_obj):
        prep_data = spawn.get_preparation_data(process_obj._name)
        prep_data.pop("init_main_from_name", None)
        prep_data.pop("init_main_from_path", None)
        buf = io.BytesIO()
        set_spawning_popen(self)
        try:
            reduction.dump(prep_data, buf)
            reduction.dump(process_obj, buf)
        finally:
            set_spawning_popen(None)
        self.sentinel, w = forkserver.connect_to_new_process(self._fds)
        _parent_w = os.dup(w)
        self.finalizer = mp_util.Finalize(self, mp_util.close_fds,
                                          (_parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class _WorkerProcess(ForkServerProcess):
    """A process of the fork server launched by ``_NoMainPopen``."""

    @staticmethod
    def _Popen(process_obj):
        return _NoMainPopen(process_obj)


class _ForkedWorker:
    """A worker process forked from ``multiprocessing``'s fork server
    (``_FORK_PRELOAD`` imported in it once, no CUDA initialized there),
    behind the part of ``subprocess.Popen`` the transport uses.  The
    process is kept out of ``multiprocessing``'s own list of children, so
    that only this handle, under its lock, ever reads its exit status."""

    _lock_start = threading.Lock()

    def __init__(self, proc):
        self._proc = proc
        self._lock = threading.Lock()
        self.pid = proc.pid

    @classmethod
    def start(cls, argv, env, quiet: bool) -> "_ForkedWorker":
        with cls._lock_start:
            # read when the fork server starts (the first worker's start)
            forkserver.set_forkserver_preload(list(_FORK_PRELOAD))
            proc = _WorkerProcess(target=_forked_worker_main,
                                  args=(list(argv), dict(env), quiet),
                                  name="spacdc-worker")
            proc.start()
            mp_process._children.discard(proc)
        return cls(proc)

    def poll(self):
        with self._lock:
            return self._proc._popen.poll()

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            code = self.poll()
            if code is not None:
                return code
            if deadline is not None and time.perf_counter() >= deadline:
                raise subprocess.TimeoutExpired("spacdc-worker", timeout)
            time.sleep(0.01)

    def send_signal(self, sig) -> None:
        if self.poll() is None:
            os.kill(self.pid, sig)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)


class SocketTransport:
    """Master side of the process mesh (see the module docstring).

    Construction is cheap: the listener and the N worker processes come up
    on the first ``submit_round`` (or an explicit ``start()``), so a
    Session with ``TransportSpec(backend="socket")`` costs nothing until a
    round runs.  Spawned workers (and their respawns) are forked from
    ``multiprocessing``'s fork server, which imports torch and the worker
    module once for every worker; ``python=`` starts each as ``python -m
    repro_torch.launch.worker`` under that interpreter instead.  With
    ``spawn_workers=False`` the transport only listens:
    start the workers yourself, with ``python -m repro_torch.launch.worker
    --connect HOST:PORT --worker-id I --device cuda`` (other terminals, or
    other machines with a routable ``bind``).

    ``stats`` counts frames, bytes each way (``bytes_sent``,
    ``bytes_received``), the master's seconds spent serializing and
    framing outgoing tasks (``frame_s``, on the submitting thread) and
    deserializing results (``unframe_s``, on the receiver threads), and the
    robustness events (kills, respawns, CRC failures, orphans, ...).
    ``max_silence_s`` is the longest gap between two frames of one
    connection (what ``liveness_timeout_s`` has to exceed for a live
    worker; ``silences`` lists those of a second or more), and ``worker_launches_<kernel>`` sums the kernel launches that
    the workers' routed RESULTs reported; each round handle keeps its own
    per worker (``worker_launches``).
    """

    name = "socket"
    join_timeout_s: float = 5.0

    def __init__(self, n_workers: int, straggler: StragglerModel, *,
                 heartbeat_s: float = 0.2, liveness_timeout_s: float = 1.5,
                 connect_timeout_s: float = 60.0, max_respawns: int = 3,
                 bind: str = "127.0.0.1:0", spawn_workers: bool = True,
                 python: Optional[str] = None, device=None):
        self.n = int(n_workers)
        self.straggler = straggler
        self.heartbeat_s = float(heartbeat_s)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_respawns = int(max_respawns)
        self.bind = str(bind)
        self.spawn_workers = bool(spawn_workers)
        self.python = python
        self.device = resolve_device(device)
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.stats: collections.Counter = collections.Counter()
        # (worker, perf_counter at its end, seconds) of each gap of 1 s or
        # more between two frames of one connection, the first 256
        self.silences: list = []
        self._lock = threading.RLock()
        self._conns: dict = {}               # wid -> _WorkerConn
        self._rounds: dict = {}              # submission id -> handle
        self._procs: dict = {}               # wid -> _ForkedWorker or Popen
        self._respawns: collections.Counter = collections.Counter()
        self._os_plans: dict = {}            # round_idx -> (plan, fault, seed)
        self._start_errors: dict = {}        # wid -> the worker's message
        self._sub_counter = itertools.count(1)
        self._rngs: dict = {}                # wid -> jitter rng
        self._threads: list = []
        self._listener: Optional[socket.socket] = None
        self._started = False
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Bring the mesh up: bind, spawn (if owning the workers), and wait
        until all N are registered.  Idempotent.  Raises when a worker
        reports that it cannot make its device ready."""
        with self._lock:
            if self._closed:
                raise RuntimeError("socket transport is closed")
            if not self._started:
                if self.device.type == "cuda" and self.spawn_workers:
                    # workers load the libraries; they never compile
                    from ..kernels import _build
                    _build.library("mask_add")
                host, _, port = self.bind.rpartition(":")
                lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                lst.bind((host or "127.0.0.1", int(port or 0)))
                lst.listen(self.n + 8)
                lst.settimeout(0.2)
                self._listener = lst
                self.host, self.port = lst.getsockname()[:2]
                self._started = True
                self._add_thread(self._accept_loop, "spacdc-accept")
                if self.spawn_workers:
                    for wid in range(self.n):
                        self._spawn(wid)
        deadline = time.perf_counter() + self.connect_timeout_s
        while time.perf_counter() < deadline:
            with self._lock:
                live = sum(1 for c in self._conns.values() if c.alive)
                failed = dict(self._start_errors)
            if failed:
                wid, msg = sorted(failed.items())[0]
                raise RuntimeError(
                    f"socket transport: worker {wid} could not start on "
                    f"{self.device}: {msg}")
            if live >= self.n:
                return
            # a worker that died BEFORE registering never EOFs a
            # connection, so the receiver-side respawn can't see it;
            # catch it here and relaunch within the respawn budget
            if self.spawn_workers:
                with self._lock:
                    dead = [w for w, p in self._procs.items()
                            if p.poll() is not None and
                            not (w in self._conns and self._conns[w].alive)]
                for w in dead:
                    with self._lock:
                        self._respawns[w] += 1
                        exhausted = self._respawns[w] > self.max_respawns
                        if not exhausted:
                            self._spawn(w)
                    if exhausted:
                        self.stats["respawns_exhausted"] += 1
                    else:
                        self.stats["respawns"] += 1
            time.sleep(0.01)
        with self._lock:
            live = sum(1 for c in self._conns.values() if c.alive)
        raise TimeoutError(
            f"socket transport: {live}/{self.n} workers registered within "
            f"{self.connect_timeout_s:.0f}s (bind={self.bind!r}, "
            f"spawn_workers={self.spawn_workers})")

    def _add_thread(self, target, name, args=()) -> None:
        t = threading.Thread(target=target, name=name, args=args,
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _spawn(self, wid: int) -> None:
        """Launch one worker process on the transport's device (the accept
        loop registers it): forked from the fork server, or, with
        ``python`` given, a fresh interpreter."""
        import repro_torch
        env = dict(os.environ)
        pkg_root = str(Path(next(iter(repro_torch.__path__))).resolve()
                       .parent)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        argv = ["--connect", f"{self.host}:{self.port}",
                "--worker-id", str(wid),
                "--heartbeat-s", str(self.heartbeat_s),
                "--connect-timeout-s", str(self.connect_timeout_s),
                "--device", str(self.device)]
        quiet = not os.environ.get("SPACDC_WORKER_DEBUG")
        if self.python is None:
            self._procs[wid] = _ForkedWorker.start(argv, env, quiet)
        else:
            sink = subprocess.DEVNULL if quiet else None
            self._procs[wid] = subprocess.Popen(
                [self.python, "-m", "repro_torch.launch.worker", *argv],
                env=env, stdout=sink, stderr=sink)
        self.stats["spawns"] += 1

    def worker_pid(self, wid: int) -> Optional[int]:
        """PID of a spawned worker (None when externally managed)."""
        proc = self._procs.get(wid)
        return None if proc is None else proc.pid

    # ------------------------------------------------------------ accepting
    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                lst = self._listener
                if lst is None or self._closed:
                    return
            try:
                sock, _ = lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._add_thread(self._serve_conn, "spacdc-recv", args=(sock,))

    def _serve_conn(self, sock: socket.socket) -> None:
        """Per-connection receiver: HELLO registers (an ERROR in its place
        is a failed start), then PING/RESULT/ERROR frames stream in until
        EOF (worker death or a replaced connection)."""
        try:
            hello = wire.read_frame(sock)
        except (EOFError, OSError, wire.FrameError):
            sock.close()
            return
        if not (0 <= hello.worker < self.n):
            sock.close()
            return
        if hello.type == wire.ERROR:
            with self._lock:
                self._start_errors[hello.worker] = bytes(
                    hello.payload).decode("utf-8", "replace")
            sock.close()
            return
        if hello.type != wire.HELLO:
            sock.close()
            return
        wid = hello.worker
        with self._lock:
            old = self._conns.get(wid)
            conn = _WorkerConn(wid, sock,
                               0 if old is None else old.generation + 1)
            self._conns[wid] = conn
            self.stats["registrations"] += 1
            if old is not None:
                if old.alive:
                    old.alive = False
                    try:
                        old.sock.close()
                    except OSError:
                        pass
                self.stats["reconnects"] += 1
        try:
            while True:
                frame = wire.read_frame(sock)
                now = time.perf_counter()
                gap = now - conn.last_seen
                self.stats["max_silence_s"] = max(
                    self.stats["max_silence_s"], gap)
                if gap >= 1.0 and len(self.silences) < 256:
                    self.silences.append((wid, now, gap))
                conn.last_seen = now
                if frame.type == wire.PING:
                    self.stats["heartbeats"] += 1
                elif frame.type in (wire.RESULT, wire.ERROR):
                    self.stats["frames_received"] += 1
                    self.stats["bytes_received"] += (wire.HEADER_SIZE +
                                                     len(frame.payload))
                    self._route(frame)
        except (EOFError, OSError, wire.FrameError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass
            self._on_worker_down(wid, conn)

    def _route(self, frame: wire.Frame) -> None:
        with self._lock:
            handle = self._rounds.get(frame.sub)
        if handle is None:
            # a straggler of a finished round, or a stale generation:
            # reaped, never misrouted
            self.stats["orphans_reaped"] += 1
            return
        w = frame.worker
        if not frame.crc_ok:
            self.stats["crc_failures"] += 1
            handle._post_result(w, ("dropped",
                                    f"worker {w}: frame CRC mismatch — "
                                    "payload tampered or truncated on the "
                                    "wire"))
            return
        if frame.type == wire.ERROR:
            msg = bytes(frame.payload).decode("utf-8", "replace")
            handle._post_result(w, ("error",
                                    f"worker {w} task failed: {msg}"))
            return
        t0 = time.perf_counter()
        try:
            msg = wire.loads(frame.payload)
            value, launches = msg["result"], msg["launches"]
        except Exception as e:          # undecodable yet CRC-valid payload
            self.stats["decode_failures"] += 1
            handle._post_result(w, ("dropped",
                                    f"worker {w}: result payload "
                                    f"undecodable ({e})"))
            return
        self.stats["unframe_s"] += time.perf_counter() - t0
        for name, n in launches.items():
            self.stats[f"worker_launches_{name}"] += int(n)
        handle._post_result(w, ("ok", value), launches)

    def _on_worker_down(self, wid: int, conn: _WorkerConn) -> None:
        with self._lock:
            if self._conns.get(wid) is not conn:
                return              # an old, already-replaced connection
            conn.alive = False
            rounds = list(self._rounds.values())
            closed = self._closed
        if closed:
            return
        self.stats["worker_deaths"] += 1
        for h in rounds:
            h._post_dead(wid)
        if self.spawn_workers:
            self._schedule_respawn(wid)

    def _schedule_respawn(self, wid: int) -> None:
        with self._lock:
            if self._closed:
                return
            self._respawns[wid] += 1
            attempt = self._respawns[wid]
        if attempt > self.max_respawns:
            self.stats["respawns_exhausted"] += 1
            return

        def _respawn():
            # capped exponential backoff + full jitter before relaunching
            time.sleep(retry_backoff(attempt, 0.05, 1.0,
                                     rng=self._rng(wid)))
            with self._lock:
                if self._closed:
                    return
                proc = self._procs.get(wid)
            if proc is not None and proc.poll() is None:
                return      # process alive: a dropped socket, and the
                            # worker's own reconnect loop re-registers it
            with self._lock:
                if self._closed:
                    return
                self._spawn(wid)
            self.stats["respawns"] += 1

        self._add_thread(_respawn, f"spacdc-respawn-{wid}")

    def _rng(self, wid: int) -> np.random.Generator:
        rng = self._rngs.get(wid)
        if rng is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([_RETRY_STREAM, int(wid)]))
            self._rngs[wid] = rng
        return rng

    # ------------------------------------------------------------ liveness
    def _liveness_deadline(self, pending) -> Optional[float]:
        with self._lock:
            seen = [self._conns[w].last_seen for w in pending
                    if w in self._conns and self._conns[w].alive]
        if not seen:
            return None
        return min(seen) + self.liveness_timeout_s

    def _stale_workers(self, pending) -> list:
        now = time.perf_counter()
        with self._lock:
            return [w for w in pending
                    if w in self._conns and self._conns[w].alive and
                    now - self._conns[w].last_seen > self.liveness_timeout_s]

    # ------------------------------------------------------------ OS faults
    def schedule_os_faults(self, round_idx: int, plan, fault,
                           seed: int) -> None:
        """Arm one round's seeded ``FaultPlan`` as real OS-level faults,
        consumed by the next ``submit_round(round_idx)``.  Called by
        ``FaultInjectingTransport`` when ``FaultSpec.os_level`` is set."""
        self._os_plans[int(round_idx)] = (plan, fault, int(seed))

    def _kill_worker(self, wid: int) -> None:
        proc = self._procs.get(wid)
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()                      # SIGKILL: a real dead PID
                self.stats["kills"] += 1
            except OSError:
                return
            # the master knows it is dead before its socket closes (a
            # process with a CUDA context closes it only once the driver
            # has torn the context down): no task goes to it, and start()
            # waits for its respawn, which the EOF triggers
            with self._lock:
                conn = self._conns.get(wid)
                if conn is not None:
                    conn.alive = False

    def _suspend_worker(self, wid: int, spike_s: float) -> None:
        proc = self._procs.get(wid)
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(signal.SIGSTOP)
        except OSError:
            return
        self.stats["suspensions"] += 1

        def _resume():
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGCONT)
                except OSError:
                    pass

        t = threading.Timer(float(spike_s), _resume)
        t.daemon = True
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------- rounds
    def submit_round(self, shards, f, round_idx, *, t_compute=None,
                     budget=None, min_ready=1) -> _SocketRoundHandle:
        self.start()
        delays = np.asarray(self.straggler.delays(round_idx),
                            dtype=np.float64)
        os_plan = self._os_plans.pop(int(round_idx), None)
        sub = next(self._sub_counter)
        t0 = time.perf_counter()
        task_bytes = pickle.dumps(f)        # operands leave as host arrays
        self.stats["frame_s"] += time.perf_counter() - t0
        targets = [i for i in range(min(len(shards), self.n))
                   if shards[i] is not None]
        handle = _SocketRoundHandle(self, sub, targets, budget, min_ready)
        with self._lock:
            self._rounds[sub] = handle
        for i in targets:
            inject = None
            if os_plan is not None:
                plan, fault, seed = os_plan
                if i < plan.corrupt.size and plan.corrupt[i]:
                    inject = {"kind": "corrupt", "seed": seed,
                              "round": int(round_idx),
                              "mode": fault.corrupt_mode,
                              "scale": float(fault.corrupt_scale)}
                elif i < plan.drop.size and plan.drop[i]:
                    inject = {"kind": "tamper", "seed": seed,
                              "round": int(round_idx)}
            t0 = time.perf_counter()
            payload = wire.dumps({
                "sub": sub, "round": int(round_idx),
                "delay": float(delays[i]) if i < delays.size else 0.0,
                "task": task_bytes, "shard": shards[i], "inject": inject})
            frame = wire.pack_frame(wire.TASK, i, sub, payload)
            del payload
            self.stats["frame_s"] += time.perf_counter() - t0
            if self._send(i, frame):
                self.stats["bytes_sent"] += len(frame)
            else:
                handle._post_dead(i)    # unreachable now; the engine
                                        # records the crash, re-dispatches
            if os_plan is not None and i < os_plan[0].crash.size and \
                    os_plan[0].crash[i]:
                # the kill lands mid-round: after the TASK, before the
                # worker can have answered it
                self._kill_worker(i)
                handle._post_dead(i)
        if os_plan is not None:
            plan, fault, seed = os_plan
            # the planned crashes that had no task, and the stops
            for i in np.flatnonzero(plan.crash):
                if int(i) not in targets:
                    self._kill_worker(int(i))
            for i in np.flatnonzero(plan.spike_s > 0):
                self._suspend_worker(int(i), float(plan.spike_s[i]))
        return handle

    def _send(self, wid: int, data: bytes, attempts: int = 3) -> bool:
        """Send one frame with capped-backoff + full-jitter retries (a
        reconnecting worker may re-register between attempts)."""
        for attempt in range(1, attempts + 1):
            with self._lock:
                conn = self._conns.get(wid)
            if conn is not None and conn.alive:
                try:
                    with conn.lock:
                        conn.sock.sendall(data)
                    self.stats["frames_sent"] += 1
                    return True
                except OSError:
                    pass            # the receiver thread will see the EOF
            if attempt < attempts:
                time.sleep(retry_backoff(attempt, 0.02, 0.2,
                                         rng=self._rng(wid)))
        self.stats["send_failures"] += 1
        return False

    def _finish_round(self, sub: int) -> None:
        with self._lock:
            self._rounds.pop(sub, None)

    # -------------------------------------------------------------- close
    def close(self) -> None:
        """Tear the mesh down without deadlocking: best-effort SHUTDOWN
        frames, close the listener and connections, then terminate → kill
        the child processes under one bounded ``join_timeout_s`` deadline
        (SIGKILL reaps even SIGSTOPped children).  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns.values())
            procs = dict(self._procs)
            listener, self._listener = self._listener, None
            rounds = list(self._rounds.values())
            self._rounds.clear()
        for h in rounds:                # unblock any straggling consumer
            for w in list(h._pending):
                h._post_dead(w)
        for c in conns:
            if c.alive:
                try:
                    with c.lock:
                        c.sock.sendall(wire.pack_frame(wire.SHUTDOWN,
                                                       c.wid, 0))
                except OSError:
                    pass
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        deadline = time.perf_counter() + self.join_timeout_s
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        for p in procs.values():
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 0.05))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=1.0)
                except Exception:
                    pass
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        for t in self._threads:
            if isinstance(t, threading.Timer):
                t.cancel()
                continue
            t.join(max(deadline - time.perf_counter(), 0.0))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
