"""Worker process of the socket transport's mesh.

Ports ``repro/launch/worker.py``::

    python -m repro_torch.launch.worker --connect HOST:PORT --worker-id I \\
        [--heartbeat-s 0.2] [--connect-timeout-s 60] [--device cuda]

One process is one coded worker.  It first makes its device ready: on the
card, the CUDA context, a cuBLAS handle (one tiny product) and the kernel
libraries that the master built (``kernels._build.load_prebuilt``: a
worker never compiles).  Only then does it dial the master and register
with a HELLO frame, so a registered worker is a ready one and the first
round's arrivals do not measure a context being created.  It heartbeats on
a thread of its own (PINGs keep flowing while a product runs; only a
frozen or dead process misses its liveness deadline) and runs TASK frames
on a one-thread executor as they arrive.  Each TASK carries the round's
pickled task (``runtime.tasks``; the worker binds its operands and cipher
to ``--device``), this worker's shard (raw tensor bytes or MEA-ECC
ciphertext limbs, ``runtime.wire``), a straggler delay to sleep and an
optional fault directive:

* ``corrupt``: perturb the result with ``runtime.faults.corrupt_value`` on
  the same seeded stream ``SeedSequence([seed, round, 3, worker])`` as the
  in-process injector, so the screening faces the same bits;
* ``tamper``: flip payload bytes after the frame's CRC is computed, so the
  master's CRC check fails and the result counts as dropped.

A RESULT carries ``{"result": value, "launches": {kernel: n}}``: the
value, and the port's kernel launches (``kernels.ops.kernel_launch_counts``)
that this task made in this process, the ones with n > 0 (a sealed task on
the card: ``{"mask_add": 2}``, its open and its seal).  The reference's
RESULT is the bare value.

``--device`` is the explicit counterpart of the reference's
``JAX_PLATFORMS=cpu`` for its workers; it defaults to the card, like every
entry point of the port.  A worker that cannot make its device ready (no
CUDA device, libraries not built) never falls back to the CPU: it sends an
ERROR frame in place of its HELLO and exits 1, and the master's start
raises with the worker's message.

If the connection drops while the master is still there, the worker
redials with capped exponential backoff and full jitter and re-registers
under the same id; a SHUTDOWN frame, or a master that stays unreachable,
ends the process.
"""

from __future__ import annotations

import argparse
import pickle
import socket
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels.ops import kernel_launch_counts
from repro_torch.runtime import wire
from repro_torch.runtime.faults import _CORRUPT_STREAM, corrupt_value
from repro_torch.runtime.scheduler import retry_backoff

_TAMPER_STREAM = 6       # rng stream for tamper byte positions (worker-side)


class _Connection:
    """One live connection to the master: socket + send lock + heartbeat."""

    def __init__(self, sock: socket.socket, worker_id: int,
                 heartbeat_s: float):
        self.sock = sock
        self.worker_id = worker_id
        self.heartbeat_s = heartbeat_s
        self.lock = threading.Lock()
        self.broken = threading.Event()

    def send(self, data: bytes) -> None:
        try:
            with self.lock:
                self.sock.sendall(data)
        except OSError:
            self.broken.set()
            raise

    def start_heartbeat(self) -> None:
        def _beat():
            ping = wire.pack_frame(wire.PING, self.worker_id, 0)
            while not self.broken.is_set():
                time.sleep(self.heartbeat_s)
                try:
                    self.send(ping)
                except OSError:
                    return
        threading.Thread(target=_beat, daemon=True,
                         name="worker-heartbeat").start()


def _connect(host: str, port: int, timeout_s: float,
             rng: np.random.Generator) -> socket.socket:
    """Dial the master with jittered capped-exponential backoff until
    ``timeout_s`` runs out."""
    deadline = time.perf_counter() + timeout_s
    attempt = 0
    while True:
        attempt += 1
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError:
            if time.perf_counter() >= deadline:
                raise
            time.sleep(retry_backoff(attempt, 0.05, 1.0, rng=rng))


def ready_device(name: str) -> torch.device:
    """Make ``name`` ready to compute, or raise: on the card the CUDA
    context, a cuBLAS handle and the prebuilt kernel libraries."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"worker told to use {name!r}, but no CUDA device is "
                "available (a worker never falls back to the CPU)")
        if dev.index is not None:
            torch.cuda.set_device(dev)
        x = torch.ones((8, 8), device=dev)
        torch.matmul(x, x)
        torch.cuda.synchronize(dev)
        from repro_torch.kernels import _build
        _build.load_prebuilt()
    elif dev.type != "cpu":
        raise RuntimeError(f"worker device {name!r}: expected cuda or cpu")
    return dev


def _apply_inject(result, inject: dict, worker_id: int):
    """The ``corrupt`` directive: the in-process injector's corruption on
    its seeded stream."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(inject["seed"]), int(inject["round"]), _CORRUPT_STREAM,
         int(worker_id)]))
    return corrupt_value(result, rng, mode=inject.get("mode", "scale"),
                         scale=float(inject.get("scale", 1e3)))


def _run_task(conn: _Connection, frame: wire.Frame,
              device: torch.device) -> None:
    """Run one TASK frame and send RESULT/ERROR back (on the compute
    executor, so the receive loop keeps draining frames)."""
    wid = conn.worker_id
    try:
        msg = wire.loads(frame.payload)
        delay = float(msg.get("delay") or 0.0)
        if delay > 0.0:
            time.sleep(delay)       # the straggler model's injected latency
        f = pickle.loads(msg["task"])
        bind = getattr(f, "bind", None)
        if bind is not None:
            f = bind(device)
        launches0 = kernel_launch_counts()
        result = f(wire.to_device(msg["shard"], device))
        launches = {k: n - launches0[k]
                    for k, n in kernel_launch_counts().items()
                    if n != launches0[k]}
        inject = msg.get("inject")
        if inject and inject.get("kind") == "corrupt":
            result = _apply_inject(result, inject, wid)
        # dumps copies the result to the host (synchronizing the card)
        data = wire.pack_frame(wire.RESULT, wid, frame.sub, wire.dumps(
            {"result": result, "launches": launches}))
        if inject and inject.get("kind") == "tamper":
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(inject["seed"]), int(inject["round"]),
                 _TAMPER_STREAM, wid]))
            data = wire.tamper_frame(data, rng)
    except Exception:
        err = traceback.format_exc(limit=8).encode("utf-8")
        data = wire.pack_frame(wire.ERROR, wid, frame.sub, err)
    try:
        conn.send(data)
    except OSError:
        pass        # reconnect loop takes over; the master reaps the round


def _report_start_failure(host: str, port: int, worker_id: int,
                          timeout_s: float, rng, message: str) -> None:
    """Tell the master why this worker cannot start (an ERROR frame in
    place of the HELLO)."""
    try:
        sock = _connect(host, port, timeout_s, rng)
    except OSError:
        return
    try:
        sock.sendall(wire.pack_frame(wire.ERROR, worker_id, 0,
                                     message.encode("utf-8")))
    except OSError:
        pass
    finally:
        sock.close()


def serve(host: str, port: int, worker_id: int, *,
          heartbeat_s: float = 0.2, connect_timeout_s: float = 60.0,
          max_reconnects: int = 100, device: str = "cuda") -> int:
    """Worker main loop: make the device ready, (re)connect, register,
    execute until SHUTDOWN."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [_TAMPER_STREAM + 1, int(worker_id)]))
    try:
        dev = ready_device(device)
    except Exception:
        _report_start_failure(host, port, worker_id, connect_timeout_s, rng,
                              traceback.format_exc(limit=8))
        return 1
    executor = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix=f"w{worker_id}-compute")
    reconnects = 0
    while True:
        try:
            sock = _connect(host, port, connect_timeout_s, rng)
        except OSError:
            return 1                # master permanently unreachable
        conn = _Connection(sock, worker_id, heartbeat_s)
        try:
            conn.send(wire.pack_frame(wire.HELLO, worker_id, 0))
            conn.start_heartbeat()
            while True:
                frame = wire.read_frame(sock)
                if frame.type == wire.SHUTDOWN:
                    return 0
                if frame.type == wire.TASK and frame.crc_ok:
                    executor.submit(_run_task, conn, frame, dev)
        except (EOFError, OSError, wire.FrameError):
            conn.broken.set()
            try:
                sock.close()
            except OSError:
                pass
            reconnects += 1
            if reconnects > max_reconnects:
                return 1
            # transient drop: back off with jitter, redial, re-HELLO
            time.sleep(retry_backoff(min(reconnects, 6), 0.05, 1.0,
                                     rng=rng))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.worker",
        description="SPACDC socket-mesh worker process")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="master's listen address")
    ap.add_argument("--worker-id", required=True, type=int,
                    help="this worker's index in the coded pool")
    ap.add_argument("--heartbeat-s", type=float, default=0.2,
                    help="liveness PING period (default 0.2s)")
    ap.add_argument("--connect-timeout-s", type=float, default=60.0,
                    help="give up dialing the master after this long")
    ap.add_argument("--device", default="cuda",
                    help="torch device the worker computes on (default: "
                    "the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    return serve(host or "127.0.0.1", int(port), args.worker_id,
                 heartbeat_s=args.heartbeat_s,
                 connect_timeout_s=args.connect_timeout_s,
                 device=args.device)


if __name__ == "__main__":
    sys.exit(main())
