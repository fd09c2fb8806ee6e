"""The port's socket mesh (``repro_torch.runtime.wire``,
``runtime.socket_transport``, ``launch.worker``, ``tasks.SealedMatmulTask``,
``FaultSpec.os_level``, serving on the mesh) against the JAX package's
``tests/test_transport_socket.py``, case by case, on the CPU.

Worker processes are spawned with ``--device cpu`` and the meshes are kept
at N = 3-6, as the reference's are.  Exact: frames (byte for byte against
the reference's for every value that is not pickled), the cross-backend
traces within the port (virtual loop round, threads, socket; plain and
``encrypt="real"``), the defended SIGKILL round against the same plan
simulated on threads, the served tokens.  Within float32's reach: the
port's socket round against the reference's virtual loop round, 1e-5 of
max |reference| (the reference's JAX-drawn noise handed in).

The ``cuda`` cases run a 3-worker mesh on the card (every worker a CUDA
context of its own); they import no JAX and skip without a card.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, CryptoSpec, FaultSpec,
                             ServeSpec, Session, StragglerSpec,
                             TransportSpec, WaitSpec)
from repro_torch.crypto import MEAECC, generate_keypair
from repro_torch.crypto.mea_ecc import Ciphertext
from repro_torch.runtime import wire
from repro_torch.runtime.faults import FaultPlan, ResultDropped
from repro_torch.runtime.socket_transport import SocketTransport
from repro_torch.runtime.straggler import StragglerModel
from repro_torch.runtime.tasks import MatmulTask, SealedMatmulTask
from repro_torch.runtime.transport import (TRANSPORTS, available_backends,
                                           build_transport)

ROOT = Path(__file__).resolve().parents[1]
REF_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# the wire codec (no processes)
# --------------------------------------------------------------------------

_VALUES = {
    "none": None, "true": True, "false": False, "zero": 0, "neg": -7,
    "i62": 2 ** 62, "ec_x": 2 ** 255 + 12345, "neg_big": -(2 ** 200),
    "float": 1.5, "neg_zero": -0.0, "str": "héllo", "bytes": b"\x00\xff",
    "tuple": (1, "a", None), "list": [1.0, 2.0],
    "dict": {"k": (1, 2), "n": None},
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "f64_empty": np.asarray([], dtype=np.float64),
    "i64": np.arange(-3, 4, dtype=np.int64),
    "u32": np.asarray([[0, 1, 2 ** 32 - 1], [7, 2 ** 31, 5]], np.uint32),
    "task_frame": {"sub": 3, "round": 0, "delay": 0.01, "task": b"\x80\x04",
                   "shard": np.full((2, 3), 1.5, np.float32),
                   "inject": {"kind": "tamper", "seed": 1, "round": 0}},
}


def _as_port(v):
    """The port's form of a value: numpy arrays become host tensors (uint32
    through its int32 view), containers are walked."""
    if isinstance(v, np.ndarray):
        if v.dtype == np.uint32:
            return torch.from_numpy(v.view(np.int32)).view(torch.uint32)
        return torch.from_numpy(v)
    if isinstance(v, tuple):
        return tuple(_as_port(x) for x in v)
    if isinstance(v, list):
        return [_as_port(x) for x in v]
    if isinstance(v, dict):
        return {k: _as_port(x) for k, x in v.items()}
    return v


def _same_value(got, want):
    """``got`` (the port's loads) equals ``want`` (a reference value)."""
    if isinstance(want, np.ndarray):
        assert torch.is_tensor(got) and got.device.type == "cpu"
        arr = _np(got.view(torch.int32)).view(np.uint32) \
            if got.dtype == torch.uint32 else _np(got)
        assert arr.dtype == want.dtype and arr.shape == want.shape
        assert arr.tobytes() == want.tobytes()
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_value(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_value(got[k], want[k])
    else:
        assert got == want and type(got) is type(want)
        if isinstance(want, float):
            assert np.signbit(got) == np.signbit(want)


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_frame_byte_identical_to_reference(name):
    """The same value framed by both packages: byte for byte, from numpy
    arrays and from the port's host tensors alike; each package reads the
    other's frame."""
    from repro.runtime import wire as ref_wire
    v = _VALUES[name]
    want = ref_wire.pack_frame(ref_wire.RESULT, 3, 42, ref_wire.dumps(v))
    assert wire.pack_frame(wire.RESULT, 3, 42, wire.dumps(v)) == want
    assert wire.pack_frame(wire.RESULT, 3, 42,
                           wire.dumps(_as_port(v))) == want
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        fr = wire.read_frame(b)
        assert (fr.type, fr.worker, fr.sub, fr.crc_ok) == \
            (wire.RESULT, 3, 42, True)
        _same_value(wire.loads(fr.payload), v)
        a.sendall(wire.pack_frame(wire.RESULT, 3, 42,
                                  wire.dumps(_as_port(v))))
        fr = ref_wire.read_frame(b)
        assert fr.crc_ok
        got = ref_wire.loads(fr.payload)
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
        else:
            assert wire.dumps(got) == wire.dumps(v)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_ciphertext_frame_byte_identical_to_reference(mode):
    """The same plaintext sealed by both packages under the same keys and
    nonce: the same limbs, ephemeral point and nonce, so the same frame;
    each package reads the other's ciphertext and decrypts it."""
    import repro.crypto as ref_crypto
    from repro.runtime import wire as ref_wire
    x = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    ref_mea = ref_crypto.MEAECC(mode=mode, codec="bits")
    mea = MEAECC(mode=mode, codec="bits", device="cpu")
    worker = (ref_crypto.generate_keypair(sk=2001),
              generate_keypair(sk=2001))
    master = (ref_crypto.generate_keypair(sk=3001),
              generate_keypair(sk=3001))
    want = ref_mea.encrypt(x, worker[0].pk, sender=master[0], nonce=5)
    got = mea.encrypt(torch.from_numpy(x), worker[1].pk, sender=master[1],
                      nonce=5)
    frame = wire.pack_frame(wire.TASK, 0, 1, wire.dumps(got))
    assert frame == ref_wire.pack_frame(ref_wire.TASK, 0, 1,
                                        ref_wire.dumps(want))
    back = wire.loads(ref_wire.dumps(want))
    assert isinstance(back, Ciphertext) and back.payload.device.type == "cpu"
    assert back.payload.dtype == torch.uint32
    assert torch.equal(mea.decrypt(back, worker[1]), torch.from_numpy(x))
    ref_back = ref_wire.loads(wire.dumps(got))
    np.testing.assert_array_equal(ref_mea.decrypt(ref_back, worker[0]), x)


def test_ciphertext_roundtrip_no_double_serialization():
    mea = MEAECC(codec="bits", mode="stream", device="cpu")
    kp = generate_keypair()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 8))
                         .astype(np.float32))
    ct = mea.encrypt(x, kp.pk, sender=kp, nonce=5)
    got = wire.loads(wire.dumps(ct))
    # the limb plane crosses verbatim
    assert torch.equal(got.payload.view(torch.int32),
                       ct.payload.view(torch.int32))
    assert torch.equal(mea.decrypt(got, kp), mea.decrypt(ct, kp))
    encoded, limb_bytes = wire.ciphertext_wire_overhead(ct)
    assert limb_bytes == 16 * 8 * 8 * 4
    assert encoded - limb_bytes < 256


def test_array_bits_exact_and_to_device():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((7, 5))
                         .astype(np.float32))
    got = wire.loads(wire.dumps(a))
    assert got.dtype == torch.float32 and torch.equal(got, a)
    # a strided view crosses as its values
    assert torch.equal(wire.loads(wire.dumps(a.T)), a.T.contiguous())
    kp = generate_keypair()
    ct = MEAECC(codec="bits", mode="stream", device="cpu").encrypt(
        a, kp.pk, sender=kp, nonce=1)
    moved = wire.to_device({"x": (a, [ct, 3])}, torch.device("cpu"))
    assert torch.equal(moved["x"][0], a)
    assert isinstance(moved["x"][1][0], Ciphertext) and moved["x"][1][1] == 3


def test_tampered_frame_fails_crc_not_routing():
    a, b = socket.socketpair()
    try:
        frame = wire.pack_frame(wire.RESULT, 1, 7, wire.dumps(
            torch.arange(64, dtype=torch.float32)))
        a.sendall(wire.tamper_frame(frame, np.random.default_rng(0)))
        fr = wire.read_frame(b)
        assert (fr.type, fr.worker, fr.sub) == (wire.RESULT, 1, 7)
        assert fr.crc_ok is False
    finally:
        a.close()
        b.close()


def test_tamper_flips_the_reference_bytes():
    """The same rng flips the same payload bytes in both packages."""
    from repro.runtime import wire as ref_wire
    frame = wire.pack_frame(wire.RESULT, 1, 7, wire.dumps(
        np.arange(256, dtype=np.float32)))
    assert wire.tamper_frame(frame, np.random.default_rng(3)) == \
        ref_wire.tamper_frame(frame, np.random.default_rng(3))


def test_bad_magic_truncation_and_unknown_tag_raise():
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + bytes(wire.HEADER_SIZE - 4))
        with pytest.raises(wire.FrameError):
            wire.read_frame(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(wire.FrameError):
        wire.loads(b"Z")
    with pytest.raises(wire.FrameError):
        wire.loads(wire.dumps(np.ones(4, np.float32))[:-3])
    a, b = socket.socketpair()
    a.sendall(wire.pack_frame(wire.RESULT, 0, 1, b"abc")[:-1])
    a.close()
    with pytest.raises(EOFError):
        wire.read_frame(b)
    b.close()


# --------------------------------------------------------------------------
# registry, spec and task plumbing
# --------------------------------------------------------------------------

def test_socket_registered_and_built_lazily():
    assert available_backends() == ("socket", "threads", "virtual")
    assert set(TRANSPORTS) == set(available_backends())
    st = StragglerModel(4, 1, seed=0)
    tr = build_transport("socket", 4, st, heartbeat_s=0.1,
                         liveness_timeout_s=0.5, device="cpu")
    try:
        assert isinstance(tr, SocketTransport)
        assert tr.device.type == "cpu" and tr.heartbeat_s == 0.1
        assert not tr._procs and tr._listener is None
    finally:
        tr.close()
    # the in-process backends take and ignore the socket's options
    assert build_transport("threads", 4, st, device="cpu").name == "threads"
    with pytest.raises(ValueError, match="socket"):
        build_transport("carrier-pigeon", 4, st)


def test_transport_spec_and_os_level_validation():
    ts = TransportSpec(backend="socket", heartbeat_s=0.1,
                       liveness_timeout_s=0.5)
    assert ts.backend_options()["heartbeat_s"] == 0.1
    assert TransportSpec(backend="threads").backend_options() == {}
    with pytest.raises(ValueError, match="liveness"):
        TransportSpec(backend="socket", heartbeat_s=0.5,
                      liveness_timeout_s=0.5)
    with pytest.raises(ValueError, match="os_level"):
        ClusterSpec.from_dict({
            "code": {"scheme": "spacdc", "n_workers": 4, "k_blocks": 2},
            "fault": {"crash_rate": 0.2, "os_level": True},
            "transport": {"backend": "threads"},
        })


def test_tasks_pickle_device_agnostic():
    """Operands leave as host numpy arrays (never a CUDA tensor that would
    come back on cuda:0) and :meth:`bind` puts them on the worker's
    device; the sealed task's cipher is rebound too."""
    import pickle
    b = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    state = MatmulTask(b).__getstate__()
    assert isinstance(state["b"], np.ndarray)
    task = pickle.loads(pickle.dumps(MatmulTask(b))).bind("cpu")
    assert torch.is_tensor(task.b) and torch.equal(task.b, b)
    mea = MEAECC(codec="bits", mode="stream", device="cpu")
    kps = [generate_keypair() for _ in range(2)]
    master = generate_keypair()
    sealed = pickle.loads(pickle.dumps(
        SealedMatmulTask(mea, kps, master.pk, b=b))).bind("cpu")
    assert sealed.mea is not mea and sealed.mea.device.type == "cpu"
    x = torch.ones((4, 3))
    ct = mea.encrypt(x, kps[1].pk, sender=master, nonce=11)
    out = sealed((1, (ct,), 12))
    assert isinstance(out, Ciphertext) and out.nonce == 12
    assert torch.equal(mea.decrypt(out, master), x @ b)


# --------------------------------------------------------------------------
# the process mesh (worker processes on the CPU)
# --------------------------------------------------------------------------

# generous liveness where nothing is meant to expire: the suite runs
# files in parallel, and a loaded host can hold a heartbeat back
LIVENESS_S = 5.0


def _mesh(n=3, **kw):
    st = StragglerModel(n, 0, delay_s=0.01, seed=0)
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("liveness_timeout_s", LIVENESS_S)
    kw.setdefault("connect_timeout_s", 60.0)
    kw.setdefault("device", "cpu")
    return SocketTransport(n, st, **kw)


_B = torch.arange(12, dtype=torch.float32).reshape(3, 4)


def _shards(n):
    return [torch.full((2, 3), float(i + 1)) for i in range(n)]


def _plan(n, **set_):
    kw = {k: np.zeros(n, bool) for k in ("crash", "drop", "corrupt")}
    kw["spike_s"] = np.zeros(n)
    kw.update(set_)
    return FaultPlan(**kw)


def _wait_for(cond, timeout_s: float) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return bool(cond())


def _parent(pid: int) -> int:
    status = Path(f"/proc/{pid}/status").read_text()
    return int(next(line.split()[1] for line in status.splitlines()
                    if line.startswith("PPid:")))


@pytest.mark.parametrize("python", [None, sys.executable])
def test_spawned_workers_forked_or_fresh(python):
    """Spawned workers are forked from one fork server that imported torch
    for them (not children of the master), unless ``python=`` asks for a
    fresh interpreter each; either way they register, compute and stop."""
    tr = _mesh(3, python=python)
    try:
        tr.start()
        parents = {_parent(tr.worker_pid(w)) for w in range(3)}
        if python is None:
            assert len(parents) == 1 and os.getpid() not in parents
        else:
            assert parents == {os.getpid()}
        h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        assert sorted(ev.worker for ev in h.events()) == [0, 1, 2]
        torch.testing.assert_close(h.result(1), _shards(3)[1] @ _B)
        h.finish()
    finally:
        tr.close()
    assert all(p.poll() is not None for p in tr._procs.values())


def test_clean_round_all_respond():
    tr = _mesh(3)
    try:
        h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        evs = list(h.events())
        assert sorted(e.worker for e in evs) == [0, 1, 2]
        for e in evs:
            got = h.result(e.worker)
            assert got.device.type == "cpu"
            assert torch.equal(got, _shards(3)[e.worker] @ _B)
        h.finish()
        assert tr.stats["bytes_sent"] > 0 and tr.stats["bytes_received"] > 0
        assert tr.stats["frame_s"] > 0
    finally:
        tr.close()


def test_kill_mid_round_and_reconnect_after_crash():
    tr = _mesh(3)
    try:
        tr.start()
        tr.schedule_os_faults(0, _plan(3, crash=np.array([True, False,
                                                          False])),
                              FaultSpec(), 0)
        h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        evs = list(h.events())
        h.finish()
        assert sorted(e.worker for e in evs) == [1, 2]
        assert tr.stats["kills"] == 1
        assert _wait_for(lambda: tr._conns.get(0) is not None and
                         tr._conns[0].alive and
                         tr._conns[0].generation >= 1, 60.0)
        h2 = tr.submit_round(_shards(3), MatmulTask(_B), 1)
        evs2 = list(h2.events())
        h2.finish()
        assert sorted(e.worker for e in evs2) == [0, 1, 2]
        assert torch.equal(h2.result(0), _shards(3)[0] @ _B)
        assert tr.stats["respawns"] >= 1
    finally:
        tr.close()


def test_tampered_frame_reported_dropped():
    tr = _mesh(3)
    try:
        tr.schedule_os_faults(0, _plan(3, drop=np.array([False, True,
                                                         False])),
                              FaultSpec(), 0)
        h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        evs = list(h.events())
        h.finish()
        # the tampered worker ARRIVES (its frame routed), its payload
        # failed the CRC: dropped in transit
        assert sorted(e.worker for e in evs) == [0, 1, 2]
        with pytest.raises(ResultDropped):
            h.result(1)
        assert torch.equal(h.result(0), _shards(3)[0] @ _B)
        assert tr.stats["crc_failures"] == 1
    finally:
        tr.close()


def test_worker_corrupts_on_the_injectors_stream():
    """A ``corrupt`` directive perturbs the result inside the worker with
    ``faults.corrupt_value`` on the seeded stream the in-process injector
    uses: the same bits."""
    from repro_torch.runtime.faults import _CORRUPT_STREAM, corrupt_value
    fault = FaultSpec(corrupt_rate=0.5, corrupt_mode="bitflip")
    tr = _mesh(3)
    try:
        tr.schedule_os_faults(4, _plan(3, corrupt=np.array([False, False,
                                                            True])),
                              fault, 99)
        h = tr.submit_round(_shards(3), MatmulTask(_B), 4)
        evs = list(h.events())
        h.finish()
        assert len(evs) == 3
        rng = np.random.default_rng(np.random.SeedSequence(
            [99, 4, _CORRUPT_STREAM, 2]))
        want = corrupt_value(_shards(3)[2] @ _B, rng, "bitflip",
                             fault.corrupt_scale)
        got = h.result(2)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert not torch.equal(got, _shards(3)[2] @ _B)
    finally:
        tr.close()


def test_liveness_deadline_ends_round_on_frozen_worker():
    tr = _mesh(3, liveness_timeout_s=2.0)
    try:
        tr.start()
        pid = tr.worker_pid(2)
        os.kill(pid, signal.SIGSTOP)
        try:
            time.sleep(0.2)
            t0 = time.perf_counter()
            h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
            evs = list(h.events())
            h.finish()
            took = time.perf_counter() - t0
            assert sorted(e.worker for e in evs) == [0, 1]
            assert took < 10.0          # bounded by liveness, no hang
            assert tr.stats["liveness_expired"] >= 1
        finally:
            os.kill(pid, signal.SIGCONT)
    finally:
        tr.close()


class _Slow:
    """Worker 2 sleeps ``late_s`` before its product."""
    n_workers, n_stragglers = 3, 0

    def __init__(self, late_s):
        self.late_s = late_s

    def delays(self, r):
        return np.array([0.0, 0.0, self.late_s])


def test_orphaned_results_reaped():
    """The round is given up after its first two arrivals (read off the
    event stream, not timed); worker 2's late result reaches a finished
    round and is reaped by submission id within 10 s."""
    tr = _mesh(3)
    try:
        tr.start()
        tr.straggler = _Slow(3.0)
        h = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        evs = []
        for ev in h.events():
            evs.append(ev)
            if len(evs) == 2:
                break
        h.finish()                       # round forgotten here
        assert sorted(e.worker for e in evs) == [0, 1]
        assert _wait_for(lambda: tr.stats["orphans_reaped"] >= 1, 10.0)
        # the next round is not polluted by the orphan
        tr.straggler = StragglerModel(3, 0, delay_s=0.01, seed=0)
        h2 = tr.submit_round(_shards(3), MatmulTask(_B), 0)
        evs2 = list(h2.events())
        h2.finish()
        assert sorted(e.worker for e in evs2) == [0, 1, 2]
        assert torch.equal(h2.result(2), _shards(3)[2] @ _B)
    finally:
        tr.close()


def test_bounded_close_with_frozen_worker():
    tr = _mesh(3)
    tr.start()
    os.kill(tr.worker_pid(1), signal.SIGSTOP)
    t0 = time.perf_counter()
    tr.close()
    took = time.perf_counter() - t0
    assert took < tr.join_timeout_s + 5.0
    for w in range(3):
        assert tr._procs[w].poll() is not None     # all reaped
    tr.close()                                     # idempotent


def test_worker_pool_builds_one_mesh_and_closes_it():
    """The engine's pool builds its mesh once from ``transport_options``
    (worker processes on the CPU), lazily, runs real rounds on it and
    closes it with the pool; a second close is a no-op."""
    from repro_torch.runtime import WorkerPool
    pool = WorkerPool(4, StragglerModel(4, 0), backend="socket",
                      transport_options={"heartbeat_s": 0.1,
                                         "liveness_timeout_s": LIVENESS_S,
                                         "device": "cpu"})
    try:
        assert pool.backend == "socket" and pool.real_threads
        mesh = pool.transport
        assert pool.transport is mesh and mesh.heartbeat_s == 0.1
        assert not mesh._procs                  # lazy until a round
        shards = [torch.full((2, 3), float(i)) for i in range(4)]
        resp, results, _ = pool.run_round(shards, MatmulTask(_B), 0, 4)
        assert list(resp) == [0, 1, 2, 3]
        for i, r in zip(resp, results):
            assert torch.equal(r, shards[i] @ _B)
    finally:
        pool.close()
    assert mesh._closed and all(p.poll() is not None
                                for p in mesh._procs.values())
    pool.close()


def test_lazy_until_first_round():
    tr = _mesh(3)
    assert not tr._procs and tr._listener is None
    tr.close()
    with pytest.raises(RuntimeError, match="closed"):
        tr.start()


def _worker_cmd(tr, wid, device):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.worker",
           "--connect", f"{tr.host}:{tr.port}", "--worker-id", str(wid),
           "--heartbeat-s", "0.1", "--device", device]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _listen_only(n):
    """A master that only listens, its ``start()`` (which waits for the
    registrations) on a thread; start errors land in the returned list."""
    import threading
    tr = _mesh(n, spawn_workers=False)
    err = []

    def start():
        try:
            tr.start()
        except Exception as e:      # surfaced to the test through ``err``
            err.append(e)
    t = threading.Thread(target=start, daemon=True)
    t.start()
    assert _wait_for(lambda: tr.port is not None, 10.0)
    return tr, t, err


def test_workers_started_by_hand():
    """``spawn_workers=False``: the master only listens, workers started
    with ``python -m repro_torch.launch.worker --connect ... --device
    cpu`` register and serve rounds."""
    tr, t, err = _listen_only(2)
    procs = [_worker_cmd(tr, w, "cpu") for w in range(2)]
    try:
        t.join(60.0)
        assert not t.is_alive() and not err, err
        assert tr.worker_pid(0) is None          # not ours
        h = tr.submit_round(_shards(2), MatmulTask(_B), 0)
        evs = list(h.events())
        h.finish()
        assert sorted(e.worker for e in evs) == [0, 1]
    finally:
        tr.close()
        for p in procs:
            p.wait(timeout=10.0)
        assert all(p.returncode == 0 for p in procs)    # SHUTDOWN obeyed


def test_worker_without_its_device_fails_the_start_loudly(monkeypatch):
    """A worker told ``--device cuda`` on a machine without CUDA never
    computes on the CPU: its ERROR frame fails the master's start with
    the worker's message, and the worker exits 1."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    tr, t, err = _listen_only(1)
    proc = _worker_cmd(tr, 0, "cuda")
    try:
        t.join(60.0)
        assert not t.is_alive()
        assert len(err) == 1 and isinstance(err[0], RuntimeError)
        assert "worker 0 could not start" in str(err[0])
        assert "no CUDA device" in str(err[0])
        assert proc.wait(timeout=30.0) == 1
    finally:
        tr.close()
        if proc.poll() is None:
            proc.kill()


# --------------------------------------------------------------------------
# Session level: cross-backend parity, the sealed round, os_level faults
# --------------------------------------------------------------------------

def _parity_spec(backend, encrypt=None, fused=None, t_colluding=0):
    return ClusterSpec.from_dict({
        "code": {"scheme": "spacdc", "n_workers": 5, "k_blocks": 2,
                 "fused": fused},
        "privacy": {"t_colluding": t_colluding, "noise_scale": 0.1},
        "straggler": {"n_stragglers": 0, "delay_s": 0.02},
        "transport": {"backend": backend, "heartbeat_s": 0.1,
                      "liveness_timeout_s": LIVENESS_S},
        "crypto": {"encrypt": encrypt},
        "seed": 7,
    })


def _mats():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal((6, 4)).astype(np.float32)
    return a, b


def _run_matmul(spec, noise=None):
    a, b = _mats()
    with Session(spec, device="cpu") as s:
        out, stats = s.matmul(a, b, round_idx=0, noise=noise)
    assert out.device.type == "cpu"
    return out, stats


def test_plain_trace_bit_identical_virtual_threads_socket():
    o_virtual, _ = _run_matmul(_parity_spec("virtual", fused=False))
    o_threads, _ = _run_matmul(_parity_spec("threads"))
    o_socket, st = _run_matmul(_parity_spec("socket"))
    assert torch.equal(o_virtual, o_threads)
    assert torch.equal(o_threads, o_socket)
    assert st.n_waited == 5 and st.crypto_s == 0


def test_real_crypto_trace_bit_identical_and_sealed():
    o_plain, _ = _run_matmul(_parity_spec("virtual", fused=False))
    o_virtual, _ = _run_matmul(
        _parity_spec("virtual", encrypt="real", fused=False))
    o_threads, _ = _run_matmul(_parity_spec("threads", encrypt="real"))
    o_socket, st = _run_matmul(_parity_spec("socket", encrypt="real"))
    assert torch.equal(o_virtual, o_threads)
    assert torch.equal(o_threads, o_socket)
    assert torch.equal(o_socket, o_plain)
    assert st.crypto_s > 0          # the sealed wire was measured
    assert st.dispatches == 0       # no kernel on the CPU


def test_sealed_round_moves_ciphertext_both_ways(monkeypatch):
    """On the mesh the shards leave the master as ``Ciphertext``s inside
    ``(worker, (ct,), reply_nonce)`` and the results return as
    ciphertexts to the master's key."""
    from repro_torch.runtime import socket_transport
    seen = {"out": [], "back": []}
    real_submit = socket_transport.SocketTransport.submit_round

    def spy(self, shards, f, round_idx, **kw):
        seen["out"].extend(shards)
        seen["task"] = f
        handle = real_submit(self, shards, f, round_idx, **kw)
        real_result = handle.result

        def result(w):
            r = real_result(w)
            seen["back"].append(r)
            return r
        handle.result = result
        return handle

    monkeypatch.setattr(socket_transport.SocketTransport, "submit_round",
                        spy)
    _run_matmul(_parity_spec("socket", encrypt="real"))
    assert isinstance(seen["task"], SealedMatmulTask)
    assert len(seen["out"]) == 5
    nonces = set()
    for i, (w, cts, reply) in enumerate(seen["out"]):
        assert w == i and len(cts) == 1
        assert isinstance(cts[0], Ciphertext)
        nonces.update((cts[0].nonce, reply))
    assert len(nonces) == 10        # one fresh nonce per message
    assert len(seen["back"]) == 5
    assert all(isinstance(r, Ciphertext) for r in seen["back"])


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_sealed_round(tamper=None):
    """One sealed CPU mesh round under ``chip_smoke.hold_sealed_round``;
    ``tamper(engine, resp, results)`` may replace the replies the engine
    receives.  Returns (output, stats, check(), RESULT launches per
    responder, the mesh's ``max_silence_s``)."""
    cs = _chip_smoke()
    a, b = (torch.from_numpy(x) for x in _mats())
    with Session(_parity_spec("socket", encrypt="real"), device="cpu") as s:
        eng = s.engine
        mesh = eng.pool.transport
        mesh.start()
        handles = cs.record_round_handles(mesh)
        if tamper is not None:
            run = eng._loop_round

            def loop_round(*args, **kw):
                resp, results, *rest = run(*args, **kw)
                return (resp, tamper(eng, resp, results), *rest)
            eng._loop_round = loop_round
        undo, check = cs.hold_sealed_round(torch, eng, b)
        try:
            out, st = s.matmul(a, b, round_idx=0)
        finally:
            undo()
        return (out, st, check(), cs.responder_launches(handles[-1], st),
                mesh.stats["max_silence_s"])


def test_sealed_round_held_through_the_workers_replies():
    """``chip_smoke.hold_sealed_round`` on a CPU mesh: every responder's
    reply is, limb for limb, the plain version's open of its shard,
    product and seal under the reply nonce the master drew; every RESULT
    reports its task's kernel launches (none on the CPU); the master saw
    each worker's frames at most ``max_silence_s`` apart, inside the
    liveness deadline."""
    out, st, got, launches, silence = _held_sealed_round()
    want, _ = _run_matmul(_parity_spec("virtual", fused=False))
    assert torch.equal(out, want)
    assert got["rounds"] == 1 and got["shards_sealed"] == 5
    assert got["master_calls"] == 0         # the CPU runs no kernel
    assert got["worker_replies"] == got["worker_replies_exact"] == \
        st.n_waited == 5
    assert launches == {w: {} for w in range(5)}
    assert 0.0 < silence < LIVENESS_S


def test_hold_sealed_round_catches_a_reply_under_another_nonce():
    """A reply sealed under another nonce than the one the master drew
    opens to the right product (a ciphertext carries its nonce), so the
    round's output stays right; the hold still finds it."""
    def renonce(eng, resp, results):
        w, ct = resp[0], results[0]
        prod = eng._mea.decrypt(ct, eng._master_kp)
        moved = eng._mea.encrypt(prod, eng._master_kp.pk,
                                 sender=eng._worker_kps[w],
                                 nonce=ct.nonce + 10 ** 6)
        return [moved] + list(results[1:])
    out, st, got, _, _ = _held_sealed_round(renonce)
    want, _ = _run_matmul(_parity_spec("virtual", fused=False))
    assert torch.equal(out, want)
    assert got["worker_replies"] == 5 and got["worker_replies_exact"] == 4


@pytest.mark.parametrize("encrypt", [None, "real"])
def test_pair_coded_round_on_the_mesh(encrypt):
    """A pair-coded scheme (matdot, recovery threshold 3 of 5): both coded
    factors cross as host tensors (sealed: two ciphertexts per shard), and
    the round equals the virtual loop round fed its arrival order, bit for
    bit."""
    from repro_torch.runtime.engine import RoundEngine

    def spec(backend):
        return ClusterSpec.from_dict({
            "code": {"scheme": "matdot", "n_workers": 5, "k_blocks": 2,
                     "fused": False},
            "straggler": {"n_stragglers": 0},
            "transport": {"backend": backend, "heartbeat_s": 0.1,
                          "liveness_timeout_s": LIVENESS_S},
            "crypto": {"encrypt": encrypt}, "seed": 7})
    got, st = _run_matmul(spec("socket"))
    a, b = _mats()
    replay = _chip_smoke().ReplayStraggler(5, 0, [w for _, w in st.arrivals])
    eng = RoundEngine(spec("virtual"), device="cpu", straggler=replay)
    try:
        want, wst = eng.matmul(a, b)
    finally:
        eng.close()
    assert st.n_waited == wst.n_waited == 3
    assert [w for _, w in wst.arrivals[:3]] == [w for _, w in st.arrivals]
    assert torch.equal(got, want)
    assert (st.crypto_s > 0) == (encrypt == "real")


def test_socket_round_matches_reference_virtual_loop_round():
    """The port's socket round against the reference's virtual loop round
    (``fused=False``) on the same spec, the reference's JAX-drawn noise
    handed in: within 1e-5 of max |reference|."""
    import repro.api as ref_api
    a, b = _mats()
    ref_spec = ref_api.ClusterSpec.from_dict(
        _parity_spec("virtual", fused=False, t_colluding=1).to_dict())
    with ref_api.Session(ref_spec) as rs:
        want, wst = rs.matmul(a, b, round_idx=0)
        sch = rs.engine.scheme
        noise = np.array(sch.make_noise((-(-a.shape[0] // sch.k_blocks),
                                           a.shape[1])))
    got, gst = _run_matmul(_parity_spec("socket", t_colluding=1),
                           noise=torch.from_numpy(noise))
    assert gst.n_waited == wst.n_waited == 5
    rel = float(np.max(np.abs(_np(got) - want)) / np.max(np.abs(want)))
    assert rel <= REF_TOL, rel


def _sigkill_spec(backend, **fault):
    kw = {"crash_rate": 0.25, "handle": True,
          "os_level": backend == "socket", "seed": 139,
          "worker_timeout_s": 1.5, "max_retries": 3}
    kw.update(fault)
    return ClusterSpec.from_dict({
        "code": {"scheme": "spacdc", "n_workers": 6, "k_blocks": 2},
        "straggler": {"n_stragglers": 0, "delay_s": 0.02},
        "transport": {"backend": backend, "heartbeat_s": 0.1,
                      "liveness_timeout_s": LIVENESS_S},
        "fault": kw,
        "seed": 7,
    })


def test_defended_sigkill_round_completes_and_matches_threads():
    """A live worker is SIGKILLed mid-round; the defended socket round
    re-dispatches its slot and decodes at reference accuracy, bit-identical
    to the same seeded plan simulated on threads."""
    a, b = _mats()
    with Session(_sigkill_spec("socket"), device="cpu") as s:
        out, stats = s.matmul(a, b, round_idx=0)
        mesh = s.engine.pool.transport
        kills = mesh.stats["kills"]
        health = s.engine.health.to_dict()
    with Session(_sigkill_spec("threads"), device="cpu") as s:
        sim, sim_stats = s.matmul(a, b, round_idx=0)
    ref = a @ b
    rel = float(np.linalg.norm(_np(out) - ref) / np.linalg.norm(ref))
    assert kills >= 1                      # a real PID died
    assert stats.retries >= 1              # ...and was re-dispatched
    assert not stats.degraded
    assert rel <= 1e-2
    assert [w for w in health["workers"] if w["n_crash"] > 0]
    assert json.dumps(health)
    assert torch.equal(out, sim)
    assert (stats.retries, stats.decode_mask) == \
        (sim_stats.retries, sim_stats.decode_mask)
    # the pool built ONE mesh and closed it with the session
    assert mesh._closed and all(p.poll() is not None
                                for p in mesh._procs.values())


def test_encrypted_defended_sigkill_round_on_the_mesh():
    """The defended round with ``encrypt="real"`` on the mesh: envelopes
    carry ciphertexts and reply nonces to worker processes, which decrypt,
    multiply and encrypt back; the lossless wire gives the plain threads
    round's decode, bit for bit."""
    a, b = _mats()
    spec = _sigkill_spec("socket")
    spec = dataclasses.replace(spec, crypto=CryptoSpec(encrypt="real"))
    with Session(spec, device="cpu") as s:
        out, stats = s.matmul(a, b, round_idx=0)
        kills = s.engine.pool.transport.stats["kills"]
    with Session(_sigkill_spec("threads"), device="cpu") as s:
        sim, _ = s.matmul(a, b, round_idx=0)
    assert kills >= 1 and stats.retries >= 1 and stats.crypto_s > 0
    assert torch.equal(out, sim)


def test_os_level_corrupt_and_drop_match_simulated_threads(monkeypatch):
    """Crashes, worker-side corruption and tampered frames on the mesh:
    the same exclusions, retries, decode mask and decode as the plan
    simulated on threads.  Re-dispatch ranks candidates by their measured
    latency, which the two backends measure differently, so both runs
    record one constant (as the parity tests fix the compute time)."""
    from repro_torch.runtime.faults import WorkerHealth
    real = WorkerHealth.record_ok
    monkeypatch.setattr(WorkerHealth, "record_ok",
                        lambda self, w, _measured: real(self, w, 1e-3))
    fault = dict(crash_rate=0.12, corrupt_rate=0.25, drop_rate=0.12,
                 seed=5, worker_timeout_s=2.0)
    a, b = _mats()

    def spec(backend):
        s = _sigkill_spec(backend, **fault)
        return dataclasses.replace(
            s, code=CodeSpec(scheme="spacdc", n_workers=6, k_blocks=2,
                             extra={"fh_degree": 1}))
    outs = {}
    for backend in ("socket", "threads"):
        with Session(spec(backend), device="cpu") as s:
            outs[backend] = [s.matmul(a, b, round_idx=r) for r in range(2)]
            if backend == "socket":
                stats = dict(s.engine.pool.transport.stats)
    for (o_s, st_s), (o_t, st_t) in zip(outs["socket"], outs["threads"]):
        assert torch.equal(o_s, o_t)
        assert (st_s.excluded, st_s.retries, st_s.decode_mask,
                st_s.degraded) == (st_t.excluded, st_t.retries,
                                   st_t.decode_mask, st_t.degraded)
    assert stats["kills"] + stats["crc_failures"] >= 1


def test_liveness_write_offs_replayed_on_threads(monkeypatch):
    """A live worker frozen past the liveness deadline is written off by
    the defended mesh round (``handle.written_off``); threads fed the
    mesh's consumed arrival orders and, as crashes, its write-offs
    (``chip_smoke.ReplayStraggler``, ``replay_write_offs``) give the same
    retries, exclusions, decode mask and output."""
    from repro_torch.runtime.engine import RoundEngine
    from repro_torch.runtime.faults import WorkerHealth
    cs = _chip_smoke()
    real = WorkerHealth.record_ok
    monkeypatch.setattr(WorkerHealth, "record_ok",
                        lambda self, w, _measured: real(self, w, 1e-3))
    a, b = (torch.from_numpy(x) for x in _mats())

    def spec(backend):
        s = _sigkill_spec(backend, crash_rate=0.0, worker_timeout_s=2.0)
        return dataclasses.replace(s, transport=TransportSpec(
            backend=backend, heartbeat_s=0.1, liveness_timeout_s=1.0))
    orders, offs = {}, {}
    eng = RoundEngine(spec("socket"), device="cpu")
    try:
        mesh = eng.pool.transport
        mesh.start()
        cs.record_arrival_orders(mesh, orders, offs)
        pid = mesh.worker_pid(2)
        os.kill(pid, signal.SIGSTOP)
        try:
            out_s, st_s = eng.matmul(a, b, round_idx=0)
        finally:
            os.kill(pid, signal.SIGCONT)
    finally:
        eng.close()
    assert offs[0] == [2] and 2 not in orders[0]
    eng = RoundEngine(spec("threads"), device="cpu",
                      straggler=cs.ReplayStraggler(6, 0, orders))
    undo = cs.replay_write_offs(offs)
    try:
        out_t, st_t = eng.matmul(a, b, round_idx=0)
    finally:
        undo()
        eng.close()
    assert st_s.retries == st_t.retries >= 1
    assert (st_s.excluded, st_s.decode_mask, st_s.degraded) == \
        (st_t.excluded, st_t.decode_mask, st_t.degraded)
    assert torch.equal(out_s, out_t)


# --------------------------------------------------------------------------
# serving on the mesh
# --------------------------------------------------------------------------

def _serve_spec(backend, fused=None):
    return ClusterSpec(
        code=CodeSpec(scheme="mds", n_workers=4, k_blocks=2, fused=fused),
        wait=WaitSpec(policy="first_k", k=4),
        straggler=StragglerSpec(n_stragglers=0),
        transport=TransportSpec(backend=backend,
                                liveness_timeout_s=LIVENESS_S),
        serve=ServeSpec(coded_layers="unembed", max_slots=2))


def test_serve_over_the_mesh_gives_the_threads_tokens():
    from repro_torch.configs import tiny_config
    from repro_torch.runtime.serve_loop import poisson_workload
    reqs = poisson_workload(2, rate_rps=0.0, prompt_len=3, gen=3,
                            vocab=tiny_config("qwen2-7b").vocab_size,
                            seed=0, ragged=False)
    reps = {}
    for backend in ("socket", "threads"):
        with Session(_serve_spec(backend), device="cpu") as s:
            reps[backend] = s.serve(arch="qwen2-7b", tiny=True,
                                    requests=reqs, check_agreement=False)
    assert reps["socket"].mode == "round"
    np.testing.assert_array_equal(reps["socket"].tokens,
                                  reps["threads"].tokens)
    assert all(st.n_waited == 4 for st in reps["socket"].step_stats)


def test_launch_serve_over_the_mesh(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--tiny", "--device", "cpu", "--transport",
                        "socket", "--workers", "4", "--k-blocks", "2",
                        "--stragglers", "0", "--requests", "1",
                        "--prompt-len", "2", "--gen", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 1 requests" in out and "socket transport" in out
    assert "coded[unembed]" in out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("encrypt", [None, "real"])
def test_cuda_socket_round_matches_virtual_loop_round(cuda, encrypt):
    """A 3-worker mesh on the card (each worker a CUDA context, the kernel
    libraries loaded, never built, in the workers): the plain and the
    sealed round with the kernels equal the virtual loop round with the
    kernels, bit for bit, every worker has ``libcuda`` mapped and every
    responder reports its task's ``mask_add`` launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel

    def spec(backend):
        return ClusterSpec.from_dict({
            "code": {"scheme": "spacdc", "n_workers": 3, "k_blocks": 2,
                     "fused": False},
            "privacy": {"t_colluding": 1, "noise_scale": 0.1},
            "straggler": {"n_stragglers": 0},
            "transport": {"backend": backend, "liveness_timeout_s": 30.0},
            "crypto": {"encrypt": encrypt}, "seed": 3})
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn((96, 64), generator=gen, device=cuda)
    b = torch.randn((64, 32), generator=gen, device=cuda)
    with Session(spec("virtual"), device=cuda) as s:
        want, _ = s.matmul(a, b)
    cs = _chip_smoke()
    with Session(spec("socket"), device=cuda) as s:
        s.matmul(a, b)              # the first round adds one-time probes
        launches = (berrut_encode_kernel.launches, mask_add_kernel.launches)
        mesh = s.engine.pool.transport
        handles = cs.record_round_handles(mesh)
        got, st = s.matmul(a, b)
        maps = [Path(f"/proc/{mesh.worker_pid(w)}/maps").read_text()
                for w in range(3)]
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert _build.build_count == 1
    assert all("libcuda" in m for m in maps)
    # each responder's task ran the kernel in its worker: the sealed task
    # opened its shard and sealed its product (two mask_add launches)
    assert set(map(json.dumps, cs.responder_launches(handles[-1], st)
                   .values())) == {json.dumps(
                       {} if encrypt is None else {"mask_add": 2})}
    # the master's launches: encode + decode, and on the sealed round one
    # mask_add per shard sealed and per result opened
    assert berrut_encode_kernel.launches - launches[0] == 2
    want_mask = 0 if encrypt is None else 3 + st.n_waited
    assert mask_add_kernel.launches - launches[1] == want_mask
    assert st.dispatches == 2 + want_mask


# --------------------------------------------------------------------------
# the worker's stall probe
# --------------------------------------------------------------------------

def test_worker_stall_probe_dumps_every_thread_after_a_silence(
        tmp_path, monkeypatch):
    """With ``SPACDC_WORKER_STALL_DUMP=SECONDS:DIR`` a worker's connection
    re-arms ``faulthandler`` on every frame it sends: a silence longer
    than SECONDS writes every thread's stack, the silent one's frames
    included, to ``DIR/worker<id>-pid<pid>.txt``; unset, nothing is
    armed."""
    import faulthandler
    from repro_torch.launch import worker
    monkeypatch.delenv("SPACDC_WORKER_STALL_DUMP", raising=False)
    assert worker._stall_probe(3) is None
    monkeypatch.setenv("SPACDC_WORKER_STALL_DUMP", f"0.2:{tmp_path}")
    stall = worker._stall_probe(3)
    a, b = socket.socketpair()
    try:
        conn = worker._Connection(a, 3, 0.1, stall)
        conn.send(b"x")
        time.sleep(0.3)
        conn.send(b"y")               # a frame re-arms the probe
        time.sleep(0.7)               # a silence of 3.5 periods
    finally:
        faulthandler.cancel_dump_traceback_later()
        a.close()
        b.close()
        stall[1].close()
    text = (tmp_path / f"worker3-pid{os.getpid()}.txt").read_text()
    assert text.count("most recent call first") >= 2
    assert "test_worker_stall_probe_dumps_every_thread_after_a_silence" \
        in text
