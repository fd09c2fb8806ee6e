"""The socket transport's wire format: framed messages and a tagged value
codec that carries coded shards and MEA-ECC ciphertexts as their raw
bytes.

Ports ``repro/runtime/wire.py`` (its own copy: the port imports nothing of
the reference, though the reference's module needs only numpy).

* **Frames**: every message on a mesh connection is one frame, a fixed
  23-byte header (``>4sBHqII``: magic ``SPC1``, frame type, worker id,
  submission id, payload length, CRC-32 of the payload) and the payload.
  A tampered or truncated payload fails its CRC at :func:`read_frame` and
  surfaces as a dropped result, never as wrong floats.
* **Values**: :func:`dump_value` / :func:`load_value` serialize what coded
  rounds move.  An array travels under the ``A`` tag as its dtype string,
  shape and raw C-contiguous bytes; an MEA-ECC ``Ciphertext`` under ``C``
  as its header and its ``(n, L)`` uint32 limb plane verbatim (the limbs
  are the lossless wire encoding, so a sealed round re-encodes nothing);
  ints (256-bit EC coordinates too), floats, strings, bytes, tuples,
  lists and dicts have compact tags; anything else (the round's task
  object) is pickled under ``P``.

Tensors.  A torch tensor is written from a host copy under the ``A`` tag
with numpy's dtype string, so a float32 tensor's frame is byte for byte
the reference's frame for the same ndarray, and so are int64 and uint32
tensors.  A ``torch.uint32`` tensor (the ciphertext limbs too) goes through
an ``int32`` view on both sides: PyTorch has no arithmetic on uint32, and
its numpy bridge for it is not relied on.  numpy arrays are accepted as in
the reference.  Only ``P`` payloads differ from the reference's, since the
pickles name the port's classes.

What :func:`load_value` returns: an ``A`` value is a **host (CPU) torch
tensor** of the array's dtype (uint32 as ``torch.uint32``), a ``C`` value
the port's ``crypto.mea_ecc.Ciphertext`` with a host ``torch.uint32``
payload.  The receiving side binds values to its own device with
:func:`to_device` (a worker to its ``--device``, the master to the
engine's), so the codec itself never chooses a device.
"""

from __future__ import annotations

import dataclasses
import pickle
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "FrameError", "Frame", "HELLO", "TASK", "RESULT", "ERROR", "PING",
    "SHUTDOWN", "HEADER_SIZE", "pack_frame", "read_frame", "tamper_frame",
    "dump_value", "load_value", "dumps", "loads", "to_device",
    "ciphertext_wire_overhead",
]

MAGIC = b"SPC1"
_HEADER = struct.Struct(">4sBHqII")      # magic, type, worker, sub, len, crc
HEADER_SIZE = _HEADER.size

# frame types
HELLO = 1        # worker -> master: registration (empty payload)
TASK = 2         # master -> worker: one round's work for this worker
RESULT = 3       # worker -> master: the task's output
ERROR = 4        # worker -> master: the task (or the worker's start) failed
PING = 5         # worker -> master: heartbeat (empty payload)
SHUTDOWN = 6     # master -> worker: exit cleanly (empty payload)


class FrameError(RuntimeError):
    """The stream is unreadable as frames (bad magic, truncated value,
    unknown tag).  A CRC mismatch is not raised: it is reported on the
    frame."""


class Frame:
    """One decoded frame.  ``crc_ok=False`` means the payload did not match
    its checksum: the payload is kept (for its length) but must not be
    deserialized."""

    __slots__ = ("type", "worker", "sub", "payload", "crc_ok")

    def __init__(self, type: int, worker: int, sub: int, payload,
                 crc_ok: bool = True):
        self.type = type
        self.worker = worker
        self.sub = sub
        self.payload = payload
        self.crc_ok = crc_ok


def pack_frame(ftype: int, worker: int, sub: int,
               payload: bytes = b"") -> bytes:
    """One wire frame: header + payload, CRC-32 over the payload."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, ftype, worker & 0xFFFF, sub,
                        len(payload), crc) + payload


def tamper_frame(frame: bytes, rng: np.random.Generator) -> bytes:
    """Flip payload bytes of a frame AFTER its CRC was computed: the wire
    tampering of the fault injector's ``drop`` mode on a real mesh.  The
    header is left alone, so the frame still routes and fails its CRC at
    the receiver."""
    out = bytearray(frame)
    if len(out) <= HEADER_SIZE:
        return bytes(out)
    body = len(out) - HEADER_SIZE
    k = max(1, body // 64)
    idx = HEADER_SIZE + rng.integers(0, body, size=k)
    for i in idx:
        out[int(i)] ^= 0xFF
    return bytes(out)


def _read_exact(sock, n: int) -> bytearray:
    """Exactly ``n`` bytes off a blocking socket, received into one buffer
    (``recv_into``: a shard of hundreds of MB is not re-allocated per
    chunk)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise EOFError("connection closed mid-frame"
                           if got else "connection closed")
        got += k
    return buf


def read_frame(sock) -> Frame:
    """Read exactly one frame off a blocking socket.  Raises ``EOFError``
    on a closed connection and :class:`FrameError` on an unframeable
    stream; a payload whose CRC mismatches comes back with
    ``crc_ok=False``."""
    head = bytes(_read_exact(sock, HEADER_SIZE))
    magic, ftype, worker, sub, length, crc = _HEADER.unpack(head)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    payload = _read_exact(sock, length) if length else b""
    ok = (zlib.crc32(payload) & 0xFFFFFFFF) == crc
    return Frame(ftype, worker, sub, payload, crc_ok=ok)


# --------------------------------------------------------------------------
# value codec
# --------------------------------------------------------------------------

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")


def _put_bytes(out: list, b) -> None:
    out.append(_U32.pack(len(b)))
    out.append(b)


def _put_str(out: list, s: str) -> None:
    _put_bytes(out, s.encode("utf-8"))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a C-contiguous host ndarray (uint32 through an
    int32 view)."""
    t = t.detach()
    if t.dtype == torch.uint32:
        return np.ascontiguousarray(
            t.view(torch.int32).cpu().numpy()).view(np.uint32)
    return np.ascontiguousarray(t.cpu().numpy())


def _put_array(out: list, arr: np.ndarray) -> None:
    """An array's ndim, shape and raw bytes."""
    out.append(bytes([arr.ndim]))
    for d in arr.shape:
        out.append(_U32.pack(d))
    # the array's bytes as they lie (b"".join copies them once)
    _put_bytes(out, memoryview(arr.reshape(-1).view(np.uint8)))


def dump_value(value, out: list) -> None:
    """Append ``value``'s wire encoding to ``out`` (a list of bytes-like
    parts)."""
    if value is None:
        out.append(b"N")
    elif value is True or value is False:
        out.append(b"b" + (b"\x01" if value else b"\x00"))
    elif isinstance(value, int):
        if -(2 ** 63) <= value < 2 ** 63:
            out.append(b"I")
            out.append(_I64.pack(value))
        else:
            # EC coordinates are ~256-bit: sign byte + magnitude bytes
            out.append(b"J")
            mag = abs(value)
            raw = mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big")
            out.append(b"\x01" if value < 0 else b"\x00")
            _put_bytes(out, raw)
    elif isinstance(value, float):
        out.append(b"F")
        out.append(_F64.pack(value))
    elif isinstance(value, str):
        out.append(b"S")
        _put_str(out, value)
    elif isinstance(value, bytes):
        out.append(b"B")
        _put_bytes(out, value)
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        arr = (_host_array(value) if torch.is_tensor(value)
               else np.ascontiguousarray(value))
        out.append(b"A")
        _put_str(out, arr.dtype.str)
        _put_array(out, arr)
    elif hasattr(value, "payload") and hasattr(value, "ephemeral"):
        # MEA-ECC Ciphertext: a small header + the uint32 limb plane
        out.append(b"C")
        dump_value(value.ephemeral.x, out)
        dump_value(value.ephemeral.y, out)
        dump_value(tuple(int(d) for d in value.shape), out)
        _put_str(out, value.mode)
        _put_str(out, value.codec)
        _put_str(out, value.dtype)
        dump_value(value.nonce, out)
        payload = value.payload
        limbs = (_host_array(payload) if torch.is_tensor(payload)
                 else np.ascontiguousarray(payload, dtype=np.uint32))
        _put_array(out, limbs)
    elif isinstance(value, tuple):
        out.append(b"T")
        out.append(_U32.pack(len(value)))
        for v in value:
            dump_value(v, out)
    elif isinstance(value, list):
        out.append(b"L")
        out.append(_U32.pack(len(value)))
        for v in value:
            dump_value(v, out)
    elif isinstance(value, dict):
        out.append(b"D")
        out.append(_U32.pack(len(value)))
        for k, v in value.items():
            _put_str(out, str(k))
            dump_value(v, out)
    else:
        # opaque objects (the round's task) fall back to pickle
        out.append(b"P")
        _put_bytes(out, pickle.dumps(value))


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise FrameError("truncated wire value")
        self.pos += n
        return b

    def take_bytes(self) -> memoryview:
        (n,) = _U32.unpack(self.take(4))
        return self.take(n)

    def take_str(self) -> str:
        return bytes(self.take_bytes()).decode("utf-8")

    def take_array(self, dtype: np.dtype) -> np.ndarray:
        ndim = self.take(1)[0]
        shape = tuple(_U32.unpack(self.take(4))[0] for _ in range(ndim))
        raw = self.take_bytes()
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host ndarray as a CPU tensor of its dtype (uint32 through an
    int32 view)."""
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(arr)


def _load(r: _Reader):
    tag = bytes(r.take(1))
    if tag == b"N":
        return None
    if tag == b"b":
        return bytes(r.take(1)) == b"\x01"
    if tag == b"I":
        return _I64.unpack(r.take(8))[0]
    if tag == b"J":
        neg = bytes(r.take(1)) == b"\x01"
        mag = int.from_bytes(r.take_bytes(), "big")
        return -mag if neg else mag
    if tag == b"F":
        return _F64.unpack(r.take(8))[0]
    if tag == b"S":
        return r.take_str()
    if tag == b"B":
        return bytes(r.take_bytes())
    if tag == b"A":
        dtype = np.dtype(r.take_str())
        return _host_tensor(r.take_array(dtype))
    if tag == b"C":
        from ..crypto.ecc import ECPoint
        from ..crypto.mea_ecc import Ciphertext
        x = _load(r)
        y = _load(r)
        shape = _load(r)
        mode = r.take_str()
        codec = r.take_str()
        dtype = r.take_str()
        nonce = _load(r)
        limbs = _host_tensor(r.take_array(np.dtype(np.uint32)))
        return Ciphertext(ephemeral=ECPoint(x, y), payload=limbs,
                          shape=tuple(shape), mode=mode, codec=codec,
                          dtype=dtype, nonce=nonce)
    if tag == b"T":
        (n,) = _U32.unpack(r.take(4))
        return tuple(_load(r) for _ in range(n))
    if tag == b"L":
        (n,) = _U32.unpack(r.take(4))
        return [_load(r) for _ in range(n)]
    if tag == b"D":
        (n,) = _U32.unpack(r.take(4))
        return {r.take_str(): _load(r) for _ in range(n)}
    if tag == b"P":
        return pickle.loads(r.take_bytes())
    raise FrameError(f"unknown wire tag {tag!r}")


def load_value(buf):
    """One value off wire bytes (see the module docstring for what arrays
    and ciphertexts come back as)."""
    return _load(_Reader(buf))


def dumps(value) -> bytes:
    """Serialize one value to wire bytes."""
    out: list = []
    dump_value(value, out)
    return b"".join(out)


def loads(buf):
    """Inverse of :func:`dumps`."""
    return load_value(buf)


def to_device(value, device: torch.device):
    """``value`` with every tensor (and every ciphertext's limb plane) on
    ``device``: tuples, lists and dicts are walked; anything else is
    returned as it is."""
    if torch.is_tensor(value):
        return value.to(device)
    if hasattr(value, "payload") and hasattr(value, "ephemeral"):
        return dataclasses.replace(value, payload=value.payload.to(device))
    if isinstance(value, tuple):
        return tuple(to_device(v, device) for v in value)
    if isinstance(value, list):
        return [to_device(v, device) for v in value]
    if isinstance(value, dict):
        return {k: to_device(v, device) for k, v in value.items()}
    return value


def ciphertext_wire_overhead(ct) -> Tuple[int, int]:
    """(encoded_bytes, limb_bytes) for one ciphertext: the wire encoding
    is the limb plane plus a small constant header, never a re-encode."""
    encoded = len(dumps(ct))
    payload = ct.payload
    limb_bytes = (payload.numel() * payload.element_size()
                  if torch.is_tensor(payload) else np.asarray(payload).nbytes)
    return encoded, int(limb_bytes)
