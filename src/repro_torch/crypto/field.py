"""Limb-vectorized F_q arithmetic — the MEA-ECC hot path as tensor math.

Ports ``repro/crypto/field.py``.  Batches of F_q elements are fixed-width
little-endian **limb planes** — shape ``(..., L)`` of 32-bit words
(``L = 8`` for secp256k1).

* The host-side numpy parts are the reference's, copied as they are: the
  limb conversions, the numpy :func:`add_mod` / :func:`sub_mod`,
  :class:`LimbField`, :class:`FixedPointCodec`, :class:`BitsCodec`, the
  batched numpy SHA-256 (:func:`sha256_counter_blocks`,
  :func:`keystream_u64`) and :func:`seed_words`.
* The reference's traced (jnp) functions become tensor functions that run
  on their inputs' device: :func:`add_mod` / :func:`sub_mod` on tensors,
  :func:`keystream_words_traced_batched` (processed in chunks of lanes),
  :func:`stream_mask_traced`, :func:`fixed_encode_traced` and
  :func:`fixed_decode_traced`.  They keep the reference's names so each
  maps to its twin; nothing is traced in eager PyTorch.

Storage of a 32-bit word on the device is ``torch.uint32``.  PyTorch has
neither ``+`` nor ``<`` for ``torch.uint32``, so the tensor functions
reinterpret the words as ``int32`` (a free view), compute in ``int64`` and
mask with ``& 0xFFFFFFFF`` (:func:`to_i64`, :func:`to_u32`).  Every result
is bit-exact with the reference's uint32 arithmetic; the tests hold them
equal.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = [
    "LimbField", "FixedPointCodec", "BitsCodec",
    "int_to_limbs", "limbs_to_int", "add_mod", "sub_mod",
    "sha256_counter_blocks", "keystream_u64", "seed_words",
    "keystream_words_traced_batched", "keystream_words_traced",
    "stream_mask_traced", "fixed_encode_traced", "fixed_decode_traced",
    "to_i64", "to_u32", "as_u32_tensor", "LANE_CHUNK",
]

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# limb <-> int conversions (host-side; ints only at the API edge)
# ---------------------------------------------------------------------------

def n_limbs_for(q: int) -> int:
    """Limbs needed for F_q elements, rounded up to an even count so the
    ``(..., L)`` uint32 planes view as ``(..., L // 2)`` uint64."""
    n = max((q.bit_length() + 31) // 32, 2)
    return n + (n % 2)


def int_to_limbs(v: int, n_limbs: int) -> np.ndarray:
    """Non-negative python int -> (n_limbs,) uint32, little-endian."""
    if v < 0:
        raise ValueError("limb encoding takes non-negative values")
    out = np.empty(n_limbs, np.uint32)
    for j in range(n_limbs):
        out[j] = v & _MASK32
        v >>= 32
    if v:
        raise OverflowError(f"value needs more than {n_limbs} limbs")
    return out


def limbs_to_int(limbs) -> object:
    """(..., L) limbs -> python ints (object array; scalar for 1-D input).
    Test/debug path — the hot path never calls this."""
    arr = np.asarray(limbs, np.uint32)
    flat = arr.reshape(-1, arr.shape[-1])
    vals = np.empty(flat.shape[0], object)
    for i, row in enumerate(flat):
        v = 0
        for j in range(arr.shape[-1] - 1, -1, -1):
            v = (v << 32) | int(row[j])
        vals[i] = v
    if arr.ndim == 1:
        return vals[0]
    return vals.reshape(arr.shape[:-1])


def as_u64(limbs: np.ndarray) -> np.ndarray:
    """(..., L) uint32 plane -> (..., L // 2) uint64 view (little-endian)."""
    return np.ascontiguousarray(limbs).view(np.uint64)


# ---------------------------------------------------------------------------
# vectorized modular add/sub (uint32-only; xp = numpy or jax.numpy)
# ---------------------------------------------------------------------------

def _add_carry(a, b, xp):
    """Limb-wise a + b with carry chain.  Returns (sum_limbs, carry_out)."""
    n = a.shape[-1]
    one = xp.uint32(1)
    carry = xp.zeros(a.shape[:-1], np.uint32)
    rows = []
    for j in range(n):
        aj, bj = a[..., j], b[..., j]
        s = aj + bj                              # wraps mod 2^32
        c1 = (s < aj).astype(np.uint32)
        s2 = s + carry
        c2 = (s2 < carry).astype(np.uint32)      # only wraps when s == 2^32-1
        rows.append(s2)
        carry = (c1 | c2) * one
    return xp.stack(rows, axis=-1), carry


def _sub_borrow(a, b, xp):
    """Limb-wise a - b with borrow chain.  Returns (diff_limbs, borrow_out)."""
    n = a.shape[-1]
    one = xp.uint32(1)
    borrow = xp.zeros(a.shape[:-1], np.uint32)
    rows = []
    for j in range(n):
        aj, bj = a[..., j], b[..., j]
        d = aj - bj                              # wraps mod 2^32
        b1 = (aj < bj).astype(np.uint32)
        d2 = d - borrow
        b2 = (d < borrow).astype(np.uint32)      # only wraps when d == 0
        rows.append(d2)
        borrow = (b1 | b2) * one
    return xp.stack(rows, axis=-1), borrow


def _geq(a, q_limbs, xp):
    """Lexicographic a >= q over (..., L) limbs; q_limbs broadcastable."""
    n = a.shape[-1]
    gt = xp.zeros(a.shape[:-1], bool)
    eq = xp.ones(a.shape[:-1], bool)
    for j in range(n - 1, -1, -1):
        qj = q_limbs[..., j]
        gt = gt | (eq & (a[..., j] > qj))
        eq = eq & (a[..., j] == qj)
    return gt | eq


def add_mod(a, b, q_limbs, xp=np):
    """(a + b) mod q over (..., L) uint32 limb planes; a, b < q.  Tensors
    (either operand) take the tensor version on their device."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return _mod_t(a, b, q_limbs, subtract=False)
    s, carry = _add_carry(a, b, xp)
    # a + b < 2q: one conditional subtract of q (carry == the dropped 2^32L)
    ge = (carry.astype(bool)) | _geq(s, q_limbs, xp)
    red, _ = _sub_borrow(s, xp.broadcast_to(q_limbs, s.shape).astype(np.uint32), xp)
    return xp.where(ge[..., None], red, s)


def sub_mod(a, b, q_limbs, xp=np):
    """(a - b) mod q over (..., L) uint32 limb planes; a, b < q.  Tensors
    (either operand) take the tensor version on their device."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return _mod_t(a, b, q_limbs, subtract=True)
    d, borrow = _sub_borrow(a, b, xp)
    fix, _ = _add_carry(d, xp.broadcast_to(q_limbs, d.shape).astype(np.uint32), xp)
    return xp.where(borrow.astype(bool)[..., None], fix, d)


# ---------------------------------------------------------------------------
# the field handle
# ---------------------------------------------------------------------------

class LimbField:
    """F_q as fixed-width uint32 limb planes (see module docstring)."""

    def __init__(self, q: int):
        self.q = q
        self.n_limbs = n_limbs_for(q)
        self.q_limbs = int_to_limbs(q, self.n_limbs)

    def add(self, a, b):
        return add_mod(np.asarray(a, np.uint32), np.asarray(b, np.uint32),
                       self.q_limbs)

    def sub(self, a, b):
        return sub_mod(np.asarray(a, np.uint32), np.asarray(b, np.uint32),
                       self.q_limbs)

    def from_int(self, v: int, shape=()) -> np.ndarray:
        """Python int -> limbs broadcast to ``shape + (L,)``."""
        base = int_to_limbs(v % self.q, self.n_limbs)
        return np.broadcast_to(base, tuple(shape) + (self.n_limbs,)).copy()

    def from_u64(self, words: np.ndarray) -> np.ndarray:
        """(…,) uint64 words (< q after reduction) -> (…, L) limb planes."""
        words = np.asarray(words, np.uint64)
        if self.q.bit_length() <= 64:
            words = words % np.uint64(self.q)
        out = np.zeros(words.shape + (self.n_limbs,), np.uint32)
        out[..., 0] = (words & np.uint64(_MASK32)).astype(np.uint32)
        out[..., 1] = (words >> np.uint64(32)).astype(np.uint32)
        return out

    def to_ints(self, limbs) -> np.ndarray:
        return limbs_to_int(limbs)


# ---------------------------------------------------------------------------
# fixed-point codec (paper §IV-B embedding), float <-> limbs
# ---------------------------------------------------------------------------

class FixedPointCodec:
    """round(x · 2^frac_bits) mod q, two's-complement embedded in F_q.

    Bit-exact with the legacy big-int codec (``crypto.ref``) for float
    inputs, but fully vectorized: the scaled magnitude is decomposed as
    ``mant · 2^shift`` with ``mant < 2^53`` exactly (``np.frexp``), the
    mantissa split into 32-bit limbs and the power-of-two shift applied as
    limb/bit shifts.  Decode reconstructs the float by a Horner pass over
    the limbs and clamps to ±3e38 (wrong-key decrypts yield huge values).
    """

    CLAMP = 3e38

    def __init__(self, q: int, frac_bits: int = 16):
        # magnitudes scale to < 2^(136 + frac_bits) (see encode's clip); the
        # embedding needs headroom below q/2 for the sign
        if q.bit_length() < 138 + frac_bits:
            raise ValueError(
                f"FixedPointCodec needs a ≥{138 + frac_bits}-bit modulus for "
                f"float32 range; got {q.bit_length()} bits (use BitsCodec or "
                "a bigger curve)")
        self.field = LimbField(q)
        self.q = q
        self.frac_bits = frac_bits
        # v is negative iff v > q//2, i.e. v >= q//2 + 1
        self._neg_from = int_to_limbs(q // 2 + 1, self.field.n_limbs)

    # -- float -> limbs ----------------------------------------------------
    def encode(self, m: np.ndarray) -> np.ndarray:
        x = np.asarray(np.asarray(m), np.float64)
        # float64 inputs beyond f32 range would overflow the 3-limb scatter
        # below; 2^136 exceeds every float32 so in-range values (the parity
        # contract with the legacy codec) are untouched
        scaled = np.rint(np.clip(x, -2.0 ** 136, 2.0 ** 136) *
                         float(1 << self.frac_bits))
        neg = scaled < 0
        mag = np.abs(scaled)
        # exact decomposition mag = mant_i * 2^shift with mant_i < 2^53
        mant, exp = np.frexp(mag)
        small = exp <= 53
        mant_f = np.where(small, mag, mant * float(1 << 53))
        mant_i = mant_f.astype(np.uint64)
        shift = np.where(small, 0, exp - 53).astype(np.int64)
        L = self.field.n_limbs
        s_limb = (shift // 32).astype(np.int64)
        r = (shift % 32).astype(np.uint64)
        # mant_i << r spans up to 84 bits -> three 32-bit limbs l0,l1,l2
        lo64 = mant_i << r
        hi = (mant_i >> np.uint64(32)) >> (np.uint64(32) - r)   # == >> (64-r)
        l0 = (lo64 & np.uint64(_MASK32)).astype(np.uint32)
        l1 = (lo64 >> np.uint64(32)).astype(np.uint32)
        l2 = (hi & np.uint64(_MASK32)).astype(np.uint32)
        out = np.zeros(x.shape + (L,), np.uint32)
        for j in range(L):
            out[..., j] = np.where(
                s_limb == j, l0,
                np.where(s_limb == j - 1, l1,
                         np.where(s_limb == j - 2, l2, np.uint32(0))))
        # negative values embed as q - |v| (v < q guaranteed by the
        # modulus-size check above); zero stays zero
        nonzero = mag > 0
        neg_embed = sub_mod(np.broadcast_to(self.field.q_limbs, out.shape),
                            out, self.field.q_limbs)
        return np.where((neg & nonzero)[..., None], neg_embed, out)

    # -- limbs -> float ----------------------------------------------------
    def decode(self, limbs: np.ndarray) -> np.ndarray:
        limbs = np.asarray(limbs, np.uint32)
        neg = _geq(limbs, self._neg_from, np)            # v > q//2
        mag = np.where(
            neg[..., None],
            sub_mod(np.broadcast_to(self.field.q_limbs, limbs.shape),
                    limbs, self.field.q_limbs),
            limbs)
        val = np.zeros(limbs.shape[:-1], np.float64)
        for j in range(limbs.shape[-1] - 1, -1, -1):     # Horner, high→low
            val = val * float(1 << 32) + mag[..., j]
        val = np.where(neg, -val, val) / float(1 << self.frac_bits)
        return np.clip(val, -self.CLAMP, self.CLAMP).astype(np.float32)


# ---------------------------------------------------------------------------
# lossless transport codec: raw bytes <-> one uint32 word per element
# ---------------------------------------------------------------------------

class BitsCodec:
    """Embed the raw little-endian bytes of any array as uint32 field
    elements — ``decode(encode(x)) is bit-identical`` for every dtype.

    This is the transport embedding the runtime's ``encrypt="real"`` mode
    and the encrypted checkpointer use: transmission security does not need
    the fixed-point quantization, only that the wire bits round-trip.
    """

    def __init__(self, q: int):
        if q.bit_length() <= 32:
            raise ValueError("BitsCodec needs q > 2^32 (one uint32/elem)")
        self.field = LimbField(q)
        self.q = q

    def encode_words(self, m):
        """array -> (n_words,) uint32 raw words (4 little-endian bytes each).
        A tensor gives a ``torch.uint32`` tensor on its own device."""
        if torch.is_tensor(m):
            raw = m.detach().contiguous().reshape(-1).view(torch.uint8)
            pad = (-raw.numel()) % 4
            if pad:
                raw = torch.cat([raw, raw.new_zeros(pad)])
            return raw.view(torch.int32).view(torch.uint32)
        raw = np.ascontiguousarray(m).tobytes()
        pad = (-len(raw)) % 4
        return np.frombuffer(raw + b"\x00" * pad, np.uint32)

    def decode_words(self, words, dtype, shape):
        """Inverse of :meth:`encode_words`; ``dtype`` is a name such as
        ``"float32"``.  Tensor words give a tensor on their device."""
        if torch.is_tensor(words):
            tdtype = getattr(torch, str(dtype).replace("torch.", ""))
            w = words.view(torch.int32).contiguous()
            if w.numel() == 1:
                # a one-element view (a 0-d leaf's word, sliced out of its
                # limb row) keeps its stride through contiguous()
                w = w.clone(memory_format=torch.contiguous_format)
            raw = w.view(torch.uint8)
            nbytes = int(np.prod(shape, initial=1)) * tdtype.itemsize
            return raw[:nbytes].view(tdtype).reshape(tuple(shape)).clone()
        try:
            dtype = np.dtype(dtype)
        except TypeError:       # extension dtypes by name ("bfloat16", ...)
            import ml_dtypes
            dtype = np.dtype(getattr(ml_dtypes, str(dtype)))
        nbytes = int(np.prod(shape, initial=1)) * dtype.itemsize
        raw = np.ascontiguousarray(np.asarray(words, np.uint32)).tobytes()
        return np.frombuffer(raw[:nbytes], dtype).reshape(shape).copy()

    def encode(self, m):
        """array -> (n_words, L) limb planes (word in limb 0)."""
        words = self.encode_words(m)
        if torch.is_tensor(words):
            return embed_limbs(words, self.field.n_limbs)
        out = np.zeros((words.size, self.field.n_limbs), np.uint32)
        out[:, 0] = words
        return out

    def decode(self, limbs, dtype, shape):
        return self.decode_words(limbs[..., 0], dtype, shape)


# ---------------------------------------------------------------------------
# batched SHA-256 counter PRF (stream-mode keystream)
# ---------------------------------------------------------------------------

_SHA_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], np.uint32)

_SHA_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], np.uint32)


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _sha256_single_block(w16, xp):
    """The SHA-256 compression of one 64-byte block, vectorized over a batch.

    ``w16``: list of 16 uint32 arrays (broadcast-compatible) — the message
    schedule base.  Returns list of 8 uint32 digest-word arrays.  xp-generic
    (numpy or jax.numpy): uint32 adds wrap, shifts/xors are elementwise.
    """
    w = list(w16)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> np.uint32(3))
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> np.uint32(10))
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, bb, c, d, e, f, g, h = (xp.asarray(v, np.uint32) for v in _SHA_H0)
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + np.uint32(_SHA_K[t]) + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & bb) ^ (a & c) ^ (bb & c)
        t2 = S0 + maj
        h, g, f, e, d, c, bb, a = g, f, e, d + t1, c, bb, a, t1 + t2
    return [x + np.uint32(h0) for x, h0 in zip([a, bb, c, d, e, f, g, h],
                                               _SHA_H0)]


def _counter_schedule(seed_words, counters_lo, counters_hi, xp):
    """Message-schedule base for SHA-256(seed32 ‖ counter_be64): 40 message
    bytes + mandatory padding in one 64-byte block."""
    w16 = [xp.asarray(seed_words[i], np.uint32) for i in range(8)]
    w16 += [counters_hi, counters_lo]
    zero = xp.zeros_like(counters_lo)
    w16 += [zero + np.uint32(0x80000000)]           # pad bit after 40 bytes
    w16 += [zero, zero, zero, zero]
    w16 += [zero + np.uint32(40 * 8)]               # message bit length
    return w16


def sha256_counter_blocks(seed32: bytes, counters: np.ndarray) -> np.ndarray:
    """SHA-256(seed32 ‖ counter_be64) for a whole batch of counters at once.

    One 64-byte block per message, compression vectorized over the counter
    axis with uint32 numpy ops.  Returns ``(len(counters), 8)`` uint32
    digest words — bit-exact with
    ``hashlib.sha256(seed + c.to_bytes(8, "big")).digest()``.
    """
    assert len(seed32) == 32
    counters = np.asarray(counters, np.uint64)
    seed_words = np.frombuffer(seed32, ">u4").astype(np.uint32)
    w16 = _counter_schedule(seed_words,
                            (counters & np.uint64(_MASK32)).astype(np.uint32),
                            (counters >> np.uint64(32)).astype(np.uint32), np)
    with np.errstate(over="ignore"):        # uint32 wraparound is the point
        return np.stack(_sha256_single_block(w16, np), axis=1)


def seed_words(secret_x, secret_y, nonce: int) -> np.ndarray:
    """The stream-mode PRF seed — SHA-256 of the ECDH point and nonce — as
    big-endian uint32 words ((8,), host-side)."""
    seed = hashlib.sha256(f"{secret_x}:{secret_y}:{nonce}".encode()).digest()
    return np.frombuffer(seed, ">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# tensor versions of the reference's traced (jnp) functions
# ---------------------------------------------------------------------------
# uint32 words live in torch.uint32 (or int32) tensors; the arithmetic runs
# in int64 on the tensors' device and every result is masked back to 32
# bits, so each function is bit-exact with its uint32 twin in the reference.

def to_i64(t: torch.Tensor) -> torch.Tensor:
    """32-bit words (``torch.uint32`` or ``int32``) -> their unsigned values
    as ``int64``."""
    if t.dtype == torch.int64:
        return t & _MASK32
    return t.view(torch.int32).to(torch.int64) & _MASK32


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """``int64`` values in [0, 2^32) -> ``torch.uint32`` words (the int32
    cast keeps the low 32 bits; the view reinterprets them)."""
    return t.to(torch.int32).view(torch.uint32)


def as_u32_tensor(x, device=None) -> torch.Tensor:
    """numpy uint32 arrays, python ints or tensors -> ``torch.uint32`` on
    ``device`` (default: the tensor's own device, else the CPU)."""
    if torch.is_tensor(x):
        if x.dtype in (torch.uint32, torch.int32):
            t = x.view(torch.uint32)
        else:
            t = to_u32(x.to(torch.int64) & _MASK32)
        return t if device is None else \
            t.view(torch.int32).to(device).view(torch.uint32)
    arr = np.ascontiguousarray(np.asarray(x, np.uint64).astype(np.uint32))
    t = torch.from_numpy(arr.view(np.int32))
    return (t if device is None else t.to(device)).view(torch.uint32)


def embed_limbs(words: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(...,) 32-bit words -> (..., n_limbs) ``torch.uint32`` limb planes,
    the word in limb 0 and zeros above."""
    out = torch.zeros(tuple(words.shape) + (n_limbs,), dtype=torch.int32,
                      device=words.device)
    out[..., 0] = words.view(torch.int32)
    return out.view(torch.uint32)


def _q_i64(q_limbs, n: int, device) -> list:
    """The modulus limbs as python ints (q is a static constant)."""
    if torch.is_tensor(q_limbs):
        q_limbs = to_i64(q_limbs.reshape(-1)).tolist()
    q = [int(v) for v in np.asarray(q_limbs, np.uint64).reshape(-1)]
    assert len(q) == n, (len(q), n)
    return q


def _mod_t(a, b, q_limbs, subtract: bool) -> torch.Tensor:
    """(a ± b) mod q over (..., L) limb tensors, b broadcast against a: the
    carry (borrow) chain over the limbs, then one conditional subtract of q
    (add-back of q), exactly as the reference's uint32 chains."""
    a = as_u32_tensor(a)
    b = as_u32_tensor(b, a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = shape[-1]
    q = _q_i64(q_limbs, n, a.device)
    a = a.expand(shape)
    b = b.expand(shape)
    rows = []
    chain = 0
    for j in range(n):
        aj, bj = to_i64(a[..., j]), to_i64(b[..., j])
        s = aj - bj - chain if subtract else aj + bj + chain
        chain = (s >> 63) & 1 if subtract else s >> 32
        rows.append(s & _MASK32)
    if subtract:
        fix = chain == 1                       # borrowed: add q back
    else:
        gt = torch.zeros_like(rows[0], dtype=torch.bool)
        eq = torch.ones_like(gt)
        for j in range(n - 1, -1, -1):
            gt = gt | (eq & (rows[j] > q[j]))
            eq = eq & (rows[j] == q[j])
        fix = (chain == 1) | gt | eq           # sum >= q: subtract q once
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    chain = 0
    for j in range(n):
        s = rows[j] + q[j] + chain if subtract else rows[j] - q[j] - chain
        chain = s >> 32 if subtract else (s >> 63) & 1
        out[..., j] = torch.where(fix, s & _MASK32, rows[j]).to(torch.int32)
    return out.view(torch.uint32)


def _geq_t(limbs64: torch.Tensor, ref_limbs) -> torch.Tensor:
    """Lexicographic limbs >= ref over (..., L) int64 values."""
    n = limbs64.shape[-1]
    gt = torch.zeros(limbs64.shape[:-1], dtype=torch.bool,
                     device=limbs64.device)
    eq = torch.ones_like(gt)
    for j in range(n - 1, -1, -1):
        rj = int(ref_limbs[j])
        gt = gt | (eq & (limbs64[..., j] > rj))
        eq = eq & (limbs64[..., j] == rj)
    return gt | eq


def _sigma(x, r1: int, r2: int, r3: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) of int64 values < 2^32 (or
    python ints): the word doubled into 64 bits once, so each rotate is one
    shift.  Fewer elementwise ops is what counts: each is a launch."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & _MASK32


def _sigma_small(x, r1: int, r2: int, sh: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> sh): the schedule's σ0 / σ1."""
    xx = x | (x << 32)
    return (((xx >> r1) ^ (xx >> r2)) & _MASK32) ^ (x >> sh)


def _sha256_lanes(w16):
    """SHA-256 compression of one 64-byte block per lane.

    ``w16``: the 16 message-schedule words, each an int64 lane tensor or a
    python int (a word every lane shares, folded on the host).  Returns the
    8 digest words as int64 lane tensors.  The schedule is kept in a
    16-slot window, as the reference's scanned round step keeps it.  Values
    stay below 2^35 between the masks, so int64 never overflows.
    """
    w = list(w16)
    a, bb, c, d, e, f, g, h = (int(v) for v in _SHA_H0)
    for t in range(64):
        if t >= 16:
            w = w[1:] + [(w[0] + _sigma_small(w[1], 7, 18, 3) + w[9] +
                          _sigma_small(w[14], 17, 19, 10)) & _MASK32]
            wt = w[15]
        else:
            wt = w[t]
        ch = g ^ (e & (f ^ g))
        t1 = h + _sigma(e, 6, 11, 25) + ch + int(_SHA_K[t]) + wt
        maj = (a & bb) | (c & (a | bb))
        h, g, f, e, d, c, bb, a = (g, f, e, (d + t1) & _MASK32, c, bb, a,
                                   (t1 + _sigma(a, 2, 13, 22) + maj) & _MASK32)
    return [(x + int(h0)) & _MASK32
            for x, h0 in zip([a, bb, c, d, e, f, g, h], _SHA_H0)]


# Lanes (counter blocks) hashed per pass.  Each pass runs ~3,000
# elementwise tensor ops (one launch each on the card) over its lanes with
# ~24 int64 arrays alive: 2^21 lanes keep that near 400 MB.  Fewer, larger
# passes launch less; smaller ones keep each op's arrays in L2.
LANE_CHUNK = 1 << 21


def keystream_words_traced_batched(seeds, n_words: int,
                                   lane_chunk: int = LANE_CHUNK):
    """(C, 8) uint32 seed-word channels -> ((C, n_words), (C, n_words))
    ``torch.uint32`` mask word halves (lo, hi); channel i's u64 stream-mask
    word j is ``hi[i, j] << 32 | lo[i, j]``.

    The batched SHA-256 counter PRF on the seeds' device (per-channel
    counters 0, 1, ...; < 2^32 blocks), bit-exact with
    :func:`keystream_u64` per channel.  All (channel, block) lanes are
    flattened into one lane axis and hashed ``lane_chunk`` at a time, as the
    reference's ``_LANE_CHUNK`` scan does: the memory of a pass stays fixed
    whatever the payload.
    """
    seeds = to_i64(as_u32_tensor(seeds))
    n_ch = seeds.shape[0]
    dev = seeds.device
    n_blocks = max(-(-n_words // 4), 1)
    lanes = n_ch * n_blocks
    digest = torch.empty((lanes, 8), dtype=torch.int32, device=dev)
    for start in range(0, lanes, lane_chunk):
        idx = torch.arange(start, min(start + lane_chunk, lanes),
                           dtype=torch.int64, device=dev)
        ch = idx // n_blocks
        ctr = idx - ch * n_blocks
        # SHA-256(seed32 || counter_be64): 40 message bytes + padding
        w16 = [seeds[ch, i] for i in range(8)]
        w16 += [0, ctr, 0x80000000, 0, 0, 0, 0, 40 * 8]
        digest[start:start + idx.numel()] = torch.stack(
            _sha256_lanes(w16), dim=1).to(torch.int32)
    digest = digest.view(n_ch, n_blocks, 8)
    # digest words pair big-endian into u64 mask words w = d0<<32 | d1
    word_lo = digest[..., 1::2].reshape(n_ch, -1)[:, :n_words]
    word_hi = digest[..., 0::2].reshape(n_ch, -1)[:, :n_words]
    return (word_lo.contiguous().view(torch.uint32),
            word_hi.contiguous().view(torch.uint32))


def keystream_words_traced(seed8, n_words: int):
    """(8,) uint32 seed words -> ((n_words,), (n_words,)) ``torch.uint32``
    mask word halves (lo, hi): the single-channel face of
    :func:`keystream_words_traced_batched`."""
    lo, hi = keystream_words_traced_batched(
        as_u32_tensor(seed8).reshape(1, 8), n_words)
    return lo[0], hi[0]


def stream_mask_traced(seed8, n_words: int, n_limbs: int):
    """(8,) uint32 seed words -> (n_words, n_limbs) ``torch.uint32``
    stream-mask limb planes: little-endian limbs (lo, hi) of the u64 mask
    words, high limbs zero.  No modular reduction: the 64-bit mask words
    are < q for any modulus wider than 64 bits (the caller takes the numpy
    path otherwise)."""
    lo, hi = keystream_words_traced(seed8, n_words)
    out = torch.zeros((n_words, n_limbs), dtype=torch.int32, device=lo.device)
    out[:, 0] = lo.view(torch.int32)
    out[:, 1] = hi.view(torch.int32)
    return out.view(torch.uint32)


def fixed_encode_traced(x, q: int, frac_bits: int, n_limbs: int):
    """Fixed-point embed: (n,) float -> (n, n_limbs) ``torch.uint32`` limbs.

    Bit-exact with :meth:`FixedPointCodec.encode` for f32/f16/bf16 inputs:
    the float is torn into sign / exponent / 24-bit mantissa, and the
    scale by 2^frac_bits, the round-half-even and the limb scatter are bit
    arithmetic, as in the reference.
    """
    f32max = 3.4028234663852886e38
    x = torch.as_tensor(x).to(torch.float32).reshape(-1).clamp(-f32max,
                                                                  f32max)
    bits = to_i64(x.contiguous().view(torch.int32))
    sign = (bits >> 31) == 1
    e = (bits >> 23) & 0xFF
    mant = (bits & 0x7FFFFF) | torch.where(e > 0, 1 << 23, 0)
    # v = round(|x| * 2^fb) = round-half-even(mant * 2^(e - 150 + fb))
    ep = e - (150 - frac_bits)
    # right-shift branch (ep < 0): t <= 26 covers everything (v == 0 beyond)
    t = torch.clamp(-ep, 0, 26)
    keep = mant >> t
    frac = mant & ((1 << t) - 1)
    half = torch.where(t > 0, 1 << torch.clamp(t - 1, min=0), 0)
    round_up = (frac > half) | ((frac == half) & ((keep & 1) == 1))
    v_small = keep + round_up.to(torch.int64)
    # left-shift branch (ep >= 0): mant << ep spans limbs s, s+1
    epp = torch.clamp(ep, min=0)
    r = epp % 32
    s = epp // 32
    lo = (mant << r) & _MASK32
    hi = torch.where(r > 0, mant >> (32 - r), 0)
    left = ep >= 0
    l0 = torch.where(left, lo, v_small)
    out = torch.stack(
        [torch.where(s == j, l0, torch.where(left & (s == j - 1), hi, 0))
         for j in range(n_limbs)], dim=-1)
    # negative values embed as q - v
    q_limbs = int_to_limbs(q, n_limbs)
    q_t = as_u32_tensor(q_limbs, out.device)
    neg_embed = to_i64(_mod_t(q_t.expand(out.shape), to_u32(out), q_limbs,
                              subtract=True))
    nonzero = (out != 0).any(dim=-1)
    return to_u32(torch.where((sign & nonzero)[:, None], neg_embed, out))


def fixed_decode_traced(limbs, q: int, frac_bits: int):
    """Fixed-point decode: (n, L) uint32 limbs -> (n,) float32.

    Matches :meth:`FixedPointCodec.decode` wherever the value has <= 24
    significant bits (everything the encode can emit) and on the ±3e38
    clamp (wrong-key garbage), as the reference's traced decode does.
    """
    limbs = as_u32_tensor(limbs)
    n_limbs = limbs.shape[-1]
    q_limbs = int_to_limbs(q, n_limbs)
    l64 = to_i64(limbs)
    neg = _geq_t(l64, int_to_limbs(q // 2 + 1, n_limbs))
    q_t = as_u32_tensor(q_limbs, limbs.device)
    mag = torch.where(neg[..., None],
                      to_i64(_mod_t(q_t.expand(limbs.shape), limbs, q_limbs,
                                    subtract=True)), l64)
    # Horner over limbs 1.. (value / 2^32), then limb 0 and the scale in
    # one last step: value / 2^frac_bits stays in float32 range whenever
    # the plaintext was (garbage overflows to inf and lands on the clamp)
    val_hi = torch.zeros(limbs.shape[:-1], dtype=torch.float32,
                         device=limbs.device)
    for j in range(n_limbs - 1, 0, -1):
        val_hi = val_hi * float(1 << 32) + mag[..., j].to(torch.float32)
    val = (val_hi * 2.0 ** (32 - frac_bits) +
           mag[..., 0].to(torch.float32) * 2.0 ** -frac_bits)
    val = torch.where(neg, -val, val)
    return torch.clamp(val, -FixedPointCodec.CLAMP, FixedPointCodec.CLAMP)


def keystream_u64(secret_x, secret_y, nonce: int, n_words: int, q: int) -> np.ndarray:
    """Vectorized stream-mode mask words: ``(n_words,)`` uint64, reduced
    mod q when q fits 64 bits (a no-op for 256-bit curves).  Bit-exact with
    the scalar ``crypto.ecc.keystream`` reference."""
    seed = hashlib.sha256(f"{secret_x}:{secret_y}:{nonce}".encode()).digest()
    n_blocks = -(-n_words // 4)
    if n_blocks == 0:
        return np.zeros(0, np.uint64)
    digests = sha256_counter_blocks(seed, np.arange(n_blocks, dtype=np.uint64))
    words = ((digests[:, 0::2].astype(np.uint64) << np.uint64(32)) |
             digests[:, 1::2].astype(np.uint64)).reshape(-1)[:n_words]
    if q.bit_length() <= 64:
        words = words % np.uint64(q)
    return words
