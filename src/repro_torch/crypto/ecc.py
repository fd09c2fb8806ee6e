"""Elliptic-curve primitives over a prime field (paper §IV-A, Defs 2).

Ports ``repro/crypto/ecc.py`` verbatim: pure Python over big integers (and
numpy for :func:`keystream`), so the port keeps its own copy rather than
importing the JAX package.  The tests hold its points and keystreams equal
to the reference's.

Weierstrass curve  y² = x³ + ax + b (mod q)  with the group law of
Eqs. 9–11 and scalar multiplication of Eq. 12.  This is the *host-side*
transmission-security layer — it never runs on the device — but it sits on
the per-message critical path of MEA-ECC, so the implementation is tuned:

* **Jacobian coordinates** for the group ops (no per-step field inversion;
  one inversion at the end of a scalar multiply),
* **windowed-NAF** scalar multiplication (width 5: ~n/6 additions instead
  of n/2) for arbitrary points,
* a **precomputed fixed-base comb table** for multiples of the generator —
  ``k·G`` (keygen, the per-message ephemeral) costs ~64 mixed additions
  and no doublings,
* an **ECDH shared-point cache** keyed by (curve, sk, pk) — repeated
  channels (master↔worker sessions, checkpoint keys) pay the Diffie–
  Hellman multiply once.

The affine double-and-add of the original reproduction survives as
:meth:`EllipticCurve.multiply_naive` — the oracle the fast paths are tested
against.  Default parameters are secp256k1; a tiny toy curve is exposed for
exhaustive group-law tests.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import secrets
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "EllipticCurve", "ECPoint", "KeyPair", "CURVE_SECP256K1", "CURVE_TOY",
    "generate_keypair", "shared_secret", "keystream", "ephemeral_nonce",
]


@dataclasses.dataclass(frozen=True)
class ECPoint:
    """Affine point; None coordinates encode the point at infinity O."""
    x: Optional[int]
    y: Optional[int]

    @property
    def is_infinity(self) -> bool:
        return self.x is None

    def __iter__(self):
        yield self.x
        yield self.y


INFINITY = ECPoint(None, None)

# Jacobian (X, Y, Z): affine (X/Z², Y/Z³); Z == 0 encodes infinity.
_JAC_INF = (1, 1, 0)


@dataclasses.dataclass(frozen=True)
class EllipticCurve:
    q: int          # field prime
    a: int
    b: int
    gx: int         # generator
    gy: int
    order: int      # order of G

    def __post_init__(self):
        if (4 * self.a ** 3 + 27 * self.b ** 2) % self.q == 0:
            raise ValueError("singular curve: 4a^3 + 27b^2 ≡ 0 (mod q)")  # Eq. (8)

    @property
    def generator(self) -> ECPoint:
        return ECPoint(self.gx, self.gy)

    def contains(self, p: ECPoint) -> bool:
        if p.is_infinity:
            return True
        return (p.y * p.y - (p.x ** 3 + self.a * p.x + self.b)) % self.q == 0

    # ---- group law (Eqs. 9–11), affine — small-scale / reference ---------
    def add(self, p: ECPoint, r: ECPoint) -> ECPoint:
        if p.is_infinity:
            return r
        if r.is_infinity:
            return p
        if p.x == r.x and (p.y + r.y) % self.q == 0:
            return INFINITY
        if p == r:
            lam = (3 * p.x * p.x + self.a) * pow(2 * p.y, -1, self.q) % self.q
        else:
            lam = (r.y - p.y) * pow(r.x - p.x, -1, self.q) % self.q
        x3 = (lam * lam - p.x - r.x) % self.q
        y3 = (lam * (p.x - x3) - p.y) % self.q
        return ECPoint(x3, y3)

    def neg(self, p: ECPoint) -> ECPoint:
        if p.is_infinity:
            return p
        return ECPoint(p.x, (-p.y) % self.q)

    # ---- Jacobian core ---------------------------------------------------
    def _jac_double(self, P: Tuple[int, int, int]) -> Tuple[int, int, int]:
        X, Y, Z = P
        if Z == 0 or Y == 0:
            return _JAC_INF
        q = self.q
        Y2 = Y * Y % q
        S = 4 * X * Y2 % q
        M = (3 * X * X + self.a * pow(Z, 4, q)) % q
        X3 = (M * M - 2 * S) % q
        Y3 = (M * (S - X3) - 8 * Y2 * Y2) % q
        Z3 = 2 * Y * Z % q
        return (X3, Y3, Z3)

    def _jac_add(self, P: Tuple[int, int, int],
                 Q: Tuple[int, int, int]) -> Tuple[int, int, int]:
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        q = self.q
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1 = Z1 * Z1 % q
        Z2Z2 = Z2 * Z2 % q
        U1 = X1 * Z2Z2 % q
        U2 = X2 * Z1Z1 % q
        S1 = Y1 * Z2 * Z2Z2 % q
        S2 = Y2 * Z1 * Z1Z1 % q
        if U1 == U2:
            if (S1 + S2) % q == 0:
                return _JAC_INF
            return self._jac_double(P)
        H = (U2 - U1) % q
        R = (S2 - S1) % q
        H2 = H * H % q
        H3 = H * H2 % q
        U1H2 = U1 * H2 % q
        X3 = (R * R - H3 - 2 * U1H2) % q
        Y3 = (R * (U1H2 - X3) - S1 * H3) % q
        Z3 = Z1 * Z2 * H % q
        return (X3, Y3, Z3)

    def _to_jac(self, p: ECPoint) -> Tuple[int, int, int]:
        return _JAC_INF if p.is_infinity else (p.x, p.y, 1)

    def _from_jac(self, P: Tuple[int, int, int]) -> ECPoint:
        X, Y, Z = P
        if Z == 0:
            return INFINITY
        zi = pow(Z, -1, self.q)
        zi2 = zi * zi % self.q
        return ECPoint(X * zi2 % self.q, Y * zi2 * zi % self.q)

    # ---- scalar multiplication -------------------------------------------
    def multiply(self, k: int, p: ECPoint) -> ECPoint:
        """k·P via width-5 wNAF over Jacobian coordinates (~n doublings +
        ~n/6 additions + ONE field inversion).  Generator multiples take the
        fixed-base comb (:meth:`multiply_base`) instead."""
        if p.is_infinity or k % self.order == 0:
            return INFINITY
        if p == self.generator:
            return self.multiply_base(k)
        k %= self.order
        w = 5
        # precompute odd multiples P, 3P, ..., (2^(w-1)-1)P
        P1 = self._to_jac(p)
        P2 = self._jac_double(P1)
        odd = [P1]
        for _ in range((1 << (w - 1)) // 2 - 1):
            odd.append(self._jac_add(odd[-1], P2))
        neg = {i: None for i in range(len(odd))}
        acc = _JAC_INF
        for d in _wnaf(k, w):
            acc = self._jac_double(acc)
            if d > 0:
                acc = self._jac_add(acc, odd[d >> 1])
            elif d < 0:
                i = (-d) >> 1
                if neg[i] is None:
                    X, Y, Z = odd[i]
                    neg[i] = (X, (-Y) % self.q, Z)
                acc = self._jac_add(acc, neg[i])
        return self._from_jac(acc)

    def multiply_base(self, k: int) -> ECPoint:
        """k·G through the per-curve precomputed comb table: one mixed
        Jacobian addition per non-zero nibble of k, no doublings."""
        k %= self.order
        if k == 0:
            return INFINITY
        table = _fixed_base_table(self)
        acc = _JAC_INF
        i = 0
        while k:
            d = k & 15
            if d:
                acc = self._jac_add(acc, table[i][d - 1])
            k >>= 4
            i += 1
        return self._from_jac(acc)

    def multiply_naive(self, k: int, p: ECPoint) -> ECPoint:
        """Affine double-and-add (Eq. 12) — the seed implementation, kept as
        the oracle for the wNAF/fixed-base fast paths."""
        if k % self.order == 0 or p.is_infinity:
            return INFINITY
        k %= self.order
        result, addend = INFINITY, p
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.add(addend, addend)
            k >>= 1
        return result


def _wnaf(k: int, w: int) -> List[int]:
    """Width-w non-adjacent form of k, most-significant digit first."""
    digits: List[int] = []
    full = 1 << w
    half = 1 << (w - 1)
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    digits.reverse()
    return digits


@functools.lru_cache(maxsize=8)
def _fixed_base_table(curve: EllipticCurve):
    """Comb table for the generator: table[i][d-1] = d · 2^(4i) · G in
    Jacobian form, for nibble values d = 1..15.  Built once per curve."""
    nibbles = (curve.order.bit_length() + 3) // 4
    table = []
    base = curve._to_jac(curve.generator)
    for _ in range(nibbles):
        row = [base]
        for _ in range(14):
            row.append(curve._jac_add(row[-1], base))
        table.append(row)
        base = curve._jac_double(curve._jac_double(
            curve._jac_double(curve._jac_double(base))))
    return table


# secp256k1 (Bitcoin/ECDSA curve) — production parameters.
CURVE_SECP256K1 = EllipticCurve(
    q=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)

# y^2 = x^3 + 2x + 2 over F_17, G=(5,1), |G| = 19 — exhaustive-testable.
CURVE_TOY = EllipticCurve(q=17, a=2, b=2, gx=5, gy=1, order=19)


@dataclasses.dataclass(frozen=True)
class KeyPair:
    sk: int
    pk: ECPoint


def generate_keypair(curve: EllipticCurve = CURVE_SECP256K1,
                     rng: Optional[secrets.SystemRandom] = None,
                     sk: Optional[int] = None) -> KeyPair:
    """§IV-B step 1: sk < order random, pk = sk·G (fixed-base comb)."""
    if sk is None:
        rng = rng or secrets.SystemRandom()
        sk = rng.randrange(1, curve.order)
    return KeyPair(sk, curve.multiply_base(sk))


@functools.lru_cache(maxsize=4096)
def _cached_shared(curve: EllipticCurve, sk: int, pk: ECPoint) -> ECPoint:
    return curve.multiply(sk, pk)


def shared_secret(curve: EllipticCurve, own: KeyPair, their_pk: ECPoint) -> ECPoint:
    """§IV-B step 2: s = sk_own · pk_their (commutes — tested).  Cached per
    (curve, sk, pk): a session channel pays the DH multiply once, after
    which per-message EC cost is the two table lookups in MEA-ECC."""
    return _cached_shared(curve, own.sk, their_pk)


def ephemeral_nonce(eph: ECPoint) -> int:
    """Stream-mode nonce from the ephemeral point's x coordinate.

    ``x == 0`` is a legitimate affine coordinate on some curves — only
    ``x is None`` means infinity, which is never a valid ephemeral (k·G
    with 0 < k < order), so reject it instead of collapsing both cases to
    the same sentinel (the old ``eph.x or 0`` bug).
    """
    if eph.x is None:
        raise ValueError("ephemeral point at infinity has no nonce "
                         "(invalid ciphertext)")
    return eph.x


def keystream(secret: ECPoint, nonce: int, n_words: int, q: int) -> np.ndarray:
    """SHA-256 counter PRF over the shared secret — per-element mask stream
    for the hardened ('stream') MEA-ECC mode.

    Scalar ``hashlib`` reference implementation; returns ``(n_words,)``
    uint64 (every word is < 2^64, and < q after reduction when q fits).
    The vectorized twin is :func:`repro.crypto.field.keystream_u64` —
    bit-exact by test.
    """
    seed = hashlib.sha256(f"{secret.x}:{secret.y}:{nonce}".encode()).digest()
    out: List[int] = []
    counter = 0
    while len(out) < n_words:
        h = hashlib.sha256(seed + counter.to_bytes(8, "big")).digest()
        for i in range(0, 32, 8):
            if len(out) >= n_words:
                break
            out.append(int.from_bytes(h[i:i + 8], "big") % q)
        counter += 1
    return np.asarray(out, dtype=np.uint64)
