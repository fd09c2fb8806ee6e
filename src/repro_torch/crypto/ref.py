"""The legacy object-dtype MEA-ECC — kept verbatim as the crypto oracle.

Ports ``repro/crypto/ref.py`` verbatim (pure Python and numpy).

This is the seed implementation of §IV-B: per-element Python big-int
arithmetic through ``np.vectorize`` on object-dtype arrays.  It is
~100× slower than the limb-vectorized pipeline in ``crypto.mea_ecc`` /
``crypto.field`` but trivially auditable, so it stays as

* the **bit-exactness oracle** the vectorized cipher is tested against
  (``tests/test_crypto.py``), and
* the **baseline** the ``bench_crypto`` speedup gate measures from.

Do not use it for real workloads.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Literal

import numpy as np

from .ecc import (CURVE_SECP256K1, ECPoint, EllipticCurve, KeyPair,
                  ephemeral_nonce, keystream)

__all__ = ["LegacyFixedPointCodec", "LegacyMEAECC", "LegacyCiphertext"]


@dataclasses.dataclass(frozen=True)
class LegacyFixedPointCodec:
    """Embed float matrices into Z_q: round(x * 2^frac_bits) mod q."""
    q: int
    frac_bits: int = 16

    def encode(self, m: np.ndarray) -> np.ndarray:
        scaled = np.rint(np.asarray(m, dtype=np.float64) *
                         (1 << self.frac_bits)).astype(object)
        return np.vectorize(lambda v: int(v) % self.q, otypes=[object])(scaled)

    def decode(self, w: np.ndarray) -> np.ndarray:
        half = self.q // 2

        def back(v):
            v = int(v)
            if v > half:
                v -= self.q
            # clamp to float32 range (wrong-key decrypts yield huge ints)
            return max(min(v / float(1 << self.frac_bits), 3e38), -3e38)

        return np.vectorize(back, otypes=[np.float64])(w).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class LegacyCiphertext:
    ephemeral: ECPoint          # k·G
    payload: np.ndarray         # masked field matrix (object dtype, big ints)
    shape: tuple
    mode: str


class LegacyMEAECC:
    """Master-side encrypt / worker-side decrypt, interpreter-speed."""

    def __init__(self, curve: EllipticCurve = CURVE_SECP256K1,
                 frac_bits: int = 16,
                 mode: Literal["paper", "stream"] = "paper"):
        self.curve = curve
        self.codec = LegacyFixedPointCodec(curve.q, frac_bits)
        self.mode = mode

    # ---- §IV-B step 3 ------------------------------------------------------
    def encrypt(self, m: np.ndarray, recipient_pk: ECPoint,
                k: int | None = None) -> LegacyCiphertext:
        if k is None:
            k = secrets.SystemRandom().randrange(2, self.curve.order - 1)
        eph = self.curve.multiply_naive(k, self.curve.generator)   # k·G
        mask_point = self.curve.multiply_naive(k, recipient_pk)    # k·pk_W
        field = self.codec.encode(m)
        flat = field.reshape(-1)
        if self.mode == "paper":
            psi = mask_point.x % self.curve.q                      # Ψ(x,y)=x
            masked = np.vectorize(lambda v: (int(v) + psi) % self.curve.q,
                                  otypes=[object])(flat)
        else:
            words = keystream(mask_point, ephemeral_nonce(eph), flat.size,
                              self.curve.q)
            masked = np.array([(int(v) + int(w)) % self.curve.q
                               for v, w in zip(flat, words)], dtype=object)
        return LegacyCiphertext(eph, masked.reshape(field.shape),
                                tuple(m.shape), self.mode)

    # ---- §IV-B step 4 ------------------------------------------------------
    def decrypt(self, c: LegacyCiphertext, recipient: KeyPair) -> np.ndarray:
        mask_point = self.curve.multiply_naive(recipient.sk, c.ephemeral)
        flat = c.payload.reshape(-1)
        if c.mode == "paper":
            psi = mask_point.x % self.curve.q
            unmasked = np.vectorize(lambda v: (int(v) - psi) % self.curve.q,
                                    otypes=[object])(flat)
        else:
            words = keystream(mask_point, ephemeral_nonce(c.ephemeral),
                              flat.size, self.curve.q)
            unmasked = np.array([(int(v) - int(w)) % self.curve.q
                                 for v, w in zip(flat, words)], dtype=object)
        return self.codec.decode(unmasked.reshape(c.payload.shape)).reshape(c.shape)
