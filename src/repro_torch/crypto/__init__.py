"""Transmission-security substrate: ECC + MEA-ECC (paper §IV).

Ports ``repro/crypto``.  ``field`` holds the limb F_q arithmetic the cipher
runs on (numpy on the host, tensors on the device); ``ecc`` the curve
arithmetic over python ints; ``mea_ecc`` the cipher; ``ref`` the legacy
object-dtype implementation kept as the bit-exactness oracle.
"""

from .ecc import (CURVE_SECP256K1, CURVE_TOY, ECPoint, EllipticCurve, KeyPair,
                  ephemeral_nonce, generate_keypair, keystream, shared_secret)
from .field import BitsCodec, LimbField, keystream_u64
from .mea_ecc import MEAECC, Ciphertext, FixedPointCodec

__all__ = [
    "CURVE_SECP256K1", "CURVE_TOY", "ECPoint", "EllipticCurve", "KeyPair",
    "ephemeral_nonce", "generate_keypair", "shared_secret", "keystream",
    "keystream_u64", "LimbField", "BitsCodec", "MEAECC", "Ciphertext",
    "FixedPointCodec",
]
