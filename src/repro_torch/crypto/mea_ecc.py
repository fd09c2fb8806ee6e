"""MEA-ECC — Matrix Encryption Algorithm over ECC (paper §IV-B), on tensors.

Ports ``repro/crypto/mea_ecc.py``.  Paper construction (steps 3–4): the
ciphertext of matrix M for worker W is

    C = ( k·G ,  M + Ψ(k·pk_W)·1_{m,d} )          Ψ(x, y) = x

and the worker strips the mask with its private key:
    M = C₂ − Ψ(sk_W · (k·G))·1.

Matrices live in F_q as limb planes (``repro_torch.crypto.field``).  The
codec embed, the mask and the carry-chain add/sub run as one direction of
``kernels.ops.mea_encrypt_core`` / ``mea_decrypt_core`` on the cipher's
device: the mask add is the hand-written CUDA ``mask_add`` kernel for CUDA
tensors and its plain version on the CPU (``use_kernel`` is the usual
tri-state).  The legacy big-int implementation is ``crypto.ref``.

Differences from the reference, by design:

* **The device** is the ``device=`` argument (``None`` = the card, which
  raises without one; tests pass ``"cpu"``).  Payloads stay tensors on it:
  ``Ciphertext.payload`` is an (n, L) ``torch.uint32`` tensor and
  :meth:`MEAECC.decrypt` returns a tensor.  numpy inputs are accepted and
  moved there.
* **No size buckets.**  The reference pads every payload to a power of two
  (``_bucket``) so that its jitted cores compile once per bucket.  Eager
  PyTorch compiles nothing per shape, so the cores run at the exact size
  (the counter PRF is prefix-stable, so the ciphertexts are the same bits).

Modes
-----
* ``mode="paper"``  — faithful: a single scalar mask for the whole matrix.
* ``mode="stream"`` — per-element mask words from a SHA-256 counter PRF
  keyed by the ECDH point and a nonce (the ephemeral x by default).

Codecs
------
* ``codec="fixed"``  — the paper's fixed-point embedding (2^-16 grid).
* ``codec="bits"``   — the raw bytes: decrypt is bit-identical for any
  dtype.  The runtime's ``encrypt="real"`` rounds use it.

Key agreement
-------------
``encrypt(..., k=...)`` is the paper's per-message ephemeral; ``sender=``
reuses a static key pair through the cached ECDH point (pair it with
``mode="stream"`` and a fresh ``nonce`` per message).
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Literal, Optional, Tuple

import numpy as np
import torch

from .ecc import (CURVE_SECP256K1, ECPoint, EllipticCurve, KeyPair,
                  ephemeral_nonce, generate_keypair, shared_secret)
from .field import (BitsCodec, FixedPointCodec, LimbField, as_u32_tensor,
                    keystream_u64, seed_words)

_CORE_FLOATS = ("float16", "bfloat16", "float32")

__all__ = ["FixedPointCodec", "MEAECC", "Ciphertext"]


def _dtype_name(dtype) -> str:
    """numpy or torch dtype -> its bare name ("float32", "bfloat16", ...)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    ephemeral: ECPoint          # k·G (or the sender's static pk)
    payload: torch.Tensor       # masked field elements, (n, L) torch.uint32
    shape: Tuple[int, ...]
    mode: str
    codec: str = "fixed"
    dtype: str = "float32"
    nonce: Optional[int] = None  # stream-mode nonce when not derived from eph


class MEAECC:
    """Master-side encrypt (to a worker pk) / worker-side decrypt (with sk)."""

    def __init__(self, curve: EllipticCurve = CURVE_SECP256K1,
                 frac_bits: int = 16,
                 mode: Literal["paper", "stream"] = "paper",
                 codec: Literal["fixed", "bits"] = "fixed",
                 use_kernel: Optional[bool] = None, device=None):
        from ..runtime.engine import resolve_device
        self.curve = curve
        self.field = LimbField(curve.q)
        self.frac_bits = frac_bits
        self.codec_name = codec
        self.codec = (FixedPointCodec(curve.q, frac_bits) if codec == "fixed"
                      else BitsCodec(curve.q))
        self.mode = mode
        self.use_kernel = use_kernel
        self.device = resolve_device(device)

    def to(self, device) -> "MEAECC":
        """This cipher on another device (a copy; the keys and the codec
        are shared).  A worker process binds the cipher of a task it
        unpickled to its own device with it."""
        import copy
        from ..runtime.engine import resolve_device
        out = copy.copy(self)
        out.device = resolve_device(device)
        return out

    # ---- dispatch: the tensor cores vs the numpy codec path ----------------
    def _core_eligible(self, dtype, codec: Optional[str] = None,
                       mode: Optional[str] = None) -> bool:
        """The cores cover the production configuration: a >64-bit modulus
        (stream words need no reduction) and, for the fixed codec, float
        inputs that cast to f32 exactly.  Small moduli and float64
        fixed-point inputs take the (bit-identical) numpy codec path."""
        codec = codec or self.codec_name
        mode = mode or self.mode
        if mode == "stream" and self.curve.q.bit_length() <= 64:
            return False
        if codec == "bits":
            return True
        return _dtype_name(dtype) in _CORE_FLOATS

    def _codec_for(self, name: str):
        """The codec matching a ciphertext's self-described codec."""
        if name == self.codec_name:
            return self.codec
        return (BitsCodec(self.curve.q) if name == "bits"
                else FixedPointCodec(self.curve.q, self.frac_bits))

    # ---- mask material -----------------------------------------------------
    def _mask_material(self, mask_point: ECPoint, nonce: Optional[int],
                       mode: Optional[str] = None) -> np.ndarray:
        """(8,) uint32 PRF seed words (stream) or (L,) psi limbs (paper),
        host-side numpy — the single source of the mask derivation."""
        if mask_point.is_infinity:
            raise ValueError("degenerate ECDH point (infinity) — invalid key")
        if (mode or self.mode) == "paper":
            return self.field.from_int(mask_point.x % self.curve.q)  # Ψ(x,y)=x
        return seed_words(mask_point.x, mask_point.y, nonce)

    def _mask_limbs(self, mask_point: ECPoint, nonce: Optional[int],
                    n_elems: int, mode: Optional[str] = None) -> torch.Tensor:
        """Numpy-path mask on the device: (n, L) stream limbs (reduced mod
        q) or (L,) paper limbs."""
        material = self._mask_material(mask_point, nonce, mode)
        if (mode or self.mode) != "paper":
            words = keystream_u64(mask_point.x, mask_point.y, nonce, n_elems,
                                  self.curve.q)
            material = self.field.from_u64(words)
        return as_u32_tensor(material, self.device)

    def _apply_mask(self, payload: torch.Tensor, mask: torch.Tensor,
                    subtract: bool) -> torch.Tensor:
        from ..kernels.ops import mask_add
        return mask_add(payload, mask, self.curve.q, subtract=subtract,
                        force_kernel=self.use_kernel)

    def _as_tensor(self, m) -> torch.Tensor:
        if not torch.is_tensor(m):
            m = torch.from_numpy(np.array(m))        # a writable copy
        return m.to(self.device)

    # ---- §IV-B step 3 ------------------------------------------------------
    def encrypt(self, m, recipient_pk: ECPoint, k: int | None = None,
                sender: Optional[KeyPair] = None,
                nonce: Optional[int] = None) -> Ciphertext:
        m = self._as_tensor(m)
        if sender is not None:
            if self.mode == "stream" and nonce is None:
                raise ValueError(
                    "static-channel stream encryption needs an explicit "
                    "per-message nonce: the ephemeral (= sender's pk) is "
                    "constant, so a derived nonce would reuse the keystream "
                    "for every message (two-time pad)")
            # static-key channel: ephemeral = sender's pk, ECDH point cached
            eph = sender.pk
            mask_point = shared_secret(self.curve, sender, recipient_pk)
        else:
            if k is None:
                k = secrets.SystemRandom().randrange(2, self.curve.order - 1)
            eph = self.curve.multiply_base(k)                  # k·G
            mask_point = self.curve.multiply(k, recipient_pk)  # k·pk_W
        if nonce is None and self.mode == "stream":
            nonce = ephemeral_nonce(eph)

        if self._core_eligible(m.dtype):
            from ..kernels.ops import mea_encrypt_core
            if self.codec_name == "bits":
                data = self.codec.encode_words(m)
            else:
                data = m.to(torch.float32).reshape(-1)
            payload = mea_encrypt_core(
                data, as_u32_tensor(self._mask_material(mask_point, nonce),
                                    self.device),
                q=self.curve.q, frac_bits=self.frac_bits, mode=self.mode,
                codec=self.codec_name, n_limbs=self.field.n_limbs,
                force_kernel=self.use_kernel)
        else:
            if self.codec_name == "bits":
                field = self.codec.encode(m)
            else:
                field = as_u32_tensor(self.codec.encode(
                    m.cpu().numpy()).reshape(-1, self.field.n_limbs),
                    self.device)
            mask = self._mask_limbs(mask_point, nonce, field.shape[0])
            payload = self._apply_mask(field, mask, subtract=False)
        return Ciphertext(eph, payload, tuple(m.shape), self.mode,
                          codec=self.codec_name, dtype=_dtype_name(m.dtype),
                          nonce=nonce)

    # ---- §IV-B step 4 ------------------------------------------------------
    def decrypt(self, c: Ciphertext, recipient: KeyPair) -> torch.Tensor:
        mask_point = shared_secret(self.curve, recipient, c.ephemeral)
        nonce = c.nonce
        if nonce is None and c.mode == "stream":
            nonce = ephemeral_nonce(c.ephemeral)
        flat = as_u32_tensor(c.payload, self.device).reshape(
            -1, self.field.n_limbs)
        codec = self._codec_for(c.codec)

        if self._core_eligible(c.dtype, codec=c.codec, mode=c.mode):
            from ..kernels.ops import mea_decrypt_core
            out = mea_decrypt_core(
                flat, as_u32_tensor(self._mask_material(mask_point, nonce,
                                                        c.mode), self.device),
                q=self.curve.q, frac_bits=self.frac_bits, mode=c.mode,
                codec=c.codec, force_kernel=self.use_kernel)
            if c.codec == "bits":
                return codec.decode_words(out, c.dtype, c.shape)
            return out.reshape(c.shape)

        mask = self._mask_limbs(mask_point, nonce, flat.shape[0], c.mode)
        unmasked = self._apply_mask(flat, mask, subtract=True)
        if c.codec == "bits":
            return codec.decode(unmasked, c.dtype, c.shape)
        return torch.from_numpy(codec.decode(unmasked.cpu().numpy())).reshape(
            c.shape).to(self.device)

    # ---- convenience: secure round trip master -> worker -> master ---------
    def secure_channel_roundtrip(self, m) -> torch.Tensor:
        """Self-test helper: generates both parties' keys and round-trips."""
        worker = generate_keypair(self.curve)
        c = self.encrypt(m, worker.pk)
        return self.decrypt(c, worker)
