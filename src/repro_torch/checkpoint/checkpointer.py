"""Fault-tolerant checkpointing: atomic, integrity-checked, optionally
MEA-ECC-encrypted at the storage boundary.

Ports ``repro/checkpoint/checkpointer.py`` with its on-disk layout:
``<dir>/step_<n>/{arrays.npz, MANIFEST.json}``, written into a temporary
directory and renamed into place, so a killed writer never leaves a
checkpoint that ``restore`` would accept; the manifest holds a SHA-256 per
array; ``latest_step`` and ``restore`` give crash-restart, ``keep``
prunes.  Leaves are ordered as ``jax.tree.flatten`` orders them
(``repro_torch.tree``: dict keys sorted, sequence and NamedTuple fields in
order, ``None`` no leaf), so a flat or nested tree written by either
package restores in the other bit for bit, plain or encrypted with the
same ``secret``.

Tensors on the card are copied to the host to be written; ``restore``
puts every leaf back on the device (and in the dtype) of the matching leaf
of ``tree_like``.

``encrypt=True`` encrypts each array with MEA-ECC in stream mode over the
lossless bits codec (``repro_torch.crypto``), on the checkpointer's
``device`` (``None`` = the card): the mask add is the CUDA ``mask_add``
kernel there.  Payloads land as uint32 limb planes trimmed to their
nonzero low columns, each array under a random 128-bit nonce kept in the
manifest, beside a keyed tag (``_decrypt_check``) that makes a restore
with the wrong ``secret`` raise instead of returning garbage.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from .. import tree as tree_util

__all__ = ["Checkpointer"]


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16 through ``ml_dtypes``)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            import ml_dtypes
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _like(arr: np.ndarray, ref):
    """``arr`` in the dtype, shape and (for a tensor) device of ``ref``."""
    if torch.is_tensor(ref):
        if ref.dtype == torch.bfloat16:
            import ml_dtypes
            bits = np.ascontiguousarray(
                np.asarray(arr).astype(ml_dtypes.bfloat16)).view(np.int16)
            t = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            np_dtype = torch.empty(0, dtype=ref.dtype).numpy().dtype
            t = torch.from_numpy(np.ascontiguousarray(
                np.asarray(arr).astype(np_dtype)))
        return t.reshape(ref.shape).to(ref.device)
    ref = np.asarray(ref)
    return np.asarray(arr).astype(ref.dtype).reshape(ref.shape)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, encrypt: bool = False,
                 secret: Optional[bytes] = None, device=None):
        """``secret`` (encrypt=True only): key material the keys are derived
        from deterministically; pass the same secret to a new Checkpointer
        (of this package or the reference's) to restore checkpoints it
        wrote.  Without it the keys are random and encrypted checkpoints
        decrypt only within this instance's lifetime.  ``device``
        (encrypt=True only) is where the cipher runs: ``None`` means the
        card, and raises without one; the tests pass ``"cpu"``."""
        self.dir = directory
        self.keep = keep
        self.encrypt = encrypt
        os.makedirs(directory, exist_ok=True)
        self._mea = None
        self._worker = None
        if encrypt:
            from ..crypto import MEAECC, generate_keypair
            self._mea = MEAECC(mode="stream", codec="bits", device=device)
            self._worker = generate_keypair(
                sk=self._derive_sk(secret, "worker"))
            self._session = generate_keypair(
                sk=self._derive_sk(secret, "session"))

    def _fresh_nonce(self) -> int:
        """A random per-array nonce (kept in the manifest): a counter would
        restart in a restarted job with the same ``secret`` and reuse the
        keystream across checkpoints."""
        return secrets.randbits(128)

    def _derive_sk(self, secret: Optional[bytes], role: str) -> Optional[int]:
        if secret is None:
            return None                       # random per-instance keypair
        curve = self._mea.curve
        digest = hashlib.sha256(bytes(secret) + b"|ckpt|" + role.encode())
        return int.from_bytes(digest.digest(), "big") % (curve.order - 1) + 1

    def _decrypt_check(self, ct, plaintext: bytes) -> str:
        """Keyed integrity tag over the plaintext: restore recomputes it
        with its own keys, so the wrong secret raises."""
        from ..crypto import shared_secret
        s = shared_secret(self._mea.curve, self._worker, ct.ephemeral)
        return hashlib.sha256(f"{s.x}:{ct.nonce}:".encode() +
                              plaintext).hexdigest()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        leaves, _ = tree_util.flatten(tree)
        arrays = {f"arr_{i}": _host(x) for i, x in enumerate(leaves)}
        manifest = {
            "step": int(step),
            "n_arrays": len(arrays),
            "treedef": f"repro_torch.tree, {len(arrays)} leaves",
            "encrypted": self.encrypt,
            # a copy: the manifest grows _eph_/_nonce_/_check_ keys below
            "extra": dict(extra or {}),
            "hashes": {},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
        }
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            if self.encrypt:
                enc = {}
                for (k, v), leaf in zip(arrays.items(), leaves):
                    src = leaf if torch.is_tensor(leaf) else v
                    ct = self._mea.encrypt(src, self._worker.pk,
                                           sender=self._session,
                                           nonce=self._fresh_nonce())
                    payload = ct.payload.view(torch.int32).cpu().numpy() \
                        .view(np.uint32)                 # (n_words, L)
                    # the bits-codec stream payload fills only the low
                    # limbs: store the nonzero-prefix columns
                    nz = payload.shape[1]
                    while nz > 1 and not payload[:, nz - 1].any():
                        nz -= 1
                    enc[k] = np.ascontiguousarray(payload[:, :nz])
                    manifest["extra"][f"_eph_{k}"] = [ct.ephemeral.x,
                                                      ct.ephemeral.y]
                    manifest["extra"][f"_nonce_{k}"] = ct.nonce
                    manifest["extra"][f"_check_{k}"] = self._decrypt_check(
                        ct, np.ascontiguousarray(v).tobytes())
                    manifest["hashes"][k] = hashlib.sha256(
                        enc[k].tobytes()).hexdigest()
                np.savez_compressed(os.path.join(tmp, "arrays.npz"), **enc)
            else:
                for k, v in arrays.items():
                    manifest["hashes"][k] = hashlib.sha256(
                        np.ascontiguousarray(v).tobytes()).hexdigest()
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic commit
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, step: int, tree_like: Any) -> Any:
        """Restore into the structure of ``tree_like`` (verifies hashes);
        every leaf takes the dtype, shape and device of its like-leaf."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"), allow_pickle=False)
        leaves, _ = tree_util.flatten(tree_like)
        if manifest["n_arrays"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_arrays']} arrays, tree wants "
                f"{len(leaves)}")
        out = []
        for i, ref in enumerate(leaves):
            k = f"arr_{i}"
            raw = data[k]
            if hashlib.sha256(np.ascontiguousarray(raw).tobytes()) \
                    .hexdigest() != manifest["hashes"][k]:
                raise IOError(f"checkpoint corruption detected in {k}")
            if manifest["encrypted"]:
                arr = self._decrypt(manifest, k, raw)
            else:
                arr = raw
            out.append(_like(arr, ref))
        return tree_util.unflatten(tree_like, out)

    def _decrypt(self, manifest: dict, k: str, raw) -> np.ndarray:
        if self._mea is None:
            raise IOError("checkpoint is encrypted: restore it with a "
                          "Checkpointer(encrypt=True, secret=...)")
        from ..crypto import ECPoint
        from ..crypto.mea_ecc import Ciphertext
        from ..crypto.field import as_u32_tensor
        ex, ey = manifest["extra"][f"_eph_{k}"]
        shape = tuple(manifest["shapes"][k])
        payload = np.asarray(raw, np.uint32)
        full = self._mea.field.n_limbs
        if payload.shape[1] < full:      # undo the nonzero-prefix trim
            payload = np.pad(payload, ((0, 0), (0, full - payload.shape[1])))
        ct = Ciphertext(ECPoint(ex, ey),
                        as_u32_tensor(payload, self._mea.device), shape,
                        "stream", codec="bits", dtype=manifest["dtypes"][k],
                        nonce=manifest["extra"].get(f"_nonce_{k}"))
        arr = _host(self._mea.decrypt(ct, self._worker))
        want = manifest["extra"].get(f"_check_{k}")
        if want is not None and self._decrypt_check(
                ct, np.ascontiguousarray(arr).tobytes()) != want:
            raise IOError(
                f"checkpoint {k} failed decryption check: wrong key (pass "
                "the Checkpointer the same `secret` that wrote this "
                "checkpoint) or corrupted data")
        return arr
