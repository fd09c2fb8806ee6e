"""Per-worker task callables for the loop round.

Ports ``MatmulTask``, ``PairMatmulTask`` and ``EnvelopeMatmulTask`` of
``repro/runtime/tasks.py``.
The transport hands each worker an opaque callable ``f`` plus its shard.
The reference pulls every shard to host numpy and back (its socket backend
pickles the task to worker processes); on the in-process transports (the
virtual clock and real threads) the port keeps shards and results on the
engine's device, so a task is a plain product of device tensors.  The worker product is not a kernel in the reference (it
runs outside any Pallas call), so here it is ``torch.matmul`` in IEEE
float32: the package never turns TF32 on
(``torch.backends.cuda.matmul.allow_tf32`` stays at PyTorch's default,
False).  ``SealedMatmulTask`` comes with the socket mesh (see
ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["MatmulTask", "PairMatmulTask", "EnvelopeMatmulTask"]


class MatmulTask:
    """Data-coded loop round: ``shard -> shard @ B``."""

    def __init__(self, b: torch.Tensor):
        self.b = b

    def __call__(self, shard):
        if shard is None:
            return None
        return torch.matmul(shard, self.b)


class PairMatmulTask:
    """Pair-coded loop round: ``(ea_i, eb_i) -> ea_i @ eb_i``."""

    def __call__(self, ab):
        if ab is None:
            return None
        return torch.matmul(ab[0], ab[1])


class EnvelopeMatmulTask:
    """The defended (fault) round's slot envelope.

    Plain rounds: ``(w, slot, shard)`` → ``(slot, shard @ B)``.  Encrypted
    rounds: ``(w, slot, ciphertext, nonce)`` → decrypt with worker ``w``'s
    key, multiply, encrypt the product back to the master under the
    dispatch-time ``nonce``.
    """

    def __init__(self, b: torch.Tensor, mea=None,
                 worker_kps: Optional[Sequence] = None, master_pk=None):
        self.b = b
        self.mea = mea
        self.worker_kps = list(worker_kps) if worker_kps is not None else None
        self.master_pk = master_pk

    def __call__(self, env):
        if env is None:                 # worker not targeted this round
            return None
        w, slot, payload = env[0], env[1], env[2]
        nonce = env[3] if len(env) > 3 else None
        if self.mea is not None and hasattr(payload, "ephemeral"):
            x = self.mea.decrypt(payload, self.worker_kps[w])
            r = torch.matmul(x, self.b)
            return (slot, self.mea.encrypt(r, self.master_pk,
                                           sender=self.worker_kps[w],
                                           nonce=nonce))
        return (slot, torch.matmul(payload, self.b))
