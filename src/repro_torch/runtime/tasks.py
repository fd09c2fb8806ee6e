"""Per-worker task callables for the loop round.

Ports ``MatmulTask``, ``PairMatmulTask``, ``EnvelopeMatmulTask`` and
``SealedMatmulTask`` of ``repro/runtime/tasks.py``.
The transport hands each worker an opaque callable ``f`` plus its shard.
On the in-process transports (the virtual clock and real threads) the port
keeps shards and results on the engine's device, so a task is a plain
product of device tensors.  The worker product is not a kernel in the
reference (it runs outside any Pallas call), so here it is ``torch.matmul``
in IEEE float32: the package never turns TF32 on
(``torch.backends.cuda.matmul.allow_tf32`` stays at PyTorch's default,
False).

**On the socket mesh** the task object is pickled to worker processes
(``runtime.socket_transport``).  It pickles device-agnostic: its operands
go out as host numpy arrays, never as CUDA tensors (a CUDA tensor pickled
as it is would be restored onto ``cuda:0`` whatever the worker was told),
and the worker binds them to its own ``--device`` with :meth:`bind` right
after unpickling (``launch.worker``); the ``MEAECC`` inside a task is
rebound there too (``MEAECC.to``).  In-process, nothing is pickled or
bound.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["MatmulTask", "PairMatmulTask", "EnvelopeMatmulTask",
           "SealedMatmulTask"]


class _Task:
    """Device-agnostic pickling: the tensors named in ``_operands`` leave as
    host numpy arrays; :meth:`bind` puts them, and the cipher, on a
    device."""

    _operands: tuple = ()

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in self._operands:
            t = state.get(name)
            if torch.is_tensor(t):
                state[name] = t.detach().cpu().numpy()
        return state

    def bind(self, device) -> "_Task":
        """The worker side of a pickled task: operands and cipher on
        ``device``.  Returns ``self``."""
        device = torch.device(device)
        for name in self._operands:
            v = getattr(self, name, None)
            if v is not None:
                setattr(self, name, torch.as_tensor(v).to(device))
        mea = getattr(self, "mea", None)
        if mea is not None:
            self.mea = mea.to(device)
        return self


class MatmulTask(_Task):
    """Data-coded loop round: ``shard -> shard @ B``."""

    _operands = ("b",)

    def __init__(self, b: torch.Tensor):
        self.b = b

    def __call__(self, shard):
        if shard is None:
            return None
        return torch.matmul(shard, self.b)


class PairMatmulTask(_Task):
    """Pair-coded loop round: ``(ea_i, eb_i) -> ea_i @ eb_i``."""

    def __call__(self, ab):
        if ab is None:
            return None
        return torch.matmul(ab[0], ab[1])


class EnvelopeMatmulTask(_Task):
    """The defended (fault) round's slot envelope.

    Plain rounds: ``(w, slot, shard)`` → ``(slot, shard @ B)``.  Encrypted
    rounds: ``(w, slot, ciphertext, nonce)`` → decrypt with worker ``w``'s
    key, multiply, encrypt the product back to the master under the
    dispatch-time ``nonce`` (drawn by the master: a shared nonce counter
    cannot cross a process boundary).
    """

    _operands = ("b",)

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


class SealedMatmulTask(_Task):
    """The socket mesh's ``encrypt="real"`` loop round.

    Shards arrive sealed: ``(worker, (ct, ...), reply_nonce)``, one
    ciphertext for a data-coded round (the task multiplies by its stored
    ``B``), two for a pair-coded round (the task multiplies the decrypted
    pair).  The product goes back encrypted to the master's public key
    under the reply nonce, so both legs of the round move genuine MEA-ECC
    bytes; on the card the decrypt and the encrypt are ``mask_add``
    launches in the worker process.
    """

    _operands = ("b",)

    def __init__(self, mea, worker_kps: Sequence, master_pk, b=None):
        self.mea = mea
        self.worker_kps = list(worker_kps)
        self.master_pk = master_pk
        self.b = b

    def __call__(self, sealed):
        if sealed is None:
            return None
        w, cts, nonce = sealed
        parts = [self.mea.decrypt(ct, self.worker_kps[w]) for ct in cts]
        if len(parts) == 2:
            r = torch.matmul(parts[0], parts[1])
        else:
            r = torch.matmul(parts[0], self.b)
        return self.mea.encrypt(r, self.master_pk,
                                sender=self.worker_kps[w], nonce=nonce)

