"""Per-worker task callables for the loop round.

Ports ``MatmulTask`` and ``PairMatmulTask`` of ``repro/runtime/tasks.py``.
The transport hands each worker an opaque callable ``f`` plus its shard.
The reference pulls every shard to host numpy and back (its socket backend
pickles the task to worker processes); on the in-process transports (the
virtual clock and real threads) the port keeps shards and results on the
engine's device, so a task is a plain product of device tensors.  The worker product is not a kernel in the reference (it
runs outside any Pallas call), so here it is ``torch.matmul`` in IEEE
float32: the package never turns TF32 on
(``torch.backends.cuda.matmul.allow_tf32`` stays at PyTorch's default,
False).  ``EnvelopeMatmulTask`` and ``SealedMatmulTask`` come with the
fault paths and the socket mesh (see ROADMAP.md).
"""

from __future__ import annotations

import torch

__all__ = ["MatmulTask", "PairMatmulTask"]


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
