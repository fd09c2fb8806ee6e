"""``Session``: the context-managed runtime behind one ``ClusterSpec``.

Ports ``Session.__init__``, its lifecycle and ``Session.matmul`` of
``repro/api/session.py``:

    with Session(ClusterSpec.paper_fig3()) as s:       # on the card
        out, stats = s.matmul(a, b)                    # one coded round

The device is the ``device=`` argument (``None`` = ``"cuda"``, which raises
without a CUDA device; the tests pass ``device="cpu"``), never a spec field.
``matmul`` returns the product as a tensor on that device, where the
reference returns a host numpy array: the host copy is left to the caller.
Anytime curves, MLP training and serving come in later slices and raise
``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..runtime.engine import RoundEngine, RoundStats
from .spec import ClusterSpec

__all__ = ["Session"]


def _later(what: str):
    raise NotImplementedError(
        f"Session.{what} comes in a later slice of the port; see ROADMAP.md")


class Session:
    """Context-managed front door over the ported stack.

    Everything is configured by the frozen :class:`~repro_torch.api.ClusterSpec`;
    ``device`` picks where rounds run.  ``straggler`` / ``policy`` accept
    pre-built instances (objects a spec can't express).
    """

    def __init__(self, spec: ClusterSpec, *, device=None, straggler=None,
                 policy=None):
        self.spec = spec
        self.engine = RoundEngine(spec, device=device, straggler=straggler,
                                  policy=policy)
        self._closed = False
        self._round = 0
        self.round_stats: List[RoundStats] = []

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def close(self):
        """Tear the engine down — exactly once; later calls are no-ops."""
        if not self._closed:
            self._closed = True
            self.engine.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Session is closed")

    # -------------------------------------------------------------- rounds
    def matmul(self, a, b, round_idx: Optional[int] = None, *, noise=None
               ) -> Tuple[torch.Tensor, RoundStats]:
        """One coded A@B round under the spec's scheme/policy.
        ``round_idx`` defaults to an internal counter (each call is a new
        straggler draw); pass it explicitly to replay rounds.  ``noise``
        optionally supplies the (T, blk, d) noise blocks.  Returns the
        (m, n) product on the session's device and the round's stats."""
        self._check_open()
        if round_idx is None:
            round_idx = self._round
            self._round += 1
        out, stats = self.engine.matmul(a, b, round_idx=round_idx,
                                        noise=noise)
        self.round_stats.append(stats)
        return out, stats

    # ------------------------------------------------- later slices' paths
    def anytime_curve(self, a, b, round_idx: int = 0):
        _later("anytime_curve")

    def init_mlp(self, layer_sizes, lr: float = 0.05, seed: int = 0):
        _later("init_mlp")

    def train_step(self, x, y):
        _later("train_step")

    def serve(self, arch: str = "qwen2-7b", **kwargs):
        _later("serve")
