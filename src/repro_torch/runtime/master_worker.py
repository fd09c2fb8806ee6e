"""Legacy master/worker surface — thin shims over the spec-driven engine.

Ports ``repro/runtime/master_worker.py``.  :class:`DistributedMatmul` is the
pre-spec constructor: its loosely-typed knobs map 1:1 onto spec fields
(``ClusterSpec.from_legacy_kwargs``) and the rounds it runs are the ones
``repro_torch.api.Session`` runs on the same spec.  :class:`CodedMaster` is
the SPACDC-DL training master (Algorithm 2), delegating its SGD step to the
same ``coded_mlp_step`` the Session's ``train_step`` runs.

Both take ``device=`` like ``Session``: ``None`` means the card and raises
without one; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

from .engine import RoundEngine, RoundStats, WorkerPool, resolve_device
from .straggler import StragglerModel
from .wait_policy import WaitPolicy, resolve_policy

__all__ = ["RoundStats", "WorkerPool", "DistributedMatmul", "CodedMaster"]


class DistributedMatmul(RoundEngine):
    """Coded A@B on the pool under a named scheme — legacy constructor.

    Every kwarg lands in exactly one ``ClusterSpec`` field; the engine the
    spec builds is the one ``repro_torch.api.Session`` drives, so both
    surfaces produce bit-identical rounds.  Pre-built ``StragglerModel`` /
    ``WaitPolicy`` instances pass straight through.
    """

    def __init__(self, scheme_name: str, n_workers: int, k_blocks: int,
                 t_colluding: int = 0,
                 straggler: Optional[StragglerModel] = None,
                 n_stragglers: int = 0, encrypt: bool | str = False,
                 seed: int = 0, fused: Optional[bool] = None,
                 cipher_mode: str = "stream",
                 wait_policy: Optional[WaitPolicy | str] = None,
                 pipeline_encode: bool = False, *, device=None,
                 **scheme_kwargs):
        from ..api.spec import ClusterSpec
        spec = ClusterSpec.from_legacy_kwargs(
            scheme_name, n_workers, k_blocks, t_colluding=t_colluding,
            straggler=straggler, n_stragglers=n_stragglers, encrypt=encrypt,
            seed=seed, fused=fused, cipher_mode=cipher_mode,
            wait_policy=wait_policy, pipeline_encode=pipeline_encode,
            **scheme_kwargs)
        super().__init__(
            spec, device=device, straggler=straggler,
            policy=resolve_policy(wait_policy) if wait_policy is not None
            else None)


class CodedMaster:
    """SPACDC-DL master (Algorithm 2): trains an MLP, distributing the
    backward products through a DistributedMatmul scheme.

    ``wait_policy`` overrides the DistributedMatmul's policy for the
    training rounds.  Per-round stats land in ``round_stats``.  The MLP's
    weights and biases are float32 tensors on ``device`` (``None`` = the
    card), which must be the DistributedMatmul's device.
    """

    def __init__(self, layer_sizes, dist: DistributedMatmul, lr=0.05, seed=0,
                 wait_policy=None, *, device=None):
        from ..api.session import coded_mlp_init
        dev = resolve_device(device)
        if dev != dist.device:
            raise ValueError(f"CodedMaster on {dev} but its DistributedMatmul "
                             f"runs on {dist.device}")
        self.dist = dist
        if wait_policy is not None:
            dist.policy = resolve_policy(wait_policy)
        self.round_stats = []
        self.lr = lr
        self.weights, self.biases = coded_mlp_init(layer_sizes, seed,
                                                   device=dev)
        self.round = 0

    def forward(self, x):
        from ..api.session import mlp_forward
        return mlp_forward(self.weights, self.biases, x)

    def train_batch(self, x, y, n_classes=10):
        """One SGD step; backward layer products distributed.  Returns
        (loss, virtual_seconds)."""
        from ..api.session import coded_mlp_step
        loss, elapsed, stats = coded_mlp_step(
            self.weights, self.biases, self.dist.matmul, x, y, lr=self.lr,
            round0=self.round)
        self.round += len(stats)
        self.round_stats.extend(stats)
        return loss, elapsed

    def accuracy(self, x, y):
        from ..api.session import _mlp_accuracy
        return _mlp_accuracy(self.weights, self.biases, x, y)
