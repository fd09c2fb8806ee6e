"""``Session``: the context-managed runtime behind one ``ClusterSpec``.

Ports ``Session.__init__``, its lifecycle, ``Session.matmul`` and the
SPACDC-DL training step (paper Algorithm 2: ``coded_mlp_init``,
``mlp_forward``, ``coded_mlp_step``, ``Session.init_mlp`` / ``train_step``
/ ``mlp_accuracy``) of ``repro/api/session.py``:

    with Session(ClusterSpec.paper_fig3()) as s:       # on the card
        out, stats = s.matmul(a, b)                    # one coded round
        s.init_mlp((784, 512, 10), lr=0.05)
        loss, elapsed = s.train_step(x, y)             # SPACDC-DL step

The device is the ``device=`` argument (``None`` = ``"cuda"``, which raises
without a CUDA device; the tests pass ``device="cpu"``), never a spec field.
``matmul`` returns the product as a tensor on that device, where the
reference returns a host numpy array: the host copy is left to the caller.
The MLP's state (weights, biases, activations, the backward ``delta``)
lives on the same device as float32 tensors; the uncoded products are
``torch.matmul`` in IEEE float32 (the package never turns TF32 on).  The
reference's state is float64 under numpy 2 (its float32 draw times a
float64 scale promotes); the port keeps float32, the reference's initial
weights rounded to float32 bit for bit.  Anytime curves and serving come in
later slices and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime.engine import RoundEngine, RoundStats, resolve_device
from .spec import ClusterSpec

__all__ = ["Session", "coded_mlp_init", "coded_mlp_step"]


# --------------------------------------------------------------------------
# the SPACDC-DL training step (Algorithm 2), functional form
# --------------------------------------------------------------------------

def coded_mlp_init(layer_sizes: Sequence[int], seed: int = 0, *,
                   device=None):
    """He-initialized MLP state: (weights, biases) as lists of float32
    tensors on ``device`` (``None`` = the card).  The draw is the
    reference's: numpy's ``default_rng(seed)``, a float32 standard normal
    scaled by sqrt(2 / fan_in), rounded to float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    weights = [torch.from_numpy(
        (rng.standard_normal((m, n)).astype(np.float32) *
         np.sqrt(2.0 / m)).astype(np.float32)).to(dev)
        for m, n in zip(layer_sizes[:-1], layer_sizes[1:])]
    biases = [torch.zeros(n, dtype=torch.float32, device=dev)
              for n in layer_sizes[1:]]
    return weights, biases


def _act(x):
    return torch.clamp_min(x, 0.0)


def _act_grad(x):
    return (x > 0).to(x.dtype)


def _on(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device, in ``dtype`` (default:
    ``like``'s)."""
    return torch.as_tensor(x, dtype=like.dtype if dtype is None else dtype,
                           device=like.device)


def mlp_forward(weights, biases, x):
    """ReLU MLP forward: returns (activations, pre-activations)."""
    x = _on(x, weights[0])
    acts, pre = [x], []
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        z = torch.matmul(h, w) + b
        pre.append(z)
        h = _act(z) if i < len(weights) - 1 else z
        acts.append(h)
    return acts, pre


def _mlp_accuracy(weights, biases, x, y) -> float:
    acts, _ = mlp_forward(weights, biases, x)
    y = _on(y, weights[0], torch.int64)
    return float((acts[-1].argmax(1) == y).to(torch.float32).mean())


def coded_mlp_step(weights, biases, matmul, x, y, lr: float = 0.05,
                   round0: int = 0):
    """One SGD step of SPACDC-DL (paper Algorithm 2), backward layer
    products distributed through ``matmul(a, b, round_idx) ->
    (product, RoundStats)`` — the coded job is Eq. 23's delta @ W^T,
    coded over W's rows.

    Mutates ``weights``/``biases`` in place (the master owns its state);
    ``x`` and ``y`` move to the weights' device.  The loss is the step's
    one host sync.  Returns (loss, elapsed_virtual_s, per_round_stats).
    """
    bsz = x.shape[0]
    y = _on(y, weights[0], torch.int64)
    rows = torch.arange(bsz, device=y.device)
    acts, pre = mlp_forward(weights, biases, x)
    logits = acts[-1]
    z = logits - logits.max(1, keepdim=True).values
    p = torch.exp(z)
    p /= p.sum(1, keepdim=True)
    loss = -torch.mean(torch.log(p[rows, y] + 1e-12))
    onehot = torch.zeros_like(p)
    onehot[rows, y] = 1.0
    delta = (p - onehot) / bsz                      # (B, n_out)

    elapsed = 0.0
    stats_out: List[RoundStats] = []
    grads_w, grads_b = [], []
    for l in reversed(range(len(weights))):
        grads_w.append(torch.matmul(acts[l].T, delta))
        grads_b.append(delta.sum(0))
        if l > 0:
            # the distributed job (Eq. 23): delta @ W^T, coded over W rows
            prod, stats = matmul(weights[l], delta.T,
                                 round_idx=round0 + len(stats_out))
            delta = prod.T * _act_grad(pre[l - 1])
            elapsed += stats.total_s
            stats_out.append(stats)
    grads_w, grads_b = grads_w[::-1], grads_b[::-1]
    for i in range(len(weights)):
        weights[i] -= lr * grads_w[i]
        biases[i] -= lr * grads_b[i]
    return float(loss), elapsed, stats_out


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
        self._mlp = None
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

    # ------------------------------------------------------------ training
    def init_mlp(self, layer_sizes: Sequence[int], lr: float = 0.05,
                 seed: int = 0) -> "Session":
        """Initialize the SPACDC-DL training state ``train_step`` advances,
        on the session's device."""
        self._check_open()
        w, b = coded_mlp_init(layer_sizes, seed, device=self.device)
        self._mlp = (w, b, lr)
        return self

    @property
    def mlp_weights(self):
        """The MLP's weights: float32 tensors on the session's device, the
        live state (``train_step`` updates them in place)."""
        return self._mlp[0] if self._mlp else None

    @property
    def mlp_biases(self):
        """The MLP's biases, as :attr:`mlp_weights`."""
        return self._mlp[1] if self._mlp else None

    def train_step(self, x, y) -> Tuple[float, float]:
        """One coded SGD step (Algorithm 2); backward layer products run
        as coded rounds under the session's policy.  Returns
        (loss, virtual_elapsed_s); per-round stats land in
        ``round_stats``."""
        self._check_open()
        if self._mlp is None:
            raise RuntimeError("call init_mlp(layer_sizes) first")
        w, b, lr = self._mlp
        loss, elapsed, stats = coded_mlp_step(
            w, b, self.engine.matmul, x, y, lr=lr, round0=self._round)
        self._round += len(stats)
        self.round_stats.extend(stats)
        return loss, elapsed

    def mlp_accuracy(self, x, y) -> float:
        self._check_open()
        if self._mlp is None:
            raise RuntimeError("call init_mlp(layer_sizes) first")
        return _mlp_accuracy(self._mlp[0], self._mlp[1], x, y)

    # ------------------------------------------------- later slices' paths
    def anytime_curve(self, a, b, round_idx: int = 0):
        _later("anytime_curve")

    def serve(self, arch: str = "qwen2-7b", **kwargs):
        _later("serve")
