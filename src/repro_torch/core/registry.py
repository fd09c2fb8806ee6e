"""Scheme defaults + the string-keyed scheme registry.

Ports ``SchemeDefaults`` and the registry of ``repro/core/registry.py``.
Every scheme registers a factory under a short name; every consumer
constructs schemes through :func:`build`.  Schemes whose encode
is a data-independent linear contraction expose ``supports_fused`` /
``fused_round(a, b, mask)``: encode, all N worker matmuls and the masked
decode of one round, run on the device through the port's two CUDA
kernels (``kernels.ops.coded_matmul`` and ``kernels.ops.berrut_combine``).
``use_kernel`` is the schemes' tri-state (None = kernel for CUDA tensors,
True = force the kernel, False = the plain PyTorch version).

Anytime decoding (the paper's no-minimum-wait claim, §V): every scheme
decodes an arbitrary responder prefix (``anytime_decode``) and gives the
decode weights of every prefix of an arrival order at once
(``prefix_decode_weights``, float64 ``np.linalg.pinv`` on the host by
default), so a round's whole anytime curve is one batched
``kernels.ops.prefix_decode``.  Rateless schemes add a second decoder for
the embedded-pair error proxy (``anytime_proxy_weights``); the default has
none.

Byzantine screening (``decode_residuals``, read by
``runtime.scheduler.screen_responders``): every responder's result is
predicted from the other responders.  The reference loops over the
responders in numpy, one float64 leave-one-out prediction each; the port
stacks the R leave-one-out rows into one (R, R) float64 matrix with a zero
diagonal (built on the host, as the reference builds each row) and
predicts all R results in one float64 ``torch.matmul`` on the results'
device (``_loo_scores``).  The reference runs this outside any Pallas
kernel, so a library product is its port.

Registered: ``spacdc`` (``core/spacdc.py``), the baselines ``conv``,
``mds``, ``polynomial``, ``matdot``, ``lcc``, ``glcc``, ``secpoly`` and
``bacc`` (``core/baselines.py``) and the gradient code ``berrut_grad``
(``core/coded_training.py``).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["AnytimeDecode", "SchemeDefaults", "register", "build", "get",
           "names"]


@dataclasses.dataclass
class AnytimeDecode:
    """Result of decoding an in-flight round at an arbitrary responder
    prefix (the paper's no-minimum-wait claim, §V).

    ``ready`` is False when the scheme cannot decode this prefix at all
    (threshold schemes below their recovery threshold); ``decoded`` is the
    scheme's usual decoded-block stack otherwise.
    """
    ready: bool
    decoded: Optional[Any]
    n_responders: int


def _host(x) -> np.ndarray:
    """A tensor on any device, an array or a list, as numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _loo_scores(results, mask: np.ndarray, resp: np.ndarray,
                weights: np.ndarray, scored: np.ndarray) -> np.ndarray:
    """(N,) float64 leave-one-out scores: ``||r_i - pred_i|| / den`` for the
    responders ``resp``, where ``pred = weights @ r[resp]`` ((R, R) float64,
    row a predicting responder ``resp[a]`` from the others, zero diagonal)
    and ``den`` is the MEDIAN responder norm.  One float64 product on the
    results' device; only the responders' rows are read, so masked-out
    garbage (NaN from a tampered ciphertext) never enters.  Responders not
    ``scored`` and non-responders score 0."""
    scores = np.zeros(mask.size, np.float64)
    if resp.size == 0:
        return scores
    x = torch.as_tensor(results)
    idx = torch.from_numpy(resp).to(x.device)
    flat = x.reshape(mask.size, -1)[idx].double()            # (R, F)
    norms = torch.linalg.vector_norm(flat, dim=1).cpu().numpy()
    den = max(float(np.median(norms)), 1e-12)
    pred = torch.from_numpy(weights).to(flat.device) @ flat
    resid = torch.linalg.vector_norm(flat - pred, dim=1).cpu().numpy()
    scores[resp] = np.where(scored, resid / den, 0.0)
    return scores


class SchemeDefaults:
    """Mixin supplying what the schemes share: the fused round, the generic
    masked decode, the wait policy and the output layout.  Subclasses set
    ``name`` / ``n_workers`` / ``recovery_threshold`` and the encoder."""

    name: str = "base"
    pair_coded: bool = False
    rateless: bool = False
    use_kernel: Optional[bool] = None   # None = kernel for CUDA tensors

    # -- coding ----------------------------------------------------------
    def encode(self, x, noise=None):
        raise NotImplementedError(
            f"{self.name}: pair-coded scheme — use encode_pair(a, b)")

    def encode_pair(self, a, b):
        raise NotImplementedError(
            f"{self.name}: data-coded scheme — use encode(x)")

    def decode_masked(self, results, mask):
        """Default masked decode for concrete masks: gather the responder
        subset and defer to ``decode``.  Rateless schemes with a runtime
        masked decode override this (SPACDC)."""
        resp = np.flatnonzero(_host(mask))
        idx = torch.from_numpy(resp).to(results.device)
        return self.decode(results[idx], resp)

    # -- fused round (linear data-coded schemes) -------------------------
    def fused_encoder_matrix(self):
        """(N, J) data-independent linear encoder over the scheme's J
        stacked input blocks, or None when encoding is not such a map."""
        return None

    def fused_blocks(self, a, noise=None):
        """Stack the J input blocks ``fused_encoder_matrix`` contracts:
        (m, d) -> (J, blk, d), including any appended noise blocks."""
        raise NotImplementedError(
            f"{self.name}: scheme has no fused block layout")

    @property
    def fused_out_blocks(self) -> int:
        """How many decoded blocks ``decode_matrix_masked`` yields (K)."""
        return getattr(self, "k_blocks", self.n_workers)

    @property
    def supports_fused(self) -> bool:
        return self.fused_encoder_matrix() is not None

    @property
    def fused_decode_stable(self) -> bool:
        """Whether the masked decode is trustworthy in f32: rateless schemes
        decode with their own renormalizing interpolant (always stable);
        others need an encoder condition number below 1e6."""
        if self.rateless:
            return True
        cached = self.__dict__.get("_fused_decode_stable")
        if cached is None:
            enc = self.fused_encoder_matrix()
            cached = enc is not None and bool(
                np.linalg.cond(np.asarray(enc, np.float64)) < 1e6)
            self.__dict__["_fused_decode_stable"] = cached
        return cached

    def decode_matrix_masked(self, mask):
        """(K, N) decode weights for a runtime responder mask.

        Default: least-squares inversion of the mask-zeroed encoder (float32,
        as in the reference) — non-responders get weight 0.  Rateless
        schemes override with their own interpolant (SPACDC).
        """
        enc = self.fused_encoder_matrix()
        if enc is None:
            raise NotImplementedError(
                f"{self.name}: no masked decode")
        mask = torch.as_tensor(mask, dtype=torch.float32)
        enc_m = torch.as_tensor(enc, dtype=torch.float32) * mask[:, None]
        return torch.linalg.pinv(enc_m)[: self.fused_out_blocks]

    def fused_round(self, a, b, mask, noise=None):
        """The whole round on the device: encode the input blocks and run
        all N worker matmuls in one ``coded_matmul`` launch, then the masked
        decode in one ``berrut_combine`` launch.  Returns the decoded
        (K, blk, n_out) blocks (``reconstruct_matmul`` undoes the layout).
        ``noise`` optionally supplies the T noise blocks (see
        ``fused_blocks``)."""
        from ..kernels.ops import coded_matmul
        enc = self.fused_encoder_matrix()
        if enc is None:
            raise NotImplementedError(f"{self.name}: no fused round path")
        # the decode weights are host math on the (concrete) mask; moving
        # them to the device before the launches keeps their copy from
        # waiting on the round's kernels
        dec = self.decode_matrix_masked(mask).to(a.device)
        blocks = self.fused_blocks(a, noise)
        results = coded_matmul(enc, blocks, b, force_kernel=self.use_kernel)
        return self._combine(dec, results)

    # -- runtime contract ------------------------------------------------
    @property
    def min_responders(self) -> int:
        """Smallest responder prefix the scheme can decode at all."""
        return 1 if self.rateless else int(self.recovery_threshold)

    # -- anytime (progressive) decoding ----------------------------------
    def anytime_decode(self, results_so_far, mask) -> AnytimeDecode:
        """Decode an in-flight round at an arbitrary responder prefix.

        ``results_so_far``: (N, ...) worker results with non-responder
        slots holding anything; ``mask``: (N,) responder mask.  Rateless
        schemes decode any non-empty prefix; threshold schemes report
        ``ready=False`` below their recovery threshold.
        """
        n = int(_host(mask).astype(bool).sum())
        if n < self.min_responders:
            return AnytimeDecode(ready=False, decoded=None, n_responders=n)
        return AnytimeDecode(ready=True,
                             decoded=self.decode_masked(results_so_far, mask),
                             n_responders=n)

    def prefix_decode_weights(self, arrival_order):
        """Stacked decode weights for EVERY prefix of a concrete arrival
        order: ``(E, K, N)`` float32 numpy + ``(E,)`` ready flags, E =
        len(order).

        ``weights[p-1] @ results`` decodes the first-p-arrivals prefix, so
        a whole round's anytime curve is ONE batched contraction
        (``kernels.ops.prefix_decode``).  Built on the host in float64, as
        the reference builds it: the float64 ``pinv`` keeps large-K
        Vandermonde prefixes exact where a float32 inverse would drown in
        conditioning noise.  Prefixes below ``min_responders`` get zero
        weights and ``ready=False``.
        """
        enc = self.fused_encoder_matrix()
        if enc is None:
            raise NotImplementedError(
                f"{self.name}: no linear encoder — no prefix decode stack")
        enc = _host(enc).astype(np.float64)
        n = enc.shape[0]
        order = np.asarray(arrival_order, dtype=np.int64)
        k_out = self.fused_out_blocks
        weights = np.zeros((order.size, k_out, n), np.float32)
        ready = np.zeros(order.size, bool)
        masked = np.zeros_like(enc)
        for p in range(1, order.size + 1):
            masked[order[p - 1]] = enc[order[p - 1]]
            if p < self.min_responders:
                continue
            weights[p - 1] = np.linalg.pinv(masked)[:k_out].astype(np.float32)
            ready[p - 1] = True
        return weights, ready

    def anytime_proxy_weights(self, arrival_order, fh_degree: int = 2):
        """Optional second decoder stack for the embedded-pair error proxy
        (``(E, K, N)`` weights + ``(E,)`` valid flags), or None.

        Rateless schemes return a higher-order decode here (SPACDC:
        Floater–Hormann of blending degree ``fh_degree``) whose
        disagreement with the primary decode estimates the primary's
        error.  Threshold schemes decode exactly once past their
        threshold, so they have no embedded pair: the engine prices their
        prefixes 0 (ready) / inf (not).
        """
        return None

    # -- Byzantine screening ---------------------------------------------
    def decode_residuals(self, results, mask) -> np.ndarray:
        """Leave-one-out consistency score per responder: (N,) float64.

        For each responder i, predict its result from the OTHER responders
        through the encoder's row space (float64 masked pinv, on the host
        as in the reference) and score ``||r_i − pred_i||`` relative to the
        MEDIAN responder norm, which stays at signal scale however many
        corrupters pollute the predictions.  Responders whose
        leave-one-out subset falls below ``min_responders`` score 0
        (unscoreable); non-responder slots score 0.  ``results`` (N, ...)
        is a tensor on any device (or an array); the predictions are one
        float64 product there (``_loo_scores``).
        """
        enc = self.fused_encoder_matrix()
        if enc is None:
            raise NotImplementedError(
                f"{self.name}: no linear encoder — no leave-one-out "
                "residual screen")
        enc = _host(enc).astype(np.float64)
        mask = _host(mask).astype(bool)
        resp = np.flatnonzero(mask)
        weights = np.zeros((resp.size, resp.size), np.float64)
        scored = np.zeros(resp.size, bool)
        for a, i in enumerate(resp):
            loo = mask.copy()
            loo[i] = False
            if int(loo.sum()) < self.min_responders:
                continue
            row = enc[i] @ np.linalg.pinv(enc * loo[:, None])   # (N,)
            weights[a] = row[resp]
            weights[a, a] = 0.0
            scored[a] = True
        return _loo_scores(results, mask, resp, weights, scored)

    def wait_policy(self, n_stragglers: int = 0) -> int:
        if self.rateless:
            # no threshold: wait for everyone who isn't straggling
            return max(self.n_workers - n_stragglers, 1)
        return self.recovery_threshold

    def reconstruct_matmul(self, decoded, m: int, n: int):
        """Row-block layout (K, m/K, n) -> (m, n); also covers schemes whose
        decode already yields a 2-D product."""
        return decoded.reshape(-1, decoded.shape[-1])[:m, :n]

    # -- the one contraction every scheme shares -------------------------
    def _combine(self, weights, blocks):
        """out[q] = Σ_j W[q, j]·blocks[j] through the kernel dispatcher."""
        from ..kernels.ops import berrut_combine
        return berrut_combine(weights, blocks, force_kernel=self.use_kernel)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str, factory: Optional[Callable[..., Any]] = None):
    """Register ``factory`` under ``name`` (usable as a decorator).

    The factory receives the subset of :func:`build`'s kwargs its signature
    declares, so schemes with different knobs share one call site.
    """
    key = name.lower()

    def _register(f):
        if key in _REGISTRY:
            raise ValueError(f"coding scheme {key!r} already registered")
        _REGISTRY[key] = f
        return f

    return _register(factory) if factory is not None else _register


def names() -> list:
    """Registered scheme names, sorted."""
    return sorted(_REGISTRY)


def get(name: str) -> Callable[..., Any]:
    key = str(name).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown coding scheme {name!r}; registered: "
                       f"{', '.join(names())}")
    return _REGISTRY[key]


def build(name: str, **cfg):
    """Construct a registered scheme, dropping kwargs its factory doesn't
    take — so a runtime can pass its full config to any scheme name.
    ``use_kernel`` is set post-construction so every scheme gains the flag
    without declaring it."""
    factory = get(name)
    use_kernel = cfg.pop("use_kernel", None)
    params = inspect.signature(factory).parameters
    if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
        cfg = {k: v for k, v in cfg.items() if k in params}
    try:
        scheme = factory(**cfg)
    except TypeError as e:
        raise TypeError(f"building coding scheme {name!r}: {e}") from e
    if use_kernel is not None:
        scheme.use_kernel = use_kernel
    return scheme
