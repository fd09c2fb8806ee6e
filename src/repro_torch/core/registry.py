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

Registered so far: ``spacdc`` (``core/spacdc.py``) and the baselines
``conv``, ``mds``, ``polynomial`` and ``matdot`` (``core/baselines.py``);
LCC, GLCC, SecPoly, BACC and ``berrut_grad`` come later (see ROADMAP.md).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["SchemeDefaults", "register", "build", "get", "names"]


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
