"""Carry the JAX package's model parameters into the port.

``load_jax_params(model, tree)`` takes the reference's ``TransformerLM``
parameter pytree as nested dicts and lists of numpy arrays (a caller with
JAX makes it with ``jax.tree.map(np.asarray, params)``; the port itself
never sees JAX) and copies it into a ``models.TransformerLM``.

The reference stacks its scanned layers: every leaf under
``groups["pos{i}"]`` has a leading axis of G groups, and group g's leaf is
layer ``n_pre + g * period + i``; ``prelude[j]`` is layer j.  Every other
leaf keeps its layout: the port's parameters have the reference's shapes
(``wq`` (d, H, hd), ``wo`` (H, hd, d), ...), and its names are the pytree
paths joined by dots (``layers.<n>.mixer.wq``, ``embedding.table``).  Tied
embeddings have no ``unembed`` leaf on either side.  The SSM families
need nothing more: an rwkv layer's leaves are ``norm1``, ``norm2`` and its
``mixer``'s (no ``ffn``), and jamba's groups are stacked with period 8
(lcm of its attention period 8 and MoE period 2; 4 at tiny size).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import TransformerLM

__all__ = ["load_jax_params"]


def _flatten(prefix: str, node, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, Mapping):
        for key, value in node.items():
            _flatten(f"{prefix}.{key}" if prefix else str(key), value, out)
    elif isinstance(node, (list, tuple)):
        for i, value in enumerate(node):
            _flatten(f"{prefix}.{i}" if prefix else str(i), value, out)
    else:
        out[prefix] = np.asarray(node)


def _layer_leaves(model: TransformerLM,
                  tree: Mapping) -> Dict[str, np.ndarray]:
    """The reference's pytree as {port parameter name: array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if key not in ("prelude", "groups"):
            _flatten(key, node, flat)
    for j, layer in enumerate(tree.get("prelude", [])):
        _flatten(f"layers.{j}", layer, flat)
    for pos, group in tree.get("groups", {}).items():
        i = int(str(pos).removeprefix("pos"))
        stacked: Dict[str, np.ndarray] = {}
        _flatten("", group, stacked)
        for name, arr in stacked.items():
            if arr.ndim == 0 or arr.shape[0] != model.n_groups:
                raise ValueError(f"groups.{pos}.{name}: leading axis "
                                 f"{arr.shape[:1]} is not the model's "
                                 f"{model.n_groups} groups")
            for g in range(model.n_groups):
                n = model.n_pre + g * model.period + i
                flat[f"layers.{n}.{name}"] = arr[g]
    return flat


def load_jax_params(model: TransformerLM, tree: Mapping) -> TransformerLM:
    """Copy the reference's parameter pytree into ``model`` in place and
    return it.  Raises ``ValueError`` on a missing or extra leaf or a
    shape mismatch, before anything is copied."""
    flat = _layer_leaves(model, tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    for name, p in params.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(flat[name].shape)} does "
                             f"not match the model's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            src = torch.from_numpy(np.asarray(flat[name], np.float32))
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model
