"""Carry the JAX package's model parameters into the port.

``load_jax_params(model, tree)`` takes the reference's ``TransformerLM`` or
``EncDecLM`` parameter pytree as nested dicts and lists of numpy arrays (a
caller with JAX makes it with ``jax.tree.map(np.asarray, params)``; the
port itself never sees JAX) and copies it into the port's model of the
same kind.

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
Qwen2-VL's tree is the dense one (M-RoPE has no parameters).

The encoder-decoder's ``encoder`` leaves are stacked over its
``n_encoder_layers`` and its ``decoder`` leaves over ``n_layers``:
``encoder.<g>.<leaf>`` is ``encoder[leaf][g]``, ``decoder.<g>.<leaf>``
likewise; ``embedding``, ``enc_norm`` and ``final_norm`` keep their
layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .encdec import EncDecLM
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


def _unstack(where: str, node, n: int, name_of,
             flat: Dict[str, np.ndarray]) -> None:
    """Every leaf of ``node``, stacked on a leading axis of ``n``, as
    ``flat[name_of(g, leaf path)] = leaf[g]``."""
    stacked: Dict[str, np.ndarray] = {}
    _flatten("", node, stacked)
    for name, arr in stacked.items():
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"{where}.{name}: leading axis {arr.shape[:1]} "
                             f"is not the model's {n}")
        for g in range(n):
            flat[name_of(g, name)] = arr[g]


def _layer_leaves(model, tree: Mapping) -> Dict[str, np.ndarray]:
    """The reference's pytree as {port parameter name: array}."""
    stacks = ({"encoder": len(model.encoder), "decoder": len(model.decoder)}
              if isinstance(model, EncDecLM) else {})
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if key in stacks:
            _unstack(key, node, stacks[key],
                     lambda g, name, key=key: f"{key}.{g}.{name}", flat)
        elif key not in ("prelude", "groups"):
            _flatten(key, node, flat)
    for j, layer in enumerate(tree.get("prelude", [])):
        _flatten(f"layers.{j}", layer, flat)
    for pos, group in tree.get("groups", {}).items():
        i = int(str(pos).removeprefix("pos"))
        _unstack(f"groups.{pos}", group, model.n_groups,
                 lambda g, name: f"layers."
                 f"{model.n_pre + g * model.period + i}.{name}", flat)
    return flat


def load_jax_params(model: TransformerLM | EncDecLM,
                    tree: Mapping) -> TransformerLM | EncDecLM:
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
