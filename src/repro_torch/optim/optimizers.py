"""Optimizers over trees of tensors: AdamW, SGD with momentum, the
warmup-cosine schedule and global-norm clipping.

Ports ``repro/optim/optimizers.py`` with its interface::

    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params`` and ``grads`` are dicts (or nested dicts, lists, NamedTuples)
of tensors, leaves in ``jax.tree`` order (``repro_torch.tree``); ``mu``
and ``nu`` are float32 trees of the same structure and ``step`` an int32
scalar tensor.  The schedules compute in float32, as the reference's.

At full width the reference's whole-tree temporaries do not fit beside
the model: phi3-mini's float32 parameters, gradients, ``mu`` and ``nu``
already take 61 GB of the card's 80, and a separate update tree would add
15 GB more.  So ``Optimizer.update_in_place(grads, state, params)``, the
update the trainer runs, applies one leaf at a time under
``torch.no_grad()``: the clip scale, then ``mu``, ``nu`` and the
parameter, written into their own tensors.  It runs the functional
update's arithmetic leaf for leaf (the same per-leaf function), so its
numbers are the functional update's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from .. import tree as tree_util

__all__ = ["OptState", "Optimizer", "adamw", "sgdm", "apply_updates",
           "clip_by_global_norm", "warmup_cosine", "global_norm"]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    update_in_place: Callable


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in jax order, of each leaf's sum of
    squares (float32)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_util.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(tree, max_norm: float):
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled so its global norm is at most ``max_norm``, the
    norm before scaling)."""
    scale, norm = _clip_scale(tree, max_norm)
    return tree_util.tree_map(lambda g: g * scale, tree), norm


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """step -> learning rate (float32): linear warmup to ``peak_lr``, then
    a cosine to ``final_frac * peak_lr`` at ``total_steps``."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros placed as ``p`` (a DTensor's state keeps its
    placements)."""
    return torch.zeros_like(p, dtype=torch.float32)


def _first_device(tree):
    flat = tree_util.leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


def _run(leaf_fn, grads, state, params, clip: float, in_place: bool):
    """The shared loop: clip scale, the step's constants, then
    ``leaf_fn(g, m, v, p, consts) -> (m, v, update)`` leaf by leaf;
    returns (updates or None, new state)."""
    scale = _clip_scale(grads, clip)[0] if clip else None
    step = state.step + 1
    consts = (step, step.to(torch.float32))
    g_l = tree_util.leaves(grads)
    m_l = tree_util.leaves(state.mu)
    v_l = tree_util.leaves(state.nu) if state.nu is not None else \
        [None] * len(g_l)
    p_l = tree_util.leaves(params)
    if not len(g_l) == len(m_l) == len(v_l) == len(p_l):
        raise ValueError("grads, state and params differ in structure")
    ms, vs, us = [], [], []
    for g, m, v, p in zip(g_l, m_l, v_l, p_l):
        if scale is not None:
            g = g * scale
        m_new, v_new, upd = leaf_fn(g, m, v, p, consts)
        if in_place:
            m.copy_(m_new)
            if v is not None:
                v.copy_(v_new)
            p.add_(upd)
            del m_new, v_new, upd
        else:
            ms.append(m_new)
            vs.append(v_new)
            us.append(upd)
    if in_place:
        return None, OptState(step, state.mu, state.nu)
    mu = tree_util.unflatten(state.mu, ms)
    nu = tree_util.unflatten(state.nu, vs) if state.nu is not None else None
    return tree_util.unflatten(params, us), OptState(step, mu, nu)


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        dev = _first_device(params)
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        tree_util.tree_map(_zeros_f32, params),
                        tree_util.tree_map(_zeros_f32, params))

    def leaf(g, m, v, p, consts):
        step, t = consts
        gf = g.to(torch.float32)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * torch.square(gf)
        lr_t = lr_fn(step)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        mhat, vhat = m / bc1, v / bc2
        u = mhat / (torch.sqrt(vhat) + eps) + \
            weight_decay * p.to(torch.float32)
        return m, v, (-lr_t * u).to(p.dtype)

    def update(grads, state, params):
        return _run(leaf, grads, state, params, max_grad_norm, False)

    @torch.no_grad()
    def update_in_place(grads, state, params):
        return _run(leaf, grads, state, params, max_grad_norm, True)[1]

    return Optimizer(init, update, update_in_place)


def sgdm(lr: Callable | float, momentum=0.9,
         max_grad_norm: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        dev = _first_device(params)
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        tree_util.tree_map(_zeros_f32, params), None)

    def leaf(g, m, v, p, consts):
        m = momentum * m + g.to(torch.float32)
        return m, None, (-lr_fn(consts[0]) * m).to(p.dtype)

    def update(grads, state, params):
        return _run(leaf, grads, state, params, max_grad_norm, False)

    @torch.no_grad()
    def update_in_place(grads, state, params):
        return _run(leaf, grads, state, params, max_grad_norm, True)[1]

    return Optimizer(init, update, update_in_place)


def apply_updates(params, updates):
    return tree_util.tree_map(lambda p, u: p + u, params, updates)
