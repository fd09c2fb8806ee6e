"""Step functions: the train step (gradient accumulation, coded or
uncoded aggregation, the optimizer) and the one-token serve step.

Ports ``repro/launch/steps.py``: ``reshape_for_blocks``, ``_micro``,
``build_train_step``, ``build_mask_fn`` and ``build_serve_step``.

Coded aggregation: the global batch is viewed as ``n_blocks`` microbatch
blocks, and the gradient is the Berrut decode of the per-block gradients
under the runtime responder mask, by the weighted-loss identity

    Σ_n w_n(mask) · ∇L(D_n)  =  ∇ Σ_n w_n(mask) · L(D_n),
    w = decoder_weights(mask) * mask.

The reference takes one backward of the weighted sum over a ``vmap`` of
the blocks.  The port runs one backward per block, each ``w_n · L(D_n)``
in turn, accumulating into the parameters' ``.grad``: by linearity the
same gradient, holding one block's activations at a time instead of
``n_blocks``'.  With ``redundancy > 1`` shard i evaluates its cyclically
assigned blocks ``asn[i]`` weighted by its encoder row; the port folds
the weights of each block over the shards that hold it (``Σ w_i ·
erow[i, j]`` where ``asn[i, j] = n``) and runs one backward per block.
Every block's backward runs, a masked one (w = 0) too, as every block's
gradient is computed in the reference's ``vmap``.

On a device mesh (``dp_axes`` names the data axis, or the tuple of
axes such as ("pod", "data"), of the mesh that ``launch.mesh.use_mesh``
installed) each dp rank is one coded shard, as the reference's ``vmap``
with ``spmd_axis_name=dp_axes`` places one block per data device: rank
``idx`` (its row-major index over the dp axes) runs the backward of its
own blocks (with ``redundancy > 1`` its ``assignment()`` row, each
weighted by its ``encode_local`` encoder row), its gradient's local
shards are settled on ``model`` (a partial sum all-reduced, then split
locally) and decoded over the dp axes by ``core.coded_psum``: Σ_idx
w_idx mask_idx g_idx, the same weighted sum the single-device step takes
by the weighted-loss identity, here as a real collective.  Uncoded
(``gcode=None``, the reference's ``uncoded_grads``) rank ``idx`` takes
its 1/n of each micro-batch's rows and the mean gradient is an
all-reduce over the dp axes.  ``compress`` rounds each decoded gradient
through int8, its scale the max over the whole leaf (a DTensor
reduction over every rank that holds a part of it).

The parameters are placed by ``dist.sharding.distribute_train_params``:
DTensors on the ``model`` submesh (``param_specs``), and, for FSDP, the
layer leaves whose specs name ``data`` on the whole mesh, gathered for
each use of their layer (``models.transformer``); their gradients come
back as this rank's whole-leaf ``Partial`` and ``coded_psum`` scatters
them (a coded reduce-scatter), so every gradient keeps its parameter's
placement.  ZeRO-1 follows from the optimizer state's placement
(``optim.place_state``).  ``build_train_step`` takes no argument for
either: both follow from where the parameters and the moments lie.  The
reference's ``shard_hint`` on the duplicated blocks has no counterpart:
each rank reads its own blocks from the batch every rank holds.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import BerrutGradientCode, registry
from ..optim.optimizers import Optimizer

__all__ = ["reshape_for_blocks", "build_train_step", "build_mask_fn",
           "build_serve_step"]


def reshape_for_blocks(batch: dict, n_blocks: int, accum: int) -> dict:
    """(B, ...) -> (n_blocks, accum, B/(n_blocks*accum), ...) on dim 0.

    For n_blocks == 1 (plain data parallelism) microbatch a takes rows a,
    accum + a, 2 accum + a, ..., as the reference's reshape-then-transpose
    (which keeps the microbatch dim the sharded one there).
    ``mrope_positions`` carries its stream dim first.
    """
    def rs(name, x):
        if name == "mrope_positions":
            s, b = x.shape[0], x.shape[1]
            return x.reshape(s, n_blocks, accum, b // (n_blocks * accum),
                             *x.shape[2:])
        b = x.shape[0]
        mb = b // (n_blocks * accum)
        if n_blocks == 1:
            y = x.reshape(mb, accum, *x.shape[1:])
            return y.transpose(0, 1)[None]
        return x.reshape(n_blocks, accum, mb, *x.shape[1:])
    return {k: rs(k, v) for k, v in batch.items()}


def _micro(batch_blocks: dict, a: int) -> dict:
    """Accumulation slice a: every leaf (n_blocks, mb, ...)."""
    return {k: (v[:, :, a] if k == "mrope_positions" else v[:, a])
            for k, v in batch_blocks.items()}


def _block(micro: dict, n: int) -> dict:
    """Block n of a microbatch: every leaf (mb, ...)."""
    return {k: (v[:, n] if k == "mrope_positions" else v[n])
            for k, v in micro.items()}


def _merged(micro: dict) -> dict:
    """A microbatch's blocks merged back into one flat batch."""
    return {k: (v.reshape(v.shape[0], -1, *v.shape[3:])
                if k == "mrope_positions" else v.reshape(-1, *v.shape[2:]))
            for k, v in micro.items()}


def _stacked_leaves(model) -> dict:
    """{the reference's leaf: [the port's parameter names in it]}.  The
    reference stacks its scanned layers, one leaf per group position
    (``groups.pos<i>.<path>`` over layers n_pre + g * period + i) and, for
    the encoder-decoder, one per encoder and decoder path; every other
    parameter is a leaf of its own."""
    out: dict = {}
    n_pre, period = getattr(model, "n_pre", 0), getattr(model, "period", 1)
    for name, _ in model.named_parameters():
        head, _, rest = name.partition(".")
        idx, _, path = rest.partition(".")
        if head == "layers" and int(idx) >= n_pre:
            key = f"groups.pos{(int(idx) - n_pre) % period}.{path}"
        elif head in ("encoder", "decoder"):
            key = f"{head}.{path}"
        else:
            key = name
        out.setdefault(key, []).append(name)
    return out


def build_train_step(model, optimizer: Optimizer, *, accum: int = 1,
                     gcode: Optional[BerrutGradientCode] = None,
                     compress: bool = False, dp_axes=None):
    """Returns train_step(params, opt_state, batch, mask) -> (params,
    opt_state, metrics).

    ``params`` is ``dict(model.named_parameters())``: the model's own
    tensors, which the step updates in place (``update_in_place``) and
    returns; their ``.grad`` holds the step's gradient afterwards.
    ``batch`` leaves may lie on the CPU: they move to the parameters'
    device.  ``mask`` is the (n_shards,) responder mask (ignored
    uncoded).  ``metrics`` has ``loss`` (the mean of the microbatch
    losses; coded, of the blocks' unweighted losses) and ``step``.

    gcode=None -> the mean gradient over ``accum`` microbatches.
    gcode=...  -> Berrut-coded aggregation over gcode.n_shards blocks
                  (a ``BerrutGradientCode`` or a registry mapping such as
                  ``{"name": "berrut_grad", "n_shards": 8}``).
    compress   -> every gradient leaf through int8 compression and back
                  before the optimizer.  The reference's scale is per leaf
                  of its tree, where the scanned layers are stacked: the
                  port shares one scale over the layers of one reference
                  leaf (``dist.int8_compress_shared``), so its numbers are
                  the reference's.
    dp_axes    -> the mesh's data axis (``"data"``) or axes
                  (``("pod", "data")``).  While a mesh with them is
                  installed (``launch.mesh.use_mesh``) the step runs
                  sharded: a ``gcode``'s ``n_shards`` must equal the
                  product of the axes' sizes, and ``params`` are the
                  model's DTensors placed by ``dist.sharding.
                  distribute_train_params``.  Every rank passes the same
                  global ``batch`` and ``mask``; the loss is the mean
                  over ranks.  Without a mesh the step is the
                  single-device one.
    """
    if isinstance(gcode, dict):
        spec = dict(gcode)
        gcode = registry.build(spec.pop("name", "berrut_grad"), **spec)
    if compress:
        from ..dist.compression import int8_compress_shared, int8_decompress
        stacked = _stacked_leaves(model)
    model_params = dict(model.named_parameters())
    if gcode is not None and gcode.redundancy > 1:
        asn = np.asarray(gcode.assignment())                      # (nb, r)
        erow = np.take_along_axis(
            np.asarray(gcode.encoder_matrix(), np.float32), asn, axis=1)

    def block_weights(mask, dev) -> torch.Tensor:
        """Each block's weight in the step's gradient: the decode weights
        w, folded over the shards holding the block when redundant."""
        mask_t = torch.as_tensor(mask).to(device=dev, dtype=torch.float32)
        w = gcode.decoder_weights(mask_t) * mask_t
        if gcode.redundancy == 1:
            return w
        coef = w[:, None] * torch.as_tensor(erow, device=dev)   # (nb, r)
        out = torch.zeros(gcode.n_blocks, dtype=torch.float32, device=dev)
        return out.index_add_(0, torch.as_tensor(asn.reshape(-1),
                                                 device=dev),
                              coef.reshape(-1))

    def coded_loss(micro: dict, w: torch.Tensor) -> torch.Tensor:
        """One backward per block of ``w_n · L(D_n)``; returns the mean of
        the unweighted losses the reference reports (per shard, the mean
        over its assigned blocks)."""
        losses = []
        for n in range(w.shape[0]):
            loss, _ = model.loss_fn(_block(micro, n))
            (w[n] * loss).backward()
            losses.append(loss.detach())
        losses = torch.stack(losses)
        if gcode.redundancy > 1:
            losses = losses[torch.as_tensor(asn, device=losses.device)
                            ].mean(dim=1)
        return losses.mean()

    def mesh_axes():
        """(the installed mesh, the dp axes as a tuple) when a mesh that
        has them is installed, else (None, None)."""
        from ..dist.sharding import ambient_mesh
        mesh = ambient_mesh()
        if mesh is None or dp_axes is None:
            return None, None
        axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
        if not axes or any(not isinstance(a, str) or
                           a not in mesh.mesh_dim_names for a in axes):
            raise ValueError(f"dp_axes {dp_axes!r} are not axes of the "
                             f"mesh {mesh.mesh_dim_names}")
        return mesh, axes

    def rank_rows(micro: dict, idx: int, n: int) -> dict:
        """Rank ``idx``'s 1/n of a merged micro-batch's rows (the
        uncoded step's batch over the dp axes)."""
        def rows(k, v):
            d = 1 if k == "mrope_positions" else 0
            m = v.shape[d] // n
            return v.narrow(d, idx * m, m)
        return {k: rows(k, v) for k, v in micro.items()}

    def sharded_step(mesh, axes, params, opt_state, batch, mask):
        from ..core.coded_training import coded_psum, dp_reduce
        from ..dist import collectives
        from ..dist.sharding import dp_group, dp_index, is_fsdp
        n_data = 1
        for a in axes:
            n_data *= mesh.size(mesh.mesh_dim_names.index(a))
        if gcode is not None and gcode.n_shards != n_data:
            raise ValueError(f"gcode.n_shards {gcode.n_shards} != the "
                             f"{'x'.join(axes)} axis size {n_data}")
        idx = dp_index(mesh, axes)
        if gcode is None:
            rows, ew = [0], [1.0]
        elif gcode.redundancy > 1:
            rows, ew = asn[idx], erow[idx]
        else:
            rows, ew = [idx], [1.0]
        dev = next(iter(params.values())).device
        blocks = reshape_for_blocks(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
            gcode.n_shards if gcode is not None else 1, accum)
        for p in params.values():
            p.grad = None
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(accum):
            micro = _micro(blocks, a)
            if gcode is None:
                micro = {k: v[:, None] if k == "mrope_positions" else
                         v[None] for k, v in
                         rank_rows(_merged(micro), idx, n_data).items()}
            losses = []
            for j, n in enumerate(rows):
                loss, _ = model.loss_fn(_block(micro, int(n)))
                (float(ew[j]) * loss).backward()
                losses.append(loss.detach().to_local().to(torch.float32))
            total = total + torch.stack(losses).mean()
        with torch.no_grad():
            # leaf by leaf, each gradient freed as its reduction is made,
            # so one leaf's temporaries at a time
            for name, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                # an FSDP leaf's gradient stays this rank's whole one (a
                # Partial over the dp axes) for the reduce-scatter below
                g = g / accum if is_fsdp(p) else \
                    (g / accum).redistribute(p.device_mesh, p.placements)
                if gcode is None:
                    g = dp_reduce({name: g}, 1.0 / n_data, axes,
                                  like={name: p})[name]
                else:
                    g = coded_psum({name: g}, mask, gcode, axes,
                                   like={name: p})[name]
                p.grad = g.to(p.dtype)
                del g
            if compress:
                _compress_grads(params)
            mean = (total / accum).reshape(1)
            collectives.all_reduce(mean, "sum", dp_group(mesh, axes))
        opt_state = optimizer.update_in_place(
            {name: p.grad for name, p in params.items()}, opt_state, params)
        return params, opt_state, {"loss": mean[0] / n_data,
                                   "step": opt_state.step}

    def _compress_grads(params) -> None:
        """Every gradient through int8 and back, one scale per reference
        leaf (``_stacked_leaves``); on a mesh the scale's max runs over
        the whole leaf (a DTensor reduction)."""
        for names in stacked.values():
            qs, scale = int8_compress_shared(
                [params[n].grad for n in names])
            for n, q in zip(names, qs):
                params[n].grad = int8_decompress(q, scale).to(
                    params[n].dtype)

    def train_step(params, opt_state, batch, mask):
        mesh, axes = mesh_axes()
        if mesh is not None:
            return sharded_step(mesh, axes, params, opt_state, batch, mask)
        if params.keys() != model_params.keys() or any(
                params[k] is not model_params[k] for k in params):
            raise ValueError("params must be dict(model.named_parameters()): "
                             "the step updates the model's own tensors")
        dev = next(iter(params.values())).device
        nb = gcode.n_shards if gcode else 1
        blocks = reshape_for_blocks(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
            nb, accum)
        for p in params.values():
            p.grad = None
        total = torch.zeros((), dtype=torch.float32, device=dev)
        w = block_weights(mask, dev) if gcode else None
        for a in range(accum):
            micro = _micro(blocks, a)
            if gcode:
                total = total + coded_loss(micro, w)
            else:
                loss, _ = model.loss_fn(_merged(micro))
                loss.backward()
                total = total + loss.detach()
        with torch.no_grad():
            for p in params.values():
                p.grad = (p.grad / accum if p.grad is not None
                          else torch.zeros_like(p))
            if compress:
                _compress_grads(params)
        grads = {name: p.grad for name, p in params.items()}
        opt_state = optimizer.update_in_place(grads, opt_state, params)
        return params, opt_state, {"loss": total / accum,
                                   "step": opt_state.step}

    return train_step


def build_mask_fn(gcode: BerrutGradientCode | dict, straggler,
                  wait_policy=None) -> Callable[[int], np.ndarray]:
    """Per-round responder masks for the coded train step, from the wait
    policies the round runtime uses (``runtime.wait_policy``):
    ``mask_fn(round_idx) -> (n_shards,)`` float32 numpy.  FixedQuantile
    (the default) drops the stragglers; Deadline and FirstK shrink the
    mask; ErrorTarget uses the decode-weight-stability proxy
    (``runtime.scheduler.policy_mask_fn``)."""
    from ..runtime.scheduler import policy_mask_fn
    if isinstance(gcode, dict):
        spec = dict(gcode)
        gcode = registry.build(spec.pop("name", "berrut_grad"), **spec)
    return policy_mask_fn(gcode._code, straggler, policy=wait_policy)


def build_serve_step(model, *, return_hidden: bool = False):
    """serve_step(params, cache, tokens, pos[, mrope_positions]) ->
    (next_tokens (B, 1) int32, cache), under ``torch.inference_mode()``
    (``torch.no_grad()`` while a mesh is installed).

    ``params`` is accepted for the reference's signature and not read: the
    model holds its parameters.  The cache is written in place.
    ``return_hidden=True`` yields the final-norm hidden state instead of
    tokens (the coded serving path runs the unembed as a round)."""

    def serve_step(params, cache, tokens, pos, mrope_positions=None):
        from ..dist.sharding import ambient_mesh
        # on a mesh under no_grad: DTensor's view rules (unflatten) fail
        # under inference_mode
        grad_free = torch.no_grad() if ambient_mesh() is not None \
            else torch.inference_mode()
        with grad_free:
            if model.cfg.encoder_decoder:
                out, cache = model.decode_step(cache, tokens, pos,
                                               return_hidden=return_hidden)
            else:
                out, cache = model.decode_step(
                    cache, tokens, pos, mrope_positions=mrope_positions,
                    return_hidden=return_hidden)
            if return_hidden:
                return out, cache
            last = out[:, -1:]
            if ambient_mesh() is not None:
                # the vocabulary whole on each rank first: DTensor's own
                # argmax over a sharded dim fails on a 3-d mesh
                from ..dist.sharding import DP_AXES, P, gathered
                last = gathered(last, P(DP_AXES, None, None))
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step
