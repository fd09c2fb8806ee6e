"""PartitionSpec utilities over ``torch.distributed``'s DTensor.

Ports ``repro/dist/sharding.py``.  The spec surgery is the reference's,
line for line, over the port's own spec type ``P`` (a tuple whose entries
are ``None``, a mesh axis name or a tuple of axis names; no JAX):

* ``prune_spec``         drop entries whose mesh-axis product does not
                         divide the dim (replicate the odd dim).
* ``resolve_spec``       pad a spec to an array's rank, drop axes the mesh
                         lacks, then prune.
* ``tree_shardings``     resolve a tree of specs against a tree of shapes
                         into ``NamedSharding``s: DTensor placements over a
                         ``DeviceMesh`` (``Shard(d)`` on every mesh dim that
                         entry d names, ``Replicate()`` elsewhere).
* ``add_data_axis``      shard the first free dim over ``data`` without
                         ever double-sharding.
* ``tree_add_data_axis`` the same over a (specs, shapes) pair.
* ``shard_hint``         redistribute a DTensor to a spec on the mesh that
                         ``use_mesh`` installed, identity otherwise, so the
                         models carry layout hints that are inert on one
                         device.  As ``with_sharding_constraint``, it
                         constrains the gradient too: the backward
                         redistributes the incoming gradient to the same
                         placements (a partial sum is all-reduced there).

The port's additions for eager execution on a mesh, which the reference's
compiler derives itself: ``distribute_params`` places a model's
parameters by its ``param_specs`` (each rank keeps its local shard; no
communication), and ``distribute`` places any tensor tree by specs.

Specs may contain tuple entries (``P(("pod", "data"), None)``); a tuple is
kept or dropped atomically.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tree import flatten, unflatten

__all__ = [
    "P", "NamedSharding", "prune_spec", "resolve_spec", "tree_shardings",
    "add_data_axis", "tree_add_data_axis", "shard_hint", "gathered",
    "ambient_mesh",
    "installed", "placements_of", "distribute", "distribute_params",
    "is_distributed",
]


def _canonical(entry):
    """A one-name tuple is that name and an empty one None, as
    ``jax.sharding.PartitionSpec`` normalizes them."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A PartitionSpec: one entry per array dim, each ``None``, a mesh axis
    name or a tuple of names.  ``P("data", None)`` as the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> dict:
    """name -> size for a ``DeviceMesh`` or a test double exposing
    ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)))
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def _entry_axes(entry) -> Tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _pad(spec, ndim: int) -> Tuple:
    entries = tuple(spec) if spec is not None else ()
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has rank {len(entries)} > array rank "
                         f"{ndim}")
    return entries + (None,) * (ndim - len(entries))


def _is_spec(leaf) -> bool:
    return isinstance(leaf, P)


def prune_spec(spec, shape: Sequence[int], mesh) -> P:
    """Replace entries whose mesh-axis-size product does not divide the
    corresponding dim with None (replicate that dim)."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, _pad(spec, len(shape))):
        axes = _entry_axes(entry)
        if not axes:
            out.append(None)
            continue
        total = int(np.prod([sizes.get(a, 1) for a in axes]))
        out.append(entry if total > 0 and dim % total == 0 else None)
    return P(*out)


def resolve_spec(spec, shape: Sequence[int], mesh) -> P:
    """Pad ``spec`` to ``len(shape)``, drop axes absent from ``mesh``, prune
    non-divisible dims.  The result always places an array of ``shape``
    on ``mesh``."""
    sizes = _axis_sizes(mesh)
    entries = []
    for entry in _pad(spec, len(shape)):
        axes = tuple(a for a in _entry_axes(entry) if a in sizes)
        if not axes:
            entries.append(None)
        elif not isinstance(entry, (tuple, list)):
            entries.append(axes[0])
        else:
            entries.append(axes)
    return prune_spec(P(*entries), shape, mesh)


def _zip_spec_tree(specs, shapes):
    """Flatten (specs, shapes) in lockstep; spec leaves are ``P``s (tuples,
    so a plain flatten would walk into them)."""
    leaves_sh, treedef = flatten(shapes)
    leaves_sp = flatten(specs, is_leaf=_is_spec)[0]
    if len(leaves_sp) != len(leaves_sh):
        raise ValueError(
            f"spec tree has {len(leaves_sp)} leaves, shape tree has "
            f"{len(leaves_sh)} — the trees must be congruent")
    return leaves_sp, leaves_sh, treedef


def placements_of(spec, mesh) -> tuple:
    """DTensor placements of a resolved ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that entry d names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for axis in _entry_axes(entry):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh and its DTensor placements: the port's
    counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P
    placements: tuple

    def distribute(self, tensor: torch.Tensor):
        """This rank's shard of the global ``tensor`` as a DTensor, in
        memory of its own (``tensor`` may be another process's, shared).
        Every rank holds the same global value, so no data moves."""
        from torch.distributed.tensor import DTensor, Shard
        local = tensor
        coord = self.mesh.get_coordinate()
        for mdim, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                n = self.mesh.size(mdim)
                local = local.chunk(n, dim=pl.dim)[coord[mdim]]
        local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False)


def tree_shardings(specs, mesh, shapes):
    """Tree of ``P``s + tree of shapes (tensors, meta tensors or anything
    with ``.shape``) -> tree (of the shapes' structure) of
    ``NamedSharding``s with unresolvable axes pruned."""
    leaves_sp, leaves_sh, treedef = _zip_spec_tree(specs, shapes)
    out = []
    for sp, sh in zip(leaves_sp, leaves_sh):
        spec = resolve_spec(sp, tuple(sh.shape), mesh)
        out.append(NamedSharding(mesh, spec, placements_of(spec, mesh)))
    return unflatten(treedef, out)


def add_data_axis(spec, shape: Sequence[int], dp_size: Optional[int] = None,
                  skip_dims: Iterable[int] = (), axis: str = "data") -> P:
    """Shard the first free (None) dim of ``spec`` over ``axis``.

    Never double-shards: if ``axis`` already appears anywhere in the spec
    (including inside tuple entries) the spec is returned unchanged.  When
    ``dp_size`` is given, only dims divisible by it qualify.  ``skip_dims``
    excludes dims that must stay replicated.
    """
    entries = list(_pad(spec, len(shape)))
    present = {a for e in entries for a in _entry_axes(e)}
    if axis in present:
        return P(*entries)
    skip = set(skip_dims)
    for d, (dim, entry) in enumerate(zip(shape, entries)):
        if d in skip or entry is not None:
            continue
        if dp_size is not None and (dp_size <= 0 or dim % dp_size):
            continue
        entries[d] = axis
        break
    return P(*entries)


def tree_add_data_axis(specs, shapes, skip_dims: Iterable[int] = (),
                       dp_size: Optional[int] = None, axis: str = "data"):
    """``add_data_axis`` over congruent (specs, shapes) trees.  Returns a
    tree of ``P``s with the shapes tree's structure."""
    leaves_sp, leaves_sh, treedef = _zip_spec_tree(specs, shapes)
    out = [add_data_axis(sp, tuple(sh.shape), dp_size=dp_size,
                         skip_dims=skip_dims, axis=axis)
           for sp, sh in zip(leaves_sp, leaves_sh)]
    return unflatten(treedef, out)


# --------------------------------------------------------------------------
# the ambient mesh and the layout hint
# --------------------------------------------------------------------------

_AMBIENT: List[Any] = []


def ambient_mesh():
    """The mesh installed by ``launch.mesh.use_mesh`` (innermost), or
    None."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def installed(mesh):
    """Install ``mesh`` as the ambient mesh for the block (``use_mesh``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def is_distributed(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Hint(torch.autograd.Function):
    """Redistribute to ``placements``; the gradient is redistributed to the
    same placements (the transpose of a sharding constraint)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def shard_hint(x, spec):
    """Constrain DTensor ``x`` to ``spec`` (resolved on x's own mesh) while
    a mesh is installed; identity otherwise (one device), as the
    reference's."""
    if ambient_mesh() is None or not is_distributed(x):
        return x
    mesh = x.device_mesh
    target = placements_of(resolve_spec(spec, tuple(x.shape), mesh), mesh)
    return _Hint.apply(x, target)


def gathered(x, spec):
    """``shard_hint`` whose gradient returns to ``x``'s own placements
    (DTensor's redistribute), for a gather whose backward should stay
    sharded: the vocab-sharded logits before the loss, whose gradient is
    then split locally, not summed.  Identity without a mesh."""
    if ambient_mesh() is None or not is_distributed(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements_of(
        resolve_spec(spec, tuple(x.shape), mesh), mesh))


def distribute(tree, specs, mesh):
    """A tree of global tensors, each identical on every rank, as DTensors
    placed by the congruent tree of ``specs`` on ``mesh`` (this rank's
    shards; no communication)."""
    shardings = tree_shardings(specs, mesh, tree)
    leaves, _ = flatten(tree)
    placed = [s.distribute(t)
              for s, t in zip(flatten(shardings, is_leaf=lambda n:
                                       isinstance(n, NamedSharding))[0],
                              leaves)]
    return unflatten(tree, placed)


def distribute_params(model, mesh, specs: Optional[dict] = None):
    """Replace every parameter of ``model`` by its DTensor on ``mesh``,
    placed by ``specs`` (default ``model.param_specs()``, keyed by
    parameter name).  Each rank keeps only its shard; the global values
    must be the same on every rank (a seeded ``build_model``, or
    parameters handed over from one process).  Returns the model."""
    from torch import nn
    specs = model.param_specs() if specs is None else specs
    names = dict(model.named_parameters())
    if set(specs) != set(names):
        raise ValueError(f"specs and parameters differ: "
                         f"{sorted(set(specs) ^ set(names))}")
    for name, p in names.items():
        spec = resolve_spec(specs[name], tuple(p.shape), mesh)
        sharding = NamedSharding(mesh, spec, placements_of(spec, mesh))
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        with torch.no_grad():
            placed = sharding.distribute(p.detach())
        module[leaf] = nn.Parameter(placed, requires_grad=p.requires_grad)
    return model
