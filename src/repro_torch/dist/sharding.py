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
For training, ``distribute_train_params`` puts a leaf whose spec names no
data-parallel axis on the mesh's non-dp submesh (``model``), where each
data rank computes on its own blocks, and a leaf that does (FSDP) on the
whole mesh; ``gather_dp`` all-gathers such a leaf over its dp axes for
one use (the backward hands the rank's whole gradient back as a
``Partial`` over them, for ``core.coded_psum`` to reduce-scatter);
``dp_group`` is the process group of one dp axis or of several
flattened row-major; ``zeros`` makes a placed zero tensor shard by shard.

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
    "is_distributed", "DP_AXES", "dp_group", "dp_index", "zeros",
    "distribute_train_params", "gather_dp", "is_fsdp", "train_specs",
]

DP_AXES = ("pod", "data")


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


# --------------------------------------------------------------------------
# the data-parallel axes: groups, FSDP placement and its gather
# --------------------------------------------------------------------------

def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def dp_group(mesh, axis_name):
    """The process group over the mesh dims ``axis_name`` (a name or a
    tuple of names): the dim's own group for one, the row-major
    flattening's for several (``DeviceMesh._flatten``, built once)."""
    axes = _axes(axis_name)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def dp_index(mesh, axis_name) -> int:
    """This rank's row-major index over the mesh dims ``axis_name``, as
    ``jax.lax.axis_index`` over a tuple of axes."""
    idx = 0
    for a in _axes(axis_name):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def _local_shape(shape, mesh, placements) -> tuple:
    from torch.distributed.tensor import Shard
    out = list(shape)
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out[pl.dim] //= mesh.size(mdim)
    return tuple(out)


def zeros(shape, sharding: NamedSharding, dtype, device):
    """A zero DTensor of global ``shape`` placed by ``sharding``, made
    shard by shard (no global tensor, no communication)."""
    from torch.distributed.tensor import DTensor
    local = torch.zeros(_local_shape(shape, sharding.mesh,
                                     sharding.placements),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def _dp_mesh_dims(x) -> list:
    """(mesh dim, tensor dim) of each dp axis that shards DTensor ``x``."""
    from torch.distributed.tensor import Shard
    names = tuple(x.device_mesh.mesh_dim_names)
    return [(m, pl.dim) for m, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and names[m] in DP_AXES]


def is_fsdp(x) -> bool:
    """A DTensor sharded over a data-parallel mesh axis."""
    return is_distributed(x) and bool(_dp_mesh_dims(x))


def _non_dp(mesh, placements):
    """(the submesh of ``mesh``'s non-dp dims, the placements there)."""
    keep = [m for m, a in enumerate(mesh.mesh_dim_names) if a not in DP_AXES]
    names = tuple(mesh.mesh_dim_names[m] for m in keep)
    sub = mesh[names] if names != tuple(mesh.mesh_dim_names) else mesh
    return sub, tuple(placements[m] for m in keep)


def distribute_train_params(model, mesh, specs: Optional[dict] = None):
    """``distribute_params`` for the data-parallel train step: a leaf
    whose resolved spec names a dp axis (FSDP: ``tree_add_data_axis`` on
    the layers) is placed on ``mesh``; every other leaf on the submesh of
    ``mesh``'s non-dp dims (``mesh["model"]``), where each data rank
    computes on its own blocks.  Returns the model."""
    from torch import nn
    specs = model.param_specs() if specs is None else specs
    names = dict(model.named_parameters())
    if set(specs) != set(names):
        raise ValueError(f"specs and parameters differ: "
                         f"{sorted(set(specs) ^ set(names))}")
    for name, p in names.items():
        spec = resolve_spec(specs[name], tuple(p.shape), mesh)
        pl = placements_of(spec, mesh)
        target = mesh
        if not any(a in DP_AXES for e in spec for a in _entry_axes(e)):
            target, pl = _non_dp(mesh, pl)
        owner, _, leaf = name.rpartition(".")
        with torch.no_grad():
            placed = NamedSharding(target, spec, pl).distribute(p.detach())
        model.get_submodule(owner)[leaf] = nn.Parameter(
            placed, requires_grad=p.requires_grad)
    return model


def train_specs(model, *, fsdp: bool, zero1: bool) -> tuple:
    """(parameter specs, moment specs) of the data-parallel train step, by
    the reference dry run's rule: FSDP adds the data axis to every
    ``layers.<i>`` leaf (the port has no stacked layer axis to skip;
    embeddings, norms and the unembed stay TP-only) and the moments are
    placed as their parameters; without FSDP, ZeRO-1 adds it to every
    moment leaf (``tree_add_data_axis``).  With both asked for, FSDP
    wins and ZeRO-1 adds nothing, as in the reference."""
    shapes = dict(model.named_parameters())
    specs = dict(model.param_specs())
    if fsdp:
        layers = {k: v for k, v in specs.items() if k.startswith("layers.")}
        specs.update(tree_add_data_axis(layers,
                                        {k: shapes[k] for k in layers}))
    moments = tree_add_data_axis(specs, shapes) if zero1 and not fsdp \
        else specs
    return specs, moments


def _all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ``group``'s shards of ``t`` concatenated along ``dim``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    buf = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(buf, t.contiguous(), group=group)
    if dim == 0:
        return buf
    return torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0), dim=dim)


class _GatherDP(torch.autograd.Function):
    """An FSDP leaf all-gathered over its dp axes onto the non-dp submesh;
    the backward returns the rank's gradient of the whole leaf unreduced,
    a ``Partial`` over those axes (``core.coded_psum`` weights and
    reduce-scatters it once a step)."""

    @staticmethod
    def forward(ctx, p):
        from torch.distributed.tensor import DTensor
        mesh = p.device_mesh
        local = p.to_local()
        for mdim, dim in _dp_mesh_dims(p):
            local = _all_gather_dim(local, dim, mesh.get_group(mdim))
        sub, pl = _non_dp(mesh, p.placements)
        ctx.mesh, ctx.placements, ctx.sub, ctx.pl = mesh, p.placements, \
            sub, pl
        return DTensor.from_local(local, sub, pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial
        local = grad.redistribute(ctx.sub, ctx.pl).to_local()
        names = tuple(ctx.mesh.mesh_dim_names)
        pl = tuple(Partial() if names[m] in DP_AXES else p
                   for m, p in enumerate(ctx.placements))
        return DTensor.from_local(local, ctx.mesh, pl, run_check=False)


def gather_dp(x):
    """An FSDP leaf (``is_fsdp``) whole over its dp axes, on the non-dp
    submesh, for one use (a layer's forward, or its recompute); anything
    else as it is."""
    return _GatherDP.apply(x) if is_fsdp(x) else x
