"""The mesh's collectives, run in place and counted: how many, how many
bytes, and, when asked, how long.

The reference's collectives are XLA's, inserted by its partitioner.  On
the port's mesh they are ``torch.distributed``'s over gloo process groups
(NCCL allows one process per device, and a mesh of 8 ranks may share one
card): the ones DTensor issues when it redistributes, and the port's own
(``core.coded_psum``, ``models.attention._seq_sharded_attention``).

``InPlace`` is the dispatch mode that ``launch.mesh.use_mesh`` installs.
DTensor issues functional collectives (``_c10d_functional``); the mode
runs each through the same gloo group's in-place collective
(``torch.distributed.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``) and returns its result,
so the ``wait_tensor`` that follows finds no work left to wait for.  On
the H100 machine's torch (2.11) gloo's functional path took 7.3 s for a
4 KiB all-reduce over CUDA tensors and then hung on an all-gather, while
every in-place collective served CUDA tensors (``probe_cuda``).  The
in-place collectives the port calls itself (``c10d``) run as they are.
Every collective's count and input bytes go to ``stats()`` under its
name.  With ``timed=True`` the mode also times each one, the device
synchronized before and after: those seconds include no queued compute,
but the syncs stall the stream, so a timed step is slower than an
untimed one.  A functional collective the mode does not translate runs
as it is and is counted under ``functional_<name>``.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["InPlace", "stats", "reset", "all_reduce", "probe_cuda"]

_C10D = {"allreduce_": "all_reduce", "allgather_": "all_gather",
         "_allgather_base_": "all_gather_into_tensor",
         "allgather_into_tensor_coalesced_": "all_gather_into_tensor",
         "reduce_scatter_": "reduce_scatter",
         "_reduce_scatter_base_": "reduce_scatter_tensor",
         "broadcast_": "broadcast", "alltoall_base_": "all_to_all_single",
         "reduce_": "reduce", "gather_": "gather", "scatter_": "scatter",
         "barrier": "barrier"}

# the functional collectives (counted; the first five run in place)
_FUNCTIONAL = ("all_reduce", "all_reduce_", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single",
               "all_reduce_coalesced", "all_gather_into_tensor_out",
               "all_gather_into_tensor_coalesced",
               "reduce_scatter_tensor_coalesced", "broadcast", "broadcast_")

_STATS: Dict[str, Dict[str, float]] = collections.defaultdict(
    lambda: {"count": 0, "bytes": 0, "seconds": 0.0})


def stats() -> Dict[str, Dict[str, float]]:
    """{collective: {"count", "bytes", "seconds"}} since the last
    ``reset``, and "total" over them all ("seconds" only from a timed
    ``InPlace``, else 0)."""
    out = {k: dict(v) for k, v in _STATS.items()}
    out["total"] = {key: sum(v[key] for v in _STATS.values())
                    for key in ("count", "bytes", "seconds")}
    return out


def reset() -> None:
    _STATS.clear()


def _tensors(node) -> List[torch.Tensor]:
    if isinstance(node, torch.Tensor):
        return [node]
    if isinstance(node, (list, tuple)):
        return [t for child in node for t in _tensors(child)]
    return []


def _sync(tensors) -> None:
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def _group(name):
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name)
    return name


def _op(reduce_op: str):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[reduce_op.lower()]


def _in_place(base: str, args):
    """A functional collective through the in-place API (None when the
    meter does not translate ``base``)."""
    import torch.distributed as dist
    if base in ("all_reduce", "all_reduce_"):
        x, op, group = args[0], args[1], _group(args[2])
        out = x if base == "all_reduce_" else x.clone()
        dist.all_reduce(out, op=_op(op), group=group)
        return out
    if base == "all_gather_into_tensor":
        x, n, group = args[0].contiguous(), args[1], _group(args[2])
        out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    if base == "reduce_scatter_tensor":
        x, op, n, group = args[0].contiguous(), args[1], args[2], \
            _group(args[3])
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=_op(op), group=group)
        return out
    if base == "all_to_all_single":
        x, out_sizes, in_sizes, group = args[0].contiguous(), args[1], \
            args[2], _group(args[3])
        rows = sum(out_sizes) if out_sizes else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, list(out_sizes) or None,
                               list(in_sizes) or None, group=group)
        return out
    return None


class InPlace(TorchDispatchMode):
    """Run DTensor's functional collectives through the in-place API and
    count every collective dispatched while the mode is on; with
    ``timed`` also time each one between two device syncs."""

    def __init__(self, timed: bool = False):
        super().__init__()
        self.timed = timed

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar into plain ops first, then see its comms
            return NotImplemented
        ns = func.namespace
        base = func.name().split("::")[-1].split(".")[0]
        if not ((ns == "_c10d_functional" and base in _FUNCTIONAL)
                or (ns == "c10d" and base in _C10D)):
            return func(*args, **kwargs)
        first = _tensors(args[0]) if args else []
        if self.timed:
            _sync(first)
        t0 = time.perf_counter()
        out = _in_place(base, args) if ns == "_c10d_functional" else None
        if out is not None:
            name = base.rstrip("_")
        elif ns == "_c10d_functional":
            name = f"functional_{base}"
            out = torch.ops._c10d_functional.wait_tensor(
                func(*args, **kwargs))
        else:
            name = _C10D.get(base, base)
            out = func(*args, **kwargs)
            if isinstance(out, (list, tuple)) and out and \
                    hasattr(out[-1], "wait"):
                out[-1].wait()
        rec = _STATS[name]
        rec["count"] += 1
        rec["bytes"] += sum(t.numel() * t.element_size() for t in first)
        if self.timed:
            _sync(first)
            rec["seconds"] += time.perf_counter() - t0
        return out


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (op "sum" or "max")."""
    import torch.distributed as dist
    dist.all_reduce(t, op=_op(op), group=group)
    return t


def probe_cuda(group, device) -> Dict[str, str]:
    """Which in-place collectives gloo serves for tensors on ``device``
    over ``group``: {name: "ok" or the error}.  Every rank of the group
    calls it."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    x = torch.arange(4 * n, dtype=torch.float32, device=device)
    src = dist.get_global_rank(group, 0)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(x.numel() * n, device=device), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(x.numel() // n, device=device), x, group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=src,
                                            group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=group),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            _sync([x])
            out[name] = "ok"
        except Exception as exc:  # recorded, the caller decides
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return out
