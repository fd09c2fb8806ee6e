"""Device meshes over ``torch.distributed`` process groups.

Ports ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_test_mesh``, ``use_mesh``, ``dp_axes``, ``DP_AXES``).  The reference
is one controller over many devices; the port is one process per mesh
position, each joined to a gloo process group (NCCL allows one process
per device, and a mesh of 8 ranks may share one card).  A mesh is
``torch.distributed.device_mesh.init_device_mesh`` over the initialized
group, on the card unless the caller asks for the CPU.

``use_mesh(mesh)`` installs the ambient mesh that ``dist.sharding.
shard_hint`` resolves its specs against, lets plain tensors meet DTensors
as replicated values (``implicit_replication``: what a jitted function's
constants are under the reference's mesh), and runs DTensor's collectives
through gloo's in-place API, counted (``dist.collectives.InPlace``;
``timed=True`` also times each one between device syncs).

``run_ranks(fn, world_size, ...)`` starts the processes: each joins the
gloo group through a file rendezvous, runs ``fn(rank, world_size, *args)``
and sends its return value back; every process is stopped before it
returns, and a failure in any rank raises with that rank's traceback.
"""

from __future__ import annotations

import contextlib
import os
import queue
import time
import traceback
from typing import Any, Callable, List

import torch

from ..dist import collectives, sharding

__all__ = ["make_production_mesh", "make_test_mesh", "use_mesh", "dp_axes",
           "DP_AXES", "run_ranks"]

DP_AXES = ("pod", "data")
JOIN_S = 15.0       # run_ranks: a finished rank's exit, before the kill


@contextlib.contextmanager
def use_mesh(mesh, *, timed: bool = False):
    """Install ``mesh`` for the block: ``shard_hint``'s ambient mesh,
    implicit replication of plain tensors and the in-place collectives
    (``dist.collectives.InPlace(timed)``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding.installed(mesh), implicit_replication(), \
            collectives.InPlace(timed):
        yield mesh


def _mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: a mesh runs on the "
                           "card by default; pass device_type='cpu'")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or "
                           "run_ranks)")
    need = 1
    for n in shape:
        need *= n
    if dist.get_world_size() != need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod.
    Raises unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over the initialized process group (world size =
    the shape's product)."""
    return _mesh(shape, axes, device_type)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (('pod', 'data') when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in DP_AXES)


def _rank_entry(fn, rank: int, world: int, init_method: str, device: str,
                results, args) -> None:
    import torch.distributed as dist
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # sent to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        results.close()
        results.join_thread()       # the result is in the pipe


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *,
              rdv_dir: str, device: str = "cuda",
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined to one gloo group (rendezvous file under
    ``rdv_dir``); returns their return values in rank order.  ``fn`` and
    ``args`` must pickle (CUDA tensors go by IPC handle: the caller keeps
    them alive until this returns).  Every process is joined or killed
    before it returns; a rank's exception, or no result within
    ``timeout_s``, raises ``RuntimeError``."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"file://{os.path.join(rdv_dir, 'rdv')}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init_method, device,
                               results, args), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    try:
        while len(got) + len(failed) < world_size:
            try:
                rank, ok, value = results.get(timeout=timeout_s)
            except queue.Empty:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world_size)) - set(got))} "
                    f"sent nothing in {timeout_s} s") from None
            (got if ok else failed)[rank] = value
            if failed:
                break
        if failed:
            rank = min(failed)
            raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                               f"{failed[rank]}")
        # every result is in: a process still tearing down (its CUDA
        # context, another's IPC memory) gets JOIN_S, then is killed
        deadline = time.monotonic() + JOIN_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world_size)]
