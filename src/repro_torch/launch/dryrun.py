"""Multi-pod dry run: build every (arch x shape) cell on the production
mesh (16 x 16 single-pod and 2 x 16 x 16 multi-pod) and read its
per-device roofline terms from the ops one rank dispatches.  No tensor is
allocated: parameters, optimizer state, cache and batch are meta tensors
placed as DTensors.

The counterpart of ``repro/launch/dryrun.py``, with its functions
(``make_cell``, ``lower_cell``, ``run_cell``, ``cells``, ``main``) and its
command line.  The reference compiles each cell for a placeholder mesh of
512 devices and analyzes the compiled HLO.  The port has no compiler: this
process joins a fake process group of 256 (or 512) ranks as rank 0
(``torch.testing._internal.distributed.fake_pg``: its collectives return
at once), builds the mesh over it (``--device``, cuda by default; nothing
is ever allocated there), builds the model on the meta device and runs the
cell's step once under ``launch.hlo_analysis.analyze``.  A hand kernel is
refused a tensor that is not meta, so nothing launches.

* Train cells run the coded step (``build_train_step(gcode=...,
  dp_axes=...)``, or ``--uncoded``) with ZeRO-1 (AdamW's moments placed by
  ``tree_add_data_axis``) and, above 10 B parameters, FSDP on every
  ``layers.<i>`` leaf (embeddings, norms and the unembed stay TP-only).
  The reference multiplies its loop bodies by their trip counts; the port
  runs the step at ``accum`` = 1 and 2 and extrapolates FLOPs, bytes and
  collectives linearly to the cell's accum (the micro-steps are
  identical, so this is exact); the peak memory is the ``accum`` = 2
  run's.
* Prefill cells run the forward under ``no_grad`` and keep the last
  position's logits; decode cells run one ``build_serve_step`` at a
  scalar ``pos`` against ``init_cache`` placed by ``cache_specs``.

The result's keys are the reference's, except
``xla_cost_analysis_flops_unscaled``, which has no counterpart and is
dropped.  The roofline constants are the H100's (NVIDIA H100 80GB HBM3 at
700 W, spec-sheet rates, not measured): bf16 dense 989 TFLOP/s, HBM 3.35
TB/s, NVLink 450 GB/s a direction for a collective whose group lies in one
node of 8, 50 GB/s (one 400 Gb/s port a GPU) for a group that spans nodes.
Results go to ``build/dryrun_results/``.

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
  (``--device cpu`` on a host with no card)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..core import BerrutGradientCode
from ..dist.sharding import (P, distribute, distribute_params,
                             distribute_train_params, prune_spec,
                             resolve_spec, train_specs)
from ..models import build_model
from ..models.zoo import input_specs
from ..optim import adamw, place_state
from .hlo_analysis import Metrics, analyze
from .mesh import make_production_mesh, make_test_mesh, use_mesh
from .roofline_math import model_flops
from .steps import build_serve_step, build_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun_results")

# NVIDIA H100 80GB HBM3 (700 W) spec-sheet rates
PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, a group inside a node
NET_BW = 50e9                # bytes/s, a group across nodes (400 Gb/s)

FSDP_PARAM_THRESHOLD = 10e9   # >10B params: 2D (FSDP+TP) weight sharding


def _accum_for(shape, n_dp: int) -> int:
    """One sequence per microbatch per block keeps remat memory flat."""
    return max(shape.global_batch // n_dp, 1)


def fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (once per
    process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is up; this "
                               f"cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_cell(arch: str, shape_name: str, multi_pod: bool,
              redundancy: int = 1, device: str = "cuda", *, cfg=None,
              mesh_shape=None):
    """(cfg, shape, mesh, n_dp) of a cell.  ``cfg`` and ``mesh_shape``
    ((data, model), or (pod, data, model) with ``multi_pod``) replace the
    arch's config and the production mesh: a small cell for tests."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    else:
        fake_world(int(np.prod(mesh_shape)))
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        mesh = make_test_mesh(tuple(mesh_shape), axes, device_type=device)
    n_dp = int(np.prod(mesh.mesh.shape[:-1]))
    is_train = shape.kind == "train"
    cfg = dataclasses.replace(
        cfg, pad_heads_to=16, remat=is_train,
        param_dtype="float32" if is_train else "bfloat16")
    return cfg, shape, mesh, n_dp


@dataclasses.dataclass
class Cell:
    """A built cell: ``run(accum)`` runs its step once (train cells at
    that accumulation count, the others ignore it) and returns what the
    step returned; ``argument_bytes(accum)`` is the local bytes of its
    inputs."""
    shape: object
    mesh: object
    accum: int
    run: object
    argument_bytes: object
    fsdp: bool = False


def _local_bytes(tree) -> int:
    from ..tree import leaves
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if type(t).__name__ == "DTensor" else t
            total += t.numel() * t.element_size()
    return total


def _placed_bytes(t, spec, mesh) -> int:
    """Local bytes of global ``t`` placed by ``spec`` on ``mesh``."""
    spec = resolve_spec(spec, tuple(t.shape), mesh)
    n = t.numel() * t.element_size()
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               redundancy: int = 1, coded: bool = True,
               fsdp: bool | None = None, zero1: bool = True,
               seq_parallel: bool = False, int8_cache: bool = False,
               device: str = "cuda", *, cfg=None, mesh_shape=None,
               shape=None) -> Cell:
    """Build the cell (the reference's ``lower_cell``, which lowers it):
    the model on the meta device, its parameters placed, the optimizer
    state, the batch and the cache, the step.  ``cfg``, ``mesh_shape``
    (``make_cell``) and ``shape`` (a ``ShapeSpec``) shrink it for
    tests."""
    cfg, shape_, mesh, n_dp = make_cell(arch, shape_name, multi_pod,
                                        device=device, cfg=cfg,
                                        mesh_shape=mesh_shape)
    shape = shape or shape_
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_shard_activations=True)
    if int8_cache:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = build_model(cfg, device="meta")
    if fsdp is None:
        fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
    fsdp = fsdp and shape.kind == "train" and not cfg.encoder_decoder
    p_specs, mv = train_specs(model, fsdp=fsdp, zero1=zero1)
    dp = ("pod", "data") if multi_pod else "data"

    def bspec(name, t):
        if name == "mrope_positions":
            spec = P(None, dp, *([None] * (t.dim() - 2)))
        else:
            spec = P(dp, *([None] * (t.dim() - 1)))
        return prune_spec(spec, tuple(t.shape), mesh)

    if shape.kind == "train":
        model = distribute_train_params(model, mesh, p_specs)
        params = dict(model.named_parameters())
        opt = adamw(1e-4)
        state = place_state(opt.init(params), mesh, mv)
        accum = _accum_for(shape, n_dp)
        mb = max(shape.global_batch // (n_dp * accum), 1)
        gcode = BerrutGradientCode(n_shards=n_dp, n_blocks=n_dp,
                                   redundancy=redundancy) if coded else None
        mask = np.ones(n_dp, np.float32)

        def batch_of(a):
            b = dataclasses.replace(shape, global_batch=n_dp * a * mb)
            return input_specs(cfg, b)

        def run(a):
            # the step's accumulation count, rebuilt for the run
            s = build_train_step(model, opt, accum=a, gcode=gcode,
                                 dp_axes=dp)
            with use_mesh(mesh):
                return s(params, state, batch_of(a), mask)

        def arg_bytes(a):
            batch = batch_of(a)
            return (_local_bytes(params) + _local_bytes(state) + sum(
                _placed_bytes(t, bspec(k, t), mesh)
                for k, t in batch.items()) + mask.nbytes)

        return Cell(shape, mesh, accum, run, arg_bytes, fsdp)

    model = distribute_params(model, mesh)
    batch = input_specs(cfg, shape)
    placed = {k: distribute(t, bspec(k, t), mesh) for k, t in batch.items()}

    if shape.kind == "prefill":
        def run(_):
            with torch.no_grad(), use_mesh(mesh):
                if cfg.encoder_decoder:
                    logits, _ = model.forward(placed["frames"],
                                              placed["tokens"])
                else:
                    logits, _ = model.forward(
                        placed["tokens"],
                        mrope_positions=placed.get("mrope_positions"))
                return logits[:, -1:]          # next-token logits only
        nbytes = _local_bytes(dict(model.named_parameters())) + \
            _local_bytes(placed)
        return Cell(shape, mesh, 1, run, lambda _: nbytes)

    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cache = distribute(cache, model.cache_specs(), mesh)
    serve = build_serve_step(model)

    def run(_):
        with use_mesh(mesh):
            return serve(None, cache, placed["tokens"], 0,
                         placed.get("mrope_positions"))
    nbytes = _local_bytes(dict(model.named_parameters())) + \
        _local_bytes(cache) + _local_bytes(placed)
    return Cell(shape, mesh, 1, run, lambda _: nbytes)


def _extrapolate(m1: Metrics, m2: Metrics, accum: int) -> Metrics:
    """m1 + (accum - 1) (m2 - m1), the identical micro-steps' linear
    count; the peak is m2's."""
    out = Metrics()
    out.add(m1, 2.0 - accum)
    out.add(m2, accum - 1.0)
    out.peak_bytes = m2.peak_bytes
    return out


def _device_bytes(device: str) -> int:
    return torch.cuda.memory_allocated() if device == "cuda" else 0


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             redundancy: int = 1, coded: bool = True, tag: str = "",
             seq_parallel: bool = False, int8_cache: bool = False,
             device: str = "cuda", **small):
    """Build and analyze a cell; write and return its result (``small``:
    ``lower_cell``'s test-size overrides)."""
    t0 = time.time()
    cell = lower_cell(arch, shape_name, multi_pod, redundancy, coded,
                      seq_parallel=seq_parallel, int8_cache=int8_cache,
                      device=device, **small)
    t_build = time.time() - t0
    t0 = time.time()
    if cell.shape.kind == "train":
        out1, m1 = analyze(cell.run, 1, device_type="meta")
        del out1
        out, m2 = analyze(cell.run, 2, device_type="meta")
        metrics = _extrapolate(m1, m2, cell.accum)
        args = cell.argument_bytes(cell.accum)
    else:
        out, metrics = analyze(cell.run, 1, device_type="meta")
        args = cell.argument_bytes(1)
    t_run = time.time() - t0
    out_bytes = _local_bytes(out)
    del out
    n_chips = int(np.prod(cell.mesh.mesh.shape))
    mf = model_flops(dataclasses.replace(
        small.get("cfg") or get_config(arch), pad_heads_to=16), cell.shape)

    flops_dev = metrics.flops
    hbm_dev = metrics.hbm_bytes
    coll_dev = metrics.total_collective_bytes
    compute_term = flops_dev / PEAK_FLOPS
    memory_term = hbm_dev / HBM_BW
    collective_term = metrics.span_bytes["node"] / NVLINK_BW + \
        metrics.span_bytes["cross_node"] / NET_BW
    dominant = max((compute_term, "compute"), (memory_term, "memory"),
                   (collective_term, "collective"))[1]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, cell.mesh.mesh.shape)),
        "n_chips": n_chips, "coded": coded, "redundancy": redundancy,
        "fsdp": cell.fsdp, "accum": cell.accum,
        "lower_s": t_build, "compile_s": t_run,
        "hlo_flops_per_device": flops_dev,
        "hlo_hbm_bytes_per_device": hbm_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": {"bytes": metrics.collective_bytes,
                        "counts": metrics.collective_counts,
                        "bytes_by_span": metrics.span_bytes},
        "model_flops": mf,
        "useful_ratio": (mf["model_flops_global"] / n_chips)
        / max(flops_dev, 1.0),
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_bytes,
            "temp_bytes": metrics.peak_bytes,
            "peak_bytes": args + metrics.peak_bytes,
        },
        # roofline terms (seconds per step, per device)
        "compute_term_s": compute_term,
        "memory_term_s": memory_term,
        "collective_term_s": collective_term,
        "dominant_term": dominant,
        "device_type": device,
        "device_bytes_allocated": _device_bytes(device),
    }
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = os.path.join(RESULTS_DIR,
                      f"{arch}__{shape_name}__{result['mesh']}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    return result


def cells(multi_pod: bool):
    for arch in ARCHS:
        for shape_name in SHAPES:
            ok, why = shape_applicable(arch, shape_name)
            yield arch, shape_name, ok, why


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--uncoded", action="store_true",
                    help="baseline (paper-external) plain-DP aggregation")
    ap.add_argument("--redundancy", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (nothing is allocated "
                    "there)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape_name, ok, why in cells(args.multi_pod):
            print(f"{arch:24s} {shape_name:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device for a cuda mesh; pass --device cpu",
              file=sys.stderr)
        return 2

    todo = []
    if args.all:
        for arch, shape_name, ok, why in cells(args.multi_pod):
            if ok:
                todo.append((arch, shape_name))
    else:
        ok, why = shape_applicable(args.arch, args.shape)
        if not ok:
            print(f"SKIP {args.arch} × {args.shape}: {why}")
            return 0
        todo.append((args.arch, args.shape))

    failures = 0
    for arch, shape_name in todo:
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"
        suffix = f"__{args.tag}" if args.tag else ""
        out = os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_tag}{suffix}.json")
        if args.skip_existing and os.path.exists(out):
            print(f"skip (cached) {arch} × {shape_name} × {mesh_tag}")
            continue
        try:
            t0 = time.time()
            r = run_cell(arch, shape_name, args.multi_pod,
                         redundancy=args.redundancy, coded=not args.uncoded,
                         tag=args.tag, seq_parallel=args.seq_parallel,
                         int8_cache=args.int8_cache, device=args.device)
            print(f"OK   {arch} × {shape_name} × {mesh_tag}: "
                  f"wall={time.time() - t0:.1f}s "
                  f"flops/dev={r['hlo_flops_per_device']:.3e} "
                  f"hbm/dev={r['hlo_hbm_bytes_per_device']:.3e}B "
                  f"coll={r['collective_bytes_per_device']:.3e}B "
                  f"terms={r['compute_term_s']:.3e}/{r['memory_term_s']:.3e}/"
                  f"{r['collective_term_s']:.3e}s "
                  f"useful={r['useful_ratio']:.2f} dom={r['dominant_term']} "
                  f"peak_mem={r['memory']['peak_bytes']/2**30:.2f}GiB "
                  f"fsdp={r['fsdp']} device_bytes={r['device_bytes_allocated']}",
                  flush=True)
        except Exception as e:
            failures += 1
            print(f"FAIL {arch} × {shape_name} × {mesh_tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
