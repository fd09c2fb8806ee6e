"""Rank programs for the port's mesh tests (``tests/test_torch_distributed.py``):
each runs in one process of ``repro_torch.launch.mesh.run_ranks``, joined
to a gloo group, and returns numpy results to the test.  No JAX here: the
spawned processes import this module, not the test file.
"""

import numpy as np
import torch


def _model(cfg, state: dict, device: str):
    """The port's model of ``cfg`` carrying the numpy ``state`` (by
    parameter name)."""
    from repro_torch.models import build_model
    model = build_model(cfg, device=device, seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(state[name]).to(p.device, p.dtype))
    return model


def coded_psum_rank(rank, world, grads: list, mask, n_shards: int):
    """``coded_psum`` of rank ``rank``'s gradient tree over a 1-D ``data``
    mesh of ``world`` ranks."""
    torch.set_num_threads(1)
    from repro_torch.core import BerrutGradientCode, coded_psum
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    mesh = make_test_mesh((world,), ("data",), device_type="cpu")
    gcode = BerrutGradientCode(n_shards, n_shards)
    tree = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    with use_mesh(mesh):
        out = coded_psum(tree, mask, gcode, "data")
    return {k: v.numpy() for k, v in out.items()}


def train_rank(rank, world, cfg, state: dict, batches: list, masks: list,
               accum: int, mesh_shape: tuple, device: str = "cpu",
               lr: float = 3e-3):
    """The sharded coded train step on a (data, model) mesh: the model's
    parameters placed by ``param_specs`` on ``mesh["model"]``, one coded
    shard a data rank, ``len(batches)`` steps.  Returns (on every rank)
    the losses, step 1's first moment and the parameters after each step,
    gathered to full tensors, and the collectives' counts."""
    torch.set_num_threads(1)
    from repro_torch.core import BerrutGradientCode
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import distribute_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw, warmup_cosine
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.load_prebuilt()
    mesh = make_test_mesh(mesh_shape, ("data", "model"), device_type=device)
    model = distribute_params(_model(cfg, state, device), mesh["model"])
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(lr, 20, 100), weight_decay=0.01)
    opt_state = opt.init(params)
    nb = mesh_shape[0]
    step = build_train_step(model, opt, accum=accum,
                            gcode=BerrutGradientCode(nb, nb), dp_axes="data")
    losses, after, mu1 = [], [], None
    collectives.reset()
    f0 = ops.kernel_launch_counts()
    with use_mesh(mesh):
        for i, (batch, mask) in enumerate(zip(batches, masks)):
            params, opt_state, metrics = step(params, opt_state, batch, mask)
            losses.append(float(metrics["loss"]))
            after.append({k: p.detach().full_tensor().cpu().numpy().copy()
                          for k, p in params.items()})
            if i == 0:
                mu1 = {k: m.full_tensor().cpu().numpy().copy()
                       for k, m in opt_state.mu.items()}
                grads1 = {k: p.grad.full_tensor().cpu().numpy().copy()
                          for k, p in params.items()}
    f1 = ops.kernel_launch_counts()
    return {"losses": losses, "after": after, "mu1": mu1, "grads1": grads1,
            "placements": {k: str(p.placements) for k, p in params.items()},
            "grad_placements": {k: str(p.grad.placements)
                                for k, p in params.items()},
            "launches": {k: f1[k] - f0[k] for k in f1},
            "collectives": collectives.stats()}


def decode_rank(rank, world, cfg, state: dict, tokens, max_len: int,
                mesh_shape: tuple, device: str = "cpu"):
    """The sequence-sharded decode: parameters by ``param_specs`` and the
    cache by ``cache_specs`` on a (data, model) mesh (batch over data,
    cache sequence over model), ``tokens.shape[1]`` steps.  Returns every
    step's full logits (B, V)."""
    torch.set_num_threads(1)
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import P, distribute, distribute_params
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    mesh = make_test_mesh(mesh_shape, ("data", "model"), device_type=device)
    model = distribute_params(_model(cfg, state, device), mesh)
    b = tokens.shape[0]
    cache = distribute(model.init_cache(b, max_len), model.cache_specs(),
                       mesh)
    toks = torch.from_numpy(tokens).to(device)
    out = []
    collectives.reset()
    with torch.no_grad(), use_mesh(mesh):
        for t in range(tokens.shape[1]):
            tok = distribute(toks[:, t:t + 1], P("data", None), mesh)
            logits, cache = model.decode_step(cache, tok, t)
            out.append(logits.full_tensor()[:, 0].float().cpu().numpy().copy())
    return {"logits": out, "collectives": collectives.stats(),
            "cache_placements": str(cache[0]["k"].placements)}


def mismatched_code_rank(rank, world, cfg, state: dict):
    """The sharded step with a code of 4 shards on a data axis of 2:
    raises."""
    torch.set_num_threads(1)
    from repro_torch.core import BerrutGradientCode
    from repro_torch.dist.sharding import distribute_params
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw
    mesh = make_test_mesh((world, 1), ("data", "model"), device_type="cpu")
    model = distribute_params(_model(cfg, state, "cpu"), mesh["model"])
    params = dict(model.named_parameters())
    opt = adamw(1e-3)
    step = build_train_step(model, opt, gcode=BerrutGradientCode(4, 4),
                            dp_axes="data")
    batch = {"tokens": np.zeros((4, 8), np.int32),
             "targets": np.zeros((4, 8), np.int32)}
    with use_mesh(mesh):
        step(params, opt.init(params), batch, np.ones(4, np.float32))


def mesh_refusals_rank(rank, world):
    """The messages of meshes this group cannot hold, and ``dp_axes``."""
    from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                         make_test_mesh)
    out = {}
    for key, make in (("test", lambda: make_test_mesh((2, 2),
                                                      device_type="cpu")),
                      ("production", lambda: make_production_mesh(
                          device_type="cpu")),
                      ("multi_pod", lambda: make_production_mesh(
                          multi_pod=True, device_type="cpu"))):
        try:
            make()
            out[key] = "built"
        except ValueError as exc:
            out[key] = str(exc)
    mesh = make_test_mesh((world, 1), ("data", "model"), device_type="cpu")
    out["dp_axes"] = list(dp_axes(mesh))
    return out


def train_paths_rank(rank, world, cfg, state: dict, batches: list,
                     masks: list, accum: int, mesh_shape: tuple,
                     mesh_axes: tuple, cases: list, device: str = "cpu"):
    """Several sharded train steps on one mesh, each from ``state``:
    ``cases`` are dicts of ``coded`` (shards over ``dp``), ``dp`` (the dp
    axes), ``compress``, ``fsdp``, ``zero1``.  Returns, per case, the
    losses, step 1's gradient and the parameters after the last step
    (full tensors), the placements of parameters, gradients and moments,
    and the collectives' counts."""
    torch.set_num_threads(1)
    from repro_torch.core import BerrutGradientCode
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import (distribute_train_params,
                                           train_specs)
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw, place_state, warmup_cosine
    mesh = make_test_mesh(mesh_shape, mesh_axes, device_type=device)
    out = []
    for case in cases:
        model = _model(cfg, state, device)
        specs, mv = train_specs(model, fsdp=case.get("fsdp", False),
                                zero1=case.get("zero1", False))
        model = distribute_train_params(model, mesh, specs)
        params = dict(model.named_parameters())
        opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
        opt_state = place_state(opt.init(params), mesh, mv)
        n = case.get("coded")
        step = build_train_step(
            model, opt, accum=accum,
            gcode=BerrutGradientCode(n, n) if n else None,
            compress=case.get("compress", False), dp_axes=case["dp"])
        losses, grads1 = [], None
        collectives.reset()
        with use_mesh(mesh):
            for i, (batch, mask) in enumerate(zip(batches, masks)):
                params, opt_state, metrics = step(params, opt_state, batch,
                                                  mask)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    grads1 = {k: p.grad.full_tensor().cpu().numpy().copy()
                              for k, p in params.items()}
            after = {k: p.detach().full_tensor().cpu().numpy().copy()
                     for k, p in params.items()}
        out.append({
            "losses": losses, "grads1": grads1, "after": after,
            "placements": {k: str(p.placements) for k, p in params.items()},
            "meshes": {k: list(p.device_mesh.mesh_dim_names)
                       for k, p in params.items()},
            "grad_placements": {k: str(p.grad.placements)
                                for k, p in params.items()},
            "mu_placements": {k: str(m.placements)
                              for k, m in opt_state.mu.items()},
            "collectives": collectives.stats()})
    return out


def decode_paths_rank(rank, world, cases: list, mesh_shape: tuple,
                      device: str = "cpu"):
    """Decodes on a (data, model) mesh, parameters by ``param_specs`` and
    the cache or states by ``cache_specs``: each case is (cfg, state,
    tokens (B, T), max_len, positions (T, B) per-slot or None for the
    scalar t).  Returns, per case, every step's full logits (B, V) and
    the first layer's cache placements."""
    torch.set_num_threads(1)
    from repro_torch.dist.sharding import P, distribute, distribute_params
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    mesh = make_test_mesh(mesh_shape, ("data", "model"), device_type=device)
    out = []
    for cfg, state, tokens, max_len, positions in cases:
        model = distribute_params(_model(cfg, state, device), mesh)
        b = tokens.shape[0]
        cache = distribute(model.init_cache(b, max_len), model.cache_specs(),
                           mesh)
        toks = torch.from_numpy(tokens).to(device)
        logits = []
        with torch.no_grad(), use_mesh(mesh):
            for t in range(tokens.shape[1]):
                tok = distribute(toks[:, t:t + 1], P("data", None), mesh)
                pos = t if positions is None else \
                    torch.from_numpy(positions[t]).to(device)
                lg, cache = model.decode_step(cache, tok, pos)
                logits.append(lg.full_tensor()[:, 0].float().cpu().numpy()
                              .copy())
        out.append({"logits": logits,
                    "cache_placements": {k: str(v.placements)
                                         for k, v in cache[0].items()}})
    return out


def coded_psum_axes_rank(rank, world, grads: list, mask, n_shards: int,
                         mesh_shape: tuple, mesh_axes: tuple, dp):
    """``coded_psum`` over the mesh axes ``dp`` (a tuple: the row-major
    index over them picks this rank's gradient tree) of a ``mesh_shape``
    mesh."""
    torch.set_num_threads(1)
    from repro_torch.core import BerrutGradientCode, coded_psum
    from repro_torch.dist.sharding import dp_index
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    mesh = make_test_mesh(mesh_shape, mesh_axes, device_type="cpu")
    gcode = BerrutGradientCode(n_shards, n_shards)
    idx = dp_index(mesh, dp)
    tree = {k: torch.from_numpy(v) for k, v in grads[idx].items()}
    with use_mesh(mesh):
        out = coded_psum(tree, mask, gcode, dp)
    return {"idx": idx, **{k: v.numpy() for k, v in out.items()}}


def warm_rank(rank, world):
    """A ``RankGroup`` warm-up: a collective over the joined group, before
    any job arrives."""
    import torch.distributed as dist
    x = torch.ones(1)
    dist.all_reduce(x)
    assert int(x.item()) == world


def sum_rank(rank, world, t):
    """All-reduce ``(rank + 1) * t`` over the group."""
    import torch.distributed as dist
    x = t.clone() * (rank + 1)
    dist.all_reduce(x)
    return x.numpy()
