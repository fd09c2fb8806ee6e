"""The dry run (``repro_torch.launch.dryrun``) and its analyzer
(``launch.hlo_analysis``) on the CPU, and the port's ``kernels.tiling``.

* The analyzer: exact FLOPs and bytes of a chain of matmuls; the flash
  kernel counted by its formula (causal pairs), not by its plain
  version's ops, forward and backward; an analysis refuses a hand
  kernel a tensor off the meta device, whatever device it analyzes;
  collectives counted in result
  bytes on a 4-rank fake process group.
* A tiny dense prefill cell (qwen2-7b tiny with 4 kv heads, 4 x 64 tokens)
  on a (2, 2) fake mesh against the reference's ``analyze(compiled.
  as_text())`` of the same cell on a forced 4-device CPU JAX: the matmul
  FLOPs agree exactly once each side's attention term is taken out (the
  reference's rule, every dot of its attention, against the port's causal
  pairs).
* A tiny train cell (phi3 tiny, 8 x 32 tokens, accum 4, ZeRO-1): its
  argument bytes equal the reference's ``memory_analysis().
  argument_size_in_bytes`` (tolerance 0), and the accum extrapolation from
  the accum 1 and 2 runs equals a direct accum 3 run, every count.
* ``--list`` prints the reference's RUN/SKIP cells; the modules import
  neither ``jax`` nor ``repro``.
* ``tiling.pad_to``/``tile`` equal the reference's over (dim, align, cap).

The fake process group is joined in subprocesses (one per side), so no
test process keeps a process group.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # container without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, strategies as st

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
PREFILL = ("qwen2-7b", 64, 4)          # arch, seq, batch
TRAIN = ("phi3-mini-3.8b", 32, 8)


def _env(devices: int = 0) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    if devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
    return env


# ---- the analyzer ---------------------------------------------------------
def test_analyzer_counts_a_chain_of_matmuls_exactly():
    from repro_torch.launch.hlo_analysis import analyze
    a, b, c = torch.randn(8, 16), torch.randn(16, 32), torch.randn(32, 4)

    def chain(a, b, c):
        return (torch.relu(a @ b) @ c).t()

    out, m = analyze(chain, a, b, c)
    assert out.shape == (4, 8)
    assert m.flops == 2 * 8 * 32 * 16 + 2 * 8 * 4 * 32
    # a @ b (in 16 x 8 + 16 x 32, out 8 x 32), relu (in and out 8 x 32),
    # @ c (8 x 32 + 32 x 4 in, 8 x 4 out); the transpose is a view
    want = 4 * ((8 * 16 + 16 * 32 + 8 * 32) + 2 * 8 * 32 +
                (8 * 32 + 32 * 4 + 8 * 4))
    assert m.hbm_bytes == want
    assert m.total_collective_bytes == 0
    assert m.peak_bytes == 4 * (2 * 8 * 32 + 8 * 4) or m.peak_bytes > 0


def test_analyzer_counts_flash_by_its_formula():
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import (analyze, flash_bwd_work,
                                                 flash_work)
    b, s, h, kvh, hd = 2, 64, 4, 2, 16
    q = torch.empty(b, s, h, hd, device="meta", requires_grad=True)
    k = torch.empty(b, s, kvh, hd, device="meta", requires_grad=True)
    v = torch.empty(b, s, kvh, hd, device="meta", requires_grad=True)
    fwd_bytes, fwd_flops = flash_work(b, s, s, h, kvh, hd, hd, True, 4)
    bwd_bytes, bwd_flops = flash_bwd_work(b, s, s, h, kvh, hd, hd, True, 4)
    pairs = s * (s + 1) // 2                 # causal: about half
    assert fwd_flops == 2 * b * h * 2 * hd * pairs
    with torch.no_grad():
        _, m = analyze(lambda: ops.flash_attention(q, k, v),
                       device_type="meta")
    assert (m.flops, m.hbm_bytes) == (fwd_flops, fwd_bytes)
    # the backward: its formula once more; the sum's ops are elementwise
    _, m = analyze(lambda: ops.flash_attention(q, k, v).sum().backward(),
                   device_type="meta")
    assert m.flops == fwd_flops + bwd_flops
    # beside the two formulas only the sum and the gradients' elementwise
    # ops: less than the one (B, H, S, S) float32 score matrix of the
    # plain version, which holds several
    extra = m.hbm_bytes - fwd_bytes - bwd_bytes
    assert 0 < extra < 4 * b * h * s * s, extra


@pytest.mark.parametrize("device_type", ["meta", None])
@pytest.mark.parametrize("kernel", ["flash_attention", "mask_add"])
def test_analysis_refuses_a_kernel_a_real_tensor(device_type, kernel):
    """Whatever the analyzed device (None: the argument's, here the
    host's), a hand kernel given a real tensor raises and never runs its
    plain version in the kernel's place."""
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import analyze
    q = torch.randn(1, 8, 2, 16)
    call = {"flash_attention": lambda x: ops.flash_attention(x, x, x),
            "mask_add": lambda x: ops.mask_add(x, x, 97)}[kernel]
    with pytest.raises(RuntimeError, match="launches no kernel"):
        analyze(call, q, device_type=device_type)


PORT_SCRIPT = r"""
import json, sys, dataclasses
import torch, torch.distributed as dist
from repro_torch.configs import tiny_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze
out = {}
dryrun.fake_world(4)
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
sub = mesh["model"]

def comms():
    x = DTensor.from_local(torch.empty(8, 16, device="meta"), sub,
                           [Partial()], run_check=False)
    y = x.redistribute(sub, [Replicate()])             # all-reduce 8x16
    z = DTensor.from_local(torch.empty(4, 16, device="meta"), sub,
                           [Shard(0)], run_check=False)
    w = z.redistribute(sub, [Replicate()])             # all-gather 8x16
    u = x.redistribute(sub, [Shard(0)])                # reduce-scatter 4x16
    t = torch.empty(5, device="meta")
    dist.all_reduce(t, group=mesh.get_group("data"))   # in place, 5
    return y, w, u

with use_mesh(mesh):
    _, m = analyze(comms, device_type="meta")
out["comms"] = {"bytes": m.collective_bytes, "counts": m.collective_counts,
                "span": m.span_bytes}

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(tiny_config(arch), n_kv_heads=4)
r = dryrun.run_cell(arch, "prefill_32k", False, device="cpu", cfg=cfg,
                    mesh_shape=(2, 2),
                    shape=ShapeSpec("tiny_prefill", seq, batch, "prefill"),
                    tag="test")
out["prefill"] = {"flops": r["hlo_flops_per_device"],
                  "n_layers": cfg.n_layers}

arch, seq, batch = sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
cell = dryrun.lower_cell(arch, "train_4k", False, device="cpu",
                         cfg=tiny_config(arch), mesh_shape=(2, 2),
                         shape=ShapeSpec("tiny_train", seq, batch, "train"))
ms = [analyze(cell.run, a, device_type="meta")[1] for a in (1, 2, 3)]
e = dryrun._extrapolate(ms[0], ms[1], 3)
pick = lambda m: {"flops": m.flops, "hbm": m.hbm_bytes,
                  "coll": m.collective_bytes,
                  "counts": m.collective_counts, "span": m.span_bytes}
out["train"] = {"accum": cell.accum, "args": cell.argument_bytes(cell.accum),
                "direct3": pick(ms[2]), "extrapolated3": pick(e),
                "peak2": ms[1].peak_bytes}
print("RESULT " + json.dumps(out))
"""

REF_SCRIPT = r"""
import json, sys, dataclasses
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import tiny_config
from repro.configs.base import ShapeSpec
from repro.core import BerrutGradientCode
from repro.dist.sharding import prune_spec, tree_add_data_axis, tree_shardings
from repro.launch.hlo_analysis import (_DIMS, _OPERAND, _dims_of,
                                       _parse_computations,
                                       _shape_elems_bytes, analyze)
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.launch.steps import build_train_step
from repro.models import build_model, input_specs
from repro.optim import adamw
from repro.optim.optimizers import OptState
mesh = make_test_mesh((2, 2), ("data", "model"))

def structs(tree, shard):
    return jax.tree.map(lambda sd, sh: jax.ShapeDtypeStruct(
        sd.shape, sd.dtype, sharding=sh), tree, shard)

def batch_structs(cfg, shape):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=NamedSharding(
        mesh, prune_spec(P("data", *([None] * (len(v.shape) - 1))), v.shape,
                         mesh))) for k, v in input_specs(cfg, shape).items()}

out = {}
# the prefill cell, as the reference's lower_cell builds it
arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(tiny_config(arch), n_kv_heads=4, pad_heads_to=16,
                          remat=False, param_dtype="bfloat16")
model = build_model(cfg)
p_shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
p = structs(p_shapes, tree_shardings(model.param_specs(), mesh, p_shapes))
bs = batch_structs(cfg, ShapeSpec("tiny_prefill", seq, batch, "prefill"))

def prefill_step(params, batch):
    logits, _ = model.forward(params, batch["tokens"])
    return logits[:, -1:]

with use_mesh(mesh):
    hlo = jax.jit(prefill_step).lower(p, bs).compile().as_text()
# the attention's dots (batched: rank-4 results) by the reference's own
# rule, 2 |out| K, once per layer of the scanned body
comps, _ = _parse_computations(hlo)
attn = 0.0
for comp in comps.values():
    shp = {i.name: i.type_str for i in comp}
    for ins in comp:
        if ins.op == "dot" and len(_dims_of(ins.type_str)) == 4:
            lhs = _OPERAND.findall(ins.rest.split(")")[0])[0]
            k = 1
            for ci in _DIMS.search(ins.rest).group(1).split(","):
                k *= _dims_of(shp[lhs])[int(ci)]
            attn += 2.0 * _shape_elems_bytes(ins.type_str)[0] * k
out["prefill"] = {"flops": analyze(hlo).flops,
                  "attention": attn * cfg.n_layers}
# the train cell's argument bytes (ZeRO-1, coded, accum = batch / n_dp)
arch, seq, batch = sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
cfg = dataclasses.replace(tiny_config(arch), pad_heads_to=16, remat=True,
                          param_dtype="float32")
model = build_model(cfg)
p_shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
specs = model.param_specs()
p = structs(p_shapes, tree_shardings(specs, mesh, p_shapes))
bs = batch_structs(cfg, ShapeSpec("tiny_train", seq, batch, "train"))
with use_mesh(mesh):
    opt = adamw(1e-4)
    mv = tree_shardings(tree_add_data_axis(specs, p_shapes), mesh, p_shapes)
    o = structs(jax.eval_shape(opt.init, p),
                OptState(NamedSharding(mesh, P()), mv, mv))
    step = build_train_step(model, opt, accum=batch // 2,
                            gcode=BerrutGradientCode(2, 2), dp_axes="data")
    mask = jax.ShapeDtypeStruct((2,), jnp.float32,
                                sharding=NamedSharding(mesh, P()))
    compiled = jax.jit(step, donate_argnums=(0, 1)).lower(
        p, o, bs, mask).compile()
out["train"] = {"args": compiled.memory_analysis().argument_size_in_bytes}
print("RESULT " + json.dumps(out))
"""


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def cells():
    argv = [str(x) for x in PREFILL + TRAIN]
    port = subprocess.Popen([sys.executable, "-c", PORT_SCRIPT, *argv],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, *argv],
                           env=_env(4), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=ROOT)
    return _result(port), _result(ref)


def test_collectives_count_in_result_bytes(cells):
    comms = cells[0]["comms"]
    f32 = 4
    assert comms["bytes"]["all-reduce"] == f32 * (8 * 16 + 5)
    assert comms["bytes"]["all-gather"] == f32 * 8 * 16
    assert comms["bytes"]["reduce-scatter"] == f32 * 4 * 16
    assert comms["counts"]["all-reduce"] == 2
    assert comms["counts"]["all-gather"] == comms["counts"][
        "reduce-scatter"] == 1
    # (2, 2) ranks 0-3: every group inside one node of 8
    assert comms["span"]["node"] == f32 * (2 * 8 * 16 + 4 * 16 + 5)
    assert comms["span"]["cross_node"] == 0


def test_prefill_matmul_flops_match_reference(cells):
    from repro_torch.configs import tiny_config
    from repro_torch.launch.hlo_analysis import flash_work
    port, ref = cells[0]["prefill"], cells[1]["prefill"]
    arch, seq, batch = PREFILL
    cfg = tiny_config(arch)
    # per device: batch over data (2), the 16 padded heads over model (2)
    hd = cfg.d_model // cfg.n_heads
    _, attn = flash_work(batch // 2, seq, seq, 16 // 2, 16 // 2, hd, hd,
                         True, 4)
    port_attn = attn * port["n_layers"]
    assert ref["attention"] > 0
    assert port["flops"] - port_attn == ref["flops"] - ref["attention"], \
        (port, ref, port_attn)


def test_train_cell_argument_bytes_match_reference(cells):
    port, ref = cells[0]["train"], cells[1]["train"]
    assert port["accum"] == TRAIN[2] // 2
    assert port["args"] == ref["args"]


def test_accum_extrapolation_equals_a_direct_run(cells):
    train = cells[0]["train"]
    assert train["direct3"] == train["extrapolated3"]
    assert train["direct3"]["flops"] > 0 and train["peak2"] > 0


# ---- the command line, isolation -----------------------------------------
def test_list_matches_reference():
    runs = [subprocess.run([sys.executable, "-m", mod, "--list"] + extra,
                           env=_env(), capture_output=True, text=True,
                           timeout=TIMEOUT_S, cwd=ROOT)
            for mod, extra in (("repro_torch.launch.dryrun",
                                ["--device", "cpu"]),
                               ("repro.launch.dryrun", []))]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    assert runs[0].stdout == runs[1].stdout
    lines = runs[0].stdout.splitlines()
    assert sum(" RUN" in l for l in lines) == 32 and len(lines) == 40


def test_dryrun_modules_load_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis, repro_torch.kernels.tiling\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- tiling ---------------------------------------------------------------
@settings(max_examples=200, deadline=None)
@given(dim=st.integers(1, 5000), align=st.integers(1, 256),
       cap=st.integers(1, 4096))
def test_tiling_matches_reference(dim, align, cap):
    from repro.kernels import tiling as ref
    from repro_torch.kernels import tiling
    assert tiling.pad_to(dim, align) == ref.pad_to(dim, align)
    if cap < align:
        return                 # no tile fits: both refuse alike below
    got, want = tiling.tile(dim, align, cap), ref.tile(dim, align, cap)
    assert got == want
    t, padded = got
    # tiling never pads beyond the alignment
    assert padded == -(-dim // align) * align and padded % t == 0
