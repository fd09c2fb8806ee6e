"""The mesh's remaining paths on the CPU, gloo process groups of spawned
ranks (``repro_torch.launch.mesh.run_ranks``), each spawned mesh running
several cases in one call (``tests/_torch_mesh_ranks.py``).

* ``coded_psum`` over ("pod", "data") on a (2, 2, 2) mesh against the
  reference's under ``shard_map`` on a forced 8-device CPU JAX (in a
  subprocess), every shard responding and one dropped: within 1e-6 of
  max |ref|.
* The sharded train step of a tiny phi3 on the (2, 2, 2) (pod, data,
  model) mesh, 2 steps (the second drops a shard), against the
  one-process port step (which ``tests/test_torch_train.py`` holds to the
  JAX package): coded over (pod, data) with FSDP and ZeRO-1, the uncoded
  and the int8-compressed steps with them, ZeRO-1 alone, and the
  compressed step without either.  Losses within 1e-5
  relative, step 1's gradient within 1e-4 of each leaf's max |g| (plus
  one int8 step for the compressed step, whose rounding a 1e-6
  difference can move by one), the
  parameters after 2 steps within 2e-3 of each leaf's max with at most
  1% of elements past 1e-5 (``tests/test_torch_train.py``'s tolerances).
  Each compressed step's gradient is the int8 round trip of the mesh's
  own uncompressed gradient (the same placements), bit for bit (the q's
  and the scales equal).
* Decodes on a (2, 2) (data, model) mesh with the cache's sequence and
  the SSM states over ``model`` (``cache_specs``), against the JAX
  package's ``decode_step`` on the same weights (``models.convert``):
  MLA and GQA with distinct per-slot positions (float32, int8 and bf16
  caches), rwkv6 and jamba.  float32 within 1e-4 of max |logits| of the
  port's one-process decode, and of the reference's plus the one-process
  port's own distance from it; bf16 within 2e-2 of max |logits| of both.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.configs import tiny_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300.0
MESH3 = ((2, 2, 2), ("pod", "data", "model"))
DP = ("pod", "data")
NB, ACCUM, SEQ, MB = 4, 2, 16, 2
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
PARAM_TOL, TIGHT_PARAM_TOL = 2e-3, 1e-5      # tests/test_torch_train.py's
PSUM_TOL = 1e-6
LOGIT_TOL, BF16_TOL = 1e-4, 2e-2


def _rdv(tmp_path) -> str:
    d = tmp_path / "rdv"
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def _env(devices: int) -> dict:
    return dict(os.environ,
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                JAX_PLATFORMS="cpu",
                PYTHONPATH=str(ROOT / "src") + os.pathsep +
                os.environ.get("PYTHONPATH", ""))


# ---- coded_psum over (pod, data) ------------------------------------------
PSUM_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import BerrutGradientCode
from repro.core.coded_training import coded_psum
from repro.launch.mesh import make_test_mesh, use_mesh
data = np.load(sys.argv[1])
gcode = BerrutGradientCode(4, 4)
mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map
dp = ("pod", "data")
out = {}
for m in ("full", "dropped"):
    mask = jnp.asarray(data["mask_" + m])
    def f(a, b, mask):
        g = coded_psum({"a": a[0], "b": b[0]}, mask, gcode, dp)
        return g["a"], g["b"]
    with use_mesh(mesh):
        a, b = shard_map(f, mesh=mesh,
                         in_specs=(P(dp), P(dp), P()),
                         out_specs=(P(), P()))(jnp.asarray(data["a"]),
                                               jnp.asarray(data["b"]), mask)
    out["a_" + m], out["b_" + m] = np.asarray(a), np.asarray(b)
np.savez(sys.argv[2], **out)
"""


def test_coded_psum_over_pod_and_data_matches_reference(tmp_path):
    rng = np.random.default_rng(12)
    a = rng.standard_normal((4, 6, 5)).astype(np.float32)
    b = rng.standard_normal((4, 7)).astype(np.float32)
    masks = {"full": np.ones(4, np.float32),
             "dropped": np.array([1, 1, 0, 1], np.float32)}
    np.savez(tmp_path / "in.npz", a=a, b=b,
             **{f"mask_{k}": v for k, v in masks.items()})
    proc = subprocess.run([sys.executable, "-c", PSUM_SCRIPT,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          env=_env(8), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    grads = [{"a": a[i], "b": b[i]} for i in range(4)]
    for m, mask in masks.items():
        got = run_ranks(ranks.coded_psum_axes_rank, 8,
                        (grads, mask, 4, *MESH3, DP),
                        rdv_dir=_rdv(tmp_path / m), device="cpu",
                        timeout_s=TIMEOUT_S)
        # (pod, data) row-major: ranks (p, d, m) -> 2 p + d
        assert [g["idx"] for g in got] == [0, 0, 1, 1, 2, 2, 3, 3]
        for g in got:
            for k in ("a", "b"):
                ref = want[f"{k}_{m}"]
                np.testing.assert_allclose(g[k], ref, rtol=0,
                                           atol=PSUM_TOL * np.abs(ref).max())


# ---- the train step's paths on (pod, data, model) ------------------------
CASES = {"coded_fsdp_zero1": dict(coded=NB, dp=DP, fsdp=True, zero1=True),
         "uncoded_fsdp": dict(coded=None, dp=DP, fsdp=True, zero1=True),
         "compress_fsdp": dict(coded=NB, dp=DP, compress=True, fsdp=True,
                               zero1=True),
         "coded_zero1": dict(coded=NB, dp=DP, zero1=True),
         "compress": dict(coded=NB, dp=DP, compress=True)}
# the compressed case and the uncompressed one it rounds
ROUNDS = {"compress": "coded_zero1", "compress_fsdp": "coded_fsdp_zero1"}


def _train_cfg():
    return dataclasses.replace(tiny_config("phi3-mini-3.8b"), pad_heads_to=2,
                               compute_dtype="float32")


def _train_inputs(cfg):
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    state = {k: v.detach().numpy().copy()
             for k, v in model.named_parameters()}
    pipe = TokenPipeline(cfg.vocab_size, SEQ, NB * ACCUM * MB, seed=3)
    batches = [{k: v.numpy() for k, v in pipe.batch_at(i).items()}
               for i in range(2)]
    masks = [np.ones(NB, np.float32), np.array([1, 0, 1, 1], np.float32)]
    return state, batches, masks


def _one_process(cfg, state, batches, masks, case):
    """The one-process port step of ``case`` from ``state``: (losses, step
    1's gradient, the parameters after the last step)."""
    from repro_torch.core import BerrutGradientCode
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(state[k]))
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    st = opt.init(params)
    n = case.get("coded")
    step = build_train_step(model, opt, accum=ACCUM,
                            gcode=BerrutGradientCode(n, n) if n else None,
                            compress=case.get("compress", False))
    losses = []
    for i, (batch, mask) in enumerate(zip(batches, masks)):
        params, st, metrics = step(params, st, batch, mask)
        losses.append(float(metrics["loss"]))
        if i == 0:
            g1 = {k: p.grad.numpy().copy() for k, p in params.items()}
    return losses, g1, {k: p.detach().numpy().copy()
                        for k, p in params.items()}


def _int8_steps(cfg, grads) -> dict:
    """{leaf: the int8 step (scale) of its compression group} for the
    one-process gradient ``grads``."""
    from repro_torch.launch.steps import _stacked_leaves
    from repro_torch.models import build_model
    out = {}
    for names in _stacked_leaves(build_model(cfg, device="meta")).values():
        amax = max(float(np.abs(grads[n]).max()) for n in names)
        out.update(dict.fromkeys(names, amax / 127.0))
    return out


@functools.lru_cache(maxsize=None)
def _mesh_train_runs(tmp: str):
    cfg = _train_cfg()
    state, batches, masks = _train_inputs(cfg)
    out = run_ranks(ranks.train_paths_rank, 8,
                    (cfg, state, batches, masks, ACCUM, *MESH3,
                     list(CASES.values())),
                    rdv_dir=tmp, device="cpu", timeout_s=TIMEOUT_S)
    return cfg, state, batches, masks, out


@pytest.fixture(scope="module")
def mesh_train(tmp_path_factory):
    return _mesh_train_runs(str(tmp_path_factory.mktemp("rdv_train")))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_path_matches_one_process(mesh_train, name):
    cfg, state, batches, masks, out = mesh_train
    i = list(CASES).index(name)
    for r in range(1, 8):                  # every rank holds one model
        assert out[r][i]["losses"] == out[0][i]["losses"]
        for k, v in out[r][i]["after"].items():
            np.testing.assert_array_equal(v, out[0][i]["after"][k])
    got = out[0][i]
    losses, g1, after = _one_process(cfg, state, batches, masks,
                                     CASES[name])
    for g, w in zip(got["losses"], losses):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got["losses"], losses)
    step = _int8_steps(cfg, g1) if CASES[name].get("compress") else {}
    for k, w in g1.items():
        diff = float(np.abs(got["grads1"][k] - w).max())
        # compressed: a gradient ~1e-6 off before the rounding may land
        # one int8 step away (test_compressed_gradient_is_the_int8_round_
        # trip holds the mesh's rounding itself exactly)
        tol = GRAD_TOL * float(np.abs(w).max()) + step.get(k, 0.0)
        assert diff <= tol, (name, k, diff, tol)
    loose = 0
    for k, w in after.items():
        diff = np.abs(got["after"][k] - w)
        scale = float(np.abs(w).max())
        assert float(diff.max()) <= PARAM_TOL * scale, (name, k)
        loose += int((diff > TIGHT_PARAM_TOL * scale).sum())
    assert loose <= 0.01 * sum(w.size for w in after.values()), loose
    # every gradient placed as its parameter
    assert got["grad_placements"] == got["placements"]
    stats = got["collectives"]
    assert not any(k.startswith("functional_") for k in stats), stats


def test_fsdp_and_zero1_placements(mesh_train):
    out = mesh_train[-1][0]
    fsdp = out[list(CASES).index("coded_fsdp_zero1")]
    zero = out[list(CASES).index("coded_zero1")]
    # FSDP: the layers on the whole mesh, sharded over data; the
    # embeddings and the final norm TP-only on the model submesh
    assert fsdp["meshes"]["layers.0.mixer.wq"] == ["pod", "data", "model"]
    assert fsdp["placements"]["layers.0.mixer.wq"] == \
        "(Replicate(), Shard(dim=0), Shard(dim=1))"
    assert fsdp["meshes"]["embedding.table"] == ["model"]
    assert fsdp["mu_placements"]["layers.0.mixer.wq"] == \
        fsdp["placements"]["layers.0.mixer.wq"]
    # the coded reduce-scatter: an FSDP gradient leaves data-sharded
    assert fsdp["collectives"]["reduce_scatter_tensor"]["count"] > 0
    assert fsdp["collectives"]["all_gather_into_tensor"]["count"] > 0
    # ZeRO-1: the moments gain the data axis, the parameters do not
    assert zero["placements"]["embedding.table"] == "(Shard(dim=0),)"
    assert zero["mu_placements"]["embedding.table"] == \
        "(Replicate(), Shard(dim=1), Shard(dim=0))"
    assert zero["mu_placements"]["layers.0.norm1.scale"] == \
        "(Replicate(), Shard(dim=0), Replicate())"


@pytest.mark.parametrize("name", list(ROUNDS))
def test_compressed_gradient_is_the_int8_round_trip(mesh_train, name):
    from repro_torch.dist.compression import (int8_compress_shared,
                                              int8_decompress)
    from repro_torch.launch.steps import _stacked_leaves
    from repro_torch.models import build_model
    cfg, _, _, _, out = mesh_train
    plain = out[0][list(CASES).index(ROUNDS[name])]["grads1"]
    comp = out[0][list(CASES).index(name)]["grads1"]
    model = build_model(cfg, device="meta")
    groups = _stacked_leaves(model)
    assert any(len(v) > 1 for v in groups.values())
    for names in groups.values():
        qs, scale = int8_compress_shared(
            [torch.from_numpy(plain[n]) for n in names])
        for n, q in zip(names, qs):
            np.testing.assert_array_equal(
                comp[n], int8_decompress(q, scale).numpy())


# ---- decodes on the (data, model) mesh ------------------------------------
DECODE = {"mla_per_slot": ("deepseek-v2-lite-16b", {}, True),
          "gqa_per_slot": ("qwen3-14b", {}, True),
          "gqa_int8_per_slot": ("qwen3-14b", {"kv_cache_dtype": "int8"},
                                True),
          "gqa_bf16_per_slot": ("qwen3-14b", {"compute_dtype": "bfloat16"},
                                True),
          "rwkv6": ("rwkv6-1.6b", {}, False),
          "jamba": ("jamba-v0.1-52b", {}, False)}
B, T, MAX_LEN = 4, 5, 12
STARTS = np.array([0, 3, 1, 5])             # each slot's first position


def _decode_cfg(cfg_fn, arch, extra):
    kw = dict(pad_heads_to=2, compute_dtype="float32")
    kw.update(extra)
    return dataclasses.replace(cfg_fn(arch), **kw)


def _jax_decode(arch, extra, per_slot, toks, positions):
    """(the reference's params as numpy, its decode's logits a step)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny
    from repro.models import build_model as ref_build
    model = ref_build(_decode_cfg(ref_tiny, arch, extra))
    params = model.init(jax.random.PRNGKey(0))
    cache = model.init_cache(B, MAX_LEN)
    step = jax.jit(model.decode_step)
    out = []
    for t in range(T):
        pos = jnp.asarray(positions[t], jnp.int32) if per_slot else t
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), pos)
        out.append(np.asarray(lg[:, 0], np.float32))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params), out


def _single_decode(model, toks, positions):
    cache = model.init_cache(B, MAX_LEN)
    out = []
    with torch.no_grad():
        for t in range(T):
            pos = t if positions is None else torch.from_numpy(positions[t])
            lg, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]).long(), pos)
            out.append(lg[:, 0].float().numpy().copy())
    return out


@pytest.fixture(scope="module")
def mesh_decodes(tmp_path_factory):
    from repro_torch.models import build_model, load_jax_params
    rng = np.random.default_rng(5)
    cases, refs = [], {}
    for name, (arch, extra, per_slot) in DECODE.items():
        cfg = _decode_cfg(tiny_config, arch, extra)
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        positions = (np.arange(T)[:, None] + STARTS[None]).astype(
            np.int64) if per_slot else None
        tree, want = _jax_decode(arch, extra, per_slot, toks, positions)
        model = load_jax_params(build_model(cfg, device="cpu"), tree)
        state = {k: v.detach().float().numpy().copy()
                 for k, v in model.named_parameters()}
        refs[name] = (want, _single_decode(model, toks, positions))
        cases.append((cfg, state, toks, MAX_LEN, positions))
    out = run_ranks(ranks.decode_paths_rank, 4, (cases, (2, 2)),
                    rdv_dir=str(tmp_path_factory.mktemp("rdv_decode")),
                    device="cpu", timeout_s=TIMEOUT_S)
    return out, refs


@pytest.mark.parametrize("name", list(DECODE))
def test_sharded_decode_matches_reference(mesh_decodes, name):
    out, refs = mesh_decodes
    i = list(DECODE).index(name)
    want, single = refs[name]
    bf16 = "bfloat16" in DECODE[name][1].values()
    for t in range(T):
        for r in range(4):
            np.testing.assert_array_equal(out[r][i]["logits"][t],
                                          out[0][i]["logits"][t])
        got = out[0][i]["logits"][t]
        scale = float(np.abs(want[t]).max())
        own = float(np.abs(single[t] - want[t]).max())
        err_single = float(np.abs(got - single[t]).max())
        err_ref = float(np.abs(got - want[t]).max())
        if bf16:
            assert err_single <= BF16_TOL * scale, (t, err_single)
            assert err_ref <= BF16_TOL * scale, (t, err_ref)
        else:
            assert err_single <= LOGIT_TOL * float(
                np.abs(single[t]).max()), (t, err_single)
            assert err_ref <= LOGIT_TOL * scale + own, (t, err_ref, own)
    pl = out[0][i]["cache_placements"]
    first = next(iter(pl.values()))
    assert first.startswith("(Shard(dim=0), Shard(dim="), pl
