"""The sharded path on the CPU: gloo process groups of spawned ranks
(``repro_torch.launch.mesh.run_ranks``, a file rendezvous under the
test's ``tmp_path``), against the reference.

* ``coded_psum`` over 4 ranks against the reference's under ``shard_map``
  on a forced 4-device CPU JAX (in a subprocess, as
  ``tests/test_distributed.py`` runs it), with every shard responding and
  with one dropped.
* The sharded coded train step on a 2 x 4 (data, model) mesh: tiny
  qwen2-7b with ``pad_heads_to=4``, 2 coded shards (one a data rank),
  accum 2, 3 steps with the second shard masked at step 2, the parameters
  DTensors placed by ``param_specs`` on ``mesh["model"]``; against the JAX
  single-device ``build_train_step`` from the same parameters
  (``load_jax_params``) and batches, at ``tests/test_torch_train.py``'s
  tolerances: losses within 1e-5 relative, step 1's first moment within
  1e-4 of each leaf's max, the parameters after each step within 2e-3 of
  each leaf's max with at most 1% of elements past 1e-5; step 1's
  gradient within 1e-4 of each leaf's max of ``jax.grad``'s.  The leaves
  that start at zero are held in units of lr (``CLEAR_GRAD``).
* The sequence-sharded decode on the 2 x 4 mesh (batch over data, cache
  sequence over model; tiny qwen3-14b, as the reference's decode test):
  6 float32 steps within 1e-4 of max |logits| of the port's single-device
  decode and of the reference's; and with the int8 cache against the
  port's single-device int8 decode.
* The mesh's refusals (a CUDA mesh without a card, a world size that is
  not the mesh's), and the new modules' isolation from JAX.
* On the card (``-k cuda``): the sharded step on a 1 x 2 mesh with the
  flash kernels running on each rank's local heads under ``local_map``.
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
TIMEOUT_S = 240.0
NB, ACCUM, SEQ, MB = 2, 2, 16, 2
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
PARAM_TOL, TIGHT_PARAM_TOL = 2e-3, 1e-5      # tests/test_torch_train.py's
LOGIT_TOL = 1e-4
# A leaf that starts at zero (qwen2's q, k and v biases) has no weight
# scale: its max |p| after a step is Adam's step sizes, so a bound
# relative to it is a bound in units of lr.  Where an element's reference
# gradient is at least CLEAR_GRAD of the leaf's max |g| at every step so
# far (10x the gradient tolerance), AdamW moves it by about lr sign(g)
# whatever the tolerance-sized gradient difference: held to
# CLEAR_PARAM_TOL of the summed lr.  The other elements sit within noise
# of a zero gradient (a fifth to a half of the k bias's: RoPE's slow pairs
# barely turn over the sequence, so the bias term's score shifts nearly
# cancel in the softmax) and may take the other sign: held to the
# sign-flip bound, 2 lr summed over the steps, and counted with the
# elements past TIGHT_PARAM_TOL (at most 1% of all).
CLEAR_GRAD, CLEAR_PARAM_TOL = 10 * GRAD_TOL, 1e-3
_LRS = (1.5e-4, 3e-4, 4.5e-4)               # warmup_cosine(3e-3, 20, 100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run there")
    return torch.device("cuda")


def _rdv(tmp_path) -> str:
    d = tmp_path / "rdv"
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


# ---- coded_psum --------------------------------------------------------
PSUM_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import BerrutGradientCode
from repro.core.coded_training import coded_psum
from repro.launch.mesh import make_test_mesh, use_mesh
data = np.load(sys.argv[1])
gcode = BerrutGradientCode(4, 4)
mesh = make_test_mesh((4,), ("data",))
shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map
out = {}
for m in ("full", "dropped"):
    mask = jnp.asarray(data["mask_" + m])
    def f(a, b, mask):
        g = coded_psum({"a": a[0], "b": b[0]}, mask, gcode, "data")
        return g["a"], g["b"]
    with use_mesh(mesh):
        a, b = shard_map(f, mesh=mesh,
                         in_specs=(P("data"), P("data"), P()),
                         out_specs=(P(), P()))(jnp.asarray(data["a"]),
                                               jnp.asarray(data["b"]), mask)
    out["a_" + m], out["b_" + m] = np.asarray(a), np.asarray(b)
np.savez(sys.argv[2], **out)
"""


def test_coded_psum_matches_reference_shard_map(tmp_path):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((4, 6, 5)).astype(np.float32)
    b = rng.standard_normal((4, 7)).astype(np.float32)
    masks = {"full": np.ones(4, np.float32),
             "dropped": np.array([1, 0, 1, 1], np.float32)}
    np.savez(tmp_path / "in.npz", a=a, b=b,
             **{f"mask_{k}": v for k, v in masks.items()})
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", PSUM_SCRIPT,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for m, mask in masks.items():
        grads = [{"a": a[r], "b": b[r]} for r in range(4)]
        got = run_ranks(ranks.coded_psum_rank, 4, (grads, mask, 4),
                        rdv_dir=_rdv(tmp_path / m), device="cpu",
                        timeout_s=TIMEOUT_S)
        for r in range(4):
            for k in ("a", "b"):
                ref = want[f"{k}_{m}"]
                np.testing.assert_allclose(got[r][k], ref, rtol=0,
                                           atol=1e-6 * np.abs(ref).max())


# ---- the sharded coded train step --------------------------------------
def _train_cfg(cfg_fn):
    return dataclasses.replace(cfg_fn("qwen2-7b"), pad_heads_to=4,
                               compute_dtype="float32")


def _masks():
    masks = [np.ones(NB, np.float32) for _ in range(3)]
    masks[1][1] = 0.0                      # the second shard straggles
    return masks


def _batches(vocab):
    pipe = TokenPipeline(vocab, SEQ, NB * ACCUM * MB, seed=1)
    return [{k: v.numpy() for k, v in pipe.batch_at(i).items()}
            for i in range(3)]


@functools.lru_cache(maxsize=None)
def _reference_train():
    """The reference's jitted single-device coded step, 3 steps: (initial
    numpy tree, losses, mu after step 1, params after each step, each
    step's gradient by ``jax.grad``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny
    from repro.core import BerrutGradientCode
    from repro.launch.steps import _micro, build_train_step, \
        reshape_for_blocks
    from repro.models import build_model
    from repro.optim import adamw, warmup_cosine
    cfg = _train_cfg(ref_tiny)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    start = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    state = opt.init(params)
    step = jax.jit(build_train_step(model, opt, accum=ACCUM,
                                    gcode=BerrutGradientCode(NB, NB)))
    # a code of its own: the step's caches arrays made under its trace
    wcode = BerrutGradientCode(NB, NB)

    @jax.jit
    def grad(params, batch, w):
        # the step's gradient, sum_n w_n grad L(D_n) over the blocks,
        # averaged over the micro-batches, before the optimizer's clip
        blocks = reshape_for_blocks(batch, NB, ACCUM)

        def weighted(p, micro):
            return jnp.sum(w * jax.vmap(lambda b: model.loss_fn(p, b)[0])(
                micro))
        gs = [jax.grad(weighted)(params, _micro(blocks, a))
              for a in range(ACCUM)]
        return jax.tree.map(lambda *g: sum(g) / ACCUM, *gs)

    losses, after, mu1, grads = [], [], None, []
    for i, (batch, mask) in enumerate(zip(_batches(cfg.vocab_size),
                                          _masks())):
        w = wcode.decoder_weights(jnp.asarray(mask)) * jnp.asarray(mask)
        grads.append(jax.tree.map(np.asarray, grad(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, w)))
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(mask))
        losses.append(float(metrics["loss"]))
        after.append(jax.tree.map(np.asarray, params))
        if i == 0:
            mu1 = jax.tree.map(np.asarray, state.mu)
    return start, losses, mu1, after, grads


def _port_state(cfg, tree) -> tuple:
    """(the port's CPU model from the reference tree, its numpy state)."""
    from repro_torch.models import build_model, load_jax_params
    model = load_jax_params(build_model(cfg, device="cpu"), tree)
    return model, {k: v.detach().numpy().copy()
                   for k, v in model.named_parameters()}


def test_sharded_coded_train_step_matches_reference(tmp_path):
    from repro_torch.models.convert import _layer_leaves
    start, ref_losses, ref_mu1, ref_after, ref_grads = _reference_train()
    cfg = _train_cfg(tiny_config)
    model, state = _port_state(cfg, start)
    out = run_ranks(ranks.train_rank, 8,
                    (cfg, state, _batches(cfg.vocab_size), _masks(), ACCUM,
                     (2, 4)),
                    rdv_dir=_rdv(tmp_path), device="cpu", timeout_s=TIMEOUT_S)
    for r in range(1, 8):             # every rank holds the same model
        assert out[r]["losses"] == out[0]["losses"]
        for k, v in out[r]["after"][-1].items():
            np.testing.assert_array_equal(v, out[0]["after"][-1][k])
    got = out[0]
    for g, w in zip(got["losses"], ref_losses):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got["losses"], ref_losses)
    grads = [_layer_leaves(model, g) for g in ref_grads]
    for mine, want in ((got["grads1"], grads[0]),
                       (got["mu1"], _layer_leaves(model, ref_mu1))):
        for name, w in want.items():
            scale = float(np.abs(w).max())
            diff = float(np.abs(mine[name] - w).max())
            assert diff <= GRAD_TOL * scale, (name, diff, scale)
    zero_start = {name for name, p in state.items() if not p.any()}
    assert any(n.endswith("mixer.bk") for n in zero_start), zero_start
    for step, want in enumerate(ref_after):
        want = _layer_leaves(model, want)
        lr = sum(_LRS[:step + 1])
        loose = 0
        for name, w in want.items():
            diff = np.abs(got["after"][step][name] - w)
            scale = float(np.abs(w).max())
            if name in zero_start:
                clear = np.min([np.abs(g[name]) / np.abs(g[name]).max()
                                for g in grads[:step + 1]], axis=0) \
                    >= CLEAR_GRAD
                worst = float(np.max(diff[clear], initial=0.0))
                assert worst <= CLEAR_PARAM_TOL * lr, (step, name, worst, lr)
                assert float(diff.max()) <= 2 * lr, (step, name)
            else:
                assert float(diff.max()) <= PARAM_TOL * scale, \
                    (step, name, float(diff.max()), scale)
            loose += int((diff > TIGHT_PARAM_TOL * scale).sum())
        assert loose <= 0.01 * sum(w.size for w in want.values()), loose
    # tensor parallel over heads, FFN width and vocabulary; every gradient
    # placed as its parameter
    pl = got["placements"]
    assert pl["layers.0.mixer.wq"] == "(Shard(dim=1),)"
    assert pl["layers.0.ffn.w_down"] == "(Shard(dim=0),)"
    assert pl["embedding.table"] == "(Shard(dim=0),)"
    assert pl["layers.0.mixer.wk"] == "(Replicate(),)"   # 2 kv heads, tp 4
    assert got["grad_placements"] == pl
    stats = got["collectives"]
    assert stats["all_reduce"]["count"] > 0
    assert not any(k.startswith("functional_") for k in stats)


def test_sharded_step_refuses_a_mismatched_code(tmp_path):
    cfg = _train_cfg(tiny_config)
    from repro_torch.models import build_model
    state = {k: v.detach().numpy() for k, v in
             build_model(cfg, device="cpu").named_parameters()}
    with pytest.raises(RuntimeError, match="n_shards 4 != the data axis"):
        run_ranks(ranks.mismatched_code_rank, 2, (cfg, state),
                  rdv_dir=_rdv(tmp_path), device="cpu", timeout_s=TIMEOUT_S)


# ---- the sequence-sharded decode ---------------------------------------
def _decode_cfg(cfg_fn, int8=False):
    return dataclasses.replace(cfg_fn("qwen3-14b"), pad_heads_to=4,
                               compute_dtype="float32",
                               kv_cache_dtype="int8" if int8 else "")


def _single_device_decode(model, toks, max_len):
    cache = model.init_cache(toks.shape[0], max_len)
    out = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
            out.append(lg[:, 0].numpy().copy())
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache",
                                                     "int8_cache"])
def test_sequence_sharded_decode_matches_single_device(tmp_path, int8):
    import jax
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny
    from repro.models import build_model as ref_build
    ref_model = ref_build(_decode_cfg(ref_tiny, int8))
    params = ref_model.init(jax.random.PRNGKey(0))
    cfg = _decode_cfg(tiny_config, int8)
    model, state = _port_state(cfg, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 6)).astype(np.int32)
    single = _single_device_decode(model, toks, 8)
    got = run_ranks(ranks.decode_rank, 8, (cfg, state, toks, 8, (2, 4)),
                    rdv_dir=_rdv(tmp_path), device="cpu",
                    timeout_s=TIMEOUT_S)
    assert got[0]["cache_placements"] == "(Shard(dim=0), Shard(dim=1))"
    ref_cache = ref_model.init_cache(2, 8)
    step = jax.jit(ref_model.decode_step)
    for t in range(toks.shape[1]):
        want, ref_cache = step(params, ref_cache,
                               jnp.asarray(toks[:, t:t + 1]), t)
        want = np.asarray(want[:, 0], np.float32)
        for r in range(8):
            assert np.array_equal(got[r]["logits"][t], got[0]["logits"][t])
        mesh_t = got[0]["logits"][t]
        err = float(np.abs(mesh_t - single[t]).max())
        assert err <= LOGIT_TOL * float(np.abs(single[t]).max()), (t, err)
        err = float(np.abs(mesh_t - want).max())
        assert err <= LOGIT_TOL * float(np.abs(want).max()), (t, err)


# ---- refusals, isolation ------------------------------------------------
def test_a_cuda_mesh_without_a_card_raises():
    from repro_torch.launch.mesh import make_test_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh((1, 1))


def test_meshes_refuse_a_world_size_that_is_not_theirs(tmp_path):
    out = run_ranks(ranks.mesh_refusals_rank, 2, (),
                    rdv_dir=_rdv(tmp_path), device="cpu", timeout_s=TIMEOUT_S)
    for msg in out:
        assert "a (2, 2) mesh needs 4 ranks" in msg["test"]
        assert "a (16, 16) mesh needs 256 ranks" in msg["production"]
        assert "a (2, 16, 16) mesh needs 512 ranks" in msg["multi_pod"]
        assert msg["dp_axes"] == ["data"]


def test_the_mesh_modules_load_neither_jax_nor_repro():
    code = ("import sys, repro_torch.dist, repro_torch.dist.sharding, "
            "repro_torch.dist.collectives, repro_torch.launch.mesh, "
            "repro_torch.launch.roofline_math, repro_torch.launch.steps, "
            "repro_torch.core.coded_training\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- on the card ---------------------------------------------------------
def test_cuda_sharded_step_runs_the_flash_kernels_in_every_rank(tmp_path,
                                                                 cuda):
    """A 1 x 2 mesh on the card: each rank's attention runs the flash
    forward and backward kernels on its local heads (``local_map``); the
    step's loss and gradient-driven parameters agree with the one-process
    step on the card (float32: the 3xTF32 route)."""
    from repro_torch.core import BerrutGradientCode
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    _build.library("flash_attention")             # the ranks load them
    cfg = dataclasses.replace(tiny_config("phi3-mini-3.8b"), pad_heads_to=2,
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    state = {k: v.detach().numpy().copy()
             for k, v in model.named_parameters()}
    pipe = TokenPipeline(cfg.vocab_size, 64, ACCUM * MB, seed=1)
    batches = [{k: v.numpy() for k, v in pipe.batch_at(0).items()}]
    masks = [np.ones(1, np.float32)]
    out = run_ranks(ranks.train_rank, 2,
                    (cfg, state, batches, masks, ACCUM, (1, 2), "cuda"),
                    rdv_dir=_rdv(tmp_path), device="cuda",
                    timeout_s=TIMEOUT_S)
    n_layers = cfg.n_layers
    for r in range(2):
        got = out[r]["launches"]
        # per micro-batch: 2 forwards (remat) and a backward per layer
        assert got["flash_attention"] == 2 * n_layers * ACCUM, got
        assert got["flash_attention_bwd"] == n_layers * ACCUM, got
    one = build_model(cfg, device=cuda)
    with torch.no_grad():
        for name, p in one.named_parameters():
            p.copy_(torch.from_numpy(state[name]))
    params = dict(one.named_parameters())
    opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    st = opt.init(params)
    step = build_train_step(one, opt, accum=ACCUM,
                            gcode=BerrutGradientCode(1, 1))
    params, st, metrics = step(params, st, batches[0], masks[0])
    loss = float(metrics["loss"])
    assert abs(out[0]["losses"][0] - loss) <= LOSS_RTOL * abs(loss)
    for name, m in st.mu.items():
        w = m.cpu().numpy()
        diff = float(np.abs(out[0]["mu1"][name] - w).max())
        assert diff <= GRAD_TOL * float(np.abs(w).max()), name
