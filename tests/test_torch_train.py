"""The LM training path (``repro_torch.data.pipeline``,
``repro_torch.launch.steps``, ``repro_torch.launch.train``) against the
JAX package's, on the CPU.

* The token pipeline, exactly: ``batch_at`` and ``make_batch`` draw the
  same numpy numbers from ``SeedSequence([seed, step])``.
* The train step on the tiny phi3-mini in float32 compute, against the
  reference's jitted ``build_train_step`` from the same parameters
  (``load_jax_params``), for 3 steps on the same batches and masks (one
  straggler masked at step 2), in four modes: uncoded with accum 2, coded
  over 4 blocks with accum 2, coded with redundancy 2, and coded with int8
  compression.  Held: each step's loss within 1e-5 relative; step 1's
  clipped gradient, read from AdamW's first moment (mu = (1 - b1) g),
  within 1e-4 of each leaf's max |mu|; the parameters after each step
  within ``PARAM_TOL`` of each leaf's max |p|.  See ``PARAM_TOL`` for why
  that bound is looser than 1e-5, and ``test_train_step_matches_reference``
  for the compression mode's rule.
* The weighted-loss identity of the coded path, as the reference's
  ``tests/test_train_integration.py`` holds it.
* The launcher: a run interrupted after its step-2 checkpoint and re-run
  with the same arguments ends bit-identical (parameters and optimizer
  state) to an uninterrupted run.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.data.pipeline import TokenPipeline, make_batch

ARCH = "phi3-mini-3.8b"
NB, ACCUM, SEQ = 4, 2, 16
GLOBAL = NB * ACCUM * 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# AdamW's first step moves every parameter by lr * g / (|g| + eps), about
# lr * sign(g): a gradient element within float32 noise of 0 (the two
# packages' 1e-4-of-max gradient differences) can take the other sign and
# move its parameter by up to 2 lr more.  The bound is that move summed
# over the 3 steps' learning rates (warmup_cosine(3e-3, 20, ...): 1.5e-4,
# 3e-4, 4.5e-4), 1.8e-3 absolute, over the tiny model's smallest leaf max
# |p| (a norm scale near 1): 2e-3 relative.  The elements that do not sit
# at such a sign are held to 1e-5 (``test_train_step_matches_reference``).
PARAM_TOL = 2e-3
TIGHT_PARAM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the token pipeline ------------------------------------------------

def test_batch_at_is_bit_identical_to_reference():
    from repro.data.pipeline import TokenPipeline as RefPipeline
    mine, ref = TokenPipeline(1000, 33, 5, seed=4), RefPipeline(1000, 33, 5,
                                                                 seed=4)
    for step in range(3):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    a, b = mine.batch_at(1), mine.batch_at(1)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-vl-72b",
                                  "whisper-small"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_make_batch_is_bit_identical_to_reference(arch, kind):
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny
    from repro.configs.base import ShapeSpec as RefShape
    from repro.data.pipeline import make_batch as ref_make_batch
    from repro_torch.configs.base import ShapeSpec
    shape = dict(name="s", seq_len=64, global_batch=3, kind=kind)
    got = make_batch(tiny_config(arch), ShapeSpec(**shape), step=2, seed=5)
    want = ref_make_batch(ref_tiny(arch), RefShape(**shape), step=2, seed=5)
    assert got.keys() == want.keys()
    for k in want:
        w = want[k]
        if w.dtype == jnp.bfloat16:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy(),
                np.asarray(w).view(np.int16))
        else:
            assert str(got[k].dtype) == f"torch.{w.dtype}"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))


# ---- the train step against the reference's ------------------------------

MODES = {"uncoded": dict(coded=False),
         "coded": dict(coded=True),
         "redundancy2": dict(coded=True, redundancy=2),
         "compress": dict(coded=True, compress=True)}


def _masks():
    masks = [np.ones(NB, np.float32) for _ in range(3)]
    masks[1][2] = 0.0                      # one straggler at step 2
    return masks


@functools.lru_cache(maxsize=None)
def _reference_run(mode: str):
    """The reference's 3 steps: (initial numpy params, losses, mu after
    step 1, params after each step), the tree leaves as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny
    from repro.core import BerrutGradientCode
    from repro.launch.steps import build_train_step
    from repro.models import build_model
    from repro.optim import adamw, warmup_cosine
    m = MODES[mode]
    cfg = dataclasses.replace(ref_tiny(ARCH), compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    start = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    state = opt.init(params)
    gcode = (BerrutGradientCode(NB, NB, redundancy=m.get("redundancy", 1))
             if m["coded"] else None)
    step = jax.jit(build_train_step(model, opt, accum=ACCUM, gcode=gcode,
                                    compress=m.get("compress", False)))
    pipe = TokenPipeline(cfg.vocab_size, SEQ, GLOBAL, seed=1)
    losses, after, mu1 = [], [], None
    for i, mask in enumerate(_masks()):
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in pipe.batch_at(i).items()}
        params, state, metrics = step(params, state, batch,
                                      jnp.asarray(mask))
        losses.append(float(metrics["loss"]))
        after.append(jax.tree.map(np.asarray, params))
        if i == 0:
            mu1 = jax.tree.map(np.asarray, state.mu)
    return start, losses, mu1, after


def _port_run(mode: str, start):
    from repro_torch.core import BerrutGradientCode
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model, load_jax_params
    from repro_torch.optim import adamw, warmup_cosine
    m = MODES[mode]
    cfg = dataclasses.replace(tiny_config(ARCH), compute_dtype="float32")
    model = load_jax_params(build_model(cfg, device="cpu"), start)
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    state = opt.init(params)
    gcode = (BerrutGradientCode(NB, NB, redundancy=m.get("redundancy", 1))
             if m["coded"] else None)
    step = build_train_step(model, opt, accum=ACCUM, gcode=gcode,
                            compress=m.get("compress", False))
    pipe = TokenPipeline(cfg.vocab_size, SEQ, GLOBAL, seed=1)
    losses, after, mu1, grads1 = [], [], None, None
    for i, mask in enumerate(_masks()):
        params, state, metrics = step(params, state, pipe.batch_at(i), mask)
        assert int(metrics["step"]) == i + 1
        losses.append(float(metrics["loss"]))
        after.append({k: v.detach().numpy().copy()
                      for k, v in params.items()})
        if i == 0:
            mu1 = {k: v.numpy().copy() for k, v in state.mu.items()}
            grads1 = {k: v.grad.numpy().copy() for k, v in params.items()}
    return model, losses, mu1, grads1, after


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_reference(mode):
    """Losses, step 1's clipped gradient (AdamW's mu) and the parameters
    after each of 3 steps.  Under compression an element whose gradient
    lies within float32 noise of a rounding boundary of the int8 grid can
    round to the neighbouring level in one package: the rule there is
    that the port's compressed gradient is the int8 round trip of its own
    gradient, exactly, and that mu agrees within one grid step at the
    elements where the two differ, 1e-4 elsewhere."""
    from repro_torch.dist import int8_compress_shared, int8_decompress
    from repro_torch.launch.steps import _stacked_leaves
    from repro_torch.models.convert import _layer_leaves
    start, ref_losses, ref_mu1, ref_after = _reference_run(mode)
    model, losses, mu1, grads1, after = _port_run(mode, start)
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (losses, ref_losses)
    want_mu = _layer_leaves(model, ref_mu1)
    steps = {}
    if MODES[mode].get("compress"):
        for names in _stacked_leaves(model).values():
            qs, s = int8_compress_shared(
                [torch.from_numpy(grads1[n]) for n in names])
            for n, q in zip(names, qs):
                np.testing.assert_array_equal(
                    int8_decompress(q, s).numpy(), grads1[n])
                steps[n] = float(s)
    flips = 0
    for name, w in want_mu.items():
        scale = float(np.abs(w).max())
        diff = np.abs(mu1[name] - w)
        if name in steps:
            flips += int((diff > GRAD_TOL * scale).sum())
            # one int8 step of the gradient, through the clip (<= 1) and
            # (1 - b1) = 0.1
            assert float(diff.max()) <= 0.1 * steps[name] * 1.01 + \
                GRAD_TOL * scale, name
        else:
            assert float(diff.max()) <= GRAD_TOL * scale, \
                (name, float(diff.max()), scale)
    assert flips <= 1e-3 * sum(w.size for w in want_mu.values()), flips
    for step, (got, want) in enumerate(zip(after, ref_after)):
        want = _layer_leaves(model, want)
        loose = 0
        for name, w in want.items():
            scale = float(np.abs(w).max())
            diff = np.abs(got[name] - w)
            assert float(diff.max()) <= PARAM_TOL * scale, \
                (step, name, float(diff.max()), scale)
            loose += int((diff > TIGHT_PARAM_TOL * scale).sum())
        # the elements past 1e-5 are few: the near-zero-gradient signs
        assert loose <= 0.01 * sum(w.size for w in want.values()), loose


def test_coded_step_runs_one_backward_per_block_and_microbatch(
        monkeypatch):
    """4 blocks x accum 2: 8 backward passes a step, a masked block's too
    (its weight is 0), as the reference computes every block's gradient;
    uncoded, one per microbatch."""
    from repro_torch.core import BerrutGradientCode
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    calls = []
    backward = torch.Tensor.backward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return backward(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "backward", counted)
    cfg = dataclasses.replace(tiny_config(ARCH), compute_dtype="float32")
    for gcode, want in ((BerrutGradientCode(NB, NB), NB * ACCUM),
                        (None, ACCUM)):
        model = build_model(cfg, device="cpu")
        params = dict(model.named_parameters())
        opt = adamw(1e-3)
        step = build_train_step(model, opt, accum=ACCUM, gcode=gcode)
        calls.clear()
        step(params, opt.init(params),
             TokenPipeline(cfg.vocab_size, SEQ, GLOBAL).batch_at(0),
             _masks()[1])
        assert len(calls) == want


def test_train_step_refuses_params_that_are_not_the_models():
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = tiny_config(ARCH)
    model = build_model(cfg, device="cpu")
    opt = adamw(1e-3)
    step = build_train_step(model, opt)
    copies = {k: v.detach().clone() for k, v in model.named_parameters()}
    with pytest.raises(ValueError, match="named_parameters"):
        step(copies, opt.init(copies),
             TokenPipeline(cfg.vocab_size, SEQ, 4).batch_at(0),
             np.ones(1, np.float32))


def test_weighted_loss_identity():
    """∇Σ w_n L_n == Σ w_n ∇L_n: the identity the coded path relies on
    (the reference's ``test_weighted_loss_identity``), on the port."""
    from repro_torch.models import build_model
    cfg = tiny_config("qwen2-7b")
    model = build_model(cfg, device="cpu")
    batch = TokenPipeline(cfg.vocab_size, 16, 4).batch_at(0)
    blocks = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(4)]
    w = [0.4, 0.3, 0.2, 0.1]
    params = list(model.parameters())
    g1 = torch.autograd.grad(sum(wi * model.loss_fn(b)[0]
                                 for wi, b in zip(w, blocks)), params)
    g2 = None
    for wi, b in zip(w, blocks):
        gi = torch.autograd.grad(model.loss_fn(b)[0], params)
        gi = [wi * g for g in gi]
        g2 = gi if g2 is None else [a + c for a, c in zip(g2, gi)]
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)


def test_coded_full_mask_matches_uncoded_and_loss_decreases():
    """The reference's integration cases on the port: with every block
    responding the coded step's loss is the uncoded one's, and 12 coded
    steps lower the loss."""
    from repro_torch.core import BerrutGradientCode
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = tiny_config(ARCH)
    pipe = TokenPipeline(cfg.vocab_size, 32, GLOBAL)
    mask = np.ones(NB, np.float32)
    first = []
    for gcode in (BerrutGradientCode(NB, NB), None):
        model = build_model(cfg, device="cpu")
        params = dict(model.named_parameters())
        opt = adamw(3e-3, weight_decay=0.0)
        state = opt.init(params)
        step = build_train_step(model, opt, accum=ACCUM, gcode=gcode)
        losses = []
        for i in range(12 if gcode else 1):
            params, state, m = step(params, state, pipe.batch_at(i), mask)
            losses.append(float(m["loss"]))
        first.append(losses[0])
        if gcode:
            assert losses[-1] < losses[0], losses
    assert abs(first[0] - first[1]) < 0.05


def test_serve_step_greedy():
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model
    model = build_model(tiny_config("qwen3-14b"), device="cpu")
    serve = build_serve_step(model)
    cache = model.init_cache(2, 32)
    tok = torch.ones((2, 1), dtype=torch.int32)
    for pos in range(4):
        tok, cache = serve(None, cache, tok, pos)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32


# ---- the launcher ---------------------------------------------------------

def _argv(ckpt_dir):
    return ["--tiny", "--device", "cpu", "--coded", "--stragglers", "1",
            "--elastic-at", "3", "--steps", "5", "--seq-len", "16",
            "--global-batch", "8", "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir)]


def _final_state(ckpt_dir):
    import json
    import os
    path = os.path.join(ckpt_dir, "step_00000005")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    return manifest, {k: data[k] for k in data.files}


def test_launcher_resumes_bit_identically(tmp_path, monkeypatch, capsys):
    """A run killed right after its step-2 checkpoint, then re-run with the
    same arguments, ends with the uninterrupted run's parameters and
    optimizer state, bit for bit."""
    from repro_torch.launch import train

    class Killed(Exception):
        pass
    assert train.main(_argv(tmp_path / "whole")) == 0
    save = train.Checkpointer.save

    def save_then_die(self, step, tree, extra=None):
        out = save(self, step, tree, extra)
        if step == 2:
            raise Killed
        return out
    monkeypatch.setattr(train.Checkpointer, "save", save_then_die)
    with pytest.raises(Killed):
        train.main(_argv(tmp_path / "cut"))
    monkeypatch.setattr(train.Checkpointer, "save", save)
    assert train.main(_argv(tmp_path / "cut")) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 2" in out
    m_whole, whole = _final_state(tmp_path / "whole")
    m_cut, cut = _final_state(tmp_path / "cut")
    assert m_whole["hashes"] == m_cut["hashes"]
    assert whole.keys() == cut.keys()
    for k in whole:
        assert whole[k].tobytes() == cut[k].tobytes()
