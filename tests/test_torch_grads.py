"""Gradients of every architecture: the port's ``loss_fn`` and
``backward`` against ``jax.value_and_grad`` of the reference's, on the
CPU.  The counterpart of ``tests/test_models.py::test_smoke_loss_and_grads``
held to numbers.

For each arch of ``configs.ARCHS`` at ``tiny_config`` size in float32
compute, the reference's ``model.init`` parameters, each leaf perturbed so
that biases and norm scales are not 0 and 1, go through
``models.load_jax_params``; both packages take the loss of the same numpy
batch (some targets masked with -1; whisper's frames float32).  The port's
gradients are mapped onto the reference's leaves through the converter's
names (``models.convert._layer_leaves``).

Tolerances:

* the loss within 1e-5 relative;
* each gradient leaf within 1e-4 of that leaf's max |g_ref|: the same
  float32 arithmetic through two autodiff systems, summed in other orders.
  For rwkv6 the bound is twice the reference's own float32 noise where
  that is larger: the distance of its gradients from the same gradients
  with the embedding table moved by float32 rounding (2^-23 n), as the
  forward tests hold it (``tests/test_torch_models.py``): the tiny rwkv's
  group norm rescales heads whose output nearly cancels.

With ``cfg.remat`` on and off the port's gradients are identical: the
recomputation runs the same kernels on the same inputs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, tiny_config
from repro_torch.models import build_model, load_jax_params
from repro_torch.models.convert import _layer_leaves

B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
JITTERED = {"rwkv6-1.6b"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str, remat: bool = True):
    return dataclasses.replace(tiny_config(arch), compute_dtype="float32",
                               remat=remat)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference model, its perturbed params as JAX arrays, as numpy)."""
    import jax
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    cfg = dataclasses.replace(ref_tiny_config(arch), compute_dtype="float32")
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(sum(map(ord, arch)) + 1)
    tree = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) +
                   0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return model, jax.tree.map(jax.numpy.asarray, tree), tree


def _batch(arch: str) -> dict:
    """A numpy batch: tokens and targets (3 masked); M-RoPE streams that
    differ (text, an image grid, text) for qwen2-vl; float32 frames and
    decoder tokens for whisper."""
    cfg = tiny_config(arch)
    rng = np.random.default_rng(11)
    if cfg.encoder_decoder:
        batch = {"frames": rng.standard_normal((B, S, cfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab_size, (B, S // 2))
                 .astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (B, S // 2))
                 .astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32)}
    batch["targets"][0, :3] = -1
    if cfg.mrope_sections:
        pos = np.zeros((3, B, S), np.int32)
        for i in range(B):
            t0 = 1 + i                       # text, a 2 x 3 grid, text
            pos[:, i, :t0] = np.arange(t0)
            grid = np.stack(np.meshgrid(np.arange(2), np.arange(3),
                                        indexing="ij"), -1).reshape(-1, 2)
            pos[0, i, t0:t0 + 6] = t0
            pos[1, i, t0:t0 + 6] = t0 + grid[:, 0]
            pos[2, i, t0:t0 + 6] = t0 + grid[:, 1]
            nxt = t0 + 3
            pos[:, i, t0 + 6:] = np.arange(nxt, nxt + S - t0 - 6)
        batch["mrope_positions"] = pos
    return batch


@functools.lru_cache(maxsize=None)
def _ref_grads(arch: str, jittered: bool = False):
    """The reference's (loss, {port name: gradient})."""
    import jax
    model, params, _ = _reference(arch)
    if jittered:
        table = np.asarray(params["embedding"]["table"])
        rng = np.random.default_rng(99)
        params = dict(params, embedding=dict(params["embedding"]))
        params["embedding"]["table"] = jax.numpy.asarray(
            (table * (1 + 2.0 ** -23 * rng.standard_normal(table.shape)))
            .astype(np.float32))
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss_fn,
                                                  has_aux=True))(
        params, _batch(arch))
    port = build_model(_cfg(arch), device="cpu")
    return float(loss), _layer_leaves(port, jax.tree.map(np.asarray, grads))


def _port_grads(arch: str, remat: bool = True):
    model = build_model(_cfg(arch, remat), device="cpu")
    load_jax_params(model, _reference(arch)[2])
    loss, _ = model.loss_fn({k: torch.from_numpy(v)
                             for k, v in _batch(arch).items()})
    loss.backward()
    # a leaf the loss does not reach (command-r's parallel block leaves
    # norm2 unused) has no .grad; the reference's gradient there is 0
    return float(loss.detach()), {n: (p.grad.numpy().copy() if p.grad is not None
                             else np.zeros(tuple(p.shape), np.float32))
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch):
    want_loss, want = _ref_grads(arch)
    got_loss, got = _port_grads(arch)
    assert np.isfinite(got_loss)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss), \
        (got_loss, want_loss)
    assert got.keys() == want.keys()
    noise = _ref_grads(arch, jittered=True)[1] if arch in JITTERED else None
    for name, g_ref in want.items():
        scale = float(np.abs(g_ref).max())
        err = float(np.abs(got[name] - g_ref).max())
        tol = GRAD_TOL * scale
        if noise is not None:
            tol = max(tol, 2.0 * float(np.abs(noise[name] - g_ref).max()))
        assert err <= tol, (name, err, tol, scale)
    # every leaf receives gradient (3 of the first row's targets masked)
    assert sum(float(np.abs(g).sum()) for g in got.values()) > 0


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_remat_gives_identical_gradients(arch):
    """Per-layer recomputation changes nothing in the numbers; the MoE
    layers' dropped-choice counts are recorded once, not again by the
    recomputation."""
    on_loss, on = _port_grads(arch, remat=True)
    off_loss, off = _port_grads(arch, remat=False)
    assert on_loss == off_loss
    for name in off:
        np.testing.assert_array_equal(on[name], off[name])
    if tiny_config(arch).encoder_decoder:
        return
    for remat in (True, False):
        model = build_model(_cfg(arch, remat), device="cpu")
        drops = []
        logits, aux = model.forward(torch.from_numpy(_batch(arch)["tokens"]),
                                    moe_drops=drops)
        (logits.square().mean() + aux["lb_loss"]).backward()
        n_moe = sum(model.cfg.is_moe_layer(i)
                    for i in range(model.cfg.n_layers))
        assert len(drops) == n_moe


def test_remat_recomputes_each_layer_once(monkeypatch):
    """With remat on, a backward runs each layer's forward once more, and
    under ``torch.no_grad()`` nothing is recomputed: counted through
    ``DecoderLayer.forward``."""
    from repro_torch.models import transformer
    model = build_model(_cfg("qwen2-7b"), device="cpu")
    calls = []
    forward = transformer.DecoderLayer.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return forward(self, *args, **kwargs)
    monkeypatch.setattr(transformer.DecoderLayer, "forward", counted)
    toks = torch.from_numpy(_batch("qwen2-7b")["tokens"])
    with torch.no_grad():
        model.forward(toks)
    assert len(calls) == model.cfg.n_layers
    calls.clear()
    logits, _ = model.forward(toks)
    assert len(calls) == model.cfg.n_layers
    logits.sum().backward()
    assert len(calls) == 2 * model.cfg.n_layers
