"""The port's encoder-decoder (``repro_torch.models.encdec.EncDecLM``,
whisper-small) against the JAX package's ``repro.models.encdec``, on the
CPU.

The reference's ``init`` parameters at ``tiny_config`` size (2 encoder
and 2 decoder layers, d 64, 4 heads of 16, layernorm, gelu), each leaf
perturbed so that biases and norm scales are not 0 and 1, go through
``models.load_jax_params``; the same numpy frame embeddings (the stubbed
audio frontend) and tokens then go through both packages' ``encode``,
``forward``, ``loss_fn`` and ``decode_step``.  Tolerances, of the
reference's max |value|: float32 compute 1e-4, bfloat16 2e-2.

Decode is held two ways: against the reference's ``decode_step`` on the
same hand-filled cache (the cross rows each layer's ``project_kv`` of the
encoder output, the rest of the ``CROSS_LEN`` rows zero, as the reference
attends them), and against the port's own teacher-forced forward (a cross
cache of exactly the encoder's rows).

Whisper is not served by either package: the reference's
``Session.serve`` fails on it (``KeyError: 'prelude'``, its batcher slices
a ``TransformerLM`` cache), and the port's refuses it by name.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import EncDecLM, build_model, load_jax_params
from repro_torch.models import attention as attn
from repro_torch.models.encdec import CROSS_LEN

ARCH = "whisper-small"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S_ENC, S_DEC = 2, 32, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype: str):
    return dataclasses.replace(tiny_config(ARCH), compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    """(reference model, its params as JAX arrays, the same as numpy)."""
    import jax
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    cfg = dataclasses.replace(ref_tiny_config(ARCH), compute_dtype=dtype)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(23)
    tree = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) +
                   0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return model, jax.tree.map(jax.numpy.asarray, tree), tree


def _port(dtype: str):
    return load_jax_params(build_model(_cfg(dtype), device="cpu"),
                           _reference(dtype)[2])


def _frames(seed: int = 0, b: int = B, s: int = S_ENC) -> np.ndarray:
    """Seeded frame embeddings, rounded to bfloat16 as
    ``repro.models.input_specs`` types them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, tiny_config(ARCH).d_model))
    return torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16).float().numpy()


def _tokens(seed: int = 0, b: int = B, s: int = S_DEC) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, tiny_config(ARCH).vocab_size, (b, s)).astype(
        np.int32)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    import jax
    ref_model, params, _ = _reference(dtype)
    frames = _frames()
    want = jax.jit(ref_model.encode)(params, frames)
    with torch.no_grad():
        got = _port(dtype).encode(torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    import jax
    ref_model, params, _ = _reference(dtype)
    frames, toks = _frames(1), _tokens(1)
    want, want_aux = jax.jit(ref_model.forward)(params, frames, toks)
    with torch.no_grad():
        got, aux = _port(dtype).forward(torch.from_numpy(frames),
                                        torch.from_numpy(toks))
    assert aux == want_aux == {}
    assert tuple(got.shape) == (B, S_DEC, tiny_config(ARCH).vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_reference(dtype):
    import jax
    ref_model, params, _ = _reference(dtype)
    targets = _tokens(3)
    targets[0, :3] = -1                       # masked positions
    batch = {"frames": _frames(2), "tokens": _tokens(2), "targets": targets}
    want, want_m = jax.jit(ref_model.loss_fn)(params, batch)
    with torch.no_grad():
        got, got_m = _port(dtype).loss_fn({k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    assert set(got_m) == set(want_m) == {"ce"}
    assert abs(float(got) - float(want)) <= TOL[dtype] * abs(float(want))
    assert float(got_m["ce"]) == float(got)


def _ref_cache_filled(ref_model, params, enc, max_len: int):
    """The reference's ``init_cache`` with each layer's cross rows [0,
    S_enc) set to its ``project_kv`` of ``enc``: (cache, the rows as
    numpy, layer by layer)."""
    import jax.numpy as jnp
    from repro.models import attention as ref_attn
    cfg = ref_model.cfg
    cache = ref_model.init_cache(B, max_len)
    s = enc.shape[1]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (B, s))
    rows = []
    ks, vs = cache["cross"]["k"], cache["cross"]["v"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["decoder"]["cross_attn"].items()}
        k, v = ref_attn.project_kv(lp, enc, cfg, pos)
        ks = ks.at[i, :, :s].set(k.astype(ks.dtype))
        vs = vs.at[i, :, :s].set(v.astype(vs.dtype))
        rows.append((np.asarray(k, np.float32), np.asarray(v, np.float32)))
    cache = dict(cache, cross={"k": ks, "v": vs})
    return cache, rows


def test_decode_matches_reference():
    """Eight decode steps, float32 compute, from the same hand-filled cache:
    the cross rows from each package's own ``project_kv`` (held against
    each other first), the remaining ``CROSS_LEN`` rows zero."""
    import jax
    ref_model, params, _ = _reference("float32")
    frames, toks = _frames(4), _tokens(4)
    enc_ref = jax.jit(ref_model.encode)(params, frames)
    ref_cache, rows = _ref_cache_filled(ref_model, params, enc_ref, 16)
    model = _port("float32")
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames))
        assert _rel(enc, enc_ref) <= TOL["float32"]
        cache = model.init_cache(B, 16)
        for layer, lc, (k_ref, v_ref) in zip(model.decoder, cache, rows):
            k, v = attn.project_kv(layer.cross_attn, enc, model.cfg)
            assert _rel(k, k_ref) <= TOL["float32"]
            assert _rel(v, v_ref) <= TOL["float32"]
            lc["cross"]["k"][:, :S_ENC] = k
            lc["cross"]["v"][:, :S_ENC] = v
        step = jax.jit(ref_model.decode_step)
        for t in range(S_DEC):
            tok = toks[:, t:t + 1]
            want, ref_cache = step(params, ref_cache, tok, np.int32(t))
            got, cache = model.decode_step(cache, torch.from_numpy(tok), t)
            assert tuple(got.shape) == (B, 1, model.cfg.vocab_size)
            assert _rel(got, want) <= TOL["float32"], (t, _rel(got, want))
        hidden, _ = model.decode_step(cache, torch.from_numpy(toks[:, :1]),
                                      S_DEC, return_hidden=True)
    want_h, _ = jax.jit(functools.partial(ref_model.decode_step,
                                          return_hidden=True))(
        params, ref_cache, toks[:, :1], np.int32(S_DEC))
    assert tuple(hidden.shape) == (B, 1, model.cfg.d_model)
    assert _rel(hidden, want_h) <= TOL["float32"]


def test_decode_matches_forward():
    """The port's own contract: teacher-forced decode steps over a cross
    cache of exactly the encoder's rows give the forward's logits, float32
    compute, at 1e-4 of max |forward|."""
    model = build_model(_cfg("float32"), device="cpu", seed=3)
    frames = torch.from_numpy(_frames(5, b=1))
    toks = torch.from_numpy(_tokens(5, b=1))
    with torch.no_grad():
        full, _ = model.forward(frames, toks)
        enc = model.encode(frames)
        cache = model.init_cache(1, S_DEC)
        for layer, lc in zip(model.decoder, cache):
            k, v = attn.project_kv(layer.cross_attn, enc, model.cfg)
            lc["cross"] = {"k": k, "v": v}
        steps = []
        for t in range(S_DEC):
            logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
            steps.append(logits[:, 0])
    assert _rel(torch.stack(steps, dim=1), full.numpy()) <= TOL["float32"]


def test_init_cache_structure():
    """One ``{"self", "cross"}`` per decoder layer, like the reference's
    stacked cache: self rows ``max_len``, cross rows ``CROSS_LEN`` (the
    reference's 4096), zeros in the compute dtype."""
    from repro.models.encdec import CROSS_LEN as REF_CROSS_LEN
    ref_model, _, _ = _reference("bfloat16")
    ref_cache = ref_model.init_cache(B, 12)
    model = build_model(_cfg("bfloat16"), device="cpu")
    cache = model.init_cache(B, 12)
    cfg = model.cfg
    assert CROSS_LEN == REF_CROSS_LEN == 4096
    assert len(cache) == cfg.n_layers
    for i, lc in enumerate(cache):
        assert set(lc) == {"self", "cross"}
        for part, rows in (("self", 12), ("cross", CROSS_LEN)):
            assert set(lc[part]) == {"k", "v"}
            for name, leaf in lc[part].items():
                want = ref_cache[part][name]
                assert tuple(leaf.shape) == tuple(want.shape[1:]) == \
                    (B, rows, cfg.n_kv_heads_padded, cfg.head_dim_)
                assert leaf.dtype == torch.bfloat16
                assert not leaf.any()


@pytest.mark.parametrize("n,d", [(32, 64), (4096, 768), (7, 10)])
def test_sinusoidal_positions_match_reference(n, d):
    """Within 2e-6 plus two float32 ulps of each entry's angle: the two
    libraries' ``pow`` may round 10000^(2i/d) one ulp apart, which moves
    an angle near 4096 by up to 2.4e-4."""
    from repro.models.layers import sinusoidal_positions as ref_sin
    from repro_torch.models.layers import sinusoidal_positions
    want = np.asarray(ref_sin(n, d))
    got = sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    angle = np.arange(n)[:, None] / 10000.0 ** (2.0 * np.arange(d // 2) / d)
    tol = 2e-6 + 2 * 2.0 ** -23 * np.concatenate([angle, angle], axis=-1)
    assert (np.abs(got.numpy() - want) <= tol).all()
    assert np.abs(got.numpy()[:64] - want[:64]).max() <= 2e-6
    assert sinusoidal_positions(n, d, torch.bfloat16).dtype == \
        torch.bfloat16


def test_decode_step_refuses_per_slot_positions():
    model = build_model(_cfg("float32"), device="cpu")
    cache = model.init_cache(B, 8)
    tok = torch.from_numpy(_tokens(6, s=1))
    with pytest.raises(ValueError, match="scalar pos"):
        model.decode_step(cache, tok, torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="scalar pos"):
        model.decode_step(cache, tok, np.array([0, 1], np.int32))
    logits, _ = model.decode_step(cache, tok, torch.tensor(0))
    assert tuple(logits.shape) == (B, 1, model.cfg.vocab_size)


# --------------------------------------------------------------------------
# the converter and the model zoo
# --------------------------------------------------------------------------

def _leaves(prefix: str, node):
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _leaves(f"{prefix}.{key}" if prefix else key, value)
    else:
        yield prefix, node


def test_converter_carries_the_encdec_tree():
    """Every leaf of the reference's tree lands, value for value, in the
    port's parameter of the same path (the encoder's and the decoder's
    stacked leaves one per layer), and every port parameter gets one."""
    tree = _reference("float32")[2]
    model = _port("float32")
    params = {k: v.detach().numpy() for k, v in model.named_parameters()}
    seen = {}
    for side, n in (("encoder", model.cfg.n_encoder_layers),
                    ("decoder", model.cfg.n_layers)):
        for name, arr in _leaves("", tree[side]):
            assert arr.shape[0] == n, (side, name)
            for g in range(n):
                seen[f"{side}.{g}.{name}"] = arr[g]
    for key in ("embedding", "enc_norm", "final_norm"):
        seen.update(_leaves(key, tree[key]))
    assert set(seen) == set(params)
    for name, arr in seen.items():
        np.testing.assert_array_equal(params[name], arr, err_msg=name)
    assert "decoder.1.cross_attn.wq" in params
    assert "encoder.1.norm2.bias" in params       # layernorm


def _break(tree, how: str):
    tree = dict(tree)
    if how == "missing":
        tree["enc_norm"] = {}
    elif how == "extra":
        tree["enc_norm"] = dict(tree["enc_norm"], shift=np.zeros(64))
    else:
        dec = dict(tree["decoder"])
        cross = dict(dec["cross_attn"])
        cross["wk"] = np.swapaxes(cross["wk"], 1, 3)    # (L, hd, KV, d)
        dec["cross_attn"] = cross
        tree["decoder"] = dec
    return tree


@pytest.mark.parametrize("how", ["missing", "extra", "misshapen"])
def test_converter_raises_on_an_encdec_tree_that_does_not_fit(how):
    tree = _reference("float32")[2]
    model = build_model(_cfg("float32"), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=how if how != "misshapen"
                       else "shape"):
        load_jax_params(model, _break(tree, how))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k             # nothing was copied


def test_converter_refuses_a_stack_of_the_wrong_depth():
    tree = dict(_reference("float32")[2])
    tree["encoder"] = {"norm1": {"scale": np.ones((3, 64), np.float32)}}
    with pytest.raises(ValueError, match="leading axis"):
        load_jax_params(build_model(_cfg("float32"), device="cpu"), tree)


def test_build_model_routes_the_encoder_decoder():
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    from repro.models.encdec import EncDecLM as RefEncDecLM
    model = build_model(tiny_config(ARCH), device="cpu")
    assert isinstance(model, EncDecLM)
    assert isinstance(ref_build_model(ref_tiny_config(ARCH)), RefEncDecLM)
    assert len(model.encoder) == 2 and len(model.decoder) == 2
    assert not isinstance(build_model(tiny_config("qwen2-vl-72b"),
                                      device="cpu"), EncDecLM)


# --------------------------------------------------------------------------
# serving: refused, as the reference cannot serve it either
# --------------------------------------------------------------------------

def test_serve_refuses_the_encoder_decoder(monkeypatch, capsys):
    """The port's ``Session.serve`` and ``launch.serve`` raise the named
    ``ValueError`` before any model is built; the reference's
    ``Session.serve`` fails on whisper with ``KeyError: 'prelude'``."""
    from repro import api as ref_api
    from repro_torch.api import ClusterSpec, Session
    from repro_torch.launch import serve as launch
    from repro_torch.models import zoo

    def no_build(*args, **kwargs):
        raise AssertionError("a model was built")

    with ref_api.Session(ref_api.ClusterSpec.serve_deadline()) as s:
        with pytest.raises(KeyError, match="prelude"):
            s.serve(arch=ARCH, tiny=True, batch=1, prompt_len=2, gen=1)
    monkeypatch.setattr(zoo, "build_model", no_build)
    monkeypatch.setattr("repro_torch.models.build_model", no_build)
    with Session(ClusterSpec.serve_deadline(), device="cpu") as s:
        with pytest.raises(ValueError, match="no encoder-decoder path"):
            s.serve(arch=ARCH, tiny=True, batch=1, prompt_len=2, gen=1)
        with pytest.raises(ValueError, match="no encoder-decoder path"):
            s.serve(arch=tiny_config(ARCH), batch=1, prompt_len=2, gen=1)
        assert not s._serve_models
    with pytest.raises(ValueError, match="no encoder-decoder path"):
        launch.main(["--arch", ARCH, "--tiny", "--device", "cpu"])
    assert "served" not in capsys.readouterr().out


# --------------------------------------------------------------------------
# on the card: the forward through the flash kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_forward_launches_the_kernel_36_times(cuda):
    """At whisper-small's depth (12 encoder and 12 decoder layers, tiny
    widths) one forward launches the flash kernel 12 (encoder, full) + 12
    (decoder self, causal) + 12 (cross, full) = 36 times, and agrees with
    the plain attention to 1e-4 in float32."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    cfg = dataclasses.replace(_cfg("float32"), n_layers=12,
                              n_encoder_layers=12)
    model = build_model(cfg, device=cuda)
    frames = torch.from_numpy(_frames(7)).to(cuda)
    toks = torch.from_numpy(_tokens(7)).to(cuda)
    with torch.inference_mode():
        n0 = flash_attention_kernel.launches
        got, _ = model.forward(frames, toks)
        assert flash_attention_kernel.launches - n0 == 36
        want, _ = model.forward(frames, toks, force_kernel=False)
        assert flash_attention_kernel.launches - n0 == 36
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL["float32"], err
