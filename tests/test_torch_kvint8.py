"""The int8 KV cache (``repro_torch.models.attention``: the int8 branch of
``init_kv_cache``, ``_quantize_kv`` and the decode's quantized write and
dequantized read) against the reference's, on the CPU.

* ``init_cache`` of an int8 config: int8 ``k``/``v`` payloads and float16
  ``k_scale``/``v_scale`` per (token, kv head), the reference's shapes and
  dtypes, for every tiny architecture with a GQA cache.
* ``_quantize_kv``: payload and scales bit-identical to the reference's on
  the same rows (``torch.round`` and ``jnp.round`` both round half to even),
  at the tiny configs' (B, 1, KV, hd), ties included.
* The decode: 6 float32 steps from the reference's parameters
  (``load_jax_params``); every row the port wrote into its cache is the
  reference's ``_quantize_kv`` of the row the port quantized, bit for bit,
  and the logits lie within 1e-4 of max |logits| of the reference's int8
  decode.
* The serve loop's cache operations carry the scale leaves:
  ``ContinuousBatcher._zero_slot`` and ``_gather_cache`` on an int8 cache,
  and a coded serve of an int8 config.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import attention, build_model, load_jax_params

# every tiny architecture whose decode keeps a GQA cache in some layer
GQA_ARCHS = ["qwen2-7b", "qwen3-14b", "phi3-mini-3.8b", "command-r-35b",
             "llama4-scout-17b-a16e", "qwen2-vl-72b", "jamba-v0.1-52b"]
STEPS, B, MAX_LEN = 6, 2, 8
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card case runs there")
    return torch.device("cuda")


def _int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8",
                               compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference model, its params, the numpy tree) of the int8 tiny
    config."""
    import jax
    from repro.configs import tiny_config as ref_tiny
    from repro.models import build_model as ref_build
    model = ref_build(_int8(ref_tiny(arch)))
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(arch: str, device="cpu"):
    return load_jax_params(build_model(_int8(tiny_config(arch)),
                                       device=device),
                           _reference(arch)[2])


def _tokens(arch: str):
    cfg = tiny_config(arch)
    return np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (B, STEPS)).astype(np.int32)


def _attn_layers(model):
    return [i for i, layer in enumerate(model.layers)
            if layer.desc.mixer == "attn"]


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_init_cache_matches_reference(arch):
    ref_model = _reference(arch)[0]
    want = ref_model.init_cache(B, MAX_LEN)
    model = build_model(_int8(tiny_config(arch)), device="cpu")
    got = model.init_cache(B, MAX_LEN)
    n_pre, period = model.n_pre, model.period
    for i in _attn_layers(model):
        if i < n_pre:
            ref = want["prelude"][i]
        else:
            ref = {k: v[0] for k, v in
                   want["groups"][f"pos{(i - n_pre) % period}"].items()}
        assert set(got[i]) == {"k", "v", "k_scale", "v_scale"} == set(ref)
        for key, leaf in got[i].items():
            assert tuple(leaf.shape) == tuple(ref[key].shape), key
            assert str(leaf.dtype).split(".")[-1] == str(ref[key].dtype)
            assert not leaf.any()


@pytest.mark.parametrize("shape", [(2, 1, 2, 16), (2, 1, 4, 16),
                                   (3, 1, 1, 24), (1, 1, 8, 128)])
def test_quantize_kv_bit_identical(shape):
    import jax.numpy as jnp
    from repro.models.attention import _quantize_kv as ref_quantize
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    # exact halves of the grid: x / scale = k + 1/2 for a row's others
    amax = np.abs(x).max(axis=-1, keepdims=True)
    ties = (np.floor(x / (amax / 127.0)) + 0.5) * (amax / 127.0)
    x[..., 1:-1:2] = ties[..., 1:-1:2].astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    for rows in (x, np.zeros(shape, np.float32)):
        q, s = attention._quantize_kv(torch.from_numpy(rows))
        rq, rs = ref_quantize(jnp.asarray(rows))
        assert q.dtype == torch.int8 and s.dtype == torch.float16
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy().view(np.uint16),
                                      np.asarray(rs).view(np.uint16))


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_decode_matches_reference(arch, monkeypatch):
    """Logits within 1e-4 of the reference's int8 decode; every row the
    port quantized lands in its cache bit-identical to the reference's
    quantization of that row."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import _quantize_kv as ref_quantize
    ref_model, params, _ = _reference(arch)
    model = _port(arch)
    toks = _tokens(arch)
    seen = []
    real = attention._quantize_kv

    def recording(x):
        seen.append(x.detach().clone())
        return real(x)
    monkeypatch.setattr(attention, "_quantize_kv", recording)
    cache = model.init_cache(B, MAX_LEN)
    step = jax.jit(ref_model.decode_step)
    ref_cache = ref_model.init_cache(B, MAX_LEN)
    layers = _attn_layers(model)
    with torch.no_grad():
        for t in range(STEPS):
            seen.clear()
            got, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
            want, ref_cache = step(params, ref_cache,
                                   jnp.asarray(toks[:, t:t + 1]), t)
            want = np.asarray(want, np.float32)
            err = float(np.abs(got.numpy() - want).max())
            assert err <= LOGIT_TOL * float(np.abs(want).max()), (t, err)
            # k then v, layer by layer: the rows written at position t
            assert len(seen) == 2 * len(layers)
            for n, i in enumerate(layers):
                for kind, x in zip("kv", seen[2 * n:2 * n + 2]):
                    rq, rs = ref_quantize(jnp.asarray(x.numpy()))
                    np.testing.assert_array_equal(
                        cache[i][kind][:, t].numpy(), np.asarray(rq)[:, 0])
                    np.testing.assert_array_equal(
                        cache[i][f"{kind}_scale"][:, t].numpy().view(
                            np.uint16),
                        np.asarray(rs)[:, 0].view(np.uint16))


def _filled_int8_cache():
    model = build_model(_int8(tiny_config("qwen2-7b")), device="cpu")
    cache = model.init_cache(4, MAX_LEN)
    gen = torch.Generator().manual_seed(3)
    for layer in cache:
        for key, leaf in layer.items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape,
                                         generator=gen, dtype=torch.int8))
            else:
                leaf.copy_(torch.rand(leaf.shape, generator=gen).half())
    return cache


def test_zero_slot_and_gather_cache_carry_the_scales():
    from repro_torch.runtime.serve_loop import ContinuousBatcher
    cache = _filled_int8_cache()
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    ContinuousBatcher._zero_slot(cache, 2)
    for layer, old in zip(cache, before):
        assert set(layer) == {"k", "v", "k_scale", "v_scale"}
        for key, leaf in layer.items():
            assert not leaf[2].any(), key
            keep = [0, 1, 3]
            assert torch.equal(leaf[keep], old[key][keep]), key
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    perm = [3, 0, 1, 2]
    ContinuousBatcher._gather_cache(cache, perm)
    for layer, old in zip(cache, before):
        for key, leaf in layer.items():
            assert torch.equal(leaf, old[key][perm]), key


def test_serve_of_an_int8_config_writes_the_scales_in_place():
    """A coded serve of an int8 config: every step writes through the
    bucket views (``_merge_cache`` asserts it for all four leaves) and
    every request gets its tokens."""
    from repro_torch.api import ClusterSpec, Session
    cfg = _int8(tiny_config("qwen2-7b"))
    with Session(ClusterSpec.serve_deadline(coded_layers="all"),
                 device="cpu") as s:
        rep = s.serve(arch=cfg, tiny=True, batch=2, prompt_len=4, gen=3,
                      check_agreement=False)
        model = next(iter(s._serve_models.values()))
    assert model.cfg.kv_cache_dtype == "int8"
    assert [len(r.tokens) for r in rep.requests] == [3, 3]


def test_cuda_int8_decode_matches_the_cpu(cuda):
    """The int8 decode on the card against the same model's on the CPU:
    logits within 1e-4 of max |logits| over 6 float32 steps."""
    cfg = _int8(tiny_config("qwen2-7b"))
    toks = torch.from_numpy(_tokens("qwen2-7b")).long()
    weights = dict(build_model(cfg, device="cpu").named_parameters())
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=0)
        with torch.no_grad():              # the CPU model's weights
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        cache = model.init_cache(B, MAX_LEN)
        assert cache[0]["k"].dtype == torch.int8
        assert cache[0]["k_scale"].dtype == torch.float16
        rows = []
        with torch.no_grad():
            for t in range(STEPS):
                lg, cache = model.decode_step(cache,
                                              toks[:, t:t + 1].to(dev), t)
                rows.append(lg.float().cpu())
        out[str(dev)] = torch.stack(rows)
    want = out["cpu"]
    err = float((out["cuda"] - want).abs().max())
    assert err <= LOGIT_TOL * float(want.abs().max()), err
