"""Continuous-batching coded serving (``repro_torch.models.coded``,
``runtime.serve_loop``, ``Session.serve``, ``launch.serve``) against the
JAX package on the CPU, and the port's own serving contracts.

The reference's parameters (tiny qwen2-7b, every leaf perturbed so that
biases and norm scales are not 0 and 1) are carried into the port by
``models.load_jax_params``; the reference runs on the CPU as its own tests
run it.  Tolerances:

* shards, a site's product and ``precoded_matmul``: 1e-5 of max |ref|
  (float32 sums in other orders; spacdc is handed the reference's
  JAX-drawn noise);
* a teacher-forced step's logits: 1e-4 of max |ref| in float32 compute,
  2e-2 in bfloat16 (``PERF.md`` §2), and the argmax wherever the
  reference's top-2 margin exceeds twice that.  The reference's own claim,
  coded tokens bit-identical to plain ones, fails at a near-tie in the
  argmax (ROADMAP §3), so tokens are not taken as ground truth;
* scheduling (admission, eviction, buckets, tokens per request, the
  plans' responders, ``n_waited`` and waits) exactly, with the measured
  step wall and worker time replaced by constants in both packages, since
  the virtual clock adds each package's own measurements.

The MLA case (``tests/test_serve.py:68``, ``deepseek-v2-lite-16b``: MLA's
wq|w_dkv and wo sites coded in every layer, the dense prelude layer's FFN
coded, the MoE FFNs uncoded) is held the same way: its sites and shards
against the reference's, its teacher-forced float32 step logits against
the reference's, its bfloat16 coded step against the port's plain step and
its encrypted step bit for bit against its plain coded step.

``qwen2-vl-72b`` is held as qwen2-7b is (teacher-forced coded logits,
exact scheduling): the serve step decodes it with plain RoPE, as the
reference's does.

The SSM archs (``rwkv6-1.6b``: no site but the unembed; ``jamba``: its
attention layer's and dense FFNs' sites, mamba mixers and MoE FFNs
uncoded) are held the same way, and by exact scheduling; a slot reused
after an eviction serves its request as a fresh slot does, because
admission zeroes its recurrent state.

The ``cuda`` cases run on the card and import no JAX.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, CryptoSpec, ServeReport,
                             ServeSpec, Session, StragglerSpec,
                             TransportSpec, WaitSpec)
from repro_torch.configs import get_config, tiny_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, load_jax_params
from repro_torch.models.coded import (_coded_apply, build_coded_step,
                                      coded_flop_fraction,
                                      encode_serving_weights)
from repro_torch.runtime.engine import RoundEngine
from repro_torch.runtime.serve_loop import (ContinuousBatcher, Request,
                                            poisson_workload)

ARCH = "qwen2-7b"
MLA_ARCH = "deepseek-v2-lite-16b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SITE_TOL = 1e-5
WALL_S = 2e-3              # the injected step wall of the scheduling cases
T_COMP_S = 1e-4            # the injected per-site worker time


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def exact_spec(coded_layers="all", *, backend="virtual", max_slots=4,
               eos_id=None, crypto=None, fused=None):
    """MDS + wait-for-all + no stragglers (``tests/test_serve.py:18``): the
    decode is exact up to float32 rounding — the parity configuration."""
    kw = dict(code=CodeSpec(scheme="mds", n_workers=8, k_blocks=4,
                            fused=fused),
              wait=WaitSpec(policy="first_k", k=8),
              straggler=StragglerSpec(n_stragglers=0),
              transport=TransportSpec(backend=backend),
              serve=ServeSpec(coded_layers=coded_layers, max_slots=max_slots,
                              eos_id=eos_id))
    if crypto is not None:
        kw["crypto"] = crypto
    return ClusterSpec(**kw)


def ref_exact_spec(coded_layers="all", *, max_slots=4, eos_id=None):
    from repro import api
    return api.ClusterSpec(
        code=api.CodeSpec(scheme="mds", n_workers=8, k_blocks=4),
        wait=api.WaitSpec(policy="first_k", k=8),
        straggler=api.StragglerSpec(n_stragglers=0),
        serve=api.ServeSpec(coded_layers=coded_layers, max_slots=max_slots,
                            eos_id=eos_id))


def ragged_requests(n=5, vocab=256, seed=3, rate=None):
    """``tests/test_serve.py``'s ragged workload, draw for draw."""
    rng = np.random.default_rng(seed)
    arr = np.zeros(n)
    if rate:
        arr = np.cumsum(rng.exponential(1.0 / rate, n))
        arr -= arr[0]
    return [Request(rid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(3, 9)))
                    .astype(np.int32),
                    gen=int(rng.integers(2, 7)), arrival_s=float(arr[i]))
            for i in range(n)]


def _ref_requests(reqs):
    from repro.runtime.serve_loop import Request as RefRequest
    return [RefRequest(rid=r.rid, prompt=r.prompt, gen=r.gen,
                       arrival_s=r.arrival_s) for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference(dtype: str, arch: str = ARCH):
    """(reference model, its params as JAX arrays, the same as numpy)."""
    import jax
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    cfg = dataclasses.replace(ref_tiny_config(arch), compute_dtype=dtype)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tree = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) +
                   0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return model, jax.tree.map(jax.numpy.asarray, tree), tree


def _port(dtype: str, arch: str = ARCH):
    cfg = dataclasses.replace(tiny_config(arch), compute_dtype=dtype)
    return load_jax_params(build_model(cfg, device="cpu"),
                           _reference(dtype, arch)[2])


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _argmax_agrees(got, want, tol: float):
    """Indices of rows whose argmax differs although ``want``'s top-2
    margin exceeds 2 * tol * max |want| (empty when the rule holds)."""
    got, want = _np(got), _np(want)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(want).max()
    return np.flatnonzero(clear & (got.argmax(-1) != want.argmax(-1)))


# --------------------------------------------------------------------------
# the reference's step up to its logits
# --------------------------------------------------------------------------

def _ref_coded_logits(model, scheme, code, params, cache, tokens, pos, mask):
    """The body of the reference's ``build_coded_step`` (``models/coded.py``
    of the JAX package) up to the argmax, from its own functions: the
    reference returns only tokens, and these tests compare logits."""
    import jax
    from repro.models.coded import _coded_apply as ref_apply
    from repro.models.coded import _layer_proj as ref_proj
    from repro.models.layers import apply_norm, embed, unembed
    from repro.models.transformer import decode_layer, layer_desc
    cfg = model.cfg
    dec_w = scheme.decode_matrix_masked(mask)
    x = embed(params["embedding"], tokens, cfg)
    prelude = []
    for i, lp in enumerate(params["prelude"]):
        desc = layer_desc(cfg, i)
        proj = ref_proj(cfg, desc, code.prelude_meta[i],
                        code.arrays["prelude"][i], dec_w,
                        force_kernel=scheme.use_kernel)
        x, c = decode_layer(lp, x, cfg, desc, cache=cache["prelude"][i],
                            pos=pos, proj=proj)
        prelude.append(c)

    def body(x, xs):
        gp, gc, gw = xs
        new = {}
        for i in range(model.period):
            desc = model.descs[i]
            proj = ref_proj(cfg, desc, code.group_meta[f"pos{i}"],
                            gw[f"pos{i}"], dec_w,
                            force_kernel=scheme.use_kernel)
            x, new[f"pos{i}"] = decode_layer(gp[f"pos{i}"], x, cfg, desc,
                                             cache=gc[f"pos{i}"], pos=pos,
                                             proj=proj)
        return x, new

    x, groups = jax.lax.scan(body, x, (params["groups"], cache["groups"],
                                       code.arrays["group"]))
    x = apply_norm(params["final_norm"], x, cfg)
    if code.unembed_meta is not None:
        logits = ref_apply(code.arrays["unembed"], x[:, 0, :], dec_w,
                           code.unembed_meta, force_kernel=scheme.use_kernel)
    else:
        logits = unembed(params["embedding"], x, cfg)[:, 0, :]
    return logits, {"prelude": prelude, "groups": groups}


# a teacher-forced stream: B slots at ragged positions, random tokens
STREAM_B, STREAM_T, STREAM_OFF = 4, 8, np.array([0, 2, 1, 3])
STREAM_TOKENS = np.random.default_rng(2).integers(
    1, 256, (STREAM_B, STREAM_T)).astype(np.int32)


def _ref_stream_logits(dtype: str, coded_layers: str, arch: str = ARCH):
    import jax
    from repro.models.coded import encode_serving_weights as ref_encode
    from repro.runtime.engine import RoundEngine as RefEngine
    model, params, _ = _reference(dtype, arch)
    engine = RefEngine(ref_exact_spec(coded_layers))
    code = ref_encode(engine.scheme, model, params, coded_layers)
    fn = jax.jit(functools.partial(_ref_coded_logits, model, engine.scheme,
                                   code))
    cache = model.init_cache(STREAM_B, 16)
    mask = np.ones(8, np.float32)
    out = []
    for t in range(STREAM_T):
        pos = (t + STREAM_OFF).astype(np.int32)
        logits, cache = fn(params, cache, STREAM_TOKENS[:, t:t + 1], pos,
                           mask)
        out.append(np.asarray(logits, np.float32))
    engine.close()
    return out


def _port_stream_logits(model, coded_layers: str, spec=None, wire=False):
    engine = RoundEngine(spec or exact_spec(coded_layers), device="cpu")
    code = encode_serving_weights(engine.scheme, model, coded_layers)
    step = build_coded_step(model, engine.scheme, code,
                            wire_params=engine.serve_wire_params())
    cache = model.init_cache(STREAM_B, 16)
    mask = torch.ones(8)
    out = []
    for t in range(STREAM_T):
        pos = torch.from_numpy((t + STREAM_OFF).astype(np.int32))
        mats = code.step_materials(engine) if wire else None
        logits, cache = step.logits(
            cache, torch.from_numpy(STREAM_TOKENS[:, t:t + 1]).long(), pos,
            mask, mats)
        out.append(logits)
    engine.close()
    return out


# --------------------------------------------------------------------------
# site level
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["mds", "spacdc"])
def test_encoded_shards_match_reference(scheme):
    """Every site's (N, blk, d_in) shards of ``coded_layers="all"``; spacdc
    (T=1) takes the reference's noise blocks."""
    from repro import api
    from repro.models.coded import encode_serving_weights as ref_encode
    from repro.runtime.engine import RoundEngine as RefEngine
    model, params, _ = _reference("float32")
    kw = dict(n_workers=8, k_blocks=4)
    ref_spec = api.ClusterSpec.serve_deadline(coded_layers="all", **kw) \
        if scheme == "spacdc" else ref_exact_spec("all")
    port_spec = ClusterSpec.serve_deadline(coded_layers="all", **kw) \
        if scheme == "spacdc" else exact_spec("all")
    ref_engine = RefEngine(ref_spec)
    rcode = ref_encode(ref_engine.scheme, model, params, "all")
    port = _port("float32")
    engine = RoundEngine(port_spec, device="cpu")
    noise = None
    if scheme == "spacdc":
        noise = {}
        for i in range(port.cfg.n_layers):
            for name, meta in rcode.group_meta["pos0"].items():
                noise[(i, name)] = np.asarray(ref_engine.scheme.make_noise(
                    (meta.blk, meta.d_in)))
        um = rcode.unembed_meta
        noise[(None, "unembed")] = np.asarray(
            ref_engine.scheme.make_noise((um.blk, um.d_in)))
    code = encode_serving_weights(engine.scheme, port, "all", noise=noise)
    for i in range(port.cfg.n_layers):
        for name, want in rcode.arrays["group"]["pos0"].items():
            got = code.layer_shards[i][name]
            assert dataclasses.astuple(code.layer_meta[i][name]) == \
                dataclasses.astuple(rcode.group_meta["pos0"][name])
            assert _rel(got, np.asarray(want)[i]) <= SITE_TOL, (i, name)
    assert dataclasses.astuple(code.unembed_meta) == \
        dataclasses.astuple(rcode.unembed_meta)
    assert _rel(code.unembed_shards,
                np.asarray(rcode.arrays["unembed"])) <= SITE_TOL
    assert code.n_instances == 4 * port.cfg.n_layers + 1
    ref_engine.close()
    engine.close()


def test_coded_apply_and_precoded_matmul_match_reference():
    """A site's product and the serving matmul at float32, a masked
    spacdc decode (two stragglers)."""
    import jax.numpy as jnp
    from repro.kernels.ops import precoded_matmul as ref_precoded
    from repro.models.coded import SiteMeta as RefMeta
    from repro.models.coded import _coded_apply as ref_apply
    from repro.models.coded import SiteMeta
    from repro.core.spacdc import SPACDCCode as RefCode
    from repro.core.spacdc import SPACDCConfig as RefConfig
    from repro_torch.core import SPACDCCode, SPACDCConfig
    rng = np.random.default_rng(5)
    shards = rng.standard_normal((8, 25, 48)).astype(np.float32)
    x = rng.standard_normal((3, 48)).astype(np.float32)
    mask = np.ones(8, np.float32)
    mask[[2, 6]] = 0.0
    rcode = RefCode(RefConfig(n_workers=8, k_blocks=4, t_colluding=1))
    pcode = SPACDCCode(SPACDCConfig(n_workers=8, k_blocks=4, t_colluding=1))
    rw = rcode.decode_matrix_masked(jnp.asarray(mask))
    pw = pcode.decode_matrix_masked(torch.from_numpy(mask))
    assert _rel(pw, np.asarray(rw)) <= SITE_TOL
    want = ref_precoded(jnp.asarray(shards), jnp.asarray(x), rw)
    got = ops.precoded_matmul(torch.from_numpy(shards), torch.from_numpy(x),
                              pw)
    assert tuple(got.shape) == (4, 25, 3)
    assert _rel(got, np.asarray(want)) <= SITE_TOL
    want = ref_apply(jnp.asarray(shards), jnp.asarray(x), rw,
                     RefMeta("o", 48, 97, (97,), blk=25))
    got = _coded_apply(torch.from_numpy(shards), torch.from_numpy(x), pw,
                       SiteMeta("o", 48, 97, (97,), blk=25))
    assert tuple(got.shape) == (3, 97)
    assert _rel(got, np.asarray(want)) <= SITE_TOL


def test_coded_flop_fraction_matches_reference():
    from repro.configs import get_config as ref_get_config
    from repro.configs import ARCHS
    from repro.models.coded import coded_flop_fraction as ref_fraction
    for arch in sorted(ARCHS):
        for coded_layers in ("none", "unembed", "attn", "ffn", "all"):
            assert coded_flop_fraction(get_config(arch), coded_layers) == \
                ref_fraction(ref_get_config(arch), coded_layers), \
                (arch, coded_layers)
    cfg = get_config(ARCH)
    assert coded_flop_fraction(cfg, "all") >= 0.9
    order = [coded_flop_fraction(cfg, c)
             for c in ("unembed", "attn", "ffn", "all")]
    assert order[0] < order[1] < order[3] and order[2] < order[3]


# --------------------------------------------------------------------------
# step level, teacher-forced
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded_layers", ["unembed", "attn", "ffn", "all"])
def test_teacher_forced_step_matches_reference(coded_layers, dtype):
    """The same token and (B,) pos stream through the reference's coded
    step and the port's, under ``exact_spec``: logits within the compute
    dtype's tolerance, and the argmax wherever the reference's top-2
    margin is clear of it."""
    want = _ref_stream_logits(dtype, coded_layers)
    got = _port_stream_logits(_port(dtype), coded_layers)
    tol = LOGIT_TOL[dtype]
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= tol, (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, tol)), t


@pytest.mark.parametrize("coded_layers", ["unembed", "attn", "ffn", "all"])
def test_coded_step_matches_plain_step_inside_the_port(coded_layers):
    """The port's version of the reference's failing bit-identity claim:
    the coded step's logits against the port's plain step (``"none"``) on
    the same stream, bfloat16 compute as served."""
    model = _port("bfloat16")
    want = _port_stream_logits(model, "none")
    got = _port_stream_logits(model, coded_layers)
    tol = LOGIT_TOL["bfloat16"]
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= tol, (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, tol)), t


def test_wired_step_is_bit_identical_to_the_plain_coded_step():
    """``encrypt="real"``: both transfers of every site cross the MEA-ECC
    wire in-step; the bits codec is lossless, so every logit keeps its
    bits."""
    model = _port("bfloat16")
    plain = _port_stream_logits(model, "all")
    wired = _port_stream_logits(
        model, "all", spec=exact_spec("all", crypto=CryptoSpec(
            encrypt="real")), wire=True)
    for g, w in zip(wired, plain):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# the MLA case (tests/test_serve.py:68): deepseek-v2-lite-16b
# --------------------------------------------------------------------------

def test_mla_sites_and_shards_match_reference():
    """``coded_layers="all"`` on the tiny deepseek: the dense prelude layer
    has the qkv (wq|w_dkv), o, up and down sites, each MoE layer only qkv
    and o, then the unembed; every site's meta and shards equal the
    reference's (mds, exact spec)."""
    from repro.models.coded import encode_serving_weights as ref_encode
    from repro.runtime.engine import RoundEngine as RefEngine
    model, params, _ = _reference("float32", MLA_ARCH)
    ref_engine = RefEngine(ref_exact_spec("all"))
    rcode = ref_encode(ref_engine.scheme, model, params, "all")
    port = _port("float32", MLA_ARCH)
    engine = RoundEngine(exact_spec("all"), device="cpu")
    code = encode_serving_weights(engine.scheme, port, "all")
    cfg = port.cfg
    h = cfg.n_heads
    assert sorted(code.layer_meta[0]) == ["down", "o", "qkv", "up"]
    assert code.layer_meta[0]["qkv"].split == (
        h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
        cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    assert code.layer_meta[0]["o"].d_in == h * cfg.v_head_dim
    want = {(0, name): (rcode.prelude_meta[0][name],
                        np.asarray(rcode.arrays["prelude"][0][name]))
            for name in rcode.prelude_meta[0]}
    for i in range(1, cfg.n_layers):
        assert sorted(code.layer_meta[i]) == ["o", "qkv"]
        for name, meta in rcode.group_meta["pos0"].items():
            want[(i, name)] = (meta, np.asarray(
                rcode.arrays["group"]["pos0"][name])[i - 1])
    assert len(want) == sum(len(m) for m in code.layer_meta)
    for (i, name), (meta, arr) in want.items():
        assert dataclasses.astuple(code.layer_meta[i][name]) == \
            dataclasses.astuple(meta), (i, name)
        assert _rel(code.layer_shards[i][name], arr) <= SITE_TOL, (i, name)
    assert _rel(code.unembed_shards,
                np.asarray(rcode.arrays["unembed"])) <= SITE_TOL
    assert code.n_instances == rcode.n_instances == \
        4 + 2 * (cfg.n_layers - 1) + 1
    ref_engine.close()
    engine.close()


def test_mla_teacher_forced_step_matches_reference():
    """The reference's coded step and the port's on one teacher-forced
    stream, float32 compute: every coded MLA site, the prelude's FFN
    sites, the uncoded all-expert MoE decode and the coded unembed."""
    want = _ref_stream_logits("float32", "all", MLA_ARCH)
    got = _port_stream_logits(_port("float32", MLA_ARCH), "all")
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= LOGIT_TOL["float32"], (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, LOGIT_TOL["float32"])), t


def test_mla_coded_step_matches_plain_step_inside_the_port():
    """bfloat16 compute as served: the coded step's logits against the
    port's plain step (``"none"``) on the same stream, within 2e-2 and
    with the argmax rule."""
    model = _port("bfloat16", MLA_ARCH)
    want = _port_stream_logits(model, "none")
    got = _port_stream_logits(model, "all")
    tol = LOGIT_TOL["bfloat16"]
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= tol, (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, tol)), t


def test_mla_wired_step_is_bit_identical_to_the_plain_coded_step():
    model = _port("bfloat16", MLA_ARCH)
    plain = _port_stream_logits(model, "all")
    wired = _port_stream_logits(
        model, "all", spec=exact_spec("all", crypto=CryptoSpec(
            encrypt="real")), wire=True)
    for g, w in zip(wired, plain):
        assert torch.equal(g, w)


def test_mla_serve_runs_the_reference_workload():
    """``Session.serve(arch="deepseek-v2-lite-16b", tiny=True)`` on the
    reference test's workload, coded and uncoded: every request gets its
    tokens and every step decodes its 11 coded sites in-step."""
    reqs = ragged_requests(n=3, seed=5)
    with Session(exact_spec("all"), device="cpu") as s:
        rep = s.serve(arch=MLA_ARCH, tiny=True, requests=reqs,
                      check_agreement=False)
        assert s._serve_models[(MLA_ARCH, True, 0)].cfg.mla
    with Session(exact_spec("none"), device="cpu") as s:
        plain = s.serve(arch=MLA_ARCH, tiny=True, requests=reqs,
                        check_agreement=False)
    assert rep.mode == "instep"
    for r, p, q in zip(rep.requests, plain.requests, reqs):
        assert len(r.tokens) == len(p.tokens) == q.gen
    assert 0 < rep.coded_fraction < 1


def test_mla_reference_serve_failure_is_an_exact_argmax_tie(monkeypatch):
    """Why ``tests/test_serve.py::test_parity_holds_on_mla_arch`` fails: its
    request 1 (prompt 71, 98, 146) is served 5, 113, 65, 17 uncoded and
    23, 116, 209, 154 coded.  Teacher-forced through the reference's own
    jitted step (its weights, ``PRNGKey(0)``), the uncoded logits of
    tokens 5 and 23 at the first generated position are the same bfloat16
    value, and argmax takes the lower index; the coded unembed's float32
    decode puts 23 above 5 by less than a bfloat16 ulp.  No router top-k
    choice differs between the two runs up to that token.  The port,
    given the same weights, serves 5 first both ways."""
    import jax
    import jax.numpy as jnp
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    from repro.models import moe as ref_moe
    from repro.models.coded import encode_serving_weights as ref_encode
    from repro.runtime.engine import RoundEngine as RefEngine
    model = ref_build_model(ref_tiny_config(MLA_ARCH))
    params = model.init(jax.random.PRNGKey(0))
    req = ragged_requests(n=3, seed=5)[1]
    assert req.prompt.tolist() == [71, 98, 146]
    routed = []
    router = ref_moe._router

    def recording(p, x, cfg):
        out = router(p, x, cfg)
        jax.debug.callback(lambda i: routed.append(np.asarray(i).tolist()),
                           out[1])
        return out
    monkeypatch.setattr(ref_moe, "_router", recording)
    logits, routes = {}, {}
    for name in ("none", "all"):
        engine = RefEngine(ref_exact_spec(name))
        code = ref_encode(engine.scheme, model, params, name)
        fn = jax.jit(functools.partial(_ref_coded_logits, model,
                                       engine.scheme, code))
        cache = model.init_cache(1, 8)
        routed.clear()
        for t, tok in enumerate(req.prompt):
            out, cache = fn(params, cache, np.array([[tok]], np.int32),
                            np.array([t], np.int32), np.ones(8, np.float32))
        jax.effects_barrier()
        logits[name] = np.asarray(out, np.float32)[0]
        routes[name] = list(routed)
        engine.close()
    plain, coded = logits["none"], logits["all"]
    assert int(plain.argmax()) == 5 and int(coded.argmax()) == 23
    assert plain[5] == plain[23] == plain.max()          # an exact tie
    assert 0 < coded[23] - coded[5] < 2.0 ** -6          # under one ulp
    assert len(routes["none"]) == 3 * 3                  # 3 MoE layers
    assert routes["all"] == routes["none"]

    monkeypatch.setattr(ref_moe, "_router", router)
    port = load_jax_params(build_model(tiny_config(MLA_ARCH), device="cpu"),
                           jax.tree.map(np.asarray, params))
    first = []
    for name in ("none", "all"):
        engine = RoundEngine(exact_spec(name), device="cpu")
        step = build_coded_step(port, engine.scheme, encode_serving_weights(
            engine.scheme, port, name))
        cache = port.init_cache(1, 8)
        for t, tok in enumerate(req.prompt):
            nxt, cache = step(cache, torch.tensor([[int(tok)]]),
                              torch.tensor([t], dtype=torch.int32),
                              torch.ones(8))
        first.append(int(nxt[0]))
        engine.close()
    assert first == [5, 5]


# --------------------------------------------------------------------------
# scheduling parity
# --------------------------------------------------------------------------

def _fix_clocks(monkeypatch):
    """Replace the measured step wall and worker time by constants in both
    packages: the virtual clock adds them, so admission would otherwise
    depend on each package's own timings."""
    from repro.runtime import engine as ref_engine
    from repro.runtime import serve_loop as ref_loop

    def ref_timed(self, b, *args):
        return self._step(*args), WALL_S

    def port_timed(self, b, fn, *args):
        if b not in self._warm:
            self._warm.add(b)
            self.trace_count += 1
        return fn(*args), WALL_S, 0

    monkeypatch.setattr(ref_loop.ContinuousBatcher, "_timed", ref_timed)
    monkeypatch.setattr(ContinuousBatcher, "_timed", port_timed)
    monkeypatch.setattr(ref_engine.RoundEngine, "worker_time",
                        lambda self, lhs, rhs: T_COMP_S)
    monkeypatch.setattr(RoundEngine, "worker_time",
                        lambda self, lhs, rhs: T_COMP_S)


def _timeline(res):
    """Everything the scheduler decides, per request and per step."""
    reqs = [(r.rid, r.arrival_s, r.admitted_s, r.first_token_s, r.done_s,
             r.n_prompt, len(r.tokens)) for r in res.requests]
    steps = [(st.n_waited, st.compute_wait_s, st.decode_at_s,
              tuple(w for _, w in st.arrivals)) for st in res.step_stats]
    return reqs, steps, list(res.buckets), res.virtual_s


@pytest.fixture(scope="module")
def scheduling_runs():
    """The reference's and the port's batcher (``coded_layers="all"``,
    float32 compute, 4 slots) over four workloads: ragged requests all
    arriving at 0, a ragged Poisson trace (continuous and gated) and an
    EOS run.  One batcher per package, so the reference compiles each
    bucket once."""
    from repro.runtime.engine import RoundEngine as RefEngine
    from repro.runtime.serve_loop import ContinuousBatcher as RefBatcher
    mp = pytest.MonkeyPatch()
    _fix_clocks(mp)
    try:
        model, params, _ = _reference("float32")
        ref_engine = RefEngine(ref_exact_spec("all"))
        ref = RefBatcher(ref_engine, model, params, coded_layers="all",
                         max_slots=4)
        engine = RoundEngine(exact_spec("all"), device="cpu")
        port = ContinuousBatcher(engine, _port("float32"), coded_layers="all",
                                 max_slots=4)
        eos_probe = [Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                             gen=8)]
        cases = {"at_zero": ("continuous", None, ragged_requests(n=6)),
                 "poisson": ("continuous", None,
                             ragged_requests(n=9, seed=11, rate=150.0)),
                 "gated": ("gated", None,
                           ragged_requests(n=9, seed=11, rate=150.0)),
                 "eos_free": ("continuous", None, eos_probe)}
        out = {}
        for name, (admission, eos, reqs) in cases.items():
            for bat in (ref, port):
                bat.admission, bat.eos_id = admission, eos
            out[name] = (ref.run(_ref_requests(reqs)), port.run(reqs))
        eos = int(out["eos_free"][1].requests[0].tokens[2])
        for bat in (ref, port):
            bat.eos_id = eos
        out["eos"] = (ref.run(_ref_requests(eos_probe)), port.run(eos_probe))
        out["eos_id"] = eos
        ref_engine.close()
        engine.close()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", ["at_zero", "poisson", "gated", "eos_free",
                                  "eos"])
def test_scheduling_matches_reference_exactly(scheduling_runs, case):
    ref, port = scheduling_runs[case]
    assert port.mode == ref.mode == "instep"
    assert _timeline(port) == _timeline(ref)
    for a, b in zip(port.requests, ref.requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_eos_evicts_early(scheduling_runs):
    free = scheduling_runs["eos_free"][1].requests[0].tokens
    toks = scheduling_runs["eos"][1].requests[0].tokens
    eos = scheduling_runs["eos_id"]
    assert len(free) == 8
    assert toks.tolist() == free[:free.tolist().index(eos) + 1].tolist()


def test_continuous_admission_beats_gated(scheduling_runs):
    cont, gated = scheduling_runs["poisson"][1], scheduling_runs["gated"][1]
    assert cont.requests_per_s > gated.requests_per_s
    assert len(cont.requests) == len(gated.requests) == 9
    assert cont.trace_count <= 3            # the buckets 1, 2 and 4


def test_poisson_workload_matches_reference():
    from repro.runtime.serve_loop import poisson_workload as ref_workload
    for kw in (dict(rate_rps=50.0, ragged=True), dict(rate_rps=0.0,
                                                      ragged=False)):
        want = ref_workload(16, prompt_len=12, gen=8, vocab=256, seed=0,
                            **kw)
        got = poisson_workload(16, prompt_len=12, gen=8, vocab=256, seed=0,
                               **kw)
        for g, w in zip(got, want):
            assert (g.rid, g.gen, g.arrival_s) == (w.rid, w.gen, w.arrival_s)
            np.testing.assert_array_equal(g.prompt, w.prompt)


# --------------------------------------------------------------------------
# the SSM archs: rwkv6 (every layer recurrent) and jamba (mamba, attention
# at one layer in four, MoE at the odd ones)
# --------------------------------------------------------------------------

SSM_ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]
# the sites of one tiny layer under "all": rwkv's and a mamba layer's mixer
# stay uncoded, a mamba layer's dense FFN and jamba's attention do not
SSM_SITES = {"rwkv6-1.6b": [[], [], [], []],
             "jamba-v0.1-52b": [["down", "up"], ["o", "qkv"], ["down", "up"],
                                []]}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_sites_and_shards_match_reference(arch):
    """``coded_layers="all"``: which layers have which sites, their metas
    and shards (mds, exact spec) against the reference's, and the count
    of site instances a step decodes."""
    from repro.models.coded import encode_serving_weights as ref_encode
    from repro.runtime.engine import RoundEngine as RefEngine
    model, params, _ = _reference("float32", arch)
    ref_engine = RefEngine(ref_exact_spec("all"))
    rcode = ref_encode(ref_engine.scheme, model, params, "all")
    port = _port("float32", arch)
    engine = RoundEngine(exact_spec("all"), device="cpu")
    code = encode_serving_weights(engine.scheme, port, "all")
    assert [sorted(m) for m in code.layer_meta] == SSM_SITES[arch]
    for i, metas in enumerate(code.layer_meta):
        g, pos = divmod(i, port.period)
        for name, meta in metas.items():
            want = rcode.group_meta[f"pos{pos}"][name]
            assert dataclasses.astuple(meta) == dataclasses.astuple(want)
            arr = np.asarray(rcode.arrays["group"][f"pos{pos}"][name])[g]
            assert _rel(code.layer_shards[i][name], arr) <= SITE_TOL, \
                (i, name)
    assert _rel(code.unembed_shards,
                np.asarray(rcode.arrays["unembed"])) <= SITE_TOL
    assert code.n_instances == rcode.n_instances == \
        1 + sum(len(m) for m in SSM_SITES[arch])
    ref_engine.close()
    engine.close()


@pytest.mark.parametrize("coded_layers", ["unembed", "all"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_teacher_forced_step_matches_reference(arch, coded_layers):
    """The reference's coded step and the port's on one teacher-forced
    stream, float32 compute, the recurrent states carried from step to
    step: within 1e-4 and with the argmax rule."""
    want = _ref_stream_logits("float32", coded_layers, arch)
    got = _port_stream_logits(_port("float32", arch), coded_layers)
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= LOGIT_TOL["float32"], (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, LOGIT_TOL["float32"])), t


@pytest.mark.parametrize("coded_layers", ["unembed", "all"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_coded_step_matches_plain_step_inside_the_port(arch,
                                                           coded_layers):
    """bfloat16 compute as served: the coded step against the port's plain
    step on the same stream, within 2e-2 and with the argmax rule (held
    inside the port as the MLA case is: the tiny rwkv's bfloat16 logits
    lie 0.24 of their max from its float32 ones in the reference itself,
    its group norm rescaling near-cancelling heads)."""
    model = _port("bfloat16", arch)
    want = _port_stream_logits(model, "none")
    got = _port_stream_logits(model, coded_layers)
    tol = LOGIT_TOL["bfloat16"]
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= tol, (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, tol)), t


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_wired_step_is_bit_identical_to_the_plain_coded_step(arch):
    model = _port("bfloat16", arch)
    plain = _port_stream_logits(model, "all")
    wired = _port_stream_logits(
        model, "all", spec=exact_spec("all", crypto=CryptoSpec(
            encrypt="real")), wire=True)
    for g, w in zip(wired, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch,want", [("rwkv6-1.6b", 0.1111),
                                       ("jamba-v0.1-52b", 0.1492)])
def test_ssm_coded_fraction_matches_reference(arch, want):
    """The tiny configs' coded FLOP fraction under ``"all"`` (the served
    report's), equal to the reference's: the SSM mixers only widen the
    denominator."""
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models.coded import coded_flop_fraction as ref_fraction
    with Session(ClusterSpec.serve_deadline(coded_layers="all"),
                 device="cpu") as s:
        rep = s.serve(arch=arch, tiny=True, batch=2, prompt_len=4, gen=4,
                      check_agreement=False)
    got = coded_flop_fraction(tiny_config(arch), "all")
    assert rep.coded_fraction == got == \
        ref_fraction(ref_tiny_config(arch), "all")
    assert round(got, 4) == want
    assert rep.tokens.shape == (2, 4) and (rep.tokens >= 0).all()


@functools.lru_cache(maxsize=None)
def _ssm_scheduling(arch: str):
    """The reference's and the port's batcher (``"all"``, float32, 4
    slots) over the ragged Poisson trace, with the clocks fixed."""
    from repro.runtime.engine import RoundEngine as RefEngine
    from repro.runtime.serve_loop import ContinuousBatcher as RefBatcher
    mp = pytest.MonkeyPatch()
    _fix_clocks(mp)
    try:
        model, params, _ = _reference("float32", arch)
        ref_engine = RefEngine(ref_exact_spec("all"))
        ref = RefBatcher(ref_engine, model, params, coded_layers="all",
                         max_slots=4)
        engine = RoundEngine(exact_spec("all"), device="cpu")
        port = ContinuousBatcher(engine, _port("float32", arch),
                                 coded_layers="all", max_slots=4)
        reqs = ragged_requests(n=9, seed=11, rate=150.0)
        out = (ref.run(_ref_requests(reqs)), port.run(reqs))
        ref_engine.close()
        engine.close()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_scheduling_matches_reference_exactly(arch):
    """Admission, eviction (slots refilled with zeroed states), buckets,
    plans, waits and tokens per request equal the reference's."""
    ref, port = _ssm_scheduling(arch)
    assert port.mode == ref.mode == "instep"
    assert _timeline(port) == _timeline(ref)
    for a, b in zip(port.requests, ref.requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _reuse_workload():
    """Five requests at t = 0 over four slots: the first four finish
    together, and the fifth is admitted into slot 0, which request 0's
    recurrent state still fills."""
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(1, 256, 6).astype(np.int32),
                    gen=6) for i in range(5)]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_reused_slot_serves_like_a_fresh_one(arch, monkeypatch):
    """The fifth request's tokens equal those it gets served alone: the
    admission reset (``ContinuousBatcher._zero_slot``) zeroes every
    recurrent state leaf of the reused slot.  With the reset skipped, the
    previous occupant's state leaks into them."""
    reqs = _reuse_workload()
    cfg = dataclasses.replace(tiny_config(arch), compute_dtype="float32")

    def fifth(requests):
        with Session(exact_spec("all"), device="cpu") as s:
            rep = s.serve(arch=cfg, requests=requests,
                          check_agreement=False)
        return next(r for r in rep.requests if r.rid == 4)

    alone = fifth(reqs[4:])
    shared = fifth(reqs)
    assert shared.admitted_s > 0            # it waited for a free slot
    np.testing.assert_array_equal(shared.tokens, alone.tokens)
    monkeypatch.setattr(ContinuousBatcher, "_zero_slot",
                        staticmethod(lambda cache, i: cache))
    leaked = fifth(reqs)
    assert not np.array_equal(leaked.tokens, alone.tokens)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launch_serve_serves_the_ssm_archs(arch, capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", arch, "--tiny", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--gen", "3",
                        "--coded-layers", "all"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "coded[all]" in out


# --------------------------------------------------------------------------
# qwen2-vl: the dense sites, decoded with plain RoPE as the reference's
# serve loop decodes it (no M-RoPE streams reach a serve step)
# --------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-72b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded_layers", ["unembed", "all"])
def test_vlm_teacher_forced_step_matches_reference(coded_layers, dtype):
    """qwen2-vl's coded step (qkv, o, up, down and the unembed under
    ``"all"``) against the reference's on one teacher-forced stream, as
    for qwen2-7b: within the compute dtype's tolerance and with the
    argmax rule."""
    want = _ref_stream_logits(dtype, coded_layers, VLM_ARCH)
    got = _port_stream_logits(_port(dtype, VLM_ARCH), coded_layers)
    tol = LOGIT_TOL[dtype]
    for t, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= tol, (t, _rel(g, w))
        assert not len(_argmax_agrees(g, w, tol)), t


def test_vlm_scheduling_matches_reference_exactly():
    """The batchers of both packages over the ragged Poisson trace, clocks
    fixed: admission, eviction, buckets, plans, waits and tokens equal,
    with the dense model's sites (4 per layer and the unembed)."""
    ref, port = _ssm_scheduling(VLM_ARCH)
    assert port.mode == ref.mode == "instep"
    assert _timeline(port) == _timeline(ref)
    for a, b in zip(port.requests, ref.requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_launch_serve_serves_qwen2_vl(capsys):
    from repro_torch.launch import serve as launch
    with Session(exact_spec("all"), device="cpu") as s:
        s.serve(arch=VLM_ARCH, tiny=True, batch=2, prompt_len=4, gen=2,
                check_agreement=False)
        code = next(iter(s._serve_batchers.values())).code
        assert [sorted(m) for m in code.layer_meta] == \
            [["down", "o", "qkv", "up"]] * tiny_config(VLM_ARCH).n_layers
    assert launch.main(["--arch", VLM_ARCH, "--tiny", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--gen", "3",
                        "--coded-layers", "all"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "coded[all]" in out


# --------------------------------------------------------------------------
# Session.serve, ServeReport, the transports
# --------------------------------------------------------------------------

def serve(spec, requests, **kw):
    with Session(spec, device="cpu") as s:
        return s.serve(arch=ARCH, tiny=True, requests=requests,
                       check_agreement=False, **kw)


def test_encrypted_serve_is_bit_identical_with_crypto_time():
    reqs = ragged_requests(n=3)
    plain = serve(exact_spec("all"), reqs)
    wired = serve(exact_spec("all", crypto=CryptoSpec(encrypt="real")), reqs)
    assert wired.mode == "instep"
    np.testing.assert_array_equal(plain.tokens, wired.tokens)
    assert all(st.crypto_s > 0 for st in wired.step_stats)
    assert all(st.crypto_s == 0 for st in plain.step_stats)


def test_threads_round_mode_serves_the_virtual_round_modes_tokens():
    """The ``threads`` transport's round mode (the unembed as a real loop
    round per step, every worker on a thread) against the same round mode
    on the virtual clock; mds waiting for all 8 workers decodes from the
    same 4 in both."""
    reqs = ragged_requests(n=3)
    threads = serve(exact_spec("unembed", backend="threads"), reqs)
    assert threads.mode == "round"
    with Session(exact_spec("unembed", fused=False), device="cpu") as s:
        s.serve(arch=ARCH, tiny=True, requests=reqs[:1],
                check_agreement=False)            # builds the model
        model = s._serve_models[(ARCH, True, 0)]
        bat = ContinuousBatcher(s.engine, model, coded_layers="unembed",
                                max_slots=4, backend="threads")
        virtual = bat.run(reqs)
    for a, b in zip(threads.requests, virtual.requests):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert all(st.n_waited == 8 for st in threads.step_stats)


def test_serve_report_accounting():
    reqs = ragged_requests(n=6, seed=4, rate=80.0)
    rep = serve(exact_spec("all"), reqs)
    assert isinstance(rep, ServeReport)
    assert rep.ttft_s.shape == (6,)
    assert (rep.ttft_s > 0).all()
    assert rep.step_latency_s.shape == (len(rep.step_stats),)
    assert 0 < rep.p50_step_s <= rep.p99_step_s
    assert rep.p99_step_s <= rep.step_latency_s.max() + 1e-12
    assert rep.requests_per_s > 0
    assert rep.virtual_s >= rep.step_latency_s.sum() - 1e-9
    assert rep.step_wall_s.shape == (len(rep.step_stats),)
    assert rep.coded_fraction == coded_flop_fraction(tiny_config(ARCH),
                                                     "all")
    # one round per step; no kernel on the CPU, so no launches
    assert all(st.dispatches == 0 and st.n_waited == 8
               for st in rep.step_stats)


def test_tok_s_excludes_admission_idle():
    reqs = [Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32), gen=3),
            Request(rid=1, prompt=np.arange(1, 5, dtype=np.int32), gen=3,
                    arrival_s=1e3)]
    rep = serve(exact_spec("unembed"), reqs)
    assert rep.virtual_s > 1e3               # the gap is on the clock
    assert rep.busy_wall_s < 1e2             # ...but not in busy wall
    assert rep.tok_s == pytest.approx(
        sum(len(r.tokens) for r in rep.requests) / rep.busy_wall_s)


def test_uniform_workload_keeps_the_batch_by_gen_shape():
    with Session(exact_spec("unembed"), device="cpu") as s:
        rep = s.serve(arch=ARCH, tiny=True, batch=3, prompt_len=6, gen=5,
                      seed=0, check_agreement=False)
        again = s.serve(arch=ARCH, tiny=True, batch=3, prompt_len=6, gen=5,
                        seed=0, check_agreement=False)
        assert len(s._serve_batchers) == 1   # encoded once, reused
    assert rep.tokens.shape == (3, 5)
    assert (rep.tokens >= 0).all()
    assert len(rep.step_stats) == 6 - 1 + 5  # prefill rides the steps
    np.testing.assert_array_equal(rep.tokens, again.tokens)
    assert again.trace_count == rep.trace_count == 1


def test_spacdc_deadline_agreement_is_bounded():
    spec = ClusterSpec.serve_deadline(t_budget=0.008, coded_layers="unembed",
                                      max_slots=4)
    with Session(spec, device="cpu") as s:
        rep = s.serve(arch=ARCH, tiny=True, batch=2, prompt_len=6, gen=4,
                      seed=0)
    assert 0.0 <= rep.argmax_agreement <= 1.0
    assert rep.steps_within_budget == len(rep.step_stats)


def test_exact_serve_agreement_with_the_uncoded_replay():
    with Session(exact_spec("unembed"), device="cpu") as s:
        rep = s.serve(arch=ARCH, tiny=True, requests=ragged_requests(n=3))
    assert rep.argmax_agreement == 1.0


def test_batcher_rejects_an_unfusable_scheme_beyond_unembed():
    spec = dataclasses.replace(exact_spec("unembed"),
                               code=CodeSpec(scheme="conv", n_workers=4),
                               wait=WaitSpec(policy="first_k", k=4))
    engine = RoundEngine(spec, device="cpu")
    model = build_model(tiny_config(ARCH), device="cpu")
    if not engine.scheme.supports_fused:
        with pytest.raises(ValueError, match="fused"):
            ContinuousBatcher(engine, model, coded_layers="all")
    with pytest.raises(ValueError, match="admission"):
        ContinuousBatcher(engine, model, admission="lottery")
    engine.close()


def test_serve_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(exact_spec("unembed")).serve(arch=ARCH, tiny=True)


def test_serve_spec_round_trip_and_validation():
    spec = exact_spec("attn", max_slots=16, eos_id=7)
    again = ClusterSpec.from_dict(spec.to_dict())
    assert again.serve == spec.serve and again == spec
    with pytest.raises(ValueError, match="coded_layers"):
        ServeSpec(coded_layers="everything")
    with pytest.raises(ValueError, match="max_slots"):
        ServeSpec(max_slots=0)
    with pytest.raises(ValueError, match="virtual"):
        exact_spec("all", backend="threads").validate()
    exact_spec("unembed", backend="threads").validate()
    assert ClusterSpec.serve_deadline(coded_layers="ffn", max_slots=2,
                                      eos_id=5).serve == \
        ServeSpec(coded_layers="ffn", max_slots=2, eos_id=5)


def test_launch_serve_prints_the_reports_lines(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--tiny", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "4", "--gen", "3",
                        "--coded-layers", "unembed"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "coded[unembed]" in out
    assert "steps decoded in budget" in out and "req1:" in out
    assert launch.main(["--tiny", "--device", "cpu", "--batch", "1",
                        "--prompt-len", "2", "--gen", "2",
                        "--coded-layers", "unembed", "--report"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("\n{") + 1:])
    assert report.pop("rounds_run") >= 2          # one round per step
    assert report == {"scheme": "spacdc", "n_workers": 8,
                      "adaptive": False, "policy": "fixed"}


def test_launch_serve_serves_the_mla_arch(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b``
    with every MLA site coded."""
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", MLA_ARCH, "--tiny", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--gen", "3",
                        "--coded-layers", "all"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "coded[all]" in out
    assert "req1:" in out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("coded_layers", ["unembed", "all"])
def test_cuda_serve_kernels_against_kernels_off(cuda, coded_layers):
    """A Fig-3-sized serve (``serve_deadline``: spacdc N=8, K=4, T=1, two
    stragglers, 8 slots) of the tiny model through the kernels against the
    same serve with the kernels forced off: the same plans, one
    ``berrut_combine`` launch per site per step, and every call held to
    the plain version within float32's elementwise bound; the
    teacher-forced logits within float32's tolerance."""
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    smoke = _chip_smoke()
    spec = dataclasses.replace(ClusterSpec.serve_deadline(
        coded_layers=coded_layers), serve=ServeSpec(
            coded_layers=coded_layers, max_slots=8))
    off = dataclasses.replace(spec, code=dataclasses.replace(
        spec.code, use_kernel=False))
    cfg = dataclasses.replace(tiny_config(ARCH), compute_dtype="float32")
    reqs = poisson_workload(8, rate_rps=0.0, prompt_len=6, gen=4,
                            vocab=cfg.vocab_size, seed=0, ragged=True)
    ratios = []
    undo = smoke.hold_ops_combines(torch, ratios)
    try:
        with Session(spec, device=cuda) as s:
            n0 = berrut_encode_kernel.launches
            rep = s.serve(arch=cfg, requests=reqs, check_agreement=False)
            launched = berrut_encode_kernel.launches - n0
    finally:
        undo()
    with Session(off, device=cuda) as s:
        n0 = berrut_encode_kernel.launches
        plain = s.serve(arch=cfg, requests=reqs, check_agreement=False)
        assert berrut_encode_kernel.launches == n0
    sites = 1 if coded_layers == "unembed" else 4 * cfg.n_layers + 1
    assert all(st.dispatches == sites for st in rep.step_stats)
    assert launched == sites * (1 + len(rep.step_stats))   # encode + steps
    assert max(ratios) <= 1.0, max(ratios)
    assert [st.n_waited for st in rep.step_stats] == \
        [st.n_waited for st in plain.step_stats]
    model = build_model(cfg, device=cuda)
    for sp in (spec, off):
        engine = RoundEngine(sp, device=cuda)
        code = encode_serving_weights(engine.scheme, model, coded_layers)
        step = build_coded_step(model, engine.scheme, code)
        cache = model.init_cache(4, 16)
        mask = torch.ones(8)
        mask[[1, 5]] = 0.0
        tok = torch.arange(1, 5, device=cuda)[:, None]
        pos = torch.tensor([0, 2, 1, 3], dtype=torch.int32, device=cuda)
        logits, _ = step.logits(cache, tok, pos, mask)
        if sp is spec:
            got = logits
        engine.close()
    assert _rel(got, logits) <= LOGIT_TOL["float32"]
