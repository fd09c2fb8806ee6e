"""The port's decoder LM (``repro_torch.models``) against the JAX package's,
on the CPU.

For each dense architecture (``qwen2-7b`` with qkv bias and G = 2,
``qwen3-14b`` with qk-norm and an explicit head_dim, ``phi3-mini`` with KV
= H, ``command-r`` with the parallel block, layernorm and tied
embeddings) and ``qwen2-vl-72b`` (qkv bias and M-RoPE, fed three
distinct position streams: text, an image's patch grid, text again; with
equal streams M-RoPE is plain RoPE and a section-order bug would not
show) and each MoE one (``deepseek-v2-lite-16b``: MLA, a dense
prelude layer and MoE layers with shared experts; ``llama4-scout``: GQA,
top-1 routing and NoPE layers) and each SSM one (``rwkv6-1.6b``:
every layer an RWKV6 time and channel mix; ``jamba-v0.1-52b``: mamba
layers, one attention layer and MoE at the odd layers) at ``tiny_config``
size, the reference's
``model.init``
parameters, each leaf perturbed so that biases and norm scales are not
0 and 1, go through ``models.load_jax_params``.  The port's ``forward``,
``loss_fn`` and ``decode_step`` then run on the same numpy tokens.

Tolerances, relative to the reference's max |logits|:

* float32 compute, 1e-4: the same float32 arithmetic through two
  libraries, summed in other orders;
* bfloat16 compute, 5e-2: each side rounds every activation to bfloat16
  (2^-8 relative) at the same points, but a different summation order can
  move a value across a rounding boundary, and that ulp propagates through
  the layers.  Where such a difference flips a router's top-k choice the
  MoE output jumps, and attention carries the jump to every later
  position of the sequence: so in bfloat16 a MoE model's logits are
  compared only at the positions before the first near-tie of their
  sequence (a top-k margin, the k-th minus the (k+1)-th router
  probability of the port's run, of at most ``MARGIN`` in any MoE layer),
  and the count of positions left out is asserted.  The SSM archs are
  held in bfloat16 by the reference's own bfloat16 distance from its
  float32 result (the port's at most twice that): the tiny rwkv's
  group norm rescales heads whose output nearly cancels, so the
  reference's bfloat16 logits lie 0.24 of their max from its float32
  ones.

The port's own forward-vs-decode contract is held as the reference's
``tests/test_models.py`` holds its own: float32 compute, atol = rtol =
0.05.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import build_model, load_jax_params

DENSE = ["qwen2-7b", "qwen3-14b", "phi3-mini-3.8b", "command-r-35b"]
VLM = ["qwen2-vl-72b"]
MOE = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
SSM = ["rwkv6-1.6b", "jamba-v0.1-52b"]
MODELS = DENSE + VLM + MOE + SSM
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MARGIN = 1e-3
B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread here keeps these CPU-heavy cases from starving the
    timing-sensitive tests that other workers run at the same time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str, dtype: str):
    return dataclasses.replace(tiny_config(arch), compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str):
    """(reference model, its params as JAX arrays, the same as numpy)."""
    import jax
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import build_model as ref_build_model
    cfg = dataclasses.replace(ref_tiny_config(arch), compute_dtype=dtype)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(sum(map(ord, arch)))
    tree = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) +
                   0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return model, jax.tree.map(jax.numpy.asarray, tree), tree


def _port(arch: str, dtype: str):
    model = build_model(_cfg(arch, dtype), device="cpu")
    return load_jax_params(model, _reference(arch, dtype)[2])


def _tokens(arch: str, seed: int = 0, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, tiny_config(arch).vocab_size, (b, s)).astype(
        np.int32)


def _chip_smoke():
    """``chip_smoke.py``, whose M-RoPE prompt layout these tests share."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mrope(arch: str, b: int = B, s: int = S):
    """(3, b, s) int32 M-RoPE streams for an arch with sections, else
    None: row i has 1 + i text tokens, then a 2 x 3 grid of image patches,
    then text (``chip_smoke.vl_positions``), so the three streams differ."""
    if not tiny_config(arch).mrope_sections:
        return None
    return _chip_smoke().vl_positions(b, s, [1 + i for i in range(b)],
                                      (2, 3))


def _mrope_kw(arch: str, b: int = B, s: int = S, torch_side: bool = False):
    m = _mrope(arch, b, s)
    if m is None:
        return {}
    return {"mrope_positions": torch.from_numpy(m) if torch_side else m}


def _rel(got, want, keep=None) -> float:
    """max |got - want| over max |want|; with ``keep`` (B, S) only at the
    kept positions (the denominator stays the whole of ``want``)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if keep is not None:
        diff = diff[keep]
    return float(np.max(diff) / np.max(np.abs(want)))


def _routed_forward(model, toks: np.ndarray, monkeypatch, **kw):
    """The forward with every MoE router call's top-k margins recorded.
    Returns (its result, keep (B, S) bool:
    the positions before their sequence's first margin <= MARGIN in any
    MoE layer; all True for a dense model)."""
    from repro_torch.models import moe
    margins = []
    router = moe._router

    def recording(p, x, cfg):
        probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        margins.append(top[..., cfg.top_k - 1] - top[..., cfg.top_k])
        return router(p, x, cfg)

    monkeypatch.setattr(moe, "_router", recording)
    with torch.no_grad():
        out = model.forward(torch.from_numpy(toks), **kw)
    monkeypatch.setattr(moe, "_router", router)
    near = torch.zeros(toks.shape, dtype=torch.bool)
    for m in margins:
        near |= m <= MARGIN
    return out, (near.cumsum(dim=1) == 0).numpy()


# bfloat16 positions left out by the near-tie rule, on this file's seeds
# (of B * S = 32)
LEFT_OUT = {"forward": {"deepseek-v2-lite-16b": 23,
                        "llama4-scout-17b-a16e": 15, "jamba-v0.1-52b": 12},
            "loss": {"deepseek-v2-lite-16b": 14,
                     "llama4-scout-17b-a16e": 15, "jamba-v0.1-52b": 2}}


@functools.lru_cache(maxsize=None)
def _jittered(arch: str):
    """The reference's float32 parameters with its embedding table scaled
    by (1 + 2^-23 n), n a seeded standard normal draw: its inputs moved
    by float32 rounding.  How far that moves the reference's own output
    is the float32 noise of the reference's result (``_ref_noise``)."""
    import jax
    _, params, tree = _reference(arch, "float32")
    table = tree["embedding"]["table"]
    rng = np.random.default_rng(99)
    jittered = dict(params, embedding=dict(params["embedding"]))
    jittered["embedding"]["table"] = jax.numpy.asarray(
        (table * (1 + 2.0 ** -23 * rng.standard_normal(table.shape)))
        .astype(np.float32))
    return jittered


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """The logits, and the MoE layers' summed load-balance and z losses
    (0 for a dense model) within the loss test's tolerance."""
    import jax
    ref_model, params, _ = _reference(arch, dtype)
    toks = _tokens(arch)
    want, want_aux = jax.jit(ref_model.forward)(params, toks,
                                                **_mrope_kw(arch))
    model = _port(arch, dtype)
    (got, aux), keep = _routed_forward(model, toks, monkeypatch,
                                       **_mrope_kw(arch, torch_side=True))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name in ("lb_loss", "z_loss"):
        assert abs(float(aux[name]) - float(want_aux[name])) <= \
            tol * abs(float(want_aux[name])), name
    if not model.cfg.moe:
        assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    if dtype == "float32":
        assert _rel(got, want) <= TOL[dtype]
        return
    assert int((~keep).sum()) == LEFT_OUT["forward"].get(arch, 0)
    if arch not in SSM:
        assert _rel(got, want, keep) <= TOL[dtype]
        return
    ref32, params32, _ = _reference(arch, "float32")
    want32 = np.asarray(jax.jit(ref32.forward)(params32, toks)[0],
                        np.float32)    # (no SSM arch has M-RoPE)
    ref_off = _rel(np.asarray(want, np.float32), want32, keep)
    assert _rel(got, want32, keep) <= 2 * ref_off, \
        (_rel(got, want32, keep), ref_off)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_loss_matches_reference(arch, dtype, monkeypatch):
    """In bfloat16 a MoE model's targets past its sequence's first router
    near-tie are masked (-1) in both packages' batches."""
    import jax
    ref_model, params, _ = _reference(arch, dtype)
    toks = _tokens(arch, seed=1)
    targets = _tokens(arch, seed=2)
    targets[0, :3] = -1                       # masked positions
    model = _port(arch, dtype)
    if dtype == "bfloat16":
        _, keep = _routed_forward(model, toks, monkeypatch,
                                  **_mrope_kw(arch, torch_side=True))
        assert int((~keep).sum()) == LEFT_OUT["loss"].get(arch, 0)
        targets = np.where(keep, targets, -1).astype(np.int32)
    batch = {"tokens": toks, "targets": targets, **_mrope_kw(arch)}
    want, want_m = jax.jit(ref_model.loss_fn)(params, batch)
    with torch.no_grad():
        got, got_m = model.loss_fn({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert abs(float(got) - float(want)) <= tol * abs(float(want))
    assert abs(float(got_m["ce"]) - float(want_m["ce"])) <= \
        tol * abs(float(want_m["ce"]))


@pytest.mark.parametrize("arch", MODELS)
def test_decode_matches_reference(arch):
    """Eight teacher-forced decode steps, float32 compute, step by step.

    For the SSM archs each step is held to 1e-4 or, where the reference's
    own result is noisier, to twice its float32 noise: its distance from
    the same step run on the jittered table (``_jittered``).  RWKV6's
    per-head group norm rescales a head whose r . (u k) v^T sum nearly
    cancels back to unit size, so float32 rounding of the projections
    moves the tiny rwkv's first logits by 3.3e-4 of their max in the
    reference itself."""
    import jax
    ref_model, params, _ = _reference(arch, "float32")
    toks = _tokens(arch, seed=3, s=8)
    mrope = _mrope(arch, s=8)
    step = jax.jit(ref_model.decode_step)
    ref_cache = ref_model.init_cache(B, 16)
    noisy_cache = ref_model.init_cache(B, 16)
    model = _port(arch, "float32")
    cache = model.init_cache(B, 16)
    with torch.no_grad():
        for t in range(8):
            tok = toks[:, t:t + 1]
            kw = {} if mrope is None else \
                {"mrope_positions": mrope[:, :, t:t + 1]}
            want, ref_cache = step(params, ref_cache, tok, np.int32(t), **kw)
            got, cache = model.decode_step(
                cache, torch.from_numpy(tok), t,
                **{k: torch.from_numpy(v) for k, v in kw.items()})
            assert tuple(got.shape) == (B, 1, tiny_config(arch).vocab_size)
            tol = TOL["float32"]
            if arch in SSM:
                noisy, noisy_cache = step(_jittered(arch), noisy_cache, tok,
                                          np.int32(t))
                tol = max(tol, 2 * _rel(np.asarray(noisy), want))
            assert _rel(got, want) <= tol, (t, _rel(got, want), tol)


def _ragged_decode_cases():
    return [(arch, "float32", hidden) for arch in MODELS
            for hidden in (False, True)] + \
        [("qwen2-7b", "bfloat16", hidden) for hidden in (False, True)]


@pytest.mark.parametrize("arch,dtype,return_hidden", _ragged_decode_cases())
def test_per_slot_decode_matches_reference(arch, dtype, return_hidden):
    """Six teacher-forced decode steps at ragged per-slot ``(B,)``
    positions (the continuous-batching decode), logits or, with
    ``return_hidden``, the final-norm hidden state, step by step, within
    this file's tolerance for the compute dtype (``TOL``).

    bfloat16 is held at the file's 5e-2, not ``PERF.md`` §2's 2e-2: on
    this file's perturbed weights each package's bfloat16 step is itself
    1.2–2.3e-2 of max |ref| off the float32 step (XLA keeps float32
    inside its fusions, eager PyTorch rounds after each op), so the two
    bfloat16 runs land up to 2.5e-2 apart at step 0 and 1.0–2.0e-2
    after.  The serve file's teacher-forced steps meet 2e-2 on their own
    weights draw.  So bfloat16 is also held to the float32 reference
    step: over the six steps the port's largest distance from it is at
    most twice the reference's own bfloat16 distance."""
    import jax
    ref_model, params, _ = _reference(arch, dtype)
    b = 3
    toks = _tokens(arch, seed=4, b=b, s=6)
    offsets = np.array([0, 3, 1], np.int32)
    mrope = _mrope(arch, b=b, s=9)

    def mrope_at(pos):
        """Each slot's three streams at its own position, (3, b, 1)."""
        if mrope is None:
            return {}
        return {"mrope_positions":
                mrope[:, np.arange(b), pos][:, :, None].copy()}
    step = jax.jit(functools.partial(ref_model.decode_step,
                                     return_hidden=return_hidden))
    ref_cache = ref_model.init_cache(b, 16)
    bf16 = dtype == "bfloat16"
    if bf16:
        ref32, params32, _ = _reference(arch, "float32")
        step32 = jax.jit(functools.partial(ref32.decode_step,
                                           return_hidden=return_hidden))
        cache32 = ref32.init_cache(b, 16)
    model = _port(arch, dtype)
    cache = model.init_cache(b, 16)
    tol = TOL[dtype]
    port_off = ref_off = 0.0
    with torch.no_grad():
        for t in range(6):
            pos = offsets + t
            kw = mrope_at(pos)
            want, ref_cache = step(params, ref_cache, toks[:, t:t + 1], pos,
                                   **kw)
            got, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]),
                torch.from_numpy(pos), return_hidden=return_hidden,
                **{k: torch.from_numpy(v) for k, v in kw.items()})
            width = model.cfg.d_model if return_hidden else \
                model.cfg.vocab_size
            assert tuple(got.shape) == (b, 1, width)
            assert _rel(got, want) <= tol, (t, _rel(got, want))
            if bf16:
                want32, cache32 = step32(params32, cache32,
                                         toks[:, t:t + 1], pos, **kw)
                port_off = max(port_off, _rel(got, want32))
                ref_off = max(ref_off, _rel(np.asarray(want, np.float32),
                                            want32))
    if bf16:
        assert port_off <= 2 * ref_off, (port_off, ref_off)


def test_per_slot_decode_writes_through_a_view_of_the_cache():
    """The serve loop hands a bucket's leading slots as views: the step's
    per-slot writes land in the full cache, at each slot's position."""
    model = build_model(_cfg("qwen2-7b", "float32"), device="cpu")
    full = model.init_cache(4, 8)
    view = [{k: leaf[:2] for k, leaf in layer.items()} for layer in full]
    toks = torch.tensor([[5], [7]])
    pos = torch.tensor([1, 4], dtype=torch.int32)
    with torch.no_grad():
        _, view = model.decode_step(view, toks, pos)
    k = full[0]["k"]
    assert view[0]["k"].data_ptr() == k.data_ptr()
    assert k[0, 1].abs().sum() > 0 and k[1, 4].abs().sum() > 0
    written = torch.zeros(k.shape[:2], dtype=torch.bool)
    written[0, 1] = written[1, 4] = True
    assert float(k[~written].abs().sum()) == 0.0


@pytest.mark.parametrize("arch", MODELS)
def test_decode_matches_forward_causal(arch):
    """Teacher-forced forward logits at position t == incremental decode
    logits, the contract of the reference's ``tests/test_models.py``.  As
    there, a MoE model's ``capacity_factor`` is raised to 8 so that the
    forward drops no token (the all-expert decode never does)."""
    cfg = _cfg(arch, "float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = build_model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(_tokens(arch, seed=3, b=1, s=8))
    mrope = _mrope_kw(arch, b=1, s=8, torch_side=True).get("mrope_positions")
    with torch.no_grad():
        full, _ = model.forward(toks, mrope_positions=mrope)
        cache = model.init_cache(1, 16)
        outs = []
        for t in range(8):
            logits, cache = model.decode_step(
                cache, toks[:, t:t + 1], t, mrope_positions=None
                if mrope is None else mrope[:, :, t:t + 1])
            outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, atol=0.05,
                               rtol=0.05)


# --------------------------------------------------------------------------
# the converter, the device rule and the unported configs
# --------------------------------------------------------------------------

def _break(tree, how: str):
    tree = {k: v for k, v in tree.items()}
    if how == "missing":
        tree["final_norm"] = {}
    elif how == "extra":
        tree["final_norm"] = dict(tree["final_norm"], shift=np.zeros(64))
    else:
        group = dict(tree["groups"]["pos0"])
        mixer = dict(group["mixer"])
        mixer["wq"] = np.swapaxes(mixer["wq"], 1, 3)     # (G, hd, H, d)
        group["mixer"] = mixer
        tree["groups"] = {"pos0": group}
    return tree


@pytest.mark.parametrize("how", ["missing", "extra", "misshapen"])
def test_converter_raises_on_a_tree_that_does_not_fit(how):
    tree = _reference("qwen2-7b", "float32")[2]
    model = build_model(_cfg("qwen2-7b", "float32"), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=how if how != "misshapen"
                       else "shape"):
        load_jax_params(model, _break(tree, how))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k             # nothing was copied


def test_converter_unstacks_groups_in_layer_order():
    tree = _reference("qwen2-7b", "float32")[2]
    model = _port("qwen2-7b", "float32")
    wq = tree["groups"]["pos0"]["mixer"]["wq"]
    for i, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.mixer["wq"].detach().numpy(),
                                      wq[i])
    assert "unembed" not in dict(_port("command-r-35b", "float32")
                                 .embedding.items())


def test_build_model_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_config("qwen2-7b"))


def test_build_model_is_deterministic_in_its_seed():
    cfg = tiny_config("qwen2-7b")
    a, b = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    c = build_model(cfg, device="cpu", seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.mixer.wq"], sc["layers.0.mixer.wq"])
    table = sa["embedding.table"]
    assert 0.015 < float(table.std()) < 0.025
    wq = sa["layers.0.mixer.wq"]
    assert abs(float(wq.std()) * 64 ** 0.5 - 1.0) < 0.1


def _leaves(prefix: str, node):
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _leaves(f"{prefix}.{key}" if prefix else key, value)
    else:
        yield prefix, node


def _carried(arch: str):
    """The port with the reference's float32 tree loaded, and its
    parameters as numpy, after holding every leaf of the tree, value for
    value, against the port's parameter of the same path (the groups'
    stacked leaves one per layer) and every port parameter to have one."""
    tree = _reference(arch, "float32")[2]
    model = _port(arch, "float32")
    params = {k: v.detach().numpy() for k, v in model.named_parameters()}
    seen = {}
    for j, layer in enumerate(tree["prelude"]):
        for name, arr in _leaves(f"layers.{j}", layer):
            seen[name] = arr
    for pos, group in tree["groups"].items():
        for name, arr in _leaves("", group):
            assert arr.shape[0] == model.n_groups
            for g in range(model.n_groups):
                n = model.n_pre + g * model.period + int(pos[3:])
                seen[f"layers.{n}.{name}"] = arr[g]
    for key in ("embedding", "final_norm"):
        seen.update(_leaves(key, tree[key]))
    assert set(seen) == set(params)
    for name, arr in seen.items():
        np.testing.assert_array_equal(params[name], arr, err_msg=name)
    return model, params


@pytest.mark.parametrize("arch", MOE)
def test_converter_carries_the_moe_trees(arch):
    """Every leaf of the reference's tree lands, value for value, in the
    port's parameter of the same path, and every port parameter gets one:
    deepseek's dense ``prelude`` layer, the groups' stacked leaves one per
    layer (the expert stacks (G, E, d, ff) among them), the nested
    ``ffn.shared`` leaves and the MLA leaves."""
    model, params = _carried(arch)
    cfg = model.cfg
    moe_layer = model.n_pre
    assert params[f"layers.{moe_layer}.ffn.w_gate"].shape == \
        (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert f"layers.{moe_layer}.ffn.shared.w_down" in params
    if cfg.mla:
        assert model.n_pre == 1 and \
            params["layers.0.ffn.w_gate"].shape == (cfg.d_model, cfg.d_ff)
        assert params["layers.1.mixer.w_uk"].shape == \
            (cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_head_dim)


def test_converter_carries_the_rwkv_tree():
    """rwkv: four groups of one layer, each ``norm1``, ``norm2`` (the
    channel mix's) and the mixer's time- and channel-mix leaves, no
    ``ffn``."""
    model, params = _carried("rwkv6-1.6b")
    cfg = model.cfg
    assert (model.n_pre, model.period, model.n_groups) == (0, 1, 4)
    assert not any(".ffn." in name for name in params)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert params["layers.3.mixer.u"].shape == (h, hd)
    assert params["layers.3.mixer.cm_wk"].shape == (cfg.d_model, cfg.d_ff)
    assert params["layers.3.norm2.bias"].shape == (cfg.d_model,)


def test_converter_carries_the_jamba_tree():
    """tiny jamba: one group of period 4 (attention at 1, MoE at odd
    layers), the mamba leaves, the attention layer's and the experts'."""
    model, params = _carried("jamba-v0.1-52b")
    cfg = model.cfg
    din = cfg.expand * cfg.d_model
    assert (model.n_pre, model.period, model.n_groups) == (0, 4, 1)
    assert [(d.mixer, d.ffn) for d in model.descs] == [
        ("mamba", "dense"), ("attn", "moe"), ("mamba", "dense"),
        ("mamba", "moe")]
    assert params["layers.0.mixer.w_in"].shape == (cfg.d_model, 2, din)
    assert params["layers.2.mixer.A_log"].shape == (din, cfg.d_state)
    assert params["layers.1.mixer.wq"].shape[0] == cfg.d_model
    assert params["layers.3.ffn.w_gate"].shape == \
        (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


@pytest.mark.parametrize("n_layers,groups", [(8, 1), (32, 4)])
def test_jamba_full_width_layer_pattern(n_layers, groups):
    """jamba at full width, cut to one period of its pattern (8 layers,
    as the card's run) or whole: no prelude, period 8 = lcm(attention 8,
    MoE 2), attention at position 4, MoE at the odd ones; the port and the
    reference agree."""
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import layer_pattern as ref_pattern
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_pattern
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=n_layers)
    ref_cfg = dataclasses.replace(ref_get_config("jamba-v0.1-52b"),
                                  n_layers=n_layers)
    n_pre, period, descs = layer_pattern(cfg)
    assert (n_pre, period, (n_layers - n_pre) // period) == (0, 8, groups)
    assert [dataclasses.astuple(d) for d in descs] == \
        [dataclasses.astuple(d) for d in ref_pattern(ref_cfg)[2]]
    assert [d.mixer for d in descs] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    assert [d.ffn for d in descs] == ["dense", "moe"] * 4


def test_every_arch_builds():
    """Every config of ``configs.ARCHS`` builds in the port: whisper as
    the encoder-decoder, the rest as the decoder-only LM."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import EncDecLM, TransformerLM
    for arch in sorted(ARCHS):
        model = build_model(tiny_config(arch), device="cpu")
        want = EncDecLM if tiny_config(arch).encoder_decoder else \
            TransformerLM
        assert type(model) is want, arch


def test_int8_kv_cache_still_raises():
    """``init_cache`` of an int8 config no longer raises: it allocates
    int8 payloads and float16 scales per (token, kv head)
    (``tests/test_torch_kvint8.py`` holds them against the reference).
    The name is kept from when the port refused the int8 cache."""
    cfg = dataclasses.replace(tiny_config("qwen2-7b"), kv_cache_dtype="int8")
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(1, 4)
    kv, hd = cfg.n_kv_heads_padded, cfg.head_dim_
    for layer in cache:
        assert layer["k"].dtype == layer["v"].dtype == torch.int8
        assert layer["k_scale"].dtype == layer["v_scale"].dtype == \
            torch.float16
        assert tuple(layer["k"].shape) == (1, 4, kv, hd)
        assert tuple(layer["k_scale"].shape) == (1, 4, kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference_and_equal_streams_are_rope(dtype):
    """The port's ``apply_mrope`` against the reference's on distinct
    streams (float32 1e-6, bfloat16 to one rounding of the output), and
    with three equal streams bit-identical to ``apply_rope`` in both
    packages."""
    import jax.numpy as jnp
    from repro.models import layers as ref_layers
    from repro_torch.models.layers import apply_mrope, apply_rope
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    pos3 = _chip_smoke().vl_positions(2, 16, [1, 2], (2, 3))
    sections, theta = (2, 3, 3), 1e6
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = ref_layers.apply_mrope(xj, jnp.asarray(pos3), sections, theta)
    got = apply_mrope(xt, torch.from_numpy(pos3), sections, theta)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert _rel(got, np.asarray(want, np.float32)) <= tol
    rope = apply_rope(xt, torch.from_numpy(pos3[0]), theta)
    assert _rel(got, rope.float().numpy()) > tol
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    assert torch.equal(apply_mrope(xt, torch.from_numpy(same), sections,
                                   theta),
                       apply_rope(xt, torch.from_numpy(pos3[0]), theta))
    assert (np.asarray(ref_layers.apply_mrope(xj, jnp.asarray(same),
                                              sections, theta)) ==
            np.asarray(ref_layers.apply_rope(xj, jnp.asarray(pos3[0]),
                                             theta))).all()
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(xt, torch.from_numpy(pos3), (2, 3, 2), theta)


def test_converter_carries_the_qwen2_vl_tree():
    """qwen2-vl's tree is the dense one (M-RoPE has no parameters): every
    leaf lands, the qkv biases among them."""
    model, params = _carried("qwen2-vl-72b")
    cfg = model.cfg
    assert (model.n_pre, model.period, model.n_groups) == \
        (0, 1, cfg.n_layers)
    assert params["layers.3.mixer.bq"].shape == (cfg.n_heads, cfg.head_dim_)
    assert cfg.mrope_sections == (2, 3, 3)


# --------------------------------------------------------------------------
# on the card: the forward through the flash kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", DENSE + VLM)
def test_cuda_forward_launches_the_kernel_per_layer(cuda, arch):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    model = build_model(_cfg(arch, "float32"), device=cuda)
    toks = torch.from_numpy(_tokens(arch)).to(cuda)
    kw = {k: v.to(cuda) for k, v in
          _mrope_kw(arch, torch_side=True).items()}
    with torch.inference_mode():
        n0 = flash_attention_kernel.launches
        got, _ = model.forward(toks, **kw)
        assert flash_attention_kernel.launches - n0 == model.cfg.n_layers
        want, _ = model.forward(toks, force_kernel=False, **kw)
        assert flash_attention_kernel.launches - n0 == model.cfg.n_layers
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL["float32"], err
    # grad mode trains through the kernels: per layer the forward kernel
    # twice (remat recomputes it) and the backward kernel once; the
    # gradients are those of the kernels-off run
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    grads = []
    for force in (None, False):
        model.zero_grad(set_to_none=True)
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_bwd_kernel.launches
        logits, _ = model.forward(toks, force_kernel=force, **kw)
        logits.float().square().mean().backward()
        torch.cuda.synchronize()
        n = model.cfg.n_layers if force is None else 0
        assert (flash_attention_kernel.launches - f0,
                flash_attention_bwd_kernel.launches - b0) == (2 * n, n)
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    for k, w in grads[1].items():
        err = float((grads[0][k] - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        assert err <= TOL["float32"], (k, err)
