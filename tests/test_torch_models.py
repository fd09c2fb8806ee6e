"""The port's decoder LM (``repro_torch.models``) against the JAX package's,
on the CPU.

For each dense architecture (``qwen2-7b`` with qkv bias and G = 2,
``qwen3-14b`` with qk-norm and an explicit head_dim, ``phi3-mini`` with KV
= H, ``command-r`` with the parallel block, layernorm and tied
embeddings) and each MoE one (``deepseek-v2-lite-16b``: MLA, a dense
prelude layer and MoE layers with shared experts; ``llama4-scout``: GQA,
top-1 routing and NoPE layers) at ``tiny_config`` size, the reference's
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
  and the count of positions left out is asserted.

The port's own forward-vs-decode contract is held as the reference's
``tests/test_models.py`` holds its own: float32 compute, atol = rtol =
0.05.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import build_model, load_jax_params

DENSE = ["qwen2-7b", "qwen3-14b", "phi3-mini-3.8b", "command-r-35b"]
MOE = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
MODELS = DENSE + MOE
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


def _routed_forward(model, toks: np.ndarray, monkeypatch):
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
        out = model.forward(torch.from_numpy(toks))
    monkeypatch.setattr(moe, "_router", router)
    near = torch.zeros(toks.shape, dtype=torch.bool)
    for m in margins:
        near |= m <= MARGIN
    return out, (near.cumsum(dim=1) == 0).numpy()


# bfloat16 positions left out by the near-tie rule, on this file's seeds
# (of B * S = 32)
LEFT_OUT = {"forward": {"deepseek-v2-lite-16b": 23,
                        "llama4-scout-17b-a16e": 15},
            "loss": {"deepseek-v2-lite-16b": 14,
                     "llama4-scout-17b-a16e": 15}}


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
    want, want_aux = jax.jit(ref_model.forward)(params, toks)
    model = _port(arch, dtype)
    (got, aux), keep = _routed_forward(model, toks, monkeypatch)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name in ("lb_loss", "z_loss"):
        assert abs(float(aux[name]) - float(want_aux[name])) <= \
            tol * abs(float(want_aux[name])), name
    if arch in DENSE:
        assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    if dtype == "float32":
        assert _rel(got, want) <= TOL[dtype]
        return
    assert int((~keep).sum()) == LEFT_OUT["forward"].get(arch, 0)
    assert _rel(got, want, keep) <= TOL[dtype]


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
        _, keep = _routed_forward(model, toks, monkeypatch)
        assert int((~keep).sum()) == LEFT_OUT["loss"].get(arch, 0)
        targets = np.where(keep, targets, -1).astype(np.int32)
    batch = {"tokens": toks, "targets": targets}
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
    """Eight teacher-forced decode steps, float32 compute, step by step."""
    import jax
    ref_model, params, _ = _reference(arch, "float32")
    toks = _tokens(arch, seed=3, s=8)
    step = jax.jit(ref_model.decode_step)
    ref_cache = ref_model.init_cache(B, 16)
    model = _port(arch, "float32")
    cache = model.init_cache(B, 16)
    with torch.no_grad():
        for t in range(8):
            want, ref_cache = step(params, ref_cache, toks[:, t:t + 1],
                                   np.int32(t))
            got, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]), t)
            assert tuple(got.shape) == (B, 1, tiny_config(arch).vocab_size)
            assert _rel(got, want) <= TOL["float32"], t


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
            want, ref_cache = step(params, ref_cache, toks[:, t:t + 1], pos)
            got, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]),
                torch.from_numpy(pos), return_hidden=return_hidden)
            width = model.cfg.d_model if return_hidden else \
                model.cfg.vocab_size
            assert tuple(got.shape) == (b, 1, width)
            assert _rel(got, want) <= tol, (t, _rel(got, want))
            if bf16:
                want32, cache32 = step32(params32, cache32,
                                         toks[:, t:t + 1], pos)
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
    with torch.no_grad():
        full, _ = model.forward(toks)
        cache = model.init_cache(1, 16)
        outs = []
        for t in range(8):
            logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
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


@pytest.mark.parametrize("arch", MOE)
def test_converter_carries_the_moe_trees(arch):
    """Every leaf of the reference's tree lands, value for value, in the
    port's parameter of the same path, and every port parameter gets one:
    deepseek's dense ``prelude`` layer, the groups' stacked leaves one per
    layer (the expert stacks (G, E, d, ff) among them), the nested
    ``ffn.shared`` leaves and the MLA leaves."""
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


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-vl-72b", "whisper-small"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(tiny_config(arch), device="cpu")


# --------------------------------------------------------------------------
# on the card: the forward through the flash kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", DENSE)
def test_cuda_forward_launches_the_kernel_per_layer(cuda, arch):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    model = build_model(_cfg(arch, "float32"), device=cuda)
    toks = torch.from_numpy(_tokens(arch)).to(cuda)
    with torch.inference_mode():
        n0 = flash_attention_kernel.launches
        got, _ = model.forward(toks)
        assert flash_attention_kernel.launches - n0 == model.cfg.n_layers
        want, _ = model.forward(toks, force_kernel=False)
        assert flash_attention_kernel.launches - n0 == model.cfg.n_layers
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL["float32"], err
    with pytest.raises(RuntimeError, match="no backward"):
        model.forward(toks)                    # grad mode: refused
