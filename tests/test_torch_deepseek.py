"""DeepSeek-V2's multi-head latent attention and the MoE FFN of the port
(``repro_torch.models.attention``'s MLA, ``repro_torch.models.moe``)
against the JAX package's, module by module, on the CPU.

Parameters come from the reference's own ``init_mla`` / ``init_moe`` at
``tiny_config("deepseek-v2-lite-16b")`` size (d 64, 4 heads, lora 32, nope
16, rope 8, v 16; 8 experts, top-2, 2 shared), each leaf perturbed, and
inputs from numpy with a seed; both packages get the same arrays.

Tolerances, of max |reference|: 1e-4 in float32 compute (the same
arithmetic summed in other orders), 2e-2 in bfloat16 (one rounding of
2^-8 at each cast).  In bfloat16 a router's top-k choice can flip where
two experts' probabilities nearly tie, and the MoE output of that token
then jumps: bfloat16 MoE outputs are compared only where the top-k margin
(the k-th minus the (k+1)-th probability) exceeds ``MARGIN``, and the
count of tokens left out is asserted.  The ``cuda`` cases run on the card
and import no JAX.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import attention as attn
from repro_torch.models import moe

ARCH = "deepseek-v2-lite-16b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MARGIN = 1e-3
B, S = 2, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype: str, **kw):
    return dataclasses.replace(tiny_config(ARCH), compute_dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(kind: str):
    """The reference's ``init_mla`` or ``init_moe`` leaves, perturbed, as
    nested dicts of float32 numpy arrays."""
    import jax
    from repro.configs import tiny_config as ref_tiny_config
    from repro.models import attention as ref_attn
    from repro.models import moe as ref_moe
    cfg = ref_tiny_config(ARCH)
    init = ref_attn.init_mla if kind == "mla" else ref_moe.init_moe
    params = init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(17)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) +
                   0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _jax_tree(tree):
    import jax
    return jax.tree.map(jax.numpy.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _ref_cfg(dtype: str, **kw):
    from repro.configs import tiny_config as ref_tiny_config
    return dataclasses.replace(ref_tiny_config(ARCH), compute_dtype=dtype,
                               **kw)


def _x(seed: int, b: int = B, s: int = S) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 64)).astype(np.float32)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want, keep=None) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if keep is not None:
        diff = diff[keep]
    return float(np.max(diff) / np.max(np.abs(want)))


def _positions(b: int, s: int) -> np.ndarray:
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_reference(dtype):
    """The full-sequence MLA (q . k over nope + rope = 24, v 16) through
    the port's flash dispatch (the plain version on the CPU)."""
    import jax
    from repro.models import attention as ref_attn
    tree = _ref_params("mla")
    x = _x(1)
    pos = _positions(B, S)
    want = jax.jit(functools.partial(ref_attn.mla_forward,
                                     cfg=_ref_cfg(dtype)))(
        _jax_tree(tree), jax.numpy.asarray(x, dtype), positions=pos)
    with torch.no_grad():
        got = attn.mla_forward(_torch_tree(tree),
                               torch.from_numpy(x).to(getattr(torch, dtype)),
                               _cfg(dtype), torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOL[dtype]


def _mla_decode_stream(per_slot: bool, steps: int = 6):
    """Teacher-forced absorbed decode steps of both packages on one cache
    each: at scalar positions 0..steps-1, or at per-slot positions
    offset by (0, 3, 1).  Yields (step, got, want, port cache)."""
    import jax
    from repro.models import attention as ref_attn
    tree = _ref_params("mla")
    b = 3
    cfg, rcfg = _cfg("float32"), _ref_cfg("float32")
    xs = _x(4, b=b, s=steps)
    offsets = np.array([0, 3, 1], np.int32)
    step = jax.jit(functools.partial(ref_attn.mla_decode, cfg=rcfg))
    rcache = ref_attn.init_mla_cache(rcfg, b, 16)
    cache = attn.init_mla_cache(cfg, b, 16)
    params, rparams = _torch_tree(tree), _jax_tree(tree)
    for t in range(steps):
        x = xs[:, t:t + 1]
        pos = offsets + t if per_slot else np.int32(t)
        want, rcache = step(rparams, x, rcache, pos=pos)
        with torch.no_grad():
            got, cache = attn.mla_decode(
                params, torch.from_numpy(x), cache,
                torch.from_numpy(pos) if per_slot else t, cfg)
        yield t, got, want, cache, rcache


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_mla_decode_matches_reference(per_slot):
    """Six absorbed-form decode steps (scores in the lora latent space,
    scale 1/sqrt(nope + rope)), step by step, and the caches after."""
    for t, got, want, cache, rcache in _mla_decode_stream(per_slot):
        assert tuple(got.shape) == (3, 1, 64)
        assert _rel(got, want) <= TOL["float32"], t
    for key in ("ckv", "kpe"):
        assert _rel(cache[key], rcache[key]) <= TOL["float32"], key


def test_mla_decode_writes_the_cache_in_place_through_a_view():
    """The serve loop hands a bucket's leading slots as views: the step's
    per-slot writes of ``ckv`` and ``kpe`` land in the full cache."""
    cfg = _cfg("float32")
    full = attn.init_mla_cache(cfg, 4, 8)
    view = {k: leaf[:2] for k, leaf in full.items()}
    params = _torch_tree(_ref_params("mla"))
    pos = torch.tensor([1, 4], dtype=torch.int32)
    with torch.no_grad():
        _, out = attn.mla_decode(params, torch.from_numpy(_x(6, b=2, s=1)),
                                 view, pos, cfg)
    assert out is view
    for key, leaf in full.items():
        assert view[key].data_ptr() == leaf.data_ptr()
        written = torch.zeros(leaf.shape[:2], dtype=torch.bool)
        written[0, 1] = written[1, 4] = True
        assert bool((leaf[written].abs().sum(-1) > 0).all()), key
        assert float(leaf[~written].abs().sum()) == 0.0, key


def test_mla_decode_proj_hooks_replace_only_the_projections():
    """``proj={"qkv", "o"}`` given the plain products gives the plain
    step's output bit for bit: the hooks replace the wq|w_dkv and wo
    matmuls and nothing else."""
    cfg = _cfg("float32")
    params = _torch_tree(_ref_params("mla"))
    d = cfg.d_model

    def qkv(x):
        return (x @ params["wq"].reshape(d, -1)).unflatten(
            -1, params["wq"].shape[1:]), x @ params["w_dkv"]
    proj = {"qkv": qkv, "o": lambda o: o @ params["wo"].reshape(-1, d)}
    x = torch.from_numpy(_x(8, b=2, s=1))
    pos = torch.tensor([0, 2], dtype=torch.int32)
    with torch.no_grad():
        want, _ = attn.mla_decode(params, x, attn.init_mla_cache(cfg, 2, 4),
                                  pos, cfg)
        got, _ = attn.mla_decode(params, x, attn.init_mla_cache(cfg, 2, 4),
                                 pos, cfg, proj=proj)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _ref_drops(tree, x, rcfg) -> int:
    """Dropped (token, choice) pairs of the reference's routing, rebuilt
    from its own router and capacity rule."""
    import jax
    from repro.configs.base import pad_to
    from repro.models import moe as ref_moe
    b, s, _ = x.shape
    e, k = rcfg.n_experts, rcfg.top_k
    cap = pad_to(max(int(s * k / e * rcfg.capacity_factor), 4), 4)
    _, idx, _, _ = jax.jit(functools.partial(ref_moe._router, cfg=rcfg))(
        _jax_tree(tree), jax.numpy.asarray(x, rcfg.compute_dtype))
    onehot = np.eye(e, dtype=np.int64)[np.asarray(idx).reshape(b, s * k)]
    pos = np.take_along_axis(np.cumsum(onehot, axis=1) - 1,
                             np.asarray(idx).reshape(b, s * k, 1), -1)
    return int((pos >= cap).sum())


def _margins(tree, x, cfg) -> torch.Tensor:
    """The port's top-k margin per token, (B, S)."""
    p = _torch_tree(tree)
    xt = torch.from_numpy(x).to(getattr(torch, cfg.compute_dtype))
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    return top[..., cfg.top_k - 1] - top[..., cfg.top_k]


@pytest.mark.parametrize("capacity_factor,dropped", [(8.0, 0), (1.25, 5)],
                         ids=["cf8_no_drops", "cf1.25_drops"])
def test_moe_ffn_matches_reference(capacity_factor, dropped):
    """Float32 capacity routing: the output, the load-balance and z
    losses, and the same count of dropped (token, choice) pairs; at the
    config's ``capacity_factor`` of 1.25 (4 slots an expert for 24
    choices over 8 experts) five choices drop into the dump slot."""
    import jax
    from repro.models import moe as ref_moe
    tree = _ref_params("moe")
    x = _x(2)
    rcfg = _ref_cfg("float32", capacity_factor=capacity_factor)
    cfg = _cfg("float32", capacity_factor=capacity_factor)
    want, wlb, wz = jax.jit(functools.partial(ref_moe.moe_ffn, cfg=rcfg))(
        _jax_tree(tree), jax.numpy.asarray(x))
    drops = []
    with torch.no_grad():
        got, lb, z = moe.moe_ffn(_torch_tree(tree), torch.from_numpy(x), cfg,
                                 drops=drops)
    assert _rel(got, want) <= TOL["float32"]
    assert abs(float(lb) - float(wlb)) <= 1e-5 * abs(float(wlb))
    assert abs(float(z) - float(wz)) <= 1e-5 * abs(float(wz))
    assert [int(n) for n in drops] == [dropped]
    assert _ref_drops(tree, x, rcfg) == dropped


def test_moe_ffn_bfloat16_matches_reference_off_near_ties():
    """bfloat16 compute at a capacity no choice reaches: every token
    whose top-k margin exceeds ``MARGIN``."""
    import jax
    from repro.models import moe as ref_moe
    tree = _ref_params("moe")
    x = _x(5)
    rcfg = _ref_cfg("bfloat16", capacity_factor=8.0)
    cfg = _cfg("bfloat16", capacity_factor=8.0)
    want, _, _ = jax.jit(functools.partial(ref_moe.moe_ffn, cfg=rcfg))(
        _jax_tree(tree), jax.numpy.asarray(x, "bfloat16"))
    with torch.no_grad():
        got, _, _ = moe.moe_ffn(_torch_tree(tree),
                                torch.from_numpy(x).to(torch.bfloat16), cfg)
    keep = (_margins(tree, x, cfg) > MARGIN).numpy()
    assert int((~keep).sum()) == 1
    assert _rel(got, want, keep) <= TOL["bfloat16"]


def test_moe_ffn_decode_matches_reference():
    """One token per slot: every expert computed densely, combined with
    the router's top-k weights, plus the shared experts."""
    import jax
    from repro.models import moe as ref_moe
    tree = _ref_params("moe")
    x = _x(7, b=5, s=1)
    want = jax.jit(functools.partial(ref_moe.moe_ffn_decode,
                                     cfg=_ref_cfg("float32")))(
        _jax_tree(tree), jax.numpy.asarray(x))
    with torch.no_grad():
        got = moe.moe_ffn_decode(_torch_tree(tree), torch.from_numpy(x),
                                 _cfg("float32"))
    assert tuple(got.shape) == (5, 1, 64)
    assert _rel(got, want) <= TOL["float32"]


def test_moe_forward_is_the_same_on_every_run():
    """The dispatch and the combine are gathers: two runs give the same
    bits (an atomic scatter-add of k rows per token would not, on the
    card)."""
    tree = _torch_tree(_ref_params("moe"))
    x = torch.from_numpy(_x(9)).to(torch.bfloat16)
    cfg = _cfg("bfloat16", capacity_factor=0.5)
    with torch.no_grad():
        a = moe.moe_ffn(tree, x, cfg)[0]
        b = moe.moe_ffn(tree, x, cfg)[0]
    assert torch.equal(a, b)


def test_capacity_follows_the_reference_rule():
    cfg = _cfg("float32")
    assert moe.capacity(cfg, 12) == 4            # max(int(3.75), 4)
    assert moe.capacity(cfg, 100) == 32          # pad_to(31, 4)
    full = dataclasses.replace(tiny_config(ARCH), n_experts=64, top_k=6)
    assert moe.capacity(full, 4096) == 480       # int(480.0)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_mla_forward_launches_flash_against_plain(cuda):
    """A tiny deepseek's MLA prefill through the flash kernel (hd 24, hd_v
    16) in float32 against the plain attention."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.models import build_model
    cfg = _cfg("float32")
    model = build_model(cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    with torch.inference_mode():
        n0 = flash_attention_kernel.launches
        got, _ = model(toks)
        assert flash_attention_kernel.launches - n0 == cfg.n_layers
        want, _ = model(toks, force_kernel=False)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= \
        TOL["float32"]
