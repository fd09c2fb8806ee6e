"""The port's SSM mixers (``repro_torch.models.ssm``: RWKV6's time and
channel mix, the Mamba S6 block) against the JAX package's
``repro.models.ssm``, function by function, on the CPU.

Each case draws the reference's parameters with its own init
(``PRNGKey(0)``) at ``tiny_config`` size, perturbs every leaf by 0.05 of a
seeded numpy normal draw (so that zero and one inits are neither), and
hands the same numpy arrays to both packages, with inputs and non-zero
states from a seeded numpy generator.

Tolerances, relative to the reference's max |output| (and per state leaf
to its max |leaf|):

* float32 compute: 1e-5 for one decode step, 1e-4 for a whole sequence
  (the same float32 arithmetic through two libraries, summed in other
  orders, over 16 recurrent steps);
* bfloat16 compute: 2e-2 where the output is well conditioned; RWKV6's
  per-head group norm after the bfloat16 rounding of the scan's output is
  not (a head whose values sit close to their mean loses its digits to
  the subtraction), so a bfloat16 time mix is held to the float32
  reference by the reference's own bfloat16 distance from it: at most
  twice that, and the groupnorm's input within 2e-2.

The ``cuda`` case runs on the card and imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.models.layers import chunked_scan

RWKV, MAMBA = "rwkv6-1.6b", "jamba-v0.1-52b"
STEP_TOL, SEQ_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
B, S = 2, 16


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


def _cfgs(arch: str, dtype: str):
    """(the reference's config, the port's), at ``dtype`` compute."""
    from repro.configs import tiny_config as ref_tiny_config
    return (dataclasses.replace(ref_tiny_config(arch), compute_dtype=dtype),
            dataclasses.replace(tiny_config(arch), compute_dtype=dtype))


def _params(arch: str, seed: int = 1):
    """The reference's block parameters, perturbed, as numpy."""
    import jax
    from repro.models import ssm as ref_ssm
    cfg, _ = _cfgs(arch, "float32")
    init = ref_ssm.init_rwkv_block if arch == RWKV else \
        ref_ssm.init_mamba_block
    p = init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v, np.float32) + 0.05 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in p.items()}


def _state(arch: str, batch: int, nonzero: bool, seed: int = 2):
    """A float32 state: zeros, or a seeded normal draw (conv and token
    shift at unit scale, the recurrent matrices at 0.5)."""
    from repro.models import ssm as ref_ssm
    cfg, _ = _cfgs(arch, "float32")
    init = ref_ssm.init_rwkv_state if arch == RWKV else \
        ref_ssm.init_mamba_state
    zeros = {k: np.zeros(v.shape, np.float32)
             for k, v in init(cfg, batch).items()}
    if not nonzero:
        return zeros
    rng = np.random.default_rng(seed)
    scale = {"wkv": 0.5, "ssm": 0.5}
    return {k: (scale.get(k, 1.0) * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in zeros.items()}


def _x(shape, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax(tree):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _run(arch, fn_name, dtype, x, state):
    """(reference's (out, state), port's (out, state)) of ``fn_name`` on
    the same inputs."""
    from repro.models import ssm as ref_ssm
    import jax.numpy as jnp
    ref_cfg, cfg = _cfgs(arch, dtype)
    p = _params(arch)
    cd = getattr(jnp, dtype)
    want = getattr(ref_ssm, fn_name)(_jax(p), jnp.asarray(x).astype(cd),
                                     _jax(state), ref_cfg)
    with torch.no_grad():
        got = getattr(ssm, fn_name)(_torch(p), torch.from_numpy(x).to(
            getattr(torch, dtype)), _torch(state), cfg)
    return want, got


def _hold(want, got, tol: float):
    (w_out, w_state), (g_out, g_state) = want, got
    assert g_out.dtype == getattr(torch, str(w_out.dtype))
    assert _rel(g_out, w_out) <= tol, _rel(g_out, w_out)
    assert set(g_state) == set(w_state)
    for k, v in w_state.items():
        assert g_state[k].dtype == torch.float32, k
        if np.abs(np.asarray(v)).max() == 0:
            assert float(g_state[k].abs().max()) == 0.0, k
        else:
            assert _rel(g_state[k], v) <= tol, (k, _rel(g_state[k], v))


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("fn_name", ["rwkv_time_mix", "rwkv_channel_mix"])
def test_rwkv_sequence_matches_reference(fn_name, nonzero):
    """A 16-token sequence from a zero state and from a carried (random)
    one, float32 compute: the output and every state leaf."""
    _, cfg = _cfgs(RWKV, "float32")
    want, got = _run(RWKV, fn_name, "float32", _x((B, S, cfg.d_model)),
                     _state(RWKV, B, nonzero))
    _hold(want, got, SEQ_TOL)


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("fn_name", ["rwkv_decode_step",
                                     "rwkv_channel_mix_decode"])
def test_rwkv_decode_step_matches_reference(fn_name, nonzero):
    _, cfg = _cfgs(RWKV, "float32")
    want, got = _run(RWKV, fn_name, "float32", _x((B, 1, cfg.d_model)),
                     _state(RWKV, B, nonzero))
    _hold(want, got, STEP_TOL)


def test_rwkv_channel_mix_matches_reference_in_bfloat16():
    _, cfg = _cfgs(RWKV, "bfloat16")
    want, got = _run(RWKV, "rwkv_channel_mix", "bfloat16",
                     _x((B, S, cfg.d_model)), _state(RWKV, B, True))
    _hold(want, got, BF16_TOL)


def test_rwkv_time_mix_in_bfloat16_is_as_close_as_the_references_own():
    """The bfloat16 time mix's distance from the float32 reference is at
    most twice the reference's own bfloat16 distance, and the wkv state
    (float32 from bfloat16-rounded r, k, v) within 2e-2."""
    _, cfg = _cfgs(RWKV, "float32")
    x, st = _x((B, S, cfg.d_model)), _state(RWKV, B, True)
    (w32, s32), _ = _run(RWKV, "rwkv_time_mix", "float32", x, st)
    (w16, _), (g16, gs16) = _run(RWKV, "rwkv_time_mix", "bfloat16", x, st)
    ref_off = _rel(np.asarray(w16, np.float32), w32)
    assert _rel(g16, w32) <= 2 * ref_off, (_rel(g16, w32), ref_off)
    assert _rel(gs16["wkv"], s32["wkv"]) <= BF16_TOL


def test_rwkv_group_norm_uses_the_population_variance():
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    x = _x((3, 5, 64))
    scale, bias = _x((64,), seed=4), _x((64,), seed=5)
    want = ref_ssm._group_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 4)
    got = ssm._group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), 4)
    assert _rel(got, want) <= STEP_TOL
    heads = torch.from_numpy(x).reshape(3, 5, 4, 16)
    plain = ssm._group_norm(torch.from_numpy(x), torch.ones(64),
                            torch.zeros(64), 4).reshape(3, 5, 4, 16)
    var = ((heads - heads.mean(-1, keepdim=True)) ** 2).mean(-1)
    torch.testing.assert_close(plain, (heads - heads.mean(-1, keepdim=True))
                               * torch.rsqrt(var + 1e-5)[..., None])


def test_rwkv_decay_is_clipped_in_float32():
    """w0 pushed to +-30 in some channels: the decay's exponent is clipped
    to [-10, 10] (w = exp(-exp(10)) = 0 and exp(-exp(-10)) ~ 1), in
    float32 also under bfloat16 compute."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = _cfgs(RWKV, dtype)
        p = _params(RWKV)
        p["w0"][:8], p["w0"][8:16] = 30.0, -30.0
        x, xp = _x((B, cfg.d_model)), _x((B, cfg.d_model), seed=6)
        cd = getattr(jnp, dtype)
        want = ref_ssm._rwkv_projections(_jax(p), jnp.asarray(x).astype(cd),
                                         jnp.asarray(xp).astype(cd),
                                         ref_cfg)[3]
        got = ssm._rwkv_projections(_torch(p), torch.from_numpy(x).to(
            getattr(torch, dtype)), torch.from_numpy(xp).to(
                getattr(torch, dtype)), cfg)[3]
        assert got.dtype == torch.float32
        assert _rel(got, want) <= STEP_TOL
        assert float(got[:, :8].max()) == 0.0
        floor = torch.exp(-torch.exp(torch.tensor(-10.0)))
        assert bool((got[:, 8:16] == floor).all())


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "carried"])
def test_mamba_forward_matches_reference(nonzero):
    """A 16-token sequence from a zero and from a carried conv and ssm
    state, float32 compute: the output, the conv window and the ssm
    state."""
    _, cfg = _cfgs(MAMBA, "float32")
    want, got = _run(MAMBA, "mamba_forward", "float32",
                     _x((B, S, cfg.d_model)), _state(MAMBA, B, nonzero))
    _hold(want, got, SEQ_TOL)


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "carried"])
def test_mamba_decode_step_matches_reference(nonzero):
    """One step: the port's conv over the (cw)-token window against the
    reference's windowed einsum."""
    _, cfg = _cfgs(MAMBA, "float32")
    want, got = _run(MAMBA, "mamba_decode_step", "float32",
                     _x((B, 1, cfg.d_model)), _state(MAMBA, B, nonzero))
    _hold(want, got, STEP_TOL)


def test_mamba_forward_matches_reference_in_bfloat16():
    _, cfg = _cfgs(MAMBA, "bfloat16")
    want, got = _run(MAMBA, "mamba_forward", "bfloat16",
                     _x((B, S, cfg.d_model)), _state(MAMBA, B, True))
    _hold(want, got, BF16_TOL)


def test_mamba_decode_steps_continue_the_forward():
    """Within the port: a forward over 8 tokens then 8 decode steps from
    its state equal one forward over all 16 (float32)."""
    _, cfg = _cfgs(MAMBA, "float32")
    p = _torch(_params(MAMBA))
    x = torch.from_numpy(_x((B, S, cfg.d_model)))
    st = _torch(_state(MAMBA, B, True))
    with torch.no_grad():
        full, want = ssm.mamba_forward(p, x, st, cfg)
        out, state = ssm.mamba_forward(p, x[:, :8], st, cfg)
        outs = [out]
        for t in range(8, S):
            out, state = ssm.mamba_decode_step(p, x[:, t:t + 1], state, cfg)
            outs.append(out)
    assert _rel(torch.cat(outs, dim=1), full) <= SEQ_TOL
    for k in want:
        assert _rel(state[k], want[k]) <= SEQ_TOL, k


# --------------------------------------------------------------------------
# init, the scan's contract
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, MAMBA])
def test_blocks_and_states_have_the_references_leaves(arch):
    from repro.models import ssm as ref_ssm
    ref_cfg, cfg = _cfgs(arch, "float32")
    gen = torch.Generator().manual_seed(0)
    if arch == RWKV:
        got, want = ssm.init_rwkv_block(gen, cfg), _params(arch)
        gst = ssm.init_rwkv_state(cfg, 3)
        wst = ref_ssm.init_rwkv_state(ref_cfg, 3)
    else:
        got, want = ssm.init_mamba_block(gen, cfg), _params(arch)
        gst = ssm.init_mamba_state(cfg, 3)
        wst = ref_ssm.init_mamba_state(ref_cfg, 3)
        np.testing.assert_allclose(
            got["A_log"].detach().numpy(),
            np.log(np.broadcast_to(np.arange(1, cfg.d_state + 1,
                                             dtype=np.float32),
                                   got["A_log"].shape)), rtol=1e-6)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in gst.items()} == \
        {k: (v.shape, torch.float32) for k, v in wst.items()}
    assert all(float(v.abs().max()) == 0.0 for v in gst.values())


def test_chunked_scan_refuses_what_the_reference_refuses():
    """S = 200 with chunk min(128, S): the reference's ValueError; S = 256
    runs and steps in time order."""
    from repro.models import layers as ref_layers
    import jax.numpy as jnp

    def step(st, inp):
        return st + inp[0], st

    with pytest.raises(ValueError, match="not divisible"):
        chunked_scan(step, torch.zeros(2), (torch.ones(200, 2),), 128)
    with pytest.raises(ValueError, match="not divisible"):
        ref_layers.chunked_scan(lambda s, x: (s + x[0], s), jnp.zeros(2),
                                (jnp.ones((200, 2)),), 128)
    final, ys = chunked_scan(step, torch.zeros(2),
                             (torch.arange(256.0)[:, None].expand(256, 2),),
                             128)
    assert float(final[0]) == 255 * 256 / 2
    assert torch.equal(ys[:, 0], torch.cumsum(torch.arange(256.0), 0)
                       - torch.arange(256.0))


def test_rwkv_time_mix_refuses_an_undivided_length():
    _, cfg = _cfgs(RWKV, "float32")
    p = _torch(_params(RWKV))
    with pytest.raises(ValueError, match="not divisible"):
        ssm.rwkv_time_mix(p, torch.zeros(1, 200, cfg.d_model),
                          _torch(_state(RWKV, 1, False)), cfg)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def test_cuda_jamba_forward_through_the_flash_kernel(cuda):
    """Tiny jamba (mamba, attention, MoE) in float32 compute: the forward
    launches the flash kernel once, for its one attention layer, and
    agrees with the plain attention within 1e-4 of max |logits|."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    cfg = dataclasses.replace(tiny_config(MAMBA), compute_dtype="float32")
    model = build_model(cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(cuda)
    with torch.inference_mode():
        n0 = flash_attention_kernel.launches
        got, _ = model(toks)
        assert flash_attention_kernel.launches - n0 == 1
        want, _ = model(toks, force_kernel=False)
        assert flash_attention_kernel.launches - n0 == 1
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= SEQ_TOL, err
