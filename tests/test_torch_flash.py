"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``)
against the JAX package.

On the CPU the port runs the kernel's plain version
(``repro_torch.kernels.ref.mha_reference``).  It is held, on the same numpy
inputs, against three JAX functions: the Pallas kernel
``repro.kernels.flash_attention.flash_attention_kernel`` in interpret mode,
the dense oracle ``repro.kernels.ref.mha_reference``, and the model's
blockwise ``repro.models.attention.flash_attention`` with ``arange``
positions (what ``TransformerLM.forward`` passes).  The sweep is
``tests/test_kernels.py``'s plus a soft-capped case, in float32 and
bfloat16.  The ``cuda`` cases hold the hand-written CUDA kernel against its
plain version and skip without a card; they import no JAX:
``python -m pytest -q tests/test_torch_flash.py -k cuda``.

The bfloat16 CUDA kernel has rounding points of its own (``scale`` applied
to the float32 product, P rounded to bfloat16 before ``P . V``, the
online softmax over 128-key tiles).  A plain emulation of them,
``_emulate_bf16_kernel``, is held against the same JAX references on the
CPU; it is a test helper, not a kernel.

Tolerances:

* float32, 3e-5 absolute: the reference's own bar for its kernel against
  its oracle (outputs are convex combinations of unit normals);
* bfloat16, 2e-2 of max |reference|: both sides round q, k, v and the
  output to bfloat16 (2^-8 relative), and the Pallas wrapper also rounds
  ``q * scale`` to bfloat16 where the port scales in float32; the bf16
  kernel's P adds one more bfloat16 rounding of weights that sum to 1.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 load_width)

DTYPES = ["float32", "bfloat16"]
F32_ATOL = 3e-5
BF16_REL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread here keeps these CPU-heavy cases from starving the
    timing-sensitive tests that other workers run at the same time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_kernels.py:95-100 — (B, Sq, Skv, H, KV, hd, causal) — plus
# the soft-capped case of tests/test_kernels.py:113-122, and a softcap
# under GQA
CASES = [
    (1, 128, 128, 4, 4, 64, True, 0.0),
    (2, 100, 100, 4, 2, 32, True, 0.0),
    (1, 256, 256, 8, 8, 128, False, 0.0),
    (2, 64, 192, 4, 1, 64, False, 0.0),
    (1, 65, 130, 2, 2, 48, True, 0.0),       # ragged, padded tiles
    (1, 64, 64, 2, 2, 32, True, 20.0),
    (1, 96, 96, 4, 2, 16, True, 20.0),
]
CASE_IDS = ["b{}-sq{}-skv{}-h{}-kv{}-hd{}-{}-cap{:g}".format(
    b, sq, skv, h, kv, hd, "causal" if c else "full", cap)
    for b, sq, skv, h, kv, hd, c, cap in CASES]


def _inputs(case, seed):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def _torch(x, dtype: str, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        device=device, dtype=getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x.astype("float32"))


def _check(got, want, dtype: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    if dtype == "float32":
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_REL * float(np.max(np.abs(want))), err


def _jax_reference(name: str, q, k, v, *, causal: bool, softcap: float):
    import jax.numpy as jnp
    if name == "pallas":
        from repro.kernels.flash_attention import flash_attention_kernel as f
        return f(q, k, v, causal=causal, softcap=softcap, bq=64, bkv=64,
                 interpret=True)
    if name == "oracle":
        from repro.kernels import ref as jref
        return jref.mha_reference(q, k, v, causal=causal, softcap=softcap)
    from repro.models.attention import flash_attention as model_flash
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32)[None], (b, sq))
    kpos = jnp.broadcast_to(jnp.arange(skv, dtype=jnp.int32)[None], (b, skv))
    return model_flash(q, k, v, q_positions=qpos, kv_positions=kpos,
                       causal=causal, softcap=softcap)


@functools.lru_cache(maxsize=None)
def _jax_reference_np(name: str, case: tuple, dtype: str) -> np.ndarray:
    """``_jax_reference`` on ``_inputs(case)`` as float32 numpy, computed
    once per (reference, case, dtype) for the tests that share it."""
    import jax.numpy as jnp
    q, k, v = _inputs(case, seed=sum(case[:6]))
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    return _np(_jax_reference(name, jq, jk, jv, causal=case[6],
                              softcap=case[7]))


def _emulate_bf16_kernel(q, k, v, *, causal: bool, softcap: float,
                         bkv: int) -> torch.Tensor:
    """The bfloat16 CUDA kernel's arithmetic in plain PyTorch: S = q . k in
    float32 from bfloat16 inputs, then ``scale`` (and the softcap), the
    online softmax over tiles of ``bkv`` keys with the row sum of the
    float32 P, P rounded to bfloat16 for ``P . V``, the output rounded to
    bfloat16.  q (B, Sq, H, hd), k/v (B, Skv, KV, hd)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    bf = torch.bfloat16
    qf = q.to(bf).float()
    kf = k.to(bf).float().repeat_interleave(h // kvh, dim=2)
    vf = v.to(bf).float().repeat_interleave(h // kvh, dim=2)
    scale = 1.0 / hd ** 0.5
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    qi = torch.arange(sq)[:, None]
    for j0 in range(0, skv, bkv):
        j1 = min(j0 + bkv, skv)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, j0:j1]) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            s = s.masked_fill(torch.arange(j0, j1)[None, :] > qi, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(bf).float(), vf[:, j0:j1])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(bf)


@pytest.mark.parametrize("reference", ["pallas", "oracle"])
@pytest.mark.parametrize("bkv", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bf16_kernel_numerics_match_reference(case, bkv, reference):
    """The bf16 kernel's rounding points stay within bfloat16's 2e-2 of the
    Pallas kernel (interpret mode) and of the dense oracle."""
    causal, softcap = case[6], case[7]
    q, k, v = (_torch(x, "bfloat16") for x in _inputs(case,
                                                       seed=sum(case[:6])))
    got = _emulate_bf16_kernel(q, k, v, causal=causal, softcap=softcap,
                               bkv=bkv)
    _check(got, _jax_reference_np(reference, case, "bfloat16"), "bfloat16")


def test_load_width_picks_tma_only_for_aligned_nested_strides():
    """16 (TMA) for contiguous and fused-projection layouts at every hd of
    16-byte rows; else the widest plain load the rows allow."""
    bf = torch.bfloat16

    def qkv(hd, h=4, kv=2, s=8, b=2):
        return (torch.zeros(b, s, h, hd, dtype=bf),
                torch.zeros(b, s, kv, hd, dtype=bf),
                torch.zeros(b, s, kv, hd, dtype=bf))

    assert load_width(*qkv(128)) == 16
    assert load_width(*qkv(8)) == 16
    assert load_width(*qkv(20)) == 8           # 40-byte rows
    assert load_width(*qkv(18)) == 4           # 36-byte rows
    assert load_width(*qkv(21)) == 2           # 42-byte rows
    fused = torch.zeros(2, 8, 4 + 2 * 2, 64, dtype=bf)
    assert load_width(fused[:, :, :4], fused[:, :, 4:6],
                      fused[:, :, 6:]) == 16
    padded = [t[..., :20] for t in qkv(24)]    # 48-byte strides
    assert load_width(*padded) == 16
    padded = [t[..., :20] for t in qkv(24, kv=1)]   # one kv head
    assert load_width(*padded) == 16
    # a batch of one: its stride is never stepped
    q, k, v = qkv(64, b=1)
    assert load_width(q.transpose(0, 1).transpose(0, 1), k, v) == 16
    # heads outside the sequence: strides that do not nest
    q = torch.zeros(2, 4, 8, 64, dtype=bf).transpose(1, 2)
    assert load_width(q, *qkv(64, s=8)[1:]) == 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# CPU: the plain version against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reference", ["pallas", "oracle", "model"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_reference(case, dtype, reference):
    import jax.numpy as jnp
    causal, softcap = case[6], case[7]
    q, k, v = _inputs(case, seed=sum(case[:6]))
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal,
                              softcap=softcap)
    assert got.dtype == getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    want = _jax_reference(reference, jq, jk, jv, causal=causal,
                          softcap=softcap)
    _check(got, want, dtype)


def test_gqa_head_h_reads_kv_head_h_over_g():
    """Query head h attends kv head h // G (G innermost, as the reference's
    (B, S, KV, G, hd) reshape): with one kv head made dominant, only its G
    query heads see it."""
    rng = np.random.default_rng(5)
    b, s, h, kv, hd = 1, 8, 6, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
    k = torch.zeros(b, s, kv, hd)
    v = torch.zeros(b, s, kv, hd)
    v[:, :, 1] = 1.0
    out = ops.flash_attention(q, k, v, causal=True)
    g = h // kv
    assert torch.all(out[:, :, :g] == 0)
    torch.testing.assert_close(out[:, :, g:], torch.ones(b, s, h - g, hd))


# MLA's widths, (B, Sq, Skv, H, KV, hd, hd_v, causal): the tiny deepseek's
# q . k over nope 16 + rope 8 = 24 against v 16, and the full model's 192
# against 128 at a short sequence
MLA_CASES = [(2, 40, 40, 4, 4, 24, 16, True),
             (1, 130, 130, 3, 3, 192, 128, True),
             (1, 70, 140, 2, 2, 192, 128, False),
             (1, 150, 90, 8, 2, 192, 128, True)]


def _mla_inputs(case, seed):
    b, sq, skv, h, kv, hd, hd_v = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd_v)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_CASES[:2])
def test_plain_mla_widths_match_the_blockwise_reference(case, dtype):
    """A v narrower than q . k (MLA): the plain version returns hd_v
    columns, scaled by 1/sqrt(hd) of the q . k width, as the reference's
    blockwise ``models.attention.flash_attention``, which its
    ``mla_forward`` calls."""
    import jax.numpy as jnp
    causal = case[7]
    q, k, v = _mla_inputs(case, seed=3)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal)
    assert tuple(got.shape) == q.shape[:3] + (case[6],)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    _check(got, _jax_reference("model", jq, jk, jv, causal=causal,
                               softcap=0.0), dtype)


# --------------------------------------------------------------------------
# the float32 kernel's 3xTF32 arithmetic
# --------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, hd_v, causal, softcap): MLA's 192/128 causal and
# full (Sq != Skv), hd 64, hd 20 and GQA, causal and full, with softcap
E3_CASES = [
    (1, 130, 130, 3, 3, 192, 128, True, 0.0),
    (1, 70, 140, 2, 2, 192, 128, False, 20.0),
    (1, 128, 128, 4, 4, 64, 64, True, 0.0),
    (2, 64, 192, 4, 1, 64, 64, False, 20.0),
    (2, 100, 100, 7, 1, 20, 20, True, 0.0),
    (1, 96, 96, 8, 2, 128, 128, True, 20.0),
]
E3_IDS = ["b{}-sq{}-skv{}-h{}-kv{}-hd{}-{}-{}-cap{:g}".format(
    b, sq, skv, h, kv, hd, hdv, "causal" if c else "full", cap)
    for b, sq, skv, h, kv, hd, hdv, c, cap in E3_CASES]
E3_REL = 1e-4          # the kernel's tolerance: of max |reference|
E3_RUNS = [(case, ref_name) for case in E3_CASES
           for ref_name in (("pallas", "oracle", "model")
                            if case[5] == case[6] else ("model",))]


def test_tf32_split_reconstructs_x_within_2_to_the_minus_22():
    """hi and lo carry 10 mantissa bits each (the low 13 bits zero, as the
    tensor cores read a tf32 operand), hi rounds to nearest with ties away
    from zero as ``tf32_round`` in ``csrc/coded_matmul.cu``, and hi + lo is
    x to within 2^-22 of |x|; infinities pass unchanged."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.standard_normal(20000) *
                          10.0 ** rng.integers(-30, 30, 20000))
                         .astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs() /
           x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # ties: 1 + 2^-11 lies halfway between two tf32 values and rounds away
    # from zero; just below it rounds down
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11),
                        np.nextafter(np.float32(1 + 2 ** -11), 0)],
                       dtype=torch.float32)
    assert ref.tf32_split(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                               1.0]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(ref.tf32_split(inf)[0], inf)


@pytest.mark.parametrize("case,reference", E3_RUNS,
                         ids=[f"{i}-{r}" for (c, r), i in
                              zip(E3_RUNS, [E3_IDS[E3_CASES.index(c)]
                                            for c, _ in E3_RUNS])])
def test_3xtf32_emulation_matches_the_jax_references(case, reference):
    """``ref.mha_3xtf32``, the float32 kernel's arithmetic (q scaled in
    float32, each product lo.hi + hi.lo + hi.hi over TF32 splits, the
    online softmax over the kernel's key tiles: 64 keys up to hd 64, else
    32), within 1e-4 of max |reference| of the JAX package's flash
    functions in float32, as the file runs them: the Pallas kernel in
    interpret mode, the dense oracle and the model's blockwise flash (the
    only one of them that takes MLA's narrower v)."""
    import jax.numpy as jnp
    causal, softcap = case[7], case[8]
    q, k, v = _mla_inputs(case, seed=sum(case[:7]))
    got = ref.mha_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal, softcap=softcap,
                         bkv=64 if case[5] <= 64 else 32)
    want = _np(_jax_reference(reference, *(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, softcap=softcap))
    assert tuple(got.shape) == want.shape
    assert _rel_err(got, want) <= E3_REL


def test_3xtf32_lse_matches_the_plain_forward():
    """The emulation's lse (m + log l over its tiles) within 1e-5 of the
    plain forward's, the backward's bar for the kernel's lse."""
    case = E3_CASES[1]
    q, k, v = (torch.from_numpy(x) for x in _mla_inputs(case, seed=4))
    _, lse = ref.mha_3xtf32(q, k, v, causal=False, softcap=20.0,
                            return_lse=True)
    _, want = ref.mha_reference(q, k, v, causal=False, softcap=20.0,
                                return_lse=True)
    assert float((lse - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_plain_planes_hold_scaled_q_k_and_v_transposed_in_key_order():
    """``ref.flash_f32_planes``, the plain version of the pre-pass: q *
    scale and k as hi and lo planes per (batch, head), zero past Sq, Skv and
    hd; v transposed, keys contiguous, and in every group of 8 in the order
    (0, 2, 4, 6, 1, 3, 5, 7); hi + lo gives each value back."""
    rng = np.random.default_rng(22)
    b, sq, skv, h, kv, hd, hd_v = 2, 50, 45, 4, 2, 20, 12
    q = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, skv, kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, kv, hd_v)).astype(np.float32))
    qp, kp, vp = ref.flash_f32_planes(q, k, v, (128, 64, 32, 32))
    assert tuple(qp.shape) == (b * h, 2, 128, 32)
    assert tuple(kp.shape) == (b * kv, 2, 64, 32)
    assert tuple(vp.shape) == (b * kv, 2, 32, 64)
    scale = torch.tensor(1 / hd ** 0.5, dtype=torch.float32)
    qs = (q * scale).permute(0, 2, 1, 3).reshape(b * h, sq, hd)
    torch.testing.assert_close(qp.sum(1)[:, :sq, :hd], qs, rtol=2 ** -22,
                               atol=0)
    assert float(qp[:, :, sq:].abs().max()) == float(qp[..., hd:].abs().max()) == 0
    torch.testing.assert_close(
        kp.sum(1)[:, :skv, :hd], k.permute(0, 2, 1, 3).reshape(b * kv, skv, hd),
        rtol=2 ** -22, atol=0)
    vt = vp.sum(1)                                  # (B * KV, 32, 64)
    order = [8 * (i // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[i % 8] for i in range(64)]
    back = torch.zeros(b * kv, 32, 64)
    back[:, :, order] = vt
    torch.testing.assert_close(
        back[:, :hd_v, :skv],
        v.permute(0, 2, 3, 1).reshape(b * kv, hd_v, skv), rtol=2 ** -22,
        atol=0)
    assert float(back[:, hd_v:].abs().max()) == float(back[..., skv:].abs().max()) == 0


# --------------------------------------------------------------------------
# dispatch rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("force_kernel", [None, False])
def test_cpu_tensors_run_the_plain_version(force_kernel):
    q, k, v = (_torch(x, "float32") for x in _inputs(CASES[1], seed=1))
    before = ops.kernel_launches()
    got = ops.flash_attention(q, k, v, causal=True,
                              force_kernel=force_kernel)
    torch.testing.assert_close(got, ref.mha_reference(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert ops.kernel_launches() == before


def test_force_kernel_and_the_wrapper_refuse_cpu_tensors():
    q, k, v = (_torch(x, "float32") for x in _inputs(CASES[1], seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, force_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v)


def test_the_wrapper_refuses_inputs_that_require_grad():
    q, k, v = (_torch(x, "float32") for x in _inputs(CASES[1], seed=3))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q.requires_grad_(), k, v)


def test_the_build_table_names_the_flash_entry():
    """The forward's entry takes an ``lse`` pointer and the float32
    pre-pass's scratch (20 arguments), and the source has two helpers: the
    scratch's extents and the pre-pass alone; the backward is a source and
    an entry of its own (24 arguments: the dtype picks the route, the load
    width is the bfloat16 route's and 0 in float32), with the same two
    helpers of its own."""
    name, argtypes = _build._ENTRY["flash_attention"]
    assert name == "flash_attention_launch" and len(argtypes) == 20
    assert _build._HELPERS["flash_attention_scratch"][0] == "flash_attention"
    assert _build._HELPERS["flash_attention_split"][0] == "flash_attention"
    assert _build._target("flash_attention").name.startswith(
        "libflash_attention-")
    name, argtypes = _build._ENTRY["flash_attention_bwd"]
    assert name == "flash_attention_bwd_launch" and len(argtypes) == 24
    assert argtypes[-2] is ctypes.c_int and argtypes[-1] is ctypes.c_void_p
    assert _build._target("flash_attention_bwd").name.startswith(
        "libflash_attention_bwd-")
    for helper in ("flash_attention_bwd_scratch", "flash_attention_bwd_split"):
        assert _build._HELPERS[helper][0] == "flash_attention_bwd"


# --------------------------------------------------------------------------
# the backward's plain version against the reference's custom VJP
# --------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, hd_v, causal, softcap): G in {1, 4}, causal and
# full, Sq != Skv both ways (whisper's cross-attention is 1024 x 4096),
# softcap 20, hd 16 and MLA's 24/16; Skv 600 spans two of the
# reference's 512-key chunks
BWD_CASES = [
    (2, 40, 40, 4, 4, 16, 16, True, 0.0),
    (1, 48, 48, 8, 2, 16, 16, True, 0.0),
    (2, 24, 70, 4, 1, 16, 16, False, 0.0),
    (1, 70, 24, 4, 4, 16, 16, True, 0.0),
    (1, 32, 32, 4, 1, 16, 16, True, 20.0),
    (2, 40, 40, 4, 4, 24, 16, True, 0.0),
    (1, 20, 600, 4, 4, 16, 16, False, 20.0),
]
# the widths the card's routes run at a small sequence: phi3-mini's hd 96
# under GQA with softcap, and MLA's 192/128, causal and full (Sq != Skv)
BWD_WIDE = [
    (1, 40, 40, 4, 2, 96, 96, True, 20.0),
    (1, 36, 36, 2, 2, 192, 128, True, 0.0),
    (1, 20, 44, 2, 1, 192, 128, False, 0.0),
]


def _bwd_ids(cases):
    return ["b{}-sq{}-skv{}-h{}-kv{}-hd{}-{}-{}-cap{:g}".format(
        b, sq, skv, h, kv, hd, hdv, "causal" if c else "full", cap)
        for b, sq, skv, h, kv, hd, hdv, c, cap in cases]


BWD_IDS = _bwd_ids(BWD_CASES)
BWD_WIDE_IDS = _bwd_ids(BWD_WIDE)
BWD_REL = 1e-5


def _bwd_inputs(case, seed):
    b, sq, skv, h, kv, hd, hd_v = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd_v)).astype(np.float32),
            rng.standard_normal((b, sq, h, hd_v)).astype(np.float32))


def _rel_err(got, want) -> float:
    got = _np(got)
    want = _np(want) if torch.is_tensor(want) else np.asarray(want,
                                                              np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("case", BWD_CASES + BWD_WIDE,
                         ids=BWD_IDS + BWD_WIDE_IDS)
def test_plain_backward_matches_the_reference_vjp(case):
    """``ref.flash_attention_bwd_reference`` against ``jax.vjp`` of the
    reference's ``models.attention.flash_attention`` (its custom VJP,
    ``_flash_bwd``) and against torch autograd through
    ``ref.mha_reference``: dq, dk, dv within 1e-5 of max |ref| in
    float32; the plain forward's lse against ``_flash_fwd_core``'s."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    causal, softcap = case[7], case[8]
    q, k, v, do = _bwd_inputs(case, seed=sum(case[:7]))
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32)[None], (b, sq))
    kpos = jnp.broadcast_to(jnp.arange(skv, dtype=jnp.int32)[None], (b, skv))

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, q_positions=qpos,
                                     kv_positions=kpos, causal=causal,
                                     softcap=softcap)
    out_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ref.mha_reference(qt, kt, vt, causal=causal, softcap=softcap,
                                 return_lse=True)
    assert _rel_err(out, out_j) <= BWD_REL
    got = ref.flash_attention_bwd_reference(qt, kt, vt, out, lse, dot,
                                            causal, softcap)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= BWD_REL
    # torch autograd through the dense plain forward
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    ops.flash_attention(*leaves, causal=causal, softcap=softcap).backward(dot)
    for g, leaf in zip(got, leaves):
        assert _rel_err(g, leaf.grad) <= BWD_REL
    # the lse residual of the reference's forward core
    qg, kc, vc, pc, _, _ = jattn._prep(*(jnp.asarray(x) for x in (q, k, v)),
                                       kpos, jattn.ATTN_CHUNK)
    _, lse_j = jattn._flash_fwd_core(qg, kc, vc, pc, qpos, causal, softcap)
    lse_j = np.asarray(lse_j).reshape(lse.shape)
    assert float(np.max(np.abs(lse.numpy() - lse_j))) <= \
        BWD_REL * float(np.max(np.abs(lse_j)))


def _emulate_bf16_bwd(q, k, v, out, lse, dout, *, causal: bool,
                      softcap: float, bk: int = 64) -> tuple:
    """The bfloat16 tensor-core backward's arithmetic in plain PyTorch:
    bfloat16 inputs, s = scale * (q . k) with q . k a float32 sum (then
    the softcap), as the bf16 forward forms it; p = exp(s - lse), delta =
    rowsum(dout * out), ds = p (dp - delta) [(1 - t^2)] in float32, masked
    pairs 0; P and dS rounded to bfloat16 for dv = P^T dout, dk = scale
    dS^T q and dq = scale dS k, every sum float32, dq summed over tiles of
    ``bk`` keys in key order (the dq pass's fixed order); the results
    rounded to bfloat16.  q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv,
    KV, hd_v), out and dout (B, Sq, H, hd_v), lse (B, Sq, H)."""
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    bf = torch.bfloat16
    qf, kf, vf, of, dof = (t.to(bf).float() for t in (q, k, v, out, dout))
    kf, vf = (t.repeat_interleave(g, dim=2) for t in (kf, vf))
    scale = 1.0 / hd ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    valid = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        valid = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
    p = torch.where(valid, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    torch.zeros(()))
    delta = (dof * of).sum(-1).permute(0, 2, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - t * t)
    ds = torch.where(valid, ds, torch.zeros(()))
    pb, dsb = p.to(bf).float(), ds.to(bf).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) * scale
    dq = torch.zeros((b, sq, h, hd))
    for j0 in range(0, skv, bk):
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", dsb[..., j0:j0 + bk],
                               kf[:, j0:j0 + bk])
    dk = dk.reshape(b, skv, kvh, g, hd).sum(3)
    dv = dv.reshape(b, skv, kvh, g, hd_v).sum(3)
    return (dq * scale).to(bf), dk.to(bf), dv.to(bf)


@pytest.mark.parametrize("case", BWD_CASES + BWD_WIDE,
                         ids=BWD_IDS + BWD_WIDE_IDS)
def test_bf16_backward_numerics_match_the_reference_vjp(case):
    """The bfloat16 backward's rounding points (``_emulate_bf16_bwd``,
    fed the plain forward's bfloat16 output and lse, as the card feeds the
    forward kernel's) stay within bfloat16's 2e-2 of max |ref| of
    ``jax.vjp`` of the reference's ``models.attention.flash_attention``
    (its custom VJP, ``_flash_bwd``) in bfloat16, MLA's 192/128 among
    them."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    causal, softcap = case[7], case[8]
    q, k, v, do = _bwd_inputs(case, seed=sum(case[:7]))
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32)[None], (b, sq))
    kpos = jnp.broadcast_to(jnp.arange(skv, dtype=jnp.int32)[None], (b, skv))

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, q_positions=qpos,
                                     kv_positions=kpos, causal=causal,
                                     softcap=softcap)
    _, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    qt, kt, vt, dot = (_torch(x, "bfloat16") for x in (q, k, v, do))
    out, lse = ref.mha_reference(qt, kt, vt, causal=causal, softcap=softcap,
                                 return_lse=True)
    got = _emulate_bf16_bwd(qt, kt, vt, out, lse, dot, causal=causal,
                            softcap=softcap)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, w) <= BF16_REL, name


@pytest.mark.parametrize("case", BWD_CASES + BWD_WIDE,
                         ids=BWD_IDS + BWD_WIDE_IDS)
def test_3xtf32_backward_emulation_matches_the_reference_vjp(case):
    """``ref.flash_attention_bwd_3xtf32``, the float32 backward kernels'
    arithmetic (q scaled in float32, each product lo.hi + hi.lo + hi.hi
    over TF32 splits, p and ds in float32, each tile's product added in
    float32: 32 queries a tile for dk and dv, 32 keys for dq), fed the
    3xTF32 forward's output and lse (``ref.mha_3xtf32``, as the card feeds
    the float32 forward kernel's), within 1e-4 of max |ref| of ``jax.vjp``
    of the reference's ``models.attention.flash_attention`` (its custom
    VJP, ``_flash_bwd``) in float32."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    causal, softcap = case[7], case[8]
    q, k, v, do = _bwd_inputs(case, seed=sum(case[:7]) + 1)
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32)[None], (b, sq))
    kpos = jnp.broadcast_to(jnp.arange(skv, dtype=jnp.int32)[None], (b, skv))

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, q_positions=qpos,
                                     kv_positions=kpos, causal=causal,
                                     softcap=softcap)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ref.mha_3xtf32(qt, kt, vt, causal=causal, softcap=softcap,
                              return_lse=True, bkv=64 if case[5] <= 64
                              else 32)
    got = ref.flash_attention_bwd_3xtf32(qt, kt, vt, out, lse, dot, causal,
                                         softcap)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel_err(g, w) <= E3_REL, name


def test_plain_bwd_planes_hold_scaled_q_dout_k_v_and_their_transposes():
    """``ref.flash_bwd_f32_planes``, the plain version of the float32
    backward's pre-pass: lse * log2(e) and delta = rowsum(dout * out) per
    (batch, head), zero past Sq; q * scale, dout, k and v as hi and lo
    rows planes, zero past S and the width; (q * scale)^T, dout^T and k^T
    transposed, the sequence contiguous and in every group of 8 in the
    order (0, 2, 4, 6, 1, 3, 5, 7); hi + lo gives each value back."""
    rng = np.random.default_rng(23)
    b, sq, skv, h, kv, hd, hd_v = 2, 50, 45, 4, 2, 20, 12
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(
        (b, sq, skv, h, kv, hd, hd_v), seed=23))
    out = torch.from_numpy(rng.standard_normal((b, sq, h, hd_v))
                           .astype(np.float32))
    lse = torch.from_numpy(rng.standard_normal((b, sq, h)).astype(np.float32))
    planes = ref.flash_bwd_f32_planes(q, k, v, out, lse, do, (64, 64, 32, 32))
    lse2, delta, qr, dr, kr, vr, qt, dt, kt = planes
    assert tuple(lse2.shape) == tuple(delta.shape) == (b * h, 64)
    assert [tuple(p.shape) for p in planes[2:]] == [
        (b * h, 2, 64, 32), (b * h, 2, 64, 32), (b * kv, 2, 64, 32),
        (b * kv, 2, 64, 32), (b * h, 2, 32, 64), (b * h, 2, 32, 64),
        (b * kv, 2, 32, 64)]
    per_head = (lambda x: x.permute(0, 2, 1).reshape(b * h, sq))
    torch.testing.assert_close(lse2[:, :sq], per_head(lse) * 1.4426950408889634,
                               rtol=1e-7, atol=0)
    torch.testing.assert_close(delta[:, :sq], per_head((do * out).sum(-1)),
                               rtol=1e-6, atol=1e-6)
    assert float(lse2[:, sq:].abs().max()) == float(delta[:, sq:].abs().max()) == 0
    scale = torch.tensor(1 / hd ** 0.5, dtype=torch.float32)
    order = [8 * (i // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[i % 8] for i in range(64)]
    for rows, tr, x, s, n, w in ((qr, qt, q * scale, sq, h, hd),
                                 (dr, dt, do, sq, h, hd_v),
                                 (kr, kt, k, skv, kv, hd)):
        want = x.permute(0, 2, 1, 3).reshape(-1, s, w)
        torch.testing.assert_close(rows.sum(1)[:, :s, :w], want,
                                   rtol=2 ** -22, atol=0)
        assert float(rows[:, :, s:].abs().max()) == 0
        assert float(rows[..., w:].abs().max()) == 0
        back = torch.zeros(b * n, 32, 64)
        back[:, :, order] = tr.sum(1)
        torch.testing.assert_close(back[:, :w, :s], want.transpose(1, 2),
                                   rtol=2 ** -22, atol=0)
        assert float(back[:, w:].abs().max()) == float(back[..., s:].abs().max()) == 0
        for part in (rows, tr):        # tf32: the low 13 bits are zero
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    torch.testing.assert_close(vr.sum(1)[:, :skv, :hd_v],
                               v.permute(0, 2, 1, 3).reshape(-1, skv, hd_v),
                               rtol=2 ** -22, atol=0)


def test_backward_route_picks_the_kernel_by_dtype_width_and_strides():
    """bfloat16 at every width (MLA's 192/128 too) takes the bf16 wgmma
    kernels, loading by TMA where q, k, v and dout are 16-byte aligned and
    by the widest plain load otherwise; float32 at every width takes the
    3xTF32 kernels (its pre-pass reads any strides); float16 has no
    route.  Shapes and strides only: nothing is launched."""
    from repro_torch.kernels.flash_attention_bwd import backward_route
    bf = torch.bfloat16

    def tensors(hd, hd_v=None, dtype=bf, h=4, kv=2, s=8, b=2):
        hd_v = hd_v or hd
        return (torch.zeros(b, s, h, hd, dtype=dtype),
                torch.zeros(b, s, kv, hd, dtype=dtype),
                torch.zeros(b, s, kv, hd_v, dtype=dtype),
                torch.zeros(b, s, h, hd_v, dtype=dtype))

    for hd in (16, 32, 64, 96, 128):
        assert backward_route(*tensors(hd)) == ("wgmma", 16)
    assert backward_route(*tensors(24, 16)) == ("wgmma", 16)   # MLA tiny
    assert backward_route(*tensors(20)) == ("wgmma", 8)        # 40-byte rows
    assert backward_route(*tensors(18)) == ("wgmma", 4)
    assert backward_route(*tensors(21)) == ("wgmma", 2)
    # q, k, v as views into 24-wide rows: TMA, unless dout's rows are not
    q, k, v, do = (t[..., :20] for t in tensors(24))
    assert backward_route(q, k, v, do) == ("wgmma", 16)
    assert backward_route(q, k, v, do.contiguous()) == ("wgmma", 8)
    for hd, hd_v in ((192, 128), (160, 64), (144, 96)):
        assert backward_route(*tensors(hd, hd_v)) == ("wgmma", 16)
    assert backward_route(*tensors(129, 128)) == ("wgmma", 2)  # 258-byte rows
    assert backward_route(*(t[..., :-2] for t in tensors(194, 130))) == \
        ("wgmma", 4)                                          # MLA views
    for hd, hd_v in ((16, 16), (20, 20), (96, 96), (128, 128), (192, 128)):
        assert backward_route(*tensors(hd, hd_v, dtype=torch.float32)) == \
            ("3xtf32", 0)
    with pytest.raises(TypeError):
        backward_route(*tensors(64, dtype=torch.float16))


def test_plain_backward_chunks_do_not_change_the_result():
    case = (1, 40, 150, 4, 2, 16, 16, True, 0.0)
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(case, 3))
    out, lse = ref.mha_reference(q, k, v, causal=True, return_lse=True)
    whole = ref.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    for chunk in (16, 64):
        parts = ref.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                  True, chunk=chunk)
        for a, b in zip(parts, whole):
            assert _rel_err(a, b) <= BWD_REL


def test_cpu_training_runs_the_plain_version_under_autograd():
    """On the CPU ``ops.flash_attention`` stays ``ref.mha_reference``
    under autograd: no kernel launches, gradients flow."""
    q, k, v = (_torch(x, "float32").requires_grad_()
               for x in _inputs(CASES[1], seed=5))
    before = ops.kernel_launches()
    ops.flash_attention(q, k, v, causal=True).square().sum().backward()
    assert ops.kernel_launches() == before
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))


def test_the_backward_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    q, k, v = (_torch(x, "float32") for x in _inputs(CASES[1], seed=6))
    out, lse = ref.mha_reference(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_kernel(q, k, v, out, lse, out, causal=True)


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------

# every hd the kernels pad (16, 32, 48, 64, 96, 128), G in {1, 7}, ragged,
# hd 20, whose 40-byte bf16 rows TMA cannot load; Sq != Skv both ways with
# softcap at hd 20, 48 and 96, and Skv = 0
CUDA_CASES = CASES + [
    (1, 200, 200, 7, 1, 128, True, 0.0),
    (2, 130, 65, 14, 2, 96, True, 0.0),
    (1, 257, 257, 28, 4, 128, True, 0.0),
    (1, 65, 130, 7, 7, 16, False, 0.0),
    (1, 33, 33, 4, 4, 8, True, 0.0),
    (2, 200, 200, 7, 1, 20, True, 0.0),
    (1, 150, 90, 8, 2, 20, True, 20.0),
    (1, 70, 150, 4, 4, 96, False, 20.0),
    (2, 90, 170, 6, 3, 48, True, 20.0),
    (1, 100, 0, 4, 2, 64, True, 0.0),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, case, dtype):
    causal, softcap = case[6], case[7]
    q, k, v = (_torch(x, dtype, cuda) for x in _inputs(case, seed=7))
    n0 = flash_attention_kernel.launches
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert got.dtype == q.dtype and got.is_cuda and got.is_contiguous()
    _check(got, ref.mha_reference(q, k, v, causal=causal, softcap=softcap),
           dtype)


def test_cuda_kernel_reads_strided_heads_in_place(cuda):
    """q, k and v as views into one fused (B, S, H + 2 KV, hd) projection:
    the kernel reads them through their strides, with no copy."""
    rng = np.random.default_rng(11)
    b, s, h, kv, hd = 2, 150, 8, 2, 64
    qkv = _torch(rng.standard_normal((b, s, h + 2 * kv, hd)), "bfloat16",
                 cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous()
    got = flash_attention_kernel(q, k, v, causal=True)
    want = ref.mha_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    torch.cuda.synchronize()
    _check(got, want, "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_cuda_bf16_hd20_on_both_load_paths(cuda, causal):
    """hd 20 in bfloat16: contiguous, its 40-byte rows go through the plain
    loads; as views into 24-wide rows (48-byte strides), through TMA with
    zero fill past hd.  Both agree with the plain version."""
    rng = np.random.default_rng(13)
    b, s, h, kv = 2, 200, 7, 1
    padded = [_torch(rng.standard_normal((b, s, n, 24)), "bfloat16", cuda)
              for n in (h, kv, kv)]
    views = [t[..., :20] for t in padded]
    dense = [t.contiguous() for t in views]
    assert load_width(*dense) == 8 and load_width(*views) == 16
    want = ref.mha_reference(*dense, causal=causal)
    for q, k, v in (dense, views):
        got = flash_attention_kernel(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _check(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_CASES)
def test_cuda_mla_widths_match_plain(cuda, case, dtype):
    """hd_v < hd on both kernels, and in bfloat16 on both load routes:
    contiguous (TMA) and as views into rows 2 elements wider, whose
    strides TMA cannot take (plain loads)."""
    causal = case[7]
    q, k, v = (_torch(x, dtype, cuda) for x in _mla_inputs(case, seed=9))
    want = ref.mha_reference(q, k, v, causal=causal)
    routes = [(q, k, v)]
    if dtype == "bfloat16":
        wide = [torch.nn.functional.pad(t, (0, 2)) for t in (q, k, v)]
        views = [t[..., :-2] for t in wide]
        assert load_width(q, k, v) == 16 and load_width(*views) < 16
        routes.append(views)
    for args in routes:
        n0 = flash_attention_kernel.launches
        got = flash_attention_kernel(*args, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == n0 + 1
        assert tuple(got.shape) == tuple(q.shape[:3]) + (case[6],)
        _check(got, want, dtype)


@pytest.mark.parametrize("hd,hd_v", [(20, 20), (192, 128)])
def test_cuda_f32_kernel_reads_strided_heads_in_place(cuda, hd, hd_v):
    """float32 q, k and v as views into one fused (B, S, H + 2 KV, width)
    projection: the pre-pass reads them through their strides (80-byte
    rows at hd 20, GQA 8/2), and the kernel matches its plain version
    within 1e-4 of max |plain|."""
    rng = np.random.default_rng(12)
    b, s, h, kv = 2, 150, 8, 2
    qkv = _torch(rng.standard_normal((b, s, h + 2 * kv, hd)), "float32",
                 cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], \
        qkv[:, :, h + kv:, :hd_v]
    assert not q.is_contiguous()
    got = flash_attention_kernel(q, k, v, causal=True, softcap=20.0)
    want = ref.mha_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, softcap=20.0)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-4


def test_cuda_f32_forward_is_deterministic(cuda):
    """Two float32 forward calls on the same inputs (MLA's 192/128, GQA,
    Sq != Skv, with lse) give the same bits: nothing in the 3xTF32 kernel
    depends on the order blocks run in."""
    case = (1, 150, 200, 8, 2, 192, 128, False)
    q, k, v = (_torch(x, "float32", cuda) for x in _mla_inputs(case, 15))
    first = flash_attention_kernel(q, k, v, causal=False, return_lse=True)
    second = flash_attention_kernel(q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", [(2, 100, 77, 4, 2, 20, 20),
                                  (1, 130, 130, 3, 3, 192, 128),
                                  (1, 64, 300, 8, 1, 96, 64)])
def test_cuda_f32_planes_match_plain(cuda, case):
    """The float32 pre-pass (``f32_planes``) writes exactly the planes of
    its plain version (``ref.flash_f32_planes``): q * scale, k and v^T in
    the kernel's key order, TF32 hi and lo, zero-padded."""
    from repro_torch.kernels.flash_attention import f32_planes
    q, k, v = (_torch(x, "float32", cuda) for x in _mla_inputs(case, 16))
    got = f32_planes(q, k, v)
    extents = (got[0].shape[2], got[1].shape[2], got[0].shape[3],
               got[2].shape[2])
    want = ref.flash_f32_planes(q, k, v, extents)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert a.shape == c.shape and torch.equal(a, c)


@pytest.mark.parametrize("hd,hd_v", [(256, 128), (64, 96), (192, 160)])
def test_cuda_kernel_refuses_widths_it_does_not_take(cuda, hd, hd_v):
    """hd above 192, hd_v above hd or above 128: a ValueError, never the
    plain version in the kernel's place."""
    q = torch.zeros(1, 8, 2, hd, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 8, 2, hd_v, device=cuda, dtype=torch.bfloat16)
    n0 = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention(q, q, v, causal=True)
    assert flash_attention_kernel.launches == n0


# the backward on the card: ragged Sq and Skv, G in {1, 7}, every hd the
# kernel pads, hd 20, MLA's 192/128, softcap, causal, full and cross
BWD_CUDA_CASES = BWD_CASES + [
    (1, 200, 200, 7, 1, 128, 128, True, 0.0),
    (2, 130, 65, 14, 2, 96, 96, True, 0.0),
    (1, 65, 130, 7, 7, 64, 64, False, 20.0),
    (2, 200, 200, 7, 1, 20, 20, True, 0.0),
    (1, 70, 140, 2, 2, 192, 128, False, 0.0),
    (1, 130, 130, 3, 3, 192, 128, True, 0.0),
    (1, 100, 300, 4, 4, 32, 32, False, 0.0),
    # the tensor-core kernels' tile edges (128 keys or queries a block, 64
    # a step): Sq and Skv of 127, 128, 129, 257, unequal both ways, G 7,
    # phi3's hd 96, hd_v < hd on one tile size
    (1, 127, 127, 4, 2, 96, 96, True, 0.0),
    (1, 128, 128, 7, 1, 96, 96, True, 0.0),
    (2, 129, 129, 4, 4, 64, 64, True, 20.0),
    (1, 257, 257, 7, 1, 96, 96, True, 0.0),
    (1, 129, 257, 4, 2, 128, 128, False, 0.0),
    (1, 257, 127, 4, 4, 96, 96, True, 0.0),
    (1, 127, 129, 4, 2, 128, 64, True, 0.0),
    # the 3xTF32 route's tiles (64 keys or queries a block, 32 a step; 16
    # for dk and dq at 192/128) and the bf16 route's 32-query dkdv steps
    # at 192/128: Sq and Skv of 33 to 97, softcap and GQA at 192/128, hd
    # 160 padded to 192, hd_v < hd at hd 72
    (1, 63, 65, 4, 2, 96, 96, True, 0.0),
    (2, 97, 97, 6, 2, 192, 128, True, 20.0),
    (1, 33, 81, 4, 1, 192, 128, False, 0.0),
    (1, 150, 150, 8, 8, 160, 128, True, 0.0),
    (1, 100, 100, 4, 2, 72, 40, True, 0.0),
]
BWD_CUDA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", BWD_CUDA_CASES)
def test_cuda_backward_kernel_matches_plain(cuda, case, dtype):
    """dq, dk and dv of the CUDA backward kernel against its plain version
    on the same inputs (the forward kernel's output and lse), within 1e-4
    (float32) or 2e-2 (bfloat16) of max |plain|, on the dtype's route
    (bfloat16: bf16 wgmma, float32: 3xTF32); the forward's lse within 1e-5
    of the plain forward's."""
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    causal, softcap = case[7], case[8]
    q, k, v, do = (_torch(x, dtype, cuda) for x in _bwd_inputs(case, 8))
    out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                      softcap=softcap, return_lse=True)
    _, lse_p = ref.mha_reference(q, k, v, causal=causal, softcap=softcap,
                                 return_lse=True)
    route = "wgmma" if dtype == "bfloat16" else "3xtf32"
    n0 = flash_attention_bwd_kernel.launches
    r0 = flash_attention_bwd_kernel.launches_by_route[route]
    got = flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=causal,
                                     softcap=softcap)
    want = ref.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             softcap)
    torch.cuda.synchronize()
    assert flash_attention_bwd_kernel.launches == n0 + 1
    assert flash_attention_bwd_kernel.launches_by_route[route] == r0 + 1
    assert float((lse - lse_p).abs().max()) <= 1e-5 * float(
        lse_p.abs().max())
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape and g.is_cuda
        assert _rel_err(g, w) <= BWD_CUDA_TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
def test_cuda_backward_hd20_on_both_load_routes(cuda, causal):
    """hd 20 in bfloat16 on the tensor-core route: contiguous, its 40-byte
    rows load by plain loads; as views into 24-wide rows (48-byte strides,
    dout too), by TMA with zero fill past hd.  Both within 2e-2 of the
    plain version, and both give the same bits."""
    from repro_torch.kernels.flash_attention_bwd import (
        backward_route, flash_attention_bwd_kernel)
    rng = np.random.default_rng(14)
    b, s, h, kv = 2, 200, 7, 1
    padded = [_torch(rng.standard_normal((b, s, n, 24)), "bfloat16", cuda)
              for n in (h, kv, kv, h)]
    views = [t[..., :20] for t in padded]
    dense = [t.contiguous() for t in views]
    q, k, v, do = dense
    out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                      return_lse=True)
    want = ref.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    out_v = torch.nn.functional.pad(out, (0, 4))[..., :20]
    do_v = views[3]
    assert backward_route(*dense) == ("wgmma", 8)
    assert backward_route(*views[:3], do_v) == ("wgmma", 16)
    got = [flash_attention_bwd_kernel(*dense[:3], out, lse, do,
                                      causal=causal),
           flash_attention_bwd_kernel(*views[:3], out_v, lse, do_v,
                                      causal=causal)]
    torch.cuda.synchronize()
    for grads in got:
        for g, w in zip(grads, want):
            assert _rel_err(g, w) <= BWD_CUDA_TOL["bfloat16"]
    for a, c in zip(*got):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case,dtype", [
    ((1, 512, 512, 32, 32, 96, 96, True, 0.0), "bfloat16"),
    ((2, 257, 257, 14, 2, 128, 128, True, 0.0), "bfloat16"),
    ((1, 129, 300, 8, 8, 64, 64, False, 20.0), "bfloat16"),
    ((1, 200, 200, 4, 4, 192, 128, True, 0.0), "bfloat16"),
    ((1, 300, 300, 8, 2, 96, 96, True, 0.0), "float32"),
    ((1, 200, 260, 4, 4, 192, 128, False, 20.0), "float32")])
def test_cuda_backward_is_deterministic(cuda, case, dtype):
    """Both routes sum dq in a pass of its own, in a fixed key order, and
    dk, dv in one block each: two calls on the same inputs give
    bit-identical dq, dk and dv (bfloat16: phi3's heads, GQA, Sq != Skv,
    MLA's 192/128; float32: hd 96 under GQA and 192/128 with softcap)."""
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    causal, softcap = case[7], case[8]
    q, k, v, do = (_torch(x, dtype, cuda) for x in _bwd_inputs(case, 10))
    out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                      softcap=softcap, return_lse=True)
    first = flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=causal,
                                       softcap=softcap)
    second = flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                        causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", [(2, 100, 77, 4, 2, 20, 20),
                                  (1, 130, 130, 3, 3, 192, 128),
                                  (1, 64, 300, 8, 1, 96, 64)])
def test_cuda_bwd_f32_planes_match_plain(cuda, case):
    """The float32 backward's pre-pass (``bwd_f32_planes``) writes exactly
    the planes of its plain version (``ref.flash_bwd_f32_planes``): lse *
    log2(e), q * scale, dout, k, v and the transposes of q * scale, dout
    and k in the kernels' order, TF32 hi and lo, zero-padded; delta, a sum
    in another order, within 1e-6 of max |delta|."""
    from repro_torch.kernels.flash_attention_bwd import bwd_f32_planes
    b, sq, skv, h, kv, hd, hd_v = case
    q, k, v, do = (_torch(x, "float32", cuda)
                   for x in _bwd_inputs(case, 17))
    out, lse = flash_attention_kernel(q, k, v, causal=True, return_lse=True)
    got = bwd_f32_planes(q, k, v, out, lse, do)
    extents = (got[2].shape[2], got[4].shape[2], got[2].shape[3],
               got[3].shape[3])
    want = ref.flash_bwd_f32_planes(q, k, v, out, lse, do, extents)
    torch.cuda.synchronize()
    for i, (a, c) in enumerate(zip(got, want)):
        assert a.shape == c.shape
        if i == 1:
            assert float((a - c).abs().max()) <= 1e-6 * float(c.abs().max())
        else:
            assert torch.equal(a, c), i


@pytest.mark.parametrize("case", [(2, 150, 150, 8, 2, 64, 64, True, 0.0),
                                  (1, 300, 300, 4, 4, 96, 96, True, 0.0)],
                         ids=["hd64-gqa", "hd96"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_trains_through_both_kernels(cuda, dtype, case):
    """Where the path now trains: ``ops.flash_attention`` on inputs that
    require grad runs the forward kernel (with lse) and, in the backward,
    the backward kernel once; the gradients agree with autograd through
    the plain version.  hd 96 is phi3-mini's, the training path's width."""
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    q, k, v, do = (_torch(x, dtype, cuda) for x in _bwd_inputs(case, 9))
    grads = []
    for force in (None, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_bwd_kernel.launches
        out = ops.flash_attention(*leaves, causal=True, force_kernel=force)
        out.backward(do)
        torch.cuda.synchronize()
        launched = (flash_attention_kernel.launches - f0,
                    flash_attention_bwd_kernel.launches - b0)
        assert launched == ((1, 1) if force is None else (0, 0))
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert _rel_err(g, w) <= BWD_CUDA_TOL[dtype]


def test_cuda_kernel_refuses_grad_and_mixed_dtypes(cuda):
    q, k, v = (_torch(x, "float32", cuda) for x in _inputs(CASES[1], seed=4))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q.requires_grad_(), k, v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.detach(), k.to(torch.bfloat16), v)
