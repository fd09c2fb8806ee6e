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

Tolerances:

* float32, 3e-5 absolute: the reference's own bar for its kernel against
  its oracle (outputs are convex combinations of unit normals);
* bfloat16, 2e-2 of max |reference|: both sides round q, k, v and the
  output to bfloat16 (2^-8 relative), and the Pallas wrapper also rounds
  ``q * scale`` to bfloat16 where the port scales in float32.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_kernel

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
    name, argtypes = _build._ENTRY["flash_attention"]
    assert name == "flash_attention_launch" and len(argtypes) == 16
    assert _build._target("flash_attention").name.startswith(
        "libflash_attention-")


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------

# every hd the kernel pads (16, 32, 48, 64, 96, 128), G in {1, 7}, ragged
CUDA_CASES = CASES + [
    (1, 200, 200, 7, 1, 128, True, 0.0),
    (2, 130, 65, 14, 2, 96, True, 0.0),
    (1, 257, 257, 28, 4, 128, True, 0.0),
    (1, 65, 130, 7, 7, 16, False, 0.0),
    (1, 33, 33, 4, 4, 8, True, 0.0),
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


def test_cuda_kernel_refuses_grad_and_mixed_dtypes(cuda):
    q, k, v = (_torch(x, "float32", cuda) for x in _inputs(CASES[1], seed=4))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q.requires_grad_(), k, v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.detach(), k.to(torch.bfloat16), v)
