"""The port's kernel layer (``repro_torch.kernels``) against the JAX package.

On the CPU the port runs its kernels' plain PyTorch versions; they are held
against ``repro.kernels.ref`` and against the Pallas kernels in interpret
mode (``repro.kernels.ops.*(force_kernel=True)``) on the same numpy inputs,
over the shape sweeps of ``tests/test_coded_matmul.py`` and
``tests/test_kernels.py``, in float32 and bfloat16.  The ``cuda`` cases
hold each hand-written CUDA kernel against its plain version and skip
without a card.  JAX is imported inside the helpers, so the card's cases
also run where JAX is not installed:
``python -m pytest -q tests/test_torch_kernels.py -k cuda``.

The coded_matmul kernel runs its worker products as an error-compensated
3xTF32 product on the tensor cores.  A plain emulation of that split,
``_emulate_3xtf32``, is held against a float64 product and the JAX
package's ``ref.coded_matmul`` on the CPU; it is a test helper, not a
kernel.

Tolerances are relative to the reference output's max |value|:

* float32, 2e-5 — both sides accumulate in float32, in different orders
  (sums over d <= 1000 here: a few ulp of the largest terms);
* bfloat16, 2e-2 — both sides round their output to bfloat16 (2^-8
  relative); a different summation order can move a value across a
  rounding boundary, one bfloat16 ulp.
"""

import ctypes
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.berrut_encode import (berrut_encode_kernel,
                                               kernel_name, load_path)
from repro_torch.kernels.coded_matmul import coded_matmul_kernel
from repro_torch.kernels.mask_add import mask_add_kernel

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]

# tests/test_coded_matmul.py:28-37 — (N, J, blk, d, n_out)
CM_SHAPES = [
    (30, 27, 22, 512, 256),     # fig-3 scale: N=30, J=K+T=24+3
    (10, 4, 64, 64, 32),
    (12, 5, 16, 48, 10),        # K=3, T=2
    (3, 3, 7, 130, 17),         # ragged everything
    (8, 8, 128, 256, 128),      # fully aligned
    (33, 33, 5, 1000, 3),
]
# tests/test_kernels.py:80-83 — (Q, J, M)
BC_SHAPES = [(8, 6, 1000), (20, 8, 4096), (3, 3, 77), (64, 32, 2048),
             (1, 1, 129)]


def _torch(x, dtype: str, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        device=device, dtype=getattr(torch, dtype))


def _jax(x, dtype: str):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _np(x) -> np.ndarray:
    """float32 numpy copy of a torch or JAX array."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x.astype("float32"))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-30))


def _inputs_cm(shape, seed):
    n, j, blk, d, nout = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, j)), rng.standard_normal((j, blk, d)),
            rng.standard_normal((d, nout)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", CM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_coded_matmul_plain_matches_reference(shape, dtype):
    from repro.kernels import ops as jops, ref as jref
    w, a, b = _inputs_cm(shape, seed=sum(shape))
    got = ops.coded_matmul(_torch(w, "float32"), _torch(a, dtype),
                           _torch(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    jw, ja, jb = _jax(w, "float32"), _jax(a, dtype), _jax(b, dtype)
    assert _rel(got, jref.coded_matmul(jw, ja, jb)) <= TOL[dtype]
    assert _rel(got, jops.coded_matmul(jw, ja, jb, force_kernel=True)) \
        <= TOL[dtype]


@pytest.mark.parametrize("shape", BC_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_berrut_combine_plain_matches_reference(shape, dtype):
    from repro.kernels import ops as jops, ref as jref
    q, j, m = shape
    rng = np.random.default_rng(q * 1000 + j)
    w, b = rng.standard_normal((q, j)), rng.standard_normal((j, m))
    got = ops.berrut_combine(_torch(w, "float32"), _torch(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    jw, jb = _jax(w, "float32"), _jax(b, dtype)
    assert _rel(got, jref.berrut_combine(jw, jb)) <= TOL[dtype]
    assert _rel(got, jops.berrut_combine(jw, jb, force_kernel=True)) \
        <= TOL[dtype]


def test_berrut_combine_keeps_the_payload_layout():
    """(J, ...) payloads are flattened and the trailing shape restored."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(1)
    w, b = rng.standard_normal((5, 7)), rng.standard_normal((7, 3, 11, 2))
    got = ops.berrut_combine(_torch(w, "float32"), _torch(b, "float32"))
    assert tuple(got.shape) == (5, 3, 11, 2)
    want = jops.berrut_combine(_jax(w, "float32"), _jax(b, "float32"),
                               force_kernel=False)
    assert _rel(got, want) <= TOL["float32"]


def test_prefix_decode_matches_reference():
    from repro.kernels import ops as jops
    rng = np.random.default_rng(2)
    w, r = rng.standard_normal((6, 4, 9)), rng.standard_normal((9, 5, 8))
    got = ops.prefix_decode(w, _torch(r, "float32"))
    assert tuple(got.shape) == (6, 4, 5, 8)
    want = jops.prefix_decode(_jax(w, "float32"), _jax(r, "float32"),
                              force_kernel=False)
    assert _rel(got, want) <= TOL["float32"]


# --------------------------------------------------------------------------
# CPU: the numerics of the 3xTF32 coded_matmul kernel, emulated
# --------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as the kernel does: to nearest, ties away from
    zero, at 10 mantissa bits, the 13 low bits zeroed (finite values)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (bits & 0x7F800000) != 0x7F800000
    bits = torch.where(finite, (bits + 0x1000) & 0xFFFFE000, bits)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _emulate_3xtf32(w, a, b, k_slice: int = 32) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the encode as the j-ordered
    fmaf chain from zero (float64 holds each w * x exactly), hi/lo TF32
    splits of the shards and of B, per 32-wide k-slice the sum
    lo.hi + hi.lo + hi.hi (products of TF32 values are exact) rounded to
    float32, and the slices added in float32."""
    coded = torch.zeros((w.shape[0],) + tuple(a.shape[1:]))
    for j in range(w.shape[1]):
        coded = (w[:, j, None, None].double() * a[j].double() +
                 coded.double()).float()
    a_hi = _tf32(coded)
    a_lo = _tf32(coded - a_hi)
    b_hi = _tf32(b.float())
    b_lo = _tf32(b.float() - b_hi)
    out = torch.zeros(coded.shape[:2] + (b.shape[1],))
    for k0 in range(0, a.shape[2], k_slice):
        ks = slice(k0, k0 + k_slice)
        part = (a_lo[..., ks].double() @ b_hi[ks].double() +
                a_hi[..., ks].double() @ b_lo[ks].double() +
                a_hi[..., ks].double() @ b_hi[ks].double())
        out = out + part.float()
    return out


def test_tf32_split_keeps_22_bits():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(4096) *
                          10.0 ** rng.integers(-20, 20, 4096))
                         .astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((x - hi).abs() <= x.abs() * 2.0 ** -11)
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(resid <= x.abs().double() * 2.0 ** -22)


@pytest.mark.parametrize("shape", CM_SHAPES)
def test_coded_matmul_3xtf32_numerics(shape):
    """The split product is no worse than 4x the plain float32 version
    against a float64 product, and within float32's tolerance of the JAX
    package's ``ref.coded_matmul``."""
    from repro.kernels import ref as jref
    w, a, b = _inputs_cm(shape, seed=sum(shape))
    w, a, b = (_torch(x, "float32") for x in (w, a, b))
    got = _emulate_3xtf32(w, a, b)
    n, j, blk, d, _ = shape
    exact = (w.double() @ a.double().reshape(j, -1)).reshape(n, blk, d) @ \
        b.double()
    err = float((got.double() - exact).abs().max())
    err_plain = float((ref.coded_matmul(w, a, b).double() - exact)
                      .abs().max())
    assert err <= 4 * err_plain, (err, err_plain)
    want = jref.coded_matmul(_jax(w, "float32"), _jax(a, "float32"),
                             _jax(b, "float32"))
    assert _rel(got, want) <= TOL["float32"]


# --------------------------------------------------------------------------
# dispatch rules
# --------------------------------------------------------------------------

def _small():
    rng = np.random.default_rng(3)
    return (_torch(rng.standard_normal((4, 3)), "float32"),
            _torch(rng.standard_normal((3, 5, 6)), "float32"),
            _torch(rng.standard_normal((6, 7)), "float32"))


@pytest.mark.parametrize("force_kernel", [None, False])
def test_cpu_tensors_run_the_plain_version(force_kernel):
    w, a, b = _small()
    before = ops.kernel_launches()
    got = ops.coded_matmul(w, a, b, force_kernel=force_kernel)
    torch.testing.assert_close(got, ref.coded_matmul(w, a, b), rtol=0, atol=0)
    dw = w.T[:2]                                  # (2, 4) decode weights
    dec = ops.berrut_combine(dw, got, force_kernel=force_kernel)
    torch.testing.assert_close(
        dec, ref.berrut_combine(dw, got.reshape(4, -1)).reshape(2, 5, 7),
        rtol=0, atol=0)
    assert ops.kernel_launches() == before       # nothing was launched


def test_force_kernel_on_cpu_tensors_raises():
    w, a, b = _small()
    with pytest.raises(ValueError, match="CUDA"):
        ops.coded_matmul(w, a, b, force_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.berrut_combine(w, a, force_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.prefix_decode(torch.ones(2, 2, 4), torch.ones(4, 3),
                          force_kernel=True)


def test_kernel_wrappers_refuse_cpu_tensors():
    w, a, b = _small()
    with pytest.raises(ValueError, match="CUDA"):
        coded_matmul_kernel(w, a, b)
    with pytest.raises(ValueError, match="CUDA"):
        berrut_encode_kernel(w, a.reshape(3, -1))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_names_a_library_by_its_source_and_flags():
    target = _build._target("coded_matmul")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libcoded_matmul-")
    assert target != _build._target("berrut_combine")
    assert _build._target("mask_add").name.startswith("libmask_add-")
    assert set(_build._ENTRY) == {"berrut_combine", "coded_matmul",
                                  "mask_add", "flash_attention",
                                  "flash_attention_bwd"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# a stand-in for nvcc: writes the library named after -o and prints a
# ptxas report for one kernel, as ``nvcc -Xptxas -v`` does
_FAKE_NVCC = """#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").close()
print("ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'",
      file=sys.stderr)
print("ptxas info    : Used 40 registers, 0 bytes smem", file=sys.stderr)
"""


class _FakeDLL:
    """ctypes.CDLL's stand-in: every attribute is a settable function."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("fn", (), {})()
        setattr(self, name, fn)
        return fn


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_keeps_each_ptxas_report_beside_its_library(monkeypatch,
                                                          tmp_path):
    """A process that finds every library built (a second run in the same
    checkout) still has every source's ptxas report: nvcc's output is kept
    beside the library and read back."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(ctypes, "CDLL", _FakeDLL)
    monkeypatch.setattr(_build, "build_log", {})
    libs = _build._build_all()                       # compiles every source
    assert set(libs) == {name for name, _ in _build._ENTRY.values()} | \
        set(_build._HELPERS)
    first = dict(_build.build_log)
    assert set(first) == set(_build._ENTRY)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))    # no nvcc now
    monkeypatch.setattr(_build, "build_log", {})
    _build._build_all()                              # loads them as built
    assert _build.build_log == first
    report = _chip_smoke().ptxas_report(_build.build_log["coded_matmul"])
    assert report == {"_Z6kernelv": "Used 40 registers, 0 bytes smem"}


def test_build_reports_nothing_for_a_library_without_its_log(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ctypes, "CDLL", _FakeDLL)
    monkeypatch.setattr(_build, "build_log", {})
    for stem in _build._ENTRY:
        _build._target(stem).touch()
    _build._build_all()
    assert _build.build_log == {stem: "" for stem in _build._ENTRY}
    assert _chip_smoke().ptxas_report(_build.build_log["flash_attention"]) \
        == {}


def test_chip_smoke_bound_names_the_rate_that_binds():
    smoke = _chip_smoke()
    # 1 GB and 1 GFLOP: bytes bind on the CUDA cores' float32 rate ...
    got = smoke.bound(1e9, 1e9, smoke.F32_CUDA)
    assert got == {"bound_ms": 1e9 / 3.35e12 * 1e3, "bound_by": "bytes",
                   "bound_rate": smoke.HBM[0]}
    # ... and operations bind at 1 TFLOP on the 3xTF32 split's rate
    got = smoke.bound(1e9, 1e12, smoke.SPLIT_3XTF32)
    assert got["bound_by"] == "operations"
    assert got["bound_rate"] == smoke.SPLIT_3XTF32[0]
    assert got["bound_ms"] == pytest.approx(1e12 / (495e12 / 3) * 1e3)


@pytest.mark.parametrize("dtype,offset,m,want", [
    ("float32", 0, 1024, "tma"), ("float32", 4, 1024, "tma"),
    ("float32", 2, 1024, "bulk"), ("float32", 1, 1024, "bulk"),
    ("float32", 0, 1026, "bulk"), ("float32", 0, 1025, "bulk"),
    ("float32", 0, 1000003, "bulk"),
    ("bfloat16", 0, 1024, "tma"), ("bfloat16", 8, 1024, "tma"),
    ("bfloat16", 4, 1024, "bulk"), ("bfloat16", 1, 1024, "bulk"),
    ("bfloat16", 0, 1028, "bulk"), ("bfloat16", 0, 1027, "bulk"),
    ("bfloat16", 0, 1000003, "bulk")])
def test_berrut_load_path_follows_pointer_and_row_alignment(dtype, offset, m,
                                                             want):
    """The kernel's load path comes from the payload's address and row
    stride alone: TMA when both are 16-byte aligned, else bulk copies."""
    buf = torch.empty(64 + offset + 2 * m, dtype=getattr(torch, dtype))
    skip = (-buf.data_ptr() % 64) // buf.element_size()   # a 64-byte start
    b = buf[skip + offset:skip + offset + 2 * m].view(2, m)
    assert load_path(b) == want


def test_berrut_load_path_keeps_tma_coordinates_in_int32():
    class Wide:          # a (1, 2^31) float32 payload, never allocated
        shape = (1, 1 << 31)

        def data_ptr(self):
            return 1 << 20

        def element_size(self):
            return 4
    assert load_path(Wide()) == "bulk"


@pytest.mark.parametrize("q,dtype,m,want", [
    (1, "float32", 1024, "<float, (int)4, (bool)0>"),
    (8, "float32", 1024, "<float, (int)4, (bool)0>"),
    (9, "float32", 1024, "<float, (int)8, (bool)0>"),
    (24, "float32", 1001, "<float, (int)12, (bool)1>"),
    (30, "bfloat16", 1024, "<__nv_bfloat16, (int)16, (bool)0>"),
    (30, "bfloat16", 1020, "<__nv_bfloat16, (int)16, (bool)1>"),
    (720, "float32", 1024, "<float, (int)16, (bool)0>")])
def test_berrut_kernel_name_follows_the_row_tiles(q, dtype, m, want):
    blocks = torch.empty((2, m), dtype=getattr(torch, dtype))
    assert blocks.data_ptr() % 16 == 0
    assert kernel_name(q, blocks) == "berrut_stream_kernel" + want


def test_plain_paths_build_nothing():
    w, a, b = _small()
    before = _build.build_count
    ops.berrut_combine(w.T[:2], ops.coded_matmul(w, a, b))
    assert _build.build_count == before
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", CM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_coded_matmul_kernel_matches_plain(cuda, shape, dtype):
    w, a, b = _inputs_cm(shape, seed=sum(shape))
    w, a, b = (_torch(w, "float32", cuda), _torch(a, dtype, cuda),
               _torch(b, dtype, cuda))
    before = coded_matmul_kernel.launches
    got = ops.coded_matmul(w, a, b)                  # None -> the kernel
    torch.cuda.synchronize()
    assert coded_matmul_kernel.launches == before + 1
    assert got.dtype == a.dtype and got.is_cuda
    assert _rel(got, ops.coded_matmul(w, a, b, force_kernel=False)) \
        <= TOL[dtype]


# chip_smoke.py's ragged coded_matmul cases: d below one 32-wide k-slice,
# n_out below one 128-wide tile, rows of N * blk off the 128-row tile
CM_CUDA_SHAPES = [(30, 27, 22, 10, 256), (30, 27, 64, 256, 512),
                  (3, 3, 7, 130, 17), (33, 33, 5, 1000, 3)]


@pytest.mark.parametrize("shape", CM_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_coded_matmul_ragged_shapes(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    n, j, blk, d, n_out = shape
    w = torch.randn((n, j), generator=g, device=cuda)
    a = torch.randn((j, blk, d), generator=g, device=cuda).to(
        getattr(torch, dtype))
    b = torch.randn((d, n_out), generator=g, device=cuda).to(
        getattr(torch, dtype))
    got = coded_matmul_kernel(w, a, b)
    torch.cuda.synchronize()
    assert got.shape == (n, blk, n_out) and got.dtype == a.dtype
    assert _rel(got, ref.coded_matmul(w, a, b)) <= TOL[dtype]


def test_cuda_coded_matmul_float64_slice(cuda):
    """Against a float64 product over d = 3584: the 3xTF32 kernel's error
    is no worse than 4x the plain float32 version's (worker 0, 64 rows)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n, j, blk, d, n_out = 30, 27, 64, 3584, 512
    w = torch.randn((n, j), generator=g, device=cuda)
    a = torch.randn((j, blk, d), generator=g, device=cuda)
    b = torch.randn((d, n_out), generator=g, device=cuda)
    got = coded_matmul_kernel(w, a, b)
    plain = ref.coded_matmul(w, a, b)
    exact = (w[:1].double() @ a.reshape(j, -1).double()).reshape(blk, d) \
        @ b.double()
    err = float((got[0].double() - exact).abs().max())
    err_plain = float((plain[0].double() - exact).abs().max())
    assert err <= 4 * err_plain, (err, err_plain)


@pytest.mark.parametrize("shape", BC_SHAPES + [
    (24, 30, 5632), (8, 200, 1003), (40, 30, 777),
    # M = 1, 2, 3 mod 4 (1003 is 3 mod 8: bf16 rows at 2-byte alignment),
    # an aligned M below one 256-column box, Q = 720 (the prefix decode's
    # 30 x 24 rows), Q > 32 with J > 32 (a slab walk per row chunk), and
    # two W too large to stay in shared memory (restaged chunk by chunk)
    (24, 30, 1001), (24, 30, 1002), (30, 27, 1003), (8, 6, 200),
    (720, 30, 2048), (40, 70, 1030), (2000, 30, 1000), (200, 300, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_berrut_kernel_matches_plain(cuda, shape, dtype):
    q, j, m = shape
    rng = np.random.default_rng(q * 1000 + j)
    w = _torch(rng.standard_normal((q, j)), "float32", cuda)
    b = _torch(rng.standard_normal((j, m)), dtype, cuda)
    before = berrut_encode_kernel.launches
    got = ops.berrut_combine(w, b)
    torch.cuda.synchronize()
    assert berrut_encode_kernel.launches == before + 1
    assert got.dtype == b.dtype and got.is_cuda
    assert _rel(got, ops.berrut_combine(w, b, force_kernel=False)) \
        <= TOL[dtype]


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_berrut_kernel_offset_views(cuda, offset, dtype):
    """A payload that is a contiguous view some elements into its buffer
    (an address TMA refuses unless 16-byte aligned) goes through the bulk
    copies, read at each row's byte shift, and still matches the plain
    version."""
    q, j, m = 24, 30, 4096
    rng = np.random.default_rng(offset)
    w = _torch(rng.standard_normal((q, j)), "float32", cuda)
    buf = _torch(rng.standard_normal(offset + j * m), dtype, cuda)
    b = buf[offset:].view(j, m)
    assert load_path(b) == ("tma" if (offset * b.element_size()) % 16 == 0
                            else "bulk")
    got = ops.berrut_combine(w, b)
    assert _rel(got, ops.berrut_combine(w, b, force_kernel=False)) \
        <= TOL[dtype]


def test_cuda_berrut_load_path_matches_the_kernel(cuda):
    """``load_path`` says what the C launch chooses, for every pointer and
    row alignment."""
    c_path = _build.function("berrut_combine_load_path")
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        buf = torch.empty(4 * 1032 + 16, dtype=dtype, device=cuda)
        for offset in range(8):
            for m in range(1024, 1032):
                b = buf[offset:offset + 4 * m].view(4, m)
                path = ("tma", "bulk")[c_path(b.data_ptr(), m, code)]
                assert load_path(b) == path, (offset, m)


# (N, J, blk, d, n_out, A's dtype, A's offset in its buffer): the
# encrypted round's fig-3 encode shape, J > 64, Q > 32, an odd M, a
# bfloat16 A and a view 4 bytes in
CONTRACT_CASES = [(30, 27, 22, 10, 256, "float32", 0),
                  (8, 200, 5, 33, 7, "float32", 0),
                  (40, 30, 9, 40, 33, "float32", 0),
                  (30, 27, 7, 13, 17, "float32", 0),
                  (30, 27, 22, 10, 256, "bfloat16", 0),
                  (30, 27, 22, 12, 256, "float32", 1)]


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_cuda_berrut_encode_then_identity_is_coded_matmul(cuda, case):
    """The encrypted round's contract: encoding through berrut_combine (in
    float32, as ``encrypted_round`` widens A) and then running
    ``coded_matmul`` with identity weights is bit-identical to
    ``coded_matmul``'s own encode, because both are the j-ordered fmaf
    chain from zero.  A bfloat16 payload's kernel output is that chain
    rounded once."""
    n, j, blk, d, n_out, dtype, offset = case
    rng = np.random.default_rng(n * 1000 + j)
    w = _torch(rng.standard_normal((n, j)), "float32", cuda)
    buf = _torch(rng.standard_normal(offset + j * blk * d), dtype, cuda)
    a = buf[offset:].view(j, blk, d)
    b = _torch(rng.standard_normal((d, n_out)), "float32", cuda)
    before = berrut_encode_kernel.launches
    coded = ops.berrut_combine(w, a.float())
    assert berrut_encode_kernel.launches == before + 1
    eye = torch.eye(n, device=cuda)
    got = ops.coded_matmul(eye, coded, b)
    want = ops.coded_matmul(w, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.to(want.dtype), want)
    if dtype == "bfloat16":
        assert torch.equal(ops.berrut_combine(w, a),
                           coded.to(torch.bfloat16))


# the loop round's berrut_combine calls at the Fig-3 backward job A(512,10)
# @ B(10,256), N = 30, S = 5, in the order each scheme makes them
LOOP_SCHEMES = {"mds": (24, ("encode", "decode")),
                "matdot": (12, ("encode_a", "encode_b", "decode")),
                "polynomial": (24, ("encode_a", "encode_b", "decode"))}


@pytest.mark.parametrize("scheme", sorted(LOOP_SCHEMES))
def test_cuda_berrut_kernel_at_the_loop_round_shapes(cuda, scheme):
    """berrut_combine against its plain version at the shapes the loop
    round hands it, recorded from the scheme as the engine drives it: the
    mds K=24 decode (Q = J = 24, weights from a float64 ``inv``), matdot
    p=12's encode of 1-column ``swapaxes`` blocks and its Q = J = 23
    decode, the polynomial encode of B's padded transpose.  Encodes within
    the float32 tolerance; the ill-conditioned decodes elementwise within
    float32's error bound of the plain version (``chip_smoke.combine_bound_
    ratio`` at most 1), and both against the float64 product by
    ``chip_smoke.f64_rule``."""
    from repro_torch.api import ClusterSpec, Session
    k, names = LOOP_SCHEMES[scheme]
    spec = ClusterSpec.from_legacy_kwargs(scheme, 30, k, n_stragglers=5)
    rng = np.random.default_rng(5)
    a = _torch(rng.standard_normal((512, 10)), "float32", cuda)
    b = _torch(rng.standard_normal((10, 256)), "float32", cuda)
    calls = []
    with Session(spec, device=cuda) as s:
        assert not s.engine.use_fused
        orig = s.engine.scheme._combine

        def record(w, blocks):
            calls.append((w, blocks))
            return orig(w, blocks)
        s.engine.scheme._combine = record
        s.matmul(a, b, round_idx=1)
    assert len(calls) == len(names)
    if scheme == "matdot":
        assert tuple(calls[0][1].shape) == (12, 512, 1)   # 1-column blocks
        assert tuple(calls[2][1].shape) == (23, 512, 256)
    if scheme == "polynomial":
        assert tuple(calls[1][1].shape) == (1, 256, 10)
        assert not calls[1][1].is_contiguous()       # B's transpose
    for name, (w, blocks) in zip(names, calls):
        before = berrut_encode_kernel.launches
        got = ops.berrut_combine(w, blocks)
        torch.cuda.synchronize()
        assert berrut_encode_kernel.launches == before + 1, name
        want = ops.berrut_combine(w, blocks, force_kernel=False)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        if name != "decode":
            assert _rel(got, want) <= TOL["float32"], name
            continue
        assert np.asarray(w).dtype == np.float64
        smoke = _chip_smoke()
        assert smoke.combine_bound_ratio(torch, w, blocks, got, want) <= 1.0
        j = blocks.shape[0]
        w32 = torch.as_tensor(w).to(device=cuda, dtype=torch.float32)
        exact = (w32.double() @ blocks.reshape(j, -1).double()).reshape(
            got.shape)
        rule = smoke.f64_rule(torch, got, want, exact)
        assert rule["holds"], (name, rule)


def test_cuda_coded_matmul_scratch_extents(cuda):
    """The kernel's split planes: N * blk, d and n_out rounded up to its
    GEMM's 128 x 128 tiles and 32-wide k-slices; refused past its grids."""
    scratch = _build.function("coded_matmul_scratch")

    def extents(*shape):
        pad = (ctypes.c_int64 * 3)()
        return scratch(*shape, pad), tuple(pad)

    assert extents(30, 512, 3584, 18944) == (0, (15360, 3584, 18944))
    assert extents(3, 7, 130, 17) == (0, (128, 160, 128))
    assert extents(33, 5, 1000, 3) == (0, (256, 1024, 128))
    assert extents(1, 1, 32 * 65536, 1)[0] != 0
    assert extents(1, 1, 0, 1)[0] != 0


def test_cuda_kernels_build_once(cuda):
    w, a, b = (t.to(cuda) for t in _small())
    for _ in range(3):
        ops.berrut_combine(w.T[:2], ops.coded_matmul(w, a, b))
    torch.cuda.synchronize()
    assert _build.build_count == 1


def _secp256k1():
    from repro_torch.crypto import CURVE_SECP256K1, field
    q = CURVE_SECP256K1.q
    return q, tuple(int(v) for v in field.int_to_limbs(q, 8))


def _limbs(shape, seed, device):
    """Random 32-bit limbs; 8 random limbs are a secp256k1 field element but
    with probability ~2^-224."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         generator=g).to(device).view(torch.uint32)


@pytest.mark.parametrize("m", [1, 100, 513, 4096])
@pytest.mark.parametrize("subtract", [False, True])
def test_cuda_mask_add_kernel_matches_plain(cuda, m, subtract):
    q, _ = _secp256k1()
    a, b = _limbs((m, 8), m, cuda), _limbs((m, 8), m + 1, cuda)
    before = mask_add_kernel.launches
    got = ops.mask_add(a, b, q, subtract=subtract)   # None -> the kernel
    torch.cuda.synchronize()
    assert mask_add_kernel.launches == before + 1
    assert got.dtype == torch.uint32 and got.is_cuda
    want = ops.mask_add(a, b, q, subtract=subtract, force_kernel=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_mask_add_edges_and_shared_mask_rows(cuda):
    from repro_torch.crypto import field
    q, ql = _secp256k1()
    vals = [0, 1, 2, q - 1, q - 2, (1 << 255) % q, 0xFFFFFFFF]
    a = field.as_u32_tensor([field.int_to_limbs(v, 8) for v in vals], cuda)
    for other in (0, 1, q - 1):
        b = field.as_u32_tensor(field.int_to_limbs(other, 8), cuda)
        for subtract in (False, True):
            got = ops.mask_add(a, b, q, subtract=subtract).cpu().numpy()
            for g, x in zip(field.limbs_to_int(got), vals):
                assert int(g) == ((x - other) if subtract else
                                  (x + other)) % q
    a = _limbs((3, 50, 8), 7, cuda)
    for mask in (_limbs((3, 1, 8), 8, cuda), _limbs((8,), 9, cuda),
                 _limbs((1, 50, 8), 10, cuda)):
        got = ops.mask_add(a, mask, q)
        assert torch.equal(got.view(torch.int32),
                           ref.mask_add(a, mask, ql).view(torch.int32))


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_cuda_encrypted_round_matches_plain(cuda, mode):
    q, _ = _secp256k1()
    w, a, b = _inputs_cm((6, 5, 9, 40, 33), seed=11)
    w, a, b = (_torch(w, "float32", cuda), _torch(a, "float32", cuda),
               _torch(b, "float32", cuda))
    material = _limbs((2, 6, 8), 12, cuda)
    if mode == "paper":
        material.view(torch.int32)[..., 7] &= 0x7FFFFFFF       # Ψ < q
    counters = (berrut_encode_kernel, mask_add_kernel, coded_matmul_kernel)
    before = [k.launches for k in counters]
    got, ct_out, ct_back = ops.encrypted_coded_matmul(
        w, a, b, material[0], material[1], q=q, mode=mode, return_wire=True)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counters, before)] == [1, 4, 1]
    assert tuple(ct_out.shape) == (6, 9 * 40, 8)
    assert tuple(ct_back.shape) == (6, 9 * 33, 8)
    want = ops.coded_matmul(w, a, b)
    assert _rel(got, want) <= TOL["float32"]
    # the same encode chain, a lossless wire and identity weights: the
    # kernel round and the encrypted kernel round agree bit for bit
    assert torch.equal(got, want)
    plain = ops.encrypted_coded_matmul(w, a, b, material[0], material[1], q=q,
                                       mode=mode, force_kernel=False)
    assert torch.equal(plain, ref.coded_matmul(w, a, b))
