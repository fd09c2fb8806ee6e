"""The encrypted round of the port against the JAX package on the CPU.

* ``mask_add``: the plain version equals the Pallas kernel in interpret mode
  and ``repro.kernels.ref.mask_add`` over ``tests/test_kernels.py``'s sweep,
  exactly.
* The wires (``kernels.encrypted_round``): ciphertext limbs exactly equal
  to the reference's for the same words and material; the fast wires equal
  the general wire (adversarial Ψ included); every round trip is the bit
  identity.
* ``encrypted_coded_matmul``: within 2e-5 of the reference's (float32
  products through different libraries) and bit-identical to the port's
  own ``ref.coded_matmul``.
* ``Session`` with ``encrypt="real"`` (stream and paper, fused and staged)
  and ``"modeled"``: within 1e-4 of the JAX ``Session`` (the reference's
  noise handed in), masks and arrivals exact, ``crypto_s > 0``, and
  bit-identical to the port's own plain round.

The card's cases are in ``tests/test_torch_kernels.py`` (``-k cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.crypto import CURVE_SECP256K1
from repro_torch.crypto import field as F
from repro_torch.kernels import encrypted_round as ER, ops, ref
from repro_torch.kernels.mask_add import mask_add_kernel

Q = CURVE_SECP256K1.q
L = 8
QL = tuple(int(v) for v in F.int_to_limbs(Q, L))
OUT_TOL = 1e-4
ROUND_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread here keeps these CPU-heavy cases from starving the
    timing-sensitive tests that other workers run at the same time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_limbs(n, seed):
    r = np.random.default_rng(seed)
    return np.stack([F.int_to_limbs(int.from_bytes(r.bytes(32), "big") % Q,
                                    L) for _ in range(n)])


def _u32(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(t, np.uint32)


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


def _materials(n, mode, seed, psi_ints=None):
    r = np.random.default_rng(seed)
    if mode == "stream":
        return r.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    psi_ints = psi_ints or [int.from_bytes(r.bytes(32), "big") % (Q - 1) + 1
                            for _ in range(n)]
    return np.stack([F.int_to_limbs(p, L) for p in psi_ints])


# --------------------------------------------------------------------------
# mask_add
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 513, 4096])
@pytest.mark.parametrize("subtract", [False, True])
def test_mask_add_plain_matches_pallas_interpret_and_reference(n, subtract):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.mask_add import mask_add_kernel as pallas
    a, b = _rand_limbs(n, n), _rand_limbs(n, n + 1)
    got = ops.mask_add(a, b, Q, subtract=subtract)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (n, L)
    want = pallas(jnp.asarray(a), jnp.asarray(b), q_limbs=QL,
                  subtract=subtract, interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    np.testing.assert_array_equal(
        _u32(got), np.asarray(jref.mask_add(a, b, np.asarray(QL, np.uint32),
                                            subtract=subtract)))
    np.testing.assert_array_equal(
        _u32(ref.mask_add(a, b, QL, subtract=subtract)), _u32(got))


def test_mask_add_edge_values():
    """Carry/borrow chains at the field's edges, against the big-int truth
    and the reference dispatcher."""
    from repro.kernels import ops as jops
    vals = [0, 1, 2, Q - 1, Q - 2, (1 << 255) % Q, 0xFFFFFFFF,
            0xFFFFFFFF00000000 % Q]
    a = np.stack([F.int_to_limbs(v, L) for v in vals])
    for other in (0, 1, Q - 1, 0xFFFFFFFF):
        b = np.broadcast_to(F.int_to_limbs(other, L), a.shape)
        for subtract in (False, True):
            got = ops.mask_add(a, b, Q, subtract=subtract)
            np.testing.assert_array_equal(_u32(got), np.asarray(
                jops.mask_add(a, b, Q, subtract=subtract,
                              force_kernel=False)))
            for g, x in zip(F.limbs_to_int(_u32(got)), vals):
                assert int(g) == ((x - other) if subtract else
                                  (x + other)) % Q


def test_mask_add_broadcast_masks():
    """Paper mode masks every element of a channel with one scalar."""
    from repro.kernels import ops as jops
    a = _rand_limbs(37, 3)
    psi = F.int_to_limbs(0x123456789ABCDEF0FEDCBA9876543210, L)
    got = ops.mask_add(a, psi, Q)
    np.testing.assert_array_equal(_u32(got), np.asarray(
        jops.mask_add(a, psi, Q, force_kernel=False)))
    per_channel = _rand_limbs(3, 4)[:, None, :]
    a3 = _rand_limbs(3 * 11, 5).reshape(3, 11, L)
    np.testing.assert_array_equal(
        _u32(ops.mask_add(a3, per_channel, Q, subtract=True)),
        F.sub_mod(a3, np.broadcast_to(per_channel, a3.shape), QL))


def test_mask_rows_keeps_shared_mask_rows_unexpanded():
    """The kernel takes one mask row per channel (or one in all) without
    expanding it; other broadcasts are expanded to a full mask."""
    per_channel = torch.arange(3 * L, dtype=torch.int32).reshape(3, 1, L)
    rows = ops._mask_rows(per_channel, (3, 11, L))
    assert tuple(rows.shape) == (3, L)
    assert tuple(ops._mask_rows(per_channel[0, 0], (3, 11, L)).shape) == (1, L)
    full = ops._mask_rows(torch.zeros((3, 11, L), dtype=torch.int32),
                          (3, 11, L))
    assert tuple(full.shape) == (33, L)
    per_row = torch.arange(11 * L, dtype=torch.int32).reshape(1, 11, L)
    expanded = ops._mask_rows(per_row, (3, 11, L))
    assert tuple(expanded.shape) == (33, L)
    assert torch.equal(expanded[11:22], per_row[0])


def test_mask_add_dispatch_on_the_cpu():
    a, b = _rand_limbs(5, 6), _rand_limbs(5, 7)
    before = ops.kernel_launches()
    ops.mask_add(a, b, Q)
    ops.mask_add(a, b, Q, force_kernel=False)
    assert ops.kernel_launches() == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.mask_add(a, b, Q, force_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        mask_add_kernel(F.as_u32_tensor(a), F.as_u32_tensor(b), QL)
    with pytest.raises(ValueError, match="CUDA"):
        ops.encrypted_coded_matmul(torch.eye(2), torch.ones(2, 3, 4),
                                   torch.ones(4, 5), _materials(2, "stream", 0),
                                   _materials(2, "stream", 1), q=Q,
                                   mode="stream", force_kernel=True)


# --------------------------------------------------------------------------
# the cipher cores
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stream", "paper"])
@pytest.mark.parametrize("codec", ["bits", "fixed"])
def test_cipher_cores_match_reference(mode, codec):
    from repro.kernels import ops as jops
    r = np.random.default_rng(8)
    x = r.standard_normal(301).astype(np.float32)
    data = x.view(np.uint32) if codec == "bits" else x
    material = _materials(1, mode, 9)[0]
    kw = dict(q=Q, frac_bits=16, mode=mode, codec=codec)
    got = ops.mea_encrypt_core(torch.from_numpy(data.copy()), material,
                               n_limbs=L, **kw)
    want = jops.mea_encrypt_core(data, material, use_kernel=False,
                                 interpret=True, n_limbs=L, **kw)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    back = ops.mea_decrypt_core(got, material, **kw)
    rback = jops.mea_decrypt_core(np.asarray(want), material,
                                  use_kernel=False, interpret=True, **kw)
    if codec == "bits":
        np.testing.assert_array_equal(_u32(back), np.asarray(rback))
        np.testing.assert_array_equal(_u32(back), data)
    else:
        np.testing.assert_array_equal(back.numpy(), np.asarray(rback))


# --------------------------------------------------------------------------
# the wires
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_wire_ciphertext_matches_reference(mode):
    from repro.kernels.encrypted_round import wire_roundtrip as jwire
    x = np.random.default_rng(10).standard_normal((4, 300)).astype(np.float32)
    material = _materials(4, mode, 11)
    out, ct = ER.wire_roundtrip(torch.from_numpy(x), material, q=Q,
                                mode=mode, return_ct=True)
    jout, jct = jwire(x, material, q=Q, mode=mode, use_kernel=False,
                      return_ct=True)
    assert tuple(ct.shape) == (4, 300, L)
    np.testing.assert_array_equal(_u32(ct), np.asarray(jct))
    np.testing.assert_array_equal(_bits(out), _bits(x))
    np.testing.assert_array_equal(_bits(out), _bits(np.asarray(jout)))


@pytest.mark.parametrize("psi_int", [
    1, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, Q // 2, Q - 1,
    Q - 2 ** 32 + 1, Q - 2 ** 32, Q - 2 ** 32 - 1])   # reduction corner
def test_paper_fast_wire_equals_general_wire(psi_int):
    psi = _materials(1, "paper", 0, [psi_int])
    x = np.random.default_rng(12).standard_normal((1, 256)).astype(np.float32)
    wds = x.view(np.uint32).copy()
    thr = (Q - psi_int) % 2 ** 32       # the single-limb overflow threshold
    wds[0, :4] = [thr, (thr - 1) % 2 ** 32, (thr + 1) % 2 ** 32, 2 ** 32 - 1]
    x = torch.from_numpy(wds.view(np.float32))
    out_f, ct_f = ER.wire_roundtrip(x, psi, q=Q, mode="paper", return_ct=True)
    out_g, ct_g = ER._wire_general(x.view(torch.int32), F.as_u32_tensor(psi),
                                   Q, "paper", L, False, True)
    np.testing.assert_array_equal(_u32(ct_f), _u32(ct_g))
    np.testing.assert_array_equal(_bits(out_f), wds)
    np.testing.assert_array_equal(_u32(out_g), wds)


def test_stream_fast_wire_equals_general_wire():
    seeds = _materials(4, "stream", 13)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (4, 512)).astype(np.float32))
    out_f, ct_f = ER.wire_roundtrip(x, seeds, q=Q, mode="stream",
                                    return_ct=True)
    out_g, ct_g = ER._wire_general(x.view(torch.int32),
                                   F.as_u32_tensor(seeds), Q, "stream", L,
                                   False, True)
    np.testing.assert_array_equal(_u32(ct_f), _u32(ct_g))
    np.testing.assert_array_equal(_bits(out_f), _u32(out_g))


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_roundtrip_is_bit_identity(mode):
    x = torch.from_numpy((np.random.default_rng(15).standard_normal(
        (3, 100)) * 1e20).astype(np.float32))
    out = ER.wire_roundtrip(x, _materials(3, mode, 16), q=Q, mode=mode)
    assert torch.equal(out.view(torch.int32), x.view(torch.int32))


def test_stream_wire_needs_a_wide_modulus():
    with pytest.raises(ValueError, match="64-bit"):
        ER.wire_roundtrip(torch.zeros(2, 8), np.zeros((2, 8), np.uint32),
                          q=(1 << 61) - 1, mode="stream")


@pytest.mark.parametrize("mode", ["stream", "paper"])
@pytest.mark.parametrize("w", [1, 5, 1000, 1025])
def test_standalone_wire_identity(mode, w):
    words = np.random.default_rng(w).integers(0, 2 ** 32, (3, w),
                                              dtype=np.uint32)
    out = ops.fused_wire(words, _materials(3, mode, 17), q=Q, mode=mode)
    assert tuple(out.shape) == (3, w)
    np.testing.assert_array_equal(_u32(out), words)


# --------------------------------------------------------------------------
# the encrypted round body
# --------------------------------------------------------------------------

def _operands(n, j, blk, d, n_out, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, j)).astype(np.float32),
            r.standard_normal((j, blk, d)).astype(np.float32),
            r.standard_normal((d, n_out)).astype(np.float32))


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_encrypted_coded_matmul_matches_reference_and_plain(mode):
    from repro.kernels import ops as jops
    w, blocks, rhs = _operands(10, 8, 6, 12, 24, 18)
    mo, mb = _materials(10, mode, 19), _materials(10, mode, 20)
    tw, tb, tr = (torch.from_numpy(v) for v in (w, blocks, rhs))
    got = ops.encrypted_coded_matmul(tw, tb, tr, mo, mb, q=Q, mode=mode)
    want = np.asarray(jops.encrypted_coded_matmul(
        w, blocks, rhs, mo, mb, q=Q, mode=mode, force_kernel=False))
    assert float(np.max(np.abs(got.numpy() - want)) /
                 np.max(np.abs(want))) <= ROUND_TOL
    plain = ref.coded_matmul(tw, tb, tr)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    oracle = ref.encrypted_coded_matmul(tw, tb, tr, mo, mb, q=Q, mode=mode)
    assert torch.equal(oracle.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_round_ciphertexts_equal_the_staged_core(mode):
    """The fused round's ciphertexts are the bits ``mea_encrypt_core``
    produces channel by channel: the fusion moves the wire, it does not
    change it."""
    w, blocks, rhs = (torch.from_numpy(v) for v in _operands(5, 4, 3, 8, 6,
                                                             21))
    mo, mb = _materials(5, mode, 22), _materials(5, mode, 23)
    _, ct_out, ct_back = ops.encrypted_coded_matmul(
        w, blocks, rhs, mo, mb, q=Q, mode=mode, return_wire=True)
    coded = torch.matmul(w, blocks.reshape(4, -1)).reshape(5, 3, 8)
    words = coded.reshape(5, -1).view(torch.int32)
    for i in range(5):
        want = ops.mea_encrypt_core(words[i], mo[i], q=Q, frac_bits=16,
                                    mode=mode, codec="bits", n_limbs=L)
        np.testing.assert_array_equal(_u32(ct_out[i]), _u32(want))
    assert tuple(ct_back.shape) == (5, 3 * 6, L)


# --------------------------------------------------------------------------
# Session rounds against the JAX Session
# --------------------------------------------------------------------------

CRYPTO = [("real_stream", dict(encrypt="real"), 2),
          ("real_paper", dict(encrypt="real", cipher_mode="paper"), 1),
          ("real_stream_staged", dict(encrypt="real", fused=False), 1),
          ("real_paper_staged", dict(encrypt="real", cipher_mode="paper",
                                     fused=False), 1),
          ("modeled", dict(encrypt="modeled"), 1)]


@pytest.mark.parametrize("name,crypto,rounds", CRYPTO,
                         ids=[c[0] for c in CRYPTO])
def test_encrypted_session_matches_reference(name, crypto, rounds):
    import repro.api as ref_api
    from repro_torch.api import ClusterSpec, Session
    m, d, n_out = 512, 10, 256                   # the fig-3 backprop job
    ref_spec = dataclasses.replace(ref_api.ClusterSpec.paper_fig3(),
                                   crypto=ref_api.CryptoSpec(**crypto))
    spec = ClusterSpec.from_dict(ref_spec.to_dict())
    rng = np.random.default_rng(24)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((d, n_out)).astype(np.float32)
    with ref_api.Session(ref_spec) as rs, \
            Session(spec, device="cpu") as ps, \
            Session(ClusterSpec.paper_fig3(), device="cpu") as pp:
        noise = np.asarray(rs.engine.scheme.make_noise((-(-m // 24), d)))
        for _ in range(rounds):
            want, wst = rs.matmul(a, b)
            got, gst = ps.matmul(a, b, noise=noise)
            plain, _ = pp.matmul(a, b, noise=noise)
            rel = float(np.max(np.abs(got.numpy() - want)) /
                        np.max(np.abs(want)))
            assert rel <= OUT_TOL, rel
            assert torch.equal(got, plain)        # lossless wires
            assert gst.n_waited == wst.n_waited
            assert gst.decode_mask == wst.decode_mask
            assert [w for _, w in gst.arrivals] == \
                [w for _, w in wst.arrivals]
            assert gst.crypto_s > 0 and wst.crypto_s > 0
            if crypto["encrypt"] == "real":
                assert gst.crypto_modeled_s > 0
            assert gst.dispatches == 0            # the CPU runs plain versions
