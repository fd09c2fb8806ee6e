"""The port's crypto package (``repro_torch.crypto``) against the JAX
package's (``repro.crypto``) on the CPU.

Everything here is integer or bit arithmetic, so every comparison is exact:
limb add/sub, the SHA-256 keystream (also against ``hashlib``), seed words,
the fixed-point codec, ECDH points for fixed secret keys, and ``MEAECC``
ciphertext payloads in both modes and with both codecs.  Both packages get
the same material: numpy inputs from a seed, fixed ``sk``/``k``/nonces.
"""

import hashlib

import numpy as np
import pytest
import torch

from repro_torch.crypto import (CURVE_SECP256K1, MEAECC, generate_keypair,
                                shared_secret)
from repro_torch.crypto import field as F
from repro_torch.crypto.ecc import CURVE_TOY, ephemeral_nonce
from repro_torch.crypto.ref import LegacyMEAECC

Q = CURVE_SECP256K1.q
QL = F.int_to_limbs(Q, 8)
EDGE = [0, 1, 2, Q - 1, Q - 2, 0xFFFFFFFF, 0xFFFFFFFF << 32,
        (1 << 255) % Q, Q - 0xFFFFFFFF]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one intra-op
    thread here keeps these CPU-heavy cases from starving the
    timing-sensitive tests that other workers run at the same time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(vals):
    return np.stack([F.int_to_limbs(v, 8) for v in vals])


def _rand_field(n, seed):
    r = np.random.default_rng(seed)
    return [int.from_bytes(r.bytes(32), "big") % Q for _ in range(n)]


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.numpy()


# --------------------------------------------------------------------------
# limb arithmetic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("subtract", [False, True])
def test_add_sub_mod_match_reference_on_edges_and_random(subtract):
    from repro.crypto import field as RF
    vals = EDGE + _rand_field(64, 1)
    a = np.repeat(_limbs(vals), len(EDGE), axis=0)
    b = np.tile(_limbs(EDGE), (len(vals), 1))
    op, rop = (F.sub_mod, RF.sub_mod) if subtract else (F.add_mod, RF.add_mod)
    got = op(torch.from_numpy(a), torch.from_numpy(b), QL)
    want = rop(a, b, QL)
    np.testing.assert_array_equal(_u32(got), want)
    # and the big-int truth
    for g, x, y in zip(F.limbs_to_int(_u32(got)), F.limbs_to_int(a),
                       F.limbs_to_int(b)):
        assert int(g) == ((x - y) if subtract else (x + y)) % Q


def test_tensor_mod_broadcasts_a_scalar_mask():
    a = _limbs(_rand_field(9, 2))
    psi = F.int_to_limbs(Q - 5, 8)
    got = F.add_mod(torch.from_numpy(a), torch.from_numpy(psi), QL)
    np.testing.assert_array_equal(_u32(got), F.add_mod(
        a, np.broadcast_to(psi, a.shape), QL))


def test_numpy_parts_are_the_reference():
    from repro.crypto import field as RF
    for v in EDGE:
        np.testing.assert_array_equal(F.int_to_limbs(v, 8),
                                      RF.int_to_limbs(v, 8))
    assert F.n_limbs_for(Q) == RF.n_limbs_for(Q) == 8
    assert F.n_limbs_for(17) == RF.n_limbs_for(17)
    words = np.arange(5, dtype=np.uint64) * np.uint64(0x123456789)
    np.testing.assert_array_equal(F.LimbField(Q).from_u64(words),
                                  RF.LimbField(Q).from_u64(words))


def test_u32_helpers_round_trip():
    vals = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    t = F.as_u32_tensor(vals)
    assert t.dtype == torch.uint32
    np.testing.assert_array_equal(F.to_i64(t).numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(_u32(F.to_u32(F.to_i64(t))), vals)
    np.testing.assert_array_equal(
        _u32(F.as_u32_tensor(torch.from_numpy(vals.astype(np.int64)))), vals)


# --------------------------------------------------------------------------
# SHA-256 counter keystream
# --------------------------------------------------------------------------

def _hashlib_words(seed_words, n_words):
    seed = b"".join(int(w).to_bytes(4, "big") for w in seed_words)
    out = []
    for ctr in range(-(-n_words // 4)):
        dig = hashlib.sha256(seed + ctr.to_bytes(8, "big")).digest()
        out += [int.from_bytes(dig[i:i + 8], "big") for i in range(0, 32, 8)]
    return out[:n_words]


@pytest.mark.parametrize("n_words,lane_chunk", [
    (1, F.LANE_CHUNK), (3, 1), (4, 1), (5, 2), (17, 3), (1000, 64),
    (1000, F.LANE_CHUNK)])
def test_keystream_matches_hashlib_and_reference(n_words, lane_chunk):
    from repro.crypto import field as RF
    seeds = np.random.default_rng(n_words).integers(
        0, 2 ** 32, (3, 8), dtype=np.uint32)
    lo, hi = F.keystream_words_traced_batched(seeds, n_words,
                                              lane_chunk=lane_chunk)
    assert lo.shape == hi.shape == (3, n_words)
    rlo, rhi = RF.keystream_words_traced_batched(seeds, n_words,
                                                 lane_chunk=5)
    np.testing.assert_array_equal(_u32(lo), np.asarray(rlo))
    np.testing.assert_array_equal(_u32(hi), np.asarray(rhi))
    for c in range(3):
        got = [(int(h) << 32) | int(l) for l, h in zip(_u32(lo)[c],
                                                       _u32(hi)[c])]
        assert got == _hashlib_words(seeds[c], n_words)


def test_stream_mask_and_seed_words_match_reference():
    from repro.crypto import field as RF
    pt = generate_keypair(sk=12345).pk
    for nonce in (1, 2, 10 ** 30):
        seed = F.seed_words(pt.x, pt.y, nonce)
        np.testing.assert_array_equal(seed, RF.seed_words(pt.x, pt.y, nonce))
        got = F.stream_mask_traced(seed, 37, 8)
        np.testing.assert_array_equal(
            _u32(got), np.asarray(RF.stream_mask_traced(seed, 37, 8)))
        words = RF.keystream_u64(pt.x, pt.y, nonce, 37, Q)
        np.testing.assert_array_equal(F.keystream_u64(pt.x, pt.y, nonce, 37,
                                                      Q), words)
        np.testing.assert_array_equal(
            _u32(got)[:, 0].astype(np.uint64) |
            (_u32(got)[:, 1].astype(np.uint64) << np.uint64(32)), words)


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

def _floats(n, seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(n) * 10.0 ** r.integers(-12, 12, n))
    x = x.astype(np.float32)
    x[:6] = [0.0, -0.0, 2 ** -17, -2 ** -17, 3.4e38, -1.5 * 2 ** -16]
    return x


def test_fixed_codec_tensor_versions_match_reference():
    from repro.crypto import field as RF
    x = _floats(500, 3)
    limbs = F.fixed_encode_traced(torch.from_numpy(x), Q, 16, 8)
    np.testing.assert_array_equal(
        _u32(limbs), np.asarray(RF.fixed_encode_traced(x, Q, 16, 8)))
    np.testing.assert_array_equal(_u32(limbs),
                                  RF.FixedPointCodec(Q, 16).encode(x))
    dec = F.fixed_decode_traced(limbs, Q, 16)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(RF.fixed_decode_traced(_u32(limbs), Q, 16)))
    garbage = F.as_u32_tensor(_limbs(_rand_field(50, 4)))
    np.testing.assert_array_equal(
        F.fixed_decode_traced(garbage, Q, 16).numpy(),
        np.asarray(RF.fixed_decode_traced(_u32(garbage), Q, 16)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64, torch.int8])
def test_bits_codec_tensor_round_trip_is_bit_identical(dtype):
    x = (torch.randn(7, 5, generator=torch.Generator().manual_seed(0)) *
         50).to(dtype)
    codec = F.BitsCodec(Q)
    limbs = codec.encode(x)
    assert limbs.dtype == torch.uint32 and limbs.shape[1] == 8
    back = codec.decode(limbs, str(dtype), tuple(x.shape))
    assert back.dtype == dtype
    assert torch.equal(back.view(torch.uint8), x.view(torch.uint8))
    if dtype == torch.float32:
        np.testing.assert_array_equal(_u32(codec.encode_words(x)),
                                      codec.encode_words(x.numpy()))


# --------------------------------------------------------------------------
# curve arithmetic and key agreement
# --------------------------------------------------------------------------

def test_ecdh_points_match_reference_for_fixed_keys():
    from repro.crypto import ecc as RE
    from repro.crypto import generate_keypair as rgen, shared_secret as rss
    for sk_a, sk_b in [(3, 5), (2 ** 200 + 12345, 987654321),
                       (CURVE_SECP256K1.order - 2, 7)]:
        a, b = generate_keypair(sk=sk_a), generate_keypair(sk=sk_b)
        ra, rb = rgen(sk=sk_a), rgen(sk=sk_b)
        assert (a.pk.x, a.pk.y) == (ra.pk.x, ra.pk.y)
        s1 = shared_secret(CURVE_SECP256K1, a, b.pk)
        assert s1 == shared_secret(CURVE_SECP256K1, b, a.pk)
        assert (s1.x, s1.y) == tuple(rss(RE.CURVE_SECP256K1, ra, rb.pk))
        assert s1 == CURVE_SECP256K1.multiply_naive(sk_a, b.pk)
    toy = [CURVE_TOY.multiply(k, CURVE_TOY.generator) for k in range(1, 19)]
    assert [(p.x, p.y) for p in toy] == \
        [(p.x, p.y) for p in (RE.CURVE_TOY.multiply(k, RE.CURVE_TOY.generator)
                              for k in range(1, 19))]
    assert ephemeral_nonce(a.pk) == RE.ephemeral_nonce(ra.pk)


# --------------------------------------------------------------------------
# MEAECC
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stream", "paper"])
@pytest.mark.parametrize("codec", ["bits", "fixed"])
def test_meaecc_payloads_match_reference(mode, codec):
    from repro.crypto import MEAECC as RMEA, generate_keypair as rgen
    m = np.random.default_rng(5).standard_normal((13, 7)).astype(np.float32)
    k, sk = 0xC0FFEE ** 3, 0xBEEF ** 5
    port = MEAECC(mode=mode, codec=codec, device="cpu")
    refm = RMEA(mode=mode, codec=codec, use_kernel=False)
    c = port.encrypt(m, generate_keypair(sk=sk).pk, k=k)
    rc = refm.encrypt(m, rgen(sk=sk).pk, k=k)
    assert c.payload.dtype == torch.uint32
    np.testing.assert_array_equal(_u32(c.payload), np.asarray(rc.payload))
    assert (c.shape, c.mode, c.codec, c.dtype, c.nonce) == \
        (rc.shape, rc.mode, rc.codec, rc.dtype, rc.nonce)
    back = port.decrypt(c, generate_keypair(sk=sk))
    assert isinstance(back, torch.Tensor)
    np.testing.assert_array_equal(back.numpy(),
                                  refm.decrypt(rc, rgen(sk=sk)))
    if codec == "bits":
        np.testing.assert_array_equal(back.numpy(), m)
    # a static channel with an explicit nonce, as the engine's wire uses
    sender = generate_keypair(sk=sk + 1)
    c2 = port.encrypt(torch.from_numpy(m), generate_keypair(sk=sk).pk,
                      sender=sender, nonce=41)
    rc2 = refm.encrypt(m, rgen(sk=sk).pk, sender=rgen(sk=sk + 1), nonce=41)
    np.testing.assert_array_equal(_u32(c2.payload), np.asarray(rc2.payload))


def test_meaecc_numpy_codec_path_matches_reference():
    """float64 under the fixed codec takes the numpy codec path."""
    from repro.crypto import MEAECC as RMEA, generate_keypair as rgen
    m = np.random.default_rng(6).standard_normal((4, 5))
    port = MEAECC(mode="stream", device="cpu")
    refm = RMEA(mode="stream", use_kernel=False)
    assert not port._core_eligible(torch.float64)
    c = port.encrypt(m, generate_keypair(sk=99).pk, k=1234567)
    rc = refm.encrypt(m, rgen(sk=99).pk, k=1234567)
    np.testing.assert_array_equal(_u32(c.payload), np.asarray(rc.payload))
    np.testing.assert_array_equal(port.decrypt(c, generate_keypair(sk=99))
                                  .numpy(), refm.decrypt(rc, rgen(sk=99)))


@pytest.mark.parametrize("mode", ["stream", "paper"])
def test_meaecc_is_bit_exact_with_the_legacy_oracle(mode):
    from repro.crypto.ref import LegacyMEAECC as RLegacy
    m = np.random.default_rng(7).standard_normal((3, 4)).astype(np.float32)
    kp = generate_keypair(sk=4242)
    c = MEAECC(mode=mode, device="cpu").encrypt(m, kp.pk, k=777)
    legacy = LegacyMEAECC(mode=mode).encrypt(m, kp.pk, k=777)
    rlegacy = RLegacy(mode=mode).encrypt(m, kp.pk, k=777)
    assert [int(v) for v in legacy.payload.reshape(-1)] == \
        [int(v) for v in rlegacy.payload.reshape(-1)]
    assert [int(v) for v in F.limbs_to_int(_u32(c.payload))] == \
        [int(v) for v in legacy.payload.reshape(-1)]


def test_meaecc_rejects_a_reused_static_stream_keystream():
    mea = MEAECC(mode="stream", codec="bits", device="cpu")
    a, b = generate_keypair(sk=5), generate_keypair(sk=6)
    with pytest.raises(ValueError, match="nonce"):
        mea.encrypt(np.ones(3, np.float32), b.pk, sender=a)
    wrong = mea.decrypt(mea.encrypt(np.ones(3, np.float32), b.pk, k=99), a)
    assert not torch.equal(wrong, torch.ones(3))


def test_meaecc_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MEAECC()
