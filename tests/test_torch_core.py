"""The port's SPACDC core (``repro_torch.core``) against the JAX package.

Node layouts are float64 numpy in both packages and must be exactly equal.
Weight matrices are float32 in both (JAX's default precision, which the
port keeps on purpose): they must agree to 1e-6 relative to their max
|value| — a few float32 ulp, from sums taken in another order.  Rounds
through ``fused_round`` must agree to 2e-5 relative (float32 products over
d <= 256 in different orders); T > 0 rounds get the JAX-drawn noise handed
in, since torch's generator draws other numbers than ``jax.random``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import berrut, registry
from repro_torch.core.spacdc import SPACDCCode, SPACDCConfig

W_TOL = 1e-6
ROUND_TOL = 2e-5
NK = [(8, 4), (8, 24), (30, 4), (30, 24)]


def _rel(got, want) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-30))


def _pair(n, k, t=0, fh_degree=0, seed=0):
    """(port scheme, reference scheme) for one (N, K, T)."""
    from repro.core.spacdc import SPACDCCode as RefCode, \
        SPACDCConfig as RefConfig
    return (SPACDCCode(SPACDCConfig(n, k, t, fh_degree=fh_degree, seed=seed)),
            RefCode(RefConfig(n, k, t, fh_degree=fh_degree, seed=seed)))


@pytest.mark.parametrize("n,k", NK)
@pytest.mark.parametrize("t", [0, 3])
def test_node_layout_is_identical(n, k, t):
    from repro.core import berrut as rb
    for got, want in zip(berrut.default_alpha_beta(n, k, t),
                         rb.default_alpha_beta(n, k, t)):
        np.testing.assert_array_equal(got, want)
    for kind in (1, 2):
        np.testing.assert_array_equal(berrut.chebyshev_points(n, kind=kind),
                                      rb.chebyshev_points(n, kind=kind))
    nodes = rb.chebyshev_points(n, kind=1)
    np.testing.assert_array_equal(berrut.fh_weights(nodes, 2),
                                  rb.fh_weights(nodes, 2))


@pytest.mark.parametrize("n,k", NK)
@pytest.mark.parametrize("fh_degree", [0, 2])
def test_enc_matrix_matches(n, k, fh_degree):
    port, ref = _pair(n, k, t=3, fh_degree=fh_degree)
    assert port.enc_matrix.dtype == torch.float32
    assert _rel(port.enc_matrix, ref.enc_matrix) <= W_TOL


@pytest.mark.parametrize("n,k", NK)
def test_decode_matrices_match_for_random_masks(n, k):
    port, ref = _pair(n, k, t=3)
    rng = np.random.default_rng(n * 100 + k)
    masks = [np.ones(n, np.float32), np.eye(n, dtype=np.float32)[n // 2]]
    masks += [(rng.random(n) < p).astype(np.float32) for p in (0.3, 0.6, 0.9)]
    for i, mask in enumerate(masks):
        mask[0] = 1.0                       # at least one responder
        got = port.decode_matrix_masked(mask)
        assert got.dtype == torch.float32 and tuple(got.shape) == (k, n)
        assert _rel(got, ref.decode_matrix_masked(mask)) <= W_TOL
        if i >= 3:                          # the concrete-set form too
            resp = np.flatnonzero(mask)
            assert _rel(port.decode_matrix(resp),
                        ref.decode_matrix(resp)) <= W_TOL


def test_prefix_decode_weights_match():
    port, ref = _pair(10, 4, t=2)
    order = np.random.default_rng(4).permutation(10)
    got_w, got_ready = port.prefix_decode_weights(order)
    want_w, want_ready = ref.prefix_decode_weights(order)
    np.testing.assert_array_equal(got_ready, want_ready)
    assert _rel(got_w, want_w) <= W_TOL


@pytest.mark.parametrize("t", [0, 3])
@pytest.mark.parametrize("m,d,n_out", [(512, 10, 256), (100, 33, 17)])
def test_fused_round_matches(t, m, d, n_out):
    port, ref = _pair(30, 24, t=t)
    rng = np.random.default_rng(m + t)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((d, n_out)).astype(np.float32)
    mask = np.ones(30, np.float32)
    mask[rng.choice(30, 7, replace=False)] = 0.0
    blk = -(-m // 24)
    noise = np.asarray(ref.make_noise((blk, d)))
    got = port.fused_round(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(mask), noise=noise)
    assert tuple(got.shape) == (24, blk, n_out)
    want = np.asarray(ref.fused_round(a, b, mask))
    assert _rel(got, want) <= ROUND_TOL
    out = port.reconstruct_matmul(got, m, n_out)
    assert tuple(out.shape) == (m, n_out)
    assert _rel(out, np.asarray(ref.reconstruct_matmul(want, m, n_out))) \
        <= ROUND_TOL


def test_encode_and_decode_match():
    port, ref = _pair(12, 4, t=2)
    x = np.random.default_rng(5).standard_normal((10, 6)).astype(np.float32)
    noise = np.asarray(ref.make_noise((3, 6)))
    shards = port.encode(torch.from_numpy(x), noise=noise)
    want = np.asarray(ref.encode(x))
    assert tuple(shards.shape) == (12, 3, 6)
    assert _rel(shards, want) <= ROUND_TOL
    resp = np.array([0, 2, 3, 5, 7, 8, 11])
    assert _rel(port.decode(shards[resp], resp), ref.decode(want[resp], resp)) \
        <= ROUND_TOL
    mask = np.zeros(12, np.float32)
    mask[resp] = 1.0
    assert _rel(port.decode_masked(shards, mask),
                ref.decode_masked(want, mask)) <= ROUND_TOL


def test_noise_is_the_same_every_draw_and_checked():
    port = SPACDCCode(SPACDCConfig(8, 4, 2))
    first = port.make_noise((3, 5))
    assert tuple(first.shape) == (2, 3, 5)
    torch.testing.assert_close(port.make_noise((3, 5)), first, rtol=0, atol=0)
    no_noise = SPACDCCode(SPACDCConfig(8, 4, 0))
    assert tuple(no_noise.make_noise((3, 5)).shape) == (0, 3, 5)
    with pytest.raises(ValueError, match="noise must have shape"):
        port.fused_blocks(torch.zeros(8, 5), noise=np.zeros((1, 2, 5)))


def test_berrut_weights_and_combine_match():
    from repro.core import berrut as rb
    nodes = rb.chebyshev_points(9, kind=1)
    queries = np.linspace(-1.2, 1.2, 13)
    queries[3] = nodes[2]                    # an exact node hit
    assert _rel(berrut.berrut_weight_matrix(queries, nodes),
                rb.berrut_weight_matrix(queries, nodes)) <= W_TOL
    bw = rb.fh_weights(nodes, 2)
    assert _rel(berrut.bary_weight_matrix(queries, nodes, bw),
                rb.bary_weight_matrix(queries, nodes, bw)) <= W_TOL
    w = np.array(rb.berrut_weight_matrix(queries, nodes))
    vals = np.random.default_rng(6).standard_normal((9, 4)).astype(np.float32)
    assert _rel(berrut.combine(torch.from_numpy(w), torch.from_numpy(vals)),
                rb.combine(w, vals)) <= ROUND_TOL


def test_generic_pinv_decode_matches():
    """The default masked decode of threshold schemes (float32 pinv of the
    mask-zeroed encoder), on one encoder in both packages."""
    from repro.core.registry import SchemeDefaults as RefDefaults
    enc = np.random.default_rng(7).standard_normal((9, 4)).astype(np.float32)

    def scheme(base):
        cls = type("Linear", (base,), {"n_workers": 9, "k_blocks": 4,
                                       "recovery_threshold": 4,
                                       "fused_encoder_matrix": lambda s: enc})
        return cls()
    port, ref = scheme(registry.SchemeDefaults), scheme(RefDefaults)
    mask = np.ones(9, np.float32)
    mask[[1, 5, 6]] = 0.0
    got = port.decode_matrix_masked(mask)
    assert tuple(got.shape) == (4, 9)
    # non-responders' columns vanish up to the SVD's float32 rounding
    assert float(got[:, [1, 5, 6]].abs().max()) < 1e-5
    # the pinv's SVD runs in other libraries: float32, a condition number
    # of a few units, so 1e-5 relative
    assert _rel(got, ref.decode_matrix_masked(mask)) <= 1e-5
    assert port.fused_decode_stable == ref.fused_decode_stable
    assert port.wait_policy(2) == ref.wait_policy(2) == 4


def test_registry_builds_spacdc_only_so_far():
    # the name is kept from the first slice; the registry now holds every
    # scheme the reference registers (all of core/baselines.py and the
    # gradient code), and no other
    assert registry.names() == ["bacc", "berrut_grad", "conv", "glcc", "lcc",
                                "matdot", "mds", "polynomial", "secpoly",
                                "spacdc"]
    scheme = registry.build("spacdc", n_workers=8, k_blocks=4, t_colluding=1,
                            use_kernel=False, not_a_knob=3)
    assert isinstance(scheme, SPACDCCode) and scheme.use_kernel is False
    assert scheme.supports_fused and scheme.fused_decode_stable
    assert scheme.wait_policy(3) == 5 and scheme.min_responders == 1
    with pytest.raises(KeyError, match="unknown coding scheme"):
        registry.build("not_a_scheme", n_workers=8, k_blocks=4)
    with pytest.raises(ValueError, match="already registered"):
        registry.register("spacdc", lambda: None)


def test_scheme_use_kernel_flows_from_code_spec():
    from repro_torch.api import ClusterSpec, CodeSpec
    spec = ClusterSpec(code=CodeSpec(n_workers=6, k_blocks=3,
                                     use_kernel=False))
    assert spec.build_scheme().use_kernel is False
    assert ClusterSpec().build_scheme().use_kernel is None
