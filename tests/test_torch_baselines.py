"""The port's baseline schemes and loop round against the JAX package.

``repro_torch.core.baselines`` (conv, mds, polynomial, matdot) and the
engine's loop round (``RoundEngine._matmul_loop``, ``WorkerPool``) get the
same numpy inputs as ``repro.core.baselines`` and ``repro.runtime``, on the
CPU, where the port runs its kernels' plain versions.  Tolerances, each
relative to the reference output's max |value|:

* encode, decode and whole rounds, 1e-5: both sides contract in float32
  with float32-cast weights, in different summation orders;
* the round's plan is exact: responders, ``n_waited`` and the arrival
  order of the workers (arrival *times* embed measured seconds);
* mds on the fused round decodes with the float32 ``pinv`` of the masked
  Vandermonde encoder, an SVD each library computes its own way (about
  cond · 2^-24 apart), so its round is held by the float64 rule below;
* at the Fig-3 backward job with mds K=24 and matdot's 23 points, the
  decode is ill-conditioned, so each package is held against a float64
  product instead: the port's error at most 4x the reference's plus 1e-6
  of max |exact| (``chip_smoke.f64_rule``);
* the encrypted loop round is bit-identical to the plain loop round.

The ``cuda`` cases hold the loop round on the card (kernels) against the
same round through the plain versions, and each of its ``berrut_combine``
calls against the plain version on the same inputs, elementwise within
float32's error bound (``chip_smoke.combine_bound_ratio``); they import no
JAX and skip without a card.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import ClusterSpec, CryptoSpec, Session
from repro_torch.core import baselines, registry
from repro_torch.kernels.berrut_encode import berrut_encode_kernel
from repro_torch.kernels.mask_add import mask_add_kernel
from repro_torch.runtime import DistributedMatmul, WorkerPool
from repro_torch.runtime.straggler import StragglerModel

TOL = 1e-5

rng = np.random.default_rng(0)
A = rng.standard_normal((24, 12)).astype(np.float32)
B = rng.standard_normal((12, 10)).astype(np.float32)
W = rng.standard_normal((12, 8)).astype(np.float32)

# (scheme, registry kwargs) at test size: N = 10, K = 4
SCHEMES = [("conv", {}), ("mds", {}), ("polynomial", {}), ("matdot", {}),
           ("spacdc", {"t_colluding": 1})]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _both(name, **kw):
    from repro.core import registry as ref_registry
    return (registry.build(name, **kw), ref_registry.build(name, **kw))


# --------------------------------------------------------------------------
# the schemes: encode and decode parity, thresholds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conv", "mds", "polynomial", "matdot",
                                  "lcc", "glcc", "secpoly", "bacc"])
def test_registry_builds_the_same_scheme(name):
    port, ref = _both(name, n_workers=10, k_blocks=4, t_colluding=0)
    assert type(port).__name__ == type(ref).__name__
    assert port.name == ref.name
    assert port.recovery_threshold == ref.recovery_threshold
    assert port.pair_coded == ref.pair_coded
    assert port.rateless == ref.rateless
    assert port.supports_fused == ref.supports_fused
    assert port.fused_decode_stable == ref.fused_decode_stable
    assert port.wait_policy(2) == ref.wait_policy(2)
    if hasattr(ref, "points"):
        np.testing.assert_array_equal(port.points, ref.points)


def test_mds_at_fig3_width_is_not_fused_stable_in_either_package():
    port, ref = _both("mds", n_workers=30, k_blocks=24)
    assert not port.fused_decode_stable and not ref.fused_decode_stable
    assert port.supports_fused and ref.supports_fused
    np.testing.assert_array_equal(port.generator, ref.generator)


@pytest.mark.parametrize("name", ["conv", "mds"])
def test_data_coded_encode_and_decode_match(name):
    port, ref = _both(name, n_workers=10, k_blocks=4)
    got, want = port.encode(_t(A)), ref.encode(A)
    assert _rel(got, want) <= TOL
    res = np.einsum("nij,jk->nik", np.asarray(want), W)
    resp = list(range(10)) if name == "conv" else [1, 3, 4, 8]
    sub = res[np.asarray(resp)]
    assert _rel(port.decode(_t(sub), resp), ref.decode(sub, resp)) <= TOL


@pytest.mark.parametrize("name", ["polynomial", "matdot"])
def test_pair_coded_encode_and_decode_match(name):
    port, ref = _both(name, n_workers=10, k_blocks=4)
    (pa, pb), (ra, rb) = port.encode_pair(_t(A), _t(B)), \
        ref.encode_pair(A, B)
    assert _rel(pa, ra) <= TOL and _rel(pb, rb) <= TOL
    prods = np.einsum("nij,njk->nik", np.asarray(ra), np.asarray(rb))
    resp = [0, 2, 3, 5, 6, 7, 9][: ref.recovery_threshold]
    sub = prods[np.asarray(resp)]
    dec_p, dec_r = port.decode(_t(sub), resp), ref.decode(sub, resp)
    assert _rel(dec_p, dec_r) <= TOL
    assert _rel(port.reconstruct_matmul(dec_p, 24, 10),
                ref.reconstruct_matmul(dec_r, 24, 10)) <= TOL


def test_polynomial_grid_with_two_column_blocks_matches():
    from repro.core.baselines import PolynomialCode as RefPoly
    port, ref = baselines.PolynomialCode(6, p=2, q=2), RefPoly(6, p=2, q=2)
    (pa, pb), (ra, rb) = port.encode_pair(_t(A), _t(B)), \
        ref.encode_pair(A, B)
    assert _rel(pa, ra) <= TOL and _rel(pb, rb) <= TOL
    prods = np.einsum("nij,njk->nik", np.asarray(ra), np.asarray(rb))
    resp = [1, 2, 4, 5]
    dec_p = port.decode(_t(prods[np.asarray(resp)]), resp)
    dec_r = ref.decode(prods[np.asarray(resp)], resp)
    assert tuple(dec_p.shape) == tuple(dec_r.shape) == (2, 2, 12, 5)
    assert _rel(port.reconstruct_matmul(dec_p, 24, 10),
                ref.reconstruct_matmul(dec_r, 24, 10)) <= TOL


@pytest.mark.parametrize("name,short", [("conv", 9), ("mds", 3),
                                        ("polynomial", 3), ("matdot", 6)])
def test_recovery_threshold_raises_in_both(name, short):
    port, ref = _both(name, n_workers=10, k_blocks=4)
    resp = list(range(short))
    with pytest.raises(ValueError, match="recovery threshold"):
        port.decode(torch.zeros((short, 6, 8)), resp)
    with pytest.raises(ValueError, match="recovery threshold"):
        ref.decode(np.zeros((short, 6, 8), np.float32), resp)


def test_schemes_refuse_too_few_workers_and_blocks():
    with pytest.raises(ValueError, match="N >= p\\*q"):
        baselines.PolynomialCode(3, p=2, q=2)
    with pytest.raises(ValueError, match="2p-1"):
        baselines.MatDotCode(4, p=3)
    with pytest.raises(ValueError, match="k_blocks"):
        registry.build("matdot", n_workers=8, k_blocks=0)
    with pytest.raises(NotImplementedError, match="encode_pair"):
        registry.build("matdot", n_workers=8, k_blocks=2).encode(_t(A))
    with pytest.raises(NotImplementedError, match="encode\\(x\\)"):
        registry.build("mds", n_workers=8, k_blocks=2).encode_pair(_t(A),
                                                                   _t(B))


# the cases of tests/test_baselines.py, on the port -------------------------

def test_mds_exact_any_k_subset():
    mds = baselines.MDSCode(n_workers=9, k_blocks=4)
    res = torch.matmul(mds.encode(_t(A)), _t(W))
    for resp in ([0, 1, 2, 3], [5, 6, 7, 8], [0, 2, 4, 8]):
        out = mds.decode(res[torch.tensor(resp)], resp)
        np.testing.assert_allclose(_np(out).reshape(-1, 8), A @ W,
                                   atol=1e-3)


def test_polynomial_codes_exact():
    pc = baselines.PolynomialCode(n_workers=6, p=2, q=2)
    ea, eb = pc.encode_pair(_t(A), _t(B))
    prods = torch.matmul(ea, eb)
    resp = [1, 2, 4, 5]
    out = pc.decode(prods[torch.tensor(resp)], resp)
    np.testing.assert_allclose(_np(pc.reconstruct_matmul(out, 24, 10)),
                               A @ B, atol=1e-2)


def test_matdot_exact():
    md = baselines.MatDotCode(n_workers=7, p=3)
    ea, eb = md.encode_pair(_t(A), _t(B))
    prods = torch.matmul(ea, eb)
    resp = [0, 2, 3, 5, 6]
    out = md.decode(prods[torch.tensor(resp)], resp)
    np.testing.assert_allclose(_np(out), A @ B, atol=1e-2)


def test_uncoded_requires_all_and_reorders():
    cv = baselines.UncodedScheme(n_workers=4)
    sh = cv.encode(_t(A))
    assert sh.shape[0] == 4
    with pytest.raises(ValueError):
        cv.decode(torch.zeros((3, 6, 12)), [0, 1, 2])
    out = cv.decode(sh[torch.tensor([2, 0, 3, 1])], [2, 0, 3, 1])
    assert torch.equal(out, sh)


# the later baselines: LCC, GLCC, SecPoly, BACC (tests/test_baselines.py and
# tests/test_glcc.py), the gradient code and the registry -------------------

def test_registry_names_match_the_reference():
    from repro.core import registry as ref_registry
    assert registry.names() == ref_registry.names()
    assert {"bacc", "berrut_grad", "glcc", "lcc", "secpoly"} <= \
        set(registry.names())


@pytest.mark.parametrize("name,kw", [
    ("lcc", dict(n_workers=12, k_blocks=3, t_colluding=1, deg_f=2,
                 noise_scale=0.05, seed=3)),
    ("glcc", dict(n_workers=12, k_blocks=4, t_colluding=1, deg_f=2,
                  n_groups=2, noise_scale=0.05, seed=3)),
    ("bacc", dict(n_workers=10, k_blocks=2))])
def test_later_data_coded_encode_and_decode_match(name, kw):
    """The numpy-drawn LCC/GLCC noise is the reference's draw, so the
    shards match; the decodes of the reference's own results too."""
    port, ref = _both(name, **kw)
    got, want = port.encode(_t(A)), np.asarray(ref.encode(A))
    assert _rel(got, want) <= TOL
    if name == "bacc":
        res = want @ W
    else:           # f(X) = X X^T, the degree-2 task LCC is exact for
        res = want @ want.transpose(0, 2, 1)
    resp = [9, 3, 7, 0, 5, 1, 2, 4, 8, 6, 11, 10][: ref.recovery_threshold
                                                    if name != "bacc" else 6]
    sub = res[np.asarray(resp)]
    assert _rel(port.decode(_t(sub), resp), ref.decode(sub, resp)) <= TOL


def test_lcc_exact_for_quadratic():
    lcc = baselines.LCCScheme(n_workers=12, k_blocks=3, t_colluding=1,
                              deg_f=2)
    sh = lcc.encode(_t(A))
    out = lcc.decode(torch.matmul(sh, sh.transpose(1, 2)), list(range(12)))
    x = A.reshape(3, 8, 12)
    np.testing.assert_allclose(_np(out), x @ x.transpose(0, 2, 1), atol=5e-2)


def test_secpoly_masks_recovers_and_matches_the_reference():
    from repro.core.baselines import SecPolyCode as RefSecPoly
    port, ref = baselines.SecPolyCode(8, p=2, q=2), RefSecPoly(8, p=2, q=2)
    (pa, pb), (ra, rb) = port.encode_pair(_t(A), _t(B)), \
        ref.encode_pair(A, B)
    assert _rel(pa, ra) <= TOL and _rel(pb, rb) <= TOL
    prods = np.einsum("nij,njk->nik", np.asarray(ra), np.asarray(rb))
    resp = list(range(ref.recovery_threshold))
    out = port.decode(_t(prods[: len(resp)]), resp)
    assert _rel(out, ref.decode(prods[: len(resp)], resp)) <= TOL
    np.testing.assert_allclose(_np(port.reconstruct_matmul(out, 24, 10)),
                               A @ B, atol=5e-2)
    port.use_kernel = False         # reaches the inner polynomial code
    assert port.inner.use_kernel is False


def test_bacc_rateless():
    bacc = baselines.BACCScheme(n_workers=10, k_blocks=2)
    res = torch.matmul(bacc.encode(_t(A)), _t(W))
    out = bacc.decode(res[:6], list(range(6)))
    exact = A.reshape(2, 12, 12) @ W
    assert np.abs(_np(out) - exact).max() / np.abs(exact).max() < 0.2
    assert bacc.min_responders == 1 and bacc.supports_fused
    bacc.use_kernel = False
    assert bacc._code.use_kernel is False


def _glcc_x(seed=0, rows=24, d=8):
    return np.random.default_rng(seed).standard_normal(
        (rows, d)).astype(np.float32)


def test_glcc_degenerate_group_matches_lcc_bitwise():
    kw = dict(n_workers=12, k_blocks=4, t_colluding=1, deg_f=2,
              noise_scale=0.05, seed=3)
    lcc, glcc = baselines.LCCScheme(**kw), baselines.GLCCScheme(n_groups=1,
                                                                **kw)
    assert glcc.recovery_threshold == lcc.recovery_threshold
    np.testing.assert_array_equal(glcc.encoder, lcc.encoder)
    x = _t(_glcc_x())
    assert torch.equal(glcc.encode(x), lcc.encode(x))
    shards = lcc.encode(x)
    results = torch.matmul(shards, shards.transpose(1, 2))
    resp = list(range(lcc.recovery_threshold))
    assert torch.equal(glcc.decode(results, resp), lcc.decode(results, resp))


def test_glcc_threshold_drops_and_shards_grow_with_groups():
    from repro.core.baselines import GLCCScheme as RefGLCC
    prev_thr, prev_rows = None, None
    for g in (1, 2, 4):
        kw = dict(n_workers=12, k_blocks=4, t_colluding=1, deg_f=2,
                  n_groups=g, noise_scale=0.05, seed=3)
        s = baselines.GLCCScheme(**kw)
        shards = s.encode(_t(_glcc_x()))
        assert _rel(shards, RefGLCC(**kw).encode(_glcc_x())) <= TOL
        rows = shards.shape[1]
        if prev_thr is not None:
            assert s.recovery_threshold < prev_thr
            assert rows > prev_rows     # the g× communication price
        prev_thr, prev_rows = s.recovery_threshold, rows
        assert rows == g * (24 // 4)


def test_glcc_exactness_linear_f():
    b = np.random.default_rng(1).standard_normal((8, 5)).astype(np.float32)
    for g in (1, 2, 4):
        s = baselines.GLCCScheme(n_workers=12, k_blocks=4, t_colluding=0,
                                 deg_f=1, n_groups=g, seed=3)
        x = _glcc_x()
        resp = [11, 3, 7, 0, 5][: s.recovery_threshold]
        shards = s.encode(_t(x))
        out = _np(s.decode(torch.matmul(shards[torch.tensor(resp)], _t(b)),
                           resp))
        want = x.reshape(4, 6, 8) @ b
        assert np.linalg.norm(out - want) / np.linalg.norm(want) < 1e-2


def test_glcc_validation():
    with pytest.raises(ValueError, match="dividing"):
        baselines.GLCCScheme(n_workers=12, k_blocks=4, n_groups=3)
    with pytest.raises(ValueError, match="dividing"):
        baselines.GLCCScheme(n_workers=12, k_blocks=4, n_groups=0)
    with pytest.raises(ValueError, match="N >="):
        baselines.GLCCScheme(n_workers=4, k_blocks=6, n_groups=1, deg_f=2)
    s = baselines.GLCCScheme(n_workers=12, k_blocks=4, n_groups=2, deg_f=2)
    with pytest.raises(ValueError):
        s.decode(torch.zeros((2, 12, 8)), [0, 1])
    with pytest.raises(ValueError, match="noise"):
        s.encode(_t(_glcc_x()), noise=torch.zeros(1))


def test_glcc_registry_build():
    s = registry.build("glcc", n_workers=12, k_blocks=6, t_colluding=1,
                       deg_f=2, n_groups=3, noise_scale=0.05, seed=0)
    assert isinstance(s, baselines.GLCCScheme)
    assert s.n_groups == 3 and s.per_group == 2
    s2 = registry.build("glcc", n_workers=12, k_blocks=6, use_kernel=None)
    assert s2.n_groups == 1


def test_berrut_gradient_code_matches_the_reference():
    from repro.core import registry as ref_registry
    port = registry.build("berrut_grad", n_shards=8, n_blocks=8,
                          redundancy=2)
    ref = ref_registry.build("berrut_grad", n_shards=8, n_blocks=8,
                             redundancy=2)
    np.testing.assert_array_equal(port.assignment(), ref.assignment())
    np.testing.assert_allclose(port.encoder_matrix(), ref.encoder_matrix(),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(5)
    for _ in range(5):
        mask = np.zeros(8, np.float32)
        mask[rng.choice(8, size=int(rng.integers(1, 9)), replace=False)] = 1
        w = port.decoder_weights(torch.from_numpy(mask))
        np.testing.assert_allclose(_np(w), np.asarray(ref.decoder_weights(
            mask)), rtol=1e-5, atol=1e-6)
        assert abs(float((w * torch.from_numpy(mask)).sum()) - 1.0) < 1e-3
    grads = rng.standard_normal((2, 3, 4)).astype(np.float32)
    got = port.encode_local(_t(grads), 5)
    assert _rel(got, ref.encode_local(grads, 5)) <= TOL
    # coded_psum is ported (held against the reference's shard_map over
    # gloo ranks in tests/test_torch_distributed.py); without a mesh it
    # refuses
    with pytest.raises(ValueError, match="runs on a mesh"):
        from repro_torch.core import coded_psum
        coded_psum(got, torch.ones(8), port, "dp")


# --------------------------------------------------------------------------
# rounds: DistributedMatmul and Session, fused and loop, against the JAX
# package
# --------------------------------------------------------------------------

def _ref_noise(ref_engine, a_shape):
    scheme = ref_engine.scheme
    if getattr(scheme, "cfg", None) is None or not scheme.cfg.t_colluding:
        return None
    blk = -(-a_shape[0] // scheme.cfg.k_blocks)
    return np.asarray(scheme.make_noise((blk, a_shape[1])))


def _smoke():
    """``chip_smoke.py``, whose error rules these tests share."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within_f64_rule(got, want, exact) -> bool:
    return _smoke().f64_rule(torch, got, want, exact)["holds"]


def _assert_same_round(got, gst, want, wst, pinv_decode=False):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    if pinv_decode:
        assert _within_f64_rule(got, want, A.astype(np.float64) @ B)
    else:
        assert _rel(got, want) <= TOL
    assert gst.n_waited == wst.n_waited
    assert [w for _, w in gst.arrivals] == [w for _, w in wst.arrivals]
    assert gst.policy == wst.policy
    assert gst.dispatches == 0          # the CPU runs the plain versions


@pytest.mark.parametrize("fused", [None, False], ids=["default", "loop"])
@pytest.mark.parametrize("scheme,kwargs", SCHEMES,
                         ids=[s for s, _ in SCHEMES])
def test_distributed_matmul_matches_reference(scheme, kwargs, fused):
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    if fused is False and scheme in ("polynomial", "matdot"):
        fused = None                    # pair-coded: the loop round anyway
    # tests/test_runtime.py's configuration (seed 0)
    ref = RefDM(scheme, 10, 4, n_stragglers=2, fused=fused, **kwargs)
    port = DistributedMatmul(scheme, 10, 4, n_stragglers=2, fused=fused,
                             device="cpu", **kwargs)
    assert port.use_fused == ref.use_fused
    noise = _ref_noise(ref, A.shape)
    for r in range(3):
        want, wst = ref.matmul(A, B, round_idx=r)
        got, gst = port.matmul(A, B, round_idx=r, noise=noise)
        _assert_same_round(got, gst, want, wst,
                           pinv_decode=port.use_fused and scheme == "mds")
        if not port.use_fused:
            assert gst.decode_s > 0.0
        assert gst.total_s > 0
        if r == 0:      # tests/test_runtime.py's accuracy case
            exact = A @ B
            rel = np.abs(_np(got) - exact).max() / np.abs(exact).max()
            assert rel < (0.25 if scheme == "spacdc" else 1e-2), (scheme, rel)


@pytest.mark.parametrize("scheme,kwargs", SCHEMES,
                         ids=[s for s, _ in SCHEMES])
def test_session_loop_round_matches_reference(scheme, kwargs):
    import repro.api as ref_api
    code = dict(scheme=scheme, n_workers=10, k_blocks=4,
                fused=None if scheme in ("polynomial", "matdot") else False)
    ref_spec = ref_api.ClusterSpec(
        code=ref_api.CodeSpec(**code),
        privacy=ref_api.PrivacySpec(t_colluding=kwargs.get("t_colluding",
                                                           0)),
        straggler=ref_api.StragglerSpec(n_stragglers=2), seed=3)
    spec = ClusterSpec.from_dict(ref_spec.to_dict())
    with ref_api.Session(ref_spec) as rs, Session(spec, device="cpu") as ps:
        assert not ps.engine.use_fused
        noise = _ref_noise(rs.engine, A.shape)
        for _ in range(2):
            want, wst = rs.matmul(A, B)
            got, gst = ps.matmul(A, B, noise=noise)
            _assert_same_round(got, gst, want, wst)
    assert len(ps.round_stats) == 2


@pytest.mark.parametrize("scheme,k", [("mds", 24), ("matdot", 12)])
def test_fig3_backward_loop_round_against_float64(scheme, k):
    """The ill-conditioned Fig-3 decodes: each package against the float64
    product, the port within 4x the reference's error + 1e-6 max |exact|;
    the plan is exact."""
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    r = np.random.default_rng(7)
    a = (r.standard_normal((512, 10)) * 0.1).astype(np.float32)
    b = (r.standard_normal((10, 256)) * 0.01).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ref = RefDM(scheme, 30, k, n_stragglers=5)
    port = DistributedMatmul(scheme, 30, k, n_stragglers=5, device="cpu")
    assert not port.use_fused and not ref.use_fused
    want, wst = ref.matmul(a, b, round_idx=1)
    got, gst = port.matmul(a, b, round_idx=1)
    assert gst.n_waited == wst.n_waited == (24 if scheme == "mds" else 23)
    assert [w for _, w in gst.arrivals] == [w for _, w in wst.arrivals]
    assert _within_f64_rule(got, want, exact)


@pytest.mark.parametrize("scheme,k", [("mds", 24), ("matdot", 12)])
def test_combine_bound_holds_the_fig3_decode_to_float32_rounding(scheme, k):
    """The elementwise bound that holds a ``berrut_combine`` kernel to its
    plain version (``chip_smoke.combine_bound_ratio``) at the
    ill-conditioned Fig-3 decodes: the same result is 0 off, a recomputed
    one within 1, while a decode 0.1% off everywhere, one with a term
    dropped, or zeros, lie outside it; the float64 rule passes the
    first."""
    from repro_torch.kernels import ops
    smoke = _smoke()
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((512, 10), generator=gen)
    b = torch.randn((10, 256), generator=gen)
    calls = []
    with Session(ClusterSpec.from_legacy_kwargs(scheme, 30, k,
                                                n_stragglers=5),
                 device="cpu") as s:
        run = s.engine.scheme._combine
        s.engine.scheme._combine = \
            lambda w, blocks: calls.append((w, blocks)) or run(w, blocks)
        s.matmul(a, b, round_idx=1)
    w, blocks = calls[-1]               # the decode
    assert blocks.shape[0] == (24 if scheme == "mds" else 23)
    want = ops.berrut_combine(w, blocks)
    j = blocks.shape[0]
    flat = blocks.reshape(j, -1)
    w32 = torch.as_tensor(w).float()
    # the same sum in the other order of j, and as float32 elementwise fmas
    again = torch.zeros_like(flat[:w32.shape[0]])
    for i in reversed(range(j)):
        again = torch.addcmul(again, w32[:, i:i + 1], flat[i:i + 1])
    exact = (w32.double() @ flat.double()).reshape(want.shape)
    ratio = lambda got: smoke.combine_bound_ratio(torch, w, blocks, got,
                                                  want)
    assert ratio(want.clone()) == 0.0
    assert ratio(again.reshape(want.shape)) <= 1.0
    dropped = np.array(w)
    dropped[:, -1] = 0.0
    for wrong in (want * 1.001, ops.berrut_combine(dropped, blocks),
                  torch.zeros_like(want)):
        assert ratio(wrong) > 1.0
    assert smoke.f64_rule(torch, want * 1.001, want, exact)["holds"]


def test_conv_waits_for_stragglers_and_spacdc_does_not_for_mds():
    conv = DistributedMatmul("conv", 10, 4, n_stragglers=2, seed=3,
                             device="cpu")
    mds = DistributedMatmul("mds", 10, 4, n_stragglers=2, seed=3,
                            device="cpu")
    _, s_conv = conv.matmul(A, B, round_idx=1)
    _, s_mds = mds.matmul(A, B, round_idx=1)
    assert s_conv.compute_wait_s > s_mds.compute_wait_s
    assert s_conv.n_waited == 10
    # stragglers push survivors (8) below mds's threshold (10)
    mds = DistributedMatmul("mds", 12, 10, n_stragglers=4, seed=7,
                            device="cpu")
    spa = DistributedMatmul("spacdc", 12, 10, t_colluding=1,
                            n_stragglers=4, seed=7, device="cpu")
    _, st_mds = mds.matmul(A, B, round_idx=2)
    _, st_spa = spa.matmul(A, B, round_idx=2)
    assert st_spa.compute_wait_s < st_mds.compute_wait_s


@pytest.mark.parametrize("scheme,kwargs", SCHEMES,
                         ids=[s for s, _ in SCHEMES])
def test_encrypted_loop_round_is_bit_identical_to_plain(scheme, kwargs):
    fused = None if scheme in ("polynomial", "matdot") else False
    plain = DistributedMatmul(scheme, 10, 4, n_stragglers=2, seed=3,
                              fused=fused, device="cpu", **kwargs)
    real = DistributedMatmul(scheme, 10, 4, n_stragglers=2, seed=3,
                             fused=fused, encrypt="real", device="cpu",
                             **kwargs)
    assert not real.use_fused
    o1, s1 = plain.matmul(A, B, round_idx=1)
    o2, s2 = real.matmul(A, B, round_idx=1)
    assert torch.equal(o1, o2)
    assert s1.crypto_s == 0.0 and s2.crypto_s > 0.0      # measured
    assert s2.crypto_modeled_s > 0.0 and s2.crypto_s != s2.crypto_modeled_s
    assert s2.n_waited == s1.n_waited and s2.arrivals[0][1] == \
        s1.arrivals[0][1]


def test_modeled_crypto_on_the_loop_round_matches_reference_shape():
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    port = DistributedMatmul("matdot", 10, 4, encrypt=True, device="cpu")
    ref = RefDM("matdot", 10, 4, encrypt=True)
    _, gst = port.matmul(A, B)
    _, wst = ref.matmul(A, B)
    assert gst.crypto_s > 0 and wst.crypto_s > 0
    assert gst.crypto_modeled_s == wst.crypto_modeled_s == 0.0


def test_worker_pool_virtual_round_matches_reference():
    from repro.runtime.engine import WorkerPool as RefPool
    from repro.runtime.straggler import StragglerModel as RefModel
    port = WorkerPool(10, StragglerModel(10, 3, seed=1))
    ref = RefPool(10, RefModel(10, 3, seed=1))
    try:
        shards = [np.full((2, 2), i, np.float32) for i in range(10)]
        for r in range(5):
            resp_p, res_p, wait_p = port.run_round(
                [_t(s) for s in shards], lambda s: s * 2, r, 7,
                t_compute=0.001)
            resp_r, res_r, wait_r = ref.run_round(shards, lambda s: s * 2,
                                                  r, 7, t_compute=0.001)
            np.testing.assert_array_equal(resp_p, resp_r)
            assert wait_p == wait_r
            for got, want in zip(res_p, res_r):
                np.testing.assert_array_equal(_np(got), want)
        assert port.backend == "virtual" and not port.real_threads
        with pytest.raises(ValueError, match="t_compute"):
            port.run_round(shards, lambda s: s, 0, 3)
    finally:
        port.close()
        ref.close()
    port.close()                                         # idempotent


def test_worker_pool_threads_backend_runs_like_the_reference():
    """The threads backend runs real rounds (the socket mesh's pool is
    ``tests/test_torch_socket.py``'s).  With a zero straggler delay both packages consume all
    workers; the results are the task's, in responder order."""
    from repro.runtime.master_worker import WorkerPool as RefPool
    from repro.runtime.straggler import StragglerModel as RefModel
    pool = WorkerPool(4, StragglerModel(4, 0), backend="threads")
    assert pool.backend == "threads" and pool.real_threads
    assert WorkerPool(4, StragglerModel(4, 0), real_threads=True).backend \
        == "threads"
    ref = RefPool(4, RefModel(4, 0), backend="threads")
    try:
        shards = [np.full((2, 2), i, np.float32) for i in range(4)]
        resp_p, res_p, wait_p = pool.run_round(
            [_t(x) for x in shards], lambda x: x * 2, 0, 4)
        resp_r, res_r, wait_r = ref.run_round(shards, lambda x: x * 2, 0, 4)
        np.testing.assert_array_equal(resp_p, resp_r)
        for got, want in zip(res_p, res_r):
            np.testing.assert_array_equal(_np(got), want)
        assert wait_p > 0.0 and wait_r > 0.0
        pool.real_threads = False
        assert pool.backend == "virtual" and not pool.real_threads
    finally:
        pool.close()
        ref.close()
    assert pool._executor is None


def test_legacy_and_session_loop_rounds_are_bit_identical():
    old = DistributedMatmul("spacdc", 8, 4, t_colluding=1, n_stragglers=1,
                            seed=0, fused=False, device="cpu")
    spec = ClusterSpec.from_legacy_kwargs("spacdc", 8, 4, t_colluding=1,
                                          n_stragglers=1, seed=0,
                                          fused=False)
    o1, s1 = old.matmul(A, B, round_idx=1)
    with Session(spec, device="cpu") as s:
        o2, s2 = s.matmul(A, B, round_idx=1)
    assert torch.equal(o1, o2)
    assert s1.n_waited == s2.n_waited


def test_distributed_matmul_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedMatmul("mds", 8, 4)
    assert DistributedMatmul("mds", 8, 4, device="cpu").device.type == "cpu"


# --------------------------------------------------------------------------
# the card: the loop round through the kernels against its plain version
# --------------------------------------------------------------------------

# per scheme at N = 30: (k_blocks, berrut_combine launches per plain round)
CARD_LOOP = [("mds", 24, 2), ("matdot", 12, 3), ("polynomial", 24, 3),
             ("spacdc", 24, 2), ("conv", 24, 0)]


@pytest.mark.parametrize("scheme,k,combines", CARD_LOOP,
                         ids=[c[0] for c in CARD_LOOP])
def test_cuda_loop_round_matches_plain(cuda, scheme, k, combines):
    """The Fig-3 backward job's loop round: kernels against the plain
    versions on the card (same plan; 1e-5 of max |plain|, or, for the
    ill-conditioned decodes, the float64 rule), with its exact launches;
    each of the kernel round's ``berrut_combine`` calls elementwise within
    float32's error bound of the plain version on the same inputs."""
    spec = ClusterSpec.from_legacy_kwargs(
        scheme, 30, k, t_colluding=3 if scheme == "spacdc" else 0,
        n_stragglers=5, fused=False if scheme in ("spacdc", "conv") else None)
    plain_spec = dataclasses.replace(
        spec, code=dataclasses.replace(spec.code, use_kernel=False))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn((512, 10), generator=gen, device=cuda) * 0.1
    b = torch.randn((10, 256), generator=gen, device=cuda) * 0.01
    smoke, ratios = _smoke(), []
    with Session(spec, device=cuda) as sk, \
            Session(plain_spec, device=cuda) as sp:
        smoke.hold_combines(torch, sk.engine.scheme, ratios)
        n0 = berrut_encode_kernel.launches
        got, gst = sk.matmul(a, b, round_idx=1)
        torch.cuda.synchronize()
        assert berrut_encode_kernel.launches - n0 == combines
        assert gst.dispatches == combines
        want, wst = sp.matmul(a, b, round_idx=1)
        assert berrut_encode_kernel.launches - n0 == combines
    assert not sk.engine.use_fused
    assert [w for _, w in gst.arrivals] == [w for _, w in wst.arrivals]
    assert got.device == a.device and bool(torch.isfinite(got).all())
    assert len(ratios) == combines and max(ratios, default=0.0) <= 1.0, \
        ratios
    assert _rel(got, want) <= TOL or \
        _within_f64_rule(got, want, a.double() @ b.double())


@pytest.mark.parametrize("scheme", ["mds", "matdot"])
def test_cuda_encrypted_loop_round_is_bit_identical(cuda, scheme):
    spec = ClusterSpec.from_legacy_kwargs(
        scheme, 30, 24 if scheme == "mds" else 12, n_stragglers=5)
    real = dataclasses.replace(spec, crypto=CryptoSpec(encrypt="real"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    a = torch.randn((512, 10), generator=gen, device=cuda)
    b = torch.randn((10, 256), generator=gen, device=cuda)
    with Session(spec, device=cuda) as sp, Session(real, device=cuda) as sr:
        want, wst = sp.matmul(a, b, round_idx=1)
        m0 = mask_add_kernel.launches
        got, gst = sr.matmul(a, b, round_idx=1)
        torch.cuda.synchronize()
    # two mask_add launches per shard part out and per result back, beside
    # the round's berrut_combine launches; the engine's first round also
    # samples the modeled rate (4 more mask_add launches, not the round's)
    parts, combines = (2, 3) if scheme == "matdot" else (1, 2)
    wires = 2 * (parts * 30 + gst.n_waited)
    assert gst.dispatches == combines + wires, gst.dispatches
    assert mask_add_kernel.launches - m0 == wires + 4
    assert torch.equal(got, want)
    assert gst.crypto_s > 0.0
