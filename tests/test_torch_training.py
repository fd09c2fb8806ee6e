"""SPACDC-DL training (paper Algorithm 2), privacy and the synthetic MNIST
data: ``repro_torch`` against the JAX package on the CPU.

Same numpy inputs on both sides.  Tolerances:

* ``synthetic_mnist``, the privacy bounds' inputs and the initial weights
  are exact: numpy in both packages (the reference's weights are float64
  under numpy 2, a float32 draw times a float64 scale; the port holds them
  in float32, equal to the reference's rounded to float32);
* a training step's loss within 1e-5 relative and the weights (and the
  biases) within 1e-5 of their layer's max |w|, after 1 and after 3
  steps: the port trains in float32 where the reference's host math runs
  in float64, and the coded rounds sum in other orders (spacdc is handed
  the reference's JAX-drawn noise);
* ``gaussian_mi_bound`` and ``min_noise_scale_for`` within 1e-6 relative
  (the encoder matrices agree to float32 rounding);
* the rounds' plans (responders, arrival order) exactly.

The ``cuda`` cases hold a training step through the kernels against the
same step with the kernels forced off, on the card; they import no JAX.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec, Session,
                             StragglerSpec, coded_mlp_init, coded_mlp_step)
from repro_torch.core import SPACDCCode, SPACDCConfig, privacy
from repro_torch.core.coded_training import (coded_backprop_decode,
                                             coded_backprop_encode)
from repro_torch.data import synthetic_mnist
from repro_torch.runtime import CodedMaster, DistributedMatmul

LOSS_TOL = 1e-5
W_TOL = 1e-5
MI_TOL = 1e-6
SIZES = (784, 32, 10)
SCHEMES = [("spacdc", {"t_colluding": 1}), ("conv", {}), ("mds", {}),
           ("matdot", {})]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(n_train=256, n_test=64, seed=0)


def _w_err(ref_ws, port_ws, scale_ws=None) -> float:
    """Max over layers of max |port - ref| / max |scale| (``scale_ws``
    defaults to the reference tensors themselves)."""
    scale_ws = ref_ws if scale_ws is None else scale_ws
    return max(float(np.abs(np.asarray(r, np.float64) -
                            p.detach().cpu().numpy()).max() /
                     np.abs(np.asarray(w)).max())
               for r, p, w in zip(ref_ws, port_ws, scale_ws))


# --------------------------------------------------------------------------
# data and initial state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(256, 64, 0), (512, 128, 3)])
def test_synthetic_mnist_is_bit_identical(args):
    from repro.data.mnist import synthetic_mnist as ref_mnist
    n_train, n_test, seed = args
    got = synthetic_mnist(n_train=n_train, n_test=n_test, seed=seed)
    want = ref_mnist(n_train=n_train, n_test=n_test, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sizes,seed", [((784, 32, 10), 0),
                                        ((784, 512, 256, 10), 3)])
def test_coded_mlp_init_is_the_reference_draw(sizes, seed):
    from repro.api import coded_mlp_init as ref_init
    rw, rb = ref_init(sizes, seed)
    pw, pb = coded_mlp_init(sizes, seed, device="cpu")
    assert len(pw) == len(rw) == len(sizes) - 1
    for r, p in zip(rw, pw):
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), r.astype(np.float32))
    for r, p in zip(rb, pb):
        np.testing.assert_array_equal(p.numpy(), r)


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coded_mlp_init(SIZES)
    dist = DistributedMatmul("spacdc", 8, 4, t_colluding=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CodedMaster(SIZES, dist)
    assert CodedMaster(SIZES, dist, device="cpu").weights[0].device.type \
        == "cpu"


# --------------------------------------------------------------------------
# the SGD step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("scheme,kwargs", SCHEMES,
                         ids=[s for s, _ in SCHEMES])
def test_coded_mlp_step_matches_reference(data, scheme, kwargs, steps):
    from repro.api import coded_mlp_init as ref_init
    from repro.api import coded_mlp_step as ref_step
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    xtr, ytr, _, _ = data
    ref = RefDM(scheme, 8, 4, n_stragglers=1, seed=0, **kwargs)
    port = DistributedMatmul(scheme, 8, 4, n_stragglers=1, seed=0,
                             device="cpu", **kwargs)
    assert port.use_fused == ref.use_fused

    def port_matmul(a, b, round_idx):
        # the reference's noise blocks for this job (every round of one
        # shape draws the same blocks from PRNGKey(seed))
        noise = None
        if scheme == "spacdc":
            blk = -(-a.shape[0] // 4)
            noise = np.asarray(ref.scheme.make_noise((blk, a.shape[1])))
        return port.matmul(a, b, round_idx, noise=noise)

    rw, rb = ref_init(SIZES, 0)
    pw, pb = coded_mlp_init(SIZES, 0, device="cpu")
    for step in range(steps):
        x, y = xtr[64 * step:64 * (step + 1)], ytr[64 * step:64 * (step + 1)]
        l_ref, el_ref, st_ref = ref_step(rw, rb, ref.matmul, x, y, lr=0.1,
                                         round0=step)
        l_port, el_port, st_port = coded_mlp_step(pw, pb, port_matmul, x, y,
                                                  lr=0.1, round0=step)
        assert isinstance(l_port, float) and el_port > 0
        assert abs(l_port - l_ref) <= LOSS_TOL * abs(l_ref), (l_port, l_ref)
        assert len(st_port) == len(st_ref) == 1
        assert st_port[0].n_waited == st_ref[0].n_waited
        assert [w for _, w in st_port[0].arrivals] == \
            [w for _, w in st_ref[0].arrivals]
    assert _w_err(rw, pw) <= W_TOL
    # the biases start at 0: their error against their layer's max |w|
    assert _w_err(rb, pb, rw) <= W_TOL


def test_session_train_step_matches_reference_session(data):
    import repro.api as ref_api
    xtr, ytr, xte, yte = data
    ref_spec = ref_api.ClusterSpec(
        code=ref_api.CodeSpec(scheme="mds", n_workers=8, k_blocks=4,
                              fused=False),
        straggler=ref_api.StragglerSpec(n_stragglers=2), seed=1)
    spec = ClusterSpec.from_dict(ref_spec.to_dict())
    with ref_api.Session(ref_spec) as rs, Session(spec, device="cpu") as ps:
        rs.init_mlp(SIZES, lr=0.1, seed=2)
        assert ps.init_mlp(SIZES, lr=0.1, seed=2) is ps
        for i in range(0, 128, 64):
            l_ref, _ = rs.train_step(xtr[i:i + 64], ytr[i:i + 64])
            l_port, _ = ps.train_step(xtr[i:i + 64], ytr[i:i + 64])
            assert abs(l_port - l_ref) <= LOSS_TOL * abs(l_ref)
        assert _w_err(rs.mlp_weights, ps.mlp_weights) <= W_TOL
        assert [s.n_waited for s in ps.round_stats] == \
            [s.n_waited for s in rs.round_stats]
        # one test example may flip across the float32/float64 boundary
        assert abs(ps.mlp_accuracy(xte, yte) -
                   rs.mlp_accuracy(xte, yte)) <= 1 / len(yte)


def test_session_train_step_equals_coded_master_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 784)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    old = DistributedMatmul("spacdc", n_workers=8, k_blocks=4,
                            t_colluding=1, n_stragglers=1, seed=0,
                            device="cpu")
    m = CodedMaster(SIZES, old, lr=0.1, seed=0, device="cpu")
    loss1, el1 = m.train_batch(x, y)
    spec = ClusterSpec(
        code=CodeSpec(scheme="spacdc", n_workers=8, k_blocks=4),
        privacy=PrivacySpec(t_colluding=1),
        straggler=StragglerSpec(n_stragglers=1), seed=0)
    with Session(spec, device="cpu") as s:
        s.init_mlp(SIZES, lr=0.1, seed=0)
        loss2, el2 = s.train_step(x, y)
        assert loss1 == loss2
        for w1, w2 in zip(m.weights, s.mlp_weights):
            assert torch.equal(w1, w2)
        for b1, b2 in zip(m.biases, s.mlp_biases):
            assert torch.equal(b1, b2)
        assert [st.n_waited for st in m.round_stats] == \
            [st.n_waited for st in s.round_stats]
        assert m.accuracy(x, y) == s.mlp_accuracy(x, y)


def test_session_training_state_lives_on_the_device():
    with Session(ClusterSpec(), device="cpu") as s:
        assert s.mlp_weights is None and s.mlp_biases is None
        with pytest.raises(RuntimeError, match="init_mlp"):
            s.train_step(np.zeros((4, 784), np.float32), np.zeros(4))
        with pytest.raises(RuntimeError, match="init_mlp"):
            s.mlp_accuracy(np.zeros((4, 784), np.float32), np.zeros(4))
        s.init_mlp(SIZES, seed=0)
        w0 = s.mlp_weights[0]
        assert isinstance(w0, torch.Tensor) and w0.dtype == torch.float32
        before = w0.clone()
        loss, elapsed = s.train_step(
            np.random.default_rng(0).standard_normal((16, 784)).astype(
                np.float32), np.arange(16) % 10)
        assert np.isfinite(loss) and elapsed > 0
        assert s.mlp_weights[0] is w0 and not torch.equal(w0, before)


def test_coded_master_trains():
    """tests/test_runtime.py's learning check at the test size."""
    xtr, ytr, xte, yte = synthetic_mnist(n_train=512, n_test=128)
    dist = DistributedMatmul("spacdc", n_workers=8, k_blocks=4,
                             t_colluding=1, n_stragglers=1, device="cpu")
    m = CodedMaster(SIZES, dist, lr=0.1, device="cpu")
    for _ in range(2):
        for i in range(0, 512, 128):
            loss, el = m.train_batch(xtr[i:i + 128], ytr[i:i + 128])
            assert np.isfinite(loss) and el > 0
    assert m.accuracy(xte, yte) > 0.8
    assert len(m.round_stats) == 8 and m.round == 8


def test_coded_master_rejects_another_device():
    dist = DistributedMatmul("spacdc", 8, 4, t_colluding=1, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        CodedMaster(SIZES, dist, device="meta")


def test_coded_backprop_encode_decode_match_reference():
    from repro.core import SPACDCCode as RefCode, SPACDCConfig as RefCfg
    from repro.core.coded_training import (
        coded_backprop_decode as ref_decode,
        coded_backprop_encode as ref_encode)
    rng = np.random.default_rng(4)
    theta_t = rng.standard_normal((30, 12)).astype(np.float32)
    delta = rng.standard_normal((12, 16)).astype(np.float32)
    sigma = (rng.standard_normal((30, 16)) > 0).astype(np.float32)
    ref = RefCode(RefCfg(10, 4, 2, noise_scale=0.5, seed=1))
    port = SPACDCCode(SPACDCConfig(10, 4, 2, noise_scale=0.5, seed=1))
    noise = np.asarray(ref.make_noise((8, 12)))
    enc_r = np.asarray(ref_encode(ref, theta_t))
    enc_p = coded_backprop_encode(port, torch.from_numpy(theta_t), noise)
    assert np.abs(enc_p.numpy() - enc_r).max() <= \
        1e-5 * np.abs(enc_r).max()
    resp = [0, 2, 3, 5, 6, 9]
    partials = np.einsum("nij,jk->nik", enc_r, delta)[resp]
    dec_r = np.asarray(ref_decode(ref, partials, resp, sigma))
    dec_p = coded_backprop_decode(port, torch.from_numpy(partials), resp,
                                  torch.from_numpy(sigma))
    assert dec_p.shape == dec_r.shape == (30, 16)
    assert np.abs(dec_p.numpy() - dec_r).max() <= 1e-5 * np.abs(dec_r).max()


# --------------------------------------------------------------------------
# privacy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [(10, 3, 2, 0.5), (10, 3, 2, 8.0),
                                 (12, 4, 2, 1.0), (30, 24, 3, 1.0)])
def test_privacy_bounds_match_reference(cfg):
    from repro.core import SPACDCCode as RefCode, SPACDCConfig as RefCfg
    from repro.core import privacy as ref_privacy
    n, k, t, scale = cfg
    port = SPACDCCode(SPACDCConfig(n, k, t, noise_scale=scale))
    ref = RefCode(RefCfg(n, k, t, noise_scale=scale))
    got = privacy.gaussian_mi_bound(port, var_x=2.0)
    want = ref_privacy.gaussian_mi_bound(ref, var_x=2.0)
    np.testing.assert_allclose(got, want, rtol=MI_TOL)
    for bits in (0.01, 0.5):
        got = privacy.min_noise_scale_for(port, bits)
        want = ref_privacy.min_noise_scale_for(ref, bits)
        assert abs(got - want) <= MI_TOL * want


def test_mi_bound_decreases_with_noise():
    prev = None
    for scale in (0.5, 2.0, 8.0):
        code = SPACDCCode(SPACDCConfig(10, 3, t_colluding=2,
                                       noise_scale=scale))
        b = privacy.gaussian_mi_bound(code).max()
        if prev is not None:
            assert b < prev
        prev = b


def test_no_noise_means_no_privacy():
    code = SPACDCCode(SPACDCConfig(10, 3, t_colluding=0))
    assert np.isinf(privacy.gaussian_mi_bound(code)).all()
    with pytest.raises(ValueError, match="T >= 1"):
        privacy.min_noise_scale_for(code, 0.1)


def test_min_noise_scale_achieves_target():
    code = SPACDCCode(SPACDCConfig(12, 4, t_colluding=2, noise_scale=1.0))
    scale = privacy.min_noise_scale_for(code, 0.01)
    code2 = SPACDCCode(SPACDCConfig(12, 4, 2, noise_scale=scale))
    assert privacy.gaussian_mi_bound(code2).max() <= 0.01 * 1.01


def test_empirical_leakage_shrinks():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    weak = SPACDCCode(SPACDCConfig(8, 2, 1, noise_scale=0.3))
    strong = SPACDCCode(SPACDCConfig(8, 2, 1, noise_scale=30.0))
    lw = privacy.empirical_leakage(weak, x, torch.Generator().manual_seed(0),
                                   n_trials=48)
    ls = privacy.empirical_leakage(strong, x,
                                   torch.Generator().manual_seed(0),
                                   n_trials=48)
    assert 0.0 <= ls < lw <= 1.0 + 1e-6


# --------------------------------------------------------------------------
# the card: a training step through the kernels against the plain versions
# --------------------------------------------------------------------------

def _smoke():
    """``chip_smoke.py``, whose training spec and error rules the card
    cases share."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scheme", ["spacdc", "conv", "mds", "matdot"])
def test_cuda_train_step_kernels_match_plain(cuda, scheme):
    """The Fig-3 apparatus (``chip_smoke.train_spec``: N=30, S=5; spacdc
    K=24 T=3, matdot p=12) at 784-512-10: one step through the kernels
    against the same step with the kernels forced off, loss within 1e-5
    relative; every ``berrut_combine`` call of the kernel step elementwise
    within float32's error bound of the plain version on the same inputs
    (``chip_smoke.combine_bound_ratio``); the weights within 1e-5 of max
    |w| on the fused round (spacdc, conv).  mds K=24 and matdot's 23
    points decode through Vandermonde inverses that amplify any float32
    rounding by ~1e6, so the two steps part there and each is held against
    the float64 step with the coded product exact
    (``chip_smoke.f64_rule``).  Neither may pick up TF32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    smoke = _smoke()
    xtr, ytr, _, _ = synthetic_mnist(n_train=256, n_test=8, seed=0)
    xtr, ytr = torch.from_numpy(xtr).to(cuda), torch.from_numpy(ytr).to(cuda)
    out, ratios = [], []
    for sp in (smoke.train_spec(scheme),
               smoke.train_spec(scheme, use_kernel=False)):
        with Session(sp, device=cuda) as s:
            s.init_mlp((784, 512, 10), lr=0.05, seed=0)
            if not out:
                smoke.hold_combines(torch, s.engine.scheme, ratios)
            loss, _ = s.train_step(xtr, ytr)
            out.append((loss, [w.clone() for w in s.mlp_weights],
                        s.round_stats[-1]))
    (lk, wk, sk), (lp, wp, spl) = out
    assert sk.dispatches > 0 and spl.dispatches == 0
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    assert len(ratios) == smoke.ROUND_LAUNCHES[scheme]["berrut_combine"]
    assert max(ratios) <= 1.0, ratios
    if scheme in ("spacdc", "conv"):
        for a, b in zip(wk, wp):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        return
    rule = smoke.f64_rule(torch, wk, wp, smoke.exact_first_step(
        torch, cuda, (784, 512, 10), (xtr, ytr)))
    assert rule["holds"], rule
