"""The port's adaptive redundancy controller (``repro_torch.runtime.
adaptive``) and the engine's retuning against the JAX package, on the CPU.

The estimator, ``predict_wait``, the candidate space and the controller
are host numpy in both packages, so for the same arrival records their
fits and decisions are equal, not close.  In whole sessions two inputs
are made equal first: the per-worker compute time of both virtual clocks
is fixed to one constant (it enters every arrival and the controller's
compute term), and the port's SPACDC noise is the reference's JAX draw
(``jax_noise``; every candidate scheme draws its own).  Then every
decision, fit, responder mask and health record must match exactly;
outputs within 1e-4 of max |reference|; a decision's
``predicted_rel_err`` (an error-profile value, float32 decode weights in
another summation order) within 1e-3 relative plus 1e-5: below that an
exact decode's profile is float32 rounding amplified by the float32
``pinv`` each library computes its own way.

Threads: the reference's virtual-vs-threads test compares fits from real
thread arrivals with the virtual clock's, which a loaded host breaks (a
few ms of lag moves a quantized delay across the grid).  The port holds
the property it is after, deterministically: a virtual run fed the
threads run's own consumed arrivals decides exactly as the threads run.

The ``cuda`` case runs an adaptive session through the kernels against
the same session with the kernels forced off, on the same measured
compute time.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.api import (AdaptiveSpec, ClusterSpec, CodeSpec, Session,
                             StragglerSpec)
from repro_torch.core import registry
from repro_torch.core.spacdc import SPACDCCode
from repro_torch.runtime import observed_delays
from repro_torch.runtime.adaptive import (AdaptiveController,
                                          OnlineStragglerEstimator,
                                          error_profile, predict_wait)
from repro_torch.runtime.engine import RoundEngine
from repro_torch.runtime.straggler import (DEFAULT_SHIFT_REGIMES,
                                           StragglerModel)

OUT_TOL = 1e-4
T_COMP_S = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fixed_clock(monkeypatch):
    from repro.runtime import engine as ref_engine
    for cls in (ref_engine.RoundEngine, RoundEngine):
        monkeypatch.setattr(cls, "_worker_compute_time",
                            lambda self, lhs, rhs: T_COMP_S)


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's SPACDC noise blocks drawn as the reference draws them
    (``jax.random.normal(PRNGKey(seed))`` × ``noise_scale``)."""
    import jax
    import jax.numpy as jnp

    def make_noise(self, block_shape, dtype=torch.float32, device="cpu"):
        cfg = self.cfg
        shape = (cfg.t_colluding,) + tuple(block_shape)
        if cfg.t_colluding == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        n = cfg.noise_scale * jax.random.normal(
            jax.random.PRNGKey(cfg.seed), shape)
        return torch.from_numpy(np.array(n.astype(jnp.float32))).to(
            device=device, dtype=dtype)
    monkeypatch.setattr(SPACDCCode, "make_noise", make_noise)


def _feed(model, ests, rounds, t_comp=0.001, start=0):
    """Feed a StragglerModel's trace to every estimator in ``ests``,
    shaped as the (t, worker) arrival records a round produces."""
    for r in range(start, start + rounds):
        d = model.delays(r)
        arr = sorted((float(d[w]) + t_comp, w)
                     for w in range(model.n_workers))
        for est in ests:
            est.observe(r, arr)


def _ref_estimator(*args, **kw):
    from repro.runtime.adaptive import OnlineStragglerEstimator as RefEst
    return RefEst(*args, **kw)


def _mats(seed=0, m=32, d=16, q=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((d, q)).astype(np.float32))


def _same_decisions(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        gp, wp = g.pop("predicted_rel_err"), w.pop("predicted_rel_err")
        assert g == w
        assert (gp is None) == (wp is None)
        if gp is not None:
            assert abs(gp - wp) <= 1e-3 * abs(wp) + 1e-5, (gp, wp)


# -------------------------------------------------------- spec validation

@pytest.mark.parametrize("bad", [
    dict(p_fail=1.5), dict(p_recover=-0.1), dict(pareto_shape=1.0),
    dict(pareto_shape=0.5), dict(regime_len=0),
    dict(regimes=((0.1, 2.0),)), dict(regimes=((0.1,),))])
def test_straggler_spec_rejects_bad_params(bad):
    with pytest.raises(ValueError):
        StragglerSpec(**bad)
    with pytest.raises(ValueError):
        StragglerModel(8, 2, **bad)


@pytest.mark.parametrize("bad", [
    dict(policy="sometimes"), dict(target_rel_err=0.0),
    dict(retune_every=0), dict(warmup_rounds=-1),
    dict(min_redundancy=0), dict(min_redundancy=4, max_redundancy=2),
    dict(window=2), dict(cp_window=1), dict(window=8, cp_window=5),
    dict(cp_threshold=0.0), dict(quantize_s=0.0),
    dict(latency_budget_s=-1.0)])
def test_adaptive_spec_rejects_bad_params(bad):
    with pytest.raises(ValueError):
        AdaptiveSpec(**bad)


def test_adaptive_spec_json_roundtrip_across_packages():
    import repro.api as ref_api
    kw = dict(policy="adaptive", target_rel_err=0.05, latency_budget_s=0.02,
              retune_every=3, max_redundancy=6, quantize_s=5e-3)
    ad = AdaptiveSpec(**kw)
    assert ad.enabled and not AdaptiveSpec().enabled
    assert AdaptiveSpec.from_dict(json.loads(json.dumps(ad.to_dict()))) == ad
    assert ref_api.AdaptiveSpec(**kw).to_dict() == ad.to_dict()
    spec = ClusterSpec(code=CodeSpec(n_workers=12, k_blocks=4), adaptive=ad,
                       seed=3)
    assert ClusterSpec.from_dict(json.loads(spec.to_json())).adaptive == ad


def test_validate_rejects_pair_coded_and_bad_bounds():
    ad = AdaptiveSpec(policy="adaptive")
    with pytest.raises(ValueError, match="pair-coded"):
        ClusterSpec(code=CodeSpec(scheme="polynomial", n_workers=12,
                                  k_blocks=4, extra={"p": 2, "q": 2}),
                    adaptive=ad).validate()
    with pytest.raises(ValueError, match="max_redundancy"):
        ClusterSpec(code=CodeSpec(n_workers=8, k_blocks=4),
                    adaptive=AdaptiveSpec(policy="adaptive",
                                          max_redundancy=8)).validate()


def test_shifting_markov_schedule_default_regimes_and_delays():
    from repro.runtime.straggler import StragglerModel as RefModel
    kw = dict(delay_s=0.05, jitter_scale=1e-4, seed=4,
              mode="shifting_markov", regimes=((0.0, 1.0), (1.0, 0.0)),
              regime_len=4)
    m, ref = StragglerModel(8, 2, **kw), RefModel(8, 2, **kw)
    assert [m.regime_at(r) for r in (0, 3, 4, 7, 8)] == [0, 0, 1, 1, 0]
    assert (m.delays(2) < 0.01).all() and (m.delays(6) >= 0.05).all()
    for r in range(10):
        np.testing.assert_array_equal(m.delays(r), ref.delays(r))
    assert StragglerModel(8, 2, mode="shifting_markov").regimes == \
        DEFAULT_SHIFT_REGIMES
    assert StragglerSpec(n_stragglers=2, mode="shifting_markov",
                         regime_len=8).build(8, seed=0).regimes == \
        DEFAULT_SHIFT_REGIMES


# ------------------------------------------------------ observed delays

@pytest.mark.parametrize("arrivals,n,q", [
    ([(0.0101, 1), (0.0302, 3), (0.0118, 0)], 5, 5e-3),
    ([], 3, 1e-3),
    ([(0.5, 0), (0.5, 1), (0.531, 2), (0.5149, 7)], 8, 1e-3)])
def test_observed_delays_match_reference(arrivals, n, q):
    from repro.runtime import observed_delays as ref_obs
    got, want = observed_delays(arrivals, n, q), ref_obs(arrivals, n, q)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ estimator recovery

@pytest.mark.parametrize("mode,kw,check", [
    ("markov", dict(p_fail=0.1, p_recover=0.5),
     lambda fm: fm.mode == "markov" and abs(fm.p_fail - 0.1) < 0.08
     and abs(fm.p_recover - 0.5) < 0.25 and abs(fm.delay_s - 0.03) < 0.015),
    ("paper", dict(),
     lambda fm: fm.mode == "paper" and abs(fm.congested_frac - 0.25) < 0.1),
    ("pareto", dict(pareto_shape=1.5),
     lambda fm: fm.mode == "pareto" and abs(fm.pareto_shape - 1.5) < 0.6)])
def test_estimator_fits_match_reference(mode, kw, check):
    seed = {"markov": 3, "paper": 5, "pareto": 7}[mode]
    m = StragglerModel(16, 4, delay_s=0.03, jitter_scale=0.002, seed=seed,
                       mode=mode, **kw)
    port = OnlineStragglerEstimator(16, window=64)
    ref = _ref_estimator(16, window=64)
    _feed(m, (port, ref), 48)
    assert port.fitted().to_dict() == ref.fitted().to_dict()
    assert check(port.fitted())
    lats = np.where(np.arange(16) % 5 == 0, np.nan,
                    np.linspace(0.001, 0.05, 16))
    assert port.fitted(lats).to_dict() == ref.fitted(lats).to_dict()


def test_change_point_detected_within_bound():
    calm = StragglerModel(16, 2, delay_s=0.01, jitter_scale=0.001, seed=9,
                          mode="markov", p_fail=0.02, p_recover=0.8)
    hot = StragglerModel(16, 10, delay_s=0.05, jitter_scale=0.001, seed=9,
                         mode="markov", p_fail=0.5, p_recover=0.1)
    port = OnlineStragglerEstimator(16, window=64, cp_window=6)
    ref = _ref_estimator(16, window=64, cp_window=6)
    _feed(calm, (port, ref), 16)
    assert port.change_points == [] == ref.change_points
    _feed(hot, (port, ref), 16, start=16)
    assert port.change_points == ref.change_points
    assert 16 <= min(port.change_points) <= 16 + 2 * 6
    assert port.fitted().delay_s > 0.025
    assert port.fitted().to_dict() == ref.fitted().to_dict()


def test_predict_wait_matches_reference():
    from repro.runtime.adaptive import predict_wait as ref_predict
    for mode, kw in (("markov", dict(p_fail=0.1, p_recover=0.5)),
                     ("pareto", dict(pareto_shape=1.5))):
        m = StragglerModel(16, 4, delay_s=0.03, jitter_scale=0.002, seed=3,
                           mode=mode, **kw)
        port, ref = OnlineStragglerEstimator(16), _ref_estimator(16)
        _feed(m, (port, ref), 32)
        fm, rfm = port.fitted(), ref.fitted()
        waits = [predict_wait(fm, p, 16) for p in range(1, 17)]
        assert waits == [ref_predict(rfm, p, 16) for p in range(1, 17)]
        assert all(b >= a for a, b in zip(waits, waits[1:]))
    assert waits[-1] > 10 * waits[3] or fm.mode == "pareto"


# --------------------------------------------------------- error profiles

@pytest.mark.parametrize("name,kw", [
    ("spacdc", dict(n_workers=12, k_blocks=4, t_colluding=1,
                    noise_scale=0.01, seed=0)),
    ("lcc", dict(n_workers=12, k_blocks=4, t_colluding=1, deg_f=2,
                 noise_scale=0.01, seed=0)),
    ("glcc", dict(n_workers=12, k_blocks=4, n_groups=2, t_colluding=1)),
    ("bacc", dict(n_workers=12, k_blocks=4)),
    ("mds", dict(n_workers=12, k_blocks=4))])
def test_error_profile_matches_reference(jax_noise, name, kw):
    from repro.core import registry as ref_registry
    from repro.runtime.adaptive import error_profile as ref_profile
    got = error_profile(registry.build(name, **kw))
    want = ref_profile(ref_registry.build(name, **kw))
    assert got.shape == (12,)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=1e-5)
    if name == "spacdc":
        assert np.isfinite(got).all() and got[-1] < 0.2 and got[0] > got[-1]
    if name == "lcc":
        thr = registry.build(name, **kw).recovery_threshold
        assert np.isinf(got[: thr - 1]).all() and (got[thr - 1:] < 1e-4).all()


# ------------------------------------------------------------- controller

def _controllers(scheme="spacdc", n=12, k=6, **ad_over):
    """(port, reference) controllers over the same candidate builder."""
    import repro.api as ref_api
    from repro.core import registry as ref_registry
    from repro.runtime.adaptive import AdaptiveController as RefCtl
    ad_kw = dict(policy="adaptive", target_rel_err=0.2, warmup_rounds=4,
                 retune_every=2, max_candidates=4)
    ad_kw.update(ad_over)
    cfg = dict(spacdc=dict(t_colluding=1, noise_scale=0.01, seed=0),
               glcc=dict(t_colluding=1, deg_f=2, noise_scale=0.01,
                         seed=0))[scheme]

    def builder(reg):
        return lambda **ov: reg.build(
            scheme, n_workers=n, **{**cfg, "k_blocks": k, **ov})
    port_b, ref_b = builder(registry), builder(ref_registry)
    return (AdaptiveController(AdaptiveSpec(**ad_kw), n, port_b(), port_b,
                               seed=0),
            RefCtl(ref_api.AdaptiveSpec(**ad_kw), n, ref_b(), ref_b, seed=0))


def _drive(ctls, rounds, health=None):
    m = StragglerModel(12, 4, delay_s=0.04, jitter_scale=0.001, seed=2,
                       mode="markov", p_fail=0.3, p_recover=0.2)
    decided = [[] for _ in ctls]
    for r in range(rounds):
        d = m.delays(r)
        arr = sorted((float(d[w]) + 0.001, w) for w in range(12))
        for i, ctl in enumerate(ctls):
            ctl.observe(r, arr, k_blocks=6)
            if ctl.maybe_decide(r, health=health) is not None:
                decided[i].append(r)
    return decided


def test_controller_decisions_match_reference(jax_noise):
    port, ref = _controllers()
    assert port.candidates == ref.candidates
    decided = _drive((port, ref), 12)
    assert decided[0] == decided[1] == [3, 5, 7, 9, 11]
    _same_decisions([d.to_dict() for d in port.decisions],
                    [d.to_dict() for d in ref.decisions])
    dec = port.decisions[-1]
    assert dec.policy == "first_k" and 1 <= dec.wait_for <= 12
    assert type(port.policy_for(dec)).__name__ == "FirstK"
    assert port.scheme_for(dec).k_blocks == dec.k_blocks
    rp, rr = port.report(), ref.report()
    assert rp["fitted"] == rr["fitted"] and rp["candidates"] == \
        rr["candidates"]


def test_controller_latency_budget_falls_back_to_deadline(jax_noise):
    port, ref = _controllers(latency_budget_s=1e-6)
    _drive((port, ref), 6)
    dec = port.decisions[-1]
    assert dec.policy == "deadline"
    assert dec.policy_params["t_budget"] == pytest.approx(1e-6)
    assert type(port.policy_for(dec)).__name__ == "Deadline"
    _same_decisions([d.to_dict() for d in port.decisions],
                    [d.to_dict() for d in ref.decisions])


@pytest.mark.parametrize("over", [
    dict(min_redundancy=2, max_redundancy=6, max_candidates=3),
    dict(max_candidates=6), dict(min_redundancy=5)])
def test_controller_candidates_match_reference(over):
    port, ref = _controllers(**over)
    assert port.candidates == ref.candidates
    ks = [c["k_blocks"] for c in port.candidates]
    assert all(12 - (over.get("max_redundancy") or 11) <= k
               <= 12 - over.get("min_redundancy", 1) for k in ks)
    assert len(ks) <= over["max_candidates"] if "max_candidates" in over \
        else True


def test_controller_sweeps_glcc_groups():
    port, ref = _controllers("glcc", k=4, target_rel_err=0.2)
    groups = sorted(c["n_groups"] for c in port.candidates
                    if "n_groups" in c)
    assert groups == [1, 2, 4]
    assert port.candidates == ref.candidates


# ----------------------------------------------- sessions: retune + report

_AD = dict(policy="adaptive", target_rel_err=0.15, warmup_rounds=4,
           retune_every=2, max_candidates=4)


def _session_spec(api, backend="virtual", **over):
    kw = dict(
        code=api.CodeSpec(scheme="spacdc", n_workers=12, k_blocks=6),
        privacy=api.PrivacySpec(t_colluding=1, noise_scale=0.01),
        straggler=api.StragglerSpec(n_stragglers=3, mode="shifting_markov",
                                    delay_s=0.02, jitter_scale=0.001,
                                    regime_len=6),
        transport=api.TransportSpec(backend=backend),
        adaptive=api.AdaptiveSpec(**_AD), seed=13)
    kw.update(over)
    return api.ClusterSpec(**kw)


def _sessions_match(make, rounds):
    """Run ``make(api)`` in both packages; every round's plan and scheme
    equal, outputs within OUT_TOL; returns both reports."""
    import repro.api as ref_api
    import repro_torch.api as port_api
    a, b = _mats()
    with ref_api.Session(make(ref_api)) as rs, \
            Session(make(port_api), device="cpu") as ps:
        for _ in range(rounds):
            want, wst = rs.matmul(a, b)
            got, gst = ps.matmul(a, b)
            assert ps.engine.k == rs.engine.k
            assert ps.engine._scheme_token == rs.engine._scheme_token
            assert ps.engine.use_fused == rs.engine.use_fused
            assert gst.policy == wst.policy
            assert gst.decode_mask == wst.decode_mask
            assert gst.arrivals == wst.arrivals
            assert gst.n_waited == wst.n_waited
            assert float(np.max(np.abs(got.numpy() - want))) <= \
                OUT_TOL * float(np.max(np.abs(want)))
        return ps.adaptive_report(), rs.adaptive_report()


def _same_reports(got, want):
    got, want = dict(got), dict(want)
    _same_decisions(got.pop("decisions"), want.pop("decisions"))
    assert got == want
    json.dumps(got)


def test_session_adaptive_matches_reference(fixed_clock, jax_noise):
    """24 rounds under a shifting trace on the fused round: the same
    retunes, schemes, masks, fits and health as the reference."""
    got, want = _sessions_match(_session_spec, 24)
    _same_reports(got, want)
    assert got["decisions"] and got["rounds_run"] == 24
    assert {d["k_blocks"] for d in got["decisions"]} != {6}


def test_session_adaptive_glcc_loop_round_matches_reference(fixed_clock):
    """GLCC (numpy-drawn noise, the loop round): the controller sweeps
    ``n_groups`` beside K, in step with the reference."""
    def make(api):
        return _session_spec(api, code=api.CodeSpec(
            scheme="glcc", n_workers=12, k_blocks=4,
            extra={"deg_f": 1}), privacy=api.PrivacySpec(t_colluding=1,
                                                         noise_scale=0.01))
    got, want = _sessions_match(make, 12)
    _same_reports(got, want)
    assert any("n_groups" in c for c in got["candidates"])


def test_adaptive_report_shapes_and_fixed_policy(fixed_clock):
    import repro_torch.api as api
    a, b = _mats()
    with Session(_session_spec(api), device="cpu") as s:
        for _ in range(10):
            out, _ = s.matmul(a, b)
            assert torch.isfinite(out).all()
        rep = s.adaptive_report()
        assert s.health is s.engine.health is not None
    assert rep["adaptive"] is True and rep["scheme"] == "spacdc"
    assert rep["rounds_run"] == 10 and rep["fitted"]["n_rounds"] > 0
    assert rep["decisions"]
    assert {"k_blocks", "policy", "fh_degree"} <= set(rep["active"])
    assert len(rep["health"]["workers"]) == 12
    json.dumps(rep)
    with Session(_session_spec(api, adaptive=AdaptiveSpec()),
                 device="cpu") as s:
        s.matmul(a, b)
        rep = s.adaptive_report()
        assert s.health is None
    assert rep["adaptive"] is False and rep["policy"] == "fixed"
    assert "health" not in rep
    json.dumps(rep)


def test_adaptive_threads_decisions_follow_their_arrivals():
    """Real threads (the loop round): a virtual-clock session fed the
    threads run's own consumed arrivals, round by round, fits and decides
    exactly as the threads run (the observations are quantized, so the
    transport cannot leak into the controller beyond its arrivals)."""
    import repro_torch.api as api
    a, b = _mats()
    kw = dict(
        code=CodeSpec(scheme="spacdc", n_workers=8, k_blocks=4),
        straggler=StragglerSpec(n_stragglers=2, mode="markov", delay_s=0.06,
                                jitter_scale=1e-4),
        adaptive=AdaptiveSpec(policy="adaptive", target_rel_err=0.2,
                              warmup_rounds=4, retune_every=2,
                              quantize_s=0.03))
    with Session(_session_spec(api, backend="threads", **kw),
                 device="cpu") as s:
        fed = [s.matmul(a, b)[1] for _ in range(12)]
        threads_rep = s.adaptive_report()
    virtual = dataclasses.replace(
        _session_spec(api, **kw),
        code=dataclasses.replace(kw["code"], fused=False))
    with Session(virtual, device="cpu") as s:
        eng = s.engine
        for r, st in enumerate(fed):
            eng._adaptive_retune(r)
            eng._matmul_inner(a, b, r)
            eng._adaptive_observe(r, st)
            s.round_stats.append(st)
        virtual_rep = s.adaptive_report()
    assert threads_rep["decisions"], "no decisions to compare"
    assert virtual_rep == threads_rep


def test_session_health_without_faults_or_controller_is_none():
    import repro_torch.api as api
    with Session(ClusterSpec(code=CodeSpec(n_workers=8, k_blocks=4)),
                 device="cpu") as s:
        assert s.health is None
    with Session(_session_spec(api), device="cpu") as s:
        assert s.health is not None and s.engine.adaptive is not None


# ------------------------------------------------------------ on the card

def test_cuda_adaptive_kernels_against_kernels_off(cuda):
    """An adaptive session through the kernels against the same session
    with the kernels forced off, the second engine reading the first
    one's measured compute times: the same decisions round by round, the
    outputs within OUT_TOL of max |plain|, one coded_matmul and one
    berrut_combine launch per fused round."""
    import repro_torch.api as api
    from repro_torch.kernels import _build
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn((96, 64), generator=gen, device=cuda)
    b = torch.randn((64, 48), generator=gen, device=cuda)
    spec = _session_spec(api)
    plain = dataclasses.replace(spec, code=dataclasses.replace(
        spec.code, use_kernel=False))
    with Session(spec, device=cuda) as sk, Session(plain, device=cuda) as sp:
        for _ in range(16):
            got, gst = sk.matmul(a, b)
            sp.engine._worker_t = dict(sk.engine._worker_t)
            want, wst = sp.matmul(a, b)
            torch.cuda.synchronize()
            assert sk.engine._scheme_token == sp.engine._scheme_token
            assert gst.decode_mask == wst.decode_mask
            assert gst.dispatches == 2 and wst.dispatches == 0
            err = float((got - want).abs().max())
            assert err <= OUT_TOL * float(want.abs().max())
        assert sk.adaptive_report()["decisions"] == \
            sp.adaptive_report()["decisions"]
    assert _build.build_count == 1
