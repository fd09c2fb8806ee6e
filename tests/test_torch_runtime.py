"""The port's host runtime (``repro_torch.runtime``) against the JAX package.

These modules are numpy in both packages, so parity is exact: straggler
delays, arrival timelines, responder sets and masks must be equal, not
close.
"""

import numpy as np
import pytest

from repro_torch.runtime import scheduler, straggler, transport, wait_policy
from repro_torch.core.spacdc import SPACDCCode, SPACDCConfig

MODES = ["paper", "pareto", "markov", "shifting_markov"]
ROUNDS = range(20)


def _models(mode, n=30, s=7, seed=3):
    from repro.runtime.straggler import StragglerModel as RefModel
    kw = dict(delay_s=0.02, jitter_scale=0.002, seed=seed, mode=mode,
              regime_len=5)
    return (straggler.StragglerModel(n, s, **kw), RefModel(n, s, **kw))


@pytest.mark.parametrize("mode", MODES)
def test_straggler_delays_are_identical(mode):
    port, ref = _models(mode)
    for r in ROUNDS:
        np.testing.assert_array_equal(port.delays(r), ref.delays(r))
        np.testing.assert_array_equal(port.responder_mask(r, 23),
                                      ref.responder_mask(r, 23))
        assert port.regime_at(r) == ref.regime_at(r)


def test_straggler_validation_matches():
    from repro.runtime.straggler import StragglerModel as RefModel
    for bad in (dict(mode="nope"), dict(p_fail=1.5), dict(pareto_shape=1.0),
                dict(regime_len=0), dict(delay_s=-1.0)):
        with pytest.raises(ValueError):
            RefModel(8, 2, **bad)
        with pytest.raises(ValueError):
            straggler.StragglerModel(8, 2, **bad)


def _policies():
    from repro.runtime import wait_policy as rw
    return [(wait_policy.FixedQuantile(), rw.FixedQuantile()),
            (wait_policy.FirstK(5), rw.FirstK(5)),
            (wait_policy.Deadline(0.004), rw.Deadline(0.004))]


@pytest.mark.parametrize("mode", MODES)
def test_plan_round_is_identical_over_20_rounds(mode):
    from repro.core.spacdc import SPACDCCode as RefCode, \
        SPACDCConfig as RefConfig
    from repro.runtime import scheduler as rs
    port_scheme = SPACDCCode(SPACDCConfig(30, 24, 3))
    ref_scheme = RefCode(RefConfig(30, 24, 3))
    port_model, ref_model = _models(mode)
    for port_pol, ref_pol in _policies():
        for r in ROUNDS:
            delays = ref_model.delays(r)
            got = scheduler.plan_round(port_scheme, port_pol,
                                       port_model.delays(r), 1e-3, 7)
            want = rs.plan_round(ref_scheme, ref_pol, delays, 1e-3, 7)
            assert got.stop == want.stop
            assert got.wait_s == want.wait_s
            np.testing.assert_array_equal(got.responders, want.responders)
            np.testing.assert_array_equal(got.mask, want.mask)
            assert got.mask.dtype == want.mask.dtype
            np.testing.assert_array_equal(got.arrival_order,
                                          want.arrival_order)
            assert [(e.t, e.worker) for e in got.events] == \
                [(e.t, e.worker) for e in want.events]


def test_policies_resolve_like_the_reference():
    from repro.runtime import wait_policy as rw
    for name in ("fixed", "fixed_quantile", None):
        assert type(wait_policy.resolve_policy(name)).__name__ == \
            type(rw.resolve_policy(name)).__name__
    with pytest.raises(KeyError):
        wait_policy.resolve_policy("deadline")
    assert wait_policy.ErrorTarget(0.1).needs_proxy
    with pytest.raises(ValueError, match="needs a proxy_fn"):
        scheduler.plan_round(SPACDCCode(SPACDCConfig(8, 4)),
                             wait_policy.ErrorTarget(0.1), np.zeros(8), 0.0, 0)


def test_virtual_timeline_and_transport():
    from repro.runtime import transport as rt
    delays = np.random.default_rng(0).exponential(0.002, 12)
    assert [(e.t, e.worker) for e in transport.virtual_timeline(
        delays, 5e-4)] == [(e.t, e.worker)
                           for e in rt.virtual_timeline(delays, 5e-4)]
    model = straggler.StragglerModel(6, 2, seed=1)
    calls = []
    tr = transport.VirtualClockTransport(model)
    handle = tr.submit_round(list(range(6)), lambda x: calls.append(x) or x,
                             0, t_compute=1e-3)
    drained = [e.worker for _, e in zip(range(3), handle.events())]
    assert [handle.result(w) for w in drained] == drained
    assert sorted(calls) == sorted(drained)       # only drained work ran
    assert handle.finish() == 0.0


def test_transport_backends_are_the_references():
    from repro.runtime import transport as rt
    assert transport.available_backends() == rt.available_backends()


def test_encode_pipeline_matches():
    from repro.runtime.scheduler import EncodePipeline as RefPipe
    port, ref = scheduler.EncodePipeline(), RefPipe()
    for enc, wait in [(0.002, 0.004), (0.006, 0.001), (0.003, 0.0),
                      (0.001, 0.01)]:
        assert port.charge(enc) == ref.charge(enc)
        port.credit(wait)
        ref.credit(wait)
