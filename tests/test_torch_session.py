"""The slice as a whole: ``repro_torch.api.Session`` against
``repro.api.Session`` on the CPU.

Same spec, same inputs (numpy, from a seed), the reference's noise handed
in: the outputs must agree to 1e-4 relative to their max |value| (float32
rounds through different libraries, and the Berrut decode weights sum
terms of both signs), and the round's plan must be exactly equal —
responders, decode mask, policy and the arrival order of the workers.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro_torch.api as port_api
from repro_torch.api import ClusterSpec, Session

OUT_TOL = 1e-4
JOBS = [("fig3_backprop", 512, 10, 256), ("fig3_wide", 1536, 256, 512)]


def _presets(api):
    c = api.ClusterSpec
    return [c.paper_fig3(), c.paper_fig3(n_stragglers=0), c.anytime_bench(),
            c.serve_deadline(), c.serve_deadline(backend="threads"), c(),
            c(code=api.CodeSpec(n_workers=12, k_blocks=3, use_kernel=False),
              straggler=api.StragglerSpec(n_stragglers=2, mode="markov"),
              wait=api.WaitSpec(policy="first_k", k=9), seed=7,
              pipeline_encode=True)]


@pytest.mark.parametrize("job", JOBS, ids=[j[0] for j in JOBS])
def test_session_matches_reference_round_for_round(job):
    import repro.api as ref_api
    _, m, d, n_out = job
    ref_spec = ref_api.ClusterSpec.paper_fig3()
    spec = ClusterSpec.from_dict(ref_spec.to_dict())
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((d, n_out)).astype(np.float32)
    with ref_api.Session(ref_spec) as rs, Session(spec, device="cpu") as ps:
        noise = np.asarray(rs.engine.scheme.make_noise((-(-m // 24), d)))
        for _ in range(3):
            want, wst = rs.matmul(a, b)
            got, gst = ps.matmul(a, b, noise=noise)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert tuple(got.shape) == (m, n_out)
            rel = float(np.max(np.abs(got.numpy() - want)) /
                        np.max(np.abs(want)))
            assert rel <= OUT_TOL, rel
            assert gst.n_waited == wst.n_waited == 23
            assert gst.decode_mask == wst.decode_mask
            assert gst.policy == wst.policy
            assert [w for _, w in gst.arrivals] == \
                [w for _, w in wst.arrivals]
            assert gst.decode_s == wst.decode_s == 0.0
            assert gst.dispatches == 0      # the CPU runs the plain versions
    assert len(ps.round_stats) == 3


def test_every_preset_loads_in_both_packages():
    import repro.api as ref_api
    for ref_spec, port_spec in zip(_presets(ref_api), _presets(port_api)):
        d = ref_spec.to_dict()
        assert port_spec.to_dict() == d
        assert ClusterSpec.from_dict(d) == port_spec
        assert ref_api.ClusterSpec.from_dict(port_spec.to_dict()) == ref_spec
        assert ClusterSpec.from_json(ref_spec.to_json()) == port_spec


def test_spec_has_no_device_field():
    assert "device" not in ClusterSpec().to_dict()
    with pytest.raises(ValueError, match="unknown key"):
        ClusterSpec.from_dict({"device": "cuda"})


def test_session_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(ClusterSpec.paper_fig3())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(ClusterSpec.paper_fig3(), device="cuda")
    assert Session(ClusterSpec.paper_fig3(), device="cpu").device.type == \
        "cpu"


def _fault_and_adaptive_specs(api):
    base = dict(code=api.CodeSpec(n_workers=8, k_blocks=4))
    return {
        "fault": api.ClusterSpec(fault=api.FaultSpec(
            handle=True, crash_rate=0.1, corrupt_rate=0.1), **base),
        "adaptive": api.ClusterSpec(adaptive=api.AdaptiveSpec(
            policy="adaptive", warmup_rounds=2, retune_every=1), **base),
    }


@pytest.mark.parametrize("path", ["adaptive", "fault"])
def test_fault_and_adaptive_paths_match_reference(monkeypatch, path):
    """The paths that raised until the fault and adaptive slice: the same
    spec in both packages, the per-worker compute time fixed to one
    constant in both, gives the same responders, retries, exclusions and
    decisions, and outputs within OUT_TOL."""
    import repro.api as ref_api
    from repro.runtime import engine as ref_engine
    from repro_torch.runtime.engine import RoundEngine
    for cls in (ref_engine.RoundEngine, RoundEngine):
        monkeypatch.setattr(cls, "_worker_compute_time",
                            lambda self, lhs, rhs: 1e-3)
    ref_spec = _fault_and_adaptive_specs(ref_api)[path]
    spec = _fault_and_adaptive_specs(port_api)[path]
    assert spec.to_dict() == ref_spec.to_dict()
    rng = np.random.default_rng(8)
    a = rng.standard_normal((32, 6)).astype(np.float32)
    b = rng.standard_normal((6, 5)).astype(np.float32)
    with ref_api.Session(ref_spec) as rs, Session(spec, device="cpu") as ps:
        for _ in range(5):
            want, wst = rs.matmul(a, b)
            got, gst = ps.matmul(a, b)
            rel = float(np.max(np.abs(got.numpy() - want)) /
                        np.max(np.abs(want)))
            assert rel <= OUT_TOL, rel
            assert gst.decode_mask == wst.decode_mask
            assert (gst.retries, gst.excluded, gst.degraded) == \
                (wst.retries, wst.excluded, wst.degraded)
            assert gst.arrivals == wst.arrivals
        assert ps.health.snapshot() == rs.health.snapshot()
        got_rep, want_rep = ps.adaptive_report(), rs.adaptive_report()
    for rep in (got_rep, want_rep):
        for d in rep.get("decisions", ()):
            d.pop("predicted_rel_err")
    assert got_rep == want_rep


def _anytime_and_thread_specs():
    api = port_api
    base = dict(code=api.CodeSpec(n_workers=8, k_blocks=4))
    target = api.WaitSpec(policy="error_target", eps=0.1)
    return {
        "error_target": ClusterSpec(wait=target, **base),
        "encrypt_real_error_target": ClusterSpec(
            crypto=api.CryptoSpec(encrypt="real"), wait=target, **base),
        "threads": ClusterSpec(transport=api.TransportSpec(backend="threads"),
                               **base),
    }


@pytest.mark.parametrize("path", sorted(_anytime_and_thread_specs()))
def test_ported_anytime_and_thread_paths_run(path):
    """Once "still unported" cases: the ErrorTarget round (plain and over
    the real MEA-ECC wire, bit-identical) and the threads transport run.
    Their parity with the reference is ``tests/test_torch_anytime.py``'s."""
    a = np.arange(24, dtype=np.float32).reshape(8, 3) / 7
    b = np.ones((3, 2), np.float32)
    spec = _anytime_and_thread_specs()[path]
    with Session(spec, device="cpu") as s:
        got, st = s.matmul(a, b, round_idx=0)
    assert tuple(got.shape) == (8, 2) and bool(torch.isfinite(got).all())
    assert 1 <= st.n_waited <= 8
    if path == "threads":
        assert not s.engine.use_fused and st.decode_s > 0.0
        assert st.policy == "fixed_quantile" and st.n_waited == 8
        return
    assert st.policy == "error_target" and s.engine.use_fused
    plain = _anytime_and_thread_specs()["error_target"]
    with Session(plain, device="cpu") as sp:
        want, wst = sp.matmul(a, b, round_idx=0)
    assert torch.equal(got, want) and st.n_waited == wst.n_waited
    assert (st.crypto_s > 0.0) == (path == "encrypt_real_error_target")


def test_ported_session_anytime_curve_runs():
    """Once a "still unported" method: ``Session.anytime_curve`` gives one
    point per worker, in arrival order, with a non-increasing envelope."""
    a = np.linspace(-1, 1, 48, dtype=np.float32).reshape(16, 3)
    with Session(ClusterSpec(), device="cpu") as s:
        pts = s.anytime_curve(a, np.ones((3, 2), np.float32), round_idx=2)
    n = ClusterSpec().code.n_workers
    assert [p.n_responders for p in pts] == list(range(1, n + 1))
    assert [p.t_s for p in pts] == sorted(p.t_s for p in pts)
    assert all(p.ready and np.isfinite(p.rel_err) for p in pts)
    best = [p.best_err for p in pts]
    assert all(b2 <= b1 for b1, b2 in zip(best, best[1:]))


def _loop_spec(**crypto):
    return ClusterSpec(code=port_api.CodeSpec(n_workers=8, k_blocks=4,
                                              fused=False),
                       crypto=port_api.CryptoSpec(**crypto))


@pytest.mark.parametrize("path", ["loop_round", "encrypt_real_loop_round"])
def test_ported_loop_round_paths_run(path):
    """Once "still unported" cases: the loop round runs, plain and with the
    real MEA-ECC wire, and the encrypted round's output is the plain
    round's, bit for bit."""
    a = np.arange(24, dtype=np.float32).reshape(8, 3) / 7
    b = np.ones((3, 2), np.float32)
    with Session(_loop_spec(), device="cpu") as s:
        want, wst = s.matmul(a, b, round_idx=0)
    spec = _loop_spec(encrypt="real", fused=False) \
        if path == "encrypt_real_loop_round" else _loop_spec()
    with Session(spec, device="cpu") as s:
        assert not s.engine.use_fused
        got, st = s.matmul(a, b, round_idx=0)
    assert torch.equal(got, want)
    assert tuple(got.shape) == (8, 2) and st.decode_s > 0.0
    assert st.n_waited == wst.n_waited
    assert (st.crypto_s > 0.0) == (path == "encrypt_real_loop_round")


@pytest.mark.parametrize("method", ["init_mlp", "train_step"])
def test_ported_session_training_methods_run(method):
    """Once "still unported" cases: ``init_mlp`` builds the state on the
    session's device, and ``train_step`` then returns a finite loss."""
    with Session(ClusterSpec(), device="cpu") as s:
        assert s.init_mlp((4, 3, 2), seed=0) is s
        assert all(w.device.type == "cpu" for w in s.mlp_weights)
        if method == "train_step":
            x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(6, 4)
            loss, elapsed = s.train_step(x, np.arange(6) % 2)
            assert np.isfinite(loss) and elapsed > 0
            assert len(s.round_stats) == 1


def test_lifecycle_round_counter_and_pipelining():
    spec = dataclasses.replace(ClusterSpec(), pipeline_encode=True)
    s = Session(spec, device="cpu")
    a, b = np.ones((9, 5), np.float32), np.ones((5, 4), np.float32)
    out, st0 = s.matmul(a, b)
    _, st1 = s.matmul(a, b)
    assert tuple(out.shape) == (9, 4) and bool(torch.isfinite(out).all())
    assert st0.pipelined_s == 0.0 and st1.pipelined_s >= 0.0
    assert st0.arrivals != st1.arrivals          # a new straggler draw
    _, replay = s.matmul(a, b, round_idx=0)
    assert replay.arrivals[0][1] == st0.arrivals[0][1]
    s.close()
    s.close()                                    # idempotent
    assert s.closed
    with pytest.raises(RuntimeError, match="closed"):
        s.matmul(a, b)
    assert json.dumps(ClusterSpec().to_dict())
