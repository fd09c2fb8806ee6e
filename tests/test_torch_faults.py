"""The port's fault layer (``repro_torch.runtime.faults``, screening, the
engine's fault round) against the JAX package's, on the CPU.

Same specs, same numpy inputs, the reference's JAX-drawn noise handed in
(``Session.matmul(..., noise=)``), and the per-worker compute time fixed
to one constant in both packages (the virtual clock adds it to every
arrival, so the health trackers' latencies and the retry timeouts are
then equal too).  Exact: fault plans, corrupted bytes (float results and
ciphertext limbs), exclusions, decode masks, retries, degraded flags,
health records.  Within float32's reach: outputs within 1e-4 of max
|reference| (the two packages contract in different orders), residual
scores within 1e-9 of the reference's (float64 throughout; the
leave-one-out products associate differently), a degraded round's
``achieved_rel_err`` within 1e-4 relative.

The ``cuda`` cases run the fault round on the card through the kernels
against the same round with the kernels forced off; they import no JAX
and skip without a card.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, CryptoSpec, FaultSpec,
                             PrivacySpec, Session, StragglerSpec,
                             TransportSpec, WaitSpec)
from repro_torch.core import registry
from repro_torch.runtime import (DegradedRoundError, FaultInjectingTransport,
                                 ResultDropped, ThreadTransport,
                                 VirtualClockTransport, WorkerHealth,
                                 plan_faults, screen_responders)
from repro_torch.runtime import faults
from repro_torch.runtime.engine import RoundEngine
from repro_torch.runtime.straggler import StragglerModel

OUT_TOL = 1e-4
SCORE_TOL = 1e-9
T_COMP_S = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fixed_clock(monkeypatch):
    """The per-worker compute time of both packages' virtual clocks set to
    one constant (each package otherwise times its own matmul)."""
    from repro.runtime import engine as ref_engine
    for cls in (ref_engine.RoundEngine, RoundEngine):
        monkeypatch.setattr(cls, "_worker_compute_time",
                            lambda self, lhs, rhs: T_COMP_S)


@pytest.fixture
def fixed_keys(monkeypatch):
    """The same key pairs in both packages: each engine draws its keys in
    the same order, here from one counter per package instead of the
    system's random source.  Tampered limbs decrypt to garbage that
    depends on the channel's keystream, so only equal keys give equal
    garbage (and so an equal eviction order)."""
    import itertools

    import repro.crypto as ref_crypto
    import repro_torch.crypto as port_crypto
    for mod in (ref_crypto, port_crypto):
        real = mod.generate_keypair
        sks = itertools.count(1001)
        monkeypatch.setattr(mod, "generate_keypair",
                            lambda *a, _r=real, _s=sks, **k:
                            _r(sk=next(_s)))


def _mats(seed=42, m=48, d=32, n_out=16):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((d, n_out)).astype(np.float32)
    return a, b


def _spec(api, **over):
    kw = dict(
        code=api.CodeSpec(scheme="spacdc", n_workers=24, k_blocks=4,
                          extra={"fh_degree": 3}),
        privacy=api.PrivacySpec(t_colluding=2, noise_scale=0.01),
        straggler=api.StragglerSpec(n_stragglers=3), seed=11)
    kw.update(over)
    return api.ClusterSpec(**kw)


def _both(make):
    """(reference spec, port spec) from ``make(api)``."""
    import repro.api as ref_api
    import repro_torch.api as port_api
    return make(ref_api), make(port_api)


def _ref_noise(ref_session, m, d):
    """The reference scheme's JAX-drawn (T, blk, d) noise, as numpy."""
    sch = ref_session.engine.scheme
    return np.asarray(sch.make_noise((-(-m // sch.k_blocks), d)))


def _rel(got, want) -> float:
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _same_round(gst, wst):
    assert gst.retries == wst.retries
    assert gst.excluded == wst.excluded
    assert gst.quarantined == wst.quarantined
    assert gst.degraded == wst.degraded
    assert gst.decode_mask == wst.decode_mask
    assert gst.n_waited == wst.n_waited
    assert gst.arrivals == wst.arrivals
    assert gst.compute_wait_s == pytest.approx(wst.compute_wait_s, rel=1e-12)


def _run_both(make, rounds, a=None, b=None):
    """Drive the same spec through both packages for ``rounds`` rounds;
    every round's plan must agree exactly and its output within OUT_TOL.
    Returns (reference session state, port session state) health
    snapshots and the last stats."""
    import repro.api as ref_api
    if a is None:
        a, b = _mats()
    ref_spec, port_spec = _both(make)
    with ref_api.Session(ref_spec) as rs, \
            Session(port_spec, device="cpu") as ps:
        noise = _ref_noise(rs, *a.shape)
        out = []
        for _ in range(rounds):
            want, wst = rs.matmul(a, b)
            got, gst = ps.matmul(a, b, noise=noise)
            assert got.device.type == "cpu" and gst.dispatches == 0
            _same_round(gst, wst)
            assert _rel(got, want) <= OUT_TOL
            out.append((gst, wst, got, want))
        snaps = (rs.health.to_dict() if rs.health else None,
                 ps.health.to_dict() if ps.health else None)
    return out, snaps


# ---------------------------------------------------------------- FaultSpec

def test_fault_spec_json_roundtrip_across_packages():
    import repro.api as ref_api
    fs = FaultSpec(crash_rate=0.1, corrupt_rate=0.05, corrupt_mode="bitflip",
                   handle=True, max_retries=3, seed=99)
    assert FaultSpec.from_dict(json.loads(json.dumps(fs.to_dict()))) == fs
    ref = ref_api.FaultSpec(crash_rate=0.1, corrupt_rate=0.05,
                            corrupt_mode="bitflip", handle=True,
                            max_retries=3, seed=99)
    assert ref.to_dict() == fs.to_dict()
    import repro_torch.api as port_api
    spec = _spec(port_api, fault=fs)
    assert ClusterSpec.from_dict(json.loads(spec.to_json())).fault == fs


@pytest.mark.parametrize("bad", [
    dict(crash_rate=1.5), dict(drop_rate=-0.1), dict(corrupt_mode="garbage"),
    dict(corrupt_scale=0.0), dict(max_retries=-1),
    dict(backoff_s=0.1, backoff_cap_s=0.01), dict(worker_timeout_s=0.0),
    dict(residual_threshold=0.0), dict(norm_factor=1.0),
    dict(quarantine_after=0)])
def test_fault_spec_rejects(bad):
    with pytest.raises(ValueError, match="fault:"):
        FaultSpec(**bad)


def test_cluster_validate_rejects_bad_fault_combos():
    import repro_torch.api as api
    fault = FaultSpec(handle=True)
    with pytest.raises(ValueError, match="pair-coded"):
        _spec(api, code=CodeSpec(scheme="polynomial", n_workers=8,
                                 k_blocks=4),
              privacy=PrivacySpec(), fault=fault).validate()
    with pytest.raises(ValueError, match="error_target"):
        _spec(api, wait=WaitSpec(policy="error_target", eps=1e-2),
              fault=fault).validate()
    with pytest.raises(ValueError, match="crypto.fused"):
        _spec(api, crypto=CryptoSpec(encrypt="real", fused=True),
              fault=fault).validate()


# ------------------------------------------------------------- determinism

@pytest.mark.parametrize("seed,round_idx", [(0, 0), (7, 3), (11, 499),
                                            (65535, 17), (3, 2_000_009)])
def test_plan_faults_match_reference(seed, round_idx):
    from repro.runtime.faults import plan_faults as ref_plan
    fault = FaultSpec(crash_rate=0.2, drop_rate=0.1, corrupt_rate=0.2,
                      delay_spike_rate=0.1, delay_spike_s=0.05)
    port, ref = plan_faults(fault, seed, round_idx, 16), \
        ref_plan(fault, seed, round_idx, 16)
    for f in ("crash", "drop", "corrupt", "spike_s"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.any_fault == ref.any_fault
    both = (port.crash & port.drop) | (port.crash & port.corrupt) | \
        (port.drop & port.corrupt)
    assert not both.any()


def test_plan_faults_vary_with_round_and_retry_indices_match():
    from repro.runtime.faults import retry_round_index as ref_retry
    fault = FaultSpec(crash_rate=0.3, corrupt_rate=0.3)
    crash_sets = {tuple(np.flatnonzero(plan_faults(fault, 7, r, 32).crash))
                  for r in range(20)}
    assert len(crash_sets) > 1
    from repro.runtime.straggler import StragglerModel as RefModel
    models = [(StragglerModel(12, 3, seed=2, mode=mode), RefModel(
        12, 3, seed=2, mode=mode)) for mode in ("paper", "pareto")]
    for r, att in ((0, 0), (0, 1), (5, 2), (41, 3)):
        rid = faults.retry_round_index(r, att)
        assert rid == ref_retry(r, att)
        for port, ref in models:    # a retry's straggler draw
            np.testing.assert_array_equal(port.delays(rid), ref.delays(rid))


def test_injection_identical_across_backends():
    """Which workers crash is a pure function of (seed, round): the
    wrapped backend does not matter, and it is the reference's plan."""
    fault = FaultSpec(crash_rate=0.25, corrupt_rate=0.25, seed=3)
    n = 12
    virt = FaultInjectingTransport(VirtualClockTransport(StragglerModel(
        n_workers=n, n_stragglers=0, seed=0, delay_s=0.0)), fault, 3)
    thr_inner = ThreadTransport(n, StragglerModel(
        n_workers=n, n_stragglers=0, seed=0, delay_s=0.0))
    thr = FaultInjectingTransport(thr_inner, fault, 3)
    try:
        arrived = {}
        for name, tr in (("virtual", virt), ("threads", thr)):
            h = tr.submit_round([np.float32(i) for i in range(n)],
                                lambda x: x * 2, 5, t_compute=1e-4)
            arrived[name] = sorted(e.worker for e in h.events())
            h.finish()
        assert arrived["virtual"] == arrived["threads"]
        plan = plan_faults(fault, 3, 5, n)
        assert arrived["virtual"] == sorted(
            set(range(n)) - set(np.flatnonzero(plan.crash)))
    finally:
        thr_inner.close()


def test_delay_spikes_flow_through_the_straggler_model():
    from repro.runtime.faults import FaultInjectingTransport as RefFIT
    from repro.runtime.straggler import StragglerModel as RefModel
    from repro.runtime.transport import VirtualClockTransport as RefVCT
    fault = FaultSpec(delay_spike_rate=0.3, delay_spike_s=0.05, seed=4)
    port = FaultInjectingTransport(VirtualClockTransport(
        StragglerModel(10, 2, seed=1)), fault, 4)
    ref = RefFIT(RefVCT(RefModel(10, 2, seed=1)), fault, 4)
    for r in range(6):
        np.testing.assert_array_equal(port.straggler.delays(r),
                                      ref.straggler.delays(r))


# ------------------------------------------------------------- corruption

def _ref_corrupt(value, seed, mode, scale):
    from repro.runtime.faults import corrupt_value as ref_corrupt
    return ref_corrupt(value, np.random.default_rng(seed), mode, scale)


@pytest.mark.parametrize("mode", ["scale", "bitflip"])
@pytest.mark.parametrize("shape", [(7,), (12, 16), (3, 5, 9)])
def test_corrupted_results_are_the_references_bytes(mode, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = _ref_corrupt(x, 9, mode, 1e3)
    got = faults.corrupt_value(torch.from_numpy(x.copy()),
                               np.random.default_rng(9), mode, 1e3)
    assert torch.is_tensor(got) and got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    # the envelope's routing metadata is kept, its payload corrupted
    env = faults.corrupt_value((3, torch.from_numpy(x.copy())),
                               np.random.default_rng(9), mode, 1e3)
    assert env[0] == 3 and env[1].numpy().tobytes() == want.tobytes()
    # numpy values come back as numpy, with the same bytes
    host = faults.corrupt_value(x.copy(), np.random.default_rng(9), mode,
                                1e3)
    assert isinstance(host, np.ndarray) and host.tobytes() == want.tobytes()


def test_tampered_ciphertext_limbs_are_the_references():
    from repro.crypto import MEAECC as RefMEA, generate_keypair as ref_kp
    from repro_torch.crypto import MEAECC, generate_keypair
    x = np.random.default_rng(2).standard_normal((6, 5)).astype(np.float32)
    ref_ct = RefMEA(mode="stream", codec="bits").encrypt(x, ref_kp().pk)
    port_ct = MEAECC(mode="stream", codec="bits", device="cpu").encrypt(
        torch.from_numpy(x), generate_keypair().pk)
    # tamper the same limbs: the port's ciphertext given the reference's
    port_ct = dataclasses.replace(port_ct, payload=torch.from_numpy(
        np.asarray(ref_ct.payload).view(np.int32).copy()).view(torch.uint32))
    want = _ref_corrupt(ref_ct, 13, "scale", 1e3)
    got = faults.corrupt_value(port_ct, np.random.default_rng(13))
    assert got.payload.dtype == torch.uint32
    assert got.payload.view(torch.int32).numpy().tobytes() == \
        np.asarray(want.payload).tobytes()
    assert not torch.equal(got.payload.view(torch.int32),
                           port_ct.payload.view(torch.int32))


def test_injector_drop_and_corrupt_virtual():
    fault = FaultSpec(drop_rate=0.5, corrupt_rate=0.3, corrupt_scale=1e3,
                      seed=0)
    n = 16
    tr = FaultInjectingTransport(VirtualClockTransport(StragglerModel(
        n_workers=n, n_stragglers=0, seed=0, delay_s=0.0)), fault, 0)
    shards = [torch.full((4,), float(i)) for i in range(n)]
    h = tr.submit_round(shards, lambda x: x + 1.0, 0, t_compute=1e-4)
    plan = plan_faults(fault, 0, 0, n)
    assert plan.drop.any() and plan.corrupt.any()
    for ev in h.events():
        w = ev.worker
        if plan.drop[w]:
            with pytest.raises(ResultDropped):
                h.result(w)
        elif plan.corrupt[w]:
            want = _ref_corrupt(np.full(4, w + 1.0, np.float32),
                                np.random.SeedSequence(
                                    [0, 0, faults._CORRUPT_STREAM, w]),
                                "scale", 1e3)
            assert h.result(w).numpy().tobytes() == want.tobytes()
        else:
            assert torch.equal(h.result(w), shards[w] + 1.0)
    h.finish()


# --------------------------------------------- screening / mask-bit proofs

def _proof_spec(api, encrypt=None, cipher_mode="stream", backend="virtual"):
    """Corrupt-only, no stragglers, no retries: every worker responds and
    every corrupted responder must end with its slot bit cleared."""
    return _spec(
        api, straggler=api.StragglerSpec(n_stragglers=0),
        crypto=api.CryptoSpec(encrypt=encrypt, cipher_mode=cipher_mode),
        transport=api.TransportSpec(backend=backend),
        fault=api.FaultSpec(corrupt_rate=0.25, corrupt_scale=1e3,
                            handle=True, max_retries=0, seed=5))


@pytest.mark.parametrize("encrypt,cipher_mode", [
    (None, "stream"), ("real", "stream"), ("real", "paper")])
def test_corrupted_responder_mask_bit_cleared(fixed_clock, fixed_keys,
                                              encrypt, cipher_mode):
    a, b = _mats()
    rounds, _ = _run_both(lambda api: _proof_spec(api, encrypt, cipher_mode),
                          1, a, b)
    gst, _, got, _ = rounds[0]
    plan = plan_faults(FaultSpec(corrupt_rate=0.25), 5, 0, 24)
    corrupted = set(int(w) for w in np.flatnonzero(plan.corrupt))
    assert corrupted and set(gst.excluded) == corrupted
    assert all(gst.decode_mask[w] == 0 for w in corrupted)
    ref = a @ b
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 1e-2


def test_clean_output_bit_identical_plain_vs_real():
    """The bits codec is lossless: a clean defended round decodes to the
    same float32 output in the clear and as genuine ciphertexts, in both
    cipher modes."""
    import repro_torch.api as api
    a, b = _mats()
    outs = []
    for encrypt, mode in ((None, "stream"), ("real", "stream"),
                          ("real", "paper")):
        spec = _spec(api, crypto=CryptoSpec(encrypt=encrypt,
                                            cipher_mode=mode),
                     fault=FaultSpec(handle=True))
        with Session(spec, device="cpu") as s:
            out, stats = s.matmul(a, b)
        assert stats.excluded == () and stats.retries == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("encrypt", [None, "real"])
def test_threads_transport_excludes_exactly_the_corrupted(encrypt):
    """The proof round on real threads (every worker is waited for, so the
    arrival order cannot change the clean set): the same exclusions as the
    plan and a clean decode."""
    import repro_torch.api as api
    a, b = _mats()
    spec = _proof_spec(api, encrypt, backend="threads")
    plan = plan_faults(spec.fault, 5, 0, 24)
    with Session(spec, device="cpu") as s:
        out, st = s.matmul(a, b)
    assert sorted(st.excluded) == sorted(int(w) for w in
                                         np.flatnonzero(plan.corrupt))
    ref = a @ b
    assert np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref) < 1e-2


def _screen_case(seed=1, bad=(2, 7, 11, 15)):
    from repro.core import registry as ref_registry
    kw = dict(n_workers=20, k_blocks=4, t_colluding=2, noise_scale=0.01,
              seed=1)
    sch = ref_registry.build("spacdc", **kw)
    rng = np.random.default_rng(0)
    a, b = _mats(seed=seed)
    results = np.einsum("nij,jk->nik", np.asarray(sch.encode(a)), b)
    for w in bad:
        results[w] = results[w] * 1e3 + rng.standard_normal(
            results[w].shape).astype(np.float32) * 1e3
    return sch, registry.build("spacdc", **kw), results


def test_screen_responders_norm_stage_handles_many_corrupters():
    from repro.runtime import screen_responders as ref_screen
    ref_sch, port_sch, results = _screen_case()
    mask = np.ones(20, np.float32)
    got = screen_responders(port_sch, torch.from_numpy(results), mask,
                            max_exclude=10)
    want = ref_screen(ref_sch, results, mask, max_exclude=10)
    assert set(got[1]) == {2, 7, 11, 15} and got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL, atol=0)


def test_screen_responders_non_finite_and_clean_rounds():
    from repro.core import registry as ref_registry
    from repro.runtime import screen_responders as ref_screen
    kw = dict(n_workers=24, k_blocks=6, t_colluding=2, noise_scale=0.05,
              seed=7)
    ref_sch, port_sch = ref_registry.build("spacdc", **kw), \
        registry.build("spacdc", **kw)
    a, b = _mats()
    results = np.einsum("nij,jk->nik", np.asarray(ref_sch.encode(a)), b)
    mask = np.ones(24, np.float32)
    got = screen_responders(port_sch, torch.from_numpy(results), mask,
                            max_exclude=20)
    assert got[1] == [] == ref_screen(ref_sch, results, mask,
                                      max_exclude=20)[1]
    results[5, 0, 0] = np.nan
    results[9] *= -3.0                      # under the norm cut: LOO sees it
    for budget in (0, 1, 20):
        got = screen_responders(port_sch, torch.from_numpy(results), mask,
                                max_exclude=budget)
        want = ref_screen(ref_sch, results, mask, max_exclude=budget)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL, atol=0)
    assert got[1][:2] == [5, 9]


def test_screen_evicts_the_clean_neighbour_of_an_escaped_corrupter():
    """The reference's screen, reproduced eviction for eviction: a
    corrupted result whose clean row is small (a Berrut row that nearly
    cancels) stays under the 30x norm cut, pollutes its neighbour's
    leave-one-out prediction, and the clean neighbour is evicted before
    it.  The products are scaled as at the full qwen2-7b width (entries
    ~ sqrt(18944)), where ``chip_smoke.py`` phase 10 (a) meets the same
    case (worker 19 beside corrupted 20)."""
    from repro.core import registry as ref_registry
    from repro.runtime import screen_responders as ref_screen
    kw = dict(n_workers=24, k_blocks=4, t_colluding=2, noise_scale=0.01,
              seed=11, fh_degree=3)
    ref_sch, port_sch = ref_registry.build("spacdc", **kw), \
        registry.build("spacdc", **kw)
    rng = np.random.default_rng(42)
    a = rng.standard_normal((4096, 64)).astype(np.float32)
    b = (17.2 * rng.standard_normal((64, 32))).astype(np.float32)
    results = np.einsum("nij,jk->nik", np.asarray(ref_sch.encode(a)), b)
    for w in (12, 20):                      # scale-mode corruption
        results[w] = results[w] * 1e3 + 1e3 * rng.standard_normal(
            results[w].shape).astype(np.float32)
    mask = np.ones(24, np.float32)
    mask[[2, 17, 18]] = 0.0
    norms = np.linalg.norm(results.reshape(24, -1), axis=1)
    assert 3.0 < norms[20] / np.median(norms[mask > 0]) < 30.0
    got = screen_responders(port_sch, torch.from_numpy(results), mask,
                            max_exclude=20)
    want = ref_screen(ref_sch, results, mask, max_exclude=20)
    assert got[1] == want[1] == [12, 19, 20]
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL, atol=0)


@pytest.mark.parametrize("name,kw", [
    ("spacdc", dict(n_workers=24, k_blocks=4, t_colluding=2,
                    noise_scale=0.01, seed=11)),
    ("mds", dict(n_workers=12, k_blocks=4)),
    ("lcc", dict(n_workers=12, k_blocks=3, deg_f=1)),
    ("bacc", dict(n_workers=12, k_blocks=4))])
def test_decode_residuals_match_reference(name, kw):
    from repro.core import registry as ref_registry
    ref_sch, port_sch = ref_registry.build(name, **kw), \
        registry.build(name, **kw)
    a, b = _mats()
    results = np.einsum("nij,jk->nik", np.asarray(ref_sch.encode(a)), b)
    n = kw["n_workers"]
    results[2] = results[2] * 3.0 + 1.0
    results[n - 1] = np.nan                 # masked out: must not leak
    mask = np.ones(n, np.float32)
    mask[[n - 1, 5]] = 0.0
    want = ref_sch.decode_residuals(results, mask)
    got = port_sch.decode_residuals(torch.from_numpy(results), mask)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=0)
    assert int(np.argmax(got)) == 2


# -------------------------------------------------- retries / degradation

def _defended(api):
    return _spec(api, fault=api.FaultSpec(
        crash_rate=0.12, corrupt_rate=0.12, corrupt_scale=1e3, handle=True,
        quarantine_after=2))


def test_defended_round_matches_reference(fixed_clock):
    """Six defended rounds: retries, exclusions, quarantines, masks and
    the health records equal the reference's; every output within
    OUT_TOL and 1e-2 of the exact product."""
    a, b = _mats()
    rounds, (ref_h, port_h) = _run_both(_defended, 6, a, b)
    ref = a @ b
    for gst, _, got, _ in rounds:
        assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 1e-2
        assert sum(gst.decode_mask) == gst.n_waited
    assert sum(g.retries for g, *_ in rounds) >= 1
    assert sum(len(g.excluded) for g, *_ in rounds) >= 1
    assert port_h == ref_h
    assert sum(w["n_corrupt"] for w in port_h["workers"]) >= 1


@pytest.mark.parametrize("mode", ["scale", "bitflip"])
def test_undefended_round_decodes_the_same_corruption(fixed_clock, mode):
    """Injection only: corrupt results are averaged into the decode,
    identically in both packages (the corrupted bytes are equal)."""
    a, b = _mats()
    rounds, _ = _run_both(lambda api: _spec(api, fault=api.FaultSpec(
        crash_rate=0.12, corrupt_rate=0.12, corrupt_mode=mode,
        corrupt_scale=1e3)), 3, a, b)
    ref = a @ b
    worst = max(np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
                for *_, g, _ in rounds)
    assert worst > 1e-1


def test_rateless_degraded_round_reports_achieved_err(fixed_clock):
    rounds, _ = _run_both(lambda api: _spec(
        api, straggler=api.StragglerSpec(n_stragglers=0),
        fault=api.FaultSpec(crash_rate=0.5, handle=True, max_retries=0,
                            seed=13)), 1)
    gst, wst, got, _ = rounds[0]
    assert gst.degraded and got.shape == (48, 16)
    assert gst.achieved_rel_err == pytest.approx(wst.achieved_rel_err,
                                                 rel=1e-4)


def test_threshold_scheme_raises_structured_degraded_error(fixed_clock):
    import repro.api as ref_api
    from repro.runtime import DegradedRoundError as RefDegraded
    a, b = _mats(m=32, d=16, n_out=8)

    def spec(api):
        return api.ClusterSpec(
            code=api.CodeSpec(scheme="mds", n_workers=8, k_blocks=4),
            straggler=api.StragglerSpec(n_stragglers=0), seed=2,
            fault=api.FaultSpec(crash_rate=0.9, handle=True, max_retries=1,
                                seed=21))
    ref_spec, port_spec = _both(spec)
    errs = []
    for session, err_cls in ((lambda: ref_api.Session(ref_spec), RefDegraded),
                             (lambda: Session(port_spec, device="cpu"),
                              DegradedRoundError)):
        with session() as s:
            with pytest.raises(err_cls) as ei:
                for r in range(6):   # some round draws > n-k crashes
                    s.matmul(a, b)
        errs.append((r, ei.value))
    (r_ref, want), (r_port, got) = errs
    assert r_port == r_ref
    assert (got.clean_slots, got.excluded, got.retries, got.needed) == \
        (want.clean_slots, want.excluded, want.retries, want.needed)
    assert got.needed >= 4 and len(got.clean_slots) < 4
    if got.clean_slots:
        assert torch.is_tensor(got.results)
        assert _rel(got.results, np.asarray(want.results)) <= OUT_TOL
    else:
        assert got.results is None and want.results is None


# ------------------------------------------------------------ WorkerHealth

def test_worker_health_quarantine_and_probation():
    h = WorkerHealth(4, quarantine_after=2, quarantine_rounds=3,
                     probation_ok=2)
    h.record_corrupt(1, 0)
    assert not h.is_quarantined(1, 1)
    h.record_corrupt(1, 1)          # second strike -> quarantined
    assert h.is_quarantined(1, 2)
    assert not h.is_quarantined(1, 5)   # 3 rounds served
    h.record_crash(1, 5)            # offense during probation
    assert h.is_quarantined(1, 6)
    assert h.is_quarantined(1, 5 + 5)   # 2x quarantine_rounds
    h.record_ok(2, 0.01)
    assert 2 in h.ranked(1)
    assert 1 not in h.ranked(6)
    assert 1 not in h.ranked(6, exclude={1})


def test_worker_health_matches_reference_event_for_event():
    from repro.runtime import WorkerHealth as RefHealth
    rng = np.random.default_rng(4)
    events = [(r, int(rng.integers(6)), int(rng.integers(4)),
               float(rng.random())) for r in range(40)]
    port, ref = WorkerHealth(6, quarantine_after=2), RefHealth(
        6, quarantine_after=2)
    for r, w, kind, lat in events:
        for h in (port, ref):
            if kind == 0:
                h.record_ok(w, lat)
            else:
                getattr(h, ("record_crash", "record_drop",
                            "record_corrupt")[kind - 1])(w, r)
        assert port.ranked(r) == ref.ranked(r)
        assert port.quarantined(r) == ref.quarantined(r)
    assert port.to_dict() == ref.to_dict()
    assert port.snapshot() == ref.snapshot()
    np.testing.assert_array_equal(port.ewma_latencies(),
                                  ref.ewma_latencies())
    json.dumps(port.to_dict())
    h = WorkerHealth(3)
    for w, lat in ((0, 0.5), (1, 0.01), (2, 0.1)):
        h.record_ok(w, lat)
    assert h.ranked(1) == [1, 2, 0]


# ------------------------------------------- transport satellites (a + b)

def _wait_for_stray(tr, timeout=10.0):
    t_end = time.perf_counter() + timeout
    while not tr._stray_errors and time.perf_counter() < t_end:
        time.sleep(0.005)
    assert tr._stray_errors, "the straggler's failure never landed"


def _failing_round(tr, round_idx):
    started, release = threading.Event(), threading.Event()

    def f(x):
        if x == 1:
            started.set()
            release.wait(10.0)
            raise RuntimeError("boom")
        return x

    h = tr.submit_round([0, 1], f, round_idx=round_idx, t_compute=1e-4)
    ev = next(h.events())           # consume the healthy worker only
    assert ev.worker == 0
    # finish() drops work not yet started: wait until the straggler runs
    assert started.wait(10.0)
    h.finish()                      # straggler still running: no error yet
    release.set()
    _wait_for_stray(tr)
    return h


def test_stray_failure_tagged_with_originating_round():
    tr = ThreadTransport(2, StragglerModel(n_workers=2, n_stragglers=0,
                                           seed=0, delay_s=0.0))
    try:
        h = _failing_round(tr, 5)
        with pytest.raises(RuntimeError, match=r"originating round 5") as ei:
            h.finish()
        assert "boom" in str(ei.value.__cause__)
    finally:
        tr.close()


def test_stray_failure_still_surfaces_on_next_submit():
    tr = ThreadTransport(2, StragglerModel(n_workers=2, n_stragglers=0,
                                           seed=0, delay_s=0.0))
    try:
        _failing_round(tr, 3)
        with pytest.raises(RuntimeError, match=r"originating round 3"):
            tr.submit_round([0, 1], lambda x: x, 4, t_compute=1e-4)
    finally:
        tr.close()


def test_close_does_not_deadlock_on_blocked_worker():
    tr = ThreadTransport(2, StragglerModel(n_workers=2, n_stragglers=0,
                                           seed=0, delay_s=0.0))
    tr.join_timeout_s = 0.3
    release = threading.Event()

    def f(x):
        if x == 1:
            release.wait()      # blocked until the test releases it
        return x

    h = tr.submit_round([0, 1], f, round_idx=0, t_compute=1e-4)
    next(h.events())
    h.finish()
    t0 = time.perf_counter()
    tr.close()
    elapsed = time.perf_counter() - t0
    release.set()
    assert elapsed < 1.5, f"close() blocked {elapsed:.2f}s on a stuck worker"


def test_session_close_bounded_with_inflight_faulted_threads_round():
    import repro_torch.api as api
    a, b = _mats(m=16, d=8, n_out=4)
    spec = _spec(
        api, code=CodeSpec(scheme="spacdc", n_workers=6, k_blocks=2,
                           fused=False, extra={"fh_degree": 3}),
        straggler=StragglerSpec(n_stragglers=2, delay_s=0.05),
        transport=TransportSpec(backend="threads"),
        fault=FaultSpec(crash_rate=0.2, handle=True))
    s = Session(spec, device="cpu")
    out, st = s.matmul(a, b)    # leaves stragglers sleeping on the pool
    assert out.shape == (16, 4) and len(st.decode_mask) == 6
    t0 = time.perf_counter()
    s.close()
    assert time.perf_counter() - t0 < 5.0


# ------------------------------------------------------------ on the card

def test_fault_round_needs_a_card_by_default(monkeypatch):
    import repro_torch.api as api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(_defended(api))


@pytest.mark.parametrize("encrypt", [None, "real"])
def test_cuda_fault_round_kernels_against_kernels_off(cuda, encrypt):
    """The defended round on the card through the kernels against the
    same round with the kernels forced off (the second engine reads the
    first one's measured compute time): identical retries, exclusions,
    masks and degraded flags, outputs within OUT_TOL of max |plain|, and
    the launches of the encode and the decode (+ the wires) counted."""
    import repro_torch.api as api
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn((48, 32), generator=gen, device=cuda)
    b = torch.randn((32, 16), generator=gen, device=cuda)
    spec = _spec(api, crypto=CryptoSpec(encrypt=encrypt),
                 fault=FaultSpec(crash_rate=0.12, corrupt_rate=0.12,
                                 corrupt_scale=1e3, handle=True,
                                 quarantine_after=2))
    plain = dataclasses.replace(spec, code=dataclasses.replace(
        spec.code, use_kernel=False))
    with Session(spec, device=cuda) as sk, Session(plain, device=cuda) as sp:
        if encrypt:
            # the same keys: tampered limbs decrypt to key-dependent
            # garbage, which orders the evictions
            sp.engine._master_kp = sk.engine._master_kp
            sp.engine._worker_kps = sk.engine._worker_kps
        for _ in range(4):
            got, gst = sk.matmul(a, b)
            sp.engine._worker_t = dict(sk.engine._worker_t)
            want, wst = sp.matmul(a, b)
            torch.cuda.synchronize()
            _same_round(gst, wst)
            assert _rel(got, want.cpu().numpy()) <= OUT_TOL
            assert gst.dispatches >= 2 and wst.dispatches == 0
