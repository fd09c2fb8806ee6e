"""The port's anytime decoding, ErrorTarget rounds and real-thread transport
against the JAX package.

``repro_torch`` gets the same numpy inputs as ``repro`` (and, where T > 0,
the reference's JAX-drawn noise blocks), on the CPU, where the port runs
its kernels' plain versions.  What is held, and how closely:

* ``anytime_decode``: ready flags and responder counts exactly, decoded
  blocks within 1e-5 of the reference's max |value| (both sides contract
  float32 weights in float32, in different orders);
* spacdc's Berrut prefix decode stacks within 1e-6 absolute; its
  Floater–Hormann proxy stacks elementwise within float32's bound for a
  row sum taken in another order (``_fh_bound_ratio``: their rows cancel,
  so weights up to ~50 differ by up to ~8e-5); the default float64
  ``pinv`` stacks of mds and conv within 1e-5 of max |w|, ready exactly;
* ``anytime_curve``: the arrival order, the arrival times less each
  package's measured compute time, and the ready flags exactly; true
  errors and proxies within 1e-4 absolute + 1e-3 relative (float32 norms
  of float32 decodes); one ``coded_matmul`` and one ``berrut_combine``
  call per curve;
* ``ErrorTarget`` rounds: the stop index (``n_waited``) exactly, the
  output within 1e-5 of max |out|;
* the encrypted ErrorTarget rounds, fused and staged, bit-identical to the
  port's plain ErrorTarget round;
* the real-thread transport by the reference's own tests and timing
  assertions (``tests/test_anytime.py``), plus the threads round's output
  against the plain decode of its own responder set.

The ``cuda`` cases hold each round kind on the card (kernels) against the
same round with the kernels forced off, with exact launch counts; they
import no JAX and skip without a card.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, CryptoSpec, Session, TransportSpec,
                             WaitSpec)
from repro_torch.core import registry
from repro_torch.kernels import ops
from repro_torch.kernels.berrut_encode import berrut_encode_kernel
from repro_torch.kernels.coded_matmul import coded_matmul_kernel
from repro_torch.kernels.mask_add import mask_add_kernel
from repro_torch.runtime import (CodedMaster, Deadline, DistributedMatmul,
                                 ErrorTarget, FirstK, StragglerModel,
                                 WorkerPool, virtual_events)

DEC_TOL = 1e-5          # decodes and rounds, of the reference's max |value|
W_TOL = 1e-5            # float64-pinv prefix weights, of max |w|
ERR_ABS, ERR_REL = 1e-4, 1e-3   # curve errors and proxies

rng = np.random.default_rng(0)
A = rng.standard_normal((256, 64)).astype(np.float32)
B = rng.standard_normal((64, 32)).astype(np.float32)


def smooth(m, d, seed=1, modes=5):
    """``tests/test_anytime.py``'s smooth workload: rows vary slowly along
    the block axis, so early decodes carry information."""
    r = np.random.default_rng(seed)
    t = np.arange(m)[:, None] / m
    out = sum(r.standard_normal(d)[None, :] * np.cos(np.pi * c * t) /
              (1 + c) ** 2.0 for c in range(modes))
    return out.astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


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
    return registry.build(name, **kw), ref_registry.build(name, **kw)


def _ref_noise(ref_engine, m, d):
    """The reference engine's (T, blk, d) noise blocks for an (m, d) A."""
    scheme = ref_engine.scheme
    if getattr(scheme, "cfg", None) is None or not scheme.cfg.t_colluding:
        return None
    blk = -(-m // scheme.cfg.k_blocks)
    return np.asarray(scheme.make_noise((blk, d)))


def _close(got, want) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both_inf = np.isinf(got) & np.isinf(want)
    with np.errstate(invalid="ignore"):
        ok = np.abs(got - want) <= ERR_ABS + ERR_REL * np.abs(want)
    return bool(np.all(both_inf | ok))


def _count_calls(monkeypatch):
    """Count ``ops.coded_matmul`` and ``ops.berrut_combine`` calls (every
    kernel entry the rounds make; on the CPU the counters stay 0)."""
    calls = {"coded_matmul": 0, "berrut_combine": 0}
    for name in calls:
        orig = getattr(ops, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    return calls


# --------------------------------------------------------------------------
# the anytime_decode contract and the prefix weight stacks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,thr", [
    ("mds", dict(n_workers=10, k_blocks=4), 4),
    ("conv", dict(n_workers=6), 6),
    ("spacdc", dict(n_workers=10, k_blocks=4, t_colluding=1), 1),
])
def test_anytime_decode_matches_reference(name, kw, thr):
    import jax.numpy as jnp
    port, ref = _both(name, **kw)
    n = ref.n_workers
    shards = np.asarray(ref.encode(jnp.asarray(A)))
    results = np.einsum("nij,jk->nik", shards, B).astype(np.float32)
    assert port.min_responders == ref.min_responders == thr
    for p in range(1, n + 1):
        mask = np.zeros(n, np.float32)
        mask[np.random.default_rng(p).permutation(n)[:p]] = 1.0
        got = port.anytime_decode(torch.from_numpy(results), mask)
        want = ref.anytime_decode(jnp.asarray(results), mask)
        assert got.ready == want.ready == (p >= thr)
        assert got.n_responders == want.n_responders == p
        assert (got.decoded is None) == (want.decoded is None)
        if want.ready:
            assert _rel(got.decoded, want.decoded) <= DEC_TOL, (name, p)


@pytest.mark.parametrize("fh_degree", [1, 2, 3])
def test_spacdc_prefix_and_proxy_weights_match_reference(fh_degree):
    port, ref = _both("spacdc", n_workers=12, k_blocks=4, t_colluding=1)
    for trial in range(4):
        order = np.random.default_rng(trial).permutation(12)
        w_p, r_p = port.prefix_decode_weights(order)
        w_r, r_r = ref.prefix_decode_weights(order)
        np.testing.assert_array_equal(r_p, r_r)
        assert np.max(np.abs(w_p - np.asarray(w_r))) <= 1e-6
        h_p, v_p = port.anytime_proxy_weights(order, fh_degree=fh_degree)
        h_r, v_r = ref.anytime_proxy_weights(order, fh_degree=fh_degree)
        np.testing.assert_array_equal(v_p, np.asarray(v_r))
        assert not v_p[: fh_degree + 1].any() and v_p[fh_degree + 1:].all()
        assert _fh_bound_ratio(h_p, np.asarray(h_r)) <= 1.0, trial


def _fh_bound_ratio(got, want) -> float:
    """Two float32 Floater–Hormann weight stacks held elementwise to what
    float32 rounding explains.  Both packages compute the same terms t_i =
    w_i / (beta - x_i) exactly rounded and normalise each row by its sum
    S; only the order of that sum differs.  Each sum lies within γ_n Σ|t|
    of the exact one, so each weight within (γ_n Σ_j |w_j| + u) |w_i| of
    the exact weight, and two of them within twice that (u = 2^-24, γ_n =
    n u / (1 - n u)).  FH rows alternate in sign and cancel, so Σ_j |w_j|
    reaches ~100 at K=4 and no absolute tolerance fits them all.  Returns
    the largest |got - want| over that bound; above 1 is no rounding."""
    u = 2.0 ** -24
    n = want.shape[-1]
    g = n * u / (1 - n * u)
    w = np.abs(want.astype(np.float64))
    limit = 2 * (g * w.sum(-1, keepdims=True) + u) * w
    diff = np.abs(got.astype(np.float64) - want)
    return float(np.max(np.where(limit > 0, diff / np.where(limit > 0, limit,
                                                             1.0),
                                 np.where(diff > 0, np.inf, 0.0))))


@pytest.mark.parametrize("name,kw", [
    ("mds", dict(n_workers=10, k_blocks=4)),
    ("mds", dict(n_workers=30, k_blocks=24)),
    ("conv", dict(n_workers=6)),
])
def test_default_pinv_prefix_stacks_match_reference(name, kw):
    port, ref = _both(name, **kw)
    n = ref.n_workers
    order = np.random.default_rng(3).permutation(n)
    w_p, r_p = port.prefix_decode_weights(order)
    w_r, r_r = ref.prefix_decode_weights(order)
    assert w_p.dtype == np.float32 and w_p.shape == np.asarray(w_r).shape
    np.testing.assert_array_equal(r_p, r_r)
    assert list(r_p) == [False] * (ref.min_responders - 1) + \
        [True] * (n - ref.min_responders + 1)
    w_r = np.asarray(w_r)
    assert np.max(np.abs(w_p - w_r)) <= W_TOL * np.max(np.abs(w_r))
    assert port.anytime_proxy_weights(order) is None


# --------------------------------------------------------------------------
# anytime_curve: one batched prefix decode per curve
# --------------------------------------------------------------------------

CURVES = {
    # tests/test_anytime.py's three curve cases (:154-193)
    "spacdc_dispatches": ("spacdc", dict(n_workers=8, k_blocks=4,
                                         t_colluding=1, n_stragglers=2),
                          [(A, B, 0), (A, B, 1), (A[:128], B, 2)]),
    "spacdc_smooth": ("spacdc", dict(n_workers=8, k_blocks=4, t_colluding=1,
                                     n_stragglers=2),
                      [(smooth(256, 64), B, 3)]),
    "mds_threshold": ("mds", dict(n_workers=10, k_blocks=4, n_stragglers=2),
                      [(A, B, 0)]),
}


@pytest.mark.parametrize("case", sorted(CURVES))
def test_anytime_curve_matches_reference(case, monkeypatch):
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    name, kw, jobs = CURVES[case]
    ref = RefDM(name, **kw)
    port = DistributedMatmul(name, device="cpu", **kw)
    calls = _count_calls(monkeypatch)
    for a, b, r in jobs:
        want = ref.anytime_curve(a, b, round_idx=r)
        before = dict(calls)
        got = port.anytime_curve(a, b, round_idx=r,
                                 noise=_ref_noise(ref, *a.shape))
        assert {k: calls[k] - before[k] for k in calls} == \
            {"coded_matmul": 1, "berrut_combine": 1}
        assert len(got) == len(want) == kw["n_workers"]
        assert [p.worker for p in got] == [p.worker for p in want]
        assert [p.n_responders for p in got] == list(range(1, len(got) + 1))
        assert [p.ready for p in got] == [p.ready for p in want]
        t_p = port._round_compute_time(a.shape, b.shape)[1]
        t_r = ref._round_compute_time(a.shape, b.shape)[1]
        np.testing.assert_allclose([p.t_s - t_p for p in got],
                                   [p.t_s - t_r for p in want], atol=1e-12)
        assert _close([p.rel_err for p in got], [p.rel_err for p in want])
        assert _close([p.best_err for p in got], [p.best_err for p in want])
        assert _close([p.proxy for p in got], [p.proxy for p in want])
        best = [p.best_err for p in got]
        assert all(b2 <= b1 for b1, b2 in zip(best, best[1:]))
    if name == "mds":
        assert [p.ready for p in got] == [False] * 3 + [True] * 7
        assert all(np.isinf(p.rel_err) for p in got[:3])
        assert got[3].rel_err < 1e-3
    else:
        assert all(p.ready for p in got)
        ev = virtual_events(port.straggler.delays(r),
                            port._round_compute_time(a.shape, b.shape)[1])
        assert [p.worker for p in got] == [e.worker for e in ev]


# --------------------------------------------------------------------------
# ErrorTarget rounds: fused, loop, threshold
# --------------------------------------------------------------------------

FUSED_KW = dict(n_workers=30, k_blocks=6, t_colluding=2, noise_scale=0.05,
                n_stragglers=7, seed=0)
LOOP_KW = dict(n_workers=12, k_blocks=4, t_colluding=1, noise_scale=0.05,
               n_stragglers=2, seed=0, fused=False)


def _error_target_jobs():
    b1 = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    b2 = np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)
    return {
        # tests/test_anytime.py:240-278
        "fused": ("spacdc", FUSED_KW, [(5e-2, 0), (5e-2, 1), (5e-3, 0)],
                  smooth(576, 64), b1),
        "loop": ("spacdc", LOOP_KW, [(5e-2, 0), (5e-2, 1)], smooth(240, 32),
                 b2),
        "mds_threshold": ("mds", dict(n_workers=10, k_blocks=4,
                                      n_stragglers=2, seed=3),
                          [(1e-3, 1)], A, B),
    }


@pytest.mark.parametrize("case", ["fused", "loop", "mds_threshold"])
def test_error_target_rounds_match_reference(case):
    from repro.runtime import ErrorTarget as RefET
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    name, kw, rounds, a, b = _error_target_jobs()[case]
    engines = {}
    for eps, r in rounds:
        if eps not in engines:      # one engine pair per target, reused
            engines[eps] = (RefDM(name, wait_policy=RefET(eps), **kw),
                            DistributedMatmul(name,
                                              wait_policy=ErrorTarget(eps),
                                              device="cpu", **kw))
        ref, port = engines[eps]
        assert port.use_fused == ref.use_fused == (case != "loop")
        want, wst = ref.matmul(a, b, round_idx=r)
        got, gst = port.matmul(a, b, round_idx=r,
                               noise=_ref_noise(ref, *a.shape))
        assert gst.policy == wst.policy == "error_target"
        assert gst.n_waited == wst.n_waited, (case, eps, r)
        assert [w for _, w in gst.arrivals] == [w for _, w in wst.arrivals]
        assert _rel(got, want) <= DEC_TOL, (case, eps, r)
        assert gst.dispatches == 0          # the CPU runs the plain versions
        exact = a @ b
        rel = np.linalg.norm(_np(got) - exact) / np.linalg.norm(exact)
        if case == "mds_threshold":
            assert gst.n_waited == 4
            assert np.abs(_np(got) - exact).max() / np.abs(exact).max() \
                < 1e-2
        elif eps == 5e-2:
            # the reference's contract at its target (the 5e-3 round only
            # has to wait at least as long, which the next test holds)
            assert rel < 2 * eps


def test_error_target_fused_round_stops_early_and_tighter_waits_longer():
    a = smooth(576, 64)
    b = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    loose = DistributedMatmul("spacdc", wait_policy=ErrorTarget(5e-2),
                              device="cpu", **FUSED_KW)
    tight = DistributedMatmul("spacdc", wait_policy=ErrorTarget(5e-3),
                              device="cpu", **FUSED_KW)
    _, s1 = loose.matmul(a, b, round_idx=0)
    _, s2 = tight.matmul(a, b, round_idx=0)
    assert s1.n_waited < 23 and s2.n_waited >= s1.n_waited
    assert s1.decode_s == 0.0 and s1.compute_wait_s == s1.decode_at_s
    # the stop prefix's arrival is the round's virtual wait
    assert s1.compute_wait_s == s1.arrivals[s1.n_waited - 1][0]


def _anytime_spec(**over):
    spec = ClusterSpec.anytime_bench()
    return dataclasses.replace(
        spec, wait=WaitSpec(policy="error_target", eps=5e-2), **over)


@pytest.mark.parametrize("mode", ["stream", "paper"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_encrypted_error_target_rounds_are_bit_identical(fused, mode):
    a = smooth(576, 64)
    b = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    real = _anytime_spec(crypto=CryptoSpec(encrypt="real", cipher_mode=mode,
                                           fused=fused))
    with Session(_anytime_spec(), device="cpu") as sp, \
            Session(real, device="cpu") as sr:
        assert sr.engine.use_fused and sr.engine._crypto_fused == fused
        for r in range(2):
            want, wst = sp.matmul(a, b, round_idx=r)
            got, gst = sr.matmul(a, b, round_idx=r)
            assert torch.equal(got, want)
            assert gst.n_waited == wst.n_waited < 23
            assert [w for _, w in gst.arrivals] == \
                [w for _, w in wst.arrivals]
            assert gst.crypto_s > 0.0 and gst.dispatches == 0
            assert (gst.decode_s > 0.0) == (not fused)


# --------------------------------------------------------------------------
# WorkerPool on real threads (tests/test_anytime.py:355-436)
# --------------------------------------------------------------------------

def test_real_thread_pool_reuses_one_executor():
    st = StragglerModel(4, 0, delay_s=0.0, jitter_scale=1e-4, seed=0)
    pool = WorkerPool(4, st, real_threads=True)
    resp, results, _ = pool.run_round([0, 1, 2, 3], lambda x: x + 1, 0,
                                      wait_for=4)
    ex1 = pool._executor
    assert ex1 is not None
    pool.run_round([0, 1, 2, 3], lambda x: x + 1, 1, wait_for=4)
    assert pool._executor is ex1          # long-lived, not per-round
    assert sorted(results) == [1, 2, 3, 4]
    pool.close()
    assert pool._executor is None


def test_real_thread_event_round_stops_at_policy():
    st = StragglerModel(6, 2, delay_s=0.05, jitter_scale=1e-4, seed=1)
    pool = WorkerPool(6, st, real_threads=True)
    scheme = registry.build("spacdc", n_workers=6, k_blocks=2, t_colluding=1)
    events, done, elapsed = pool.run_round_real(
        list(range(6)), lambda x: x, 0, policy=FirstK(3), scheme=scheme,
        n_stragglers=2)
    assert len(events) >= 3 and len(done) >= 3
    assert elapsed < 0.05                 # did not wait for the stragglers
    assert [e.t for e in events] == sorted(e.t for e in events)
    with pytest.raises(NotImplementedError):
        pool.run_round_real(list(range(6)), lambda x: x, 0,
                            policy=ErrorTarget(1e-2), scheme=scheme)
    pool.close()


def test_real_thread_deadline_wakes_at_budget_not_next_straggler():
    st = StragglerModel(6, 3, delay_s=0.4, jitter_scale=1e-4, seed=1)
    pool = WorkerPool(6, st, real_threads=True)
    scheme = registry.build("spacdc", n_workers=6, k_blocks=2, t_colluding=1)
    events, done, elapsed = pool.run_round_real(
        list(range(6)), lambda x: x, 0, policy=Deadline(0.05), scheme=scheme)
    # woke at the 50ms budget — not at the 400ms stragglers
    assert elapsed < 0.3 and 1 <= len(events) <= 3
    pool.close()


def test_real_thread_stray_worker_failure_surfaces_next_round():
    st = StragglerModel(4, 2, delay_s=0.05, jitter_scale=1e-4, seed=1)
    pool = WorkerPool(4, st, real_threads=True)
    scheme = registry.build("spacdc", n_workers=4, k_blocks=2)
    slow = set(np.argsort(st.delays(0))[2:])

    def f(x):
        if x in slow:
            raise RuntimeError("boom")
        return x

    events, done, _ = pool.run_round_real(list(range(4)), f, 0,
                                          policy=FirstK(2), scheme=scheme)
    assert len(done) >= 2
    time.sleep(0.15)                      # let the stragglers fail
    with pytest.raises(RuntimeError, match="straggler worker"):
        pool.run_round_real(list(range(4)), f, 1, policy=FirstK(2),
                            scheme=scheme)
    try:
        pool.close()
    except RuntimeError:
        pass


def test_real_thread_distributed_matmul_with_policy():
    """The reference's test, then the round's output against the plain
    decode of its own responder set and against the reference's round on
    the same responders (the T noise handed in).

    Nothing here rests on wall-clock timing.  Which six workers answer
    first on real threads depends on the machine's load: the stragglers'
    50 ms margin, and the reference's worker threads compiling their
    first product, can reorder arrivals when other processes hold the
    cores.  So the reference's round is its virtual-clock round with the
    straggler delays set to put the port's responders first, and the
    threads are held to the straggler model by what sleeping guarantees:
    every worker arrived no earlier than its injected delay."""
    from repro.runtime import FirstK as RefFirstK
    from repro.runtime import StragglerModel as RefModel
    from repro.runtime.master_worker import DistributedMatmul as RefDM
    kw = dict(n_workers=8, k_blocks=4, t_colluding=1, fused=False)
    st = StragglerModel(8, 2, delay_s=0.05, jitter_scale=1e-4, seed=1)
    dist = DistributedMatmul("spacdc", straggler=st, wait_policy=FirstK(6),
                             device="cpu", **kw)
    dist.pool.real_threads = True
    ref_st = RefModel(8, 2, delay_s=0.05, jitter_scale=1e-4, seed=1)
    ref = RefDM("spacdc", straggler=ref_st, wait_policy=RefFirstK(6), **kw)
    noise = _ref_noise(ref, *A.shape)
    out, stats = dist.matmul(A, B, round_idx=0, noise=noise)
    assert stats.n_waited == 6
    assert tuple(out.shape) == (256, 32) and bool(torch.isfinite(out).all())
    delays = st.delays(0)
    np.testing.assert_array_equal(delays, ref_st.delays(0))
    assert len(stats.arrivals) >= 6
    for t_s, w in stats.arrivals:         # each thread slept its delay
        assert t_s >= delays[w], (w, t_s, delays[w])
    resp = sorted(w for _, w in stats.arrivals[:6])
    enc = dist.scheme.encode(torch.from_numpy(A), noise)
    plain = dist.scheme.decode(
        torch.stack([enc[i] @ torch.from_numpy(B) for i in resp]), resp)
    assert _rel(out, dist.scheme.reconstruct_matmul(plain, 256, 32)) <= 1e-6
    # the reference's virtual-clock round, its delays putting the port's
    # responders first
    forced = np.where(np.isin(np.arange(8), resp), 0.0, 1.0)
    ref_st.delays = lambda round_idx: forced
    want, wst = ref.matmul(A, B, round_idx=0)
    assert wst.n_waited == 6
    assert sorted(w for _, w in wst.arrivals[:6]) == resp
    assert _rel(out, want) <= DEC_TOL
    dist.close()
    ref.pool.close()


def test_threads_session_runs_rounds_and_closes_within_its_bound():
    spec = dataclasses.replace(ClusterSpec.paper_fig3(),
                               transport=TransportSpec(backend="threads"))
    a = np.random.default_rng(1).standard_normal((96, 16)).astype(np.float32)
    b = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
    s = Session(spec, device="cpu")
    assert not s.engine.use_fused and s.engine.pool.real_threads
    for r in range(2):
        out, st = s.matmul(a, b, round_idx=r)
        assert st.n_waited == 23 and st.decode_s > 0.0
        assert tuple(out.shape) == (96, 8)
        assert [t for t, _ in st.arrivals] == sorted(t for t, _ in st.arrivals)
        assert st.compute_wait_s == st.arrivals[st.n_waited - 1][0]
    t0 = time.perf_counter()
    s.close()
    assert time.perf_counter() - t0 <= \
        s.engine.pool._threads.join_timeout_s + 0.5
    assert s.engine.pool._executor is None


# --------------------------------------------------------------------------
# CodedMaster under ErrorTarget (tests/test_runtime.py:118)
# --------------------------------------------------------------------------

def test_coded_master_trains_under_error_target():
    from repro_torch.data import synthetic_mnist
    xtr, ytr, xte, yte = synthetic_mnist(n_train=512, n_test=128)
    dist = DistributedMatmul("spacdc", n_workers=8, k_blocks=4,
                             t_colluding=1, n_stragglers=1, device="cpu")
    m = CodedMaster((784, 32, 10), dist, lr=0.1,
                    wait_policy=ErrorTarget(0.25), device="cpu")
    for i in range(0, 512, 256):
        loss, _ = m.train_batch(xtr[i:i + 256], ytr[i:i + 256])
        assert np.isfinite(loss)
    assert dist.policy.name == "error_target"
    assert all(s.policy == "error_target" for s in m.round_stats)
    assert all(1 <= s.n_waited <= 8 for s in m.round_stats)
    assert len(m.round_stats) == 2


# --------------------------------------------------------------------------
# on the card: each round kind through the kernels against the plain one
# --------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(spec):
    return dataclasses.replace(spec, code=dataclasses.replace(
        spec.code, use_kernel=False))


def _launches():
    return (coded_matmul_kernel.launches, berrut_encode_kernel.launches,
            mask_add_kernel.launches)


def _smooth_job(dev, m=576, d=64, n=48):
    a = torch.from_numpy(smooth(m, d)).to(dev)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (d, n)).astype(np.float32)).to(dev)
    return a, b


def test_cuda_anytime_curve_matches_plain(cuda):
    a, b = _smooth_job(cuda)
    spec = ClusterSpec.anytime_bench()
    with Session(spec, device=cuda) as sk, \
            Session(_plain(spec), device=cuda) as sp:
        for r in range(2):
            n0 = _launches()
            got = sk.anytime_curve(a, b, round_idx=r)
            n1 = _launches()
            want = sp.anytime_curve(a, b, round_idx=r)
            assert (n1[0] - n0[0], n1[1] - n0[1], n1[2] - n0[2]) == (1, 1, 0)
            assert _launches() == n1
            assert [p.worker for p in got] == [p.worker for p in want]
            assert [p.ready for p in got] == [p.ready for p in want]
            assert _close([p.rel_err for p in got],
                          [p.rel_err for p in want])
            assert _close([p.proxy for p in got], [p.proxy for p in want])


@pytest.mark.parametrize("crypto", [None, "fused", "staged"])
def test_cuda_error_target_round_matches_plain(cuda, crypto):
    a, b = _smooth_job(cuda)
    spec = _anytime_spec()
    with Session(spec, device=cuda) as sk, \
            Session(_plain(spec), device=cuda) as sp:
        want, wst = sp.matmul(a, b, round_idx=0)
        got, gst = sk.matmul(a, b, round_idx=0)
        assert gst.n_waited == wst.n_waited < 23 and gst.dispatches == 2
        assert _rel(got, want) <= 1e-4
        if crypto is not None:
            real = _anytime_spec(crypto=CryptoSpec(
                encrypt="real", fused=crypto == "fused"))
            with Session(real, device=cuda) as sr:
                enc, est = sr.matmul(a, b, round_idx=0)
            assert torch.equal(enc, got) and est.n_waited == gst.n_waited
            n = spec.code.n_workers
            assert est.dispatches == (7 if crypto == "fused" else
                                      3 + 2 * (n + est.n_waited))


def test_cuda_loop_error_target_round_matches_plain(cuda):
    a, b = _smooth_job(cuda, 240, 32, 16)
    spec = ClusterSpec.from_legacy_kwargs(
        "spacdc", wait_policy=ErrorTarget(5e-2), **LOOP_KW)
    with Session(spec, device=cuda) as sk, \
            Session(_plain(spec), device=cuda) as sp:
        want, wst = sp.matmul(a, b, round_idx=0)
        got, gst = sk.matmul(a, b, round_idx=0)
    assert not sk.engine.use_fused
    assert gst.n_waited == wst.n_waited and gst.dispatches == 2
    assert _rel(got, want) <= 1e-4


def test_cuda_threads_round_matches_the_plain_decode_of_its_responders(
        cuda):
    cs = _chip_smoke()
    spec = dataclasses.replace(ClusterSpec.paper_fig3(),
                               transport=TransportSpec(backend="threads"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn((1536, 256), generator=gen, device=cuda)
    b = torch.randn((256, 512), generator=gen, device=cuda)
    plain = _plain(spec).build_scheme()
    with Session(spec, device=cuda) as s:
        for r in range(2):
            n0 = _launches()
            out, st = s.matmul(a, b, round_idx=r)
            assert (_launches()[1] - n0[1], st.dispatches) == (2, 2)
            want = cs.threads_plain_decode(torch, plain, a, b, st)
            assert _rel(out, want) <= 1e-5
