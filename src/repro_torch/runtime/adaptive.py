"""Adaptive redundancy: fit straggler models online, retune the code.

Ports ``repro/runtime/adaptive.py`` (host numpy; its own copy, the port
imports nothing of the reference):

* :class:`OnlineStragglerEstimator` fits the ``StragglerModel`` families
  (markov on/off transition rates, pareto tail index, paper shift/scale)
  from baseline-subtracted, quantized arrival delays
  (``scheduler.observed_delays``) over a sliding window with change-point
  reset, blending per-worker congestion with ``WorkerHealth``'s EWMA
  latencies;
* :class:`AdaptiveController` picks, between rounds, the redundancy
  (N − K via ``k_blocks``, or GLCC's ``n_groups``), the wait policy and
  the decode ``fh_degree`` that minimize the predicted latency at the
  error target under the fitted model.  Error-vs-prefix profiles
  (:func:`error_profile`) are computed once per candidate on the host
  from the scheme's own masked decode.

Determinism: observations are quantized to a ``quantize_s`` grid, so the
same injected trace and seed give the same fits and the same decisions on
the virtual clock and on threads.  The objective's compute term
(``_compute_term``) reads the rounds' quantized fastest arrivals, which
carry the engine's measured per-worker compute time: two engines decide
alike when they see the same measurements (the tests fix that time; the
card's comparisons seed one engine's measurements into the other).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .scheduler import observed_delays
from .wait_policy import Deadline, FirstK, WaitPolicy

__all__ = [
    "FittedModel", "OnlineStragglerEstimator", "predict_wait",
    "error_profile", "Decision", "AdaptiveController",
]

_EPS = 1e-9


# --------------------------------------------------------------- estimator

@dataclasses.dataclass
class FittedModel:
    """One snapshot of the estimator's belief about the delay process."""
    mode: str = "paper"             # best-fitting StragglerModel family
    n_rounds: int = 0               # rounds in the fitting window
    congested_frac: float = 0.0     # fleet fraction of slow observations
    jitter_scale: float = 0.0       # background exponential scale (s)
    delay_s: float = 0.0            # congested-mode extra latency (s)
    p_fail: float = 0.0             # markov: P(OK -> congested) / round
    p_recover: float = 1.0          # markov: P(congested -> OK) / round
    pareto_shape: float = 2.0       # tail index of the slow cluster
    per_worker_congestion: Tuple[float, ...] = ()
    change_points: Tuple[int, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["per_worker_congestion"] = [round(float(p), 6)
                                      for p in self.per_worker_congestion]
        d["change_points"] = list(self.change_points)
        return d


def _two_means(obs: np.ndarray, iters: int = 25) -> Tuple[float, float, float]:
    """1-D 2-means over positive delay observations: (mean_lo, mean_hi,
    threshold).  Deterministic init (min/max)."""
    lo, hi = float(obs.min()), float(obs.max())
    if hi - lo < _EPS:
        return lo, hi, hi + _EPS
    c0, c1 = lo, hi
    for _ in range(iters):
        thr = 0.5 * (c0 + c1)
        left = obs[obs <= thr]
        right = obs[obs > thr]
        if left.size == 0 or right.size == 0:
            break
        n0, n1 = float(left.mean()), float(right.mean())
        if abs(n0 - c0) < _EPS and abs(n1 - c1) < _EPS:
            break
        c0, c1 = n0, n1
    return c0, c1, 0.5 * (c0 + c1)


class OnlineStragglerEstimator:
    """Sliding-window fit of the straggler process from arrival records.

    ``observe(round_idx, arrivals)`` feeds one round's recorded
    ``RoundStats.arrivals``; ``fitted()`` returns the current
    :class:`FittedModel`.
    """

    def __init__(self, n_workers: int, window: int = 64,
                 cp_window: int = 6, cp_threshold: float = 0.25,
                 quantize_s: float = 1e-3):
        self.n = int(n_workers)
        self.window = int(window)
        self.cp_window = int(cp_window)
        self.cp_threshold = float(cp_threshold)
        self.quantize_s = float(quantize_s)
        # [(round_idx, (N,) obs with NaN for unobserved), ...]
        self._rounds: List[Tuple[int, np.ndarray]] = []
        self.change_points: List[int] = []

    # -- ingestion -------------------------------------------------------
    def observe(self, round_idx: int,
                arrivals: Sequence[Tuple[float, int]]) -> None:
        obs = observed_delays(arrivals, self.n, self.quantize_s)
        self._rounds.append((int(round_idx), obs))
        if len(self._rounds) > self.window:
            del self._rounds[: len(self._rounds) - self.window]
        self._maybe_reset(int(round_idx))

    def _congested_frac_of(self, rounds, thr: float) -> float:
        vals = np.concatenate([o[np.isfinite(o)] for _, o in rounds]) \
            if rounds else np.empty(0)
        if vals.size == 0:
            return 0.0
        return float((vals > thr).mean())

    def _maybe_reset(self, round_idx: int) -> None:
        """Change-point check: the last ``cp_window`` rounds against the
        preceding ``cp_window`` on congested fraction and mean delay; a
        jump collapses the window to the recent rounds."""
        w = self.cp_window
        if len(self._rounds) < 2 * w:
            return
        pooled = self._pooled()
        if pooled.size < 4:
            return
        _, _, thr = _two_means(pooled)
        recent, prev = self._rounds[-w:], self._rounds[-2 * w: -w]
        f_new = self._congested_frac_of(recent, thr)
        f_old = self._congested_frac_of(prev, thr)
        m_new = self._mean_of(recent)
        m_old = self._mean_of(prev)
        ratio = (m_new + _EPS) / (m_old + _EPS)
        if (abs(f_new - f_old) > self.cp_threshold
                or ratio > 2.5 or ratio < 1.0 / 2.5):
            self.change_points.append(round_idx)
            self._rounds = self._rounds[-w:]

    @staticmethod
    def _mean_of(rounds) -> float:
        vals = np.concatenate([o[np.isfinite(o)] for _, o in rounds]) \
            if rounds else np.empty(0)
        return float(vals.mean()) if vals.size else 0.0

    def _pooled(self) -> np.ndarray:
        if not self._rounds:
            return np.empty(0)
        return np.concatenate([o[np.isfinite(o)] for _, o in self._rounds])

    # -- fitting ---------------------------------------------------------
    def fitted(self,
               health_latencies: Optional[np.ndarray] = None) -> FittedModel:
        """Fit the window.  ``health_latencies``: optional (N,) EWMA
        latency seconds from ``WorkerHealth.ewma_latencies()``, blended
        into the per-worker congestion (fleet fit 0.7, health z-score
        0.3)."""
        pooled = self._pooled()
        fm = FittedModel(n_rounds=len(self._rounds),
                         change_points=tuple(self.change_points))
        if pooled.size < 4:
            fm.per_worker_congestion = tuple(0.0 for _ in range(self.n))
            return fm
        mean_lo, mean_hi, thr = _two_means(pooled)
        bimodal = mean_hi > 3.0 * max(mean_lo, 1e-4)
        fast = pooled[pooled <= thr]
        slow = pooled[pooled > thr]
        if not bimodal:
            fast, slow = pooled, np.empty(0)

        # background jitter: exponential scale from the fast cluster,
        # corrected for the baseline (round minimum) subtraction
        n_obs = max(pooled.size // max(len(self._rounds), 1), 2)
        corr = 1.0 - 1.0 / n_obs
        fm.jitter_scale = float(fast.mean()) / max(corr, 0.5) \
            if fast.size else 0.0
        fm.congested_frac = float(slow.size) / float(pooled.size)
        if slow.size:
            # StragglerModel adds delay_s * (1 + U[0,1]) -> mean 1.5·delay_s
            fm.delay_s = max((float(slow.mean()) - float(fast.mean())) / 1.5,
                             0.0)
        # Hill estimator on the upper tail for the pareto family
        if pooled.size >= 8:
            tail = np.sort(pooled)[::-1]
            k = max(5, int(0.2 * tail.size))
            k = min(k, tail.size - 1)
            if k >= 2 and tail[k] > _EPS:
                logs = np.log(np.maximum(tail[:k], _EPS) / tail[k])
                s = float(logs.sum())
                fm.pareto_shape = float(np.clip(k / max(s, _EPS), 1.05, 50.0))

        # markov rates: pooled per-worker transitions across consecutive
        # observed rounds (congested := obs > thr)
        n00 = n01 = n10 = n11 = 0
        for (r0, o0), (r1, o1) in zip(self._rounds, self._rounds[1:]):
            if r1 != r0 + 1:
                continue
            both = np.isfinite(o0) & np.isfinite(o1)
            s0 = o0[both] > thr
            s1 = o1[both] > thr
            n00 += int((~s0 & ~s1).sum())
            n01 += int((~s0 & s1).sum())
            n10 += int((s0 & ~s1).sum())
            n11 += int((s0 & s1).sum())
        # a heavy tail also reads as "bimodal" to 2-means, so pareto is
        # recognized by its signature: a tiny slow fraction with a tail
        # that dwarfs the median, under a small fitted tail index
        heavy = (pooled.size >= 8 and fm.pareto_shape < 3.0 and
                 float(pooled.max()) > 6.0 * max(float(np.median(pooled)),
                                                 1e-4))
        if bimodal and fm.congested_frac >= 0.08 and (n01 or n10 or n11):
            fm.p_fail = n01 / max(n00 + n01, 1)
            fm.p_recover = n10 / max(n10 + n11, 1)
            # bursty iff congestion persists round-to-round more than an
            # i.i.d. process at the same occupancy would
            sticky = (n11 / max(n10 + n11, 1)) > fm.congested_frac + 0.1
            fm.mode = "markov" if sticky else "paper"
        elif heavy and fm.congested_frac < 0.08:
            fm.mode = "pareto"
        elif bimodal:
            fm.mode = "paper"

        # per-worker congestion probability: window fraction per worker,
        # blended with the health EWMA z-score when available
        frac = np.full(self.n, fm.congested_frac)
        counts = np.zeros(self.n)
        hits = np.zeros(self.n)
        for _, o in self._rounds:
            seen = np.isfinite(o)
            counts += seen
            hits += seen & (o > thr)
        have = counts > 0
        frac[have] = hits[have] / counts[have]
        if health_latencies is not None:
            h = np.asarray(health_latencies, np.float64)
            ok = np.isfinite(h)
            if ok.sum() >= 2:
                med = float(np.nanmedian(h))
                z = np.clip((h - med) / max(fm.delay_s, 10 * _EPS), 0.0, 1.0)
                z[~ok] = frac[~ok]
                frac = 0.7 * frac + 0.3 * z
        fm.per_worker_congestion = tuple(float(p) for p in frac)
        return fm


def predict_wait(fm: FittedModel, n_responders: int, n_workers: int) -> float:
    """Predicted seconds until the ``n_responders``-th of ``n_workers``
    arrivals under the fitted model: deterministic order statistics
    (quantile positions), no sampling."""
    n = int(n_workers)
    p = int(np.clip(n_responders, 1, n))
    if fm.mode == "pareto":
        # jitter + 0.25·delay_s·Pareto(α) quantiles (StragglerModel scale)
        q = (np.arange(1, n + 1) - 0.5) / n
        scale = 0.25 * max(fm.delay_s, fm.jitter_scale)
        alpha = max(fm.pareto_shape, 1.05)
        lat = fm.jitter_scale + scale * ((1.0 - q) ** (-1.0 / alpha) - 1.0)
    else:
        n_cong = int(round(fm.congested_frac * n))
        n_cong = min(max(n_cong, 0), n)
        n_fast = n - n_cong
        j = np.arange(1, n_fast + 1)
        fast = -fm.jitter_scale * np.log(1.0 - (j - 0.5) / max(n_fast, 1)) \
            if n_fast else np.empty(0)
        cong = np.full(n_cong, 1.5 * fm.delay_s + fm.jitter_scale)
        lat = np.concatenate([fast, cong])
    lat = np.sort(lat)
    return float(lat[p - 1])


# --------------------------------------------------------- error profiles

def _f64(x) -> np.ndarray:
    """A tensor (any device) or an array as float64 numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def error_profile(scheme, n_perms: int = 3, probe_dim: int = 32,
                  seed: int = 0) -> np.ndarray:
    """(N,) predicted relative decode error after each arrival prefix.

    Built on the host (CPU tensors, float64 numpy) on a fixed Gaussian
    probe with the scheme's OWN masked decode (``decode_matrix_masked``:
    the weights the engine's rounds apply), medianed over ``n_perms``
    fixed arrival permutations.  Schemes without a linear encoder get the
    threshold profile: 0 at/above ``min_responders``, inf below.
    """
    n = int(scheme.n_workers)
    prof = np.full(n, np.inf)
    try:
        enc = scheme.fused_encoder_matrix()
    except NotImplementedError:
        enc = None
    min_r = int(getattr(scheme, "min_responders",
                        getattr(scheme, "recovery_threshold", n)))
    if enc is None:
        prof[min_r - 1:] = 0.0
        return prof
    rng = np.random.default_rng(seed)
    k = int(getattr(scheme, "k_blocks", scheme.fused_out_blocks))
    m = k * max(probe_dim // k, 2)
    a = rng.standard_normal((m, probe_dim)).astype(np.float32)
    b = rng.standard_normal((probe_dim, probe_dim)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    den = max(float(np.linalg.norm(exact)), _EPS)
    blocks = _f64(scheme.fused_blocks(torch.from_numpy(a)))   # (J, blk, d)
    results = np.einsum("nj,jbd->nbd", _f64(enc),
                        blocks) @ b.astype(np.float64)        # (N, blk, q)
    errs = np.full((n_perms, n), np.inf)
    perm_rng = np.random.default_rng(12345)
    for pi in range(n_perms):
        order = np.arange(n) if pi == 0 else perm_rng.permutation(n)
        for p in range(min_r, n + 1):
            mask = np.zeros(n, np.float32)
            mask[order[:p]] = 1.0
            try:
                w = _f64(scheme.decode_matrix_masked(torch.from_numpy(mask)))
            except Exception:
                continue
            dec = np.einsum("kn,nbq->kbq", w, results)
            out = _f64(scheme.reconstruct_matmul(torch.from_numpy(dec), m,
                                                 probe_dim))
            errs[pi, p - 1] = np.linalg.norm(out - exact) / den
    return np.median(errs, axis=0)


# ------------------------------------------------------------- controller

@dataclasses.dataclass
class Decision:
    """One retune: what the controller chose and why."""
    round_idx: int
    overrides: Dict[str, int]           # {"k_blocks": K'} or {"n_groups": g}
    k_blocks: int
    n_groups: Optional[int]
    policy: str                         # wait-policy name
    policy_params: Dict[str, Any]
    fh_degree: int
    wait_for: int                       # predicted responders consumed
    predicted_wait_s: float
    predicted_rel_err: float

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["predicted_wait_s"] = round(float(self.predicted_wait_s), 6)
        d["predicted_rel_err"] = (float(f"{self.predicted_rel_err:.3e}")
                                  if np.isfinite(self.predicted_rel_err)
                                  else None)
        return d


class AdaptiveController:
    """Between-rounds controller: observe arrivals, refit, retune.

    ``build_scheme(**overrides)`` constructs a candidate scheme (the
    engine passes its registry-backed builder); candidates and their
    error profiles are cached for the controller's lifetime, so a retune
    costs a handful of host-side argmins.
    """

    def __init__(self, ad_spec, n_workers: int, base_scheme,
                 build_scheme: Callable[..., Any], seed: int = 0):
        self.spec = ad_spec
        self.n = int(n_workers)
        self.base_scheme = base_scheme
        self._build = build_scheme
        self.seed = int(seed)
        self.estimator = OnlineStragglerEstimator(
            self.n, window=ad_spec.window, cp_window=ad_spec.cp_window,
            cp_threshold=ad_spec.cp_threshold, quantize_s=ad_spec.quantize_s)
        self.decisions: List[Decision] = []
        self._observed = 0
        self._last_fit: Optional[FittedModel] = None
        self._schemes: Dict[Tuple[Tuple[str, int], ...], Any] = {}
        self._profiles: Dict[Tuple[Tuple[str, int], ...], np.ndarray] = {}
        # quantized round baselines (min arrival ≈ per-worker compute) per
        # active k_blocks: the compute term of the objective (per-worker
        # work scales as 1/K, so shrinking K is NOT free)
        self._baselines: Dict[int, List[float]] = {}
        self.candidates = self._enumerate_candidates()

    # -- candidate space -------------------------------------------------
    def _enumerate_candidates(self) -> List[Dict[str, int]]:
        base_k = int(getattr(self.base_scheme, "k_blocks",
                             self.base_scheme.fused_out_blocks))
        n = self.n
        max_red = self.spec.max_redundancy
        if max_red is None:
            max_red = n - 1
        lo_k = max(n - max_red, 1)
        hi_k = min(n - self.spec.min_redundancy, n - 1)
        ks = sorted(set([lo_k, hi_k, min(max(base_k, lo_k), hi_k)]))
        span = [k for k in range(lo_k, hi_k + 1)]
        # subsample the K axis to <= max_candidates, keeping endpoints + base
        while len(ks) < min(self.spec.max_candidates, len(span)):
            best, best_gap = None, -1
            for k in span:
                if k in ks:
                    continue
                gap = min(abs(k - e) for e in ks)
                if gap > best_gap:
                    best, best_gap = k, gap
            if best is None:
                break
            ks.append(best)
            ks.sort()
        cands = [{"k_blocks": k} for k in ks]
        # GLCC-style comms knob: sweep group counts at the base K
        if hasattr(self.base_scheme, "n_groups"):
            for g in range(1, base_k + 1):
                if base_k % g:
                    continue
                cand = {"k_blocks": base_k, "n_groups": g}
                try:
                    sch = self._scheme_for(cand)
                except Exception:
                    continue
                if int(sch.recovery_threshold) <= n:
                    cands.append(cand)
        return cands

    @staticmethod
    def _key(overrides: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted(overrides.items()))

    def _scheme_for(self, overrides: Dict[str, int]):
        key = self._key(overrides)
        if key not in self._schemes:
            self._schemes[key] = self._build(**overrides)
        return self._schemes[key]

    def _profile_for(self, overrides: Dict[str, int]) -> np.ndarray:
        key = self._key(overrides)
        if key not in self._profiles:
            self._profiles[key] = error_profile(self._scheme_for(overrides),
                                                seed=self.seed)
        return self._profiles[key]

    # -- the loop --------------------------------------------------------
    def observe(self, round_idx: int,
                arrivals: Sequence[Tuple[float, int]],
                k_blocks: Optional[int] = None) -> None:
        self.estimator.observe(round_idx, arrivals)
        self._observed += 1
        if arrivals and k_blocks:
            q = self.spec.quantize_s
            base = round(min(float(t) for t, _ in arrivals) / q) * q
            hist = self._baselines.setdefault(int(k_blocks), [])
            hist.append(base)
            if len(hist) > self.spec.window:
                del hist[: len(hist) - self.spec.window]

    def _compute_term(self, k_blocks: int) -> float:
        """Predicted per-worker compute seconds at ``k_blocks``, off the
        quantized baselines of observed rounds (per-worker work ∝ 1/K,
        extrapolated from the nearest K with data); 0 before any round."""
        if not self._baselines:
            return 0.0
        if k_blocks in self._baselines:
            return float(np.median(self._baselines[k_blocks]))
        near = min(self._baselines, key=lambda k: abs(k - k_blocks))
        return float(np.median(self._baselines[near])) * near / k_blocks

    def maybe_decide(self, round_idx: int,
                     health=None) -> Optional[Decision]:
        """Retune if due: after ``warmup_rounds`` observations, every
        ``retune_every`` rounds.  Returns the new :class:`Decision` (also
        appended to ``self.decisions``) or None."""
        sp = self.spec
        if self._observed < sp.warmup_rounds:
            return None
        if (self._observed - sp.warmup_rounds) % sp.retune_every:
            return None
        lats = None
        if health is not None:
            try:
                lats = health.ewma_latencies()
            except AttributeError:
                lats = None
        fit = self.estimator.fitted(lats)
        self._last_fit = fit
        best = None   # (wait, k, cand, p_needed, err)
        for cand in self.candidates:
            prof = self._profile_for(cand)
            scheme = self._scheme_for(cand)
            min_r = int(getattr(scheme, "min_responders", 1))
            ok = np.flatnonzero(prof <= sp.target_rel_err) + 1
            ok = ok[ok >= min_r]
            if ok.size:
                p_needed = int(ok[0])
            else:
                p_needed = int(np.argmin(prof)) + 1
            err = float(prof[p_needed - 1])
            k = int(cand["k_blocks"])
            wait = predict_wait(fit, p_needed, self.n) \
                + self._compute_term(k)
            # prefer less redundancy (higher K) on near-ties: a candidate
            # only displaces the incumbent on a ~2% latency improvement
            if (best is None or wait < best[0] * 0.98
                    or (wait <= best[0] * 1.02 and k > best[1])):
                best = (wait, k, cand, p_needed, err)
        pred_wait, _, cand, p_needed, err = best
        if sp.latency_budget_s is not None and pred_wait > sp.latency_budget_s:
            pol_name, pol_params = "deadline", {
                "t_budget": sp.latency_budget_s}
        else:
            pol_name, pol_params = "first_k", {"k": p_needed}
        fh = int(np.clip(p_needed - 2, 1, 3))
        dec = Decision(
            round_idx=int(round_idx), overrides=dict(cand),
            k_blocks=int(cand["k_blocks"]),
            n_groups=cand.get("n_groups"),
            policy=pol_name, policy_params=pol_params, fh_degree=fh,
            wait_for=p_needed, predicted_wait_s=pred_wait,
            predicted_rel_err=err)
        self.decisions.append(dec)
        return dec

    def policy_for(self, dec: Decision) -> WaitPolicy:
        if dec.policy == "deadline":
            return Deadline(dec.policy_params["t_budget"])
        return FirstK(dec.policy_params["k"])

    def scheme_for(self, dec: Decision):
        return self._scheme_for(dec.overrides)

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        fit = self._last_fit or self.estimator.fitted()
        return {
            "policy": self.spec.policy,
            "rounds_observed": self._observed,
            "fitted": fit.to_dict(),
            "candidates": [dict(c) for c in self.candidates],
            "decisions": [d.to_dict() for d in self.decisions],
        }
