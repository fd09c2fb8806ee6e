"""Straggler models for the simulated master/worker runtime (paper §VII-B:
artificial delays via sleep()) and for SPMD responder-mask schedules.

Ports ``repro/runtime/straggler.py`` close to verbatim (numpy only): the
same seed and round give exactly the reference's delays in every mode.

Three delay modes (``mode=``):

* ``"paper"`` (default, bit-identical to the seed): S of N workers get
  ``delay_s`` extra latency with uniform scatter, everyone gets
  exponential background jitter — the paper's sleep() injection.
* ``"pareto"``: heavy-tailed per-worker delays, ``jitter + Pareto(shape)``
  scaled so the tail routinely dwarfs the median — the regime where
  anytime decoding's error-vs-latency curve matters most (real clusters
  are closer to this than to uniform sleep injection).
* ``"markov"``: bursty on/off congestion.  Each worker carries a hidden
  two-state Markov chain over rounds (OK ↔ congested with transition
  probabilities ``p_fail`` / ``p_recover``); congested workers pay
  ``delay_s``-scale latency.  Straggler sets are *correlated across
  rounds* — the burst pattern threshold schemes have no answer to.
* ``"shifting_markov"``: the markov chain under a deterministic schedule
  of transition-rate regimes — every ``regime_len`` rounds the chain's
  ``(p_fail, p_recover)`` jumps to the next entry of ``regimes`` (cycling).
  This is the non-stationary trace the adaptive controller
  (``runtime.adaptive``) is benchmarked against: a fixed redundancy /
  wait policy tuned for one regime is wrong in the next.

Parameters are validated at construction (and again at
``StragglerSpec`` construction) rather than deep inside ``delays()``:
probabilities outside [0, 1] and Pareto tails with α ≤ 1 (undefined
mean — every latency-at-error prediction would diverge) are rejected
up front.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STRAGGLER_MODES = ("paper", "pareto", "markov", "shifting_markov")

# the default regime schedule for "shifting_markov": a calm regime
# (rare congestion, fast recovery) alternating with a congested one
# (frequent congestion, slow recovery) — shared by bench_adaptive and
# the estimator tests so both exercise the same regime shift
DEFAULT_SHIFT_REGIMES = ((0.05, 0.6), (0.45, 0.15))


@dataclasses.dataclass
class StragglerModel:
    """Per-epoch straggler assignment: S of N workers get `delay_s` extra
    latency (the paper's setup); optionally exponential background jitter.

    ``delays(round_idx)`` is deterministic per (seed, round) in every mode.
    """
    n_workers: int
    n_stragglers: int
    delay_s: float = 0.02
    jitter_scale: float = 0.002
    seed: int = 0
    mode: str = "paper"          # see STRAGGLER_MODES
    pareto_shape: float = 1.5    # tail index (smaller = heavier tail)
    p_fail: float = 0.1          # markov: P(OK -> congested) per round
    p_recover: float = 0.5       # markov: P(congested -> OK) per round
    # shifting_markov: ((p_fail, p_recover), ...) regime schedule, cycled
    # every ``regime_len`` rounds; () = DEFAULT_SHIFT_REGIMES
    regimes: tuple = ()
    regime_len: int = 40

    def __post_init__(self):
        if self.mode not in STRAGGLER_MODES:
            raise ValueError(f"unknown straggler mode {self.mode!r} "
                             f"({' | '.join(STRAGGLER_MODES)})")
        if self.delay_s < 0 or self.jitter_scale < 0:
            raise ValueError("straggler: delay_s and jitter_scale must "
                             "be >= 0")
        if not 1.0 < self.pareto_shape:
            raise ValueError(
                f"straggler: pareto_shape must be > 1 (α ≤ 1 has an "
                f"undefined mean — no finite latency prediction exists), "
                f"got {self.pareto_shape!r}")
        for name in ("p_fail", "p_recover"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"straggler: {name} must be in [0, 1], "
                                 f"got {v!r}")
        if self.regime_len < 1:
            raise ValueError("straggler: regime_len must be >= 1")
        regimes = tuple(tuple(float(p) for p in r) for r in self.regimes)
        if self.mode == "shifting_markov" and not regimes:
            regimes = DEFAULT_SHIFT_REGIMES
        for r in regimes:
            if len(r) != 2 or not all(0.0 <= p <= 1.0 for p in r):
                raise ValueError(
                    f"straggler: each regime must be a (p_fail, p_recover) "
                    f"pair in [0, 1]^2, got {r!r}")
        object.__setattr__(self, "regimes", regimes)

    def regime_at(self, round_idx: int) -> int:
        """Index into ``regimes`` active at ``round_idx`` (0 outside
        shifting_markov mode)."""
        if self.mode != "shifting_markov" or not self.regimes:
            return 0
        return (round_idx // self.regime_len) % len(self.regimes)

    def _markov_params(self, round_idx: int):
        """The chain's (p_fail, p_recover) at ``round_idx`` — constant for
        "markov", schedule-driven for "shifting_markov"."""
        if self.mode == "shifting_markov":
            return self.regimes[self.regime_at(round_idx)]
        return self.p_fail, self.p_recover

    def _rng(self, round_idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, round_idx]))

    def delays(self, round_idx: int) -> np.ndarray:
        if self.mode == "pareto":
            return self._pareto_delays(round_idx)
        if self.mode in ("markov", "shifting_markov"):
            return self._markov_delays(round_idx)
        # "paper": the seed's exact construction — same rng stream, same
        # draw order, so existing traces reproduce bit-identically
        rng = self._rng(round_idx)
        d = rng.exponential(self.jitter_scale, self.n_workers)
        if self.n_stragglers:
            idx = rng.choice(self.n_workers, self.n_stragglers, replace=False)
            d[idx] += self.delay_s * (1.0 + rng.random(self.n_stragglers))
        return d

    def _pareto_delays(self, round_idx: int) -> np.ndarray:
        """Heavy tail: every worker draws jitter + scaled Pareto excess.
        The scale is set so the *median* worker sits near the paper mode's
        jitter while the tail reaches multiples of ``delay_s``."""
        rng = self._rng(round_idx)
        jitter = rng.exponential(self.jitter_scale, self.n_workers)
        excess = rng.pareto(self.pareto_shape, self.n_workers)
        return jitter + self.delay_s * 0.25 * excess

    def _markov_states(self, round_idx: int) -> np.ndarray:
        """Boolean congested-state vector at ``round_idx``, evolved from
        round 0 (initial states: the ``n_stragglers`` lowest worker ids
        congested) — O(round_idx · N), deterministic, uncached on purpose
        (bench sweeps re-enter rounds arbitrarily)."""
        state = np.zeros(self.n_workers, bool)
        state[: self.n_stragglers] = True
        for r in range(round_idx + 1):
            p_fail, p_recover = self._markov_params(r)
            # a stream distinct from the jitter draw of the same round
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, r, 1]))
            u = rng.random(self.n_workers)
            fail = ~state & (u < p_fail)
            recover = state & (u < p_recover)
            state = (state | fail) & ~recover
        return state

    def _markov_delays(self, round_idx: int) -> np.ndarray:
        rng = self._rng(round_idx)
        d = rng.exponential(self.jitter_scale, self.n_workers)
        state = self._markov_states(round_idx)
        if state.any():
            d[state] += self.delay_s * (1.0 + rng.random(int(state.sum())))
        return d

    def responder_mask(self, round_idx: int, wait_for: int) -> np.ndarray:
        """Boolean mask of the `wait_for` fastest workers this round."""
        d = self.delays(round_idx)
        order = np.argsort(d)
        mask = np.zeros(self.n_workers, bool)
        mask[order[:wait_for]] = True
        return mask
