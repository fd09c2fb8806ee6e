"""Closed loop of coded rounds: ``Session(spec).matmul`` on one job.

One master: each round waits for the previous one (the paper's
Algorithm-2 loop), a round being ``Session.matmul`` returning its output
and a device sync.  The job A @ B and the T noise blocks are made on the
device from the seed in set-up and are the same every round; round r
draws the straggler set of round r (rounds are numbered from 0 through
set-up and the window), so each round decodes from other responders.

The job is A (rows, hidden_size) @ B (hidden_size, intermediate_size),
both standard Gaussian.  The traffic file names the rows, the wait
policy (``wait``: a ``WaitSpec``'s fields), the warm-up rounds and how
many rounds of the window the check compares.

The check: a reservoir sample, drawn from the seed, of the window's
rounds keeps rows of their outputs; once the window has closed, each is
compared with the same rows of the reference's decode of that round.
Slot j of the reservoir keeps the j-th of ``sample_rounds`` parts of a
permutation of the rows drawn from the seed, so the samples together
cover every row once and hold one output's worth, not ``sample_rounds``.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import work
from perfbench.core import Check, seed_of

# seed purposes
_A, _B, _NOISE, _CLUSTER, _SAMPLE, _ROWS = 1, 2, 3, 4, 5, 6
# the compared number's limit: see PERF.md §2 for the readings it was
# set from
LIMIT_REL_MAX_ERR = 2e-4


def gaussian(torch, shape, seed: int, device):
    """A standard normal float32 operand from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.torch = cell.torch
        cfg, tr = cell.config, cell.traffic
        d, ff = cfg["hidden_size"], cfg["intermediate_size"]
        self.shape_a, self.shape_b = (tr["rows"], d), (d, ff)
        self.cluster_seed = seed_of(cell.seed, _CLUSTER)
        self.sample_k = int(tr["sample_rounds"])
        self.rounds = []            # wall seconds of each window round
        self.samples = []           # reservoir: (round index, its rows)

    # ---- the program ---------------------------------------------------
    def setup(self) -> None:
        torch, cell = self.torch, self.cell
        from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec,
                                     Session, StragglerSpec, WaitSpec)
        cfg, tr = cell.config, cell.traffic
        spec = ClusterSpec(
            code=CodeSpec(scheme=cfg["scheme"], n_workers=cfg["n_workers"],
                          k_blocks=cfg["k_blocks"], fused=cfg["fused"]),
            privacy=PrivacySpec(t_colluding=cfg["t_colluding"],
                                noise_scale=cfg["noise_scale"]),
            wait=WaitSpec(**tr["wait"]),
            straggler=StragglerSpec(n_stragglers=cfg["n_stragglers"],
                                    delay_s=cfg["delay_s"],
                                    jitter_scale=cfg["jitter_scale"],
                                    mode=cfg["straggler_mode"]),
            seed=self.cluster_seed)
        self._inputs()
        self.session = Session(spec, device=cell.device)
        # every shape once, and as many rows held as the window's
        # reservoir holds, so that the window allocates nothing new
        held = []
        for r in range(tr["warmup_rounds"]):
            out = self._round(r)[0]
            held.append(out.index_select(0, self.rows[r % self.sample_k]))
            del held[: -self.sample_k], out
        del held
        self.next_round = int(tr["warmup_rounds"])

    def _inputs(self) -> None:
        """A, B and the T noise blocks, on the device from the seed, and
        the rows each reservoir slot keeps."""
        torch, cell = self.torch, self.cell
        cfg, dev = cell.config, cell.device
        self.a = gaussian(torch, self.shape_a, seed_of(cell.seed, _A), dev)
        self.b = gaussian(torch, self.shape_b, seed_of(cell.seed, _B), dev)
        blk = -(-self.shape_a[0] // cfg["k_blocks"])
        self.noise = cfg["noise_scale"] * gaussian(
            torch, (cfg["t_colluding"] * blk, self.shape_a[1]),
            seed_of(cell.seed, _NOISE), dev).reshape(
            cfg["t_colluding"], blk, self.shape_a[1])
        gen = torch.Generator()
        gen.manual_seed(seed_of(cell.seed, _ROWS))
        perm = torch.randperm(self.shape_a[0], generator=gen)
        self.rows = [part.sort().values.to(dev)
                     for part in torch.tensor_split(perm, self.sample_k)]

    def _round(self, r: int):
        out, stats = self.session.matmul(self.a, self.b, round_idx=r,
                                         noise=self.noise)
        if self.cell.device.type == "cuda":
            self.torch.cuda.synchronize()
        return out, stats

    def window(self, seconds: float, tracer) -> None:
        rng = np.random.default_rng(seed_of(self.cell.seed, _SAMPLE))
        span = tracer.span
        tracer.start()
        r, seen = self.next_round, 0
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        self.t0_ns = t0
        t_last = t0
        while t_last < end:
            ts = time.perf_counter_ns()
            with span("Session.matmul"):
                out, _ = self.session.matmul(self.a, self.b, round_idx=r,
                                             noise=self.noise)
            with span("sync"):
                if self.cell.device.type == "cuda":
                    self.torch.cuda.synchronize()
            te = time.perf_counter_ns()
            if te > end:
                break
            self.rounds.append((te - ts) / 1e9)
            t_last = te
            # reservoir sampling: every round of the window equally likely
            j = seen if seen < self.sample_k else int(
                rng.integers(0, seen + 1))
            if j < self.sample_k:
                kept = (r, out.index_select(0, self.rows[j]))
                if j == len(self.samples):
                    self.samples.append(kept)
                else:
                    self.samples[j] = kept
            seen += 1
            r += 1
        del out
        self.t1_ns = t_last
        tracer.stop()

    def end_to_end(self) -> dict:
        wall = (self.t1_ns - self.t0_ns) / 1e9
        return {"round_ms": 1e3 * wall / len(self.rounds),
                "round_p95_ms": 1e3 * float(np.percentile(self.rounds, 95))}

    def work(self) -> dict:
        """Operations and bytes of one round, from the shapes."""
        cfg = self.cell.config
        m, d = self.shape_a
        return work.coded_round_work(m, d, self.shape_b[1],
                                     cfg["n_workers"], cfg["k_blocks"],
                                     cfg["t_colluding"],
                                     self.n_responders)

    @property
    def n_responders(self) -> int:
        """The results a round's decode waits for: all but the S
        stragglers (FixedQuantile)."""
        cfg = self.cell.config
        return max(cfg["n_workers"] - cfg["n_stragglers"], 1)

    @property
    def n_units(self) -> int:
        """Rounds completed in the window."""
        return len(self.rounds)

    def release(self) -> None:
        self.session.close()
        del self.session
        if self.cell.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # ---- the check -----------------------------------------------------
    def check(self):
        ref_mod = self.cell.reference()
        ref = ref_mod.Round(self.cell.config, self.a, self.b, self.noise,
                            self.cluster_seed)
        worst, failed = 0.0, 0
        for j, (r, got) in enumerate(self.samples):
            err = ref_mod.rel_max_err(
                got, ref.expected(r).index_select(0, self.rows[j]))
            if not np.isfinite(err):
                failed += 1
            worst = max(worst, err)
        return ([Check("round_rel_max_err", worst, LIMIT_REL_MAX_ERR)],
                len(self.rounds), failed)

    def control(self, precision: str, rounds: int):
        """The check's numbers with the reference computed in
        ``precision`` in the program's place, over ``rounds`` rounds of
        the window's numbering, round i compared on slot i's rows."""
        self._inputs()
        ref_mod = self.cell.reference()
        args = (self.cell.config, self.a, self.b, self.noise,
                self.cluster_seed)
        ref, low = ref_mod.Round(*args), ref_mod.Round(*args, precision)
        first = int(self.cell.traffic["warmup_rounds"])
        worst = 0.0
        for i in range(rounds):
            rows = self.rows[i % self.sample_k]
            worst = max(worst, ref_mod.rel_max_err(
                low.expected(first + i).index_select(0, rows),
                ref.expected(first + i).index_select(0, rows)))
        return [Check("round_rel_max_err", worst, LIMIT_REL_MAX_ERR)]
