"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip, plants one fault in the
program at tiny sizes on the CPU, drives the rest of a run
(``core.run_cell``) and sees ``correct`` false: for each fault a cell
can have.  The cells are one chip each, so no exchange between chips is
left out.  The sound run at the same sizes comes out correct
(``test_perfbench_harness.py``).  CPU only."""

import pytest
import torch

from perfbench import core
from perfbench.tests import tiny

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")


def _run(workload):
    return core.run_cell(BENCH, workload, 2**31 + 4242, 1.5, False,
                         device="cpu", adjust=tiny.FOR[workload])


# ---- the coded round: the answer is the round's (m, n) product ----------

def _round_fault(kind):
    from repro_torch.runtime.engine import RoundEngine
    real = RoundEngine._matmul_fused
    first = {}

    def faulty(self, a, b, round_idx, noise=None):
        out, stats = real(self, a, b, round_idx, noise)
        if kind == "state_unchanged":       # every round the first answer
            out = first.setdefault("out", out)
        elif kind == "half_left_out":       # half the rows never computed
            out = out.clone()
            out[out.shape[0] // 2:] = 0.0
        elif kind == "answer_altered":      # one element where produced
            out = out.clone()
            out[3, 5] += 1.0
        return out, stats
    return faulty


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
def test_a_broken_round_is_not_correct(kind, monkeypatch):
    from repro_torch.runtime.engine import RoundEngine
    monkeypatch.setattr(RoundEngine, "_matmul_fused", _round_fault(kind))
    res = _run("fig3.ffn_up")
    assert not res["correct"], core.check_lines(res)


# ---- the coded training step ----------------------------------------------

def _step_fault(kind, real_build, from_step):
    def build(model, opt, **kw):
        step = real_build(model, opt, **kw)
        calls = []

        def faulty(params, state, batch, mask):
            calls.append(1)
            if len(calls) < from_step:
                return step(params, state, batch, mask)
            if kind == "state_unchanged":
                keep = {n: p.detach().clone() for n, p in params.items()}
                mu = {n: m.clone() for n, m in state.mu.items()}
                nu = {n: v.clone() for n, v in state.nu.items()}
            if kind == "half_left_out":
                # the second micro-batch of every block replaced by the
                # first: the mean over the micro-batches is the first's
                batch = {k: v.clone() for k, v in batch.items()}
                for v in batch.values():
                    v[1::2] = v[0::2]
            params, new_state, metrics = step(params, state, batch, mask)
            if kind == "state_unchanged":
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(keep[n])
                    for n in mu:
                        new_state.mu[n].copy_(mu[n])
                        new_state.nu[n].copy_(nu[n])
            if kind == "answer_altered":
                metrics = dict(metrics, loss=metrics["loss"] * 1.01)
            return params, new_state, metrics
        return faulty
    return build


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
# from step 1, set-up's; from step 2, the window's first, once the step
# object is warm
@pytest.mark.parametrize("from_step", [1, 2])
def test_a_broken_step_is_not_correct(kind, from_step, monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "build_train_step",
                        _step_fault(kind, steps.build_train_step, from_step))
    res = _run("phi3.train_4k")
    assert not res["correct"], core.check_lines(res)
