"""The controls come out not correct: the reference computed in the
precision below the configuration's, put in the program's place, fails
one of the cell's numbers (TF32 products for the float32 round, fp8
products for bf16 training), and so does the training fault read on the
chip (half of each step's micro-batches).  The readings at the cells'
own sizes are ``perfbench/readings.py``'s, on the chip (PERF.md §2); here
at a size a test run holds, on the CPU."""

import pytest

from perfbench.tests.test_perfbench_harness import _driver


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_tf32_round_is_not_correct(seed):
    checks = _driver("fig3.ffn_up", seed).control("tf32", 8)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_step_is_not_correct(seed):
    checks = _driver("phi3.train_4k", seed).control("fp8")
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_half_the_batch_is_not_correct(seed):
    checks = _driver("phi3.train_4k", seed).control("float32", rows="half")
    assert not all(c.ok for c in checks), checks
