"""The harness end to end on the CPU: a run at tiny sizes comes out
correct, the command refuses without a card and outside a checkout, and
nothing it loads is JAX or the JAX package.  CPU only."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import core
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = core.load_json(ROOT / "BENCHMARK.json")


def run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("workload", sorted(tiny.FOR))
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(workload, trace):
    res = core.run_cell(BENCH, workload, 2**31 + 977, 1.5, trace,
                        device="cpu", adjust=tiny.FOR[workload])
    assert res["correct"], core.check_lines(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    line = json.loads(core.result_line(res))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    want = {m["name"] for m in core.metrics_for(BENCH, workload, trace)}
    if trace:
        # off the card no device metric is read
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def _driver(workload, seed):
    cell = core.make_cell(BENCH, workload, seed, 0.1, False, "cpu")
    tiny.FOR[workload](cell)
    return cell.driver()


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_same_seed_gives_the_same_inputs(seed):
    import torch
    a, b, c = (_driver("fig3.ffn_up", s) for s in (seed, seed, seed + 1))
    for d in (a, b, c):
        d._inputs()
    assert torch.equal(a.a, b.a) and torch.equal(a.b, b.b)
    assert torch.equal(a.noise, b.noise) and a.cluster_seed == b.cluster_seed
    assert not torch.equal(a.a, c.a)
    a, b = _driver("phi3.train_4k", seed), _driver("phi3.train_4k", seed)
    for d in (a, b):
        d._seed_feed()
    for _ in range(3):
        (ba, ma), (bb, mb) = a._feed(), b._feed()
        assert torch.equal(ba["tokens"], bb["tokens"])
        assert (ma == mb).all() and ma.sum() == 3


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(["perfbench/run.py", "--workload", "fig3.ffn_up", "--seed",
               "1", "--seconds", "1", "--trace", "0"], env=env)
    assert out.returncode == core.EXIT_NO_DEVICE
    assert out.stdout == ""


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(["perfbench/run.py", "--workload", "fig3.ffn_up", "--seed",
               "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


ISOLATION = """
import sys
sys.path[0:0] = [{root!r}, {src!r}]
from pathlib import Path
from perfbench import core
mods = {mods!r}
for kind, name in mods:
    core.load_module(kind, name)
{extra}
found = sorted({{m.split(".")[0] for m in sys.modules}} & set({forbidden!r}))
print(found)
"""


def _modules(kind):
    return [(kind, p.stem) for p in sorted((ROOT / "perfbench" / kind)
                                           .glob("*.py"))]


def _isolated(mods, forbidden, extra=""):
    code = ISOLATION.format(root=str(ROOT), src=str(ROOT / "src"),
                            mods=mods, forbidden=forbidden, extra=extra)
    out = run(["-c", code])
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_nothing_the_harness_loads_is_jax():
    mods = (_modules("drivers") + _modules("metrics") +
            _modules("reference"))
    extra = ("import runpy\n"
             "import perfbench.devtrace, perfbench.work, perfbench.peaks\n"
             "import perfbench.lm_weights, perfbench.kernel_classes\n"
             "import repro_torch.api, repro_torch.models\n"
             "import repro_torch.launch.steps, repro_torch.optim\n"
             "runpy.run_path(str(Path(core.BENCH / 'run.py')))\n")
    assert _isolated(mods, ["jax", "jaxlib", "flax", "repro"],
                     extra) == "[]"


def test_the_references_load_neither_jax_nor_the_port():
    assert _isolated(_modules("reference"),
                     ["jax", "jaxlib", "flax", "repro",
                      "repro_torch"]) == "[]"
