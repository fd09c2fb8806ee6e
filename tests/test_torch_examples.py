"""The five examples of the PyTorch port (``examples/*_torch.py``) on the
CPU.

``quickstart_torch.py`` and ``anytime_decode_torch.py`` run as
subprocesses with ``--device cpu`` beside their JAX twins
(``examples/quickstart.py``, ``examples/anytime_decode.py``, the JAX
package on the CPU): both exit 0, and the rounds' decisions (how many
workers each round waited for, which prefixes each scheme can decode)
are the same lines.  Times and errors are not compared: arrival times
embed each package's measured compute time, and the quickstart's
hands-on encode draws its own noise.  The serving, MNIST and LM-training
demos run at the JAX twins' own flags (the LM demo's step count cut
through its module constant).
"""

import os
import re
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] +
                   [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [script] if script == "-c" else [str(EXAMPLES / script)]
    proc = subprocess.run([sys.executable, *cmd, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, (script, proc.returncode,
                                  proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def _waited(text: str) -> list:
    """Every round's responder count as printed: "from 16/20 workers",
    "decoded from 17/20", "fixed_quantile: waited 15/20"."""
    return re.findall(r"(?:(\w+): waited|from) +(\d+)/(\d+)", text)


def _ready_pattern(text: str) -> list:
    """Per curve point: whether the scheme could decode that prefix."""
    return re.findall(r"after +(\d+) arrivals \(t= *[\d.]+ ms\): best err "
                      r"(-|[\d.]+)", text)


def test_quickstart_decisions_match_the_jax_twin():
    port = _run("quickstart_torch.py", "--device", "cpu")
    ref = _run("quickstart.py")
    assert _waited(port) == _waited(ref), (port, ref)
    assert len(_waited(port)) == 2
    assert "spec round-trips: True" in port
    assert "encrypted bit-exactly" in port
    privacy = [re.search(r"bits/elem\): ([\d.]+)", t).group(1)
               for t in (port, ref)]
    assert abs(float(privacy[0]) - float(privacy[1])) <= 1e-5 * float(
        privacy[1])
    rmse = float(re.search(r"rel-RMSE = ([\d.]+)", port).group(1))
    assert rmse < 0.25


def test_anytime_decisions_match_the_jax_twin():
    port = _run("anytime_decode_torch.py", "--device", "cpu")
    ref = _run("anytime_decode.py")
    assert _waited(port) == _waited(ref), (port, ref)
    assert [p for p, _, _ in _waited(port)] == [
        "fixed_quantile", "deadline", "error_target"]
    got = [(n, err == "-") for n, err in _ready_pattern(port)]
    want = [(n, err == "-") for n, err in _ready_pattern(ref)]
    assert got == want and len(got) == 40      # spacdc's curve, then mds's
    assert not any(dash for _, dash in got[:20])     # rateless: every prefix


def test_serve_demo_runs():
    out = _run("serve_demo_torch.py", "--device", "cpu")
    assert "served 6 requests" in out
    m = re.search(r"(\d+)/(\d+) steps decoded in budget", out)
    assert m and m.group(1) == m.group(2), out


def test_spacdc_dl_mnist_runs():
    out = _run("spacdc_dl_mnist_torch.py", "--device", "cpu", "--epochs",
               "1")
    rows = dict((s, (float(acc), float(t))) for s, acc, t in re.findall(
        r"^(\w+) +final acc=([\d.]+) time= *([\d.]+)s", out, re.M))
    assert sorted(rows) == ["conv", "matdot", "mds", "spacdc"], out
    assert all(acc >= 0.95 for acc, _ in rows.values()), rows
    # Fig. 3's point: conv waits on every straggler, spacdc on none
    assert rows["conv"][1] > rows["spacdc"][1], rows


def test_coded_lm_training_runs(tmp_path):
    """The JAX twin's flags with 12 steps and the pod lost at step 8 (not
    90 and 60), set through the example's ``ARGS`` in a fresh process."""
    driver = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location(
    "demo", {str(EXAMPLES / "coded_lm_training_torch.py")!r})
demo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(demo)
args = list(demo.ARGS)
for flag, value in (("--steps", "12"), ("--elastic-at", "8"),
                    ("--log-every", "4"),
                    ("--ckpt-dir", {str(tmp_path / "ckpt")!r})):
    args[args.index(flag) + 1] = value
demo.ARGS = args
demo.CKPT_DIR = {str(tmp_path / "ckpt")!r}
demo.main(["--device", "cpu"])
"""
    out = _run("-c", driver)
    steps = re.findall(r"step +(\d+) loss=([\d.]+) responders=(\d)/4", out)
    assert [int(s) for s, _, _ in steps] == [4, 8, 12], out
    assert all(int(r) < 4 for _, _, r in steps[1:]), out    # pod lost
    assert out.rstrip().endswith("done")
    assert (tmp_path / "ckpt").is_dir()
