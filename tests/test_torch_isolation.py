"""The port stands alone: no file of ``src/repro_torch`` (and not
``chip_smoke.py`` or the port's ``examples/*_torch.py``) imports JAX or anything of the JAX package ``repro``, at
any depth — imports inside functions included — and importing the public
surface leaves both out of ``sys.modules``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    """Every absolute module name the file imports, anywhere in it, with
    ``__import__("x")`` / ``importlib.import_module("x")`` calls too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield node.args[0].value, node.lineno


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/api/session.py",
                 "src/repro_torch/runtime/engine.py",
                 "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/crypto/mea_ecc.py",
                 "src/repro_torch/kernels/encrypted_round.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/models/encdec.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/models/coded.py",
                 "src/repro_torch/runtime/serve_loop.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/runtime/faults.py",
                 "src/repro_torch/runtime/adaptive.py",
                 "src/repro_torch/runtime/wire.py",
                 "src/repro_torch/runtime/socket_transport.py",
                 "src/repro_torch/launch/worker.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/optim/optimizers.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/checkpointer.py",
                 "src/repro_torch/dist/compression.py",
                 "src/repro_torch/kernels/flash_attention_bwd.py",
                 "src/repro_torch/tree.py",
                 "chip_smoke.py", "examples/quickstart_torch.py",
                 "examples/anytime_decode_torch.py",
                 "examples/spacdc_dl_mnist_torch.py",
                 "examples/serve_demo_torch.py",
                 "examples/coded_lm_training_torch.py"):
        assert must in names
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_port_file_imports_jax_or_the_reference(path):
    bad = [(m, line) for m, line in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.api, repro_torch.kernels, "
            "repro_torch.runtime.engine, repro_torch.crypto, "
            "repro_torch.kernels.encrypted_round, repro_torch.models, "
            "repro_torch.configs, repro_torch.models.coded, "
            "repro_torch.models.moe, "
            "repro_torch.runtime.serve_loop, repro_torch.launch.serve, "
            "repro_torch.runtime.faults, repro_torch.runtime.adaptive, "
            "repro_torch.runtime.wire, repro_torch.runtime.socket_transport, "
            "repro_torch.launch.worker, repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.optim, "
            "repro_torch.data.pipeline, repro_torch.checkpoint, "
            "repro_torch.dist.compression, "
            "repro_torch.kernels.flash_attention_bwd\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr



def test_a_spawned_worker_loads_neither_jax_nor_repro(tmp_path):
    """A mesh worker's whole path in a process of its own, as the master
    spawns it: ``python -m repro_torch.launch.worker`` registers with a
    listening master, runs a plain and a sealed task and obeys SHUTDOWN.
    ``-X importtime`` lists every module the process imported, lazily
    imported ones too: neither JAX nor the reference is among them."""
    import pickle
    import socket

    import torch

    from repro_torch.crypto import MEAECC, generate_keypair
    from repro_torch.runtime import wire
    from repro_torch.runtime.tasks import MatmulTask, SealedMatmulTask
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(120.0)
    port = lst.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = tmp_path / "importtime.log"
    with open(log, "w") as sink:    # a file: the log outgrows a pipe
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "repro_torch.launch.worker", "--connect", f"127.0.0.1:{port}",
             "--worker-id", "0", "--device", "cpu"],
            env=env, stdout=subprocess.DEVNULL, stderr=sink)
    try:
        conn, _ = lst.accept()
        conn.settimeout(120.0)
        assert wire.read_frame(conn).type == wire.HELLO
        mea = MEAECC(codec="bits", mode="stream", device="cpu")
        kp, master = generate_keypair(), generate_keypair()
        b = torch.ones((3, 2))
        ct = mea.encrypt(torch.ones((4, 3)), kp.pk, sender=master, nonce=1)
        for sub, (task, shard) in enumerate(
                [(MatmulTask(b), torch.ones((4, 3))),
                 (SealedMatmulTask(mea, [kp], master.pk, b=b),
                  (0, (ct,), 2))], 1):
            conn.sendall(wire.pack_frame(wire.TASK, 0, sub, wire.dumps(
                {"sub": sub, "round": 0, "delay": 0.0,
                 "task": pickle.dumps(task), "shard": shard,
                 "inject": None})))
            fr = wire.read_frame(conn)
            while fr.type == wire.PING:
                fr = wire.read_frame(conn)
            assert (fr.type, fr.sub) == (wire.RESULT, sub), \
                bytes(fr.payload)
            reply = wire.loads(fr.payload)
            got = reply["result"]
            if sub == 2:
                got = mea.decrypt(got, master)
            assert torch.equal(got, torch.full((4, 2), 3.0))
            assert reply["launches"] == {}      # the CPU runs no kernel
        conn.sendall(wire.pack_frame(wire.SHUTDOWN, 0, 0))
        proc.wait(timeout=60.0)
    finally:
        lst.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = log.read_text()
    assert proc.returncode == 0, err[-2000:]
    mods = {ln.split("|")[-1].strip() for ln in err.splitlines()
            if ln.startswith("import time:") and "|" in ln}
    assert "repro_torch.runtime.wire" in mods
    assert "repro_torch.kernels.ops" in mods        # the launch counts
    bad = sorted(m for m in mods if _forbidden(m))
    assert not bad, bad
