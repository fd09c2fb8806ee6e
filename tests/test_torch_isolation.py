"""The port stands alone: no file of ``src/repro_torch`` (and not
``chip_smoke.py``) imports JAX or anything of the JAX package ``repro``, at
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
    [ROOT / "chip_smoke.py"]
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
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/models/coded.py",
                 "src/repro_torch/runtime/serve_loop.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/runtime/faults.py",
                 "src/repro_torch/runtime/adaptive.py",
                 "chip_smoke.py"):
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
            "repro_torch.runtime.serve_loop, repro_torch.launch.serve, "
            "repro_torch.runtime.faults, repro_torch.runtime.adaptive\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
