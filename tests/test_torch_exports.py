"""The port's public surface against the JAX package's.

One case per module of ``src/repro`` that declares ``__all__``: every name
it exports exists in the port's counterpart module (``repro/x/y.py`` ->
``repro_torch.x.y``).  The reference's ``__all__`` is read with ``ast``,
so nothing of JAX is imported.  Then the protocols: every registered
round scheme is a ``CodingScheme`` (the gradient code ``berrut_grad`` is
registered beside them and, as in the reference, is not), and every
registered transport is a ``Transport``.
"""

import ast
import importlib
from pathlib import Path

import pytest

from repro_torch.core import registry
from repro_torch.core.coded_training import BerrutGradientCode
from repro_torch.core.registry import CodingScheme
from repro_torch.runtime import TRANSPORTS, RoundHandle, Transport
from repro_torch.runtime.straggler import StragglerModel

REF = Path(__file__).resolve().parents[1] / "src" / "repro"


def _declared_all(path: Path):
    """The module's ``__all__`` as a list, or None when it has none."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def _port_module(path: Path) -> str:
    parts = list(path.relative_to(REF.parent).with_suffix("").parts)
    parts[0] = "repro_torch"
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


MODULES = sorted(str(p.relative_to(REF.parent)) for p in REF.rglob("*.py")
                 if _declared_all(p) is not None)


def test_reference_modules_found():
    assert len(MODULES) >= 40, MODULES


@pytest.mark.parametrize("module", MODULES)
def test_port_exports_every_reference_name(module):
    path = REF.parent / module
    names = _declared_all(path)
    port = importlib.import_module(_port_module(path))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    declared = set(getattr(port, "__all__", ()))
    assert not (set(names) - declared) or not declared, \
        f"{port.__name__}.__all__ lacks {sorted(set(names) - declared)}"


@pytest.mark.parametrize("name", registry.names())
def test_registered_schemes_are_coding_schemes(name):
    kw = (dict(n_shards=4) if name == "berrut_grad"
          else dict(n_workers=8, k_blocks=4))
    scheme = registry.build(name, **kw)
    if isinstance(scheme, BerrutGradientCode):
        assert not isinstance(scheme, CodingScheme)
    else:
        assert isinstance(scheme, CodingScheme)


@pytest.mark.parametrize("backend", sorted(TRANSPORTS))
def test_registered_transports_are_transports(backend):
    from repro_torch.runtime import build_transport
    kw = {"device": "cpu"} if backend == "socket" else {}
    transport = build_transport(backend, 4, StragglerModel(4, 1), **kw)
    try:
        assert isinstance(transport, Transport)
        assert transport.name == backend
    finally:
        transport.close()       # the socket mesh never started: nothing runs


def test_virtual_round_handle_is_a_round_handle():
    from repro_torch.runtime import VirtualClockTransport
    transport = VirtualClockTransport(StragglerModel(3, 0))
    handle = transport.submit_round([1, 2, 3], lambda x: 2 * x, 0,
                                    t_compute=1e-3)
    assert isinstance(handle, RoundHandle)
    assert sorted(e.worker for e in handle.events()) == [0, 1, 2]
    assert handle.result(2) == 6 and handle.finish() == 0.0
