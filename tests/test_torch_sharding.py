"""``repro_torch.dist.sharding``'s spec surgery and the models' specs
against the reference's (``repro.dist.sharding``, the models'
``param_specs``/``cache_specs``, ``zoo.input_specs``), on the CPU.

* ``prune_spec``, ``resolve_spec`` and ``add_data_axis`` on the inputs of
  ``tests/test_sharding.py``'s six spec tests and on 300 random (spec,
  shape, mesh) draws each: the same entries as the reference's.
* ``tree_shardings``: every resolved spec and its DTensor placements
  (``Shard(d)`` on each mesh dim entry d names, ``Replicate()`` elsewhere).
* Every tiny architecture's ``param_specs`` and ``cache_specs`` (with
  ``pad_heads_to=4``, so that the kv heads' axis is decided both ways, and
  with the int8 cache): the reference's, leaf for leaf under the port's
  parameter names, its stacked ``groups`` (and whisper's stacked encoder
  and decoder) axis dropped.
* ``input_specs``: the reference's shapes and dtypes for every (arch,
  shape), and ``input_shardings``' specs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, tiny_config
from repro_torch.dist.sharding import (P, add_data_axis, placements_of,
                                       prune_spec, resolve_spec,
                                       tree_add_data_axis, tree_shardings)


class FakeMesh:
    """The reference test's mesh double: axis names and a device shape."""

    def __init__(self, names=("data", "model"), shape=(4, 2)):
        self.axis_names = names

        class _Dev:
            pass
        self.devices = _Dev()
        self.devices.shape = shape


class FakeDeviceMesh:
    """A ``DeviceMesh`` double: what ``resolve_spec`` and
    ``placements_of`` read of one."""

    def __init__(self, names=("data", "model"), shape=(4, 2)):
        self.mesh_dim_names = names
        self.mesh = torch.empty(shape)


def _ref(spec):
    from jax.sharding import PartitionSpec
    return PartitionSpec(*spec)


# ---- the reference's six spec tests -------------------------------------
SIX = [
    ("prune", (P("data", "model"), (1, 64)), (None, "model")),
    ("prune", (P("data", "model"), (8, 64)), ("data", "model")),
    ("prune", (P(("data", "model"), None), (8, 3)), (("data", "model"), None)),
    ("prune", (P(("data", "model"), None), (4, 3)), (None, None)),
    ("add", (P(None, "model", None), (64, 32, 48), 16, ()),
     ("data", "model", None)),
    ("add", (P(None, "model", None), (64, 32, 48), 16, (0,)),
     (None, "model", "data")),
    ("add", (P("data", None), (64, 32), 16, ()), ("data", None)),
]


@pytest.mark.parametrize("case", SIX, ids=[f"{c[0]}{i}"
                                           for i, c in enumerate(SIX)])
def test_reference_spec_cases(case):
    from repro.dist import sharding as ref
    kind, args, want = case
    if kind == "prune":
        spec, shape = args
        got = prune_spec(spec, shape, FakeMesh())
        ref_got = ref.prune_spec(_ref(spec), shape, FakeMesh())
    else:
        spec, shape, dp, skip = args
        got = add_data_axis(spec, shape, dp_size=dp, skip_dims=skip)
        ref_got = ref.add_data_axis(_ref(spec), shape, dp_size=dp,
                                    skip_dims=skip)
    assert isinstance(got, P)
    assert tuple(got) == want == tuple(ref_got)


AXES = ("pod", "data", "model", "expert")


def _random_case(rng):
    n_axes = int(rng.integers(1, 4))
    names = tuple(rng.choice(AXES[:3] if n_axes < 4 else AXES, n_axes,
                             replace=False))
    sizes = tuple(int(s) for s in rng.choice([1, 2, 3, 4, 8], n_axes))
    ndim = int(rng.integers(1, 5))
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 64]))
                  for _ in range(ndim))
    entries = []
    for _ in range(int(rng.integers(0, ndim + 1))):
        r = rng.random()
        if r < 0.35:
            entries.append(None)
        elif r < 0.75:
            entries.append(str(rng.choice(AXES)))
        else:
            k = int(rng.integers(1, 3))
            entries.append(tuple(str(a) for a in
                                 rng.choice(AXES, k, replace=False)))
    return names, sizes, shape, entries


@pytest.mark.parametrize("fn", ["prune_spec", "resolve_spec",
                                "add_data_axis"])
def test_random_specs_match_reference(fn):
    from repro.dist import sharding as ref
    rng = np.random.default_rng({"prune_spec": 1, "resolve_spec": 2,
                                 "add_data_axis": 3}[fn])
    for _ in range(300):
        names, sizes, shape, entries = _random_case(rng)
        mesh = FakeMesh(names, sizes)
        spec = P(*entries)
        if fn == "add_data_axis":
            dp = [None, 2, 4, 3][int(rng.integers(0, 4))]
            skip = tuple(int(d) for d in rng.choice(len(shape), int(
                rng.integers(0, 2)), replace=False))
            got = add_data_axis(spec, shape, dp_size=dp, skip_dims=skip)
            want = ref.add_data_axis(_ref(spec), shape, dp_size=dp,
                                     skip_dims=skip)
        else:
            got = getattr(
                __import__("repro_torch.dist.sharding",
                           fromlist=[fn]), fn)(spec, shape, mesh)
            want = getattr(ref, fn)(_ref(spec), shape, mesh)
        assert tuple(got) == tuple(want), (fn, spec, shape, names, sizes)


def test_rank_check_and_tree_add_data_axis():
    from repro.dist import sharding as ref
    with pytest.raises(ValueError):
        resolve_spec(P("data", None, None), (4, 4), FakeMesh())
    specs = {"a": P(None, "model"), "b": [P("model"), P(None, None)]}
    shapes = {"a": torch.empty(8, 4, device="meta"),
              "b": [torch.empty(6, device="meta"),
                    torch.empty(16, 2, device="meta")]}
    got = tree_add_data_axis(specs, shapes, dp_size=4)
    import jax
    ref_specs = {"a": _ref(("model",)), "b": [_ref(("model",)),
                                              _ref((None, None))]}
    ref_specs["a"] = _ref((None, "model"))
    ref_shapes = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                             np.float32),
                              {"a": shapes["a"], "b": shapes["b"]})
    want = ref.tree_add_data_axis(ref_specs, ref_shapes, dp_size=4)
    assert tuple(got["a"]) == tuple(want["a"]) == ("data", "model")
    assert [tuple(s) for s in got["b"]] == [tuple(s) for s in want["b"]]


def test_tree_shardings_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeDeviceMesh(("data", "model"), (2, 4))
    specs = {"w": P(None, "model"), "odd": P("model", None),
             "both": P(("data", "model"), None), "cache": P("data", "model"),
             "gone": P("pod", None)}
    shapes = {"w": torch.empty(8, 12, device="meta"),
              "odd": torch.empty(6, 4, device="meta"),
              "both": torch.empty(16, 2, device="meta"),
              "cache": torch.empty(2, 8, device="meta"),
              "gone": torch.empty(4, 4, device="meta")}
    got = tree_shardings(specs, mesh, shapes)
    assert tuple(got["w"].spec) == (None, "model")
    assert got["w"].placements == (Replicate(), Shard(1))
    assert tuple(got["odd"].spec) == (None, None)      # 6 % 4: replicated
    assert got["odd"].placements == (Replicate(), Replicate())
    assert got["both"].placements == (Shard(0), Shard(0))
    assert got["cache"].placements == (Shard(0), Shard(1))
    assert tuple(got["gone"].spec) == (None, None)
    assert placements_of(P(None, None), mesh) == (Replicate(), Replicate())


# ---- the models' specs -----------------------------------------------------
def _spec_leaves(node, prefix=""):
    """A reference spec tree as {dotted path: tuple(spec)}."""
    from jax.sharding import PartitionSpec
    out = {}
    if isinstance(node, PartitionSpec):
        out[prefix] = tuple(node)
    elif isinstance(node, dict):
        for k, v in node.items():
            out.update(_spec_leaves(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(_spec_leaves(v, f"{prefix}.{i}" if prefix else str(i)))
    return out


def _ref_params_by_port_name(model, ref_specs) -> dict:
    """The reference's ``param_specs`` under the port's names: a stacked
    leaf's spec (its first entry the unsharded stacking axis) for each
    layer it stacks."""
    out = {}
    for key, node in ref_specs.items():
        leaves = _spec_leaves(node)
        if key == "groups":
            for path, spec in leaves.items():
                pos, _, rest = path.partition(".")
                i = int(pos.removeprefix("pos"))
                assert spec[0] is None
                for g in range(model.n_groups):
                    out[f"layers.{model.n_pre + g * model.period + i}."
                        f"{rest}"] = spec[1:]
        elif key == "prelude":
            for path, spec in leaves.items():
                out[f"layers.{path}"] = spec
        elif key in ("encoder", "decoder"):
            n = len(getattr(model, key))
            for path, spec in leaves.items():
                assert spec[0] is None
                for g in range(n):
                    out[f"{key}.{g}.{path}"] = spec[1:]
        else:
            for path, spec in leaves.items():
                out[f"{key}.{path}"] = spec
    return out


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _configs(arch):
    base = dataclasses.replace(tiny_config(arch), pad_heads_to=4)
    yield base
    yield dataclasses.replace(base, kv_cache_dtype="int8")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch):
    from repro.configs import tiny_config as ref_tiny
    from repro.models import build_model as ref_build
    from repro_torch.models import build_model
    for cfg in _configs(arch):
        ref_cfg = dataclasses.replace(ref_tiny(arch), pad_heads_to=4,
                                      kv_cache_dtype=cfg.kv_cache_dtype)
        model = build_model(cfg, device="cpu")
        got = model.param_specs()
        want = _ref_params_by_port_name(model, ref_build(ref_cfg)
                                        .param_specs())
        names = dict(model.named_parameters())
        assert set(got) == set(want) == set(names)
        for name, spec in got.items():
            assert isinstance(spec, P), name
            assert len(spec) <= names[name].dim(), name
            assert _pad(spec, names[name].dim()) == \
                _pad(want[name], names[name].dim()), name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch):
    from repro.configs import tiny_config as ref_tiny
    from repro.models import build_model as ref_build
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    for cfg in _configs(arch):
        ref_cfg = dataclasses.replace(ref_tiny(arch), pad_heads_to=4,
                                      kv_cache_dtype=cfg.kv_cache_dtype)
        model = build_model(cfg, device="cpu")
        ref_model = ref_build(ref_cfg)
        got = model.cache_specs()
        want = ref_model.cache_specs()
        cache = model.init_cache(2, 8)
        assert len(got) == len(cache)
        for i, (layer_specs, layer_cache) in enumerate(zip(got, cache)):
            if cfg.encoder_decoder:
                ref_layer = {k: {kk: vv[1:] for kk, vv in
                                 _spec_leaves(v).items()}
                             for k, v in want.items()}
                mine = {k: {kk: tuple(vv) for kk, vv in v.items()}
                        for k, v in layer_specs.items()}
                assert mine == ref_layer
            else:
                if i < model.n_pre:
                    ref_layer = _spec_leaves(want["prelude"][i])
                else:
                    pos = f"pos{(i - model.n_pre) % model.period}"
                    ref_layer = {k: v[1:] for k, v in
                                 _spec_leaves(want["groups"][pos]).items()}
                assert {k: tuple(v) for k, v in layer_specs.items()} == \
                    ref_layer
            # congruent with the cache it places
            n_spec = len(flatten(layer_specs, is_leaf=lambda s:
                                 isinstance(s, P))[0])
            assert n_spec == len(flatten(layer_cache)[0])


CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_reference(arch, shape):
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.models.zoo import input_specs as ref_input_specs
    from repro_torch.models.zoo import input_shardings, input_specs
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    mesh = FakeDeviceMesh(("data", "model"), (4, 2))
    for k, sh in input_shardings(ARCHS[arch], SHAPES[shape], mesh,
                                 "data").items():
        dim = 1 if k == "mrope_positions" else 0
        divides = got[k].shape[dim] % 4 == 0
        assert sh.spec[dim] == ("data" if divides else None), k
        assert all(e is None for j, e in enumerate(sh.spec) if j != dim)
