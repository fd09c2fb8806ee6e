"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

The reference's ``tests/test_checkpoint.py`` cases run on the port (the
cipher on the CPU, ``device="cpu"``), and checkpoints cross between the
packages both ways: a flat and a nested tree (an ``OptState`` of AdamW
inside), plain and encrypted with one ``secret``, restore bit-identical
in the other package; a wrong secret raises.  Both packages order leaves
as ``jax.tree.flatten`` does, which is what makes ``arr_<i>`` the same
leaf on both sides.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer


def _ck(path, **kw):
    if kw.get("encrypt"):
        kw.setdefault("device", "cpu")
    return Checkpointer(str(path), **kw)


def _tree():
    rng = np.random.default_rng(0)
    return {"layer": {"w": torch.from_numpy(
                          rng.standard_normal((8, 4)).astype(np.float32)),
                      "b": torch.from_numpy(
                          rng.standard_normal(4).astype(np.float32))},
            "step_arr": torch.tensor([3], dtype=torch.int32)}


def test_roundtrip(tmp_path):
    ck = _ck(tmp_path)
    tree = _tree()
    ck.save(7, tree)
    assert ck.latest_step() == 7
    out = ck.restore(7, tree)
    assert torch.equal(out["layer"]["w"], tree["layer"]["w"])
    assert torch.equal(out["step_arr"], tree["step_arr"])
    assert out["step_arr"].dtype == torch.int32


def test_atomic_no_partial(tmp_path):
    ck = _ck(tmp_path)
    os.makedirs(tmp_path / ".tmp_crashed")      # a crashed writer's leftovers
    assert ck.latest_step() is None


def test_corruption_detected(tmp_path):
    ck = _ck(tmp_path)
    tree = _tree()
    path = ck.save(3, tree)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["arr_0"] = data["arr_0"] + 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError):
        ck.restore(3, tree)


def test_prune_keeps_latest(tmp_path):
    ck = _ck(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.all_steps() == [3, 4]


def test_encrypted_roundtrip(tmp_path):
    ck = _ck(tmp_path, encrypt=True)
    tree = {"w": torch.linspace(-2, 2, 12).reshape(3, 4)}
    ck.save(1, tree)
    out = ck.restore(1, tree)
    assert torch.equal(out["w"], tree["w"])


def test_encrypted_roundtrip_mixed_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    ck = _ck(tmp_path, encrypt=True)
    tree = {"f32": torch.from_numpy(
                rng.standard_normal((5, 3)).astype(np.float32)),
            "i32": torch.tensor([[7, -9], [2**30, -2**30]],
                                dtype=torch.int32),
            "f64": rng.standard_normal(7),
            "odd": np.arange(11, dtype=np.int8),
            "bf16": torch.randn(6, generator=torch.Generator().manual_seed(1))
            .to(torch.bfloat16)}
    ck.save(1, tree)
    out = ck.restore(1, tree)
    for k in tree:
        if torch.is_tensor(tree[k]):
            assert out[k].dtype == tree[k].dtype
            assert torch.equal(out[k], tree[k])
        else:
            np.testing.assert_array_equal(out[k], tree[k])


def test_encrypted_corruption_detected(tmp_path):
    ck = _ck(tmp_path, encrypt=True)
    tree = {"w": torch.linspace(-1, 1, 8)}
    path = ck.save(3, tree)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["arr_0"] = data["arr_0"] ^ np.uint32(1)
    np.savez(npz, **data)
    with pytest.raises(IOError):
        ck.restore(3, tree)


def test_encrypted_restore_across_instances_with_secret(tmp_path):
    tree = {"w": torch.linspace(-2, 2, 12).reshape(3, 4)}
    _ck(tmp_path, encrypt=True, secret=b"job-42").save(1, tree)
    out = _ck(tmp_path, encrypt=True, secret=b"job-42").restore(1, tree)
    assert torch.equal(out["w"], tree["w"])
    with pytest.raises(IOError):
        _ck(tmp_path, encrypt=True, secret=b"wrong").restore(1, tree)


def test_save_does_not_mutate_extra(tmp_path):
    extra = {"epoch": 3}
    _ck(tmp_path, encrypt=True).save(1, {"w": torch.ones(4)}, extra=extra)
    assert extra == {"epoch": 3}


def test_restore_resumes_training_state(tmp_path):
    from repro_torch.optim import adamw, apply_updates
    opt = adamw(0.1)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    for _ in range(3):
        upd, state = opt.update({"w": 2 * params["w"]}, state, params)
        params = apply_updates(params, upd)
    ck = _ck(tmp_path)
    ck.save(3, {"params": params, "opt": state})
    restored = ck.restore(3, {"params": params, "opt": state})
    assert torch.equal(restored["params"]["w"], params["w"])
    assert torch.equal(restored["opt"].nu["w"], state.nu["w"])
    assert int(restored["opt"].step) == 3


def test_an_encrypted_checkpoint_needs_the_cipher(tmp_path):
    _ck(tmp_path, encrypt=True).save(1, {"w": torch.ones(4)})
    with pytest.raises(IOError, match="encrypted"):
        _ck(tmp_path).restore(1, {"w": torch.ones(4)})


# ---- across the two packages -----------------------------------------

def _cross_trees():
    """(port tree, reference tree) of one content: a flat dict, and a
    nested training state with an OptState (its NamedTuple fields in
    order, dict keys sorted)."""
    import jax.numpy as jnp
    from repro.optim import adamw as ref_adamw
    from repro_torch.optim import adamw
    rng = np.random.default_rng(7)
    flat = {"layers.1.w": rng.standard_normal((6, 3)).astype(np.float32),
            "embedding.table": rng.standard_normal((5, 6)).astype(np.float32),
            "count": np.array([4, -4], np.int32)}
    params = {"b": rng.standard_normal(3).astype(np.float32),
              "a": {"w": rng.standard_normal((2, 3)).astype(np.float32)}}
    nested_t = {"params": {"b": torch.from_numpy(params["b"]),
                           "a": {"w": torch.from_numpy(params["a"]["w"])}}}
    nested_t["opt"] = adamw(0.1).init(nested_t["params"])
    nested_j = {"params": {"b": jnp.asarray(params["b"]),
                           "a": {"w": jnp.asarray(params["a"]["w"])}}}
    nested_j["opt"] = ref_adamw(0.1).init(nested_j["params"])
    # give the state content: nu = params squared, step 5
    nested_t["opt"] = nested_t["opt"]._replace(
        step=torch.tensor(5, dtype=torch.int32),
        nu={"b": torch.from_numpy(params["b"] ** 2),
            "a": {"w": torch.from_numpy(params["a"]["w"] ** 2)}})
    nested_j["opt"] = nested_j["opt"]._replace(
        step=jnp.asarray(5, jnp.int32),
        nu={"b": jnp.asarray(params["b"] ** 2),
            "a": {"w": jnp.asarray(params["a"]["w"] ** 2)}})
    flat_t = {k: torch.from_numpy(v) for k, v in flat.items()}
    flat_j = {k: jnp.asarray(v) for k, v in flat.items()}
    return {"flat": (flat_t, flat_j), "nested": (nested_t, nested_j)}


def _leaves_np(tree):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: torch.is_tensor(x))]


@pytest.mark.parametrize("encrypt", [False, True], ids=["plain", "encrypted"])
@pytest.mark.parametrize("kind", ["flat", "nested"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_the_packages(tmp_path, writer, kind,
                                                 encrypt):
    from repro.checkpoint import Checkpointer as RefCheckpointer
    tree_t, tree_j = _cross_trees()[kind]
    kw = {"encrypt": True, "secret": b"shared"} if encrypt else {}
    port = _ck(tmp_path, **kw)
    ref = RefCheckpointer(str(tmp_path), **kw)
    if writer == "port":
        port.save(2, tree_t)
        out = ref.restore(2, tree_j)
    else:
        ref.save(2, tree_j)
        out = port.restore(2, tree_t)
        if kind == "nested":
            assert isinstance(out["opt"], type(tree_t["opt"]))
            assert out["opt"].step.dtype == torch.int32
    got, want = _leaves_np(out), _leaves_np(tree_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    if encrypt:
        wrong_kw = dict(kw, secret=b"not-it")
        with pytest.raises(IOError):
            if writer == "port":
                RefCheckpointer(str(tmp_path), **wrong_kw).restore(2, tree_j)
            else:
                _ck(tmp_path, **wrong_kw).restore(2, tree_t)
