"""The port's optimizers, gradient compression and policy masks
(``repro_torch.optim``, ``repro_torch.dist.compression``,
``repro_torch.runtime.scheduler.policy_mask_fn``) against the JAX
package's, on the CPU.

Tolerances:

* optimizer state and parameters, 1e-6 of each leaf's max |value| over 5
  steps: both sides run the same float32 arithmetic per element; the
  global norm sums the leaves' sums of squares in another order (XLA's
  reduction tree), which moves the clip scale by an ulp or so;
* ``warmup_cosine``, 1e-6 relative: float32 on both sides;
* the in-place update the trainer runs, exactly: it runs the functional
  update's per-leaf function;
* int8 compression, exactly: ``torch.round`` and ``jnp.round`` both round
  half to even, on the same float32 quotients;
* policy masks, exactly: the same arrival timeline and the same policy
  decisions, ErrorTarget's decode-weight proxy in float64.
"""

import numpy as np
import pytest
import torch

from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               sgdm, warmup_cosine)

RTOL = 1e-6


def _tree(rng):
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "block": {"u": rng.standard_normal(3).astype(np.float32),
                      "a": rng.standard_normal((2, 5)).astype(np.float32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close(got, want, rtol=RTOL):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float64) -
                           np.asarray(want[k], np.float64)).max())
        assert err <= rtol * scale, (k, err, scale)


def _pair(name, **kw):
    import repro.optim as ref_optim
    if name == "adamw":
        return adamw(warmup_cosine(3e-2, 2, 10), **kw), \
            ref_optim.adamw(ref_optim.warmup_cosine(3e-2, 2, 10), **kw)
    return sgdm(5e-2, **kw), ref_optim.sgdm(5e-2, **kw)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),                                  # clip at 1.0
    ("adamw", {"max_grad_norm": 0.0, "weight_decay": 0.01}),
    ("adamw", {"max_grad_norm": 0.5, "b2": 0.999}),
    ("sgdm", {}),
    ("sgdm", {"max_grad_norm": 0.3, "momentum": 0.8}),
], ids=["adamw-clip", "adamw-noclip", "adamw-clip0.5", "sgdm", "sgdm-clip"])
def test_optimizer_matches_reference_over_5_steps(name, kw):
    """Fed the same gradients (the reference's own, as numpy, scaled so
    that clipping bites), the port's state and parameters follow the
    reference's for 5 steps."""
    import jax.numpy as jnp
    from repro.optim.optimizers import apply_updates as ref_apply
    rng = np.random.default_rng(3)
    start = _tree(rng)
    opt, ref = _pair(name, **kw)
    p_t = _map(torch.from_numpy, start)
    p_j = _map(jnp.asarray, start)
    s_t, s_j = opt.init(p_t), ref.init(p_j)
    for step in range(5):
        g = _map(lambda x: (3.0 * rng.standard_normal(x.shape)).astype(
            np.float32), start)
        u_t, s_t = opt.update(_map(torch.from_numpy, g), s_t, p_t)
        p_t = apply_updates(p_t, u_t)
        u_j, s_j = ref.update(_map(jnp.asarray, g), s_j, p_j)
        p_j = ref_apply(p_j, u_j)
        assert int(s_t.step) == int(s_j.step) == step + 1
        _close(p_t, p_j)
        _close(s_t.mu, s_j.mu)
        if s_j.nu is None:
            assert s_t.nu is None
        else:
            _close(s_t.nu, s_j.nu)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"max_grad_norm": 0.0}), ("sgdm", {}),
    ("sgdm", {"max_grad_norm": 0.3})],
    ids=["adamw-clip", "adamw-noclip", "sgdm", "sgdm-clip"])
def test_in_place_update_equals_the_functional_one_bit_for_bit(name, kw):
    rng = np.random.default_rng(4)
    start = _tree(rng)
    opt = _pair(name, **kw)[0]
    p_f = _map(torch.from_numpy, start)
    p_i = _map(lambda x: torch.from_numpy(x.copy()), start)
    s_f, s_i = opt.init(p_f), opt.init(p_i)
    for _ in range(4):
        g = _map(lambda x: torch.from_numpy((2.0 * rng.standard_normal(
            x.shape)).astype(np.float32)), start)
        u, s_f = opt.update(g, s_f, p_f)
        p_f = apply_updates(p_f, u)
        before = p_i
        s_i = opt.update_in_place(g, s_i, p_i)
        assert p_i is before                     # the same tensors, updated
    for a, b in zip(_flat(p_f).values(), _flat(p_i).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_flat(s_f.mu).values(), _flat(s_i.mu).values()):
        np.testing.assert_array_equal(a, b)
    if s_f.nu is not None:
        for a, b in zip(_flat(s_f.nu).values(), _flat(s_i.nu).values()):
            np.testing.assert_array_equal(a, b)
    assert int(s_f.step) == int(s_i.step) == 4


@pytest.mark.parametrize("args", [(3e-3, 20, 100), (1.0, 10, 100),
                                  (0.5, 0, 7, 0.2)])
def test_warmup_cosine_matches_reference(args):
    import jax.numpy as jnp
    from repro.optim import warmup_cosine as ref_schedule
    mine, ref = warmup_cosine(*args), ref_schedule(*args)
    for step in range(0, 121):
        got = float(mine(torch.tensor(step, dtype=torch.int32)))
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= RTOL * abs(want), (step, got, want)


def test_global_norm_clip_matches_reference():
    import jax.numpy as jnp
    from repro.optim import clip_by_global_norm as ref_clip
    tree = _tree(np.random.default_rng(5))
    got, norm = clip_by_global_norm(_map(torch.from_numpy, tree), 1.0)
    want, ref_norm = ref_clip(_map(jnp.asarray, tree), 1.0)
    assert abs(float(norm) - float(ref_norm)) <= RTOL * float(ref_norm)
    _close(got, want)


# ---- the reference's tests/test_optim.py, on the port ---------------------

def _train_quadratic(opt, steps=120):
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    state = opt.init(params)
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                     list(leaves.values()))))
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
    return float(loss(params))


def test_adamw_converges():
    assert _train_quadratic(adamw(0.1, weight_decay=0.0)) < 5e-2


def test_sgdm_converges():
    assert _train_quadratic(sgdm(0.05)) < 5e-2


def test_clipping():
    clipped, norm = clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)


def test_warmup_cosine_shape():
    sched = warmup_cosine(1.0, 10, 100)
    v5, v10, v100 = (float(sched(torch.tensor(s))) for s in (5, 10, 100))
    assert 0 < v5 < v10 <= 1.0
    assert v100 < v10 and abs(v100 - 0.1) < 1e-2


def test_weight_decay_pulls_to_zero():
    opt = adamw(0.05, weight_decay=1.0, max_grad_norm=0.0)
    params = {"w": torch.tensor(5.0)}
    state = opt.init(params)
    for _ in range(50):
        upd, state = opt.update({"w": torch.tensor(0.0)}, state, params)
        params = apply_updates(params, upd)
    assert abs(float(params["w"])) < 1.0


# ---- int8 gradient compression ----------------------------------------

def _compress_cases():
    rng = np.random.default_rng(6)
    half = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0, 3.5],
                    np.float32)          # max 127: scale 1, exact halves
    return {"random": rng.standard_normal((33, 7)).astype(np.float32),
            "zeros": np.zeros((5, 4), np.float32),
            "halfway": half,
            "scalar": np.float32(-2.75)}


@pytest.mark.parametrize("case", ["random", "zeros", "halfway", "scalar"])
def test_int8_compress_is_bit_identical_to_reference(case):
    import jax.numpy as jnp
    from repro.dist.compression import (int8_compress as ref_compress,
                                        int8_decompress as ref_decompress)
    from repro_torch.dist import int8_compress, int8_decompress
    x = _compress_cases()[case]
    q, s = int8_compress(torch.as_tensor(x))
    rq, rs = ref_compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(int8_decompress(q, s).numpy(),
                                  np.asarray(ref_decompress(rq, rs)))
    if case == "halfway":    # round half to even, as jnp.round
        np.testing.assert_array_equal(q.numpy(), [0, 2, 2, 0, -2, -2, 127, 4])
    if case == "zeros":
        assert float(s) == 1.0 and not q.any()


def test_int8_roundtrip_error_is_at_most_half_a_step():
    from repro_torch.dist import int8_compress, int8_decompress
    x = torch.from_numpy(_compress_cases()["random"])
    q, s = int8_compress(x)
    assert float((int8_decompress(q, s) - x).abs().max()) <= float(s) / 2


# ---- policy masks for the coded train step ----------------------------

POLICIES = ["fixed_quantile", "deadline", "first_k", "error_target"]


def _policy(pkg, name):
    wp = pkg.wait_policy
    return {"fixed_quantile": wp.FixedQuantile(),
            "deadline": wp.Deadline(0.021),
            "first_k": wp.FirstK(5),
            "error_target": wp.ErrorTarget(0.05, min_prefix=3)}[name]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_mask_fn_matches_reference(policy):
    """Six rounds of a StragglerModel over 8 shards (2 stragglers): the
    port's masks are the reference's, exactly."""
    import repro.runtime as ref_rt
    import repro_torch.runtime as rt
    from repro.core import BerrutGradientCode as RefCode
    from repro.runtime.scheduler import policy_mask_fn as ref_mask_fn
    from repro_torch.core import BerrutGradientCode
    from repro_torch.launch.steps import build_mask_fn
    from repro_torch.runtime.scheduler import policy_mask_fn
    straggle = dict(n_workers=8, n_stragglers=2, seed=3)
    mine = policy_mask_fn(BerrutGradientCode(8, 8)._code,
                          rt.StragglerModel(**straggle),
                          policy=_policy(rt, policy))
    ref = ref_mask_fn(RefCode(8, 8)._code, ref_rt.StragglerModel(**straggle),
                      policy=_policy(ref_rt, policy))
    steps = build_mask_fn({"name": "berrut_grad", "n_shards": 8},
                          rt.StragglerModel(**straggle),
                          wait_policy=_policy(rt, policy))
    for r in range(6):
        got, want = mine(r), np.asarray(ref(r))
        assert got.dtype == np.float32 and got.shape == (8,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(steps(r), want)
