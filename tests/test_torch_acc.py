"""Approximated coded computing of an arbitrary f in the port against the
JAX package: ``berrut.interpolate`` and ``SPACDCCode.run``.

``run`` is the paper's §V pipeline end to end: encode X into N coded
shards, apply a (non-polynomial) f on every shard, decode from whichever
workers answered.  Both packages take the same numpy inputs; T > 0 runs
hand the port the noise JAX draws (``ref.make_noise(..., key)``), since
torch's generator draws other numbers.  The port holds the reference
within 1e-5 of max |ref| (float32 contractions and products summed in
other orders).  The reference's own claims (``tests/test_spacdc.py``) are
held by the port with its own noise.  The JAX package is imported inside
the tests, so the ``cuda`` cases run on a machine without JAX
(``pytest tests/test_torch_acc.py -k cuda``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import berrut, registry
from repro_torch.core.registry import CodingScheme
from repro_torch.core.spacdc import SPACDCCode, SPACDCConfig
from repro_torch.kernels import ops

TOL = 1e-5                          # of max |ref|


def _rel(got, want) -> float:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-30))


@pytest.fixture(scope="module")
def data():
    """``tests/test_spacdc.py``'s data: (40, 16) standard normal, seed 0."""
    return np.random.default_rng(0).standard_normal((40, 16)).astype(
        np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def combines(monkeypatch):
    """Count the calls of ``kernels.ops.berrut_combine`` (the schemes and
    ``interpolate`` look it up at call time)."""
    calls = []
    inner = ops.berrut_combine

    def counted(weights, blocks, **kw):
        calls.append((tuple(torch.as_tensor(weights).shape),
                      tuple(blocks.shape)))
        return inner(weights, blocks, **kw)
    monkeypatch.setattr(ops, "berrut_combine", counted)
    return calls


# the workers' functions, one per package: X Xᵀ and gelu(X Xᵀ) (JAX's gelu
# is the tanh form by default)
def _port_f(name):
    if name == "xxT":
        return lambda z: z @ z.T
    return lambda z: F.gelu(z @ z.T, approximate="tanh")


def _ref_f(name):
    import jax
    if name == "xxT":
        return lambda z: z @ z.T
    return lambda z: jax.nn.gelu(z @ z.T)


# --------------------------------------------------------------------------
# interpolate
# --------------------------------------------------------------------------

INTERP_CASES = {
    "scalar_x": dict(x=0.3, n=9, value_shape=(5, 4), signs=False),
    "vector_x": dict(x=np.linspace(-0.9, 0.95, 7), n=9, value_shape=(6,),
                     signs=False),
    "vector_x_at_nodes": dict(x="nodes", n=6, value_shape=(3, 2),
                              signs=False),
    "signs_of_a_parent": dict(x=np.linspace(-0.8, 0.8, 5), n=7,
                              value_shape=(4, 3), signs=True),
    "scalar_x_signs": dict(x=-0.45, n=7, value_shape=(8,), signs=True),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_matches_reference(case):
    import jax.numpy as jnp
    from repro.core import berrut as rb
    c = INTERP_CASES[case]
    rng = np.random.default_rng(len(case))
    nodes = berrut.chebyshev_points(c["n"], kind=1)
    values = rng.standard_normal((c["n"],) + c["value_shape"]).astype(
        np.float32)
    x = nodes[1:4] if isinstance(c["x"], str) else c["x"]
    signs = None
    if c["signs"]:
        # the straggler case: a subset of a parent node set keeps the
        # parent's alternating signs
        signs = np.where(np.arange(c["n"] + 2) % 2 == 0, 1.0, -1.0)[
            np.r_[0:2, 4:c["n"] + 2]].astype(np.float32)
    got = berrut.interpolate(x, nodes, torch.from_numpy(values), signs)
    want = np.asarray(rb.interpolate(
        jnp.asarray(x), nodes, jnp.asarray(values),
        None if signs is None else jnp.asarray(signs)))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL


def test_interpolate_hits_nodes_exactly():
    nodes = berrut.chebyshev_points(5, kind=1)
    values = torch.arange(10.0).reshape(5, 2)
    for i in range(5):
        torch.testing.assert_close(berrut.interpolate(nodes[i], nodes,
                                                      values), values[i],
                                   rtol=0, atol=0)


def test_interpolate_is_one_berrut_combine(combines):
    nodes = berrut.chebyshev_points(6, kind=1)
    values = torch.randn(6, 3, 4)
    out = berrut.interpolate(np.linspace(-0.5, 0.5, 4), nodes, values)
    assert tuple(out.shape) == (4, 3, 4)
    assert combines == [((4, 6), (6, 3, 4))]
    berrut.interpolate(0.1, nodes, values)
    assert combines[-1] == ((1, 6), (6, 3, 4)) and len(combines) == 2


# --------------------------------------------------------------------------
# SPACDCCode.run
# --------------------------------------------------------------------------

RUN_CASES = [
    # (N, K, T, responders)
    (12, 3, 0, None),
    (12, 3, 0, (0, 2, 3, 5, 7, 8, 11)),
    (12, 3, 2, None),
    (12, 3, 2, (11, 0, 4, 6, 9, 1)),       # any order, as the reference
    (8, 2, 1, (0, 1, 2, 3, 4, 6, 7)),      # §V-A: worker 5 dropped
]


@pytest.mark.parametrize("fname", ["xxT", "gelu_xxT"])
@pytest.mark.parametrize("n,k,t,resp", RUN_CASES)
def test_run_matches_reference(data, fname, n, k, t, resp):
    import jax
    from repro.core import SPACDCCode as RefCode, SPACDCConfig as RefConfig
    port = SPACDCCode(SPACDCConfig(n, k, t, noise_scale=0.5))
    ref = RefCode(RefConfig(n, k, t, noise_scale=0.5))
    key = jax.random.PRNGKey(7)
    blk = -(-data.shape[0] // k)
    noise = np.asarray(ref.make_noise((blk, data.shape[1]), key=key))
    got = port.run(torch.from_numpy(data), _port_f(fname), responders=resp,
                   noise=noise)
    want = np.asarray(ref.run(data, _ref_f(fname), responders=resp,
                              key=key))
    assert tuple(got.shape) == (k, blk, blk)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert _rel(got, want) <= TOL


def test_run_is_encode_vmap_decode(data, combines):
    """Two ``berrut_combine`` calls a run: the encode of the K + T blocks
    at the N alphas, the decode of the responders at the K betas."""
    code = SPACDCCode(SPACDCConfig(10, 2, 1))
    resp = [0, 1, 2, 4, 5, 6, 8, 9]
    x = torch.from_numpy(data)
    out = code.run(x, _port_f("gelu_xxT"), responders=resp)
    assert combines == [((10, 3), (3, 20, 16)), ((2, 8), (8, 20, 20))]
    # the same steps by hand
    shards = code.encode(x)
    results = torch.stack([_port_f("gelu_xxT")(s) for s in shards])
    by_hand = code.decode(results[resp], resp)
    torch.testing.assert_close(out, by_hand, rtol=1e-6, atol=1e-6)


def test_run_pads_ragged_rows():
    code = SPACDCCode(SPACDCConfig(8, 3))
    x = torch.randn(10, 4, generator=torch.Generator().manual_seed(3))
    out = code.run(x, lambda z: z.sum(dim=0))
    assert tuple(out.shape) == (3, 4)      # 10 rows -> 3 blocks of 4


def _exact(code, x, f):
    return torch.stack([f(blk) for blk in code.split_blocks(x)])


def test_paper_illustrating_example(data):
    """§V-A, the reference's ``test_paper_illustrating_example``: N=8, K=2,
    S=T=1, f(X) = X Xᵀ, worker 5 dropped: < 0.25 of max |exact|."""
    code = SPACDCCode(SPACDCConfig(n_workers=8, k_blocks=2, t_colluding=1,
                                   noise_scale=1.0))
    f = _port_f("xxT")
    x = torch.from_numpy(data)
    exact = _exact(code, x, f)
    approx = code.run(x, f, responders=[0, 1, 2, 3, 4, 6, 7])
    scale = float(exact.abs().max())
    assert float((approx - exact).abs().max()) / scale < 0.25


def test_nonlinear_function_support(data):
    """The reference's ``test_nonlinear_function_support``: N=30, K=3,
    f = gelu(X Xᵀ), every worker: < 0.15 of max |exact|."""
    code = SPACDCCode(SPACDCConfig(n_workers=30, k_blocks=3))
    f = _port_f("gelu_xxT")
    x = torch.from_numpy(data)
    exact = _exact(code, x, f)
    approx = code.run(x, f)
    scale = float(exact.abs().max()) + 1e-9
    assert float((approx - exact).abs().max()) / scale < 0.15


# --------------------------------------------------------------------------
# the CodingScheme protocol, beside the reference's
# --------------------------------------------------------------------------

def _build(module, name):
    kw = (dict(n_shards=4) if name == "berrut_grad"
          else dict(n_workers=8, k_blocks=4))
    return module.build(name, **kw)


@pytest.mark.parametrize("name", registry.names())
def test_coding_scheme_protocol_as_in_reference(name):
    """A registered scheme is a ``CodingScheme`` in the port exactly when
    it is one in the reference (the gradient code ``berrut_grad`` is a
    registered factory, not a round scheme, in both)."""
    import repro.core  # noqa: F401  (registers the reference's schemes)
    from repro.core import registry as ref_registry
    assert isinstance(_build(registry, name), CodingScheme) == isinstance(
        _build(ref_registry, name), ref_registry.CodingScheme)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def test_cuda_run_launches_berrut_combine_twice(data, cuda):
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    code = SPACDCCode(SPACDCConfig(8, 2, 1))
    plain = SPACDCCode(SPACDCConfig(8, 2, 1, use_kernel=False))
    x = torch.from_numpy(data).to(cuda)
    noise = code.make_noise((20, 16), device=cuda)
    resp = [0, 1, 2, 3, 4, 6, 7]
    f = _port_f("gelu_xxT")
    before = berrut_encode_kernel.launches
    got = code.run(x, f, responders=resp, noise=noise)
    assert berrut_encode_kernel.launches - before == 2
    want = plain.run(x, f, responders=resp, noise=noise)
    assert berrut_encode_kernel.launches - before == 2
    assert got.device.type == "cuda"
    assert _rel(got, want.cpu().numpy()) <= 1e-4


def test_cuda_interpolate_launches_berrut_combine(cuda):
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    nodes = berrut.chebyshev_points(9, kind=1)
    values = torch.randn(9, 64, 33, device=cuda)
    before = berrut_encode_kernel.launches
    got = berrut.interpolate(np.linspace(-0.9, 0.9, 5), nodes, values)
    assert berrut_encode_kernel.launches - before == 1
    want = berrut.interpolate(np.linspace(-0.9, 0.9, 5), nodes,
                              values.cpu())
    assert got.device.type == "cuda"
    assert _rel(got, want.numpy()) <= 1e-4
