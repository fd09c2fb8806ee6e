"""The plain references against the port's CPU path at tiny sizes (a test
may import the port; the references may not).  CPU only."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import lm_weights
from perfbench.drivers.lm_train import model_config
from perfbench.reference import dense_lm, spacdc_round

ROOT = Path(__file__).resolve().parents[2]
FIG3 = json.loads((ROOT / "perfbench/configs/spacdc-fig3.json").read_text())
PHI3 = json.loads((ROOT / "perfbench/configs/phi3-mini-3.8b.json")
                  .read_text())
TINY_LM = dict(PHI3, hidden_size=64, intermediate_size=96,
               num_attention_heads=4, num_key_value_heads=4,
               num_hidden_layers=2, vocab_size=128, compute_dtype="float32")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**62 + 3])
def test_responders_are_the_ports_straggler_draw(seed):
    from repro_torch.runtime.straggler import StragglerModel
    model = StragglerModel(30, 7, delay_s=0.02, jitter_scale=0.002,
                           seed=seed)
    for r in range(40):
        want = np.flatnonzero(model.responder_mask(r, 23))
        np.testing.assert_array_equal(
            spacdc_round.responders(FIG3, seed, r), want)


def test_nodes_and_encoder_are_the_ports():
    from repro_torch.core import berrut
    from repro_torch.core.spacdc import SPACDCCode, SPACDCConfig
    alphas, betas = spacdc_round.node_layout(30, 24, 3)
    pa, pb = berrut.default_alpha_beta(30, 24, 3)
    np.testing.assert_array_equal(alphas, pa)
    np.testing.assert_array_equal(betas, pb)
    code = SPACDCCode(SPACDCConfig(30, 24, 3))
    np.testing.assert_allclose(spacdc_round.encode_matrix(alphas, betas),
                               code.enc_matrix.numpy(), rtol=2e-5,
                               atol=1e-6)
    mask = np.ones(30)
    mask[[3, 8, 11, 17, 21, 26, 29]] = 0
    resp = np.flatnonzero(mask)
    want = code.decode_matrix_masked(torch.from_numpy(mask)).numpy()
    got = spacdc_round.berrut_matrix(betas[:24], alphas[resp])
    np.testing.assert_allclose(got, want[:, resp], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("straggler", [0, 1, 2, 3])
def test_block_weights_are_the_gradient_codes(straggler):
    from repro_torch.core import BerrutGradientCode
    mask = np.ones(4, np.float32)
    mask[straggler] = 0
    code = BerrutGradientCode(4, 4)
    want = (code.decoder_weights(torch.from_numpy(mask)) *
            torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(dense_lm.block_weights(4, mask), want,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 5, 20, 21, 400, 1000, 1200])
def test_learning_rate_is_the_ports_schedule(step):
    from repro_torch.optim import warmup_cosine
    o = PHI3["optimizer"]
    sched = warmup_cosine(o["peak_lr"], o["warmup_steps"], o["total_steps"],
                          o["final_frac"])
    assert dense_lm.learning_rate(o, step) == pytest.approx(
        float(sched(step)), rel=1e-6)


def _port_model(cfg, seed):
    from repro_torch.models import build_model
    model = build_model(model_config(cfg), device="meta")
    model.to_empty(device="cpu")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for c, chunk in enumerate(lm_weights.chunk_specs(cfg)):
            for name, w in lm_weights.make_chunk(torch, chunk, seed, c,
                                                 "cpu").items():
                params[name].copy_(w)
    return model


def test_lm_loss_and_gradients_are_the_ports():
    seed = 5
    model = _port_model(TINY_LM, seed)
    ids = torch.randint(0, TINY_LM["vocab_size"], (1, 17),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = ids[:, :-1], ids[:, 1:]
    loss, _ = model.loss_fn({"tokens": tokens, "targets": targets})
    loss.backward()
    ref = dense_lm.Trainer(TINY_LM, seed, "cpu")
    got = ref.model.loss_backward(tokens, targets, torch.tensor(1.0))
    assert got == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, p in model.named_parameters():
        g = ref.params[name].grad
        scale = float(p.grad.abs().max())
        assert float((g - p.grad).abs().max()) <= 1e-4 * scale, name


def test_weights_chunks_cover_the_model_and_repeat():
    names = lm_weights.leaf_names(TINY_LM)
    assert len(names) == len(set(names))
    a = lm_weights.make_chunk(torch, lm_weights.chunk_specs(TINY_LM)[1], 9,
                              1, "cpu")
    b = lm_weights.make_chunk(torch, lm_weights.chunk_specs(TINY_LM)[1], 9,
                              1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    c = lm_weights.make_chunk(torch, lm_weights.chunk_specs(TINY_LM)[1], 10,
                              1, "cpu")
    assert not torch.equal(a["layers.0.mixer.wq"], c["layers.0.mixer.wq"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10,
                      3.0e-5], dtype=torch.float32)
    got = spacdc_round.round_tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0                        # a tie, to even
    assert got[2] == 1.0 + 2 * 2**-10           # a tie, to even (up)
    assert got[3] == -1.0 - 2**-10              # representable
    rel = float(((got[4] - x[4]) / x[4]).abs())
    assert rel <= 2**-11
