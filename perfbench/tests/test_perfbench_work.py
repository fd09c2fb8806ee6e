"""The yardstick's work counts against hand-worked values and against
the port's own counts.  CPU only."""

import json
import math
from pathlib import Path

import pytest

from perfbench import peaks, work

ROOT = Path(__file__).resolve().parents[2]
PHI3 = json.loads((ROOT / "perfbench/configs/phi3-mini-3.8b.json")
                  .read_text())
FIG3 = json.loads((ROOT / "perfbench/configs/spacdc-fig3.json").read_text())


def test_fig3_round_work_by_hand():
    w = work.coded_round_work(12288, 3584, 18944, 30, 24, 3, 23)
    # 30 workers x (512 x 3584) @ (3584 x 18944), two FLOP a product
    assert 2 * 30 * 512 * 3584 * 18944 == 2_085_743_493_120
    products = 2_085_743_493_120
    encode = 2 * 30 * 27 * 512 * 3584
    decode = 2 * 24 * 23 * 512 * 18944
    assert w["coded_matmul_flops"] == products + encode
    assert w["round_flops"] == products + encode + decode
    assert math.isclose(w["round_flops"], 2.10e12, rel_tol=5e-3)
    # the decode reads the N - S = 23 responders' results and writes K
    # blocks, float32: 0.5445 ms at 3.35 TB/s, where the kernel table's
    # 0.6254 ms (PERF.md) counts all N
    assert w["decode_bytes"] == 4 * (23 * 512 * 18944 + 24 * 23 +
                                     24 * 512 * 18944)
    assert math.isclose(w["decode_bytes"] / peaks.HBM_BYTES_PER_S * 1e3,
                        0.5443, rel_tol=1e-3)
    assert math.isclose(
        work.coded_round_work(12288, 3584, 18944, 30, 24, 3, 30)
        ["decode_bytes"] / peaks.HBM_BYTES_PER_S * 1e3, 0.6254,
        rel_tol=1e-3)
    # operations bound the coded product: ~4.22 ms at 495 TFLOP/s
    assert math.isclose(peaks.roofline_s(w["coded_matmul_flops"],
                                         w["coded_matmul_bytes"],
                                         peaks.TF32_FLOPS) * 1e3,
                        4.219, rel_tol=1e-3)


def test_flash_bwd_work_matches_the_kernel_table():
    nbytes, flops = work.flash_bwd_work(1, 4096, 4096, 32, 32, 96, 96, True,
                                        2)
    # PERF.md's kernel table: 0.2606 ms bound over bf16's 989 TFLOP/s
    assert math.isclose(peaks.roofline_s(flops, nbytes, peaks.BF16_FLOPS)
                        * 1e3, 0.26062785876643074, rel_tol=1e-9)


def test_model_flops_equal_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.roofline_math import model_flops
    cfg = get_config("phi3-mini-3.8b")
    assert work.dense_param_count(PHI3) == cfg.param_count()
    want = model_flops(cfg, ShapeSpec("t", 4096, 8, "train"))
    assert work.model_flops_train(PHI3, 4096, 8) == \
        want["model_flops_global"]


@pytest.mark.parametrize("seq,batch", [(4096, 8), (512, 3), (64, 1)])
def test_model_flops_at_other_shapes(seq, batch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.roofline_math import model_flops
    want = model_flops(get_config("phi3-mini-3.8b"),
                       ShapeSpec("t", seq, batch, "train"))
    assert work.model_flops_train(PHI3, seq, batch) == \
        want["model_flops_global"]


def test_phi3_config_is_the_ports():
    from repro_torch.configs import get_config
    from perfbench.drivers.lm_train import model_config
    port = get_config("phi3-mini-3.8b")
    ours = model_config(PHI3)
    for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "rope_theta", "norm_eps", "tie_embeddings",
                "activation", "norm_type", "qkv_bias", "qk_norm",
                "compute_dtype", "param_dtype", "remat"):
        assert getattr(ours, key) == getattr(port, key), key
