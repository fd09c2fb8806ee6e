"""``repro_torch.launch.roofline_math.model_flops`` against the reference's
``repro.launch.roofline_math.model_flops``: the analytic model FLOPs,
tokens and active parameter counts of every architecture of
``configs.ARCHS`` at every shape of ``SHAPES``, equal exactly (integer
arithmetic over the two packages' copies of the configs)."""

import pytest

from repro_torch.configs import ARCHS, SHAPES

CELLS = [(arch, shape) for arch in sorted(ARCHS) for shape in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equals_reference(arch, shape):
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.launch.roofline_math import model_flops as ref_flops
    from repro_torch.launch.roofline_math import model_flops
    got = model_flops(ARCHS[arch], SHAPES[shape])
    want = ref_flops(REF_ARCHS[arch], REF_SHAPES[shape])
    assert got == want
    assert set(got) == {"model_flops_global", "tokens", "n_active_params",
                        "n_nonemb_active"}
    assert got["model_flops_global"] > 0
