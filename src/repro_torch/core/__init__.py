"""SPACDC core: Berrut coded computing, the scheme registry, the baseline
schemes, coded training and privacy.

Ports ``repro/core``.  Importing this package registers the ``spacdc``
scheme and the baselines ``conv``, ``mds``, ``polynomial`` and ``matdot``,
so ``repro_torch.core.registry.build(name, **cfg)`` is ready immediately.
LCC, GLCC, SecPoly, BACC, ``berrut_grad``, ``BerrutGradientCode`` and
``coded_psum`` come in later slices (see ROADMAP.md).
"""

from .berrut import (berrut_weight_matrix, berrut_weights, chebyshev_points,
                     combine, default_alpha_beta)
from . import registry
from .spacdc import SPACDCCode, SPACDCConfig, pad_to_blocks
from .coded_training import coded_backprop_decode, coded_backprop_encode
from . import baselines, privacy

__all__ = [
    "berrut_weight_matrix", "berrut_weights", "chebyshev_points", "combine",
    "default_alpha_beta",
    "registry",
    "SPACDCCode", "SPACDCConfig", "pad_to_blocks",
    "coded_backprop_decode", "coded_backprop_encode",
    "baselines", "privacy",
]
