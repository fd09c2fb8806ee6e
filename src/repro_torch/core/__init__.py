"""SPACDC core: Berrut coded computing and the scheme registry.

Ports ``repro/core``.  Importing this package registers the ``spacdc``
scheme, so ``repro_torch.core.registry.build(name, **cfg)`` is ready
immediately.  The baseline schemes, coded training and privacy come in
later slices (see ROADMAP.md).
"""

from .berrut import (berrut_weight_matrix, berrut_weights, chebyshev_points,
                     combine, default_alpha_beta)
from . import registry
from .spacdc import SPACDCCode, SPACDCConfig, pad_to_blocks

__all__ = [
    "berrut_weight_matrix", "berrut_weights", "chebyshev_points", "combine",
    "default_alpha_beta",
    "registry",
    "SPACDCCode", "SPACDCConfig", "pad_to_blocks",
]
