"""SPACDC core: Berrut coded computing, the scheme registry, the baseline
schemes, coded training and privacy.

Ports ``repro/core``.  Importing this package registers every scheme the
reference registers (``bacc``, ``berrut_grad``, ``conv``, ``glcc``,
``lcc``, ``matdot``, ``mds``, ``polynomial``, ``secpoly``, ``spacdc``), so
``repro_torch.core.registry.build(name, **cfg)`` is ready immediately.
``coded_psum`` all-reduces over a mesh axis (``launch.mesh.use_mesh``).
"""

from .berrut import (berrut_weight_matrix, berrut_weights, chebyshev_points,
                     combine, default_alpha_beta)
from . import registry
from .spacdc import SPACDCCode, SPACDCConfig, pad_to_blocks
from .coded_training import (BerrutGradientCode, coded_backprop_decode,
                             coded_backprop_encode, coded_psum)
from . import baselines, privacy

__all__ = [
    "berrut_weight_matrix", "berrut_weights", "chebyshev_points", "combine",
    "default_alpha_beta",
    "registry",
    "SPACDCCode", "SPACDCConfig", "pad_to_blocks",
    "BerrutGradientCode", "coded_backprop_decode", "coded_backprop_encode",
    "coded_psum",
    "baselines", "privacy",
]
