"""The public surface: one declarative ``ClusterSpec`` → one ``Session``.

Ports ``repro/api``:

    from repro_torch.api import ClusterSpec, Session

    with Session(ClusterSpec.paper_fig3()) as s:      # device="cuda"
        out, stats = s.matmul(a, b)
"""

from .spec import (AdaptiveSpec, ClusterSpec, CodeSpec, CryptoSpec,
                   FaultSpec, PrivacySpec, ServeSpec, StragglerSpec,
                   TransportSpec, WaitSpec)
from .session import Session

__all__ = [
    "AdaptiveSpec", "ClusterSpec", "CodeSpec", "CryptoSpec", "FaultSpec",
    "PrivacySpec", "ServeSpec", "StragglerSpec", "TransportSpec",
    "WaitSpec", "Session",
]
