"""The public surface: one declarative ``ClusterSpec`` → one ``Session``.

Ports ``repro/api``:

    from repro_torch.api import ClusterSpec, Session

    with Session(ClusterSpec.paper_fig3()) as s:      # device="cuda"
        out, stats = s.matmul(a, b)
        s.init_mlp((784, 512, 10))
        loss, elapsed = s.train_step(x, y)
        report = s.serve(arch="qwen2-7b", tiny=True)
"""

from .spec import (AdaptiveSpec, ClusterSpec, CodeSpec, CryptoSpec,
                   FaultSpec, PrivacySpec, ServeSpec, StragglerSpec,
                   TransportSpec, WaitSpec)
from .session import ServeReport, Session, coded_mlp_init, coded_mlp_step

__all__ = [
    "AdaptiveSpec", "ClusterSpec", "CodeSpec", "CryptoSpec", "FaultSpec",
    "PrivacySpec", "ServeSpec", "StragglerSpec", "TransportSpec",
    "WaitSpec", "Session", "ServeReport", "coded_mlp_init",
    "coded_mlp_step",
]
