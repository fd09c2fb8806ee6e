"""The host runtime: straggler models, wait policies, the virtual-clock
transport, the round scheduler and the round engine.

Ports ``repro/runtime``.  The engine is not imported here, so importing the
numpy-only modules stays light; use ``repro_torch.runtime.engine`` (or
``repro_torch.api.Session``) for rounds.
"""

from .straggler import StragglerModel
from .wait_policy import (ArrivalEvent, Deadline, ErrorTarget, FirstK,
                          FixedQuantile, WaitPolicy, resolve_policy)
from .scheduler import EncodePipeline, RoundPlan, plan_round, virtual_events
from .transport import (VirtualClockTransport, available_backends,
                        virtual_timeline)

__all__ = [
    "StragglerModel", "ArrivalEvent", "Deadline", "ErrorTarget", "FirstK",
    "FixedQuantile", "WaitPolicy", "resolve_policy", "EncodePipeline",
    "RoundPlan", "plan_round", "virtual_events", "VirtualClockTransport",
    "available_backends", "virtual_timeline",
]
