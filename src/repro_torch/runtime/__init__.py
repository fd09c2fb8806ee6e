"""The host runtime: straggler models, wait policies, the virtual-clock
transport, the round scheduler, the round engine and the legacy
master/worker surface.

Ports ``repro/runtime``: ``RoundEngine``, ``RoundStats``, ``WorkerPool``
(virtual clock), the loop round's tasks, ``DistributedMatmul`` and the
SPACDC-DL master ``CodedMaster``.  Threads and sockets, faults and the
adaptive controller come in later slices (see ROADMAP.md).
"""

from .straggler import StragglerModel
from .wait_policy import (ArrivalEvent, Deadline, ErrorTarget, FirstK,
                          FixedQuantile, WaitPolicy, resolve_policy)
from .scheduler import EncodePipeline, RoundPlan, plan_round, virtual_events
from .transport import (VirtualClockTransport, available_backends,
                        virtual_timeline)
from .tasks import MatmulTask, PairMatmulTask
from .engine import RoundEngine, RoundStats, WorkerPool
from .master_worker import CodedMaster, DistributedMatmul

__all__ = [
    "StragglerModel", "ArrivalEvent", "Deadline", "ErrorTarget", "FirstK",
    "FixedQuantile", "WaitPolicy", "resolve_policy", "EncodePipeline",
    "RoundPlan", "plan_round", "virtual_events", "VirtualClockTransport",
    "available_backends", "virtual_timeline", "MatmulTask",
    "PairMatmulTask", "RoundEngine", "RoundStats", "WorkerPool",
    "CodedMaster", "DistributedMatmul",
]
