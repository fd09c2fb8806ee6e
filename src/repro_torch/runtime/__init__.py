"""The host runtime: straggler models, wait policies, the virtual-clock
transport, the round scheduler, the round engine and the legacy
master/worker surface.

Ports ``repro/runtime``: ``RoundEngine``, ``RoundStats``, ``WorkerPool``
(virtual clock and real threads), the anytime scheduler
(``AnytimePoint``, ``assemble_curve``), the loop round's tasks,
``DistributedMatmul`` and the SPACDC-DL master ``CodedMaster``; the
continuous-batching serve loop is ``runtime.serve_loop`` (not re-exported
here, as in the reference).  The socket mesh, faults and the adaptive
controller come in later slices (see ROADMAP.md).
"""

from .straggler import StragglerModel
from .wait_policy import (ArrivalEvent, Deadline, ErrorTarget, FirstK,
                          FixedQuantile, WaitPolicy, resolve_policy)
from .scheduler import (AnytimePoint, EncodePipeline, RoundPlan,
                        assemble_curve, plan_round, virtual_events)
from .transport import (ThreadTransport, VirtualClockTransport,
                        available_backends, build_transport,
                        virtual_timeline)
from .tasks import MatmulTask, PairMatmulTask
from .engine import RoundEngine, RoundStats, WorkerPool
from .master_worker import CodedMaster, DistributedMatmul

__all__ = [
    "StragglerModel", "ArrivalEvent", "Deadline", "ErrorTarget", "FirstK",
    "FixedQuantile", "WaitPolicy", "resolve_policy", "EncodePipeline",
    "RoundPlan", "plan_round", "virtual_events", "AnytimePoint",
    "assemble_curve", "VirtualClockTransport", "ThreadTransport",
    "available_backends", "build_transport", "virtual_timeline", "MatmulTask",
    "PairMatmulTask", "RoundEngine", "RoundStats", "WorkerPool",
    "CodedMaster", "DistributedMatmul",
]
