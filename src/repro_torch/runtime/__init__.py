"""The host runtime: straggler models, wait policies, the virtual-clock
and thread transports, the round scheduler, fault injection and handling,
the adaptive redundancy controller, the round engine and the legacy
master/worker surface.

Ports ``repro/runtime``: ``RoundEngine``, ``RoundStats``, ``WorkerPool``
(virtual clock and real threads), the anytime scheduler
(``AnytimePoint``, ``assemble_curve``), screening (``screen_responders``,
``retry_backoff``, ``observed_delays``), the round tasks, the fault layer
(``runtime.faults``), the adaptive controller (``runtime.adaptive``),
``DistributedMatmul`` and the SPACDC-DL master ``CodedMaster``; the
continuous-batching serve loop is ``runtime.serve_loop`` (not re-exported
here, as in the reference), and so is the socket mesh of worker processes
(``runtime.socket_transport``, with its wire codec ``runtime.wire``), which
``build_transport("socket", ...)`` loads when it is asked for.
"""

from .straggler import StragglerModel
from .wait_policy import (ArrivalEvent, Deadline, ErrorTarget, FirstK,
                          FixedQuantile, WaitPolicy, resolve_policy)
from .scheduler import (AnytimePoint, EncodePipeline, RoundPlan,
                        assemble_curve, observed_delays, plan_round,
                        retry_backoff, screen_responders, virtual_events)
from .adaptive import (AdaptiveController, Decision, FittedModel,
                       OnlineStragglerEstimator, error_profile)
from .transport import (ThreadTransport, VirtualClockTransport,
                        available_backends, build_transport,
                        virtual_timeline)
from .faults import (DegradedRoundError, FaultInjectingTransport,
                     ResultDropped, WorkerHealth, plan_faults)
from .tasks import (EnvelopeMatmulTask, MatmulTask, PairMatmulTask,
                    SealedMatmulTask)
from .engine import RoundEngine, RoundStats, WorkerPool
from .master_worker import CodedMaster, DistributedMatmul

__all__ = [
    "StragglerModel", "ArrivalEvent", "Deadline", "ErrorTarget", "FirstK",
    "FixedQuantile", "WaitPolicy", "resolve_policy", "EncodePipeline",
    "RoundPlan", "plan_round", "virtual_events", "AnytimePoint",
    "assemble_curve", "observed_delays", "retry_backoff",
    "screen_responders", "AdaptiveController", "Decision", "FittedModel",
    "OnlineStragglerEstimator", "error_profile", "VirtualClockTransport",
    "ThreadTransport", "available_backends", "build_transport",
    "virtual_timeline", "DegradedRoundError", "FaultInjectingTransport",
    "ResultDropped", "WorkerHealth", "plan_faults", "EnvelopeMatmulTask",
    "MatmulTask", "PairMatmulTask", "SealedMatmulTask", "RoundEngine",
    "RoundStats", "WorkerPool", "CodedMaster", "DistributedMatmul",
]
