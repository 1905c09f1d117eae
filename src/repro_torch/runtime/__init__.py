"""Query-execution resilience (`resilience`), seeded fault injection
(`chaos`), the continuous-batching query server (`server`) and the training
supervisor (`fault_tolerance`) — the JAX package's ``repro.runtime``
surface."""
from repro_torch.runtime.chaos import (
    ChaosConfig,
    ChaosInjector,
    ChaosKernels,
    ShardFaultError,
)
from repro_torch.runtime.fault_tolerance import (
    SimulatedPreemption,
    TrainSupervisor,
    elastic_restore,
    straggler_update,
)
from repro_torch.runtime.resilience import (
    DegradeReason,
    QueryGuard,
    RetryPolicy,
    adaptive_run,
)
from repro_torch.runtime.server import (
    QueryOutcome,
    QueryServer,
    ServerConfig,
    ServerStats,
    Ticket,
    summarize_outcomes,
)

__all__ = [
    "ChaosConfig",
    "ChaosInjector",
    "ChaosKernels",
    "DegradeReason",
    "QueryGuard",
    "QueryOutcome",
    "QueryServer",
    "RetryPolicy",
    "ServerConfig",
    "ServerStats",
    "ShardFaultError",
    "SimulatedPreemption",
    "Ticket",
    "TrainSupervisor",
    "adaptive_run",
    "elastic_restore",
    "straggler_update",
    "summarize_outcomes",
]
