"""Query-execution resilience (`resilience`), seeded fault injection
(`chaos`) and the continuous-batching query server (`server`) — the JAX
package's ``repro.runtime`` surface without ``fault_tolerance``, the
training supervisor, which waits for the port's training path."""
from repro_torch.runtime.chaos import (
    ChaosConfig,
    ChaosInjector,
    ChaosKernels,
    ShardFaultError,
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
    "Ticket",
    "adaptive_run",
    "summarize_outcomes",
]
