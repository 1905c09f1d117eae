"""The port's public entry point, the counterpart of ``repro.api``:
`GraphSession` (``open`` → ``compile`` → ``run`` / ``stream``;
``run_batch``; ``serve`` for continuous batching, `repro_torch.api.serve`)
and the typed results. `__all__` below is the public surface."""
from repro_torch.api.compiled import CompiledQuery
from repro_torch.api.serve import (
    QueryOutcome,
    QueryServer,
    ServerConfig,
    ServerStats,
    Ticket,
    summarize_outcomes,
)
from repro_torch.api.session import GraphSession
from repro_torch.core.cache import ExecutableCache
from repro_torch.core.result import MatchPage, MatchResult, MatchStats

__all__ = [
    "GraphSession",
    "CompiledQuery",
    "ExecutableCache",
    "MatchResult",
    "MatchStats",
    "MatchPage",
    "QueryServer",
    "ServerConfig",
    "ServerStats",
    "QueryOutcome",
    "Ticket",
    "summarize_outcomes",
]
