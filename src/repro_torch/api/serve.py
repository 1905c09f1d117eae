"""`repro_torch.api.serve` — the public serving surface.

A `QueryServer` opened over a `GraphSession` continuously batches
block-join quanta from many in-flight queries on one device, shares cached
steps across shape-bucketed queries through the session's
`ExecutableCache`, and degrades per query (deadline / first-K budget /
fault) — never globally::

    from repro_torch.api import GraphSession

    session = GraphSession.open(graph)              # the card
    outcomes = session.serve(max_inflight=8, deadline_s=0.5).serve(queries)

    with session.serve() as server:                 # open loop: scheduler thread
        ticket = server.submit(query, max_matches=256)
        outcome = ticket.result()                   # QueryOutcome: status + result

Everything here is a re-export of `repro_torch.runtime.server`, which holds
the implementation.
"""
from repro_torch.runtime.server import (
    QueryOutcome,
    QueryServer,
    ServerConfig,
    ServerStats,
    Ticket,
    bucket_key,
    summarize_outcomes,
)

__all__ = [
    "QueryOutcome",
    "QueryServer",
    "ServerConfig",
    "ServerStats",
    "Ticket",
    "bucket_key",
    "summarize_outcomes",
]
