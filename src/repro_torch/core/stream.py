"""The streaming driver (paper §6.1).

An engine exposes two methods: ``_stream_setup`` runs the once-per-query
work (exploration) and returns a state object, and
``_stream_block(state, lo, B)`` joins only rows ``[lo, lo+B)`` of the
blocked table through the join chain. Abandoning the iterator early leaves
all remaining blocks' joins unexecuted.

The two halves are also exposed separately: `open_stream` runs the setup
eagerly and returns an `OpenStream` whose ``blocks()`` iterator joins one
block per ``next()``. `stream_blocks` composes the two lazily (setup on
first ``next()``).

The block boundary is also the stream's preemption point: a
`repro_torch.runtime.resilience.QueryGuard` passed as ``guard`` is checked
before every block, and a tripped deadline ends the stream with one final
degraded page (``complete=False``, the reason in the shared stats) — the
pages already delivered stay valid, the remaining blocks are never joined.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.plan import QueryPlan, caps_from_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchPage


@dataclasses.dataclass(eq=False)
class OpenStream:
    """A stream whose run-once half has already executed.

    ``state`` holds the engine's per-query stream state (tables on device,
    schemas, join order); ``blocks()`` joins lazily, one block per
    ``next()``. One `OpenStream` belongs to one query.
    """

    engine: object
    query: QueryGraph
    state: object
    guard: object
    block_rows: int  # effective B (clamped to the blocked table's capacity)

    @property
    def stats(self):
        """The stream's shared `MatchStats` (every page carries it)."""
        return self.state.stats

    @property
    def plan(self) -> QueryPlan:
        return self.state.plan

    @property
    def n_blocks(self) -> int:
        """Upper bound on join quanta left in a full consumption."""
        return -(-self.state.cap // self.block_rows)

    def blocks(self) -> Iterator[MatchPage]:
        """Yield one `MatchPage` per non-empty block of the blocked table.

        Pages are disjoint and their union over all blocks equals a
        one-shot ``max_matches=0`` run: blocks partition the blocked
        table's rows and every join output row descends from exactly one
        of them. Streaming is inherently first-K: there
        is no adaptive retry; a page whose block overflowed a capacity
        reports ``complete=False``.
        """
        state, stats, guard = self.state, self.state.stats, self.guard
        index = 0
        for lo in range(0, state.cap, self.block_rows):
            if guard is not None:
                reason = guard.check()
                if reason is not None:
                    if stats.degrade_reason is None:
                        stats.degrade_reason = str(reason)
                    yield MatchPage(
                        rows=np.zeros((0, state.plan.n_qnodes), np.int64),
                        index=index,
                        complete=False,
                        stats=stats,
                    )
                    return
            rows, block_overflow = self.engine._stream_block(
                state, lo, self.block_rows
            )
            faulted = stats.degrade_reason is not None
            if rows.shape[0] == 0 and not block_overflow:
                continue
            yield MatchPage(
                rows=rows,
                index=index,
                complete=not (
                    state.explore_overflow or block_overflow or faulted
                ),
                stats=stats,
            )
            index += 1
        if index == 0 and (
            state.explore_overflow or stats.degrade_reason is not None
        ):
            # exploration overflowed (or the fetch degraded) and no block
            # produced rows: without a page the incompleteness would be
            # invisible to the consumer
            yield MatchPage(
                rows=np.zeros((0, state.plan.n_qnodes), np.int64),
                index=0,
                complete=False,
                stats=stats,
            )


def open_stream(
    engine,
    query: QueryGraph,
    plan: QueryPlan | None = None,
    *,
    block_rows: int = 1024,
    guard=None,
    **engine_kw,
) -> OpenStream:
    """Run the once-per-query half NOW (guard arming, exploration) and
    return the open stream. ``guard.start()`` is idempotent, so a guard
    armed earlier keeps its original epoch.
    """
    if guard is not None:
        if guard.deadline_s is not None and getattr(engine, "spmd", False):
            # a deadline could end the stream on one rank only, leaving the
            # others waiting in the next block's gather
            raise ValueError("a deadline may trip on one rank only: the rank engine refuses it")
        guard.start()
    state = engine._stream_setup(query, plan, **engine_kw)
    stats = state.stats
    stats.retries = 0
    caps = caps_from_plan(state.plan)
    stats.final_caps = {
        k: caps[k] for k in ("child_cap", "join_rows_cap", "join_dup_cap")
    }
    return OpenStream(
        engine=engine,
        query=query,
        state=state,
        guard=guard,
        block_rows=max(1, min(block_rows, state.cap)),
    )


def stream_blocks(
    engine,
    query: QueryGraph,
    plan: QueryPlan | None = None,
    *,
    block_rows: int = 1024,
    guard=None,
    **engine_kw,
) -> Iterator[MatchPage]:
    """`open_stream` + `OpenStream.blocks`, composed lazily: nothing (not
    even setup) runs until the first ``next()``, matching the historical
    generator semantics."""
    yield from open_stream(
        engine, query, plan, block_rows=block_rows, guard=guard, **engine_kw
    ).blocks()
