"""`CompiledQuery`: the run side of the compile/run split.

Compilation (planning + executable cache keys) happens once in
`GraphSession.compile`; a `CompiledQuery` can then be run repeatedly —
one-shot (`run`), or streamed in pages with the paper's pipelined first-K
semantics (`stream`). Adaptive capacity growth re-plans escalated queries
through the same session cache, so retries reuse every step whose static
spec survived the escalation.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterator

import numpy as np

from repro_torch.core.plan import QueryPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchPage, MatchResult
from repro_torch.core.stream import stream_blocks
from repro_torch.runtime.resilience import QueryGuard, RetryPolicy

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.api.session import GraphSession


@dataclasses.dataclass
class CompiledQuery:
    """A planned query bound to its session. Reusable and cheap to rerun."""

    session: "GraphSession"
    query: QueryGraph
    plan: QueryPlan
    caps: dict

    @property
    def kernels(self) -> str:
        """Name of the kernel backend this query's steps run on (it keys the
        session's executable cache, so flipping the session's kernels
        re-resolves here automatically)."""
        return self.session.engine.kernels.name

    def run(
        self,
        *,
        max_matches: int | None = None,
        adaptive: bool = True,
        max_retries: int = 6,
        deadline_s: float | None = None,
        memory_budget_bytes: float | None = None,
        guard: QueryGuard | None = None,
        retry_policy: RetryPolicy | None = None,
        **engine_kw,
    ) -> MatchResult:
        """Execute the compiled plan.

        ``max_matches`` overrides the compiled plan's value (0 = all
        matches) without replanning. With ``adaptive=True``, a capacity
        overflow re-plans with doubled block sizes (paper §4.2) and reruns,
        up to ``max_retries`` times; ``adaptive=False`` returns the first,
        possibly partial, result — the paper's first-K semantics.
        ``engine_kw`` passes engine options through.

        Resilience (`repro_torch.runtime.resilience`): ``deadline_s`` /
        ``memory_budget_bytes`` build a `QueryGuard` (or pass ``guard``
        to share one across calls) enforced between retries — a trip
        returns the partial result with a typed
        ``stats.degrade_reason``; ``retry_policy`` controls backoff and
        the cap-growth byte ceiling.
        """
        plan = self.plan
        if max_matches is not None and max_matches != plan.max_matches:
            plan = dataclasses.replace(plan, max_matches=max_matches)
        if guard is None and (
            deadline_s is not None or memory_budget_bytes is not None
        ):
            guard = QueryGuard(
                deadline_s=deadline_s,
                memory_budget_bytes=memory_budget_bytes,
            )
        return self.session.engine._adaptive_match(
            self.query,
            plan,
            adaptive=adaptive,
            max_retries=max_retries,
            guard=guard,
            retry_policy=retry_policy,
            engine_kw=engine_kw,
            kw=dict(self.caps, max_matches=plan.max_matches),
        )

    def stream(
        self,
        page_size: int = 256,
        *,
        max_matches: int | None = None,
        block_rows: int | None = None,
        deadline_s: float | None = None,
        guard: QueryGuard | None = None,
        **engine_kw,
    ) -> Iterator[MatchPage]:
        """Yield matches in pages of ``page_size`` rows as they materialize
        (pipelined first-K delivery, §6.1). The join chain really runs
        block by block, so stopping early (e.g. after ``max_matches`` rows,
        enforced here when set) skips the remaining blocks' join work
        entirely. Pages are disjoint and their concatenation equals a
        one-shot ``run(max_matches=0)`` row set.

        ``block_rows`` trades first-page latency for total throughput: each
        block's join re-probes the full fetched tables, so tiny blocks make
        the first page cheap but a fully-consumed stream expensive — prefer
        `run` when you know you want every match.

        ``deadline_s`` (or a shared ``guard``) bounds the stream: the
        guard is checked between blocks, and on expiry the stream ends
        with one final degraded page — pages already delivered stay
        valid, remaining blocks are never joined. Every page carries the
        stream's shared `MatchStats` (retries, final caps, stage times).
        """
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if guard is None and deadline_s is not None:
            guard = QueryGuard(deadline_s=deadline_s)
        limit = self.plan.max_matches if max_matches is None else max_matches
        blocks = stream_blocks(
            self.session.engine,
            self.query,
            self.plan,
            block_rows=block_rows or max(page_size, 1024),
            guard=guard,
            **engine_kw,
        )
        buf: list[np.ndarray] = []
        buffered = 0
        emitted = 0
        index = 0
        complete = True
        incomplete_seen = False  # some emitted page already carries False
        stats = None  # the stream's shared stats, captured from the blocks

        def page(rows: np.ndarray, complete: bool) -> MatchPage:
            nonlocal index, emitted, incomplete_seen
            incomplete_seen |= not complete
            p = MatchPage(rows=rows, index=index, complete=complete, stats=stats)
            index += 1
            emitted += rows.shape[0]
            return p

        for blk in blocks:
            stats = blk.stats if blk.stats is not None else stats
            complete &= blk.complete
            buf.append(blk.rows)
            buffered += blk.rows.shape[0]
            while buffered >= page_size or (limit and emitted + buffered >= limit):
                # never exceed the limit, even mid-full-page
                take = page_size if not limit else min(page_size, limit - emitted)
                flat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
                head, tail = flat[:take], flat[take:]
                buf, buffered = ([tail], tail.shape[0]) if tail.shape[0] else ([], 0)
                yield page(head, complete)
                if limit and emitted >= limit:
                    return  # early exit: remaining blocks are never joined
        if buffered:
            flat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            if limit:
                flat = flat[: max(0, limit - emitted)]
            if flat.shape[0]:
                yield page(flat, complete)
        if not complete and not incomplete_seen:
            # a capacity overflowed but every emitted page predated the
            # signal (or none had rows): surface it rather than swallow it
            yield page(np.zeros((0, self.plan.n_qnodes), np.int64), False)
