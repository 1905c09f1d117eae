"""Continuous-batching `QueryServer`: many users, one device.

A copy of the JAX package's ``runtime/server.py`` over the port's engines.
One `GraphSession` serves many in-flight queries the way LLM engines serve
many decode streams from one model: a stream's block join is
the scheduler quantum, and the scheduler round-robins those quanta across
every in-flight stream, admitting new queries as finished ones drain.

Three ideas:

  * **Shape buckets.** A query's bucket is its step identity — (STwig
    specs, capacities, block size, kernels name), the tuple that keys the
    session's `ExecutableCache`. Concurrent queries in one bucket share
    the cached steps: the first builds them, its bucket-mates hit.
    Admission prefers queries whose bucket is already live.
  * **Continuous batching.** One scheduler quantum = one block join of one
    in-flight query (`repro_torch.core.stream.OpenStream.blocks`), or the
    run-once setup (exploration, and on the sharded engine the load-set
    fetch) when a query is first admitted. Finished queries drain
    mid-loop and free their slot for the next queued query.
  * **Per-query degradation.** Every query carries its own `QueryGuard`
    (deadline armed at submission, so queue wait counts) and first-K
    budget. A trip degrades THAT query — its stream ends with a typed
    partial result — and its bucket-mates never notice; a per-query
    exception becomes a failed `QueryOutcome`, not a dead server. The
    only thing counted as global is an error escaping the scheduler loop
    itself (`ServerStats.global_degradations`).

On the card every quantum launches the matcher's kernels from the thread
that runs the scheduler: the caller's, or the one `QueryServer.start`
starts. A failed outcome there hides whatever raised (a kernel that did
not launch, too) behind ``QueryOutcome.error``, so a caller that must know
reads the statuses.

The public surface is re-exported as `repro_torch.api.serve`; open a server
with `GraphSession.serve(...)`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.plan import QueryPlan, caps_from_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchPage, MatchResult, MatchStats
from repro_torch.core.stream import OpenStream, open_stream
from repro_torch.runtime.resilience import DegradeReason, QueryGuard, degraded_empty

__all__ = [
    "QueryOutcome",
    "QueryServer",
    "ServerConfig",
    "ServerStats",
    "Ticket",
    "bucket_key",
    "summarize_outcomes",
]


def bucket_key(plan: QueryPlan, block_rows: int, kernels: str) -> tuple:
    """A query's shape bucket: the static identity of every step its
    stream will ask the session cache for. Two queries with equal buckets
    share cached steps end to end — same STwig specs (match step), same
    capacities and block size (join steps), same kernel backend."""
    caps = caps_from_plan(plan)
    return (
        plan.specs,
        caps["child_cap"],
        caps["join_rows_cap"],
        caps["join_dup_cap"],
        int(block_rows),
        str(kernels),
    )


@dataclasses.dataclass
class ServerConfig:
    """Serving knobs, validated once at server construction.

    ``max_inflight`` bounds how many streams the scheduler interleaves
    (admission control; queued queries' deadlines keep running while they
    wait). ``block_rows`` is the scheduler quantum size — small blocks
    give fair, low-latency interleaving, large blocks amortize per-call
    overhead. ``max_matches`` is the default per-query first-K budget
    (0 = all matches); ``deadline_s`` the default per-query deadline
    (None = none). With ``prefer_warm_buckets`` admission picks queued
    queries whose shape bucket is already in flight before falling back
    to FIFO, maximizing step sharing under load.
    """

    max_inflight: int = 8
    block_rows: int = 512
    max_matches: int = 1024
    deadline_s: float | None = None
    prefer_warm_buckets: bool = True

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")
        if self.max_matches < 0:
            raise ValueError("max_matches must be >= 0 (0 = unbounded)")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")


@dataclasses.dataclass
class QueryOutcome:
    """What serving one query produced (the server-side `MatchResult`).

    ``status`` is the three-way split `launch/serve.py` reports: ``"served"`` (complete, or first-K budget met),
    ``"partial"`` (a capacity overflowed or the query's guard tripped —
    the typed why is in ``result.stats.degrade_reason``), ``"failed"``
    (an exception inside this query's quanta; the server kept running).
    """

    result: MatchResult
    status: str                  # "served" | "partial" | "failed"
    bucket: tuple
    pages: list[MatchPage]
    queue_s: float               # submission -> admission
    wall_s: float                # submission -> completion
    ttfp_s: float | None         # submission -> first non-empty page
    error: str | None = None     # repr of the per-query exception, if any

    @property
    def rows(self) -> np.ndarray:
        return self.result.rows

    @property
    def n_matches(self) -> int:
        return self.result.n_matches

    @property
    def stats(self) -> MatchStats:
        return self.result.stats


class Ticket:
    """The caller's handle on one submitted query — thread-safe; resolved
    by the scheduler. ``result()`` blocks (so it belongs with a started
    server or after ``run_until_idle``); ``done()`` polls."""

    def __init__(self, query: QueryGraph, bucket: tuple):
        self.query = query
        self.bucket = bucket
        self._event = threading.Event()
        self._outcome: QueryOutcome | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryOutcome:
        if not self._event.wait(timeout):
            raise TimeoutError("query still in flight — is the server "
                               "running (started or pumped to idle)?")
        assert self._outcome is not None
        return self._outcome

    def _resolve(self, outcome: QueryOutcome) -> None:
        self._outcome = outcome
        self._event.set()


@dataclasses.dataclass
class ServerStats:
    """Cumulative serving counters (scheduler-thread owned)."""

    submitted: int = 0
    admitted: int = 0
    served: int = 0
    partial: int = 0
    failed: int = 0
    setup_quanta: int = 0        # admissions that ran exploration/fetch
    join_quanta: int = 0         # block joins the scheduler dispatched
    warm_admissions: int = 0     # admitted into an already-live bucket
    peak_inflight: int = 0       # deepest concurrent in-flight set seen
    # errors escaping the scheduler loop itself — per-query failures never
    # count here; the serving SLO is that this stays 0 under overload
    global_degradations: int = 0
    buckets: dict[tuple, int] = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> int:
        return self.served + self.partial + self.failed

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "served": self.served,
            "partial": self.partial,
            "failed": self.failed,
            "setup_quanta": self.setup_quanta,
            "join_quanta": self.join_quanta,
            "warm_admissions": self.warm_admissions,
            "peak_inflight": self.peak_inflight,
            "global_degradations": self.global_degradations,
            "n_buckets": len(self.buckets),
        }


def summarize_outcomes(outcomes: Iterable[QueryOutcome]) -> dict:
    """The served/partial/failed split plus totals — the dict
    `launch/serve.py` prints from (and tests pin)."""
    out = {"served": 0, "partial": 0, "failed": 0, "n_matches": 0}
    for o in outcomes:
        out[o.status] += 1
        out["n_matches"] += o.n_matches
    return out


@dataclasses.dataclass(eq=False)
class _InFlight:
    """Scheduler-private state of one admitted query."""

    ticket: Ticket
    plan: QueryPlan
    guard: QueryGuard | None
    budget: int                  # first-K budget (0 = all matches)
    block_rows: int
    t_submit: float
    t_admit: float
    engine_kw: dict
    stream: OpenStream | None = None
    blocks: object = None        # the stream's block iterator
    pages: list[MatchPage] = dataclasses.field(default_factory=list)
    emitted: int = 0
    t_first_page: float | None = None

    def take(self, page: MatchPage) -> bool:
        """Accumulate one block's page (trimmed to the remaining budget);
        True when the first-K budget is met and the stream can close —
        the remaining blocks' joins are then never executed."""
        if self.budget:
            room = self.budget - self.emitted
            if page.rows.shape[0] > room:
                page = dataclasses.replace(page, rows=page.rows[:room])
        if page.rows.shape[0] and self.t_first_page is None:
            self.t_first_page = time.perf_counter()
        self.pages.append(page)
        self.emitted += page.rows.shape[0]
        return bool(self.budget) and self.emitted >= self.budget


class QueryServer:
    """Continuous-batching serving loop over one `GraphSession`.

    Synchronous use (one caller, e.g. a launcher or a test)::

        outcomes = session.serve(max_inflight=8).serve(queries)

    Open-loop use (submissions arrive while the scheduler runs)::

        with session.serve(deadline_s=0.5) as server:   # scheduler thread
            tickets = [server.submit(q) for q in arriving_queries]
            outcomes = [t.result() for t in tickets]

    The scheduler itself is single-threaded — every quantum's kernels are
    launched from one thread; what continuous batching buys is that the
    one thread always has a next quantum from SOME query, and that the
    quanta of expensive queries interleave with (never block) cheap ones.
    `submit` is safe from any thread.
    """

    def __init__(self, session, config: ServerConfig | None = None):
        self.session = session
        self.config = config or ServerConfig()
        self.stats = ServerStats()
        self._lock = threading.Lock()
        self._pending: deque = deque()     # submissions, any thread
        self._queue: deque = deque()       # admission queue, scheduler only
        self._inflight: list[_InFlight] = []
        self._rr = 0                       # round-robin cursor
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- submit
    def submit(
        self,
        query: QueryGraph,
        *,
        max_matches: int | None = None,
        deadline_s: float | None = None,
        block_rows: int | None = None,
        engine_kw: dict | None = None,
        **caps,
    ) -> Ticket:
        """Admit ``query`` to the serving queue and return its `Ticket`.

        Planning happens here (host-side, cheap) so the ticket knows its
        shape bucket before admission; the deadline guard is armed here
        too, so time spent queued counts against the deadline — an
        overloaded server sheds expired queries at admission instead of
        running them late.
        """
        cfg = self.config
        budget = cfg.max_matches if max_matches is None else int(max_matches)
        deadline = cfg.deadline_s if deadline_s is None else deadline_s
        rows = cfg.block_rows if block_rows is None else int(block_rows)
        plan = self.session.compile(query, **caps).plan
        guard = None
        if deadline is not None:
            guard = QueryGuard(deadline_s=deadline)
            guard.start()
        entry = _InFlight(
            ticket=Ticket(query, bucket_key(plan, rows, self.session.kernels.name)),
            plan=plan,
            guard=guard,
            budget=budget,
            block_rows=rows,
            t_submit=time.perf_counter(),
            t_admit=0.0,
            engine_kw=dict(engine_kw or {}),
        )
        with self._lock:
            self._pending.append(entry)
        self._wake.set()
        return entry.ticket

    # ---------------------------------------------------------- scheduler
    def step(self) -> bool:
        """One scheduler quantum: admit if a slot is free, then run either
        one query's stream setup (exploration/fetch) or one block join,
        round-robin across the in-flight set. Returns False when idle
        (nothing queued, nothing in flight)."""
        self._drain_pending()
        self._admit()
        if not self._inflight:
            return False
        i = self._rr % len(self._inflight)
        entry = self._inflight[i]
        try:
            if entry.stream is None:
                entry.stream = open_stream(
                    self.session.engine,
                    entry.ticket.query,
                    entry.plan,
                    block_rows=entry.block_rows,
                    guard=entry.guard,
                    **entry.engine_kw,
                )
                entry.blocks = entry.stream.blocks()
                self.stats.setup_quanta += 1
                # keep the cursor here: the freshly-set-up query gets its
                # first join quantum next, so its first page lands right
                # after admission instead of a full round-robin lap later
                self._rr = i
                return True
            page = next(entry.blocks)
        except StopIteration:
            self._retire(i, entry)
            return True
        except Exception as exc:  # noqa: BLE001 — per-query isolation:
            # one query's fault must not take down its bucket-mates
            self._retire(i, entry, error=exc)
            return True
        self.stats.join_quanta += 1
        if entry.take(page):
            entry.blocks.close()  # budget met: remaining blocks never join
            self._retire(i, entry)
        else:
            self._rr = i + 1
        return True

    def run_until_idle(self) -> None:
        """Pump the scheduler until queue and in-flight set are empty (the
        synchronous serving mode)."""
        try:
            while self.step():
                pass
        except Exception:
            self.stats.global_degradations += 1
            raise

    def serve(
        self, queries: Sequence[QueryGraph] | Iterable[QueryGraph], **kw
    ) -> list[QueryOutcome]:
        """Submit a whole workload and serve it to completion; outcomes
        come back in submission order. ``kw`` is per-query `submit`
        keywords applied to every query. Works in both modes: with the
        background thread running it just waits, otherwise it pumps."""
        tickets = [self.submit(q, **kw) for q in queries]
        if self._thread is None:
            self.run_until_idle()
        return [t.result() for t in tickets]

    # ---------------------------------------------------- scheduler thread
    def start(self) -> "QueryServer":
        """Run the scheduler on a background thread (open-loop serving:
        `submit` from any thread, `Ticket.result()` to collect)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    busy = self.step()
                except Exception:  # noqa: BLE001 — a scheduler-level
                    # failure is the one thing counted as global
                    self.stats.global_degradations += 1
                    continue
                if not busy:
                    self._wake.wait(timeout=0.001)
                    self._wake.clear()

        self._thread = threading.Thread(
            target=loop, name="repro-torch-query-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler thread (in-flight work finishes its current
        quantum; unfinished tickets stay unresolved)."""
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ plumbing
    def _drain_pending(self) -> None:
        with self._lock:
            moved = list(self._pending)
            self._pending.clear()
        for entry in moved:
            self.stats.submitted += 1
            b = entry.ticket.bucket
            self.stats.buckets[b] = self.stats.buckets.get(b, 0) + 1
            self._queue.append(entry)

    def _live_buckets(self) -> set:
        return {e.ticket.bucket for e in self._inflight}

    def _admit(self) -> None:
        while self._queue and len(self._inflight) < self.config.max_inflight:
            idx = 0
            if self.config.prefer_warm_buckets and len(self._queue) > 1:
                live = self._live_buckets()
                idx = next(
                    (k for k, e in enumerate(self._queue)
                     if e.ticket.bucket in live),
                    0,
                )
            entry = self._queue[idx]
            del self._queue[idx]
            entry.t_admit = time.perf_counter()
            # admission control: a query whose deadline expired while
            # queued is shed here — degraded per-query, never run late
            reason = entry.guard.check() if entry.guard is not None else None
            if reason is not None:
                self._finish(entry, degraded=reason)
                continue
            if entry.ticket.bucket in self._live_buckets():
                self.stats.warm_admissions += 1
            self.stats.admitted += 1
            self._inflight.append(entry)
            self.stats.peak_inflight = max(
                self.stats.peak_inflight, len(self._inflight)
            )

    def _retire(self, i: int, entry: _InFlight, error=None) -> None:
        self._inflight.pop(i)
        self._rr = i
        self._finish(entry, error=error)

    def _finish(
        self, entry: _InFlight, error=None, degraded: DegradeReason | None = None
    ) -> None:
        now = time.perf_counter()
        if degraded is not None:
            # shed at admission: never opened, typed empty partial result
            result = degraded_empty(
                entry.plan.n_qnodes, self.session.backend, degraded
            )
        else:
            rows = (
                np.concatenate([p.rows for p in entry.pages], axis=0)
                if entry.pages
                else np.zeros((0, entry.plan.n_qnodes), np.int64)
            )
            stats = (
                entry.stream.stats
                if entry.stream is not None
                else MatchStats(backend=self.session.backend)
            )
            complete = (
                all(p.complete for p in entry.pages)
                and stats.degrade_reason is None
                and error is None
            )
            result = MatchResult(
                rows=rows,
                n_matches=int(rows.shape[0]),
                complete=complete,
                stats=stats,
            )
        if error is not None:
            status = "failed"
        elif result.complete:
            status = "served"
        else:
            status = "partial"
        setattr(self.stats, status, getattr(self.stats, status) + 1)
        entry.ticket._resolve(QueryOutcome(
            result=result,
            status=status,
            bucket=entry.ticket.bucket,
            pages=list(entry.pages),
            queue_s=max(0.0, entry.t_admit - entry.t_submit),
            wall_s=now - entry.t_submit,
            ttfp_s=(
                None
                if entry.t_first_page is None
                else entry.t_first_page - entry.t_submit
            ),
            error=None if error is None else repr(error),
        ))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"QueryServer(inflight={len(self._inflight)}, "
            f"queued={len(self._queue)}, stats={self.stats.as_dict()})"
        )
