"""Query-execution resilience: deadlines, memory budgets, bounded retry.

The part of the JAX package's ``runtime/resilience.py`` that the local
query path calls:

  * `DegradeReason` — the typed "why" of a partial result;
  * `QueryGuard` — per-query deadline + device-memory budget, checked at
    host-side preemption points: between adaptive retries (`adaptive_run`)
    and between blocks in the streaming driver;
  * `RetryPolicy` — seeded jittered backoff between retries and a
    cap-growth ceiling, so escalation stops *before* the doubled plan
    exceeds the memory ceiling rather than after an out-of-memory error;
    and the sharded engine's fetch-retry budget (`repro_torch.runtime.chaos`
    injects the shard faults it recovers from);
  * `adaptive_run` — the one retry loop the engine and
    `CompiledQuery.run` share; `stage` — per-stage wall times.

Cap growth is priced as the JAX package prices it, with the staticcheck
cost model: `join_cost_bytes` runs the escalated join on ``meta`` tensors
under the op recorder and takes the peak of its storages' lifetimes (the
JAX package traces it with ``jax.make_jaxpr``); the estimate grows with
``join_rows_cap × join_dup_cap``. The ceiling, `retry_ceiling_bytes`, is
the ``retry`` section of the port's ``analysis/budgets.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import random
import time
from typing import Callable

import numpy as np

from repro_torch.core.result import MatchResult, MatchStats

__all__ = [
    "DegradeReason",
    "QueryGuard",
    "RetryPolicy",
    "adaptive_run",
    "degraded_empty",
    "grow_caps",
    "join_cost_bytes",
    "plan_caps_bytes",
    "retry_ceiling_bytes",
]

# caps that adaptive escalation grows (and that MatchStats.final_caps
# reports) — everything else in a caps dict passes through untouched
GROWN_CAP_KEYS = ("child_cap", "join_rows_cap", "join_dup_cap")


class DegradeReason(str, enum.Enum):
    """Why a result came back partial. Stored in
    ``MatchStats.degrade_reason`` as the plain value string (members
    compare equal to their values, so ``reason == "deadline"`` works)."""

    DEADLINE = "deadline"                  # QueryGuard deadline expired
    BUDGET = "budget"                      # caller's memory budget exceeded
    OVERFLOW_CEILING = "overflow-ceiling"  # caps still overflow, growth capped
    SHARD_FAULT = "shard-fault"            # degraded to surviving shards

    def __str__(self) -> str:  # log lines print "deadline", not the repr
        return self.value


def grow_caps(caps: dict) -> dict:
    """One step of adaptive capacity growth (paper §4.2: block sizes are set
    by available memory; overflow doubles them and re-runs).

    Growth is plain doubling for every capacity, so retry ``r`` runs at
    ``2**r`` times the seed caps — geometric, bounded by the retry budget
    and by `RetryPolicy`'s byte ceiling. (An earlier version multiplied
    ``child_cap`` by ``2 * retries``, compounding super-exponentially and
    risking OOM before the retry budget was spent.)
    """
    caps = dict(caps)
    caps["child_cap"] = 2 * caps.get("child_cap", 8)
    caps["join_rows_cap"] = 2 * caps.get("join_rows_cap", 1 << 16)
    caps["join_dup_cap"] = 2 * caps.get("join_dup_cap", 64)
    return caps


# ----------------------------------------------------------- cost estimates

# the cap-growth ceiling when no budgets dict is given and the port's
# ``analysis/budgets.json`` has no ``retry`` section: its
# ``retry.memory_ceiling_bytes``, as the JAX package's
MEMORY_CEILING_BYTES = 16e9

# canonical probe shape, as the JAX package prices it: two width-4 tables
# sharing one query node. Per-query widths vary by a column or two; the
# caps vary by 2**r.
_PROBE_WIDTH = 4
_COST_CACHE: dict[tuple[int, int, int], float] = {}


def join_cost_bytes(out_cap: int, dup_cap: int, width: int = _PROBE_WIDTH) -> float:
    """Peak live bytes of one `sort_merge_join` of two ``out_cap``-row
    tables of ``width`` columns, from the staticcheck cost model's storage
    liveness over the join run on ``meta`` tensors — shapes only: nothing
    is computed and no device memory is touched."""
    key = (int(out_cap), int(dup_cap), int(width))
    hit = _COST_CACHE.get(key)
    if hit is not None:
        return hit
    import torch

    from repro_torch.analysis.staticcheck import costmodel, oplog
    from repro_torch.core import join as join_lib

    w = max(2, int(width))
    sa = join_lib.Schema(qnodes=tuple(range(w)), qlabels=(0,) * w)
    sb = join_lib.Schema(qnodes=(w - 1,) + tuple(range(w, 2 * w - 1)), qlabels=(0,) * w)

    def table(cap):
        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        return join_lib.JoinTable(
            cols=meta((cap, w), torch.int32), valid=meta((cap,), torch.bool),
            n_rows=meta((), torch.int32), overflow=meta((), torch.bool),
        )

    def peak(cap: int) -> float:
        _, log = oplog.record(
            lambda a, b: join_lib.sort_merge_join(
                a, b, sa, sb, out_cap=cap, dup_cap=int(dup_cap)
            )[0],
            table(cap), table(cap),
        )
        return costmodel.peak_bytes(log)

    # every buffer of the join is linear in ``out_cap`` at a fixed
    # ``dup_cap``; torch's meta cumsum sizes an n × n scratch, which
    # overflows at 2**30 probe pairs, so such caps are priced at half the
    # rows, twice
    cap, scale = int(out_cap), 1
    while True:
        try:
            est = peak(cap) * scale
            break
        except RuntimeError:
            if cap < 2:
                raise
            cap, scale = cap // 2, scale * 2
    _COST_CACHE[key] = est
    return est


def plan_caps_bytes(caps: dict) -> float:
    """Byte estimate for a caps dict (the join dominates every other
    allocation by orders of magnitude, so it IS the estimate)."""
    return join_cost_bytes(
        caps.get("join_rows_cap", 1 << 16), caps.get("join_dup_cap", 64)
    )


def retry_ceiling_bytes(budgets: dict | None = None) -> float:
    """The cap-growth byte ceiling: ``budgets["retry"]["memory_ceiling_bytes"]``
    of a dict shaped like ``analysis/budgets.json``; with no dict, the
    port's own ``analysis/budgets.json``'s (as the JAX package reads its
    own). A dict without the entry gives `MEMORY_CEILING_BYTES`."""
    if budgets is None:
        from repro_torch.analysis.staticcheck import costmodel

        budgets = costmodel.load_budgets()
    retry = budgets.get("retry", {}) if isinstance(budgets, dict) else {}
    return float(retry.get("memory_ceiling_bytes", MEMORY_CEILING_BYTES))


# ------------------------------------------------------------------ guard


@dataclasses.dataclass
class QueryGuard:
    """Per-query deadline and device-memory budget.

    Enforced cooperatively at host-side preemption points — never inside a
    jitted program — so a trip costs at most one in-flight block/retry: a
    deadline-bounded query returns within the deadline plus one unit of
    work, not after an unbounded run. ``clock`` is injectable for tests.
    """

    deadline_s: float | None = None
    memory_budget_bytes: float | None = None
    clock: Callable[[], float] = time.monotonic
    started_at: float | None = None

    def start(self) -> "QueryGuard":
        """Arm the deadline (idempotent — re-entering run/stream on the
        same guard keeps the original epoch, so one guard bounds a whole
        multi-call interaction)."""
        if self.started_at is None:
            self.started_at = self.clock()
        return self

    def elapsed_s(self) -> float:
        return 0.0 if self.started_at is None else self.clock() - self.started_at

    def remaining_s(self) -> float | None:
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.elapsed_s()

    def check(self, planned_bytes: float | None = None) -> DegradeReason | None:
        """The preemption-point test: returns the degrade reason to stop
        with, or None to keep going. ``planned_bytes`` (when known) is the
        estimate for the work *about to be* scheduled."""
        rem = self.remaining_s()
        if rem is not None and rem <= 0:
            return DegradeReason.DEADLINE
        if (
            planned_bytes is not None
            and self.memory_budget_bytes is not None
            and planned_bytes > self.memory_budget_bytes
        ):
            return DegradeReason.BUDGET
        return None


# ------------------------------------------------------------------ policy


@dataclasses.dataclass
class RetryPolicy:
    """How adaptive escalation and fetch recovery retry.

    ``backoff(i)`` grows geometrically with deterministic, seeded jitter
    (two policies with equal seeds back off identically — chaos tests are
    reproducible). ``backoff_s`` defaults to 0 so plain adaptive runs keep
    their no-sleep behaviour; the sharded engine's fetch-retry loop uses
    ``fetch_backoff_s`` and gives up after ``fetch_retries`` retries.
    ``ceiling_bytes=None`` means `retry_ceiling_bytes()`.
    """

    max_retries: int = 6
    backoff_s: float = 0.0
    fetch_retries: int = 3
    fetch_backoff_s: float = 0.01
    jitter: float = 0.5
    seed: int = 0
    ceiling_bytes: float | None = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def ceiling(self) -> float:
        if self.ceiling_bytes is not None:
            return float(self.ceiling_bytes)
        return retry_ceiling_bytes()

    def backoff(self, attempt: int, base_s: float | None = None) -> float:
        base = self.backoff_s if base_s is None else base_s
        return base * (2**attempt) * (1.0 + self.jitter * self._rng.random())

    def sleep(self, attempt: int, base_s: float | None = None) -> float:
        t = self.backoff(attempt, base_s)
        if t > 0:
            time.sleep(t)
        return t

    def next_caps(
        self, caps: dict, guard: QueryGuard | None = None
    ) -> tuple[dict | None, DegradeReason | None]:
        """One escalation step, or the typed reason there is none: the
        grown caps are costed BEFORE anything is planned or traced, so
        retry stops ahead of the OOM, not after it."""
        grown = grow_caps(caps)
        est = plan_caps_bytes(grown)
        if (
            guard is not None
            and guard.memory_budget_bytes is not None
            and est > guard.memory_budget_bytes
        ):
            return None, DegradeReason.BUDGET
        if est > self.ceiling():
            return None, DegradeReason.OVERFLOW_CEILING
        return grown, None


# -------------------------------------------------------------- retry loop


def _final_caps(caps: dict) -> dict:
    return {k: caps[k] for k in GROWN_CAP_KEYS if k in caps}


def mark_degraded(res: MatchResult, reason) -> MatchResult:
    """Stamp a typed degrade reason onto a result (idempotent; keeps any
    rows already produced — degraded ≠ empty)."""
    res.complete = False
    if res.stats.degrade_reason is None:
        res.stats.degrade_reason = str(
            reason.value if isinstance(reason, DegradeReason) else reason
        )
    return res


def degraded_empty(n_qnodes: int, backend: str, reason) -> MatchResult:
    """The result of refusing to run at all (pre-expired deadline, plan
    over budget at admission)."""
    stats = MatchStats(backend=backend)
    res = MatchResult(
        rows=np.zeros((0, n_qnodes), np.int64),
        n_matches=0,
        complete=False,
        stats=stats,
    )
    return mark_degraded(res, reason)


def adaptive_run(
    first: Callable[[], MatchResult],
    escalate: Callable[[dict], MatchResult],
    caps: dict,
    *,
    n_qnodes: int,
    backend: str,
    policy: RetryPolicy | None = None,
    guard: QueryGuard | None = None,
    adaptive: bool = True,
) -> MatchResult:
    """The shared adaptive loop behind `SubgraphMatcher.match` and
    `CompiledQuery.run`.

    ``first`` runs the seed plan; ``escalate(caps)`` re-plans and re-runs
    at grown caps. Escalation stops on: success, a guard trip (deadline /
    budget), the policy's byte ceiling, the retry budget, or a result that
    already carries a degrade reason (a shard fault is not a capacity
    problem — growing caps would not help). With ``adaptive=False`` the
    first (possibly partial) result is returned — the paper's first-K
    semantics, not a degradation, so no reason is stamped.
    """
    policy = policy or RetryPolicy()
    caps = dict(caps)
    if guard is not None:
        guard.start()
        reason = guard.check(
            plan_caps_bytes(caps)
            if guard.memory_budget_bytes is not None
            else None
        )
        if reason is not None:
            res = degraded_empty(n_qnodes, backend, reason)
            res.stats.final_caps = _final_caps(caps)
            return res
    res = first()
    retries = 0
    while adaptive and not res.complete and res.stats.degrade_reason is None:
        if retries >= policy.max_retries:
            mark_degraded(res, DegradeReason.OVERFLOW_CEILING)
            break
        reason = guard.check() if guard is not None else None
        grown = None
        if reason is None:
            grown, reason = policy.next_caps(caps, guard)
        if reason is not None:
            mark_degraded(res, reason)
            break
        policy.sleep(retries)
        caps = grown
        retries += 1
        res = escalate(caps)
    res.stats.retries = retries
    res.stats.final_caps = _final_caps(caps)
    return res


@contextlib.contextmanager
def stage(stats: MatchStats, name: str):
    """Accumulate wall time of a named execution stage into
    ``stats.stage_times`` (re-entrant across blocks: times add up).

    This is host wall time. CUDA work runs asynchronously, so on the card a
    stage's time covers its device work only when the stage ends in a host
    sync; the engine notes which of its stages do."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.stage_times[name] = (
            stats.stage_times.get(name, 0.0) + time.perf_counter() - t0
        )
