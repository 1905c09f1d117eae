"""Typed query results: `MatchResult`, structured `MatchStats`, `MatchPage`.

The engines used to report execution details in an untyped ``stats`` dict;
these dataclasses make the schema explicit. The fields are the JAX
package's, so results of the two packages compare field by field.
``MatchStats`` still supports ``stats["key"]`` access as a deprecation
bridge — it emits `DeprecationWarning` on every use.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.deprecation import warn_dict_stats_access


@dataclasses.dataclass
class MatchStats:
    """Execution statistics for one query run.

    Per-STwig lists are indexed in exploration (Algorithm 2) order.
    ``cache_hits``/``cache_misses`` are the owning executable cache's
    cumulative counters at the end of the run (0 when no cache is attached).
    """

    backend: str = "local"             # "local" | "sharded"
    time_s: float = 0.0
    retries: int = 0                   # adaptive capacity-growth re-runs
    # why a partial result is partial — a `repro_torch.runtime.resilience
    # .DegradeReason` value string ("deadline" | "budget" |
    # "overflow-ceiling" | "shard-fault"); None for complete results and
    # for plain first-K truncation (adaptive=False is semantics, not
    # degradation)
    degrade_reason: str | None = None
    # wall seconds per execution stage ("explore", "fetch", "join",
    # "materialize"), accumulated across blocks on the streaming path
    stage_times: dict[str, float] = dataclasses.field(default_factory=dict)
    # per-shard health after chaos/fault handling: shard -> "ok" | "slow" |
    # "dead" | "recovered" | "truncated" (sharded backend only)
    shard_health: dict[int, str] = dataclasses.field(default_factory=dict)
    # the grow-able capacities the final (possibly escalated) plan ran at
    final_caps: dict[str, int] = dataclasses.field(default_factory=dict)
    # fetch attempts beyond the first while recovering from shard faults
    fetch_retries: int = 0
    # block-parameterized join steps this query executed on the streaming
    # path (0 on one-shot runs); per-query — the engines' cumulative
    # `join_block_calls` counters sum these across all streams. The query
    # server's scheduler accounts its join quanta with this field.
    join_blocks: int = 0
    rounds: list[int] = dataclasses.field(default_factory=list)
    stwig_rows: list[int] = dataclasses.field(default_factory=list)
    # matching roots per STwig; both backends populate it (sharded reports
    # the max over shards — the shard that drives the round count)
    stwig_roots: list[int] = dataclasses.field(default_factory=list)
    join_order: list[tuple[int, ...]] = dataclasses.field(default_factory=list)
    n_join_rows: int = 0
    n_shards: int = 1
    cache_hits: int = 0
    cache_misses: int = 0

    # -------- deprecation bridge: the old dict-style access keeps working,
    # but warns — `tests/test_api.py` pins the warning
    def __getitem__(self, key: str):
        warn_dict_stats_access(key)
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default=None):
        warn_dict_stats_access(key)
        return getattr(self, key, default)


@dataclasses.dataclass
class MatchResult:
    rows: np.ndarray          # (n_matches, n_qnodes) ORIGINAL node ids
    n_matches: int
    complete: bool            # False if any capacity overflowed (partial set)
    stats: MatchStats

    @property
    def degrade_reason(self) -> str | None:
        """Typed reason this result is partial (None when complete or when
        partial is first-K semantics, not degradation)."""
        return self.stats.degrade_reason


@dataclasses.dataclass
class MatchPage:
    """One page of a streaming (first-K, pipelined) run."""

    rows: np.ndarray          # (n_rows, n_qnodes) ORIGINAL node ids
    index: int                # 0-based page number
    complete: bool            # False if this page's block overflowed a cap
    # the query-level stats object, shared by every page of one stream
    # (retries, final caps, stage times, shard health accumulate there)
    stats: "MatchStats | None" = None

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])
