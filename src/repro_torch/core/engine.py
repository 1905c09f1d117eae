"""Single-shard subgraph matching engine (the per-machine executor).

Orchestration is host-side (the paper's query proxy), as in the JAX
package's ``src/repro/core/engine.py``; every dense step is a PyTorch
function on the engine's device, keyed by its static plan spec and kernel
backend in a session-owned `ExecutableCache`.

Host syncs, which also bound what the stage times measure on the card:
each exploration round reads its root count (``explore`` ends synced), the
one-shot join reads the final overflow flag (``join`` ends synced), and
materialization copies rows to the host (``materialize`` ends synced). On
the streaming path a block's ``join`` stage only enqueues work; its device
time lands in that block's ``materialize``.

.. deprecated::
    Constructing `SubgraphMatcher` directly is deprecated — open a
    `repro_torch.api.GraphSession` instead.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import join as join_lib
from repro_torch.core.backend import Kernels, resolve_kernels
from repro_torch.core.cache import ExecutableCache
from repro_torch.core.deprecation import warn_direct_construction
from repro_torch.core.match import (
    Bindings,
    ShardGraph,
    STwigTable,
    apply_binding_update,
    match_stwig_shard,
)
from repro_torch.core.plan import QueryPlan, STwigSpec, caps_from_plan, make_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchPage, MatchResult, MatchStats
from repro_torch.core.stream import stream_blocks
from repro_torch.graphstore.partition import PartitionedGraph
from repro_torch.runtime.resilience import QueryGuard, RetryPolicy, adaptive_run, stage

__all__ = ["CachedSteps", "SubgraphMatcher"]


def _concat_tables(tables: list[STwigTable]) -> join_lib.JoinTable:
    """Concatenate per-round tables into one join input. The concatenated
    capacity is ``n_rounds * spec.rows_cap``: rounds exist so one round's
    block never overflows, and the join's own ``out_cap`` bounds
    everything downstream."""
    return join_lib.JoinTable(
        cols=torch.cat([t.cols for t in tables], dim=0),
        valid=torch.cat([t.valid for t in tables], dim=0),
        n_rows=torch.stack([t.n_rows for t in tables]).sum(dtype=torch.int32),
        overflow=torch.stack([t.overflow for t in tables]).any(),
    )


@dataclasses.dataclass(eq=False)
class _LocalStreamState:
    """Per-query stream state: exploration ran once, tables/schemas/order
    are fixed, and blocks of the first table in join order are joined
    lazily by `SubgraphMatcher._stream_block`."""

    plan: QueryPlan
    stats: MatchStats
    tables: list
    schemas: list
    order: tuple[int, ...]
    explore_overflow: bool
    cap: int  # row capacity of the blocked table (the block loop bound)
    valid_host: np.ndarray  # (cap,) host bool mask of the blocked table


class CachedSteps:
    """What both engines share: planning, the direct entry points, and the
    MatchSTwig and join steps keyed by static spec and kernel backend in
    the session's cache. A subclass sets ``pg``, ``cache``, ``kernels`` and
    ``backend``."""

    pg: PartitionedGraph
    cache: ExecutableCache
    kernels: Kernels
    backend: str

    def plan(self, query: QueryGraph, **kw) -> QueryPlan:
        return make_plan(query, self.pg.freq, **kw)

    def _adaptive_match(
        self, query: QueryGraph, plan: QueryPlan | None, *, adaptive: bool,
        max_retries: int, guard: QueryGuard | None,
        retry_policy: RetryPolicy | None, engine_kw: dict, kw: dict,
    ) -> MatchResult:
        """The direct ``match`` of either engine and the facade's
        ``CompiledQuery.run``: `adaptive_run` over ``_match_once``,
        escalating from ``plan``'s caps (or ``kw``'s plan of ``query``) with
        re-made plans."""
        policy = retry_policy or RetryPolicy(max_retries=max_retries)
        plan0 = plan if plan is not None else self.plan(query, **kw)
        return adaptive_run(
            lambda: self._match_once(query, plan0, retry_policy=policy, **engine_kw),
            lambda caps: self._match_once(
                query, None, retry_policy=policy, **engine_kw, **caps),
            caps_from_plan(plan0, kw),
            n_qnodes=query.n_nodes,
            backend=self.backend,
            policy=policy,
            guard=guard,
            adaptive=adaptive,
        )

    def match_stream(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        *,
        block_rows: int = 1024,
        **kw,
    ) -> Iterator[MatchPage]:
        """Pipelined first-K execution (paper §6.1): the shared streaming
        driver (`repro_torch.core.stream.stream_blocks`), kept for direct
        (deprecated) engine use. ``kw`` holds the driver's ``guard``, the
        engine's options (``use_ring``) and plan caps."""
        yield from stream_blocks(self, query, plan, block_rows=block_rows, **kw)

    def _match_fn(self, spec: STwigSpec):
        kern = self.kernels
        return self.cache.get(
            ("match", spec, kern.name),
            lambda: functools.partial(match_stwig_shard, spec=spec, kernels=kern),
        )

    def _join_fn(
        self, schema_a, schema_b, out_cap: int, dup_cap: int,
        a_cap: int, b_cap: int,
    ):
        """Returns (join fn, merged schema). ``a_cap``/``b_cap`` are the
        operand capacities; they shape the step, so they belong to its key."""
        kern = self.kernels

        def build():
            merged, _ = schema_a.merge(schema_b)
            fn = functools.partial(
                join_lib.sort_merge_join,
                schema_a=schema_a,
                schema_b=schema_b,
                out_cap=out_cap,
                dup_cap=dup_cap,
                kernels=kern,
            )
            return fn, merged

        return self.cache.get(
            ("join", schema_a, schema_b, out_cap, dup_cap, a_cap, b_cap,
             kern.name),
            build,
        )

    def _join_chain(
        self, acc: join_lib.JoinTable, acc_schema: join_lib.Schema,
        tables: list, schemas: list, rest, plan: QueryPlan,
    ) -> tuple[join_lib.JoinTable, join_lib.Schema]:
        """Join ``acc`` with ``tables[idx]`` for each ``idx`` of ``rest``,
        in order."""
        for idx in rest:
            fn, merged = self._join_fn(
                acc_schema, schemas[idx], plan.join_rows_cap, plan.join_dup_cap,
                int(acc.cols.shape[0]), int(tables[idx].cols.shape[0]),
            )
            acc, acc_schema = fn(acc, tables[idx])[0], merged
        return acc, acc_schema

    def _materialize(
        self, cols: torch.Tensor, valid: torch.Tensor, schema: join_lib.Schema,
        max_matches: int,
    ) -> np.ndarray:
        """Device rows ``cols (n, w)``, ``valid (n,)`` → host rows of ORIGINAL
        ids in query-node order. The validity mask crosses as packed words;
        then only the rows kept are gathered on the device and copied.
        Truncated to ``max_matches`` before the columns are permuted and the
        ids mapped; the ghost id ``n_total`` maps to -1."""
        keep = np.nonzero(self.kernels.mask_to_host(valid))[0]
        if max_matches and keep.shape[0] > max_matches:
            keep = keep[:max_matches]
        rows_new = cols[torch.as_tensor(keep, device=cols.device)].cpu().numpy()
        return self._old_ids(rows_new, schema)

    def _old_ids(self, rows_new: np.ndarray, schema: join_lib.Schema) -> np.ndarray:
        """Host rows of new ids in ``schema``'s column order → ORIGINAL ids
        in query-node order; the ghost id ``n_total`` maps to -1."""
        perm = np.argsort(np.asarray(schema.qnodes))
        rows_new = rows_new[:, perm]
        rows_old = np.where(
            rows_new < self.pg.n_total,
            self.pg.new_to_old[np.minimum(rows_new, self.pg.n_total - 1)],
            -1,
        )
        return rows_old.astype(np.int64)


class SubgraphMatcher(CachedSteps):
    """Single-device matcher over a 1-shard partitioned graph."""

    backend = "local"

    def __init__(
        self,
        pg: PartitionedGraph,
        shard: int = 0,
        *,
        device,
        cache: ExecutableCache | None = None,
        kernels: "str | Kernels | None" = None,
        chaos=None,
    ):
        warn_direct_construction("SubgraphMatcher")
        if not 0 <= shard < pg.n_shards:
            raise ValueError(f"shard {shard} out of range for {pg.n_shards} shards")
        self.pg = pg
        self.device = torch.device(device)
        self.cache = cache if cache is not None else ExecutableCache()
        # the kernel backend every dense step draws from; reassignable at
        # any time — cached steps are keyed by (static spec, kernels.name)
        self.kernels = resolve_kernels(kernels, self.device)
        # optional seeded fault injector (repro_torch.runtime.chaos). The
        # local engine has no fetch, so only the per-block delay and forced
        # overflow apply; the wrapped kernels' distinct name keeps chaos
        # steps out of clean cache entries
        self.chaos = chaos
        if chaos is not None:
            self.kernels = chaos.wrap_kernels(self.kernels)
        # cumulative per-block join chains run on the streaming path; lets
        # callers assert early-stopped streams skip work
        self.join_block_calls = 0
        self.g = ShardGraph.from_partition(pg, shard, self.device)

    def match(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        *,
        adaptive: bool = True,
        max_retries: int = 6,
        guard: QueryGuard | None = None,
        retry_policy: RetryPolicy | None = None,
        **kw,
    ) -> MatchResult:
        """Match with adaptive capacity growth, for direct (deprecated)
        engine use: if a block capacity overflows (paper §4.2), the plan is
        re-made with doubled capacities and the query re-runs, starting
        from ``plan``'s caps when one is given. ``adaptive=False`` returns
        the first, possibly partial, result (``complete=False``): the
        paper's first-K semantics. ``guard`` bounds the query by deadline
        or memory budget at the retry boundaries; ``retry_policy`` adds
        backoff and the byte ceiling on cap growth
        (`repro_torch.runtime.resilience.adaptive_run`)."""
        return self._adaptive_match(
            query, plan, adaptive=adaptive, max_retries=max_retries, guard=guard,
            retry_policy=retry_policy, engine_kw={}, kw=kw)

    # -------------------------------------------------- streaming interface
    def _stream_setup(
        self, query: QueryGraph, plan: QueryPlan | None = None, **kw
    ) -> _LocalStreamState:
        """Run exploration once and pick the blocked (first-in-join-order)
        table; everything the per-block join step needs is returned as one
        reusable state object."""
        plan = plan or self.plan(query, **kw)
        stats = MatchStats(backend="local")
        with stage(stats, "explore"):
            tables, schemas, explore_overflow = self._explore(plan, stats)
        if self.chaos is not None and self.chaos.forced_overflow():
            explore_overflow = True
        order = tuple(join_lib.select_join_order(schemas, stats.stwig_rows))
        # probe-side compaction: every block join re-probes the non-blocked
        # tables, and probe cost scales with their capacity, not their row
        # count — shrink them once here
        for idx in order[1:]:
            tables[idx] = join_lib.compact_table(
                tables[idx], self.kernels.mask_to_host(tables[idx].valid)
            )
        first = tables[order[0]]
        return _LocalStreamState(
            plan=plan,
            stats=stats,
            tables=tables,
            schemas=schemas,
            order=order,
            explore_overflow=explore_overflow,
            cap=int(first.cols.shape[0]),
            # one host copy of the blocked table's validity: empty blocks are
            # then skipped without any per-block device round-trip
            valid_host=self.kernels.mask_to_host(first.valid),
        )

    def _stream_block(
        self, state: _LocalStreamState, lo: int, block_rows: int
    ) -> tuple[np.ndarray, bool]:
        """Join rows ``[lo, lo+block_rows)`` of the blocked table through the
        join chain and materialize the block's matches."""
        if not state.valid_host[lo : lo + block_rows].any():
            return np.zeros((0, state.plan.n_qnodes), np.int64), False
        if self.chaos is not None:
            d = self.chaos.block_delay()
            if d > 0:
                time.sleep(d)
        first = state.tables[state.order[0]]
        blk = join_lib.block_table(first, lo, block_rows)
        self.join_block_calls += 1
        state.stats.join_blocks += 1
        with stage(state.stats, "join"):
            acc, acc_schema = self._join_chain(
                blk, state.schemas[state.order[0]], state.tables, state.schemas,
                state.order[1:], state.plan,
            )
        with stage(state.stats, "materialize"):
            rows = self._materialize(acc.cols, acc.valid, acc_schema, max_matches=0)
        return rows, bool(acc.overflow)

    # ------------------------------------------------------ execution phases
    def _explore(
        self, plan: QueryPlan, stats: MatchStats
    ) -> tuple[list[join_lib.JoinTable], list[join_lib.Schema], bool]:
        """STwig exploration in Algorithm-2 order → per-STwig join inputs."""
        n_bits = self.pg.n_total + 1
        bind = Bindings.fresh(plan.n_qnodes, n_bits, self.device)
        tables: list[join_lib.JoinTable] = []
        schemas: list[join_lib.Schema] = []
        overflow = False
        for spec in plan.specs:
            fn = self._match_fn(spec)
            round_tables: list[STwigTable] = []
            contrib = None
            r = 0
            while True:
                table, c = fn(self.g, bind, round_idx=r)
                round_tables.append(table)
                contrib = c.words if contrib is None else contrib | c.words
                n_roots = int(table.n_roots)
                r += 1
                if r * spec.root_cap >= n_roots:
                    break
            bind = apply_binding_update(bind, spec, contrib)
            jt = _concat_tables(round_tables)
            tables.append(jt)
            schemas.append(
                join_lib.Schema(
                    qnodes=spec.qnodes,
                    qlabels=(spec.root_label,) + spec.child_labels,
                )
            )
            stats.stwig_rows.append(int(jt.n_rows))
            stats.stwig_roots.append(int(round_tables[0].n_roots))
            stats.rounds.append(r)
            overflow |= bool(jt.overflow)
        return tables, schemas, overflow

    def _match_once(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        retry_policy=None,  # accepted so the facade drives engines uniformly
        **kw,
    ) -> MatchResult:
        t0 = time.perf_counter()
        plan = plan or self.plan(query, **kw)
        stats = MatchStats(backend="local")
        with stage(stats, "explore"):
            tables, schemas, overflow = self._explore(plan, stats)
        if self.chaos is not None and self.chaos.forced_overflow():
            overflow = True

        # ---- join phase ----------------------------------------------------
        with stage(stats, "join"):
            order = join_lib.select_join_order(schemas, stats.stwig_rows)
            acc, acc_schema = self._join_chain(
                tables[order[0]], schemas[order[0]], tables, schemas, order[1:], plan
            )
            overflow |= bool(acc.overflow)

        # ---- materialize (original ids, query-node column order) ----------
        with stage(stats, "materialize"):
            rows_old = self._materialize(acc.cols, acc.valid, acc_schema, plan.max_matches)
        stats.join_order = [tuple(schemas[i].qnodes) for i in order]
        stats.time_s = time.perf_counter() - t0
        stats.n_join_rows = int(acc.n_rows)
        stats.cache_hits = self.cache.hits
        stats.cache_misses = self.cache.misses
        return MatchResult(
            rows=rows_old,
            n_matches=int(rows_old.shape[0]),
            complete=not overflow,
            stats=stats,
        )
