"""Distributed, parallel subgraph matching (paper §4.3) with one shard a
process: the port of ``src/repro/core/dist.py`` over `torch.distributed`.

Each rank of a process group plays one machine of the paper's memory
cloud, as each device of the reference's mesh does: it holds its own shard
graph only (`ShardGraph.from_partition` of its rank, with the replicated
global labels), explores STwigs over its own roots, ORs its binding
contributions into the replicated bitsets (`rank_collectives.or_allreduce`),
fetches the remote STwig tables of its load set (Theorem 4) and joins
locally. The head STwig is never fetched (Theorem 5), so the per-rank
results are disjoint, and their union is gathered in rank order onto every
rank: every rank returns the same `MatchResult`.

The host side is the stacked engine's (`repro_torch.core.dist`): the
sequence of a query's phases (`ShardedSteps`), its schemas, load sets,
ring radii and chaos decisions are shared, not copied; this engine gives
its own explore, load-mask, chaos-gate, fetch, join and union steps. A
round reads the all-reduced root count, so every rank runs every round;
the load sets come from the host `ClusterGraphIndex`, which rank 0 builds
and broadcasts, and of which each rank takes its row.

**SPMD.** Every rank must make the same calls in the same order — the
collectives of one rank wait for the others', as ``shard_map`` imposes it
on the reference. So every rank runs the same queries with the same
plans, and consumes a stream alike: a consumer that stops on one rank
only leaves the others waiting in the next block's gather. The pages are
the same on every rank, so a consumer that decides from the pages stops
every rank at the same page. A deadline could trip on one rank only, so
the rank engine refuses a deadline guard. Faults are decided on rank 0
(`chaos_outcome`) and broadcast, so the ranks cannot diverge; attach the
same injector config on every rank, or none.

.. deprecated::
    Constructing `RankMatcher` directly is deprecated — open a
    `repro_torch.api.GraphSession` with ``mesh=``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import join as join_lib
from repro_torch.core import rank_collectives as rc
from repro_torch.core.backend import Kernels, resolve_kernels
from repro_torch.core.cache import ExecutableCache
from repro_torch.core.deprecation import warn_direct_construction
from repro_torch.core.dist import (
    DistributedMatcher,
    ShardedSteps,
    _table,
    chaos_outcome,
    load_sets,
)
from repro_torch.core.match import Bindings, ShardGraph, apply_binding_update
from repro_torch.core.plan import QueryPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchResult, MatchStats
from repro_torch.graphstore.cluster_graph import ClusterGraphIndex
from repro_torch.runtime.resilience import RetryPolicy, stage

__all__ = ["RankMatcher"]


class RankMatcher(ShardedSteps):
    """The multi-machine engine, one shard in this process: shard ``r`` of
    ``pg`` on rank ``r`` of the 1-D ``mesh`` (``pg.n_shards`` must be the
    mesh's size)."""

    spmd = True  # every rank must make the same calls (see the module docstring)

    def __init__(
        self,
        pg,
        *,
        mesh,
        device,
        cache: ExecutableCache | None = None,
        kernels: "str | Kernels | None" = None,
        chaos=None,
    ):
        warn_direct_construction("RankMatcher")
        self.group = mesh.get_group()
        self.rank = dist.get_rank(self.group)
        self.n_shards = dist.get_world_size(self.group)
        if pg.n_shards != self.n_shards:
            raise ValueError(
                f"a partition of {pg.n_shards} shards on a mesh of {self.n_shards} ranks: "
                "one shard a rank"
            )
        self.pg = pg
        self.mesh = mesh
        self.device = torch.device(device)
        self.cache = cache if cache is not None else ExecutableCache()
        self.kernels = resolve_kernels(kernels, self.device)
        self.chaos = chaos
        if chaos is not None:
            self.kernels = chaos.wrap_kernels(self.kernels)
        # the index scans every shard's edges: rank 0 builds it, the others
        # receive it
        box = [ClusterGraphIndex.build(pg) if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0),
                                   group=self.group)
        self.cgi = box[0]
        # cumulative block joins on the streaming path (one a block on
        # every rank); lets callers assert early-stopped streams skip work
        self.join_block_calls = 0
        all_labels = torch.as_tensor(pg.all_labels).to(self.device)
        self.g = ShardGraph.from_partition(pg, self.rank, self.device, all_labels=all_labels)

    def _adaptive_match(self, query, plan, *, guard, **kw) -> MatchResult:
        # every rank escalates alike: completeness is all-reduced, and the
        # memory budget reads the caps only; a deadline reads each rank's clock
        if guard is not None and guard.deadline_s is not None:
            raise ValueError("a deadline may trip on one rank only: the rank engine refuses it")
        return super()._adaptive_match(query, plan, guard=guard, **kw)

    # ------------------------------------------------------ execution phases
    def _explore(self, plan: QueryPlan, stats: MatchStats):
        """STwig exploration (Algorithm 2 order) on this rank's shard.

        Each round runs MatchSTwig with the replicated bindings; the
        contributions are OR-reduced over the ranks, the root count is the
        max over them and the overflow any. Rounds continue until the most
        loaded shard's roots are covered, so every rank runs every round.
        Returns this shard's tables: ``all_cols[i]`` has shape
        (rounds_i * rows_cap_i, width_i)."""
        bind = Bindings.fresh(plan.n_qnodes, self.pg.n_total + 1, self.device)
        overflow = False
        all_cols, all_valids = [], []
        for spec in plan.specs:
            fn = self._match_fn(spec)
            round_cols, round_valids, n_rows = [], [], []
            contrib = None
            r = 0
            while True:
                table, c = fn(self.g, bind, round_idx=r)
                round_cols.append(table.cols)
                round_valids.append(table.valid)
                n_rows.append(table.n_rows)
                cw = rc.or_allreduce(c.words, self.group)
                contrib = cw if contrib is None else contrib | cw
                n_roots_max, ovf = torch.stack([
                    rc.pmax(table.n_roots, self.group).to(torch.int64),
                    rc.bool_allreduce_any(table.overflow, self.group).to(torch.int64),
                ]).tolist()
                overflow |= bool(ovf)
                r += 1
                if r * spec.root_cap >= n_roots_max:
                    break
            bind = apply_binding_update(bind, spec, contrib)
            all_cols.append(torch.cat(round_cols))
            all_valids.append(torch.cat(round_valids))
            # the rows over every rank and round, as the stacked engine counts
            stats.stwig_rows.append(int(rc.psum(
                torch.stack(n_rows).sum(dtype=torch.int64), self.group)))
            stats.stwig_roots.append(n_roots_max)
            stats.rounds.append(r)
        return all_cols, all_valids, overflow

    def _load_masks(self, query: QueryGraph, plan: QueryPlan):
        """The host load sets ``(T, S, S)`` and this rank's rows of them on
        the device, ``(T, S)``: entry (t, j) true when this rank loads
        STwig t's results from rank j."""
        load = load_sets(self.cgi, query, plan)
        row = torch.as_tensor(np.ascontiguousarray(load[:, self.rank]))
        return load, row.to(self.device)

    def _fetch(self, all_cols, all_valids, load_rows, head: int, ring_radii):
        """Every non-head table fetched from this rank's load set:
        ``{t: (cols, valid)}``. The head table is never fetched (Theorem
        5)."""
        return {
            t: rc.fetch_load_set(
                all_cols[t], all_valids[t], load_rows[t], self.group,
                ring_radius=None if ring_radii is None else ring_radii[t],
            )
            for t in range(len(all_cols))
            if t != head
        }

    @staticmethod
    def _tables(head: int, head_table, fetched) -> list:
        """The join inputs: this rank's own head table and the fetched
        ones."""
        return [head_table if t == head else _table(*fetched[t])
                for t in range(len(fetched) + 1)]

    def _join_local(self, all_cols, all_valids, fetched, schemas, order, plan):
        """The one-shot join on this rank: the chain in ``order`` over its
        head table and its fetched tables."""
        tables = self._tables(
            plan.head, _table(all_cols[plan.head], all_valids[plan.head]), fetched)
        return self._join_chain(
            tables[order[0]], schemas[order[0]], tables, schemas, order[1:], plan
        )

    def _union_rows(self, cols, valid, schema, max_matches: int) -> np.ndarray:
        """This rank's disjoint result ``cols (cap, w)``, ``valid (cap,)``
        and every other rank's → the same host rows of ORIGINAL ids on
        every rank, in query-node order, rank-major; ``max_matches`` keeps
        the first rows of the union, rank 0's first."""
        keep = np.nonzero(self.kernels.mask_to_host(valid))[0]
        rows = cols[torch.as_tensor(keep, device=cols.device)]
        parts = rc.gather_rows(rows, self.group, limit=max_matches)
        return self._old_ids(torch.cat(parts).cpu().numpy(), schema)

    def _chaos_gate(self, stats: MatchStats, policy: RetryPolicy, all_valids, head_pos: int):
        """The fetch boundary: rank 0 consults the chaos injector
        (`chaos_outcome`) and broadcasts what it decided; a dead or
        truncated shard's validity is masked on its own rank before the
        fetch, as `DistributedMatcher._mask_shard` masks its slice of the
        stack. Returns (all_valids, faulted)."""
        if self.chaos is None:
            out = chaos_outcome(None, policy, self.n_shards)
        else:
            box = [chaos_outcome(self.chaos, policy, self.n_shards) if self.rank == 0 else None]
            dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0),
                                       group=self.group)
            out = box[0]
        out.apply_stats(stats)
        if out.dead == self.rank:
            all_valids = self._mask_own(all_valids)
        if out.truncated is not None and out.truncated[0] == self.rank:
            all_valids = self._mask_own(all_valids, head_pos, out.truncated[1])
        return all_valids, out.fault

    @staticmethod
    def _mask_own(all_valids, head_pos: int | None = None, keep_frac: float | None = None):
        stacked = DistributedMatcher._mask_shard(
            [v[None] for v in all_valids], 0, head_pos=head_pos, keep_frac=keep_frac)
        return [v[0] for v in stacked]

    def _match_once(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        use_ring: bool = False,
        retry_policy: RetryPolicy | None = None,
        **kw,
    ) -> MatchResult:
        t0 = time.perf_counter()
        plan = plan or self.plan(query, **kw)
        stats = MatchStats(backend="sharded", n_shards=self.n_shards)
        all_cols, all_valids, fetched, schemas, order, overflow, fault = self._setup(
            query, plan, use_ring, retry_policy, stats, head_first=False)
        with stage(stats, "join"):
            acc, schema = self._join_local(all_cols, all_valids, fetched, schemas, order, plan)
            overflow |= bool(rc.bool_allreduce_any(acc.overflow, self.group))
        with stage(stats, "materialize"):
            rows_old = self._union_rows(acc.cols, acc.valid, schema, plan.max_matches)
        return self._result(t0, stats, rows_old, overflow, fault)

    # -------------------------------------------------- streaming interface
    def _stream_setup(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        use_ring: bool = False,
        retry_policy: RetryPolicy | None = None,
        **kw,
    ) -> "_RankStreamState":
        """The run-once half of a streamed query: exploration, load sets
        and the fetch of every non-head table, kept on the device for every
        block. Blocks are cut on the head table, so the join order starts
        there; a block no rank has a valid head row in is skipped on every
        rank without a device call."""
        plan = plan or self.plan(query, **kw)
        stats = MatchStats(backend="sharded", n_shards=self.n_shards)
        all_cols, all_valids, fetched, schemas, order, overflow, _ = self._setup(
            query, plan, use_ring, retry_policy, stats, head_first=True)
        head_valid = all_valids[plan.head]
        head_any = rc.bool_allreduce_any(head_valid, self.group)
        return _RankStreamState(
            plan=plan,
            stats=stats,
            schemas=schemas,
            order=order,
            head_cols=all_cols[plan.head],
            head_valid=head_valid,
            head_valid_any=self.kernels.mask_to_host(head_any),
            fetched=fetched,
            explore_overflow=overflow,
            cap=int(head_valid.shape[0]),
        )

    def _stream_block(
        self, state: "_RankStreamState", lo: int, block_rows: int
    ) -> tuple[np.ndarray, bool]:
        """One pipelined block: join head rows ``[lo, lo+block_rows)`` of
        this rank's head table against the fetched tables, and gather every
        rank's (disjoint) rows."""
        if not state.head_valid_any[lo : lo + block_rows].any():
            return np.zeros((0, state.plan.n_qnodes), np.int64), False
        if self.chaos is not None:
            d = self.chaos.block_delay()
            if d > 0:
                time.sleep(d)
        self.join_block_calls += 1
        state.stats.join_blocks += 1
        plan, head = state.plan, state.plan.head
        with stage(state.stats, "join"):
            blk = join_lib.block_table(_table(state.head_cols, state.head_valid), lo, block_rows)
            tables = self._tables(head, blk, state.fetched)
            acc, schema = self._join_chain(
                blk, state.schemas[head], tables, state.schemas, state.order[1:], plan)
        with stage(state.stats, "materialize"):
            rows = self._union_rows(acc.cols, acc.valid, schema, max_matches=0)
            overflow = bool(rc.bool_allreduce_any(acc.overflow, self.group))
        return rows, overflow


@dataclasses.dataclass(eq=False)
class _RankStreamState:
    """Per-query stream state of the rank engine: exploration and the
    load-set fetch ran once; ``head_cols``/``head_valid`` are this rank's
    ``(cap, w)`` head table and ``fetched`` its fetched non-head tables,
    all on the device. `RankMatcher._stream_block` joins head rows
    ``[lo, lo+B)`` a call."""

    plan: QueryPlan
    stats: MatchStats
    schemas: tuple
    order: tuple[int, ...]
    head_cols: torch.Tensor
    head_valid: torch.Tensor
    head_valid_any: np.ndarray  # (cap,) host bool: any rank valid at row i
    fetched: dict
    explore_overflow: bool
    cap: int  # the head table's row capacity, the same on every rank
