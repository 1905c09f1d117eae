"""Distributed, parallel subgraph matching (paper §4.3), its S shards stacked
on one device.

The JAX package (``src/repro/core/dist.py``) runs each shard of a
``PartitionedGraph`` on its own device of a mesh: it explores STwigs over
the shard's own roots, ORs its binding contributions into the replicated
bitsets, fetches remote STwig tables only from the shards in its load set
(Theorem 4), and joins locally. The head STwig is never fetched (Theorem
5), so the per-shard results are disjoint and their union needs no
deduplication.

Here one card holds every shard. The shard graphs are S `ShardGraph`s on
that device, each round's tables are stacked with the shard as dim 0, and
each collective is an operation over that dimension
(`repro_torch.core.collectives`). Every per-shard step the JAX body runs
once per shard, the engine runs once per shard in a loop, on the same
`Kernels`: a round launches the matcher's kernels S times.

Host syncs: each exploration round reads its root count, row count and
overflow flag in one copy (``explore`` ends synced); the fetch only
enqueues work (its device time lands in ``join``), the one-shot join reads
the overflow flags (``join`` ends synced), and materialization copies rows
to the host. On the streaming path a block's ``join`` stage only enqueues;
its device time lands in that block's ``materialize``.

Two join paths share that structure: a one-shot join of every shard's
whole tables (`_match_once`), and the streaming pair (`_stream_setup`,
`_stream_block`): exploration and the fetch run once per query, and each
block joins head rows ``[lo, lo+B)`` of every shard.

Faults (`repro_torch.runtime.chaos`) enter at the host-side fetch
boundary, `_chaos_gate`, before the fetch: a dead shard's fetch is retried
with the `RetryPolicy`'s backoff and then masked out of the stacked
validity (`_mask_shard`), so the result is the surviving shards' rows,
typed ``"shard-fault"``.

.. deprecated::
    Constructing `DistributedMatcher` directly is deprecated — open a
    `repro_torch.api.GraphSession` with ``backend="sharded"`` instead.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import join as join_lib
from repro_torch.core.backend import Kernels, resolve_kernels
from repro_torch.core.cache import ExecutableCache
from repro_torch.core.collectives import fetch_load_set, or_allreduce, pmax
from repro_torch.core.deprecation import warn_direct_construction
from repro_torch.core.engine import CachedSteps
from repro_torch.core.match import Bindings, ShardGraph, apply_binding_update
from repro_torch.core.plan import QueryPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.result import MatchResult, MatchStats
from repro_torch.graphstore.cluster_graph import ClusterGraphIndex
from repro_torch.graphstore.partition import PartitionedGraph
from repro_torch.runtime.chaos import ShardFaultError
from repro_torch.runtime.resilience import DegradeReason, QueryGuard, RetryPolicy, stage

__all__ = ["DistributedMatcher", "ShardedSteps"]


def _schemas(plan: QueryPlan) -> tuple[join_lib.Schema, ...]:
    return tuple(
        join_lib.Schema(qnodes=s.qnodes, qlabels=(s.root_label,) + s.child_labels)
        for s in plan.specs
    )


def _table(cols: torch.Tensor, valid: torch.Tensor) -> join_lib.JoinTable:
    """A join input as the reference's join step makes it: the exact count
    of its valid rows, no overflow of its own."""
    return join_lib.JoinTable(
        cols=cols,
        valid=valid,
        n_rows=valid.sum(dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.bool, device=valid.device),
    )


def ring_radii_for(load: np.ndarray) -> tuple[int, ...] | None:
    """If every STwig's load set fits in a ring window (shards within
    ring-distance r of each other), return per-STwig radii; else None.
    Hash partitions have complete cluster graphs → None (all-gather is
    optimal there); locality-aware partitions get bounded rings."""
    T, S, _ = load.shape
    radii = []
    for t in range(T):
        ks, js = np.nonzero(load[t])
        d = np.minimum((ks - js) % S, (js - ks) % S)
        r = int(d.max()) if len(d) else 0
        if r > (S - 1) // 2:
            return None
        radii.append(r)
    # beneficial only if strictly smaller than a full gather
    return tuple(radii) if max(radii) < (S - 1) // 2 or S <= 4 else None


def load_sets(cgi: ClusterGraphIndex, query: QueryGraph, plan: QueryPlan) -> np.ndarray:
    """Load sets (Theorem 4) on the host: ``(T, S, S)``, entry (t, k, j)
    true when shard k loads STwig t's results from shard j."""
    return cgi.load_sets(query.label_pairs(), plan.head_dists)


@dataclasses.dataclass
class ChaosOutcome:
    """What the fetch boundary decided: each shard's health, the fetch
    retries spent, the dead shard whose rows are dropped, and the truncated
    shard with its keep fraction."""

    health: dict
    fetch_retries: int = 0
    dead: int | None = None
    truncated: tuple[int, float] | None = None

    @property
    def fault(self) -> bool:
        return self.dead is not None or self.truncated is not None

    def apply_stats(self, stats: MatchStats) -> None:
        stats.shard_health = dict(self.health)
        stats.fetch_retries += self.fetch_retries


def chaos_outcome(chaos, policy: RetryPolicy, n_shards: int) -> ChaosOutcome:
    """Consult the chaos injector (``None``: every shard ok) at the fetch
    boundary: the slow shard's delay is slept here, a dead shard's fetch is
    retried with the policy's jittered backoff and then given up on, and a
    truncated payload is reported with its keep fraction."""
    out = ChaosOutcome(health={k: "ok" for k in range(n_shards)})
    if chaos is None:
        return out
    ev = chaos.fetch_delay()
    if ev is not None:
        k, d = ev
        time.sleep(d)
        out.health[k] = "slow"
    attempt = 0
    while True:
        try:
            chaos.try_fetch()
            if attempt > 0:
                out.health[chaos.config.dead_shard] = "recovered"
            break
        except ShardFaultError as e:
            if attempt >= policy.fetch_retries:
                out.dead = e.shard
                out.health[e.shard] = "dead"
                break
            policy.sleep(attempt, policy.fetch_backoff_s)
            attempt += 1
            out.fetch_retries += 1
    tr = chaos.truncation()
    if tr is not None:
        k, keep = tr
        out.truncated = (k, keep)
        if out.health.get(k) == "ok":
            out.health[k] = "truncated"
    return out


class ShardedSteps(CachedSteps):
    """What the paper's two engines share: `DistributedMatcher` (every shard
    stacked on one device) and `repro_torch.core.rank_dist.RankMatcher`
    (one shard a process). Each engine gives its own `_explore`,
    `_load_masks`, `_chaos_gate` and `_fetch`; the sequence that runs them
    (`_setup`) and the result's bookkeeping (`_result`) are here, once."""

    backend = "sharded"
    ring_radii_for = staticmethod(ring_radii_for)

    def match(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        *,
        adaptive: bool = True,
        max_retries: int = 6,
        use_ring: bool = False,
        guard: QueryGuard | None = None,
        retry_policy: RetryPolicy | None = None,
        **kw,
    ) -> MatchResult:
        """Adaptive matching for direct (deprecated) engine use, with the
        local engine's escalation semantics (`SubgraphMatcher.match`);
        ``retry_policy`` also paces the fetch-recovery retries when a chaos
        injector is attached, and ``use_ring`` takes the ring fetch where
        the load sets allow it."""
        return self._adaptive_match(
            query, plan, adaptive=adaptive, max_retries=max_retries, guard=guard,
            retry_policy=retry_policy, engine_kw={"use_ring": use_ring}, kw=kw)

    def _setup(self, query, plan, use_ring, retry_policy, stats, head_first: bool):
        """Exploration, load sets, the join order, the fetch gate and the
        fetch: what the one-shot and the streaming paths share. A streamed
        query cuts its blocks on the head table, so with ``head_first`` the
        join order starts there (disjointness across shards comes from head
        locality). Returns (all_cols, all_valids, fetched, schemas, order,
        overflow, fault); the stats carry the join order and, after a
        fault, the shard-fault reason."""
        with stage(stats, "explore"):
            all_cols, all_valids, overflow = self._explore(plan, stats)
        load, load_masks = self._load_masks(query, plan)
        schemas = _schemas(plan)
        order = tuple(join_lib.select_join_order(
            list(schemas), stats.stwig_rows, **({"start": plan.head} if head_first else {})))
        ring_radii = self.ring_radii_for(load) if use_ring else None
        with stage(stats, "fetch"):
            all_valids, fault = self._chaos_gate(
                stats, retry_policy or RetryPolicy(), all_valids, plan.head)
            fetched = self._fetch(all_cols, all_valids, load_masks, plan.head, ring_radii)
        if self.chaos is not None and self.chaos.forced_overflow():
            overflow = True
        if fault:
            stats.degrade_reason = DegradeReason.SHARD_FAULT.value
        stats.join_order = [schemas[i].qnodes for i in order]
        return all_cols, all_valids, fetched, schemas, order, overflow, fault

    def _result(self, t0: float, stats: MatchStats, rows_old: np.ndarray, overflow: bool,
                fault: bool) -> MatchResult:
        """The one-shot path's `MatchResult`: complete unless a table
        overflowed or a shard faulted."""
        stats.time_s = time.perf_counter() - t0
        stats.cache_hits = self.cache.hits
        stats.cache_misses = self.cache.misses
        return MatchResult(
            rows=rows_old,
            n_matches=int(rows_old.shape[0]),
            complete=not (overflow or fault),
            stats=stats,
        )


class DistributedMatcher(ShardedSteps):
    """The multi-machine engine, its ``pg.n_shards`` shards on one device."""

    def __init__(
        self,
        pg: PartitionedGraph,
        *,
        device,
        cache: ExecutableCache | None = None,
        kernels: "str | Kernels | None" = None,
        chaos=None,
    ):
        warn_direct_construction("DistributedMatcher")
        self.pg = pg
        self.device = torch.device(device)
        self.cache = cache if cache is not None else ExecutableCache()
        # the kernel backend every per-shard step draws from; reassignable —
        # cached steps are keyed by (static spec, kernels.name)
        self.kernels = resolve_kernels(kernels, self.device)
        # optional seeded fault injector (repro_torch.runtime.chaos),
        # consulted at the host-side fetch and block boundaries
        self.chaos = chaos
        if chaos is not None:
            self.kernels = chaos.wrap_kernels(self.kernels)
        self.cgi = ClusterGraphIndex.build(pg)
        # cumulative block joins run on the streaming path (one a block, for
        # every shard); lets callers assert early-stopped streams skip work
        self.join_block_calls = 0
        all_labels = torch.as_tensor(pg.all_labels).to(self.device)
        self.graphs = [
            ShardGraph.from_partition(pg, k, self.device, all_labels=all_labels)
            for k in range(pg.n_shards)
        ]

    @property
    def n_shards(self) -> int:
        return self.pg.n_shards

    # ------------------------------------------------------ execution phases
    def _explore(self, plan: QueryPlan, stats: MatchStats):
        """STwig exploration (Algorithm 2 order) on every shard.

        Each round runs MatchSTwig on every shard with the same bindings;
        the contributions are OR-reduced over the shards, the root count is
        the max over them and the overflow any. Rounds continue until the
        most loaded shard's roots are covered, so every shard runs every
        round. Returns stacked per-shard tables: ``all_cols[i]`` has shape
        (S, rounds_i * rows_cap_i, width_i), the shard leading."""
        bind = Bindings.fresh(plan.n_qnodes, self.pg.n_total + 1, self.device)
        overflow = False
        all_cols, all_valids = [], []
        for spec in plan.specs:
            fn = self._match_fn(spec)
            round_cols, round_valids = [], []
            contrib = None
            n_rows_tot = 0
            r = 0
            while True:
                outs = [fn(g, bind, round_idx=r) for g in self.graphs]
                round_cols.append(torch.stack([t.cols for t, _ in outs]))
                round_valids.append(torch.stack([t.valid for t, _ in outs]))
                cw = or_allreduce(torch.stack([c.words for _, c in outs]))
                contrib = cw if contrib is None else contrib | cw
                n_roots_max, n_rows, ovf = torch.stack([
                    pmax(torch.stack([t.n_roots for t, _ in outs])).to(torch.int64),
                    torch.stack([t.n_rows for t, _ in outs]).sum(dtype=torch.int64),
                    pmax(torch.stack([t.overflow for t, _ in outs])).to(torch.int64),
                ]).tolist()
                n_rows_tot += n_rows
                overflow |= bool(ovf)
                r += 1
                if r * spec.root_cap >= n_roots_max:
                    break
            bind = apply_binding_update(bind, spec, contrib)
            # concatenate rounds along the per-shard row axis
            all_cols.append(torch.cat(round_cols, dim=1))
            all_valids.append(torch.cat(round_valids, dim=1))
            stats.stwig_rows.append(n_rows_tot)
            # the max over shards: the shard that drives the round count
            stats.stwig_roots.append(n_roots_max)
            stats.rounds.append(r)
        return all_cols, all_valids, overflow

    def _load_masks(self, query: QueryGraph, plan: QueryPlan):
        """Load sets (Theorem 4): ``(T, S, S)`` on the host, entry (t, k, j)
        true when shard k loads STwig t's results from shard j; and the
        shard-major ``(S, T, S)`` copy on the device."""
        load = load_sets(self.cgi, query, plan)
        masks = torch.as_tensor(np.ascontiguousarray(np.transpose(load, (1, 0, 2))))
        return load, masks.to(self.device)

    def _fetch(self, all_cols, all_valids, load_masks, head: int, ring_radii):
        """Every non-head table fetched by each shard from its load set:
        ``{t: (cols, valid (S, n))}``. The head table is never fetched
        (Theorem 5)."""
        return {
            t: fetch_load_set(
                all_cols[t], all_valids[t], load_masks[:, t],
                ring_radius=None if ring_radii is None else ring_radii[t],
            )
            for t in range(len(all_cols))
            if t != head
        }

    def _shard_tables(self, k: int, head: int, head_table, fetched) -> list:
        """Shard ``k``'s join inputs: its own head table, and the fetched
        ones (shared columns after an all-gather, its own after a ring)."""
        tables = []
        for t in range(len(fetched) + 1):
            if t == head:
                tables.append(head_table)
                continue
            cols, valid = fetched[t]
            tables.append(_table(cols if cols.dim() == 2 else cols[k], valid[k]))
        return tables

    def _join_shard(self, k, all_cols, all_valids, fetched, schemas, order, plan):
        """The one-shot join on shard ``k``: the chain in ``order`` over its
        local head table and its fetched tables."""
        head = _table(all_cols[plan.head][k], all_valids[plan.head][k])
        tables = self._shard_tables(k, plan.head, head, fetched)
        return self._join_chain(
            tables[order[0]], schemas[order[0]], tables, schemas, order[1:], plan
        )

    def _union_rows(self, cols, valid, schema, max_matches: int) -> np.ndarray:
        """The disjoint per-shard results ``cols (S, cap, w)``, ``valid (S,
        cap)`` → host rows of ORIGINAL ids in query-node column order,
        shard-major (`CachedSteps._materialize` of the flattened stack)."""
        S, cap, w = cols.shape
        return self._materialize(
            cols.reshape(S * cap, w), valid.reshape(S * cap), schema, max_matches
        )

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
            accs = [
                self._join_shard(k, all_cols, all_valids, fetched, schemas, order, plan)
                for k in range(self.n_shards)
            ]
            schema = accs[0][1]
            cols = torch.stack([a.cols for a, _ in accs])
            valid = torch.stack([a.valid for a, _ in accs])
            overflow |= bool(torch.stack([a.overflow for a, _ in accs]).any())
        with stage(stats, "materialize"):
            rows_old = self._union_rows(cols, valid, schema, plan.max_matches)
        return self._result(t0, stats, rows_old, overflow, fault)

    # -------------------------------------------------- streaming interface
    def _stream_setup(
        self,
        query: QueryGraph,
        plan: QueryPlan | None = None,
        use_ring: bool = False,
        retry_policy: RetryPolicy | None = None,
        **kw,
    ) -> "_ShardedStreamState":
        """The run-once half of a streamed query: exploration, load sets and
        the fetch of every non-head table happen here, and the fetched
        tables stay on the device for every block. A shard fault at the
        fetch degrades every page of the stream: the stats carry the
        shard-fault reason and `OpenStream.blocks` marks pages ``complete=False``."""
        plan = plan or self.plan(query, **kw)
        stats = MatchStats(backend="sharded", n_shards=self.n_shards)
        all_cols, all_valids, fetched, schemas, order, overflow, _ = self._setup(
            query, plan, use_ring, retry_policy, stats, head_first=True)
        head_valid = all_valids[plan.head]
        S, cap = head_valid.shape
        # one host copy of the head validity: blocks where no shard has a
        # valid head row are skipped without any device call
        head_any = self.kernels.mask_to_host(head_valid.reshape(S * cap))
        return _ShardedStreamState(
            plan=plan,
            stats=stats,
            schemas=schemas,
            order=order,
            head_cols=all_cols[plan.head],
            head_valid=head_valid,
            head_valid_any=head_any.reshape(S, cap).any(axis=0),
            fetched=fetched,
            explore_overflow=overflow,
            cap=cap,
        )

    def _stream_block(
        self, state: "_ShardedStreamState", lo: int, block_rows: int
    ) -> tuple[np.ndarray, bool]:
        """One pipelined block: join head rows ``[lo, lo+block_rows)`` of
        every shard against the fetched tables and union the (disjoint)
        per-shard results."""
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
            accs = []
            for k in range(self.n_shards):
                blk = join_lib.block_table(
                    _table(state.head_cols[k], state.head_valid[k]), lo, block_rows
                )
                tables = self._shard_tables(k, head, blk, state.fetched)
                accs.append(self._join_chain(
                    blk, state.schemas[head], tables, state.schemas, state.order[1:], plan
                ))
        with stage(state.stats, "materialize"):
            rows = self._union_rows(
                torch.stack([a.cols for a, _ in accs]),
                torch.stack([a.valid for a, _ in accs]),
                accs[0][1],
                max_matches=0,
            )
        return rows, bool(torch.stack([a.overflow for a, _ in accs]).any())

    # -------------------------------------------------------- fault handling
    def _chaos_gate(
        self, stats: MatchStats, policy: RetryPolicy, all_valids, head_pos: int
    ):
        """The host-side fetch boundary: consult the chaos injector (when
        attached, `chaos_outcome`) and degrade to the surviving shards' rows
        by masking the faulty shard's stacked validity. Returns
        (all_valids, faulted). Runs before the fetch: a memory cloud loses a
        shard at fetch time."""
        out = chaos_outcome(self.chaos, policy, self.n_shards)
        out.apply_stats(stats)
        if out.dead is not None:
            all_valids = self._mask_shard(all_valids, out.dead)
        if out.truncated is not None:
            k, keep = out.truncated
            all_valids = self._mask_shard(all_valids, k, head_pos=head_pos, keep_frac=keep)
        return all_valids, out.fault

    @staticmethod
    def _mask_shard(
        all_valids,
        shard: int,
        head_pos: int | None = None,
        keep_frac: float | None = None,
    ) -> list:
        """Invalidate (all of, or the tail of) one shard's rows in the
        stacked ``(S, cap)`` validity tables, on the device and into new
        tensors, so results built from the masked tables are a correct
        subset of the true row set, never a wrong one. With ``keep_frac``
        (the truncated-payload fault) the head table is left intact: it is
        never fetched (Theorem 5), so a transfer can't truncate it."""
        out = []
        for i, v in enumerate(all_valids):
            if keep_frac is not None and i == head_pos:
                out.append(v)
                continue
            v = v.clone()
            if keep_frac is None:
                v[shard] = False
            else:
                v[shard, int(keep_frac * v.shape[1]):] = False
            out.append(v)
        return out


@dataclasses.dataclass(eq=False)
class _ShardedStreamState:
    """Per-query stream state for the sharded engine: exploration and the
    load-set fetch ran once; ``head_cols``/``head_valid`` are the stacked
    ``(S, cap, w)`` local head tables and ``fetched`` the fetched non-head
    tables, all on the device. `DistributedMatcher._stream_block` joins head
    rows ``[lo, lo+B)`` per call."""

    plan: QueryPlan
    stats: MatchStats
    schemas: tuple
    order: tuple[int, ...]
    head_cols: torch.Tensor
    head_valid: torch.Tensor
    head_valid_any: np.ndarray  # (cap,) host bool: any shard valid at row i
    fetched: dict
    explore_overflow: bool
    cap: int  # per-shard head-table row capacity (the block loop bound)
