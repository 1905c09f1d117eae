"""`GraphSession`: one facade over the local and sharded engines.

The session is the unit of engine state: it owns the partitioned graph on
its device, the engine, and the keyed `ExecutableCache` shared by every
query compiled in it.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from repro_torch.api.compiled import CompiledQuery
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.core.cache import ExecutableCache
from repro_torch.core.deprecation import facade_construction
from repro_torch.core.dist import DistributedMatcher
from repro_torch.core.engine import SubgraphMatcher
from repro_torch.core.plan import QueryPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.rank_dist import RankMatcher
from repro_torch.core.result import MatchResult
from repro_torch.graphstore.csr import Graph
from repro_torch.graphstore.partition import PartitionedGraph
from repro_torch.runtime.server import QueryServer, ServerConfig

BACKENDS = ("auto", "local", "sharded")


class GraphSession:
    """A query session over one graph. Use `GraphSession.open`, not the
    constructor. Usable as a context manager; `close()` drops the executable
    cache."""

    def __init__(self, pg: PartitionedGraph, engine, backend: str, cache: ExecutableCache):
        self.pg = pg
        self.backend = backend
        self.cache = cache
        self._engine = engine

    # ------------------------------------------------------------- factory
    @classmethod
    def open(
        cls,
        graph_or_pg: Graph | PartitionedGraph,
        *,
        backend: str = "auto",
        kernels: "str | Kernels" = "auto",
        device=None,
        n_shards: int | None = None,
        mesh=None,
        partition_mode: str = "hash",
        cache_size: int = 512,
        chaos=None,
    ) -> "GraphSession":
        """Open a session on ``device`` (``None``: the card; it raises if
        there is none — there is no fallback to the CPU).

        ``backend="auto"`` picks ``"sharded"`` when a ``mesh`` is given, for
        a partition of more than one shard, or for a raw `Graph` with
        ``n_shards > 1``, else ``"local"``. A raw `Graph` is partitioned here (``partition_mode``
        ``"hash"`` or ``"range"``): into 1 shard for the local backend, into
        ``n_shards`` for the sharded one, which needs it for a raw `Graph`.
        The local backend refuses a partition of more than one shard.

        The sharded backend runs every shard on the one device, stacked
        (`repro_torch.core.dist`), so unlike the JAX package it does not
        ask for a device a shard: any S fits that the device's memory holds.

        ``mesh`` — a 1-D `torch.distributed.device_mesh.DeviceMesh`
        (`repro_torch.launch.mesh.make_host_mesh`) spanning more than one
        process — runs the paper's engine with one shard a process
        (`repro_torch.core.rank_dist.RankMatcher`): every rank of the mesh
        opens its session on the same partition, whose ``n_shards`` must be
        the mesh's size, and holds its own shard only. ``device=None`` is
        then the card ``cuda:(rank % device_count)`` — ``cuda:0`` for every
        rank on a one-card machine. Every rank must make the same calls
        (``compile``, ``run``, ``stream``, ``run_batch``) in the same
        order; each returns the same rows on every rank.

        ``kernels`` selects the kernel backend every dense inner step draws
        from — ``"auto"`` (the CUDA kernels on a CUDA device, the plain
        PyTorch versions elsewhere), ``"cuda"``, ``"torch"``, or a `Kernels`
        instance (`repro_torch.core.backend`). The choice keys every cached
        step, so sessions can compare kernel backends.

        ``chaos`` attaches a seeded fault injector
        (`repro_torch.runtime.chaos.ChaosInjector`) to the engine: injected
        faults (slow/dead shard, truncated fetch, forced overflow) are
        handled by the resilience layer and surface as typed partial
        results. The injector wraps the kernel backend under a distinct
        name (``"chaos(cuda)"`` on the card), so chaos steps never share
        cache entries with clean ones.
        """
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        dev = resolve_device(device)
        ranks = mesh.size() if mesh is not None else 1
        if ranks > 1 and device is None:
            dev = torch.device("cuda", mesh.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        kern = resolve_kernels(kernels, dev)
        if backend == "auto":
            if mesh is not None:
                backend = "sharded"
            elif isinstance(graph_or_pg, PartitionedGraph):
                backend = "sharded" if graph_or_pg.n_shards > 1 else "local"
            elif n_shards is not None and n_shards > 1:
                backend = "sharded"
            else:
                backend = "local"
        if isinstance(graph_or_pg, PartitionedGraph):
            pg = graph_or_pg
        else:
            if backend == "local":
                shards = 1
            elif n_shards is None and mesh is not None:
                shards = ranks
            elif n_shards is None:
                raise ValueError(
                    "the sharded backend needs n_shards= to partition a raw Graph"
                )
            else:
                shards = n_shards
            pg = PartitionedGraph.build(graph_or_pg, shards, mode=partition_mode)
        if mesh is not None and pg.n_shards != ranks:
            raise ValueError(
                f"a partition of {pg.n_shards} shards on a mesh of {ranks} ranks: the "
                "partition needs one shard a rank"
            )
        cache = ExecutableCache(maxsize=cache_size)
        with facade_construction():
            if backend == "local":
                if pg.n_shards != 1:
                    raise ValueError(
                        f"the local backend needs a 1-shard partition, got "
                        f"{pg.n_shards} shards (use backend='sharded' or re-partition)"
                    )
                engine = SubgraphMatcher(
                    pg, device=dev, cache=cache, kernels=kern, chaos=chaos
                )
            elif ranks > 1:
                engine = RankMatcher(
                    pg, mesh=mesh, device=dev, cache=cache, kernels=kern, chaos=chaos
                )
            else:
                engine = DistributedMatcher(
                    pg, device=dev, cache=cache, kernels=kern, chaos=chaos
                )
        return cls(pg, engine, backend, cache)

    # ----------------------------------------------------------- query API
    def compile(self, query: QueryGraph, **caps) -> CompiledQuery:
        """Plan ``query`` (Algorithm 2 + head selection + static capacities)
        without running it. ``caps`` are `make_plan` keywords (``child_cap``,
        ``join_rows_cap``, ``max_matches``, ...)."""
        plan = self._engine.plan(query, **caps)
        return CompiledQuery(session=self, query=query, plan=plan, caps=caps)

    def run(
        self,
        query: QueryGraph,
        *,
        adaptive: bool = True,
        deadline_s: float | None = None,
        memory_budget_bytes: float | None = None,
        retry_policy=None,
        **caps,
    ) -> MatchResult:
        """One-shot convenience: ``compile(query).run()``."""
        return self.compile(query, **caps).run(
            adaptive=adaptive,
            deadline_s=deadline_s,
            memory_budget_bytes=memory_budget_bytes,
            retry_policy=retry_policy,
        )

    def stream(
        self,
        query: QueryGraph,
        *,
        page_size: int = 256,
        max_matches: int | None = None,
        block_rows: int | None = None,
        deadline_s: float | None = None,
        engine_kw: dict | None = None,
        **caps,
    ):
        """One-shot convenience: ``compile(query).stream(...)``;
        ``engine_kw`` carries engine options (e.g. ``{"use_ring": True}``
        on the sharded backend), ``caps`` go to `compile`."""
        return self.compile(query, **caps).stream(
            page_size=page_size,
            max_matches=max_matches,
            block_rows=block_rows,
            deadline_s=deadline_s,
            **(engine_kw or {}),
        )

    def serve(self, **cfg) -> QueryServer:
        """Open a continuous-batching `QueryServer` over this session.
        ``cfg`` keywords are `ServerConfig` fields::

            server = session.serve(max_inflight=8, deadline_s=0.5)
            outcomes = server.serve(queries)       # synchronous batch
            with session.serve() as srv:           # background scheduler
                t = srv.submit(q)
                out = t.result()

        Concurrent queries with identical plan shapes share cached steps
        through this session's `ExecutableCache`; the server interleaves
        their block joins on the one device and enforces per-query
        deadlines and budgets, so overload degrades per query, never
        globally. Not on a mesh of ranks yet (``ROADMAP.md``, Queue 1, the
        ``torch.distributed`` path's next slice: ``serve`` on a mesh)."""
        if getattr(self._engine, "spmd", False):
            raise NotImplementedError(
                "serve on a mesh of ranks is not ported yet (ROADMAP.md, Queue 1: the "
                "torch.distributed path's next slice, 'serve on a mesh')"
            )
        return QueryServer(self, ServerConfig(**cfg))

    def run_batch(
        self,
        queries: Sequence[QueryGraph] | Iterable[QueryGraph],
        *,
        adaptive: bool = True,
        **caps,
    ) -> list[MatchResult]:
        """Run a workload: every query is planned up front, then run against
        the shared cache, so queries with identical STwig specs and join
        schemas reuse each other's steps. Results come back in input order
        and equal sequential `run` calls."""
        compiled = [self.compile(q, **caps) for q in queries]
        return [cq.run(adaptive=adaptive) for cq in compiled]

    # ------------------------------------------------------------ plumbing
    @property
    def engine(self):
        """The wrapped engine (for low-level access; prefer the facade)."""
        return self._engine

    @property
    def device(self) -> torch.device:
        return self._engine.device

    @property
    def kernels(self) -> Kernels:
        """The kernel backend the engine's dense steps draw from."""
        return self._engine.kernels

    def set_kernels(self, kernels: "str | Kernels") -> "GraphSession":
        """Switch the kernel backend for subsequent runs. Safe mid-session:
        steps are keyed by (static spec, kernels name)."""
        self._engine.kernels = resolve_kernels(kernels, self.device)
        return self

    def replan(self, query: QueryGraph, **caps) -> QueryPlan:
        return self._engine.plan(query, **caps)

    def close(self) -> None:
        self.cache.clear()

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"GraphSession(backend={self.backend!r}, device={str(self.device)!r}, "
            f"kernels={self.kernels.name!r}, n_shards={self.pg.n_shards}, "
            f"cache={len(self.cache)} steps)"
        )
