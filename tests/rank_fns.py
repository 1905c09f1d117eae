"""Rank functions for `repro_torch.launch.mesh.spawn_ranks` in the tests of
the one-shard-a-process path (``tests/test_torch_ranks.py``).

Each runs in a spawned gloo rank and returns plain numpy results; it
imports neither ``jax`` nor a test module, so a rank starts with torch and
the port alone. The inputs are made from seeds with numpy
(`collective_inputs`), so the parent makes the same ones for the JAX side.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.analysis.staticcheck import engines
from repro_torch.api import GraphSession
from repro_torch.core import collectives, join as join_lib, rank_collectives as rc
from repro_torch.core.dist import _schemas, ring_radii_for
from repro_torch.core.result import MatchStats
from repro_torch.graphstore.cluster_graph import ClusterGraphIndex
from repro_torch.kernels import cuda
from repro_torch.launch import gpipe, make_host_mesh, mesh_axis_size
from repro_torch.optim import EFState, compressed_psum
from repro_torch.optim.compression import quantize
from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy

GPIPE_SHAPE = dict(M=4, mb=8, d=16)
EF_STEPS = 50


def collective_inputs(S: int, seed: int) -> dict:
    """Every rank's inputs, stacked on dim 0: packed words with bit 31 set
    in some, flags, fetch tables with load rows, gradients with EF errors,
    and the GPipe stages."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-(2**31), 2**31, (S, 3, 37), dtype=np.int64).astype(np.int32)
    words &= rng.integers(-(2**31), 2**31, words.shape, dtype=np.int64).astype(np.int32)
    words[:, 0, 0] = np.int32(-(2**31))  # the sign bit alone
    cap, w = 9, 3
    m = GPIPE_SHAPE
    return {
        "words": words,
        "flags": rng.random((S, 5)) < 0.2,
        "cols": rng.integers(0, 1000, (S, cap, w)).astype(np.int32),
        "valid": rng.random((S, cap)) < 0.6,
        "load": rng.random((S, S)) < 0.5,
        "grad": (rng.normal(size=(S, 5, 33)) * rng.uniform(0.1, 3.0, (S, 1, 1))).astype(np.float32),
        "ef": (rng.normal(size=(S, 5, 33)) * 1e-3).astype(np.float32),
        "ws": (rng.normal(size=(S, m["d"], m["d"])) * 0.3).astype(np.float32),
        "x": rng.normal(size=(m["M"], m["mb"], m["d"])).astype(np.float32),
        "const_grad": (rng.normal(size=(256,)) * 1e-3).astype(np.float32),
    }


def stage_fn(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w)


def collectives_rank(rank: int, sizes: tuple, seed: int) -> dict:
    """On the group of the first S ranks of the world for each S of
    ``sizes`` (the last is the world's mesh): every rank collective,
    `compressed_psum` and the EF constant-gradient stream, on this rank's
    slice of ``collective_inputs(S, seed + S)``; then `gpipe` over the
    ``pod`` dim of (world/S, S) meshes for S = 2 and 4. Returns
    ``{S: results}`` for the groups this rank is in, and ``("gpipe", S)``."""
    world = torch.distributed.get_world_size()
    groups = {S: torch.distributed.new_group(list(range(S))) for S in sizes[:-1]}
    host = make_host_mesh(world)
    groups[world] = host.get_group()
    out = {S: _collectives(rank, S, seed + S, groups[S]) for S in sizes if rank < S}
    out["axis_sizes"] = [mesh_axis_size(host, "data")]
    for S in (2, 4):
        mesh = init_device_mesh("cpu", (world // S, S), mesh_dim_names=("data", "pod"))
        out["axis_sizes"] += [mesh_axis_size(mesh, "pod"), mesh_axis_size(mesh, ("data", "pod")),
                              mesh_axis_size(mesh, ("pod", "model"))]
        inp = collective_inputs(S, seed + S)
        pipe = gpipe(stage_fn, mesh, axis="pod")
        out["gpipe", S] = pipe(torch.from_numpy(inp["ws"][rank % S]),
                               torch.from_numpy(inp["x"])).numpy()
    out["sources_built"] = cuda.sources_built
    return out


def _collectives(rank: int, S: int, seed: int, group) -> dict:
    inp = {k: torch.from_numpy(v) for k, v in collective_inputs(S, seed).items()}
    out = {}
    out["or"] = rc.or_allreduce(inp["words"][rank], group).numpy()
    out["pmax"] = rc.pmax(inp["words"][rank], group).numpy()
    out["pmax_bool"] = rc.pmax(inp["flags"][rank], group).numpy()
    out["any"] = rc.bool_allreduce_any(inp["flags"][rank], group).numpy()
    args = (inp["cols"][rank], inp["valid"][rank], inp["load"][rank], group)
    out["gather"] = [t.numpy() for t in rc.fetch_load_set(*args)]
    for r in (1, 2):
        out[f"ring{r}"] = [t.numpy() for t in rc.fetch_load_set(*args, ring_radius=r)]
    g, e = inp["grad"][rank], EFState(inp["ef"][rank])
    red, ef = compressed_psum(g, e, group)
    x = g + e.error
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    scale = rc.pmax(scale, group)
    out["psum"] = (red.numpy(), ef.error.numpy(), quantize(x, scale).numpy())
    total = torch.zeros(256)
    err = EFState(torch.zeros(256))
    for _ in range(EF_STEPS):
        step, err = compressed_psum(inp["const_grad"], err, group)
        total += step
    out["ef_total"] = total.numpy()
    return out


def _plain(t):
    return t.detach().cpu().numpy()


def _record_or(calls):
    def hook(name, operands, result, info):
        if name == "or_allreduce":
            calls.append(_plain(result))
    return hook


def engine_rank(rank: int, cases: list, caps: dict, chaos_case) -> dict:
    """On a mesh of the world's ranks, for each ``(key, pg, queries)`` of
    ``cases``: each query's exploration tables, OR'd contributions and
    join outputs (both fetches), its rows (``run``, truncated, non-adaptive)
    and stream pages; then the early-stopped stream's block joins, and the
    chaos cases on ``chaos_case``'s ``(pg, queries)``."""
    S = torch.distributed.get_world_size()
    mesh = make_host_mesh(S)
    out = {"rank": rank, "cgi_builds": 0}
    real_build = ClusterGraphIndex.build

    def counted_build(pg):
        out["cgi_builds"] += 1
        return real_build(pg)

    ClusterGraphIndex.build = staticmethod(counted_build)
    for key, pg, queries in cases:
        session = GraphSession.open(pg, mesh=mesh, device="cpu", kernels="torch")
        eng = session.engine
        out["cgi", key] = {k: v.copy() for k, v in eng.cgi.pair_index.items()}
        per_q = []
        for q in queries:
            plan = eng.plan(q, root_cap=1, **caps)
            ors = []
            collectives.recorder = _record_or(ors)
            try:
                stats = MatchStats(backend="sharded", n_shards=S)
                all_cols, all_valids, _ = eng._explore(plan, stats)
            finally:
                collectives.recorder = None
            rec = {"cols": [_plain(c) for c in all_cols],
                   "valids": [_plain(v) for v in all_valids],
                   "ors": ors, "stwig_rows": list(stats.stwig_rows), "joins": {}}
            if len(plan.specs) > 1:
                load, rows = eng._load_masks(q, plan)
                schemas = _schemas(plan)
                order = join_lib.select_join_order(list(schemas), stats.stwig_rows)
                for ring in (False, True):
                    radii = ring_radii_for(load) if ring else None
                    if ring and radii is None:
                        continue
                    fetched = eng._fetch(all_cols, all_valids, rows, plan.head, radii)
                    acc, _ = eng._join_local(all_cols, all_valids, fetched, schemas, order, plan)
                    rec["joins"][ring] = (_plain(acc.cols), _plain(acc.valid))
            res = {}
            for ring in (False, True):
                compiled = session.compile(q, max_matches=0, **caps)
                full = compiled.run(use_ring=ring)
                first = compiled.run(max_matches=5, use_ring=ring)
                once = compiled.run(adaptive=False, use_ring=ring)
                pages = list(compiled.stream(page_size=7, block_rows=16, use_ring=ring))
                res[ring] = {
                    "rows": full.rows, "complete": full.complete,
                    "n_shards": full.stats.n_shards, "health": full.stats.shard_health,
                    "first": first.rows, "once": once.rows, "once_complete": once.complete,
                    "pages": [(p.rows, p.complete) for p in pages],
                }
            rec["runs"] = res
            per_q.append(rec)
        out[key] = per_q
    # an early-stopped stream joins fewer blocks, on every rank alike
    key, pg, queries = cases[0]
    session = GraphSession.open(pg, mesh=mesh, device="cpu", kernels="torch")
    compiled = session.compile(queries[0], max_matches=0, **caps)
    before = session.engine.join_block_calls
    full = list(compiled.stream(page_size=4, block_rows=4))
    n_full = session.engine.join_block_calls - before
    before = session.engine.join_block_calls
    early = list(compiled.stream(page_size=4, block_rows=4, max_matches=1))
    out["stream_stop"] = (n_full, full[0].stats.join_blocks if full else 0,
                          session.engine.join_block_calls - before,
                          sum(p.n_rows for p in early))
    out["chaos"] = chaos_rank(mesh, *chaos_case)
    out["probe"] = engines.rank_probe(rank, "torch", "cpu")
    out["refusals"] = refusals(mesh, pg, queries[0], caps)
    out["sources_built"] = cuda.sources_built
    return out


def refusals(mesh, pg, q, caps) -> list[str]:
    """What a mesh session refuses, as ``ExceptionType: message``: a
    partition of another shard count, ``serve``, and deadlines."""
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.partition import PartitionedGraph

    got = []
    session = GraphSession.open(pg, mesh=mesh, device="cpu", kernels="torch")
    g = generators.rmat(50, 100, 4, seed=0)
    attempts = [
        lambda: GraphSession.open(PartitionedGraph.build(g, pg.n_shards + 1), mesh=mesh,
                                  device="cpu"),
        session.serve,
        lambda: session.run(q, deadline_s=60.0, **caps),
        lambda: list(session.stream(q, deadline_s=60.0, **caps)),
    ]
    for fn in attempts:
        try:
            fn()
            got.append("no error")
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            got.append(f"{type(e).__name__}: {e}")
    return got


CHAOS_FAULTS = {
    "dead": dict(dead_shard=1),
    "heals": dict(dead_shard=2, dead_heals_after=2),
    "truncated": dict(truncate_shard=3, truncate_keep_frac=0.5),
    "slow": dict(slow_shard=0, slow_delay_s=0.005),
}


def chaos_rank(mesh, pg, queries, caps, device="cpu", kernels="torch") -> dict:
    """Each of `CHAOS_FAULTS` on each query, a fresh injector a query (as
    the chaos phases open a session a query): rows, completeness, reason,
    shard health and fetch retries."""
    out = {}
    for what, kw in CHAOS_FAULTS.items():
        res = []
        for q in queries:
            s = GraphSession.open(pg, mesh=mesh, device=device, kernels=kernels,
                                  chaos=ChaosInjector(ChaosConfig(seed=0, **kw)))
            r = s.run(q, max_matches=0, adaptive=False, retry_policy=RetryPolicy(), **caps)
            res.append((r.rows, r.complete, r.stats.degrade_reason, r.stats.shard_health,
                        r.stats.fetch_retries))
        out[what] = res
    return out


def gloo_cuda_rank(rank: int) -> dict:
    """On two gloo ranks sharing ``cuda:0``: the collectives the staging
    rule leaves on the card (`all_reduce` by SUM and MAX, `all_gather`) on
    CUDA tensors, then an `exchange` of words with bit 31 set and of a bool
    mask under the rule. Returns the results on the host, the device the
    exchange returned on, and the bytes staged."""
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    group, peer = torch.distributed.group.WORLD, 1 - rank
    t = torch.tensor([rank + 1, -(rank + 1)], dtype=torch.int32, device=dev)
    out = {"sum": rc.psum(t, group).cpu().numpy(), "max": rc.pmax(t, group).cpu().numpy(),
           "gather": rc.all_gather(torch.full((3, 2), rank - 2**31, dtype=torch.int32,
                                              device=dev), group).cpu().numpy(),
           "staged_p2p": rc._staged("p2p", group, t)}
    rc.reset_staged_bytes()
    words = torch.tensor([-(2**31), -(2**31) + rank, 2**31 - 1], dtype=torch.int32, device=dev)
    mask = torch.tensor([rank == 0, rank == 1, True], device=dev)
    got = rc.exchange([(words, peer), (mask, peer)], [(words, peer), (mask, peer)], group, "probe")
    out["exchange"] = [(g.device.type, g.dtype, g.cpu().numpy()) for g in got]
    out["staged"] = dict(rc.staged_bytes)
    return out


def failing_rank(rank: int, bad: int) -> int:
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank
