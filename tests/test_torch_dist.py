"""The port's sharded engine on the CPU against the JAX package, in process:
the cluster-graph index and its load sets, ``ring_of_cliques``, the stacked
collectives (against the JAX functions run under ``jax.vmap`` with a named
axis), every shard's exploration tables and the OR'd contributions (against
``repro.core.match.match_stwig_shard`` called shard by shard), every
shard's joins (against ``repro.core.join.sort_merge_join`` on the same
fetched tables), and the session end to end: rows equal to the JAX local
engine's and the networkx oracle's, streams, truncation, routing. S = 4
and 8 on graphs of at most 2,000 nodes; ``kernels="torch"`` against
``"jnp"``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("networkx")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import nx_oracle  # noqa: E402
from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.core import join as jjoin  # noqa: E402
from repro.core import match as jmatch  # noqa: E402
from repro.core.backend import get_kernels  # noqa: E402
from repro.graphstore import PartitionedGraph as JPartitionedGraph  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.graphstore.cluster_graph import ClusterGraphIndex as JClusterGraphIndex  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.configs import stwig  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.core import match as tmatch  # noqa: E402
from repro_torch.core.dist import DistributedMatcher  # noqa: E402
from repro_torch.core.result import MatchStats  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.cluster_graph import ClusterGraphIndex  # noqa: E402
from repro_torch.graphstore.partition import PartitionedGraph  # noqa: E402
from repro_torch.workloads import dfs_query, path_query  # noqa: E402

JNP = get_kernels("jnp")
# (generator, args, seed): an R-MAT and a ring of cliques, both ≤ 2,000 nodes
GRAPHS = {"rmat": ("rmat", (1500, 5000, 24), 1), "ring": ("ring_of_cliques", (40, 6, 4), 2),
          # labels² · S² past the index's bitmap: its keys are sorted instead
          "wide": ("rmat", (1500, 5000, 200), 1)}
# small caps keep the JAX side short; some still overflow (escalation runs)
CAPS = dict(child_cap=6, emission_budget=256, join_rows_cap=512, join_dup_cap=8)


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


def as_np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def equal(port, ref, msg=""):
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(a, as_np(ref), err_msg=msg)


@functools.lru_cache(maxsize=None)
def graph(name):
    kind, args, seed = GRAPHS[name]
    return getattr(jgen, kind)(*args, seed=seed), getattr(generators, kind)(*args, seed=seed)


@functools.lru_cache(maxsize=None)
def partition(name, S, mode):
    g_ref, g_port = graph(name)
    return JPartitionedGraph.build(g_ref, S, mode=mode), PartitionedGraph.build(g_port, S, mode=mode)


@functools.lru_cache(maxsize=None)
def queries(name, n=2, seed=0):
    """A DFS query, then a 4-node path (≥ 2 STwigs: joins and fetches)."""
    _, g = graph(name)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        q = dfs_query(g, rng, 4) if len(out) < n - 1 else path_query(g, rng, 4)
        if q is not None:
            out.append(q)
    return tuple(out)


def jquery(q):
    return JQueryGraph.build(list(q.labels), list(q.edges))


def engine(name, S, mode, kernels="torch"):
    session = GraphSession.open(partition(name, S, mode)[1], device="cpu", kernels=kernels)
    assert session.backend == "sharded"
    return session


# ------------------------------------------------------------ graph store
@pytest.mark.parametrize("args", [(40, 6, 4, 2), (7, 3, 2, 0), (25, 10, 9, 5)])
def test_ring_of_cliques_equals_reference(args):
    *shape, seed = args
    ours, ref = generators.ring_of_cliques(*shape, seed=seed), jgen.ring_of_cliques(*shape, seed=seed)
    assert (ours.n_nodes, ours.n_labels) == (ref.n_nodes, ref.n_labels)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("name,S,mode", [("rmat", 4, "hash"), ("rmat", 8, "range"),
                                         ("ring", 8, "range"), ("ring", 4, "hash"),
                                         ("wide", 8, "hash")])
def test_cluster_graph_and_load_sets_equal_reference(name, S, mode):
    pg_ref, pg = partition(name, S, mode)
    for f in dataclasses.fields(PartitionedGraph):
        np.testing.assert_array_equal(getattr(pg, f.name), getattr(pg_ref, f.name), err_msg=f.name)
    ours, ref = ClusterGraphIndex.build(pg), JClusterGraphIndex.build(pg_ref)
    assert (ours.n_shards, ours.n_labels) == (ref.n_shards, ref.n_labels)
    assert sorted(ours.pair_index) == sorted(ref.pair_index)
    for key, pairs in ref.pair_index.items():
        assert ours.pair_index[key].dtype == pairs.dtype
        np.testing.assert_array_equal(ours.pair_index[key], pairs)
    for q in queries(name):
        plan = engine(name, S, mode).compile(q, **CAPS).plan
        C = ours.cluster_adjacency(q.label_pairs())
        np.testing.assert_array_equal(C, ref.cluster_adjacency(q.label_pairs()))
        np.testing.assert_array_equal(ClusterGraphIndex.bfs_distances(C),
                                      JClusterGraphIndex.bfs_distances(C))
        load = ours.load_sets(q.label_pairs(), plan.head_dists)
        np.testing.assert_array_equal(load, ref.load_sets(q.label_pairs(), plan.head_dists))
        assert load.shape == (len(plan.specs), S, S)
    if name == "ring" and mode == "range":  # its cluster graph is the shard ring
        load = ours.load_sets([(a, b) for a in range(4) for b in range(4)], (0, 1, 2))
        assert DistributedMatcher.ring_radii_for(load) == (0, 1, 2)


# ------------------------------------------------------------ collectives
def jax_vmap(f, *args):
    return jax.vmap(f, axis_name="data")(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("S", [1, 4, 5, 6, 8])
def test_or_allreduce_equals_reference(S):
    rng = np.random.default_rng(S)
    words = rng.integers(-(2**31), 2**31, (S, 3, 37), dtype=np.int64).astype(np.int32)
    words &= rng.integers(-(2**31), 2**31, words.shape, dtype=np.int64).astype(np.int32)
    want = jax_vmap(lambda w: jcoll.or_allreduce(w, "data"), words)
    got = coll.or_allreduce(torch.from_numpy(words))
    for k in range(S):  # every shard of the reference holds the same result
        equal(got, want[k])
    equal(coll.pmax(torch.from_numpy(words)), words.max(axis=0))


@pytest.mark.parametrize("radius", [1, 2])  # at S = 4, radius 2 is cut to (S - 1) // 2
@pytest.mark.parametrize("S", [4, 8])
def test_load_set_fetches_equal_reference(S, radius):
    rng = np.random.default_rng(10 * S + radius)
    cap, w = 9, 3
    cols = rng.integers(0, 1000, (S, cap, w)).astype(np.int32)
    valid = rng.random((S, cap)) < 0.6
    load = rng.random((S, S)) < 0.5
    t = [torch.from_numpy(a) for a in (cols, valid, load)]
    # the all-gather: one shared (S·cap, w) column tensor, per-shard validity
    jc, jv = jax_vmap(lambda c, v, l: jcoll.gather_load_set(c, v, l, "data"), cols, valid, load)
    fc, fv = coll.fetch_load_set(*t)
    assert fc.shape == (S * cap, w) and fv.shape == (S, S * cap)
    assert fc.data_ptr() == t[0].data_ptr()  # a view: the columns are not copied
    for k in range(S):
        equal(fc, jc[k])
    equal(fv, jv)
    # the ring: [self, +1, -1, +2, -2, …] shifts, each masked by its source's load row
    jc, jv = jax_vmap(lambda c, v, l: jcoll.gather_load_set_ring(c, v, l, "data", radius),
                      cols, valid, load)
    rc, rv = coll.fetch_load_set(*t, ring_radius=radius)
    h = min(radius, (S - 1) // 2)
    assert rc.shape == (S, (2 * h + 1) * cap, w) and rv.shape == (S, (2 * h + 1) * cap)
    equal(rc, jc)
    equal(rv, jv)


# ------------------------------------------- exploration and joins, per shard
def _jax_shard_graph(pg, k):
    return jmatch.ShardGraph(
        labels=jnp.asarray(pg.labels[k]), indptr=jnp.asarray(pg.indptr[k]),
        indices=jnp.asarray(pg.indices[k]), edge_src=jnp.asarray(pg.edge_src[k]),
        n_local=jnp.int32(pg.n_local[k]), n_local_edges=jnp.int32(pg.n_local_edges[k]),
        shard_id=jnp.int32(k), all_labels=jnp.asarray(pg.all_labels),
    )


@pytest.mark.parametrize("name,S,mode", [("rmat", 4, "hash"), ("ring", 8, "range")])
def test_shard_tables_and_joins_equal_reference(name, S, mode):
    pg_ref, pg = partition(name, S, mode)
    eng = engine(name, S, mode).engine
    jgs = [_jax_shard_graph(pg_ref, k) for k in range(S)]
    most_rounds = n_joins = 0
    for q in queries(name):
        plan = eng.plan(q, root_cap=1, **CAPS)  # a root a round: several rounds
        # every round of every shard, each shard called on its own, and the
        # OR of their contributions, from the same bindings on both sides
        jb = jmatch.Bindings.fresh(plan.n_qnodes, pg.n_total + 1)
        tb = tmatch.Bindings.fresh(plan.n_qnodes, pg.n_total + 1, "cpu")
        jcols, jvalids, jrows = [], [], []
        for spec in plan.specs:
            fn = jax.jit(functools.partial(jmatch.match_stwig_shard, spec=spec, kernels=JNP))
            rc, rv, jc, tc, r = [], [], None, None, 0
            while True:
                jouts = [fn(g, jb, round_idx=jnp.int32(r)) for g in jgs]
                touts = [tmatch.match_stwig_shard(g, tb, spec, r) for g in eng.graphs]
                for k, ((jt, jcw), (tt, tcw)) in enumerate(zip(jouts, touts)):
                    for f in jt._fields:
                        equal(getattr(tt, f), getattr(jt, f), f"shard {k} round {r} {f}")
                    equal(tcw.words, jcw.words, f"shard {k} round {r} contribution")
                jcw = functools.reduce(jnp.bitwise_or, [c.words for _, c in jouts])
                tcw = coll.or_allreduce(torch.stack([c.words for _, c in touts]))
                equal(tcw, jcw)
                jc = jcw if jc is None else jnp.bitwise_or(jc, jcw)
                tc = tcw if tc is None else tc | tcw
                rc.append(np.stack([np.asarray(t.cols) for t, _ in jouts]))
                rv.append(np.stack([np.asarray(t.valid) for t, _ in jouts]))
                jrows.append(sum(int(t.n_rows) for t, _ in jouts))
                r += 1
                if r * spec.root_cap >= max(int(t.n_roots) for t, _ in jouts):
                    break
            most_rounds = max(most_rounds, r)
            jb = jmatch.apply_binding_update(jb, spec, jc)
            tb = tmatch.apply_binding_update(tb, spec, tc)
            equal(tb.words, jb.words)
            jcols.append(np.concatenate(rc, axis=1))
            jvalids.append(np.concatenate(rv, axis=1))
        # the engine's exploration: the same rounds, stacked and concatenated
        stats = MatchStats(backend="sharded", n_shards=S)
        all_cols, all_valids, _ = eng._explore(plan, stats)
        for t in range(len(plan.specs)):
            equal(all_cols[t], jcols[t])
            equal(all_valids[t], jvalids[t])
        assert sum(stats.stwig_rows) == sum(jrows)
        if len(plan.specs) < 2:
            continue
        # every shard's join chain on its fetched tables, join by join
        _, load_masks = eng._load_masks(q, plan)
        fetched = eng._fetch(all_cols, all_valids, load_masks, plan.head, None)
        schemas = tuple(tjoin.Schema(s.qnodes, (s.root_label,) + s.child_labels)
                        for s in plan.specs)
        order = tjoin.select_join_order(list(schemas), stats.stwig_rows)
        kw = dict(out_cap=plan.join_rows_cap, dup_cap=plan.join_dup_cap)
        for k in range(S):
            head = tmatch_table(all_cols[plan.head][k], all_valids[plan.head][k])
            tables = eng._shard_tables(k, plan.head, head, fetched)
            acc, sch = tables[order[0]], schemas[order[0]]
            jacc = jtable(acc)
            for idx in order[1:]:
                jout = jax_join(sch, schemas[idx], **kw)(jacc, jtable(tables[idx]))
                acc, sch = tjoin.sort_merge_join(acc, tables[idx], sch, schemas[idx], **kw)
                for f in ("cols", "valid", "n_rows", "overflow"):
                    equal(getattr(acc, f), getattr(jout, f), f"shard {k} {f}")
                jacc = jout
                n_joins += 1
            mine, _ = eng._join_shard(k, all_cols, all_valids, fetched, schemas, order, plan)
            equal(mine.cols, acc.cols)
            equal(mine.valid, acc.valid)
    assert most_rounds > 1 and n_joins > 0


@functools.lru_cache(maxsize=None)
def jax_join(sch_a, sch_b, out_cap, dup_cap):
    """The reference's join of two schemas, jitted once for every shard."""
    a, b = jjoin.Schema(sch_a.qnodes, sch_a.qlabels), jjoin.Schema(sch_b.qnodes, sch_b.qlabels)
    return jax.jit(lambda x, y: jjoin.sort_merge_join(
        x, y, a, b, out_cap=out_cap, dup_cap=dup_cap, kernels=JNP)[0])


def tmatch_table(cols, valid):
    return tjoin.JoinTable(cols=cols, valid=valid, n_rows=valid.sum(dtype=torch.int32),
                           overflow=torch.tensor(False))


def jtable(t):
    return jjoin.JoinTable(cols=jnp.asarray(t.cols.numpy()), valid=jnp.asarray(t.valid.numpy()),
                           n_rows=jnp.int32(int(t.n_rows)), overflow=jnp.bool_(bool(t.overflow)))


# ------------------------------------------------------------- end to end
@functools.lru_cache(maxsize=None)
def local_reference(name):
    """The JAX local engine's rows (``kernels="jnp"``) and completeness."""
    g_ref, _ = graph(name)
    s = JGraphSession.open(g_ref, backend="local", kernels="jnp")
    return [
        (rows_set(r.rows), r.complete)
        for r in (s.run(jquery(q), max_matches=0, **CAPS) for q in queries(name))
    ]


@pytest.mark.parametrize("use_ring", [False, True], ids=["gather", "ring"])
@pytest.mark.parametrize("name,S,mode", [("rmat", 4, "hash"), ("rmat", 8, "hash"),
                                         ("ring", 8, "range")])
def test_run_and_stream_equal_local_reference_and_oracle(name, S, mode, use_ring):
    session = engine(name, S, mode)
    g = graph(name)[1]
    if use_ring and name == "ring":  # the range-partitioned ring really rings
        plan = session.compile(queries(name)[0], **CAPS).plan
        load, _ = session.engine._load_masks(queries(name)[0], plan)
        assert session.engine.ring_radii_for(load) is not None
    n_complete = 0
    for q, (want, want_complete) in zip(queries(name), local_reference(name)):
        compiled = session.compile(q, max_matches=0, **CAPS)
        res = compiled.run(use_ring=use_ring)
        got = rows_set(res.rows)
        assert len(got) == res.n_matches == len(res.rows)  # no duplicates across shards
        assert (got, res.complete) == (want, want_complete)
        assert res.stats.backend == "sharded" and res.stats.n_shards == S
        assert res.stats.shard_health == {k: "ok" for k in range(S)}
        if res.complete:
            n_complete += 1
            assert got == nx_oracle(g, q)
            # truncation keeps the first k rows of the shard-major union
            first = compiled.run(max_matches=5, use_ring=use_ring)
            np.testing.assert_array_equal(first.rows, res.rows[:5])
        # pages are disjoint and their union is the non-adaptive run
        once = compiled.run(adaptive=False, use_ring=use_ring)
        pages = list(compiled.stream(page_size=7, block_rows=16, use_ring=use_ring))
        streamed = [tuple(r) for p in pages for r in p.rows.tolist()]
        assert len(streamed) == len(set(streamed))
        assert set(streamed) == rows_set(once.rows)
        assert all(p.complete for p in pages) == once.complete
    assert n_complete >= 2


def test_early_stopped_stream_skips_block_joins():
    session = engine("rmat", 4, "hash")
    q = queries("rmat")[0]
    compiled = session.compile(q, max_matches=0, **CAPS)
    before = session.engine.join_block_calls
    full = list(compiled.stream(page_size=4, block_rows=4))
    n_full = session.engine.join_block_calls - before
    assert n_full >= 3 and full[0].stats.join_blocks == n_full
    before = session.engine.join_block_calls
    early = list(compiled.stream(page_size=4, block_rows=4, max_matches=1))
    assert sum(p.n_rows for p in early) == 1
    assert session.engine.join_block_calls - before < n_full


def test_session_routing(monkeypatch):
    _, pg = partition("rmat", 4, "hash")
    assert GraphSession.open(pg, device="cpu").backend == "sharded"
    with pytest.raises(ValueError, match="1-shard partition"):
        GraphSession.open(pg, backend="local", device="cpu")
    g = graph("rmat")[1]
    s = GraphSession.open(g, device="cpu", n_shards=3, partition_mode="range")
    assert (s.backend, s.pg.n_shards) == ("sharded", 3)
    assert GraphSession.open(g, device="cpu").backend == "local"
    # a raw graph on the sharded backend needs its shard count
    with pytest.raises(ValueError, match="needs n_shards="):
        GraphSession.open(g, backend="sharded", device="cpu")
    assert GraphSession.open(g, backend="sharded", device="cpu", n_shards=1).pg.n_shards == 1
    assert stwig.CONFIG.n_nodes // stwig.CONFIG.n_shards == 250_000
    assert stwig.smoke().n_shards == 4
    with pytest.raises(ValueError, match="backend must be one of"):
        GraphSession.open(pg, backend="mesh", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open(pg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open(pg, backend="sharded", kernels="cuda")
