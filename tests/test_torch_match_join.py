"""The port's MatchSTwig and sort-merge join against the JAX package's, on
two small R-MAT graphs: every ``(spec, round)`` table and binding
contribution, and every join table, must be exactly equal. Also the join's
uint32 hash, and `PartitionedGraph.from_arrays` against the port's own
partitioning."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.core import join as jjoin  # noqa: E402
from repro.core import match as jmatch  # noqa: E402
from repro.core.backend import get_kernels  # noqa: E402
from repro.core.plan import make_plan as j_make_plan  # noqa: E402
from repro.graphstore import PartitionedGraph as JPartitionedGraph  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.workloads import dfs_query as j_dfs_query  # noqa: E402
from repro.workloads import path_query as j_path_query  # noqa: E402
from repro.workloads import random_query as j_random_query  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.core import match as tmatch  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.labels import LabelIndex  # noqa: E402
from repro_torch.graphstore.partition import PartitionedGraph  # noqa: E402
from repro_torch.workloads import dfs_query, path_query, random_query  # noqa: E402

JNP = get_kernels("jnp")
GRAPHS = {"rmat-a": (300, 1200, 5, 3), "rmat-b": (400, 1800, 4, 8)}


def as_np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def equal(port, ref):
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(a, as_np(ref))


@functools.lru_cache(maxsize=None)
def graph(name):
    n, m, labels, seed = GRAPHS[name]
    return jgen.rmat(n, m, labels, seed=seed), generators.rmat(n, m, labels, seed=seed)


def queries(g_port, g_ref, seed, n):
    """The same DFS queries drawn by both packages' workload generators."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    while len(out) < n:
        q, qr = dfs_query(g_port, r1, 4), j_dfs_query(g_ref, r2, 4)
        assert (q is None) == (qr is None)
        if q is not None:
            assert (q.labels, q.edges) == (qr.labels, qr.edges)
            out.append(q)
    return out


def test_query_generators_match_reference():
    g_ref, g_port = graph("rmat-a")
    for seed in range(5):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for ours, ref in [(path_query(g_port, r1, 4), j_path_query(g_ref, r2, 4)),
                          (random_query(5, 6, 5, r1), j_random_query(5, 6, 5, r2))]:
            assert (ours is None) == (ref is None)
            if ours is not None:
                assert (ours.n_nodes, ours.labels, ours.edges) == (
                    ref.n_nodes, ref.labels, ref.edges)


def test_from_arrays_equals_own_build():
    g_ref, g_port = graph("rmat-a")
    pg_ref = JPartitionedGraph.build(g_ref, 1)
    pg = PartitionedGraph.from_arrays(dataclasses.asdict(pg_ref))
    own = PartitionedGraph.build(g_port, 1)
    for f in dataclasses.fields(PartitionedGraph):
        a, b = getattr(pg, f.name), getattr(own, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    with pytest.raises(ValueError, match="missing"):
        PartitionedGraph.from_arrays({"n_shards": 1})


def test_label_index_matches_reference():
    from repro.graphstore import LabelIndex as JLabelIndex

    g_ref, _ = graph("rmat-b")
    pg_ref = JPartitionedGraph.build(g_ref, 1)
    ours = LabelIndex(PartitionedGraph.from_arrays(dataclasses.asdict(pg_ref)))
    ref = JLabelIndex(pg_ref)
    ids = np.arange(pg_ref.n_total + 1)
    for label in range(pg_ref.n_labels):
        np.testing.assert_array_equal(ours.get_ids(0, label), ref.get_ids(0, label))
        assert ours.count(0, label) == ref.count(0, label)
        np.testing.assert_array_equal(ours.has_label(ids, label), ref.has_label(ids, label))


def test_mix32_and_combine_keys_match_reference():
    rng = np.random.default_rng(0)
    cols = rng.integers(-(2**31), 2**31, (257, 3), dtype=np.int64).astype(np.int32)
    cols[:4] = [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -(2**31), 1], [7, 8, 9]]
    mixed = np.asarray(jjoin._mix32(jnp.asarray(cols[:, 0])))
    np.testing.assert_array_equal(
        tjoin._mix32(torch.from_numpy(cols[:, 0]).to(torch.int64)).numpy(), mixed
    )
    for pos in [(0,), (2, 0), (0, 1, 2)]:
        want = np.asarray(jjoin._combine_keys(jnp.asarray(cols), pos))
        got = tjoin._combine_keys(torch.from_numpy(cols), pos).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def _jax_shard_graph(pg):
    return jmatch.ShardGraph(
        labels=jnp.asarray(pg.labels[0]), indptr=jnp.asarray(pg.indptr[0]),
        indices=jnp.asarray(pg.indices[0]), edge_src=jnp.asarray(pg.edge_src[0]),
        n_local=jnp.int32(pg.n_local[0]), n_local_edges=jnp.int32(pg.n_local_edges[0]),
        shard_id=jnp.int32(0), all_labels=jnp.asarray(pg.all_labels),
    )


def _t_table(jt):
    return tjoin.JoinTable(
        cols=torch.from_numpy(np.array(jt.cols)),
        valid=torch.from_numpy(np.array(jt.valid)),
        n_rows=torch.tensor(int(jt.n_rows), dtype=torch.int32),
        overflow=torch.tensor(bool(jt.overflow)),
    )


def _equal_tables(port, ref):
    for f in ("cols", "valid", "n_rows", "overflow"):
        equal(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_match_and_join_tables_equal_reference(name):
    g_ref, g_port = graph(name)
    pg_ref = JPartitionedGraph.build(g_ref, 1)
    pg = PartitionedGraph.from_arrays(dataclasses.asdict(pg_ref))
    jg = _jax_shard_graph(pg_ref)
    tg = tmatch.ShardGraph.from_partition(pg, 0, "cpu")
    n_bits = pg.n_total + 1
    checked_rounds = checked_joins = 0
    for q in queries(g_port, g_ref, seed=1, n=3):
        # small caps force several root rounds and child-cap overflow
        caps = dict(root_cap=16, child_cap=3, emission_budget=64, join_rows_cap=256,
                    join_dup_cap=8)
        plan = make_plan(q, pg.freq, **caps)
        jplan = j_make_plan(JQueryGraph.build(list(q.labels), list(q.edges)),
                            pg_ref.freq, **caps)
        assert [dataclasses.astuple(s) for s in plan.specs] == [
            dataclasses.astuple(s) for s in jplan.specs
        ]
        jb = jmatch.Bindings.fresh(q.n_nodes, n_bits)
        tb = tmatch.Bindings.fresh(q.n_nodes, n_bits, "cpu")
        jtables, schemas = [], []
        for spec, jspec in zip(plan.specs, jplan.specs):
            fn = jax.jit(functools.partial(jmatch.match_stwig_shard, spec=jspec, kernels=JNP))
            jrounds, jc, tc, r = [], None, None, 0
            while True:
                jt, jcw = fn(jg, jb, round_idx=jnp.int32(r))
                tt, tcw = tmatch.match_stwig_shard(tg, tb, spec, r)
                for f in jt._fields:
                    equal(getattr(tt, f), getattr(jt, f))
                equal(tcw.words, jcw.words)
                checked_rounds += 1
                jrounds.append(jt)
                jc = jcw.words if jc is None else jnp.bitwise_or(jc, jcw.words)
                tc = tcw.words if tc is None else tc | tcw.words
                r += 1
                if r * spec.root_cap >= int(jt.n_roots):
                    break
            jb = jmatch.apply_binding_update(jb, jspec, jc)
            tb = tmatch.apply_binding_update(tb, spec, tc)
            equal(tb.words, jb.words)
            jtables.append(jjoin.JoinTable(
                cols=jnp.concatenate([t.cols for t in jrounds]),
                valid=jnp.concatenate([t.valid for t in jrounds]),
                n_rows=sum(int(t.n_rows) for t in jrounds),
                overflow=any(bool(t.overflow) for t in jrounds),
            ))
            schemas.append((spec.qnodes, (spec.root_label,) + spec.child_labels))
        # join chain in the reference's order, each join fed identical inputs
        order = jjoin.select_join_order(
            [jjoin.Schema(*s) for s in schemas], [int(t.n_rows) for t in jtables]
        )
        assert order == tjoin.select_join_order(
            [tjoin.Schema(*s) for s in schemas], [int(t.n_rows) for t in jtables]
        )
        jacc, jsch = jtables[order[0]], jjoin.Schema(*schemas[order[0]])
        for idx in order[1:]:
            jb_sch, tb_sch = jjoin.Schema(*schemas[idx]), tjoin.Schema(*schemas[idx])
            kw = dict(out_cap=plan.join_rows_cap, dup_cap=plan.join_dup_cap)
            jout = jax.jit(
                lambda a, b: jjoin.sort_merge_join(a, b, jsch, jb_sch, **kw, kernels=JNP)[0]
            )(jacc, jtables[idx])
            jmerged = jsch.merge(jb_sch)[0]
            tout, tmerged = tjoin.sort_merge_join(
                _t_table(jacc), _t_table(jtables[idx]),
                tjoin.Schema(jsch.qnodes, jsch.qlabels), tb_sch, **kw,
            )
            _equal_tables(tout, jout)
            assert (tmerged.qnodes, tmerged.qlabels) == (jmerged.qnodes, jmerged.qlabels)
            checked_joins += 1
            # the blocked build side, as the streaming path cuts it
            jblk = jjoin.block_table(jacc, 5, 32)
            tblk = tjoin.block_table(_t_table(jacc), 5, 32)
            _equal_tables(tblk, jblk)
            jacc, jsch = jout, jmerged
    assert checked_rounds > 3
    assert checked_joins > 0
