"""The port's last generators, the engines' direct entry points and the
stacked ``bool_allreduce_any`` against the JAX package on the CPU.

The generators (``erdos_renyi``, ``grid_2d``, ``paper_fig6_query_edges``,
``molecule_batch``; ``rmat`` and ``ring_of_cliques`` again beside them) must
give the same CSR and labels bit for bit from a seed. ``SubgraphMatcher``'s
and ``DistributedMatcher``'s ``match`` and ``match_stream`` (S = 4) must
give the rows of the port's own facade and of the JAX local engine
(``kernels="jnp"``). ``OpenStream.n_blocks`` bounds the pages. The GIN-TU
and GatedGCN forwards on a 4-graph ``molecule_batch`` are held to the JAX
forwards from the same weights within ``1e-4 · max|jax|``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.configs import gatedgcn, gin_tu  # noqa: E402
from repro_torch.core import QueryGraph  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.stream import open_stream  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.partition import PartitionedGraph  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.runtime import QueryGuard, RetryPolicy  # noqa: E402
from repro_torch.train.step import make_serve_fns  # noqa: E402

# (generator, args, kwargs): each call is made on both packages
GENERATORS = {
    "erdos_renyi": ((300, 1200, 7), {"seed": 3}),
    "grid_2d": ((9, 13, 5), {"seed": 4}),
    "molecule_batch": ((6, 30, 4.3, 9), {"seed": 5}),
    "rmat": ((500, 2000, 11), {"seed": 6}),
    "ring_of_cliques": ((7, 5, 3), {"seed": 7}),
}
# the molecule shape (128 graphs × 30 nodes, 8,192 slots of directed edges):
# avg_degree 2.15 draws int(30 · 2.15 / 2) = 32 bonds a molecule, 4,096 in
# all, 8,192 once stored both ways
MOLECULE_AVG_DEGREE = 2.15
CAPS = dict(child_cap=6, emission_budget=256, join_rows_cap=512, join_dup_cap=8)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_equal_reference(name):
    args, kw = GENERATORS[name]
    want = getattr(jgen, name)(*args, **kw)
    got = getattr(generators, name)(*args, **kw)
    assert (got.n_nodes, got.n_labels, got.directed) == (want.n_nodes, want.n_labels, want.directed)
    for field in ("indptr", "indices", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_paper_fig6_query_edges_equal_reference():
    assert generators.paper_fig6_query_edges() == jgen.paper_fig6_query_edges()


def test_molecule_batch_at_the_molecule_shape():
    """e_per is exactly 32 at avg_degree 2.15; `Graph.from_edges` drops
    self-loops and repeats and stores each bond both ways; every edge stays
    inside its molecule (graph_id = node // 30); the batch carries every
    stored directed edge, as `gnn_full_batch` does, in the shape's 8,192
    slots, each bond in both directions."""
    from repro_torch.configs.base import GNN_SHAPES

    shape = GNN_SHAPES["molecule"]
    n_graphs, per = shape["n_graphs"], shape["n"] // shape["n_graphs"]
    e_per = max(1, int(per * MOLECULE_AVG_DEGREE / 2))
    assert (per, e_per, 2 * n_graphs * e_per) == (30, 32, shape["e"])
    g = generators.molecule_batch(n_graphs, per, MOLECULE_AVG_DEGREE, 8, seed=0)
    src = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    assert g.n_nodes == shape["n"] and not g.directed
    assert (src // per == g.indices // per).all() and (src != g.indices).all()
    undirected = int((src < g.indices).sum())
    assert g.n_edges == 2 * undirected <= shape["e"]
    cfg = dataclasses.replace(gin_tu.CONFIG, d_in=shape["d"], task="graph")
    b = pipeline.gnn_graph_batch(cfg, g, nodes_per_graph=per, n_edges=shape["e"],
                                 n_classes=cfg.n_classes, seed=0)
    assert b.edge_src.shape == (shape["e"],) and int(b.edge_mask.sum()) == g.n_edges
    kept = b.edge_mask
    pairs = set(zip(b.edge_src[kept].tolist(), b.edge_dst[kept].tolist()))
    assert len(pairs) == g.n_edges and all((d, s) in pairs for s, d in pairs)
    np.testing.assert_array_equal(b.graph_id, np.arange(g.n_nodes) // per)
    assert b.n_graphs == n_graphs and b.labels.shape == (n_graphs,)


# ------------------------------------------------------- molecule forwards
def _jax_cfg(cfg):
    from repro.configs.base import GNNConfig as JaxGNNConfig

    return JaxGNNConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("mod", [gin_tu, gatedgcn], ids=["gin-tu", "gatedgcn"])
def test_molecule_forward_matches_jax(mod):
    cfg = dataclasses.replace(mod.smoke(), d_in=32, task="graph")
    g = generators.molecule_batch(4, 30, MOLECULE_AVG_DEGREE, 8, seed=1)
    b = pipeline.gnn_graph_batch(cfg, g, nodes_per_graph=30, n_edges=256,
                                 n_classes=cfg.n_classes, seed=1)
    params = jax.tree.map(np.array, jax.jit(lambda k: jax_gnn.init(_jax_cfg(cfg), k))(
        jax.random.PRNGKey(0)))
    jb = jax_gnn.GraphBatch(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                               for k, v in b._asdict().items()})
    want = np.asarray(jax.jit(functools.partial(jax_gnn.forward, _jax_cfg(cfg)))(params, jb))
    model = gnn.params_from_jax(cfg, params, device="cpu")
    got = make_serve_fns(cfg, model)["infer"](b).numpy()
    assert got.shape == want.shape == (4, cfg.n_classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------ engines' entry points
GRID = (8, 9, 3)  # rows, cols, labels: 72 nodes with many 4-cycles


@functools.lru_cache(maxsize=None)
def grid_graphs():
    return jgen.grid_2d(*GRID, seed=2), generators.grid_2d(*GRID, seed=2)


QUERIES = [  # a 4-cycle and a 3-path, labels from the grid's first nodes
    ([0, 1, 2, 1], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([2, 0, 1], [(0, 1), (1, 2)]),
]


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


@functools.lru_cache(maxsize=None)
def reference_rows():
    """The JAX local engine's rows and completeness, adaptive, a query."""
    s = JGraphSession.open(grid_graphs()[0], backend="local", kernels="jnp")
    return [(rows_set(r.rows), r.complete)
            for r in (s.run(JQueryGraph.build(labels=lb, edges=ed), max_matches=0, **CAPS)
                      for lb, ed in QUERIES)]


def session(backend):
    g = grid_graphs()[1]
    pg = PartitionedGraph.build(g, 1 if backend == "local" else 4, mode="hash")
    return GraphSession.open(pg, backend=backend, device="cpu", kernels="torch")


@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_direct_match_equals_facade_and_reference(backend):
    s = session(backend)
    eng = s.engine
    assert eng.backend == backend
    for (lb, ed), (want, want_complete) in zip(QUERIES, reference_rows()):
        q = QueryGraph.build(labels=lb, edges=ed)
        compiled = s.compile(q, max_matches=0, **CAPS)
        res = eng.match(q, max_matches=0, **CAPS)
        assert (rows_set(res.rows), res.complete) == (want, want_complete)
        assert rows_set(res.rows) == rows_set(compiled.run().rows)
        assert res.stats.backend == backend
        once = eng.match(q, adaptive=False, max_matches=0, **CAPS)
        facade_once = compiled.run(adaptive=False)
        np.testing.assert_array_equal(once.rows, facade_once.rows)
        assert once.complete == facade_once.complete
        # an explicit plan: escalation starts from its caps
        planned = eng.match(q, compiled.plan)
        assert rows_set(planned.rows) == rows_set(res.rows)
        pages = list(eng.match_stream(q, max_matches=0, block_rows=16, **CAPS))
        streamed = [tuple(r) for p in pages for r in p.rows.tolist()]
        assert len(streamed) == len(set(streamed))
        assert set(streamed) == rows_set(once.rows)
        assert set(streamed) == rows_set(
            np.concatenate([p.rows for p in compiled.stream(page_size=16, block_rows=16)]))
        n_blocks = open_stream(eng, q, compiled.plan, block_rows=16).n_blocks
        assert 0 < len(pages) <= n_blocks


def test_direct_match_takes_the_policy_guard_and_ring():
    s = session("sharded")
    q = QueryGraph.build(labels=QUERIES[0][0], edges=QUERIES[0][1])
    tight = dict(CAPS, child_cap=1, join_rows_cap=4)
    capped = s.engine.match(q, max_matches=0, retry_policy=RetryPolicy(max_retries=0), **tight)
    facade = s.compile(q, max_matches=0, **tight).run(retry_policy=RetryPolicy(max_retries=0))
    assert rows_set(capped.rows) == rows_set(facade.rows)
    assert (capped.complete, capped.stats.retries) == (facade.complete, facade.stats.retries)
    tripped = s.engine.match(q, max_matches=0, guard=QueryGuard(deadline_s=0.0), **tight)
    assert tripped.stats.degrade_reason == "deadline" and not tripped.complete
    ring = s.engine.match(q, max_matches=0, use_ring=True, **CAPS)
    assert rows_set(ring.rows) == reference_rows()[0][0]


def test_n_blocks_bounds_a_stream():
    s = session("local")
    q = QueryGraph.build(labels=QUERIES[1][0], edges=QUERIES[1][1])
    for block_rows in (1, 5, 16, 1 << 20):
        st = open_stream(s.engine, q, None, block_rows=block_rows, max_matches=0, **CAPS)
        assert st.n_blocks == -(-st.state.cap // st.block_rows) >= 1
        assert len(list(st.blocks())) <= st.n_blocks


# ------------------------------------------------------------ collectives
def jax_vmap(f, *args):
    return jax.vmap(f, axis_name="data")(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_bool_allreduce_any_equals_reference(S, dtype):
    rng = np.random.default_rng(S)
    x = (rng.random((S, 5, 7)) < 0.2).astype(dtype)
    if dtype == np.int32:
        x *= rng.integers(-3, 4, x.shape).astype(np.int32)
    want = np.asarray(jax_vmap(lambda v: jcoll.bool_allreduce_any(v, "data"), x))
    got = coll.bool_allreduce_any(torch.as_tensor(x))
    assert got.dtype == torch.bool
    for k in range(S):  # every shard holds the same result
        np.testing.assert_array_equal(got.numpy(), want[k])


def test_bool_allreduce_any_reports_its_call():
    seen = []
    prev = coll.recorder
    coll.recorder = lambda name, operands, result, info: seen.append((name, tuple(operands)))
    try:
        coll.bool_allreduce_any(torch.zeros((4, 3), dtype=torch.bool))
    finally:
        coll.recorder = prev
    assert seen == [("bool_allreduce_any", ("x",))]
