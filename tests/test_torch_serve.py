"""The port's continuous-batching server (``repro_torch.runtime.server``,
``GraphSession.serve``, ``run_batch``) on the CPU against the JAX package's
(``kernels="jnp"``): per query the same rows and status, and the same
``ServerStats``; admission shedding, deadline isolation, per-query failure,
first-K budgets, bucket sharing, the scheduler thread, ``mixed_workload`` and
the launcher. Three 3-node DFS queries on ``rmat(150, 500, 4, seed=7,
symmetrize=True)`` at ``child_cap=32`` and ``block_rows=8``: the JAX
server pays its compiles once for them, and every case reuses them."""
import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("networkx")

from helpers import nx_oracle  # noqa: E402
from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.core.result import MatchResult as JMatchResult  # noqa: E402
from repro.core.result import MatchStats as JMatchStats  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro.workloads import mixed_workload as j_mixed_workload  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.api import serve as serve_mod  # noqa: E402
from repro_torch.core.result import MatchResult, MatchStats  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.runtime.server import (  # noqa: E402
    QueryOutcome,
    QueryServer,
    ServerConfig,
    bucket_key,
    summarize_outcomes,
)
from repro_torch.workloads import dfs_query, mixed_workload, path_query  # noqa: E402

GRAPH = (150, 500, 4)
KW = dict(seed=7, symmetrize=True)
SERVE = dict(max_inflight=4, block_rows=8, max_matches=0)
CAPS = dict(child_cap=32)


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


@functools.lru_cache(maxsize=None)
def graph():
    return generators.rmat(*GRAPH, **KW)


@functools.lru_cache(maxsize=None)
def queries():
    rng, out = np.random.default_rng(0), []
    while len(out) < 3:
        q = dfs_query(graph(), rng, 3)
        if q is not None:
            out.append(q)
    return tuple(out)


def jqueries():
    return [JQueryGraph.build(list(q.labels), list(q.edges)) for q in queries()]


@functools.lru_cache(maxsize=None)
def session():
    return GraphSession.open(graph(), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_session():
    return JGraphSession.open(jgen.rmat(*GRAPH, **KW), kernels="jnp")


def same_outcomes(ours, ref):
    """Per query: the same status, row set and (for complete results)
    degrade reason; and no row twice."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.status == b.status, (a.status, a.error, b.status, b.error)
        assert a.stats.degrade_reason == b.stats.degrade_reason
        assert rows_set(a.rows) == rows_set(b.rows)
        assert a.n_matches == len(rows_set(a.rows)) == b.n_matches


# ------------------------------------------------------------------- config
@pytest.mark.parametrize("bad", [dict(max_inflight=0), dict(block_rows=0),
                                 dict(max_matches=-1), dict(deadline_s=-0.5)])
def test_server_config_validation(bad):
    with pytest.raises(ValueError):
        ServerConfig(**bad)
    with pytest.raises(ValueError):
        jserver.ServerConfig(**bad)
    assert dataclasses.asdict(ServerConfig()) == dataclasses.asdict(jserver.ServerConfig())


def test_api_exports_the_server_surface():
    for name in ("QueryServer", "ServerConfig", "ServerStats", "QueryOutcome", "Ticket",
                 "summarize_outcomes"):
        assert name in api.__all__
        assert getattr(api, name) is getattr(serve_mod, name)
    server = session().serve(max_inflight=3, block_rows=64)
    assert isinstance(server, QueryServer) and server.session is session()
    assert (server.config.max_inflight, server.config.block_rows) == (3, 64)


def test_summarize_outcomes_equals_the_reference():
    statuses = ["served", "partial", "failed", "served", "partial", "served"]
    counts = [5, 0, 0, 2, 7, 1]

    def outcomes(result, stats, outcome):
        return [outcome(result=result(rows=np.zeros((n, 3), np.int64), n_matches=n,
                                      complete=s == "served", stats=stats()),
                        status=s, bucket=(), pages=[], queue_s=0.0, wall_s=0.0, ttfp_s=None)
                for s, n in zip(statuses, counts)]

    ours = summarize_outcomes(outcomes(MatchResult, MatchStats, QueryOutcome))
    ref = jserver.summarize_outcomes(outcomes(JMatchResult, JMatchStats, jserver.QueryOutcome))
    assert ours == ref == {"served": 3, "partial": 2, "failed": 1, "n_matches": 15}


def test_bucket_key_is_the_cache_key():
    """A bucket is the identity of every cached step its query asks for:
    the match steps' specs, the join steps' capacities and the kernels."""
    s = GraphSession.open(graph(), device="cpu")
    rng, q = np.random.default_rng(3), None
    while q is None:  # two STwigs: match and join steps
        q = path_query(graph(), rng, 4)
    (out,) = s.serve(block_rows=8, max_matches=0).serve([q], **CAPS)
    plan = s.compile(q, **CAPS).plan
    assert out.bucket == bucket_key(plan, 8, "torch")
    specs, child_cap, rows_cap, dup_cap, block, kern = out.bucket
    keys = list(s.cache._data)
    assert {k[1] for k in keys if k[0] == "match"} == set(specs)
    joins = [k for k in keys if k[0] == "join"]
    assert joins and all((k[3], k[4]) == (rows_cap, dup_cap) for k in joins)
    assert all(k[-1] == kern == "torch" for k in keys)
    assert child_cap == max(sp.child_cap for sp in specs) and block == 8
    # the reference's key of the same plan, field by field
    jplan = JGraphSession.open(jgen.rmat(*GRAPH, **KW), kernels="jnp").compile(
        JQueryGraph.build(list(q.labels), list(q.edges)), **CAPS).plan
    ref = jserver.bucket_key(jplan, 8, "jnp")
    assert [dataclasses.astuple(sp) for sp in ref[0]] == [dataclasses.astuple(sp) for sp in specs]
    assert ref[1:5] == out.bucket[1:5]


# ---------------------------------------------------------------- serving
def test_served_workload_equals_the_reference_and_the_sequential_streams():
    s = session()
    server = s.serve(**SERVE)
    ours = server.serve(queries(), **CAPS)
    jsrv = jax_session().serve(**SERVE)
    ref = jsrv.serve(jqueries(), **CAPS)
    same_outcomes(ours, ref)
    assert server.stats.as_dict() == jsrv.stats.as_dict()
    assert [b[1:] for b in server.stats.buckets] == [
        b[1:-1] + ("torch",) for b in jsrv.stats.buckets]
    assert server.stats.join_quanta == sum(o.stats.join_blocks for o in ours)
    for q, o in zip(queries(), ours):
        assert o.status == "served" and rows_set(o.rows) == nx_oracle(graph(), q)
        pages = list(s.compile(q, **CAPS).stream(max_matches=0, block_rows=8))
        np.testing.assert_array_equal(o.rows, np.concatenate([p.rows for p in pages]))
        assert o.queue_s >= 0 and o.wall_s >= o.queue_s and o.ttfp_s is not None


def test_bucket_mates_add_no_cache_miss():
    for sess, qs, in ((session(), queries()), (jax_session(), jqueries())):
        server = sess.serve(**SERVE)
        server.serve([qs[0]], **CAPS)
        misses = sess.cache.misses
        outs = server.serve([qs[0]] * 4, **CAPS)
        assert all(o.status == "served" for o in outs)
        assert sess.cache.misses == misses
        assert len({o.bucket for o in outs}) == 1
        assert server.stats.warm_admissions == 3


def test_expired_deadline_sheds_at_admission():
    results = []
    for sess, qs in ((session(), queries()), (jax_session(), jqueries())):
        blocks = sess.engine.join_block_calls
        server = sess.serve(max_inflight=2)
        tickets = [server.submit(qs[1], deadline_s=0.0, **CAPS) for _ in range(3)]
        server.run_until_idle()
        outs = [t.result(timeout=1) for t in tickets]
        assert all(o.status == "partial" and o.stats.degrade_reason == "deadline"
                   and o.n_matches == 0 for o in outs)
        assert server.stats.setup_quanta == server.stats.join_quanta == 0
        assert sess.engine.join_block_calls == blocks  # no block joined
        results.append((server.stats.as_dict(), summarize_outcomes(outs)))
    assert results[0] == results[1]
    assert results[0][1] == {"served": 0, "partial": 3, "failed": 0, "n_matches": 0}


def test_deadline_trip_leaves_bucket_mates_complete():
    got = []
    for sess, qs in ((session(), queries()), (jax_session(), jqueries())):
        with sess.serve(max_inflight=5, block_rows=8, max_matches=0) as server:
            mates = [server.submit(qs[0], **CAPS) for _ in range(4)]
            victim = server.submit(qs[0], deadline_s=1e-6, **CAPS)
            outs = [t.result(timeout=120) for t in mates]
            loser = victim.result(timeout=120)
        assert loser.status == "partial" and loser.stats.degrade_reason == "deadline"
        assert all(o.status == "served" and o.result.complete for o in outs)
        assert server.stats.global_degradations == 0
        got.append(([rows_set(o.rows) for o in outs], rows_set(loser.rows)))
    assert got[0][0] == got[1][0]
    assert got[0][1] <= got[0][0][0]


def test_a_query_that_raises_is_isolated():
    results = []
    for sess, qs in ((session(), queries()), (jax_session(), jqueries())):
        server = sess.serve(max_inflight=3, block_rows=8, max_matches=0)
        t_good = server.submit(qs[1], **CAPS)
        t_bad = server.submit(qs[0], **CAPS)
        with server._lock:  # its setup quantum raises a TypeError
            next(e for e in server._pending if e.ticket is t_bad).block_rows = "bogus"
        server.run_until_idle()
        bad, good = t_bad.result(timeout=1), t_good.result(timeout=1)
        assert bad.status == "failed" and "TypeError" in bad.error
        assert good.status == "served"
        assert server.stats.global_degradations == 0
        results.append((server.stats.as_dict(), rows_set(good.rows)))
    assert results[0] == results[1]


def test_first_k_budget_stops_join_quanta():
    results = []
    for sess, qs in ((session(), queries()), (jax_session(), jqueries())):
        full_server = sess.serve(max_inflight=1, block_rows=8, max_matches=0)
        (full,) = full_server.serve([qs[2]], **CAPS)
        k_server = sess.serve(max_inflight=1, block_rows=8, max_matches=1)
        (first,) = k_server.serve([qs[2]], **CAPS)
        assert full.stats.join_blocks >= 2 and first.n_matches == 1
        assert rows_set(first.rows) <= rows_set(full.rows)
        assert k_server.stats.join_quanta < full_server.stats.join_quanta
        results.append((full_server.stats.as_dict(), k_server.stats.as_dict(),
                        rows_set(full.rows), first.status))
    assert results[0] == results[1]


def test_run_batch_equals_sequential_run_and_the_reference():
    ours = session().run_batch(queries(), max_matches=0, **CAPS)
    ref = jax_session().run_batch(jqueries(), max_matches=0, **CAPS)
    for q, a, b in zip(queries(), ours, ref):
        seq = session().run(q, max_matches=0, **CAPS)
        np.testing.assert_array_equal(a.rows, seq.rows)
        assert a.complete == b.complete == seq.complete
        assert rows_set(a.rows) == rows_set(b.rows)


def test_scheduler_thread_gives_the_synchronous_rows():
    s = session()
    sync = s.serve(**SERVE).serve(queries(), **CAPS)
    with s.serve(**SERVE) as server:
        tickets = [server.submit(q, **CAPS) for q in queries()]
        outs = [t.result(timeout=120) for t in tickets]
    assert server._thread is None  # stopped on exit
    for a, b in zip(sync, outs):
        assert a.status == b.status == "served"
        np.testing.assert_array_equal(a.rows, b.rows)
    assert server.stats.global_degradations == 0


# --------------------------------------------------------------- workload
@pytest.mark.parametrize("seed,n,n_labels", [(0, 8, 4), (1, 12, 4), (2, 9, 3)])
def test_mixed_workload_draws_the_reference_list(seed, n, n_labels):
    ours = mixed_workload(graph(), n, n_labels=n_labels, rng=np.random.default_rng(seed))
    ref = j_mixed_workload(jgen.rmat(*GRAPH, **KW), n, n_labels=n_labels,
                           rng=np.random.default_rng(seed))
    assert [(list(q.labels), list(q.edges)) for q in ours] == [
        (list(q.labels), list(q.edges)) for q in ref]


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [
    ["--arch", "stwig", "--n-queries", "4", "--max-nodes", "300"],
    ["--arch", "gemma-2b", "--tokens", "2", "--batch", "2"],
], ids=["stwig", "gemma-2b"])
def test_launcher_serves_on_the_cpu(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(argv + ["--device", "cpu"])
    last = out.getvalue().strip().splitlines()[-1]
    if argv[1] == "stwig":
        assert "served /" in last and "0 failed" in last and "0 global degradations" in last
        assert "'torch' on cpu" in last
    else:
        assert last.startswith("decoded 2 tokens × batch 2") and "on cpu" in last
