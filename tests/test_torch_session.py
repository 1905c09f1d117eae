"""The port's local query path end to end on the CPU: `GraphSession.open(g,
device="cpu")` against the JAX package's ``GraphSession.open(g,
kernels="jnp")`` and the networkx oracle, on three R-MAT graphs of at most
2,000 nodes with four queries each (two DFS queries, two 4-node paths)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("networkx")

from helpers import nx_oracle  # noqa: E402
from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.runtime.resilience import join_cost_bytes as j_join_cost_bytes  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.runtime.resilience import (  # noqa: E402
    MEMORY_CEILING_BYTES,
    RetryPolicy,
    grow_caps,
    join_cost_bytes,
)
from repro_torch.workloads import dfs_query, path_query  # noqa: E402

GRAPHS = {"n300": (300, 1100, 10, 0), "n900": (900, 3600, 20, 1), "n2000": (2000, 7000, 40, 2)}
# small caps keep the JAX side's compiles short; overflow escalates on both sides
CAPS = dict(child_cap=8, emission_budget=512, join_rows_cap=512, join_dup_cap=8)


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


@functools.lru_cache(maxsize=None)
def workload(name):
    n, m, labels, seed = GRAPHS[name]
    g = generators.rmat(n, m, labels, seed=seed)
    rng = np.random.default_rng(seed)
    qs = []
    while len(qs) < 4:  # two DFS queries, two 4-node paths (≥2 STwigs: joins)
        q = dfs_query(g, rng, 4) if len(qs) < 2 else path_query(g, rng, 4)
        if q is not None:
            qs.append(q)
    return g, qs


@functools.lru_cache(maxsize=None)
def reference_rows(name):
    n, m, labels, seed = GRAPHS[name]
    g = jgen.rmat(n, m, labels, seed=seed)
    s = JGraphSession.open(g, backend="local", kernels="jnp")
    out = []
    for q in workload(name)[1]:
        res = s.run(JQueryGraph.build(list(q.labels), list(q.edges)), max_matches=0, **CAPS)
        out.append((rows_set(res.rows), res.complete))
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_run_and_stream_match_reference_and_oracle(name):
    g, qs = workload(name)
    session = GraphSession.open(g, device="cpu")
    assert session.kernels.name == "torch"
    n_complete = 0
    for q, (want, want_complete) in zip(qs, reference_rows(name)):
        compiled = session.compile(q, max_matches=0, **CAPS)
        res = compiled.run()
        got = rows_set(res.rows)
        assert (got, res.complete) == (want, want_complete)
        assert res.n_matches == len(res.rows) == len(got)  # distinct embeddings
        if res.complete:
            n_complete += 1
            assert got == nx_oracle(g, q)
        # stream never escalates caps: it equals the non-adaptive run, in
        # disjoint pages; when that run is complete it is the full set
        once = compiled.run(adaptive=False)
        pages = list(compiled.stream(page_size=7, block_rows=16))
        streamed = [tuple(r) for p in pages for r in p.rows.tolist()]
        assert len(streamed) == len(set(streamed))
        assert set(streamed) == rows_set(once.rows)
        assert all(p.complete for p in pages) == once.complete
        if once.complete:
            assert set(streamed) == got
            # first-K: a subset of the full set of size min(K, total)
            first = compiled.run(max_matches=5, adaptive=False)
            assert rows_set(first.rows) <= got
            assert first.n_matches == min(5, len(got))
    assert n_complete >= 3


def test_early_stopped_stream_skips_block_joins():
    g, _ = workload("n2000")
    session = GraphSession.open(g, device="cpu")
    rng = np.random.default_rng(5)
    best = None
    while best is None:  # a query whose blocked table spans several blocks
        q = dfs_query(g, rng, 3)
        if q is None:
            continue
        compiled = session.compile(q, max_matches=0, **CAPS)
        before = session.engine.join_block_calls
        pages = list(compiled.stream(page_size=4, block_rows=4))
        if session.engine.join_block_calls - before >= 3:
            best, full_calls = compiled, session.engine.join_block_calls - before
    before = session.engine.join_block_calls
    early = list(best.stream(page_size=4, block_rows=4, max_matches=1))
    assert sum(p.n_rows for p in early) == 1
    assert session.engine.join_block_calls - before < full_calls
    assert len(pages) > 1


def test_cuda_backend_on_cpu_tensors_runs_plain_versions():
    g, qs = workload("n300")
    session = GraphSession.open(g, device="cpu", kernels="cuda")
    assert session.kernels.name == "cuda"
    res = session.run(qs[1], max_matches=0, **CAPS)
    assert rows_set(res.rows) == reference_rows("n300")[1][0]
    # switching backends keys new cache entries and changes no row
    misses = session.cache.misses
    session.set_kernels("torch")
    assert rows_set(session.run(qs[1], max_matches=0, **CAPS).rows) == rows_set(res.rows)
    assert session.cache.misses > misses


def test_open_without_device_raises_without_a_gpu(monkeypatch):
    g, _ = workload("n300")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open(g, device="cuda")


def test_join_estimate_grows_with_caps_and_tracks_reference():
    caps = {"join_rows_cap": 1 << 16, "join_dup_cap": 64}
    prev = join_cost_bytes(caps["join_rows_cap"], caps["join_dup_cap"])
    for _ in range(3):
        caps = grow_caps(caps)
        est = join_cost_bytes(caps["join_rows_cap"], caps["join_dup_cap"])
        assert 3.5 < est / prev < 4.5  # ∝ join_rows_cap × join_dup_cap
        prev = est
    for rows, dup in [(1024, 8), (1 << 16, 64)]:
        ratio = join_cost_bytes(rows, dup) / j_join_cost_bytes(rows, dup)
        assert 0.5 < ratio < 2.0, ratio
    # the ceiling refuses growth before an estimate passes it
    grown, reason = RetryPolicy().next_caps({"join_rows_cap": 1 << 20, "join_dup_cap": 256})
    assert grown is None and reason == "overflow-ceiling"
    assert MEMORY_CEILING_BYTES == 16e9
