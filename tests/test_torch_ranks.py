"""The one-shard-a-process path on gloo ranks on the CPU, against the JAX
package: the rank collectives (`repro_torch.core.rank_collectives`) against
``repro.core.collectives`` run under ``jax.vmap`` with a named axis, bit for
bit, at S = 2, 3, 4 and 8 with words whose bit 31 is set; the rank engine
(`GraphSession.open(pg, mesh=...)`, S = 4) shard by shard against the
stacked engine's slice (tables, OR'd contributions, joins over both
fetches), its rows, pages, truncation and chaos outcomes against the
stacked engine's, the JAX local engine's and the networkx oracle's;
`compressed_psum` and `gpipe` against ``repro.optim.compression`` and
``repro.launch.pipeline``'s sequential reference; `spawn_ranks` itself.

Each case group is one `spawn_ranks` call (the rank functions live in
``tests/rank_fns.py``, which imports no JAX); the parent holds their
results against the JAX package in process."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("networkx")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rank_fns  # noqa: E402
from helpers import nx_oracle  # noqa: E402
from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.launch.pipeline import bubble_fraction as jbubble  # noqa: E402
from repro.optim.compression import EFState as JEFState  # noqa: E402
from repro.optim.compression import compressed_psum as jcompressed_psum  # noqa: E402
from repro_torch.analysis.staticcheck import collective_safety, engines  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.core.dist import _schemas, ring_radii_for  # noqa: E402
from repro_torch.core.result import MatchStats  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.cluster_graph import ClusterGraphIndex  # noqa: E402
from repro_torch.graphstore.partition import PartitionedGraph  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    bubble_fraction,
    make_host_mesh,
    make_production_mesh,
    spawn_ranks,
)
from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy  # noqa: E402
from repro_torch.workloads import dfs_query, path_query  # noqa: E402

SEED = 5
CAPS = dict(child_cap=6, emission_budget=256, join_rows_cap=512, join_dup_cap=8)
# (key, generator, args, seed, partition mode): an R-MAT in hash shards, a
# ring of cliques in range shards (whose load sets really ring)
GRAPHS = [("rmat", "rmat", (1500, 5000, 24), 1, "hash"),
          ("ring", "ring_of_cliques", (40, 6, 4), 2, "range")]
S_ENGINE = 4


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


def as_np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def jax_vmap(f, *args):
    return jax.vmap(f, axis_name="data")(*[jnp.asarray(a) for a in args])


# ------------------------------------------------------------ collectives
SIZES = (2, 3, 4, 8)


@functools.lru_cache(maxsize=None)
def world_run():
    """One spawn of 8 ranks: groups of the first 2, 3, 4 and all 8."""
    return spawn_ranks(rank_fns.collectives_rank, SIZES[-1], SIZES, SEED, timeout=300)


def collectives_run(S):
    return [r[S] for r in world_run()[:S]]


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_reductions_equal_reference(S):
    res = collectives_run(S)
    inp = rank_fns.collective_inputs(S, SEED + S)
    want_or = jax_vmap(lambda w: jcoll.or_allreduce(w, "data"), inp["words"])
    want_any = jax_vmap(lambda f: jcoll.bool_allreduce_any(f, "data"), inp["flags"])
    want_max = jax_vmap(lambda w: jax.lax.pmax(w, "data"), inp["words"])
    assert (inp["words"] < 0).any()  # bit 31 travels
    for k, r in enumerate(res):
        np.testing.assert_array_equal(r["or"], as_np(want_or[k]), err_msg=f"rank {k}")
        np.testing.assert_array_equal(r["pmax"], as_np(want_max[k]))
        np.testing.assert_array_equal(r["any"], np.asarray(want_any[k]))
        np.testing.assert_array_equal(r["pmax_bool"], inp["flags"].any(axis=0))
    assert all(r["sources_built"] == 0 for r in world_run())  # no rank builds a kernel


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_load_set_fetches_equal_reference(S):
    res = collectives_run(S)
    inp = rank_fns.collective_inputs(S, SEED + S)
    args = (inp["cols"], inp["valid"], inp["load"])
    jc, jv = jax_vmap(lambda c, v, l: jcoll.gather_load_set(c, v, l, "data"), *args)
    for k, r in enumerate(res):
        np.testing.assert_array_equal(r["gather"][0], as_np(jc[k]))
        np.testing.assert_array_equal(r["gather"][1], np.asarray(jv[k]))
    for radius in (1, 2):
        jc, jv = jax_vmap(
            lambda c, v, l: jcoll.gather_load_set_ring(c, v, l, "data", radius), *args)
        h = min(radius, (S - 1) // 2)
        for k, r in enumerate(res):
            c, v = r[f"ring{radius}"]
            assert c.shape == ((2 * h + 1) * inp["cols"].shape[1], inp["cols"].shape[2])
            np.testing.assert_array_equal(c, as_np(jc[k]), err_msg=f"radius {radius} rank {k}")
            np.testing.assert_array_equal(v, np.asarray(jv[k]))


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_compressed_psum_equals_reference(S):
    res = collectives_run(S)
    inp = rank_fns.collective_inputs(S, SEED + S)

    def ref(g, e):
        out, ef = jcompressed_psum(g, JEFState(e), "data")
        x = g + e
        scale = jax.lax.pmax(jnp.maximum(jnp.max(jnp.abs(x)) / 127.0, 1e-12), "data")
        q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
        return out, ef.error, q

    out, err, q = jax_vmap(ref, inp["grad"], inp["ef"])
    tol = 1e-6 * float(np.abs(inp["grad"] + inp["ef"]).max())
    for k, r in enumerate(res):
        got_out, got_err, got_q = r["psum"]
        np.testing.assert_array_equal(got_q, np.asarray(q[k]))  # the int8 payload
        np.testing.assert_allclose(got_out, np.asarray(out[k]), rtol=0, atol=tol)
        np.testing.assert_allclose(got_err, np.asarray(err[k]), rtol=0, atol=tol)


def test_error_feedback_constant_gradient_on_four_ranks():
    """The JAX test's case: a constant gradient stream, compressed with
    error feedback, sums to the true total within two quantization steps —
    here on 4 ranks, each with the same gradient (so the mean is it)."""
    g = rank_fns.collective_inputs(4, SEED + 4)["const_grad"]
    for r in collectives_run(4):
        np.testing.assert_allclose(r["ef_total"], g * rank_fns.EF_STEPS,
                                   atol=2 * float(np.abs(g).max()) / 127)


@pytest.mark.parametrize("S", [2, 4])
def test_gpipe_equals_sequential(S):
    inp = rank_fns.collective_inputs(S, SEED + S)
    want = jnp.asarray(inp["x"])
    for s in range(S):
        want = jnp.tanh(want @ jnp.asarray(inp["ws"][s]))
    for r in world_run():  # every pipeline of the (8 / S, S) mesh
        np.testing.assert_allclose(r["gpipe", S], np.asarray(want), rtol=0, atol=1e-5)


def test_bubble_fraction_and_mesh_axis_sizes_equal_reference():
    for S, M in [(2, 4), (1, 8), (4, 32), (4, 4), (16, 3)]:
        assert bubble_fraction(S, M) == jbubble(S, M)
    # the host mesh's dim, then (pod, data·pod, pod·absent) of the (4, 2)
    # and (2, 4) meshes: a name the mesh lacks counts 1, as in the reference
    for r in world_run():
        assert r["axis_sizes"] == [8, 2, 8, 2, 4, 8, 4]


# ----------------------------------------------------------- the engine
@functools.lru_cache(maxsize=None)
def graph(key):
    _, kind, args, seed, mode = next(g for g in GRAPHS if g[0] == key)
    return getattr(jgen, kind)(*args, seed=seed), getattr(generators, kind)(*args, seed=seed)


@functools.lru_cache(maxsize=None)
def partition(key):
    mode = next(g for g in GRAPHS if g[0] == key)[4]
    return PartitionedGraph.build(graph(key)[1], S_ENGINE, mode=mode)


@functools.lru_cache(maxsize=None)
def queries(key, n=2, seed=0):
    """A DFS query, then a 4-node path (≥ 2 STwigs: joins and fetches)."""
    _, g = graph(key)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        q = dfs_query(g, rng, 4) if len(out) < n - 1 else path_query(g, rng, 4)
        if q is not None:
            out.append(q)
    return tuple(out)


def chaos_queries():
    _, g = graph("rmat")
    rng = np.random.default_rng(3)
    out = []
    while len(out) < 2:
        q = dfs_query(g, rng, 3)
        if q is not None:
            out.append(q)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def engine_run():
    cases = [(key, partition(key), queries(key)) for key, *_ in GRAPHS]
    return spawn_ranks(rank_fns.engine_rank, S_ENGINE, cases, CAPS,
                       (partition("rmat"), chaos_queries(), CAPS), timeout=600)


@functools.lru_cache(maxsize=None)
def stacked(key):
    return GraphSession.open(partition(key), device="cpu", kernels="torch")


def stacked_explore(eng, plan):
    ors = []

    def hook(name, operands, result, info):
        if name == "or_allreduce":
            ors.append(result.numpy())

    coll.recorder = hook
    try:
        stats = MatchStats(backend="sharded", n_shards=S_ENGINE)
        all_cols, all_valids, _ = eng._explore(plan, stats)
    finally:
        coll.recorder = None
    return all_cols, all_valids, ors, stats


@pytest.mark.parametrize("key", [g[0] for g in GRAPHS])
def test_rank_tables_and_joins_equal_stacked_slices(key):
    res = engine_run()
    eng = stacked(key).engine
    n_joins = n_ring = 0
    for i, q in enumerate(queries(key)):
        plan = eng.plan(q, root_cap=1, **CAPS)  # a root a round: several rounds
        all_cols, all_valids, ors, stats = stacked_explore(eng, plan)
        for k, r in enumerate(res):
            mine = r[key][i]
            for t in range(len(plan.specs)):
                np.testing.assert_array_equal(mine["cols"][t], all_cols[t][k].numpy())
                np.testing.assert_array_equal(mine["valids"][t], all_valids[t][k].numpy())
            assert len(mine["ors"]) == len(ors) and sum(stats.rounds) == len(ors)
            for a, b in zip(mine["ors"], ors):
                np.testing.assert_array_equal(a, b)  # every round's OR'd contribution
            assert mine["stwig_rows"] == stats.stwig_rows
        if len(plan.specs) < 2:
            continue
        load, load_masks = eng._load_masks(q, plan)
        schemas = _schemas(plan)
        order = tjoin.select_join_order(list(schemas), stats.stwig_rows)
        for ring in (False, True):
            radii = ring_radii_for(load) if ring else None
            if ring and radii is None:
                continue
            fetched = eng._fetch(all_cols, all_valids, load_masks, plan.head, radii)
            for k, r in enumerate(res):
                acc, _ = eng._join_shard(k, all_cols, all_valids, fetched, schemas, order, plan)
                cols, valid = r[key][i]["joins"][ring]
                np.testing.assert_array_equal(cols, acc.cols.numpy())
                np.testing.assert_array_equal(valid, acc.valid.numpy())
                n_joins += 1
                n_ring += ring
    assert n_joins > 0
    assert key != "ring" or n_ring > 0  # the range-partitioned ring really rings


@functools.lru_cache(maxsize=None)
def local_reference(key):
    """The JAX local engine's rows (``kernels="jnp"``) and completeness."""
    g_ref, _ = graph(key)
    s = JGraphSession.open(g_ref, backend="local", kernels="jnp")
    return [(rows_set(r.rows), r.complete) for r in (
        s.run(JQueryGraph.build(list(q.labels), list(q.edges)), max_matches=0, **CAPS)
        for q in queries(key))]


@pytest.mark.parametrize("key", [g[0] for g in GRAPHS])
def test_rank_rows_equal_stacked_local_reference_and_oracle(key):
    res = engine_run()
    session = stacked(key)
    n_complete = 0
    for i, (q, (want, want_complete)) in enumerate(zip(queries(key), local_reference(key))):
        for ring in (False, True):
            compiled = session.compile(q, max_matches=0, **CAPS)
            full = compiled.run(use_ring=ring)
            first = compiled.run(max_matches=5, use_ring=ring)
            once = compiled.run(adaptive=False, use_ring=ring)
            pages = list(compiled.stream(page_size=7, block_rows=16, use_ring=ring))
            for k, r in enumerate(res):
                got = r[key][i]["runs"][ring]
                # the stacked engine's rows, in its order, on every rank
                np.testing.assert_array_equal(got["rows"], full.rows, err_msg=f"rank {k}")
                np.testing.assert_array_equal(got["first"], first.rows)
                np.testing.assert_array_equal(got["once"], once.rows)
                assert (got["complete"], got["once_complete"]) == (full.complete, once.complete)
                assert got["n_shards"] == S_ENGINE
                assert got["health"] == {j: "ok" for j in range(S_ENGINE)}
                assert len(got["pages"]) == len(pages)
                for (rows, complete), p in zip(got["pages"], pages):
                    np.testing.assert_array_equal(rows, p.rows)
                    assert complete == p.complete
            rows = res[0][key][i]["runs"][ring]
            assert len(rows_set(rows["rows"])) == len(rows["rows"])  # disjoint shards
            assert (rows_set(rows["rows"]), rows["complete"]) == (want, want_complete)
            np.testing.assert_array_equal(rows["first"], rows["rows"][:5])
            streamed = [tuple(x) for p, _ in rows["pages"] for x in p.tolist()]
            assert len(streamed) == len(set(streamed))
            assert set(streamed) == rows_set(rows["once"])
            if want_complete and not ring:
                n_complete += 1
                assert want == nx_oracle(graph(key)[1], q)
    assert n_complete >= 1


def test_early_stopped_stream_skips_block_joins_on_every_rank():
    res = engine_run()
    n_full, blocks, n_early, early_rows = res[0]["stream_stop"]
    assert n_full >= 3 and blocks == n_full
    assert n_early < n_full and early_rows == 1
    assert all(r["stream_stop"] == res[0]["stream_stop"] for r in res)


def test_cluster_index_is_built_on_rank_zero_and_received_by_the_others():
    res = engine_run()
    assert res[0]["cgi_builds"] > 0
    assert all(r["cgi_builds"] == 0 for r in res[1:])
    for key, *_ in GRAPHS:
        want = ClusterGraphIndex.build(partition(key)).pair_index
        for k, r in enumerate(res):
            got = r["cgi", key]
            assert sorted(got) == sorted(want), (key, k)
            for pair, shards in want.items():
                np.testing.assert_array_equal(got[pair], shards, err_msg=f"{key} rank {k}")


def test_chaos_outcomes_equal_stacked():
    res = engine_run()
    pg = partition("rmat")
    for what, kw in rank_fns.CHAOS_FAULTS.items():
        for i, q in enumerate(chaos_queries()):
            s = GraphSession.open(pg, device="cpu", kernels="torch",
                                  chaos=ChaosInjector(ChaosConfig(seed=0, **kw)))
            want = s.run(q, max_matches=0, adaptive=False, retry_policy=RetryPolicy(), **CAPS)
            for k, r in enumerate(res):
                rows, complete, reason, health, retries = r["chaos"][what][i]
                np.testing.assert_array_equal(rows, want.rows, err_msg=f"{what} rank {k}")
                assert (complete, reason, health, retries) == (
                    want.complete, want.stats.degrade_reason, want.stats.shard_health,
                    want.stats.fetch_retries), what
            if what in ("dead", "truncated"):
                assert not want.complete and want.stats.degrade_reason == "shard-fault"


def test_rank_probe_is_clean_and_refusals_name_their_cause():
    res = engine_run()
    assert engines.check_rank_probes([r["probe"] for r in res]) == []
    seq = res[0]["probe"]["sequence"]
    names = {n for n, _ in seq}
    assert {"or_allreduce", "pmax", "bool_allreduce_any", "gather_load_set",
            "gather_rows"} <= names and {g for _, g in seq} == {S_ENGINE}
    wrong, serve, run_deadline, stream_deadline = res[0]["refusals"]
    assert wrong.startswith("ValueError") and "one shard a rank" in wrong
    assert serve.startswith("NotImplementedError") and "ROADMAP.md" in serve
    assert "deadline" in run_deadline and "deadline" in stream_deadline
    assert all(r["sources_built"] == 0 for r in res)


def test_rank_sequences_divergence_and_rank_form_planted():
    seq = [("or_allreduce", 4), ("pmax", 4)]
    assert collective_safety.check_rank_sequences([seq, seq], "t") == []
    fs = collective_safety.check_rank_sequences([seq, seq[:1]], "t")
    assert [f.rule for f in fs] == ["coll-divergent-control"] and "rank 1" in fs[0].message
    cols, valid = torch.zeros(3, 2, dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    with collective_safety.Recording(4) as rec:
        coll._note("gather_load_set", {"cols": cols, "valid": valid,
                                       "load": torch.ones(4, dtype=torch.bool)},
                   (cols, valid), group_size=3, rank=0)
        coll._note("gather_load_set_ring", {"cols": cols.clone(), "valid": valid,
                                            "load": torch.ones(4, dtype=torch.bool)},
                   (cols, valid), group_size=4, rank=0,
                   sources=(torch.tensor([3, 3, 1, 2]),))
        rec.taint(cols)
        coll._note("fetch_load_set", {"cols": cols + 0, "valid": valid,
                                      "load": torch.ones(4, dtype=torch.bool)},
                   (cols, valid), group_size=4, rank=0)
    rules = sorted(f.rule for f in collective_safety.check(rec, "t"))
    assert rules == ["coll-axis-name", "coll-head-gather", "coll-ppermute-bijection"]


# ------------------------------------------------------ spawn and meshes
def test_spawn_ranks_names_the_rank_that_raised():
    with pytest.raises(RuntimeError, match=r"rank 1 raised:(.|\n)*fails on purpose"):
        spawn_ranks(rank_fns.failing_rank, 3, 1, timeout=120)


def test_meshes_outside_a_world_and_saved_partitions(tmp_path):
    with pytest.raises(ValueError, match=r"'data': 16, 'model': 16.*256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match=r"'pod': 2.*512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_host_mesh(4)
    pg = partition("rmat")
    pg.save(tmp_path / "pg")
    back = PartitionedGraph.load(tmp_path / "pg")
    for f in ("labels", "indptr", "indices", "all_labels", "freq", "new_to_old"):
        np.testing.assert_array_equal(getattr(back, f), getattr(pg, f))
    assert (back.n_shards, back.cap, back.edge_cap) == (pg.n_shards, pg.cap, pg.edge_cap)
