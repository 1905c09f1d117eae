"""Seeded fault injection in the port (``repro_torch.runtime.chaos``) on the
CPU, against the JAX package: the injector draws the reference's events,
delays and heal points; `ChaosKernels` delegates every op of the port's
`Kernels`; and under each fault (dead shard, healed shard, truncated
fetch, slow shard, forced overflow) the engines return the typed partial
result the reference returns — rows held to ``helpers.nx_oracle`` and to
the JAX local engine's (``kernels="jnp"``), the sharded engine at S = 4 in
process. JAX runs only queries of one STwig here: its join steps compile
for minutes on the CPU at these capacities."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("networkx")

from helpers import nx_oracle  # noqa: E402
from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import resilience as jres  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core.backend import OP_CONTRACTS, Kernels  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.partition import PartitionedGraph, shard_of  # noqa: E402
from repro_torch.runtime import resilience  # noqa: E402
from repro_torch.runtime.chaos import (  # noqa: E402
    ChaosConfig,
    ChaosInjector,
    ChaosKernels,
    ShardFaultError,
)
from repro_torch.workloads import dfs_query, path_query  # noqa: E402

S = 4
# the JAX package's chaos suite graph; caps at which every clean run here
# is complete (the join caps only matter to the port's path query)
CAPS = dict(child_cap=32, emission_budget=512, join_rows_cap=1024, join_dup_cap=8)
NO_WAIT = resilience.RetryPolicy(fetch_backoff_s=0.0)


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


@functools.lru_cache(maxsize=None)
def graph():
    return generators.rmat(120, 480, 4, seed=3, symmetrize=True)


@functools.lru_cache(maxsize=None)
def queries():
    """A 3-node DFS query (one STwig) and a 4-node path (two STwigs: a
    fetch and a join)."""
    g = graph()
    star = dfs_query(g, np.random.default_rng(5), 3)
    rng, path = np.random.default_rng(1), None
    while path is None:
        path = path_query(g, rng, 4)
    return star, path


@functools.lru_cache(maxsize=None)
def oracle(i):
    return frozenset(nx_oracle(graph(), queries()[i]))


@functools.lru_cache(maxsize=None)
def jax_session():
    return JGraphSession.open(jgen.rmat(120, 480, 4, seed=3, symmetrize=True),
                              backend="local", kernels="jnp")


@functools.lru_cache(maxsize=None)
def jax_session_chaos():
    return JGraphSession.open(jgen.rmat(120, 480, 4, seed=3, symmetrize=True), backend="local",
                              kernels="jnp", chaos=jchaos.ChaosInjector(force_overflow=True))


def jquery(q):
    return JQueryGraph.build(list(q.labels), list(q.edges))


@functools.lru_cache(maxsize=None)
def jax_rows(i):
    res = jax_session().run(jquery(queries()[i]), max_matches=0, **CAPS)
    assert res.complete
    return frozenset(rows_set(res.rows))


@functools.lru_cache(maxsize=None)
def partition():
    return PartitionedGraph.build(graph(), S)


def sharded(chaos=None):
    s = GraphSession.open(partition(), device="cpu", chaos=chaos)
    assert s.backend == "sharded"
    return s


def roots(session, q):
    """The query node at each STwig's root: a row lives on the shards that
    own these nodes' data nodes."""
    return [spec.qnodes[0] for spec in session.compile(q, **CAPS).plan.specs]


def on_shard(rows, qnodes, k):
    """The rows some of whose ``qnodes`` map to a data node of shard k."""
    return {r for r in rows if any(shard_of(np.array([r[u]]), S)[0] == k for u in qnodes)}


# ------------------------------------------------------------------ injector
CONFIGS = {
    "slow": dict(seed=9, slow_shard=0, slow_delay_s=0.5),
    "dead": dict(seed=1, dead_shard=2),
    "heals": dict(seed=2, dead_shard=1, dead_heals_after=2),
    "truncated": dict(seed=3, truncate_shard=3, truncate_keep_frac=0.25),
    "all": dict(seed=4, slow_shard=1, dead_shard=0, dead_heals_after=1,
                truncate_shard=2, force_overflow=True),
}


def drive(inj, fault_error):
    """What an engine asks an injector across a few queries, as a list."""
    out = []
    for _ in range(3):
        out.append(inj.fetch_delay())
        out.append([inj.block_delay() for _ in range(4)])
        tries = []
        for _ in range(4):
            try:
                inj.try_fetch()
                tries.append("ok")
            except fault_error as e:
                tries.append(e.shard)
        out.append(tries)
        out.append(inj.truncation())
        out.append(inj.forced_overflow())
    return out, list(inj.events), inj.fetch_attempts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_injector_draws_the_reference_events(name):
    ours = drive(ChaosInjector(ChaosConfig(**CONFIGS[name])), ShardFaultError)
    ref = drive(jchaos.ChaosInjector(jchaos.ChaosConfig(**CONFIGS[name])),
                jchaos.ShardFaultError)
    assert ours == ref
    # the keyword form builds the same config
    assert ChaosInjector(**CONFIGS[name]).config == ChaosConfig(**CONFIGS[name])


# ------------------------------------------------------------------ kernels
KERNEL_OPS = ("bitset_pack", "bitset_unpack", "bitset_lookup", "bitset_build",
              "candidate_filter", "stwig_expand", "hash_join_probe", "cin_layer",
              "segment_mp", "flash_attention", "mask_to_host")


def test_chaos_kernels_override_every_op():
    """Every public op of the port's `Kernels` is on this list and
    overridden by `ChaosKernels`: an op it left to the base class would run
    the plain version under a ``chaos(cuda)`` session."""
    public = {n for n in dir(Kernels) if not n.startswith("_") and callable(getattr(Kernels, n))}
    assert public == set(KERNEL_OPS)
    for op in KERNEL_OPS:
        assert op in vars(ChaosKernels), op


def test_chaos_kernels_delegate_every_op_to_the_inner_backend():
    calls = []

    class Inner(Kernels):
        name = "inner"

    for op in KERNEL_OPS:
        def record(self, *a, _op=op, **kw):
            calls.append(_op)
            return getattr(Kernels, _op)(self, *a, **kw)
        setattr(Inner, op, record)
    inj = ChaosInjector()
    k = inj.wrap_kernels(Inner())
    assert isinstance(k, ChaosKernels) and k.name == "chaos(inner)"
    assert inj.wrap_kernels(k) is k  # no double wrap
    cpu = torch.device("cpu")
    for c in OP_CONTRACTS:
        args, kw = c.make_args(cpu)
        want = getattr(Kernels(), c.op)(*args, **kw)
        got = getattr(k, c.op)(*args, **kw)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), c.op
    mask = torch.arange(70) % 3 == 0
    assert (k.mask_to_host(mask) == mask.numpy()).all()
    assert sorted(calls) == sorted(KERNEL_OPS)
    assert inj.op_calls == {op: 1 for op in KERNEL_OPS}


def test_chaos_name_keys_the_cache_apart():
    g, (q, _) = graph(), queries()
    inj = ChaosInjector(ChaosConfig(seed=0))
    s = GraphSession.open(g, device="cpu", chaos=inj)
    assert s.kernels.name == "chaos(torch)"
    assert rows_set(s.run(q, max_matches=0, **CAPS).rows) == oracle(0) == jax_rows(0)
    assert inj.op_calls["stwig_expand"] > 0 and inj.op_calls["mask_to_host"] > 0
    assert all(key[-1] == "chaos(torch)" for key in s.cache._data)
    clean = GraphSession.open(g, device="cpu")
    assert clean.kernels.name == "torch"
    clean.run(q, max_matches=0, **CAPS)
    assert all(key[-1] == "torch" for key in clean.cache._data)


# ---------------------------------------------------------- sharded faults
@pytest.mark.parametrize("i", [0, 1], ids=["star", "path"])
def test_clean_sharded_run_is_the_oracle(i):
    res = sharded().run(queries()[i], max_matches=0, **CAPS)
    assert res.complete and res.stats.shard_health == {k: "ok" for k in range(S)}
    assert rows_set(res.rows) == oracle(i)
    if i == 0:
        assert oracle(0) == jax_rows(0)


@pytest.mark.parametrize("i", [0, 1], ids=["star", "path"])
def test_dead_shard_degrades_to_the_survivors(i):
    """A shard that never heals: after the policy's fetch retries its rows
    are masked out. A row survives exactly when no STwig root of it lies on
    the dead shard (each shard explores its own roots)."""
    q = queries()[i]
    probe = sharded()
    qroots = roots(probe, q)
    k = shard_of(np.array([sorted(oracle(i))[0][qroots[0]]]), S)[0]  # owns rows
    inj = ChaosInjector(ChaosConfig(seed=0, dead_shard=int(k)))
    s = sharded(inj)
    res = s.run(q, max_matches=0, retry_policy=NO_WAIT, **CAPS)
    got = rows_set(res.rows)
    assert not res.complete and res.stats.degrade_reason == "shard-fault"
    assert res.stats.shard_health[k] == "dead"
    assert res.stats.fetch_retries == NO_WAIT.fetch_retries == 3
    assert res.stats.retries == 0  # not a capacity problem: no escalation
    assert got == oracle(i) - on_shard(oracle(i), qroots, k)
    assert got < oracle(i)
    if i == 0:
        assert got < jax_rows(0)
    assert inj.events == [("dead", k)] * 4
    # the stream degrades every page the same way
    pages = list(s.compile(q, max_matches=0, **CAPS).stream(
        page_size=16, block_rows=16, retry_policy=NO_WAIT))
    assert rows_set(np.concatenate([p.rows for p in pages])) == got
    assert not any(p.complete for p in pages)


def test_dead_shard_that_heals_gives_the_clean_rows():
    q = queries()[1]
    inj = ChaosInjector(ChaosConfig(seed=0, dead_shard=1, dead_heals_after=2))
    res = sharded(inj).run(q, max_matches=0, retry_policy=NO_WAIT, **CAPS)
    assert res.complete and res.stats.degrade_reason is None
    assert res.stats.shard_health[1] == "recovered"
    assert res.stats.fetch_retries == 2
    assert rows_set(res.rows) == oracle(1)
    assert inj.events == [("dead", 1), ("dead", 1), ("healed", 1)]


def test_truncated_fetch_keeps_a_subset():
    """Half of one shard's non-head rows survive the fetch; the head table
    is never fetched, so rows whose non-head roots lie elsewhere all stay."""
    q = queries()[1]
    probe = sharded()
    plan = probe.compile(q, **CAPS).plan
    non_head = [spec.qnodes[0] for t, spec in enumerate(plan.specs) if t != plan.head]
    for k in range(S):
        inj = ChaosInjector(ChaosConfig(seed=0, truncate_shard=k, truncate_keep_frac=0.5))
        res = sharded(inj).run(q, max_matches=0, **CAPS)
        got = rows_set(res.rows)
        assert not res.complete and res.stats.degrade_reason == "shard-fault"
        assert res.stats.shard_health[k] == "truncated"
        assert oracle(1) - on_shard(oracle(1), non_head, k) <= got <= oracle(1)


def test_slow_shard_delays_but_keeps_every_row():
    inj = ChaosInjector(ChaosConfig(seed=0, slow_shard=2, slow_delay_s=0.001))
    s = sharded(inj)
    for i, q in enumerate(queries()):
        res = s.run(q, max_matches=0, **CAPS)
        assert res.complete and res.stats.degrade_reason is None
        assert res.stats.shard_health[2] == "slow"
        assert rows_set(res.rows) == oracle(i)
    pages = list(s.compile(queries()[1], max_matches=0, **CAPS).stream(page_size=8, block_rows=8))
    assert rows_set(np.concatenate([p.rows for p in pages])) == oracle(1)
    assert all(p.complete for p in pages)
    assert ("slow", 2) in inj.events


def test_forced_overflow_on_the_sharded_engine():
    inj = ChaosInjector(ChaosConfig(seed=0, force_overflow=True))
    res = sharded(inj).run(queries()[0], max_matches=0,
                           retry_policy=resilience.RetryPolicy(ceiling_bytes=1.0), **CAPS)
    assert not res.complete and res.stats.degrade_reason == "overflow-ceiling"
    assert res.stats.retries == 0
    assert rows_set(res.rows) == jax_rows(0)


# ------------------------------------------------------------ _mask_shard
def mask_shard_reference(all_valids, shard, head_pos=None, keep_frac=None):
    """``src/repro/core/dist.py`` ``_mask_shard`` (lines 780-805) in numpy,
    without the device round trip."""
    out = []
    for i, v in enumerate(all_valids):
        if keep_frac is not None and i == head_pos:
            out.append(v)
            continue
        vh = np.array(v)
        if keep_frac is None:
            vh[shard] = False
        else:
            vh[shard, int(keep_frac * vh.shape[1]):] = False
        out.append(vh)
    return out


@pytest.mark.parametrize("shard,head_pos,keep_frac", [
    (0, None, None), (3, 1, None), (2, 0, 0.5), (1, 2, 0.25), (3, 1, 0.0), (0, 0, 1.0),
    (2, 1, 0.3),
])
def test_mask_shard_matches_the_reference(shard, head_pos, keep_frac):
    rng = np.random.default_rng(shard * 7 + (head_pos or 0))
    valids = [rng.random((S, cap)) < 0.7 for cap in (13, 64, 7)]
    before = [v.copy() for v in valids]
    want = mask_shard_reference(valids, shard, head_pos, keep_frac)
    tensors = [torch.from_numpy(v.copy()) for v in valids]
    engine = sharded().engine
    got = engine._mask_shard(tensors, shard, head_pos=head_pos, keep_frac=keep_frac)
    for g_, w, t, b in zip(got, want, tensors, before):
        np.testing.assert_array_equal(g_.numpy(), w)
        np.testing.assert_array_equal(t.numpy(), b)  # the inputs are not written


# ---------------------------------------------------------- forced overflow
def test_forced_overflow_first_result_is_final_under_a_tiny_ceiling():
    q = queries()[0]
    inj = ChaosInjector(ChaosConfig(seed=0, force_overflow=True))
    ours = GraphSession.open(graph(), device="cpu", chaos=inj).run(
        q, max_matches=0, retry_policy=resilience.RetryPolicy(ceiling_bytes=1.0), **CAPS)
    ref = JGraphSession.open(jgen.rmat(120, 480, 4, seed=3, symmetrize=True), backend="local",
                             kernels="jnp", chaos=jchaos.ChaosInjector(force_overflow=True)).run(
        jquery(q), max_matches=0, retry_policy=jres.RetryPolicy(ceiling_bytes=1.0), **CAPS)
    for res in (ours, ref):
        assert not res.complete and res.stats.degrade_reason == "overflow-ceiling"
        assert res.stats.retries == 0
    assert rows_set(ours.rows) == rows_set(ref.rows) == oracle(0)


def test_forced_overflow_escalates_twice_then_stops_like_the_reference():
    """Both packages escalate under a ceiling between their estimates of
    the second and the third grown caps: two escalations, then
    ``"overflow-ceiling"``, the same final caps and rows."""
    seed = {k: CAPS[k] for k in ("child_cap", "join_rows_cap", "join_dup_cap")}
    grown, estimates = dict(seed), []
    for _ in range(3):
        grown = resilience.grow_caps(grown)
        estimates.append((resilience.plan_caps_bytes(grown), jres.plan_caps_bytes(grown)))
    lo, hi = max(estimates[1]), min(estimates[2])
    assert lo < hi
    ceiling = math.sqrt(lo * hi)
    q = queries()[0]
    ours = GraphSession.open(graph(), device="cpu",
                             chaos=ChaosInjector(force_overflow=True)).run(
        q, max_matches=0, retry_policy=resilience.RetryPolicy(ceiling_bytes=ceiling), **CAPS)
    ref = jax_session_chaos().run(
        jquery(q), max_matches=0, retry_policy=jres.RetryPolicy(ceiling_bytes=ceiling), **CAPS)
    for res in (ours, ref):
        assert not res.complete and res.stats.degrade_reason == "overflow-ceiling"
        assert res.stats.retries == 2
    assert ours.stats.final_caps == ref.stats.final_caps
    assert rows_set(ours.rows) == rows_set(ref.rows) == oracle(0)


def test_retry_ceiling_reads_a_budgets_dict_like_the_reference():
    assert resilience.retry_ceiling_bytes() == resilience.MEMORY_CEILING_BYTES
    assert resilience.retry_ceiling_bytes() == jres.retry_ceiling_bytes()  # budgets.json
    for budgets in ({"retry": {"memory_ceiling_bytes": 5e9}}, {"retry": {"memory_ceiling_bytes": 1}}):
        assert resilience.retry_ceiling_bytes(budgets) == jres.retry_ceiling_bytes(budgets)
    ours, ref = resilience.RetryPolicy(), jres.RetryPolicy()
    assert (ours.fetch_retries, ours.fetch_backoff_s) == (ref.fetch_retries, ref.fetch_backoff_s)
    assert ours.ceiling() == ref.ceiling()
    # seeded backoff: the fetch loop's sleeps are the reference's
    a, b = resilience.RetryPolicy(seed=5), jres.RetryPolicy(seed=5)
    assert [a.backoff(i, a.fetch_backoff_s) for i in range(4)] == [
        b.backoff(i, b.fetch_backoff_s) for i in range(4)]
