"""Seeded-violation suite for the port's `repro_torch.analysis.staticcheck`,
case for case with the JAX package's ``tests/test_staticcheck.py`` where a
rule has a counterpart: every rule fires on a planted violation and stays
silent on the repo; `run_all` on the CPU gives no finding; the registries
(architectures, kernel backends) are the JAX package's; the cost model's
FLOPs agree with the JAX cost model's on the same shapes."""
import dataclasses
import pathlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.analysis.staticcheck import costmodel as jcostmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis.staticcheck import (  # noqa: E402
    RULES,
    archlint,
    cachekeys,
    collective_safety,
    contracts,
    costmodel,
    engines,
    oplog,
    report_json,
    run_all,
)
from repro_torch.core import backend as backend_lib  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.backend import OpContract  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rules_of(findings):
    return {f.rule for f in findings}


def _write(root: pathlib.Path, rel: str, body: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))


def _lint(root, rule_id):
    return [f for f in archlint.run(str(root)) if f.rule == rule_id]


@pytest.fixture()
def fixture_repo(tmp_path):
    """A minimal repo skeleton the AST passes can walk."""
    _write(tmp_path, "src/repro_torch/__init__.py", "")
    _write(tmp_path, "src/repro_torch/core/__init__.py", "")
    _write(tmp_path, "tests/test_ok.py", "import repro_torch.core\n")
    return tmp_path


# ------------------------------------------------------------ archlint rules
def test_bitset_twiddling_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/twiddle.py", """\
        def word_of(i):
            return i >> 5, i & 31, i % 32
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.twiddle\n")
    fs = _lint(fixture_repo, "bitset-twiddling")
    assert len(fs) == 3 and all("twiddle.py" in f.path for f in fs)


def test_bitset_twiddling_allowed_in_kernels_bitset(fixture_repo):
    _write(fixture_repo, "src/repro_torch/kernels/__init__.py", "")
    _write(fixture_repo, "src/repro_torch/kernels/bitset/__init__.py", "")
    _write(fixture_repo, "src/repro_torch/kernels/bitset/impl.py", """\
        def word_of(i):
            return i >> 5
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.kernels.bitset.impl\n")
    assert not _lint(fixture_repo, "bitset-twiddling")


def test_module_jit_state_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/jitstate.py", """\
        import functools
        import torch

        @functools.lru_cache(maxsize=None)
        def build(n):
            return n

        square = torch.compile(lambda x: x * x)
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.jitstate\n")
    assert len(_lint(fixture_repo, "module-jit-state")) == 2  # decorator AND import-time compile


def test_direct_engine_construction_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/sneaky.py", """\
        from repro_torch.core.engine import SubgraphMatcher

        def make(pg):
            return SubgraphMatcher(pg, device="cpu")
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.sneaky\n")
    fs = _lint(fixture_repo, "direct-engine-construction")
    assert len(fs) == 1 and fs[0].line == 4


@pytest.mark.parametrize("call", ["page.rows_dev.cpu()", "n.item()", "torch.cuda.synchronize()"])
def test_stream_host_sync_planted(fixture_repo, call):
    _write(fixture_repo, "src/repro_torch/core/consumer.py", f"""\
        import torch

        def drain(compiled, n):
            out = []
            for page in compiled.stream(page_size=8):
                out.append({call})
            return out
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.consumer\n")
    assert len(_lint(fixture_repo, "stream-host-sync")) == 1


def test_stream_host_sync_reads_chip_smoke(fixture_repo):
    _write(fixture_repo, "chip_smoke.py", """\
        def main(compiled):
            for page in compiled.stream(page_size=8):
                page.rows_dev.cpu()
    """)
    fs = _lint(fixture_repo, "stream-host-sync")
    assert [f.path for f in fs] == ["chip_smoke.py"]


def test_missing_slow_marker_planted(fixture_repo):
    _write(fixture_repo, "tests/test_spawns.py", """\
        import subprocess

        def test_heavy():
            subprocess.run(["true"])
    """)
    assert len(_lint(fixture_repo, "missing-slow-marker")) == 1
    _write(fixture_repo, "tests/test_spawns.py", """\
        import subprocess
        import pytest

        pytestmark = pytest.mark.slow

        def test_heavy():
            subprocess.run(["true"])
    """)
    assert not _lint(fixture_repo, "missing-slow-marker")


def test_orphan_module_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/dead.py", "VALUE = 1\n")
    fs = _lint(fixture_repo, "orphan-module")
    assert [f.path for f in fs] == ["src/repro_torch/core/dead.py"]
    # the extras/ quarantine is exempt; chip_smoke.py is a root
    _write(fixture_repo, "src/repro_torch/extras/__init__.py", "")
    _write(fixture_repo, "src/repro_torch/extras/dead2.py", "VALUE = 2\n")
    assert [f.path for f in _lint(fixture_repo, "orphan-module")] == [
        "src/repro_torch/core/dead.py"]
    _write(fixture_repo, "chip_smoke.py", "def main():\n    import repro_torch.core.dead\n")
    assert not _lint(fixture_repo, "orphan-module")


def test_unused_import_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/lazy.py", """\
        import os
        import sys

        def cwd():
            return os.getcwd()
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.lazy\n")
    fs = _lint(fixture_repo, "unused-import")
    assert len(fs) == 1 and "`sys`" in fs[0].message


def test_suppression_comment_silences_rule(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/twiddle.py", """\
        def word_of(i):
            return i >> 5  # staticcheck: ignore[bitset-twiddling]
    """)
    _write(fixture_repo, "tests/test_ok.py", "import repro_torch.core.twiddle\n")
    assert not _lint(fixture_repo, "bitset-twiddling")


# ------------------------------------------------------------- cache keys
def test_cache_key_coverage_planted(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/leaky.py", """\
        import functools

        class Engine:
            def fn(self, spec, cap):
                return self.cache.get(
                    ("match", spec),
                    lambda: functools.partial(lambda x: x[:cap]),
                )
    """)
    fs = cachekeys.check_cache_keys(fixture_repo)
    assert len(fs) == 1 and "'cap'" in fs[0].message


def test_cache_key_coverage_assigned_key_and_named_builder(fixture_repo):
    _write(fixture_repo, "src/repro_torch/core/tight.py", """\
        class Engine:
            def fn(self, spec, cap):
                def build():
                    return lambda x: x[:cap]

                key = ("match", spec, cap)
                return self.cache.get(key, build)
    """)
    assert not cachekeys.check_cache_keys(fixture_repo)


# ---------------------------------------------------------- op contracts
class _FakeKernels(backend_lib.Kernels):
    """A `Kernels` backend with one op, ``op``, per test."""

    name = "_staticcheck_test"

    def __init__(self, fn):
        self._fn = fn

    def op(self, x):
        return self._fn(x)


def _check_fake(fn, out_dtypes):
    """Register a throwaway backend, run the contract pass on it alone."""
    name = _FakeKernels.name
    contract = OpContract(
        "op", lambda dev: ((torch.arange(8, dtype=torch.int32, device=dev),), {}), out_dtypes)
    backend_lib.register_backend(name, lambda: _FakeKernels(fn), contracts=(contract,))
    try:
        assert backend_lib.op_contracts(name) == (contract,)
        return [f for f in contracts.check_kernel_contracts([name], "cpu")
                if f.path.endswith(":op")]
    finally:
        backend_lib._REGISTRY.pop(name, None)
        backend_lib._INSTANCES.pop(name, None)
        backend_lib._CONTRACTS.pop(name, None)


def test_out_dtype_planted():
    fs = _check_fake(lambda x: x.float(), out_dtypes=(torch.int32,))
    assert _rules_of(fs) == {"out-dtype"}
    assert "float32" in fs[0].message


def test_out_dtype_raising_op_is_a_finding():
    def broken(x):
        raise TypeError("no example for you")

    fs = _check_fake(broken, out_dtypes=(torch.int32,))
    assert _rules_of(fs) == {"out-dtype"} and "raised" in fs[0].message


@pytest.mark.parametrize("fn,out", [
    (lambda x: (x.double() * 2).int(), torch.int32),  # float64 inside the op
    (lambda x: x.long() + 1, torch.int64),            # an int64 output
], ids=["float64-inside", "int64-output"])
def test_dtype_width_planted(fn, out):
    assert _rules_of(_check_fake(fn, out_dtypes=(out,))) == {"dtype-width"}


def test_dtype_width_exempts_what_torch_demands():
    # searchsorted's default int64 output is torch's, named by its aten op
    fs = _check_fake(lambda x: torch.searchsorted(x, x), out_dtypes=(torch.int64,))
    assert fs == []


def test_banned_primitive_planted():
    fs = _check_fake(lambda x: x + int(x.sum()), out_dtypes=(torch.int32,))
    assert _rules_of(fs) == {"banned-primitive"}
    assert "_local_scalar_dense" in fs[0].message and "test_torch_analysis.py" not in fs[0].message


def test_mask_to_host_is_exempt_by_name():
    kern = backend_lib.get_kernels("torch")
    assert contracts.check_host_op(kern, "mask_to_host", torch.device("cpu"), "t") == []
    _, log = oplog.record(oplog.RecordingKernels(kern).mask_to_host,
                          torch.zeros(64, dtype=torch.bool))
    assert log.ops[-1].name == "kernels.mask_to_host"
    assert contracts.check_log(log, "t") == []


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_real_contracts_run_clean_on_every_backend(backend):
    assert contracts.check_kernel_contracts([backend], "cpu") == []


def test_backend_registry():
    assert backend_lib.available_backends()[:2] == ("torch", "cuda")
    for name in ("torch", "cuda"):
        assert backend_lib.op_contracts(name) is backend_lib.OP_CONTRACTS
    with pytest.raises(ValueError, match="unknown kernel backend"):
        backend_lib.get_kernels("jnp")


# ------------------------------------------------- collective safety (d)
def _one_finding(findings, rule_id):
    assert [f.rule for f in findings] == [rule_id], "\n".join(str(f) for f in findings)
    assert rule_id in report_json(findings)  # survives into --json output
    return findings[0]


def _tables(S=4, cap=3, w=2):
    cols = torch.arange(S * cap * w, dtype=torch.int32).reshape(S, cap, w)
    return cols, torch.ones(S, cap, dtype=torch.bool), torch.ones(S, S, dtype=torch.bool)


def test_collective_divergent_control_planted():
    cols, valid, load = _tables()
    with collective_safety.Recording(4) as rec:
        collectives.gather_load_set(cols, valid, load[:3])  # a shard stays out
    _one_finding(collective_safety.check(rec, "t"), "coll-divergent-control")


def test_collective_ppermute_bijection_planted():
    cols, valid, load = _tables()
    with collective_safety.Recording(4) as rec:
        # a ring shift whose source map sends shard 3 twice and shard 0 never
        collectives._note("gather_load_set_ring", {"cols": cols, "valid": valid, "load": load},
                          (cols, valid), shifts=(0, 1),
                          sources=(torch.arange(4), torch.tensor([3, 3, 1, 2])))
    f = _one_finding(collective_safety.check(rec, "t"), "coll-ppermute-bijection")
    assert "[3, 3, 1, 2]" in f.message


def test_collective_axis_name_planted():
    with collective_safety.Recording(4) as rec:
        collectives.or_allreduce(torch.ones(2, 5, dtype=torch.int32))  # 2 of 4 shards
    _one_finding(collective_safety.check(rec, "t"), "coll-axis-name")


def test_collective_head_gather_planted():
    cols, valid, load = _tables()
    with collective_safety.Recording(4) as rec:
        rec.taint(cols)                # the head table
        derived = cols + 0             # taint runs through the op log
        collectives.fetch_load_set(derived, valid, load)
    fs = collective_safety.check(rec, "t")
    assert _rules_of(fs) == {"coll-head-gather"}


def test_collective_clean_on_benign_calls():
    cols, valid, load = _tables()
    with collective_safety.Recording(4) as rec:
        rec.taint(torch.zeros(3))      # a head table that is never fetched
        collectives.pmax(torch.tensor([1, 5, 2, 0]))
        collectives.or_allreduce(torch.ones(4, 2, dtype=torch.int32))
        collectives.fetch_load_set(cols, valid, load)
        collectives.fetch_load_set(cols, valid, load, ring_radius=1)
    assert collective_safety.check(rec, "t") == []
    names = [c.name for c in rec.calls]
    assert names == ["pmax", "or_allreduce", "gather_load_set", "fetch_load_set",
                     "gather_load_set_ring", "fetch_load_set"]
    ring = rec.calls[4]
    assert ring.sources == ((0, 1, 2, 3), (3, 0, 1, 2), (1, 2, 3, 0))
    assert collectives.recorder is None  # the hook is removed on exit


def test_sharded_probe_taints_the_head_and_stays_clean():
    reports = {}
    fs, traces = engines.probe_traces("sharded", "torch", device="cpu", reports=reports)
    assert fs == []
    seq = reports["collectives"][0]
    assert seq["n_shards"] == engines.PROBE_SHARDS
    assert {"or_allreduce", "pmax", "fetch_load_set"} <= set(seq["collectives"])
    heads = {t.target.rsplit(":", 1)[1] for t in traces}
    assert heads == {"match", "join", "or_allreduce", "pmax", "gather_load_set",
                     "fetch_load_set"}


# ----------------------------------------------------------- cost model (e)
def _est(target, peak=0.0, flops=0.0, coll=0.0):
    return costmodel.CostEstimate(target, float(peak), float(flops), float(coll), {})


_TEST_BUDGETS = {
    "entries": {
        "engine:test:torch:match": {"peak_bytes": 1000, "flops": 5000, "collective_bytes": 100},
    },
}


def test_cost_budget_overflow_planted():
    f = _one_finding(costmodel.check_budgets(
        [_est("engine:test:torch:match", peak=1500, flops=10)], _TEST_BUDGETS),
        "cost-budget-exceeded")
    assert "peak_bytes" in f.message


def test_cost_budget_missing_fails_closed():
    _one_finding(costmodel.check_budgets(
        [_est("engine:test:torch:new_entry_point", peak=1)], _TEST_BUDGETS),
        "cost-budget-missing")


def test_cost_budget_within_ceiling_is_clean():
    assert costmodel.check_budgets(
        [_est("engine:test:torch:match", peak=999, flops=4999, coll=99)], _TEST_BUDGETS) == []


def test_cost_superlinear_memory_planted():
    small = [_est("engine:test:torch:join", peak=1000)]
    # quadratic structure: 4x graph -> 16x bytes, bound is 2.0 * 4 = 8x
    _one_finding(costmodel.check_linear_memory(
        small, [_est("engine:test:torch:join", peak=16000)], size_ratio=4.0, slack=2.0),
        "cost-superlinear-memory")
    assert costmodel.check_linear_memory(
        small, [_est("engine:test:torch:join", peak=4000)], size_ratio=4.0, slack=2.0) == []


def test_cost_estimate_counts_quadratic_intermediate():
    """The liveness peak sees a materialised O(n²) outer product, and
    drops it once it is dead."""
    n = 64

    def outer(a, b):
        z = a[:, None] * b[None, :]          # (n, n) float32
        return z.sum()

    _, log = oplog.record(outer, torch.ones(n), torch.ones(n))
    est = costmodel.estimate(log, "fx")
    assert est.peak_bytes >= n * n * 4
    assert est.flops == n * n + n * n  # the product, then the sum's reads


def test_cost_collective_bytes_ring_conventions():
    cols, valid, load = _tables(S=4, cap=3, w=2)
    with collective_safety.Recording(4) as rec:
        collectives.or_allreduce(torch.ones(4, 5, dtype=torch.int32))
        collectives.gather_load_set(cols, valid, load)
    by_kind = costmodel.collective_bytes(rec.calls)
    ring = 3 / 4
    assert np.isclose(by_kind["all-reduce"], 5 * 4 * 2 * ring)
    assert np.isclose(by_kind["all-gather"], (12 * 2 * 4 + 4 * 12 / 4) * ring)


def test_checked_in_budgets_cover_probe_targets():
    """Every engine×kernels×entry point the probe records has a budget row
    (the fail-closed contract, checked without running the probe)."""
    targets = set(costmodel.load_budgets()["entries"])
    for eng, heads in (
        ("local", ("match", "join")),
        ("sharded", ("match", "join", "or_allreduce", "pmax", "gather_load_set",
                     "fetch_load_set")),
    ):
        for k in ("torch", "cuda"):
            for h in heads:
                assert f"engine:{eng}:{k}:{h}" in targets


def test_local_probe_key_heads_are_the_references():
    """The JAX probe with ``kernels="jnp"`` records the local engine's
    entry points under the key heads its checked-in budget rows name."""
    jax_heads = {t.split(":")[3] for t in jcostmodel.load_budgets()["entries"]
                 if t.startswith("engine:local:jnp:")}
    _, traces = engines.probe_traces("local", "torch", device="cpu")
    assert {t.key[0] for t in traces} == jax_heads == {"match", "join"}


@pytest.mark.parametrize("shape", [(4, 8, 6, 10, 5), (64, 39, 39, 10, 200)])
def test_cost_flops_cin_layer_within_10pct_of_the_reference(shape):
    from repro.kernels.cin.ref import cin_layer_reference as jcin
    from repro_torch.kernels.cin.ref import cin_layer_reference

    B, H, m, d, H2 = shape
    args = [np.zeros(s, np.float32) for s in ((B, H, d), (B, m, d), (H * m, H2))]
    want = jcostmodel.estimate(jax.make_jaxpr(jcin)(*args)).flops
    _, log = oplog.record(cin_layer_reference, *map(torch.from_numpy, args))
    got = costmodel.estimate(log).flops
    assert abs(got - want) <= 0.1 * want, (got, want)


def _join_flops(cap, dup, w=4):
    """The cost model's operations for one `sort_merge_join` of two
    ``cap``-row, ``w``-column tables sharing one column, on both sides:
    ``(port, reference)``."""
    from repro.core import join as jjoin
    from repro_torch.core import join as tjoin

    qa, qb = tuple(range(w)), (w - 1,) + tuple(range(w, 2 * w - 1))

    def jtable():
        return jjoin.JoinTable(
            cols=jax.ShapeDtypeStruct((cap, w), jnp.int32),
            valid=jax.ShapeDtypeStruct((cap,), jnp.bool_),
            n_rows=jax.ShapeDtypeStruct((), jnp.int32),
            overflow=jax.ShapeDtypeStruct((), jnp.bool_))

    def ttable():
        return tjoin.JoinTable(torch.zeros((cap, w), dtype=torch.int32),
                               torch.zeros(cap, dtype=torch.bool),
                               torch.zeros((), dtype=torch.int32),
                               torch.zeros((), dtype=torch.bool))

    jsa, jsb = jjoin.Schema(qa, (0,) * w), jjoin.Schema(qb, (0,) * w)
    tsa, tsb = tjoin.Schema(qa, (0,) * w), tjoin.Schema(qb, (0,) * w)
    want = jcostmodel.estimate(jax.make_jaxpr(
        lambda a, b: jjoin.sort_merge_join(a, b, jsa, jsb, out_cap=cap, dup_cap=dup)[0]
    )(jtable(), jtable())).flops
    _, log = oplog.record(
        lambda a, b: tjoin.sort_merge_join(a, b, tsa, tsb, out_cap=cap, dup_cap=dup)[0],
        ttable(), ttable())
    return costmodel.estimate(log).flops, want


@pytest.mark.parametrize("cap,dup", [(256, 8), (1024, 16)])
def test_cost_flops_join_within_10pct_of_the_reference(cap, dup):
    got, want = _join_flops(cap, dup)
    assert abs(got - want) <= 0.1 * want, (got, want)


def test_cost_flops_join_at_the_probe_shape_less_the_references_extra_gathers():
    """At the probe's own join (`engines.PROBE_CAPS`) the port's count is
    12% under the reference's. The term that grows apart is the programs',
    not the model's: for each of the nb·W probe slots the reference runs
    four gathers the port does not — ``order[probe_c]`` then
    ``a.cols[a_rows]`` where the port reads ``a.cols[order]`` once, and one
    ``jnp.take`` per extra column of b where the port broadcasts them
    (``repeat_interleave``, a copy). Each is three operations an index in
    both models. With those taken off the reference's count, the two agree
    within 10%; the budgets price the port's program."""
    cap, dup, w = engines.PROBE_CAPS["join_rows_cap"], engines.PROBE_CAPS["join_dup_cap"], 4
    got, want = _join_flops(cap, dup, w)
    assert 0.1 * want < want - got  # the gap the docstring names is there
    extra_gathers = 3.0 * cap * dup * ((w - 1) + 1)
    assert abs(got - (want - extra_gathers)) <= 0.1 * (want - extra_gathers), (got, want)


def test_an_indexed_read_is_priced_as_the_reference_prices_a_gather():
    x, i = np.zeros(1000, np.int32), np.zeros(300, np.int32)
    want = jcostmodel.estimate(jax.make_jaxpr(lambda x, i: x[i])(x, i)).flops
    _, log = oplog.record(lambda x, i: x[i], torch.from_numpy(x), torch.from_numpy(i).long())
    assert costmodel.estimate(log).flops == want == 3 * 300


def test_join_cost_bytes_is_the_cost_models_peak_of_a_real_join():
    """`join_cost_bytes` prices the join on meta tensors; at small caps it
    equals the cost model's peak of the same join run on the CPU."""
    from repro_torch.core import join as tjoin
    from repro_torch.runtime.resilience import join_cost_bytes

    cap, dup, w = 512, 8, 4
    tsa = tjoin.Schema(tuple(range(w)), (0,) * w)
    tsb = tjoin.Schema((w - 1,) + tuple(range(w, 2 * w - 1)), (0,) * w)
    rng = np.random.default_rng(0)

    def table():
        return tjoin.JoinTable(torch.from_numpy(rng.integers(0, 50, (cap, w), dtype=np.int32)),
                               torch.ones(cap, dtype=torch.bool),
                               torch.tensor(cap, dtype=torch.int32),
                               torch.zeros((), dtype=torch.bool))

    _, log = oplog.record(
        lambda a, b: tjoin.sort_merge_join(a, b, tsa, tsb, out_cap=cap, dup_cap=dup)[0],
        table(), table())
    assert join_cost_bytes(cap, dup) == costmodel.peak_bytes(log)


# ------------------------------------------------------------ registries
def test_all_archs_equal_the_reference_field_for_field():
    ours, ref = configs.all_archs(), jconfigs.all_archs()
    assert sorted(ours) == sorted(ref)
    for arch, e in ours.items():
        r = ref[arch]
        assert (e.arch_id, e.family, e.shapes, e.skipped_shapes) == \
            (r.arch_id, r.family, r.shapes, r.skipped_shapes)
        assert dataclasses.asdict(e.config) == dataclasses.asdict(r.config)
        assert dataclasses.asdict(e.smoke()) == dataclasses.asdict(r.smoke())


def test_launchers_read_the_registry():
    from repro_torch.extras import train
    from repro_torch.launch import serve

    assert serve.lm_archs() == sorted(a for a, e in jconfigs.all_archs().items()
                                      if e.family == "lm")
    assert train.trainable_archs() == sorted(
        a for a, e in jconfigs.all_archs().items() if e.family in ("lm", "gnn", "recsys"))
    with pytest.raises(SystemExit, match="unknown --arch"):
        train.build("stwig", smoke=True, batch=1, seq=8, seed=0, device="cpu")


def test_retry_ceiling_reads_the_ports_budgets():
    from repro_torch.runtime.resilience import MEMORY_CEILING_BYTES, retry_ceiling_bytes

    budgets = costmodel.load_budgets()
    assert retry_ceiling_bytes() == budgets["retry"]["memory_ceiling_bytes"] == MEMORY_CEILING_BYTES
    assert retry_ceiling_bytes({}) == MEMORY_CEILING_BYTES


# ----------------------------------------------------------- clean repo
def test_run_all_is_clean_on_the_cpu():
    """Every pass on the repo, on the CPU, over every registered backend:
    zero findings, and the side reports filled."""
    reports = {}
    fs = run_all(REPO_ROOT, device="cpu", reports=reports)
    assert fs == [], "\n".join(str(f) for f in fs)
    assert set(reports["cost_report"]["aggregates"]) == set(costmodel.load_budgets()["entries"])
    assert all(s["host_syncs"] == 0 for s in reports["steps"])


def test_cli_static_passes_exit_zero(capsys):
    from repro_torch.analysis.staticcheck.__main__ import main

    assert main(["--device", "cpu", "--no-engines"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_run_all_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all(REPO_ROOT, engines=False)


@pytest.mark.parametrize("entry", [
    lambda: contracts.check_kernel_contracts(["torch"]),
    lambda: engines.probe_traces("local", "torch"),
    lambda: engines.check_engines_traces(("local",)),
    lambda: __import__("repro_torch.analysis.roofline", fromlist=["_"]).engine_rooflines(),
], ids=["check_kernel_contracts", "probe_traces", "check_engines_traces", "engine_rooflines"])
def test_analysis_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_no_collectives_skips_the_collective_pass(monkeypatch):
    from repro_torch.analysis.staticcheck import collective_safety

    def refuse(*a, **k):
        raise AssertionError("collective_safety.check ran with collectives=False")

    monkeypatch.setattr(collective_safety, "check", refuse)
    fs, traces = engines.probe_traces("local", "torch", device="cpu", collectives=False)
    assert fs == [] and traces


def test_every_rule_has_a_registered_description():
    assert len(RULES) >= 19  # incl. the collective-safety + cost rules
    for r in RULES.values():
        assert r.layer and r.description
