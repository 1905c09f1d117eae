"""Retrace detection in the port's `ExecutableCache`, as the JAX package's
``tests/test_retrace.py`` holds its own: one logical key is built once,
the env opt-in, the silent variant on a callable that carries a trace
cache, the staticcheck recorder; then run, stream and re-stream on both
engines with ``check_retrace`` on, and the engine probe clean."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.analysis.staticcheck.engines import PROBE_CAPS  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core.cache import ExecutableCache, RetraceError  # noqa: E402
from repro_torch.core.query import QueryGraph  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402

QUERY = QueryGraph.build([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3)])


def _graph():
    return generators.rmat(120, 420, 4, seed=3, symmetrize=True)


# ---------------------------------------------------------------- unit
def test_cache_raises_on_second_build_of_one_key():
    cache = ExecutableCache(check_retrace=True)
    cache.get(("f", 1), lambda: (lambda x: x))
    cache.clear()  # dropping the step does not erase its build
    with pytest.raises(RetraceError, match="built twice"):
        cache.get(("f", 1), lambda: (lambda x: x))
    assert cache.trace_log == [("f", 1)]


def test_cache_records_duplicates_when_not_raising():
    cache = ExecutableCache(maxsize=1)
    cache.get(("a",), lambda: 1)
    cache.get(("b",), lambda: 2)  # evicts ("a",)
    cache.get(("a",), lambda: 1)  # rebuilt
    assert cache.duplicate_traces() == [("a",)]
    with pytest.raises(RetraceError):
        cache.assert_no_retrace()


@pytest.mark.parametrize("value,on", [("1", True), ("true", True), ("0", False), ("", False)])
def test_cache_env_opt_in(monkeypatch, value, on):
    monkeypatch.setenv("REPRO_CHECK_RETRACE", value)
    assert ExecutableCache().check_retrace is on
    assert ExecutableCache(check_retrace=not on).check_retrace is (not on)


def test_silent_retrace_under_one_key_is_caught():
    class Traced:
        def __init__(self, n):
            self.n = n

        def __call__(self, x):
            return x

        def _cache_size(self):
            return self.n

    cache = ExecutableCache()
    cache.get(("once",), lambda: Traced(1))
    assert cache.retraced_executables() == []
    cache.get(("twice",), lambda: (Traced(2), "meta"))
    assert cache.retraced_executables() == [(("twice",), 2)]
    with pytest.raises(RetraceError, match="re-traced"):
        cache.assert_no_retrace()


def test_recorder_sees_invocations_and_results():
    cache = ExecutableCache()
    seen, results = [], []

    def recorder(key, fn, a, kw):
        seen.append((key, a))
        return results.append

    cache.recorder = recorder
    fn = cache.get(("f",), lambda: (lambda x: x + 1))
    assert fn(1) == 2
    fn = cache.get(("f",), lambda: (lambda x: x + 1))  # hit, still wrapped
    assert fn(2) == 3
    assert seen == [(("f",), (1,)), (("f",), (2,))]
    assert results == [2, 3]
    assert ("f",) in cache and ("g",) not in cache
    cache.recorder = None
    assert cache.get(("f",), lambda: None)(5) == 6


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_run_stream_restream_builds_each_key_once(monkeypatch, backend):
    monkeypatch.setenv("REPRO_CHECK_RETRACE", "1")
    s = GraphSession.open(_graph(), backend=backend, device="cpu",
                          n_shards=4 if backend == "sharded" else None)
    assert s.cache.check_retrace  # env picked up at session open
    compiled = s.compile(QUERY, max_matches=0, **PROBE_CAPS)
    res = compiled.run(adaptive=False)
    pages = [p.rows for p in compiled.stream(page_size=16)]
    misses_after_stream = s.cache.misses
    re_pages = [p.rows for p in compiled.stream(page_size=16)]
    # the re-stream built nothing new: every step was a cache hit
    assert s.cache.misses == misses_after_stream
    s.cache.assert_no_retrace()
    s.close()
    if res.complete:
        rows = np.concatenate([np.zeros((0, 4), np.int64), *pages])
        assert rows.shape[0] == res.rows.shape[0]
        assert [r.tolist() for r in re_pages] == [r.tolist() for r in pages]


def test_engine_probe_is_clean():
    """The staticcheck engine probe on the cheap combination; the CLI and
    `run_all` cover the full matrix."""
    from repro_torch.analysis.staticcheck import engines

    findings, traces = engines.probe_traces("local", "torch", device="cpu")
    assert findings == []
    assert {t.target for t in traces} == {"engine:local:torch:match", "engine:local:torch:join"}
