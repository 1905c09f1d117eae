"""Session-owned executable cache.

A `GraphSession` owns one `ExecutableCache`. PyTorch runs eagerly, so what
the cache holds are the per-spec step functions (a `match_stwig_shard`
bound to its `STwigSpec` and kernel backend, a join bound to its schemas
and capacities). The keys are the tuples the JAX package keys its jitted
executables by, the kernel backend's name included, so one session can
switch backends mid-run, and the hit/miss counters in `MatchStats` mean
what they mean there.

Retrace detection, as in the JAX package (``src/repro/core/cache.py``):
every build is recorded as a trace event for its logical key. With
``REPRO_CHECK_RETRACE=1`` in the environment (or ``check_retrace=True``),
building the same logical key twice raises `RetraceError` — one logical key
(spec, schemas, caps, kernels name) must be built exactly once, the
invariant the compile/run split and the query server's step sharing stand
on. A cached step here is an eager function that cannot re-trace silently;
`retraced_executables` reports what it finds on a cached callable that does
carry a trace cache (none does today), and the static pass
`repro_torch.analysis.staticcheck.cachekeys` carries the invariant that
every builder's varying state is in its key.
"""
from __future__ import annotations

import os
from collections import Counter, OrderedDict
from typing import Any, Callable, Hashable


class RetraceError(RuntimeError):
    """One logical executable-cache key built more than once."""


def _env_check_retrace() -> bool:
    return os.environ.get("REPRO_CHECK_RETRACE", "").strip().lower() not in (
        "", "0", "false",
    )


class ExecutableCache:
    """A keyed LRU cache of step functions (and their static metadata)."""

    def __init__(self, maxsize: int = 512, *, check_retrace: bool | None = None):
        self.maxsize = int(maxsize)
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        # one entry per build of a logical key; survives `clear()` —
        # dropping steps does not erase the build history
        self.trace_log: list[Hashable] = []
        self._traced: set[Hashable] = set()
        self.check_retrace = (
            _env_check_retrace() if check_retrace is None else bool(check_retrace)
        )
        # staticcheck hook: called as recorder(key, fn, args, kwargs) on
        # every invocation of a cached step (None = disabled); a callable it
        # returns is called with the step's result
        self.recorder: Callable[..., None] | None = None

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building (and storing) it on
        a miss. The least-recently-used entry is evicted past ``maxsize``."""
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            if key in self._traced and self.check_retrace:
                raise RetraceError(
                    f"logical key built twice: {key!r} — the step for this "
                    "key was already built once this session (rebuilt after "
                    "eviction/clear, or the key is unstable across calls); "
                    "one logical key must be built exactly once"
                ) from None
            self.trace_log.append(key)
            self._traced.add(key)
            value = self._data[key] = build()
            if len(self._data) > self.maxsize:
                self._data.popitem(last=False)
            return self._wrap(key, value)
        self._data.move_to_end(key)
        self.hits += 1
        return self._wrap(key, value)

    # -------------------------------------------------- retrace diagnostics
    def duplicate_traces(self) -> list[Hashable]:
        """Logical keys built more than once (empty ⇒ invariant held)."""
        return [k for k, n in Counter(self.trace_log).items() if n > 1]

    def retraced_executables(self) -> list[tuple[Hashable, int]]:
        """Cached callables whose own trace cache holds more than one trace
        (a ``_cache_size()`` over 1) — a static argument varied without
        varying the cache key. The port's eager steps carry no trace cache,
        so this is empty unless such a callable is cached."""
        out: list[tuple[Hashable, int]] = []
        for key, value in self._data.items():
            fns = value if isinstance(value, tuple) else (value,)
            for f in fns:
                size_fn = getattr(f, "_cache_size", None)
                if not callable(size_fn):
                    continue
                n = int(size_fn())
                if n > 1:
                    out.append((key, n))
        return out

    def assert_no_retrace(self) -> None:
        """Fail if any logical key was built twice or any cached callable
        re-traced under its key."""
        dup = self.duplicate_traces()
        if dup:
            raise RetraceError(f"logical keys built twice: {dup!r}")
        rex = self.retraced_executables()
        if rex:
            raise RetraceError(
                "steps re-traced under a single cache key (a static "
                f"argument is missing from the key): {rex!r}"
            )

    # ------------------------------------------------------------- plumbing
    def _wrap(self, key: Hashable, value: Any) -> Any:
        """With a recorder installed, intercept step invocations so
        staticcheck can capture (key, fn, concrete args) and run the step
        again under its op recorder."""
        rec = self.recorder
        if rec is None:
            return value

        def wrap_fn(f):
            def wrapped(*a, **kw):
                after = rec(key, f, a, kw)
                out = f(*a, **kw)
                if callable(after):
                    after(out)
                return out

            return wrapped

        if callable(value):
            return wrap_fn(value)
        if isinstance(value, tuple) and value and callable(value[0]):
            return (wrap_fn(value[0]),) + tuple(value[1:])
        return value

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data
