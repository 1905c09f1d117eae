"""Deprecation plumbing for the pre-facade surface.

Two things are deprecated for real (not just in docstrings): constructing
`SubgraphMatcher` / `DistributedMatcher` directly instead of opening a
`repro_torch.api.GraphSession`, and the dict-style access bridge on `MatchStats`
(``stats["time_s"]`` / ``stats.get("time_s")``). Both now emit
`DeprecationWarning`; `tests/test_api.py` pins that they fire.

The facade itself constructs the engines, so engine ``__init__`` cannot
warn unconditionally — `GraphSession.open` wraps its construction in
`facade_construction()`, which suppresses the warning for exactly that
scope (a context variable, so it nests and survives threads correctly).
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings

_IN_FACADE = contextvars.ContextVar("repro_torch_facade_construction", default=False)


@contextlib.contextmanager
def facade_construction():
    """Mark engine construction as facade-internal (no warning)."""
    token = _IN_FACADE.set(True)
    try:
        yield
    finally:
        _IN_FACADE.reset(token)


def warn_direct_construction(name: str) -> None:
    """Emit the direct-engine-construction `DeprecationWarning` unless the
    construction is happening inside `GraphSession.open`."""
    if _IN_FACADE.get():
        return
    warnings.warn(
        f"constructing {name} directly is deprecated — open a "
        "repro_torch.api.GraphSession instead (it selects the backend, owns the "
        "executable cache, and exposes compile/run/stream/serve)",
        DeprecationWarning,
        stacklevel=3,
    )


def warn_dict_stats_access(key: str) -> None:
    """Emit the dict-style `MatchStats` access `DeprecationWarning`."""
    warnings.warn(
        f"dict-style MatchStats access (stats[{key!r}]) is deprecated — "
        f"use the typed attribute (stats.{key}) instead",
        DeprecationWarning,
        stacklevel=3,
    )
