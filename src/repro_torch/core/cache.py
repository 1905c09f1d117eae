"""Session-owned executable cache.

A `GraphSession` owns one `ExecutableCache`. PyTorch runs eagerly, so what
the cache holds are the per-spec step functions (a `match_stwig_shard`
bound to its `STwigSpec` and kernel backend, a join bound to its schemas
and capacities). The keys are the tuples the JAX package keys its jitted
executables by, the kernel backend's name included, so one session can
switch backends mid-run, and the hit/miss counters in `MatchStats` mean
what they mean there.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable


class ExecutableCache:
    """A keyed LRU cache of step functions (and their static metadata)."""

    def __init__(self, maxsize: int = 512):
        self.maxsize = int(maxsize)
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building (and storing) it on
        a miss. The least-recently-used entry is evicted past ``maxsize``."""
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            value = self._data[key] = build()
            if len(self._data) > self.maxsize:
                self._data.popitem(last=False)
            return value
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)
