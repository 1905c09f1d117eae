"""Deterministic, seeded fault injection for query execution.

A `ChaosInjector` simulates the failure modes of the paper's distributed
memory cloud — a slow shard, a dead shard, a truncated fetch payload,
forced capacity overflow — so the resilience layer
(`repro_torch.runtime.resilience`) can be tested end to end: under every
injected fault the engines must return a typed partial result (a correct
*subset* of the true row set, ``complete=False``, the right
`DegradeReason`), never hang, crash, or return wrong rows. A copy of the
JAX package's ``runtime/chaos.py``: equal configs draw equal events.

Faults act at the engines' host-side orchestration boundaries, never
inside a kernel:

  * *slow shard* — a host-side delay charged before the fetch and before
    each block join (the slowest shard gates the step).
  * *dead shard* — each fetch attempt raises `ShardFaultError` until the
    configured heal point; the sharded engine retries with the
    `RetryPolicy`'s jittered backoff, then degrades to the surviving
    shards' rows by masking the dead shard's rows in the stacked validity.
  * *truncated fetch* — the tail of the configured shard's non-head
    table rows is dropped before the fetch (the head table is never
    fetched — Theorem 5 — so it is never truncated in transit).
  * *forced overflow* — ORed into the engines' host-side overflow flags,
    driving the adaptive-retry / ceiling machinery without needing a
    pathological graph.

`ChaosKernels` wraps a `Kernels` backend with per-op call accounting under
a distinct ``name`` — the name keys every cached step, so chaos runs can
never share a clean session's cache entries. It delegates every public op
of `Kernels`: an op it left out would fall through to the base class, the
plain PyTorch version, and a ``chaos(cuda)`` session would quietly run it
off the card.

Everything is seeded (`ChaosConfig.seed`): two injectors with equal
configs observe identical delays, deaths and heal points.
"""
from __future__ import annotations

import collections
import dataclasses
import random

from repro_torch.core.backend import Kernels

__all__ = ["ChaosConfig", "ChaosInjector", "ChaosKernels", "ShardFaultError"]


class ShardFaultError(RuntimeError):
    """A fetch from ``shard`` failed (the injected dead-shard fault)."""

    def __init__(self, shard: int):
        super().__init__(f"fetch from shard {shard} failed")
        self.shard = int(shard)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Which faults to inject. All deterministic given ``seed``."""

    seed: int = 0
    # slow shard: delay charged at the fetch and before every block join
    slow_shard: int | None = None
    slow_delay_s: float = 0.02
    # dead shard: fetch attempts raise until `dead_heals_after` attempts
    # have failed (None = never heals; engines degrade after their retry
    # budget)
    dead_shard: int | None = None
    dead_heals_after: int | None = None
    # truncated fetch payload: only `truncate_keep_frac` of the shard's
    # non-head table rows survive the (simulated) transfer
    truncate_shard: int | None = None
    truncate_keep_frac: float = 0.5
    # force the capacity-overflow path regardless of the data
    force_overflow: bool = False


class ChaosInjector:
    """Host-side fault source the engines consult at their orchestration
    boundaries. Construct from a `ChaosConfig` (or its fields as kwargs)
    and pass to ``GraphSession.open(..., chaos=...)``."""

    def __init__(self, config: ChaosConfig | None = None, **kw):
        self.config = config if config is not None else ChaosConfig(**kw)
        self._rng = random.Random(self.config.seed)
        self.fetch_attempts = 0
        # op calls recorded by `ChaosKernels`
        self.op_calls: collections.Counter = collections.Counter()
        # chronological fault log: (event, shard) pairs, for assertions
        self.events: list[tuple[str, int]] = []

    # ------------------------------------------------------------- kernels
    def wrap_kernels(self, kernels: Kernels) -> "ChaosKernels":
        if isinstance(kernels, ChaosKernels):
            return kernels
        return ChaosKernels(kernels, self)

    # -------------------------------------------------------------- faults
    def forced_overflow(self) -> bool:
        return self.config.force_overflow

    def fetch_delay(self) -> tuple[int, float] | None:
        """(shard, seconds) to stall the fetch for, or None. Jittered but
        seeded: deterministic per injector."""
        c = self.config
        if c.slow_shard is None:
            return None
        d = c.slow_delay_s * (0.75 + 0.5 * self._rng.random())
        self.events.append(("slow", c.slow_shard))
        return c.slow_shard, d

    def block_delay(self) -> float:
        """Per-block-join stall contributed by the slow shard (every block
        waits on the slowest shard's join step)."""
        c = self.config
        if c.slow_shard is None:
            return 0.0
        return c.slow_delay_s * (0.75 + 0.5 * self._rng.random())

    def try_fetch(self) -> None:
        """One fetch attempt. Raises `ShardFaultError` while the configured
        dead shard is down; returns quietly once it healed (or when no
        death is configured)."""
        c = self.config
        if c.dead_shard is None:
            return
        self.fetch_attempts += 1
        if c.dead_heals_after is None or self.fetch_attempts <= c.dead_heals_after:
            self.events.append(("dead", c.dead_shard))
            raise ShardFaultError(c.dead_shard)
        self.events.append(("healed", c.dead_shard))

    def truncation(self) -> tuple[int, float] | None:
        """(shard, keep_frac) for the truncated-payload fault, or None."""
        c = self.config
        if c.truncate_shard is None:
            return None
        self.events.append(("truncated", c.truncate_shard))
        return c.truncate_shard, c.truncate_keep_frac


class ChaosKernels(Kernels):
    """Delegating `Kernels` wrapper with per-op call accounting.

    The distinct ``name`` is part of every cached step's key, so chaos
    steps live beside — never instead of — the clean backend's (the same
    invariant `GraphSession.set_kernels` relies on). Every public op of
    `Kernels` is delegated to ``inner``, ``mask_to_host`` included.
    """

    def __init__(self, inner: Kernels, injector: ChaosInjector):
        self.inner = inner
        self.injector = injector
        self.name = f"chaos({inner.name})"

    def _op(self, op: str, *args, **kw):
        self.injector.op_calls[op] += 1
        return getattr(self.inner, op)(*args, **kw)

    def bitset_pack(self, *args, **kw):
        return self._op("bitset_pack", *args, **kw)

    def bitset_unpack(self, *args, **kw):
        return self._op("bitset_unpack", *args, **kw)

    def bitset_lookup(self, *args, **kw):
        return self._op("bitset_lookup", *args, **kw)

    def bitset_build(self, *args, **kw):
        return self._op("bitset_build", *args, **kw)

    def candidate_filter(self, *args, **kw):
        return self._op("candidate_filter", *args, **kw)

    def stwig_expand(self, *args, **kw):
        return self._op("stwig_expand", *args, **kw)

    def hash_join_probe(self, *args, **kw):
        return self._op("hash_join_probe", *args, **kw)

    def cin_layer(self, *args, **kw):
        return self._op("cin_layer", *args, **kw)

    def segment_mp(self, *args, **kw):
        return self._op("segment_mp", *args, **kw)

    def flash_attention(self, *args, **kw):
        return self._op("flash_attention", *args, **kw)

    def mask_to_host(self, *args, **kw):
        return self._op("mask_to_host", *args, **kw)
