"""Join phase (paper §4.2 step 3): join-order selection + pipelined joins.

Intermediate STwig tables are joined on their shared query nodes with a
sort-merge join at static capacities, as in the JAX package
(``src/repro/core/join.py``). The probe — lower bound, window expansion and
exact-key verification — is a `Kernels` op (`hash_join_probe`).

The join keys are uint32 murmur3 hashes. PyTorch has no uint32 arithmetic
worth the name, so they are computed in int64 and masked to 32 bits after
every step (a 32×32-bit product is split so it never leaves int64), sorted
as int64 (so ``BIG = 0xFFFFFFFF`` sorts last, as in unsigned order) with a
stable sort (ties keep row order, as ``lax.sort`` with an iota payload
does), and handed to the probe as int32 bit patterns.

Rows are *subgraph-isomorphism* embeddings: any two query nodes with equal
labels must map to distinct data nodes; the filter runs at every join.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.backend import Kernels, get_kernels
from repro_torch.core.match import compact_rows
from repro_torch.kernels.bitset.ref import as_int32_words

U32 = 0xFFFFFFFF


class JoinTable(NamedTuple):
    cols: torch.Tensor      # (cap, width) int32 global ids (ghost-padded)
    valid: torch.Tensor     # (cap,) bool
    n_rows: torch.Tensor    # () int32 exact (pre-truncation) count
    overflow: torch.Tensor  # () bool


@dataclasses.dataclass(frozen=True)
class Schema:
    qnodes: tuple[int, ...]
    qlabels: tuple[int, ...]  # labels of those query nodes

    def merge(self, other: "Schema") -> tuple["Schema", tuple[int, ...]]:
        shared = tuple(q for q in other.qnodes if q in self.qnodes)
        extra = tuple(
            (q, l)
            for q, l in zip(other.qnodes, other.qlabels)
            if q not in self.qnodes
        )
        merged = Schema(
            self.qnodes + tuple(q for q, _ in extra),
            self.qlabels + tuple(l for _, l in extra),
        )
        return merged, shared


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, without int64
    overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x & U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _combine_keys(cols: torch.Tensor, positions: tuple[int, ...]) -> torch.Tensor:
    """Mix the key columns into one uint32 sort key (int64 values in
    ``[0, 2**32)``). Collisions only cost probe-window slots: exact column
    equality is always verified at probe time."""
    k = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for p in positions:
        k = _mix32(k ^ _mix32(cols[:, p].to(torch.int64)))
        k = (_mul32(k, 5) + 0xE6546B64) & U32
    return k


def sort_merge_join(
    a: JoinTable,
    b: JoinTable,
    schema_a: Schema,
    schema_b: Schema,
    *,
    out_cap: int,
    dup_cap: int,
    kernels: Kernels | None = None,
) -> tuple[JoinTable, Schema]:
    """R_a ⋈ R_b on shared query nodes; output capacity ``out_cap``;
    at most ``dup_cap`` equal-key rows on the build (a) side per probe."""
    kern = kernels if kernels is not None else get_kernels("torch")
    merged_schema, shared = schema_a.merge(schema_b)
    if not shared:
        raise ValueError("join between disconnected tables")
    pos_a = tuple(schema_a.qnodes.index(q) for q in shared)
    pos_b = tuple(schema_b.qnodes.index(q) for q in shared)

    key_a = torch.where(a.valid, _combine_keys(a.cols, pos_a), U32)
    key_b = _combine_keys(b.cols, pos_b)
    ka64, order = torch.sort(key_a, stable=True)
    a_valid_s = a.valid[order]

    # build-side duplicate-run overflow detection
    run_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=ka64.device), ka64[1:] != ka64[:-1]]
    ) | ~a_valid_s
    run_id = torch.cumsum(run_start.to(torch.int64), 0) - 1
    run_len = torch.zeros_like(run_id).scatter_add_(0, run_id, torch.ones_like(run_id))
    longest = torch.where(a_valid_s, run_len[run_id], 0).amax()
    dup_overflow = longest > dup_cap

    # windowed probe with exact-key verification — one backend op
    W = dup_cap
    a_sorted = a.cols[order]
    a_keys_s = a_sorted[:, list(pos_a)].contiguous()  # (na, nk)
    b_keys = b.cols[:, list(pos_b)].contiguous()      # (nb, nk)
    hit, probe_c = kern.hash_join_probe(
        as_int32_words(ka64), a_keys_s, a_valid_s, as_int32_words(key_b),
        b_keys, b.valid.contiguous(), dup_cap=W,
    )

    # merged row values: all of a's columns + b's extra columns
    extra_pos_b = [i for i, q in enumerate(schema_b.qnodes) if q not in schema_a.qnodes]
    flat_hit = hit.reshape(-1)
    merged_cols = torch.cat(
        [a_sorted[probe_c.reshape(-1).long()],
         b.cols[:, extra_pos_b].repeat_interleave(W, dim=0)],
        dim=1,
    )  # (nb*W, w_merged)

    # isomorphism (injectivity) filter on equal-label column pairs
    labs = merged_schema.qlabels
    wm = len(merged_schema.qnodes)
    for i in range(wm):
        for j in range(i + 1, wm):
            if labs[i] == labs[j]:
                flat_hit = flat_hit & (merged_cols[:, i] != merged_cols[:, j])

    n_rows = flat_hit.sum(dtype=torch.int32)
    ghost = a.cols.amax()  # any value; rows are masked by `valid`
    cols, valid = compact_rows(flat_hit, merged_cols, out_cap, ghost)
    overflow = (n_rows > out_cap) | dup_overflow | a.overflow | b.overflow
    return (
        JoinTable(cols=cols, valid=valid, n_rows=n_rows, overflow=overflow),
        merged_schema,
    )


def block_table(table: JoinTable, lo: int, block_rows: int) -> JoinTable:
    """Rows ``[lo, lo+block_rows)`` of a join table as a fixed-shape block;
    indices past the table's capacity are masked invalid. Blocks partition
    the table's valid rows, and every join output row descends from exactly
    one build-side row, so per-block results are disjoint and their union
    equals the unblocked join (§4.2 step 3 / §6.1)."""
    cap = int(table.cols.shape[0])
    idx = lo + torch.arange(block_rows, dtype=torch.int64, device=table.cols.device)
    safe = torch.clamp(idx, max=cap - 1)
    valid = table.valid[safe] & (idx < cap)
    return JoinTable(
        cols=table.cols[safe],
        valid=valid,
        n_rows=valid.sum(dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.bool, device=valid.device),
    )


def compact_table(table: JoinTable, valid_host: np.ndarray, min_cap: int = 64) -> JoinTable:
    """Squeeze a table's valid rows to the front and shrink its capacity to
    the smallest power of two that holds them all. ``valid_host`` is the
    table's validity already on the host.

    STwig tables are allocated at worst-case capacity but are usually
    sparse, and the probe side of every join pays O(cap × dup_cap) however
    few rows are real; the streaming path re-probes the same tables once
    per block, so its setup compacts them once. Lossless: the compact
    capacity covers every valid row and the exact-count/overflow flags are
    carried over unchanged."""
    keep = np.nonzero(valid_host)[0]
    cap = int(table.cols.shape[0])
    new_cap = min_cap
    while new_cap < len(keep):
        new_cap *= 2
    if new_cap >= cap:
        return table
    dev = table.cols.device
    cols = torch.zeros((new_cap, table.cols.shape[1]), dtype=table.cols.dtype, device=dev)
    cols[: len(keep)] = table.cols[torch.as_tensor(keep, device=dev)]
    valid = torch.zeros(new_cap, dtype=torch.bool, device=dev)
    valid[: len(keep)] = True
    return JoinTable(cols=cols, valid=valid, n_rows=table.n_rows, overflow=table.overflow)


def select_join_order(
    schemas: list[Schema], counts: list[int], start: int | None = None
) -> list[int]:
    """Greedy smallest-intermediate-first join order (host-side).

    Start from the smallest table (or a forced start); repeatedly pick the
    connected table whose estimated output (count scaled by shared-key
    count) is smallest.
    """
    n = len(schemas)
    remaining = set(range(n))
    first = start if start is not None else min(remaining, key=lambda i: counts[i])
    order = [first]
    remaining.discard(first)
    joined = set(schemas[first].qnodes)
    while remaining:
        connected = [i for i in remaining if joined & set(schemas[i].qnodes)]
        pool = connected or list(remaining)
        # more shared keys → more selective; fewer rows → cheaper
        nxt = min(
            pool,
            key=lambda i: (-len(joined & set(schemas[i].qnodes)), counts[i]),
        )
        order.append(nxt)
        remaining.discard(nxt)
        joined |= set(schemas[nxt].qnodes)
    return order
