"""Static query plans.

XLA needs static shapes, so every STwig step carries *capacities* (max roots
per round, per-child candidate cap, output-table rows). These are exactly the
paper's pipelined-join blocks (§4.2 step 3: "we divide the join into multiple
rounds ... We use available memory to control the block size"): a capacity is
a block size, and overflow triggers another round rather than wrong answers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decompose import (
    Decomposition,
    head_stwig_selection,
    stwig_order_selection,
)
from repro_torch.core.query import QueryGraph, STwig


@dataclasses.dataclass(frozen=True)
class STwigSpec:
    """Static (hashable) spec for one STwig matching step — the executable-cache key."""

    root_label: int
    child_labels: tuple[int, ...]
    root_qnode: int
    child_qnodes: tuple[int, ...]
    root_bound: bool
    child_bound: tuple[bool, ...]
    root_cap: int          # R: roots processed per round
    child_cap: int         # C: candidate children kept per (root, child)
    rows_cap: int          # output table rows per round
    # distinctness constraints, precomputed statically:
    same_label_child_pairs: tuple[tuple[int, int], ...]
    root_label_child_positions: tuple[int, ...]
    child_need: tuple[int, ...]  # per-child multiplicity of its label

    @property
    def n_children(self) -> int:
        return len(self.child_labels)

    @property
    def width(self) -> int:
        return 1 + self.n_children

    @property
    def qnodes(self) -> tuple[int, ...]:
        return (self.root_qnode,) + self.child_qnodes

    @property
    def grid_size(self) -> int:
        return self.child_cap ** self.n_children


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    query: QueryGraph
    specs: tuple[STwigSpec, ...]   # in exploration order
    head: int                      # index into specs
    head_dists: tuple[int, ...]    # d(r_head, r_t) per STwig (Theorem 4)
    join_rows_cap: int
    join_dup_cap: int
    join_block: int
    max_matches: int               # pipeline termination (paper uses 1024)

    @property
    def n_qnodes(self) -> int:
        return self.query.n_nodes


def caps_from_plan(plan: QueryPlan, base: dict | None = None) -> dict:
    """Recover the grow-able capacities from an already-made plan.

    Used as the escalation seed when a caller passed an explicit ``plan``:
    adaptive retries then double the plan's actual capacities instead of
    silently restarting from the `make_plan` defaults (or, worse, not
    retrying at all). Also how the streaming driver reports the caps a
    stream ran at (``MatchStats.final_caps``)."""
    caps = dict(base or {})
    caps.setdefault(
        "child_cap", max((s.child_cap for s in plan.specs), default=8)
    )
    caps.setdefault("join_rows_cap", plan.join_rows_cap)
    caps.setdefault("join_dup_cap", plan.join_dup_cap)
    caps.setdefault("max_matches", plan.max_matches)
    return caps


def _spec_for(
    stwig: STwig,
    bound_before: set[int],
    *,
    root_cap: int,
    child_cap: int,
    emission_budget: int,
) -> STwigSpec:
    k = len(stwig.children)
    # shrink C so the emission grid C^k stays within budget even at R=1
    c = child_cap
    while k > 0 and c > 2 and c**k > emission_budget:
        c -= 1
    grid = c**k if k else 1
    # roots per round sized so one round emits ≤ emission_budget rows;
    # rows_cap = R * grid means per-round emission can NEVER overflow.
    r = max(1, min(root_cap, emission_budget // max(grid, 1)))
    rows_cap = r * max(grid, 1)
    pairs = tuple(
        (i, j)
        for i in range(k)
        for j in range(i + 1, k)
        if stwig.child_labels[i] == stwig.child_labels[j]
    )
    root_kids = tuple(
        i for i in range(k) if stwig.child_labels[i] == stwig.root_label
    )
    need = tuple(
        sum(1 for l in stwig.child_labels if l == stwig.child_labels[i])
        for i in range(k)
    )
    return STwigSpec(
        root_label=stwig.root_label,
        child_labels=stwig.child_labels,
        root_qnode=stwig.root,
        child_qnodes=stwig.children,
        root_bound=stwig.root in bound_before,
        child_bound=tuple(c_ in bound_before for c_ in stwig.children),
        root_cap=r,
        child_cap=c,
        rows_cap=rows_cap,
        same_label_child_pairs=pairs,
        root_label_child_positions=root_kids,
        child_need=need,
    )


def make_plan(
    query: QueryGraph,
    freq: np.ndarray,
    *,
    root_cap: int = 1024,
    child_cap: int = 8,
    emission_budget: int = 1 << 18,
    join_rows_cap: int = 1 << 16,
    join_dup_cap: int = 64,
    join_block: int = 2048,
    max_matches: int = 1024,
    decomposition: Decomposition | None = None,
) -> QueryPlan:
    """Full planning: Algorithm 2 + head selection + static capacities."""
    dec = decomposition or stwig_order_selection(query, freq)
    assert dec.covers(query) and dec.edge_disjoint(), "bad STwig cover"
    head, dists = head_stwig_selection(query, dec)
    specs = tuple(
        _spec_for(
            t,
            bb,
            root_cap=root_cap,
            child_cap=child_cap,
            emission_budget=emission_budget,
        )
        for t, bb in zip(dec.stwigs, dec.bound_before)
    )
    return QueryPlan(
        query=query,
        specs=specs,
        head=head,
        head_dists=tuple(int(d) for d in dists),
        join_rows_cap=join_rows_cap,
        join_dup_cap=join_dup_cap,
        join_block=join_block,
        max_matches=max_matches,
    )
