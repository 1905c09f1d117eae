"""Query decomposition + STwig order selection (paper §5.1-§5.2, Algorithm 2).

Minimum STwig cover ≡ minimum vertex cover (Theorem 1, NP-hard), so the paper
uses a revised 2-approximation (Theorem 2) whose edge selection is guided by

  * rule 1 — prefer edges touching nodes bound by already-emitted STwigs, so
    every non-first STwig's root is bound (exploration prunes via bindings);
  * rule 2 — prefer high-selectivity nodes, ranked by the f-value
    f(v) = deg(v) / freq(v.label).

This module is a faithful transcription of Algorithm 2, plus the metadata the
matcher needs downstream (which query nodes are bound before each STwig).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.query import QueryGraph, STwig


@dataclasses.dataclass
class Decomposition:
    stwigs: list[STwig]
    # bound_before[i] = set of query nodes bound by stwigs[0..i-1]
    bound_before: list[set[int]]

    def covers(self, q: QueryGraph) -> bool:
        cov: set[tuple[int, int]] = set()
        for t in self.stwigs:
            cov |= t.covered_edges()
        return cov == set(q.edges)

    def edge_disjoint(self) -> bool:
        seen: set[tuple[int, int]] = set()
        for t in self.stwigs:
            for e in t.covered_edges():
                if e in seen:
                    return False
                seen.add(e)
        return True


def f_values(q: QueryGraph, freq: np.ndarray) -> np.ndarray:
    """f(v) = deg(v)/freq(label(v)); freq from the data graph (§5.2)."""
    deg = q.degrees().astype(np.float64)
    fr = np.maximum(freq[np.asarray(q.labels)], 1).astype(np.float64)
    return deg / fr


def stwig_order_selection(q: QueryGraph, freq: np.ndarray) -> Decomposition:
    """Algorithm 2 (STwig-Order-Selection).

    Returns the ordered STwig list T. Deterministic tie-breaking: highest
    f-value sum, then lexicographic (v, u).
    """
    adj = {v: set(ws) for v, ws in enumerate(q.adjacency())}
    live_edges: set[tuple[int, int]] = set(q.edges)
    f = f_values(q, freq)

    S: set[int] = set()
    stwigs: list[STwig] = []
    bound_before: list[set[int]] = []
    bound: set[int] = set()

    def deg(v: int) -> int:
        return len(adj[v])

    def pick_edge() -> tuple[int, int]:
        # returns (v, u) where v is the (first) STwig root
        best = None
        best_key = None
        for a, b in live_edges:
            for v, u in ((a, b), (b, a)):
                if S and v not in S:
                    continue
                key = (f[v] + f[u], f[v], -v, -u)
                if best_key is None or key > best_key:
                    best_key, best = key, (v, u)
        if best is None:  # S nonempty but disconnected remainder: restart rule
            best = max(
                ((a, b) for a, b in live_edges),
                key=lambda e: (f[e[0]] + f[e[1]], -e[0], -e[1]),
            )
        return best

    def emit(root: int) -> None:
        children = sorted(adj[root])
        stwigs.append(STwig.of(q, root, children))
        bound_before.append(set(bound))
        bound.add(root)
        bound.update(children)
        S.update(children)
        for c in children:
            adj[c].discard(root)
            live_edges.discard((min(root, c), max(root, c)))
        adj[root] = set()

    while live_edges:
        v, u = pick_edge()
        emit(v)
        if deg(u) > 0:
            emit(u)
        # remove u, v and degree-0 nodes from S
        S.discard(u)
        S.discard(v)
        for w in list(S):
            if deg(w) == 0:
                S.discard(w)

    return Decomposition(stwigs=stwigs, bound_before=bound_before)


def head_stwig_selection(
    q: QueryGraph, dec: Decomposition
) -> tuple[int, np.ndarray]:
    """§5.3: choose head STwig minimizing d(s) = max_i d(r_s, r_i) over the
    query's shortest-path matrix; return (head index, per-STwig distances
    d(r_head, r_t)) used for load sets (Theorem 4)."""
    M = q.shortest_paths()
    roots = [t.root for t in dec.stwigs]
    d = np.array([max(M[r, r2] for r2 in roots) for r in roots])
    head = int(np.argmin(d))
    dists = np.array([M[roots[head], r] for r in roots], dtype=np.int32)
    return head, dists
