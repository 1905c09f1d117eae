"""Query graphs and STwigs (paper §2.1, §4.1).

A subgraph query q = (V_q, E_q, T_q). Query nodes are integers 0..n-1 with
integer labels into the data graph's label alphabet. Unlike the paper's
presentation (which assumes uniquely-labeled query nodes for exposition), we
carry query-node ids everywhere, so duplicate labels are fully supported.

An STwig is a two-level tree q_i = (root, children): the *basic unit of graph
access* (§4.1).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class QueryGraph:
    n_nodes: int
    labels: tuple[int, ...]              # per query node
    edges: tuple[tuple[int, int], ...]   # undirected, u < v canonical

    @staticmethod
    def build(labels: list[int], edges: list[tuple[int, int]]) -> "QueryGraph":
        canon = sorted({(min(u, v), max(u, v)) for u, v in edges if u != v})
        return QueryGraph(
            n_nodes=len(labels), labels=tuple(labels), edges=tuple(canon)
        )

    def adjacency(self) -> list[set[int]]:
        adj: list[set[int]] = [set() for _ in range(self.n_nodes)]
        for u, v in self.edges:
            adj[u].add(v)
            adj[v].add(u)
        return adj

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n_nodes, dtype=np.int64)
        for u, v in self.edges:
            deg[u] += 1
            deg[v] += 1
        return deg

    def shortest_paths(self) -> np.ndarray:
        """All-pairs shortest path lengths via Floyd-Warshall (§5.3: head
        STwig selection computes the matrix M). Queries are tiny (≤ ~32
        nodes) so O(n^3) host-side is free."""
        n = self.n_nodes
        INF = n + 1
        M = np.full((n, n), INF, dtype=np.int32)
        np.fill_diagonal(M, 0)
        for u, v in self.edges:
            M[u, v] = M[v, u] = 1
        for k in range(n):
            M = np.minimum(M, M[:, k : k + 1] + M[k : k + 1, :])
        return M

    def label_pairs(self) -> list[tuple[int, int]]:
        """Label pairs of query edges — drives the cluster graph (§5.3)."""
        return [(self.labels[u], self.labels[v]) for u, v in self.edges]

    def is_connected(self) -> bool:
        if self.n_nodes == 0:
            return True
        adj = self.adjacency()
        seen = {0}
        stack = [0]
        while stack:
            for w in adj[stack.pop()]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == self.n_nodes


@dataclasses.dataclass(frozen=True)
class STwig:
    """Two-level tree: root query-node + child query-nodes (§4.1)."""

    root: int
    children: tuple[int, ...]
    root_label: int
    child_labels: tuple[int, ...]

    @staticmethod
    def of(q: QueryGraph, root: int, children: list[int]) -> "STwig":
        return STwig(
            root=root,
            children=tuple(children),
            root_label=q.labels[root],
            child_labels=tuple(q.labels[c] for c in children),
        )

    @property
    def qnodes(self) -> tuple[int, ...]:
        return (self.root,) + self.children

    @property
    def width(self) -> int:
        return 1 + len(self.children)

    def covered_edges(self) -> set[tuple[int, int]]:
        return {(min(self.root, c), max(self.root, c)) for c in self.children}
