"""Query-workload generators (paper §6.1).

The paper evaluates with queries sampled from the data graph (DFS queries —
guaranteed at least one match) and random label/topology queries. Copied
from the JAX package's ``repro/workloads.py``, so the same seed draws the
same queries in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.query import QueryGraph
from repro_torch.graphstore.csr import Graph


def dfs_query(g: Graph, rng: np.random.Generator, n_nodes: int) -> QueryGraph | None:
    """Paper §6.1 DFS query: traverse from a random node, keep the first
    ``n_nodes`` visited (None if the start node is too isolated)."""
    start = int(rng.integers(g.n_nodes))
    nodes, edges, seen = [start], [], {start}
    stack = [start]
    while stack and len(nodes) < n_nodes:
        v = stack.pop()
        for u in g.neighbors(v):
            u = int(u)
            if u not in seen and len(nodes) < n_nodes:
                seen.add(u)
                nodes.append(u)
                edges.append((v, u))
                stack.append(u)
    if len(nodes) < 2:
        return None
    remap = {v: i for i, v in enumerate(nodes)}
    return QueryGraph.build(
        [int(g.labels[v]) for v in nodes],
        [(remap[a], remap[b]) for a, b in edges],
    )


def path_query(g: Graph, rng: np.random.Generator, n_nodes: int) -> QueryGraph | None:
    """A simple-path query sampled from the data graph (always matchable,
    like `dfs_query`, but guaranteed path topology). Paths of ≥4 nodes
    decompose into ≥2 STwigs, so they exercise the join phase — `dfs_query`
    often lands on a star, which a single STwig covers."""
    v = int(rng.integers(g.n_nodes))
    nodes = [v]
    while len(nodes) < n_nodes:
        nbrs = [int(u) for u in g.neighbors(nodes[-1]) if int(u) not in nodes]
        if not nbrs:
            return None
        nodes.append(nbrs[int(rng.integers(len(nbrs)))])
    return QueryGraph.build(
        [int(g.labels[v]) for v in nodes],
        [(i, i + 1) for i in range(n_nodes - 1)],
    )


def random_query(
    n_nodes: int, n_edges: int, n_labels: int, rng: np.random.Generator
) -> QueryGraph:
    """Random connected query: a random tree plus extra random edges, with
    uniform random labels."""
    edges = [(int(rng.integers(i)), i) for i in range(1, n_nodes)]
    seen = {(min(a, b), max(a, b)) for a, b in edges}
    tries = 0
    while len(edges) < n_edges and tries < 10 * n_edges:
        a, b = rng.integers(n_nodes, size=2)
        tries += 1
        key = (min(a, b), max(a, b))
        if a != b and key not in seen:
            seen.add(key)
            edges.append((int(a), int(b)))
    return QueryGraph.build(
        rng.integers(0, n_labels, n_nodes).astype(int).tolist(), edges
    )


def mixed_workload(
    g: Graph,
    n_queries: int,
    *,
    n_labels: int,
    rng: np.random.Generator,
    min_nodes: int = 4,
    max_nodes: int = 8,
) -> list[QueryGraph]:
    """The serving mix: alternate DFS (always matchable) and random (often
    empty) queries. The same ``rng`` state draws the JAX package's list."""
    out: list[QueryGraph] = []
    for i in range(n_queries):
        nq = int(rng.integers(min_nodes, max_nodes))
        q = (
            dfs_query(g, rng, nq)
            if i % 2 == 0
            else random_query(nq, 8, n_labels, rng)
        )
        if q is not None:
            out.append(q)
    return out
