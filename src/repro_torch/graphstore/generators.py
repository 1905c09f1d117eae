"""Synthetic graph generators (copied from the JAX package, numpy only).

The paper evaluates on R-MAT graphs (§6.3, citing Chakrabarti et al. [8]) plus
two real datasets (US Patents, WordNet). The real datasets are replaced by
R-MAT graphs with matched node/edge/label counts, made from a seed.
`ring_of_cliques` is the fixture whose range partition has a ring for its
cluster graph: the case the sharded engine's ring fetch is built for.
`molecule_batch` is the GNN ``molecule`` shape's input. Every generator
makes the same numpy draws in the same order as the JAX package's, so a
seed gives the same `Graph`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphstore.csr import Graph


def assign_labels(
    n_nodes: int, n_labels: int, rng: np.random.Generator, *, zipf_s: float = 0.0
) -> np.ndarray:
    """Assign labels; ``zipf_s > 0`` gives a power-law label distribution
    (real graphs' labels are skewed; the paper calls this *label density*)."""
    if zipf_s <= 0.0:
        return rng.integers(0, n_labels, size=n_nodes, dtype=np.int32)
    w = 1.0 / np.arange(1, n_labels + 1, dtype=np.float64) ** zipf_s
    w /= w.sum()
    return rng.choice(n_labels, size=n_nodes, p=w).astype(np.int32)


def rmat(
    n_nodes: int,
    n_edges: int,
    n_labels: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    zipf_s: float = 0.0,
    symmetrize: bool = True,
) -> Graph:
    """R-MAT recursive matrix generator [Chakrabarti et al., SDM'04].

    Vectorized: all edges draw their quadrant bits at once, one level of the
    recursion per bit of ``log2(n)``.
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_nodes, 2))))
    d = 1.0 - a - b - c
    probs = np.array([a, b, c, d])
    thresholds = np.cumsum(probs)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        quad = np.searchsorted(thresholds, r)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    src %= n_nodes
    dst %= n_nodes
    labels = assign_labels(n_nodes, n_labels, rng, zipf_s=zipf_s)
    return Graph.from_edges(
        n_nodes, src, dst, labels, n_labels, symmetrize=symmetrize
    )


def erdos_renyi(
    n_nodes: int, n_edges: int, n_labels: int, *, seed: int = 0
) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    labels = assign_labels(n_nodes, n_labels, rng)
    return Graph.from_edges(n_nodes, src, dst, labels, n_labels)


def ring_of_cliques(
    n_cliques: int, clique_size: int, n_labels: int, *, seed: int = 0
) -> Graph:
    """Cliques joined in a ring — a high-locality graph. When partitioned by
    node ranges, its cluster graph (§5.3) is a ring, so load sets are small:
    the fixture used to exercise Theorems 3-5 in a non-degenerate way."""
    rng = np.random.default_rng(seed)
    n_nodes = n_cliques * clique_size
    srcs, dsts = [], []
    iu, ju = np.triu_indices(clique_size, k=1)
    for c in range(n_cliques):
        off = c * clique_size
        srcs.append(iu + off)
        dsts.append(ju + off)
        # one bridge edge to the next clique
        srcs.append(np.array([off + clique_size - 1]))
        dsts.append(np.array([(off + clique_size) % n_nodes]))
    labels = assign_labels(n_nodes, n_labels, rng)
    return Graph.from_edges(
        n_nodes, np.concatenate(srcs), np.concatenate(dsts), labels, n_labels
    )


def grid_2d(rows: int, cols: int, n_labels: int, *, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    labels = assign_labels(n, n_labels, rng)
    return Graph.from_edges(n, src, dst, labels, n_labels)


def paper_fig6_query_edges() -> tuple[list[tuple[str, str]], dict[str, str]]:
    """The §5.2 walkthrough query: used to unit-test Algorithm 2.

    Nodes a..f; Algorithm 2 with freq(l)=10 for all labels must produce
    T1={d,(b,c,e,f)}, T2={c,(a,f)}, T3={b,(a,f)}.
    """
    edges = [
        ("d", "b"), ("d", "c"), ("d", "e"), ("d", "f"),
        ("c", "a"), ("c", "f"), ("b", "a"), ("b", "f"),
    ]
    labels = {v: v for v in "abcdef"}
    return edges, labels


def molecule_batch(
    n_graphs: int,
    nodes_per_graph: int,
    avg_degree: float,
    n_labels: int,
    *,
    seed: int = 0,
) -> Graph:
    """A disjoint union of small random molecules (batched-small-graphs
    regime). Returned as one block-diagonal graph; `graph_id = node //
    nodes_per_graph`. Each molecule draws ``e_per = max(1,
    int(nodes_per_graph * avg_degree / 2))`` edges (rounded down);
    `Graph.from_edges` then drops self-loops and duplicates and stores each
    edge in both directions, so the graph has at most ``2 · n_graphs ·
    e_per`` directed edges."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per_graph
    e_per = max(1, int(nodes_per_graph * avg_degree / 2))
    src = rng.integers(0, nodes_per_graph, size=(n_graphs, e_per))
    dst = rng.integers(0, nodes_per_graph, size=(n_graphs, e_per))
    offs = (np.arange(n_graphs) * nodes_per_graph)[:, None]
    labels = assign_labels(n, n_labels, rng)
    return Graph.from_edges(
        n, (src + offs).ravel(), (dst + offs).ravel(), labels, n_labels
    )
