"""Synthetic graph generators (copied from the JAX package, numpy only).

The paper evaluates on R-MAT graphs (§6.3, citing Chakrabarti et al. [8]) plus
two real datasets (US Patents, WordNet). The real datasets are replaced by
R-MAT graphs with matched node/edge/label counts, made from a seed.
`ring_of_cliques` is the fixture whose range partition has a ring for its
cluster graph: the case the sharded engine's ring fetch is built for.
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
