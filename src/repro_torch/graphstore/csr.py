"""Host-side labeled graph with CSR adjacency.

This is the construction-time representation. ``PartitionedGraph``
(partition.py) turns it into the sharded, padded, device-ready layout used by
the matching engine and the GNN models.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """A labeled graph in CSR form (host / numpy).

    Attributes:
      n_nodes:   number of vertices.
      n_labels:  size of the label alphabet; labels are ints in [0, n_labels).
      labels:    (n_nodes,) int32 vertex labels.
      indptr:    (n_nodes+1,) int64 CSR row pointers.
      indices:   (n_edges,) int32 CSR column indices (out-neighbors).
      directed:  whether ``indices`` is a directed out-adjacency. The STwig
                 matcher follows edges as stored; for undirected semantics
                 build with ``symmetrize=True`` (the default used everywhere
                 in the paper's experiments).
    """

    n_nodes: int
    n_labels: int
    labels: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    directed: bool = False

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_edges(
        n_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        labels: np.ndarray,
        n_labels: int,
        *,
        symmetrize: bool = True,
        dedup: bool = True,
    ) -> "Graph":
        """Build a CSR graph from an edge list.

        Self-loops are removed (the paper's query graphs are simple graphs).
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if dedup and len(src):
            key = src * n_nodes + dst
            key = np.unique(key)
            src, dst = key // n_nodes, key % n_nodes
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(
            n_nodes=n_nodes,
            n_labels=n_labels,
            labels=np.asarray(labels, dtype=np.int32),
            indptr=indptr,
            indices=dst.astype(np.int32),
            directed=not symmetrize,
        )

    # ------------------------------------------------------------- accessors
    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def max_degree(self) -> int:
        return int(self.degrees().max()) if self.n_nodes else 0

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def label_frequencies(self) -> np.ndarray:
        """freq(l) = number of data nodes with label l (paper §5.2 f-values)."""
        return np.bincount(self.labels, minlength=self.n_labels).astype(np.int64)

    # ----------------------------------------------------------------- utils
    def relabel(self, perm: np.ndarray) -> "Graph":
        """Apply a node permutation: new_id = perm[old_id]."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n_nodes, dtype=perm.dtype)
        new_src = np.repeat(perm, np.diff(self.indptr))
        new_dst = perm[self.indices]
        return Graph.from_edges(
            self.n_nodes,
            new_src,
            new_dst,
            self.labels[inv],
            self.n_labels,
            symmetrize=False,
            dedup=False,
        )

    def memory_bytes(self) -> int:
        return (
            self.labels.nbytes + self.indptr.nbytes + self.indices.nbytes
        )
