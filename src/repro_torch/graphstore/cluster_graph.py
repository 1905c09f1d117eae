"""Cluster graph + load-set machinery (paper §5.3, Theorems 3-5).

Preprocessing: for every pair of shards ``(i, j)`` record the set of label
pairs ``(A, B)`` such that some data edge ``u→v`` with ``T(u)=A, T(v)=B``
crosses from shard ``i`` to shard ``j``. At query time the *cluster graph*
``C`` keeps only shard pairs whose label-pair set intersects the query's edge
label pairs; BFS distances ``D_C`` then bound which remote shards can possibly
contribute joinable STwig results (Theorem 4):

    F_{k,t} = { j : D_C(k, j) <= d(r_head, r_t) }

and the head STwig is chosen to minimize total communication (Theorem 5).

The JAX package's ``graphstore/cluster_graph.py`` (host numpy only), with
the same index and load sets; `ClusterGraphIndex.build` finds the unique
keys in a bitmap where the key space is small, and cuts the sorted keys
into label pairs in one pass instead of a loop a label pair. The
sharded engine (`repro_torch.core.dist`) reads its load sets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClusterGraphIndex:
    """Host-side preprocessing result.

    ``pair_index`` maps a label pair key ``A * n_labels + B`` to a bool
    (S, S) shard adjacency. Stored sparsely as a dict of packed shard-pair
    sets; for the label alphabets in the paper (≤ ~420) and S ≤ 512 this is
    small. Built once per graph (linear scan over edges).
    """

    n_shards: int
    n_labels: int
    pair_index: dict[int, np.ndarray]  # key -> (n_pairs, 2) int32 shard pairs

    @staticmethod
    def build(pg) -> "ClusterGraphIndex":
        si, sj, la, lb = pg.edge_shard_pairs()
        n_labels = pg.n_labels
        S = pg.n_shards
        # unique (label_pair, shard_pair) rows — one vectorized pass; the
        # sorted keys run label pair by label pair, shard pairs ascending
        key = ((la.astype(np.int64) * n_labels + lb) * S + si) * S + sj
        space = n_labels * n_labels * S * S
        if space <= 4 * key.shape[0] + (1 << 20):  # a bitmap of the key space: no sort
            seen = np.zeros(space, dtype=bool)
            seen[key] = True
            key = np.flatnonzero(seen)
        else:
            key = np.unique(key)
        pairs = np.stack([(key // S) % S, key % S], axis=1).astype(np.int32)
        lp = key // (S * S)
        starts = np.flatnonzero(np.concatenate([[True], lp[1:] != lp[:-1]]))
        # one (n_pairs, 2) block of ``pairs`` a label pair
        pair_index = dict(zip(lp[starts].tolist(), np.split(pairs, starts[1:])))
        return ClusterGraphIndex(S, n_labels, pair_index)

    # ------------------------------------------------------------ query time
    def cluster_adjacency(
        self, query_label_pairs: list[tuple[int, int]]
    ) -> np.ndarray:
        """Bool (S, S) adjacency of the query-specific cluster graph C.
        ``C[i, i]`` is always True (distance 0 to self)."""
        S = self.n_shards
        C = np.zeros((S, S), dtype=bool)
        np.fill_diagonal(C, True)
        for a, b in query_label_pairs:
            for la, lb in ((a, b), (b, a)):  # data edges are symmetrized
                pairs = self.pair_index.get(int(la) * self.n_labels + int(lb))
                if pairs is not None:
                    C[pairs[:, 0], pairs[:, 1]] = True
        return C

    @staticmethod
    def bfs_distances(C: np.ndarray) -> np.ndarray:
        """All-pairs BFS distances on the cluster graph. Unreachable = a
        large sentinel (S, never ≤ any query distance)."""
        S = C.shape[0]
        INF = np.int32(S + 1)
        D = np.full((S, S), INF, dtype=np.int32)
        reach = np.eye(S, dtype=bool)
        D[reach] = 0
        frontier = reach
        for dist in range(1, S + 1):
            nxt = (frontier @ C) & ~reach
            if not nxt.any():
                break
            D[nxt] = dist
            reach |= nxt
            frontier = nxt
        return D

    def load_sets(
        self,
        query_label_pairs: list[tuple[int, int]],
        head_to_root_dist: np.ndarray,
    ) -> np.ndarray:
        """Bool (n_stwigs, S, S) mask: entry (t, k, j) says shard k must load
        results of STwig t from shard j (Theorem 4). Row for the head STwig
        is the identity (F = ∅ plus self)."""
        C = self.cluster_adjacency(query_label_pairs)
        D = self.bfs_distances(C)
        out = np.zeros(
            (len(head_to_root_dist), self.n_shards, self.n_shards), dtype=bool
        )
        for t, d in enumerate(head_to_root_dist):
            out[t] = D <= np.int32(d)
        return out
