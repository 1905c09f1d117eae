"""Fanout neighbor sampler (GraphSAGE-style) for minibatch GNN batches —
copied from the JAX package's ``graphstore/sampler.py`` (numpy only), so
that both packages sample the same subgraph from the same seed.

The ``minibatch_lg`` shape regime (batch_nodes=1024, fanout 15-10) needs a
real sampler: given seed nodes, sample up to ``fanout[l]`` neighbors per node
per hop from the CSR adjacency, emit a padded subgraph (node list + edge
index) with static shapes so the jitted train step never recompiles.

Host-side numpy (samplers are data-pipeline work, they run on CPU feeders in
a real deployment); the output tensors are what ``input_specs`` mirrors for
the dry-run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphstore.csr import Graph


@dataclasses.dataclass
class SampledSubgraph:
    """Padded k-hop sampled subgraph.

    nodes:     (n_node_cap,) int32 global node ids, pad = -1
    n_nodes:   int, real count
    edge_src:  (n_edge_cap,) int32 *local* indices into ``nodes``
    edge_dst:  (n_edge_cap,) int32 local indices (messages flow src -> dst)
    edge_mask: (n_edge_cap,) bool
    seed_mask: (n_node_cap,) bool — which rows are the labeled seed nodes
    """

    nodes: np.ndarray
    n_nodes: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seed_mask: np.ndarray

    @property
    def node_cap(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def edge_cap(self) -> int:
        return int(self.edge_src.shape[0])


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: tuple[int, ...], *, seed: int = 0):
        self.g = g
        self.fanouts = tuple(int(f) for f in fanouts)
        self.rng = np.random.default_rng(seed)

    def capacities(self, batch_nodes: int) -> tuple[int, int]:
        """Static (node_cap, edge_cap) implied by batch size and fanouts."""
        node_cap = batch_nodes
        edge_cap = 0
        frontier = batch_nodes
        for f in self.fanouts:
            edge_cap += frontier * f
            frontier *= f
            node_cap += frontier
        return node_cap, edge_cap

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        """Sample the k-hop neighborhood of ``seeds`` with per-hop fanouts."""
        g, rng = self.g, self.rng
        seeds = np.asarray(seeds, dtype=np.int64)
        node_cap, edge_cap = self.capacities(len(seeds))

        id_of: dict[int, int] = {}
        nodes: list[int] = []

        def intern(vs: np.ndarray) -> np.ndarray:
            out = np.empty(len(vs), dtype=np.int32)
            for i, v in enumerate(vs):
                j = id_of.get(int(v))
                if j is None:
                    j = len(nodes)
                    id_of[int(v)] = j
                    nodes.append(int(v))
                out[i] = j
            return out

        intern(seeds)
        frontier = seeds
        e_src: list[np.ndarray] = []
        e_dst: list[np.ndarray] = []
        for f in self.fanouts:
            nbr_src, nbr_dst = [], []
            deg = np.diff(g.indptr)[frontier]
            for v, d in zip(frontier, deg):
                if d == 0:
                    continue
                take = min(int(d), f)
                if d <= f:
                    picks = g.indices[g.indptr[v] : g.indptr[v + 1]]
                else:
                    offs = rng.choice(int(d), size=take, replace=False)
                    picks = g.indices[g.indptr[v] + offs]
                nbr_src.append(np.full(take, v, dtype=np.int64))
                nbr_dst.append(picks.astype(np.int64))
            if not nbr_src:
                break
            s = np.concatenate(nbr_src)
            t = np.concatenate(nbr_dst)
            # messages flow neighbor -> center: edge (t -> s)
            e_src.append(intern(t))
            e_dst.append(intern(s))
            frontier = np.unique(t)

        src = np.concatenate(e_src) if e_src else np.zeros(0, np.int32)
        dst = np.concatenate(e_dst) if e_dst else np.zeros(0, np.int32)
        n_real_e = len(src)
        n_real_n = len(nodes)
        assert n_real_n <= node_cap and n_real_e <= edge_cap, (
            n_real_n, node_cap, n_real_e, edge_cap,
        )

        nodes_arr = np.full(node_cap, -1, dtype=np.int32)
        nodes_arr[:n_real_n] = np.asarray(nodes, dtype=np.int32)
        edge_src = np.zeros(edge_cap, dtype=np.int32)
        edge_dst = np.zeros(edge_cap, dtype=np.int32)
        edge_mask = np.zeros(edge_cap, dtype=bool)
        edge_src[:n_real_e] = src
        edge_dst[:n_real_e] = dst
        edge_mask[:n_real_e] = True
        seed_mask = np.zeros(node_cap, dtype=bool)
        seed_mask[: len(seeds)] = True
        return SampledSubgraph(
            nodes=nodes_arr,
            n_nodes=n_real_n,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=edge_mask,
            seed_mask=seed_mask,
        )
