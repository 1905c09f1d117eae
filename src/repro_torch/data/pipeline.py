"""Seeded synthetic batches, copied from the JAX package's
``data/pipeline.py`` so that both packages see the same inputs from the same
seed. numpy only."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.graphstore.csr import Graph
from repro_torch.graphstore.sampler import NeighborSampler
from repro_torch.models.gnn import GraphBatch


def lm_batch(cfg: LMConfig, batch: int, seq: int, *, seed: int, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipfian tokens: realistic softmax/label statistics
    z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    return {"tokens": (z % cfg.vocab_size).astype(np.int32)}


def gnn_full_batch(
    cfg: GNNConfig, g: Graph, *, n_classes: int, seed: int
) -> GraphBatch:
    """Full-graph batch straight from a graphstore Graph (host numpy)."""
    rng = np.random.default_rng(seed)
    N, E = g.n_nodes, g.n_edges
    src = np.repeat(np.arange(N, dtype=np.int32), np.diff(g.indptr))
    dst = g.indices.astype(np.int32)
    return GraphBatch(
        node_feat=rng.normal(size=(N, cfg.d_in)).astype(np.float32),
        edge_src=src,
        edge_dst=dst,
        node_mask=np.ones(N, bool),
        edge_mask=np.ones(E, bool),
        edge_feat=rng.normal(size=(E, cfg.d_edge)).astype(np.float32)
        if cfg.d_edge
        else None,
        node_pos=rng.normal(size=(N, 3)).astype(np.float32)
        if cfg.kind == "egnn"
        else None,
        graph_id=None,
        n_graphs=1,
        labels=rng.normal(size=(N,)).astype(np.float32)
        if cfg.task == "regression"
        else rng.integers(0, n_classes, N).astype(np.int32),
        label_mask=np.ones(N, bool),
    )


def gnn_minibatch(
    cfg: GNNConfig,
    g: Graph,
    sampler: NeighborSampler,
    *,
    batch_nodes: int,
    n_classes: int,
    seed: int,
    step: int,
) -> GraphBatch:
    """Sampled k-hop minibatch (the minibatch_lg regime), host numpy."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    seeds = rng.choice(g.n_nodes, size=batch_nodes, replace=False)
    sub = sampler.sample(seeds)
    N = sub.node_cap
    feat_rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    # features keyed by global node id hash → consistent across batches
    feats = feat_rng.normal(size=(1, cfg.d_in)).astype(np.float32)
    node_feat = np.tile(feats, (N, 1)) * (1 + (sub.nodes[:, None] % 13) / 13.0)
    labels = (np.maximum(sub.nodes, 0) % n_classes).astype(np.int32)
    return GraphBatch(
        node_feat=node_feat.astype(np.float32),
        edge_src=sub.edge_src,
        edge_dst=sub.edge_dst,
        node_mask=sub.nodes >= 0,
        edge_mask=sub.edge_mask,
        edge_feat=np.zeros((sub.edge_cap, cfg.d_edge), np.float32)
        if cfg.d_edge
        else None,
        node_pos=np.zeros((N, 3), np.float32) if cfg.kind == "egnn" else None,
        graph_id=None,
        n_graphs=1,
        labels=labels,
        label_mask=sub.seed_mask,
    )


def recsys_batch(
    cfg: RecSysConfig, batch: int, *, seed: int, step: int
) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ids = rng.zipf(1.2, size=(batch, cfg.n_sparse, cfg.bag_size))
    ids = (ids % cfg.vocab_per_field).astype(np.int32)
    mask = rng.random((batch, cfg.n_sparse, cfg.bag_size)) < 0.7
    mask[..., 0] = True  # at least one id per bag
    # labels correlated with a random linear model over first ids
    w = np.random.default_rng(seed).normal(size=cfg.n_sparse)
    score = (ids[..., 0] % 97 / 97.0) @ w
    labels = (score > np.median(score)).astype(np.int32)
    return {"ids": ids, "bag_mask": mask, "labels": labels}


def gnn_graph_batch(
    cfg: GNNConfig,
    g: Graph,
    *,
    nodes_per_graph: int,
    n_edges: int,
    n_classes: int,
    seed: int,
) -> GraphBatch:
    """Graph-level batch (the ``molecule`` regime): ``gnn_full_batch`` of the
    block-diagonal union of small graphs that ``generators.molecule_batch``
    makes, every stored (directed) edge padded to ``n_edges`` slots with
    masked edges at node 0, ``graph_id = node // nodes_per_graph`` and one
    label a graph. Raises if the edges do not fit."""
    if g.n_edges > n_edges:
        raise ValueError(f"{g.n_edges} directed edges do not fit {n_edges} slots")
    b = gnn_full_batch(cfg, g, n_classes=n_classes, seed=seed)
    pad = n_edges - g.n_edges

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    n_graphs = g.n_nodes // nodes_per_graph
    rng = np.random.default_rng([seed, 1])
    return b._replace(
        edge_src=padded(b.edge_src),
        edge_dst=padded(b.edge_dst),
        edge_mask=padded(b.edge_mask),
        edge_feat=None if b.edge_feat is None else padded(b.edge_feat),
        graph_id=(np.arange(g.n_nodes) // nodes_per_graph).astype(np.int32),
        n_graphs=n_graphs,
        labels=rng.normal(size=(n_graphs,)).astype(np.float32)
        if cfg.task == "regression"
        else rng.integers(0, n_classes, n_graphs).astype(np.int32),
        label_mask=None,
    )
