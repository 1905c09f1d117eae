"""Config dataclasses, copied from the JAX package's ``configs/base.py``:
only what a ported model path reads (the GNN and recsys families so far)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                        # gatedgcn | egnn | gin | meshgraphnet
    n_layers: int
    d_hidden: int
    d_in: int = 64                   # input feature dim (overridden per shape)
    d_edge: int = 0
    n_classes: int = 16
    aggregator: str = "sum"
    mlp_layers: int = 2              # meshgraphnet per-MLP depth
    learnable_eps: bool = True       # GIN-ε
    task: str = "node"               # node | graph | regression
    dtype: str = "float32"


# The GNN input shapes of ``src/repro/extras/shapes.py`` (``GNN_SHAPES``):
# nodes, directed edges, input feature width, task.
GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d=1433, task="node"),
    "minibatch_lg": dict(n=170624, e=168960, d=602, task="node"),
    "ogb_products": dict(n=2449029, e=61859140, d=100, task="node"),
    "molecule": dict(n=3840, e=8192, d=32, task="graph", n_graphs=128),
}


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    bag_size: int = 1                # multi-hot bag length (EmbeddingBag)
    dtype: str = "float32"
