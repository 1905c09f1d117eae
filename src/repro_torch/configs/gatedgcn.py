"""gatedgcn [gnn]: 16L d_hidden=70 gated aggregator [arXiv:2003.00982] —
the JAX package's ``configs/gatedgcn.py``."""
from repro_torch.configs.base import ArchEntry, GNNConfig, register

CONFIG = GNNConfig(
    name="gatedgcn", kind="gatedgcn", n_layers=16, d_hidden=70,
    d_edge=8, aggregator="gated", n_classes=16,
)


def smoke() -> GNNConfig:
    return GNNConfig(
        name="gatedgcn-smoke", kind="gatedgcn", n_layers=3, d_hidden=16,
        d_in=8, d_edge=4, aggregator="gated", n_classes=5,
    )


ENTRY = register(
    ArchEntry(
        arch_id="gatedgcn",
        family="gnn",
        config=CONFIG,
        smoke=smoke,
        shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    )
)
