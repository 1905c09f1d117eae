"""meshgraphnet [gnn]: 15L d_hidden=128 sum aggregator mlp_layers=2
[arXiv:2010.03409; unverified] — the JAX package's
``configs/meshgraphnet.py``."""
from repro_torch.configs.base import ArchEntry, GNNConfig, register

CONFIG = GNNConfig(
    name="meshgraphnet", kind="meshgraphnet", n_layers=15, d_hidden=128,
    d_edge=8, aggregator="sum", mlp_layers=2, task="regression", n_classes=1,
)


def smoke() -> GNNConfig:
    return GNNConfig(
        name="meshgraphnet-smoke", kind="meshgraphnet", n_layers=2,
        d_hidden=16, d_in=8, d_edge=4, mlp_layers=2, task="regression",
        n_classes=1,
    )


ENTRY = register(
    ArchEntry(
        arch_id="meshgraphnet",
        family="gnn",
        config=CONFIG,
        smoke=smoke,
        shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    )
)
