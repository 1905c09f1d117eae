"""gin-tu [gnn]: 5L d_hidden=64 sum aggregator, learnable eps
[arXiv:1810.00826] — the JAX package's ``configs/gin_tu.py``. ``d_in`` is
set by the input shape (``dataclasses.replace``), as there."""
from repro_torch.configs.base import ArchEntry, GNNConfig, register

CONFIG = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
    aggregator="sum", learnable_eps=True, n_classes=16,
)


def smoke() -> GNNConfig:
    return GNNConfig(
        name="gin-tu-smoke", kind="gin", n_layers=2, d_hidden=16, d_in=8,
        n_classes=5,
    )


ENTRY = register(
    ArchEntry(
        arch_id="gin-tu",
        family="gnn",
        config=CONFIG,
        smoke=smoke,
        shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    )
)
