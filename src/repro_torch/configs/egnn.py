"""egnn [gnn]: 4L d_hidden=64 E(n)-equivariant [arXiv:2102.09844] — the
JAX package's ``configs/egnn.py``."""
from repro_torch.configs.base import ArchEntry, GNNConfig, register

CONFIG = GNNConfig(
    name="egnn", kind="egnn", n_layers=4, d_hidden=64, n_classes=16,
)


def smoke() -> GNNConfig:
    return GNNConfig(
        name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=16, d_in=8,
        n_classes=5,
    )


ENTRY = register(
    ArchEntry(
        arch_id="egnn",
        family="gnn",
        config=CONFIG,
        smoke=smoke,
        shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    )
)
