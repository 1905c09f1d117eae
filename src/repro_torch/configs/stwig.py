"""The paper's own system config: graph workload + engine capacities — the
JAX package's ``configs/stwig.py``.

`CONFIG` is the paper's default run (§6.3): 64,000,000 nodes over 256
shards, 250,000 nodes a shard. The sharded engine
(`repro_torch.core.dist`) stacks every shard on one card, so a caller keeps
that shard size by cutting a graph of N nodes into about ``N / 250,000``
shards."""
import dataclasses

from repro_torch.configs.base import ArchEntry, register


@dataclasses.dataclass(frozen=True)
class STwigConfig:
    name: str = "stwig"
    n_nodes: int = 64_000_000          # paper default (§6.3): 64M nodes
    avg_degree: int = 16
    n_labels: int = 418                # US-Patents label count
    label_zipf: float = 0.0
    n_shards: int = 256
    query_nodes: int = 10              # §6.1 defaults
    query_edges: int = 20
    max_matches: int = 1024            # pipeline termination


CONFIG = STwigConfig()


def smoke() -> STwigConfig:
    return STwigConfig(
        name="stwig-smoke", n_nodes=2_000, avg_degree=8, n_labels=8,
        n_shards=4, query_nodes=6, query_edges=8,
    )


ENTRY = register(
    ArchEntry(
        arch_id="stwig",
        family="stwig",
        config=CONFIG,
        smoke=smoke,
        shapes=("paper_default",),
    )
)
