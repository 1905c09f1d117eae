"""Graph storage: host-side (numpy) graph construction, partitioning into
the shard-block layout, the label index and the R-MAT generator — copies
of the JAX package's numpy modules."""
from repro_torch.graphstore import generators
from repro_torch.graphstore.csr import Graph
from repro_torch.graphstore.partition import PartitionedGraph

__all__ = ["Graph", "PartitionedGraph", "generators"]
