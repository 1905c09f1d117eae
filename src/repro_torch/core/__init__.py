"""The matcher: query model, Algorithm-2 planning, MatchSTwig, the join and
the local engine, on PyTorch tensors. The preferred entry point is
`repro_torch.api.GraphSession`."""
from repro_torch.core.query import QueryGraph, STwig

__all__ = ["QueryGraph", "STwig"]
