"""GNN message aggregation: `ref` holds the plain version, `segment_mp` the
CUDA wrapper, `ops` the entry point. Nothing is compiled at import."""
from repro_torch.extras.segment_mp import ops, ref, segment_mp

__all__ = ["ops", "ref", "segment_mp"]
