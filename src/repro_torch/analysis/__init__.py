"""The port's analysis layer: the H100 roofline with the models' useful
FLOPs (`roofline`), and the static analyzer (`staticcheck`)."""
from repro_torch.analysis.roofline import CollectiveStats, Roofline

__all__ = ["CollectiveStats", "Roofline"]
