"""Fused STwig expansion: `ref` holds the plain version, `stwig_expand` the
CUDA wrapper. Nothing is compiled at import."""
from repro_torch.kernels.stwig_expand import ref, stwig_expand

__all__ = ["ref", "stwig_expand"]
