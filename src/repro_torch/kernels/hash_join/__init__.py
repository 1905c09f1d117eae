"""Sort-merge join probe: `ref` holds the plain version, `hash_join` the CUDA
wrapper. Nothing is compiled at import."""
from repro_torch.kernels.hash_join import hash_join, ref

__all__ = ["hash_join", "ref"]
