"""Packed-bitset ops: `ref` holds the plain versions and the numpy helpers,
`bitset` the CUDA wrappers. Nothing is compiled at import."""
from repro_torch.kernels.bitset import bitset, ref

__all__ = ["bitset", "ref"]
