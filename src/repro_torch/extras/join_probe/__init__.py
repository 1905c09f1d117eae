"""The join probe as two kernels: `ref` holds the plain versions,
`join_probe` the CUDA wrappers, `ops` the entry points. Nothing is compiled
at import."""
from repro_torch.extras.join_probe import join_probe, ops, ref

__all__ = ["join_probe", "ops", "ref"]
