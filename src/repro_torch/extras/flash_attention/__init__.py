"""Causal GQA flash attention (forward): `ref` holds the plain version,
`flash_attention` the CUDA wrapper, `ops` the entry point. Nothing is
compiled at import."""
from repro_torch.extras.flash_attention import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
