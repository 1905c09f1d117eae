"""The xDeepFM CIN layer: `ref` holds the plain version, `cin` the CUDA
wrapper. Nothing is compiled at import."""
from repro_torch.kernels.cin import cin, ref

__all__ = ["cin", "ref"]
