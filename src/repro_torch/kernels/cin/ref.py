"""Plain PyTorch version of one xDeepFM CIN layer (arXiv:1803.05170), as
the JAX package's oracle ``src/repro/kernels/cin/ref.py`` computes it (and
``models/recsys._cin``): the outer product ``z`` is materialised.

``out[b, h', d] = Σ_{h, m'} w[h·m + m', h'] · xk[b, h, d] · x0[b, m', d]`` —
the flat index of ``w``'s rows is h-major."""
from __future__ import annotations

import torch


def cin_layer_reference(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(B, H, d)``, ``(B, m, d)``, ``(H·m, H')`` → ``(B, H', d)``,
    contiguous as the kernel's output is."""
    B, _, d = xk.shape
    z = torch.einsum("bhd,bmd->bhmd", xk, x0).reshape(B, -1, d)
    return torch.einsum("bzd,zh->bhd", z, w).contiguous()
