"""Entry point of causal GQA attention, as the JAX package's
``src/repro/extras/flash_attention/ops.py``: the kernel on the card, the
plain version (`repro_torch.extras.flash_attention.ref`) on the CPU. The LM
prefill reaches the same kernel through ``Kernels.flash_attention``."""
from __future__ import annotations

import torch

from repro_torch.extras.flash_attention import flash_attention as fa


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """``q (B, S, Nq, H)``, ``k (B, S, Nkv, H)``, ``v (B, S, Nkv, Hv)`` →
    ``(B, S, Nq, Hv)`` in q's dtype."""
    return fa.flash_attention(q, k, v, scale=scale, window=window, softcap=softcap)
