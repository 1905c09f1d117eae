"""Plain PyTorch versions of the join-probe kernels, as the JAX package's
oracles (``src/repro/extras/join_probe/ref.py``).

Keys are uint32 values held as int32 bit patterns; the lower bound widens
them to int64 and masks them to 32 bits, so they order as unsigned.
Equality needs no widening: equal bit patterns are equal keys."""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def lower_bound_reference(ka_sorted: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """``searchsorted(ka, kb, side="left")`` in unsigned order → ``(capB,)``
    int32."""
    ka = ka_sorted.to(torch.int64) & U32
    key = kb.to(torch.int64) & U32
    return torch.searchsorted(ka, key, side="left").to(torch.int32)


def window_reference(
    ka_sorted: torch.Tensor, kb: torch.Tensor, lo: torch.Tensor, *, dup_cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``dup_cap`` window of each probe row: ``p = lo + j``,
    ``idx = min(p, capA - 1)``, ``hit = p < capA ∧ ka[idx] == kb`` →
    ``hit (capB, dup_cap)`` bool, ``idx (capB, dup_cap)`` int32."""
    cap_a = ka_sorted.shape[0]
    probe = lo.to(torch.int64)[:, None] + torch.arange(
        dup_cap, dtype=torch.int64, device=lo.device)[None, :]
    in_range = probe < cap_a
    pc = torch.clamp(probe, max=cap_a - 1)
    return in_range & (ka_sorted[pc] == kb[:, None]), pc.to(torch.int32)
