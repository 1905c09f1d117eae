"""Plain PyTorch version of the sort-merge join probe.

The same computation as the JAX package's oracle
(``src/repro/kernels/hash_join/ref.py``): each probe key's lower bound in the
sorted build keys by a branchless binary search of ``bit_length(capA)``
guarded steps, then a ``dup_cap`` window verified by hash equality, both
rows' validity and exact key-column equality.

Hashed keys are uint32 values held as int32 bit patterns; they are widened
to int64 and masked before every comparison, so they order as unsigned.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their unsigned values, as int64."""
    return x.to(torch.int64) & U32


def lower_bound(ka_sorted: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """``searchsorted(ka, kb, side='left')`` in unsigned order, as the
    unrolled guarded binary search of the reference (int64 result)."""
    cap = ka_sorted.shape[0]
    ka = as_u32(ka_sorted)
    key = as_u32(kb)
    lo = torch.zeros(kb.shape, dtype=torch.int64, device=kb.device)
    hi = torch.full(kb.shape, cap, dtype=torch.int64, device=kb.device)
    for _ in range(max(1, int(cap).bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = active & (ka[torch.clamp(mid, 0, max(cap - 1, 0))] < key)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def probe_reference(
    ka_sorted: torch.Tensor,  # (capA,) int32 (uint32 patterns), ascending unsigned
    a_keys: torch.Tensor,     # (capA, nk) int32 key columns, same order
    a_valid: torch.Tensor,    # (capA,) bool, same order
    kb: torch.Tensor,         # (capB,) int32 (uint32 patterns) hashed probe keys
    b_keys: torch.Tensor,     # (capB, nk) int32 probe key columns
    b_valid: torch.Tensor,    # (capB,) bool
    *,
    dup_cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``hit (capB, dup_cap)`` bool and ``idx (capB, dup_cap)``
    int32 positions into the sorted build side."""
    cap_a = ka_sorted.shape[0]
    lo = lower_bound(ka_sorted, kb)
    probe = lo[:, None] + torch.arange(dup_cap, dtype=torch.int64, device=kb.device)[None, :]
    in_range = probe < cap_a
    pc = torch.clamp(probe, max=cap_a - 1)
    hit = in_range & (ka_sorted[pc] == kb[:, None]) & b_valid[:, None] & a_valid[pc]
    for j in range(a_keys.shape[-1]):  # exact-key verification (collisions)
        hit &= a_keys[:, j][pc] == b_keys[:, j][:, None]
    return hit, pc.to(torch.int32)
