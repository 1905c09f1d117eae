"""Plain PyTorch version of the fused STwig expansion (MatchSTwig steps 2-3).

The same scatter-free formulation as the JAX package's oracle
(``src/repro/kernels/stwig_expand/ref.py``), so the two agree bit for bit:
per child, the survivor mask (dst label ∧ binding bit ∧ root candidacy), its
inclusive prefix sum ``ic`` and the reverse cumulative minimum ``nxt`` of the
survivor edge indices; exact counts from two boundary gathers into ``ic`` and
each root's first ``child_cap`` survivors from a gather chain through
``nxt``. JAX's ``take(mode="clip")`` clamps its indices; PyTorch indexing
does not, so every gather here clamps explicitly.

Contract (shared with the CUDA kernel):
  * ``cand[c, r, p]`` is the ``p``-th (in edge order) surviving destination
    of root row ``r`` for child ``c``; unused slots hold the ghost id
    ``n_total``. Row ``cap`` is the ghost row that owns the edge-pad tail.
  * ``cnt[c, r]`` is the EXACT count of survivors of root ``r`` — it may
    exceed ``child_cap``; only the first ``child_cap`` are materialized.
  * ``indptr`` is ``(cap+2,)`` int32 CSR bounds over the edge arrays.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset.ref import lookup_reference


def _clamped(x: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(x, 0, max(hi, 0)).long()


def stwig_expand_reference(
    words_k: torch.Tensor,     # (k, W) int32 binding bitsets, row per child
    dst_ids: torch.Tensor,     # (E,) int32 edge destination global ids
    dst_labels: torch.Tensor,  # (E,) int32 destination labels
    indptr: torch.Tensor,      # (cap+2,) int32 CSR bounds incl. pad tail
    root_ok: torch.Tensor,     # (E,) bool root-candidacy per edge
    *,
    child_labels: tuple[int, ...],
    child_bound: tuple[bool, ...],
    child_cap: int,
    cap: int,
    n_total: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``cand (k, cap+1, child_cap)`` and ``cnt (k, cap)``, int32."""
    dev = dst_ids.device
    C = child_cap
    E = dst_ids.shape[0]
    lo = indptr[:-1].long()
    hi = indptr[1:].long()
    slots = torch.arange(C, dtype=torch.int32, device=dev)
    edge_idx = torch.arange(E, dtype=torch.int64, device=dev)
    cands, cnts = [], []
    for i, label in enumerate(child_labels):
        m = root_ok & (dst_labels == label)
        if child_bound[i]:
            m &= lookup_reference(words_k[i], dst_ids)
        ic = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32)
        survivor = torch.where(m, edge_idx, E)
        nxt = torch.flip(torch.cummin(torch.flip(survivor, [0]), 0).values, [0])
        nxt_pad = torch.cat([nxt, torch.full((1,), E, dtype=torch.int64, device=dev)])
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        base = torch.where(lo > 0, ic[_clamped(lo - 1, E - 1)], zero)
        last = torch.where(hi > 0, ic[_clamped(hi - 1, E - 1)], zero)
        cnt = last - base  # (cap+1,) exact counts
        e = nxt_pad[_clamped(lo, E)]
        es = [e]
        for _ in range(C - 1):
            e = nxt_pad[_clamped(e + 1, E)]
            es.append(e)
        ee = torch.stack(es, dim=1)  # (cap+1, C)
        c_i = torch.where(
            slots[None, :] < cnt[:, None],
            dst_ids[_clamped(ee, E - 1)],
            torch.full((), n_total, dtype=torch.int32, device=dev),
        )
        cands.append(c_i)
        cnts.append(cnt[:cap])
    return torch.stack(cands), torch.stack(cnts)
