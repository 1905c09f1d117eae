"""Wrapper of the fused STwig-expansion CUDA kernel (``csrc/stwig_expand.cu``).

Replaces ``stwig_expand`` of ``src/repro/kernels/stwig_expand/stwig_expand.py``
(three Pallas kernels: a forward masked prefix sum carried across a
sequential grid, a reverse suffix-min, a per-root emission). On Hopper the
CSR segments make both scans unnecessary. The work is cut into tiles of
`TILE` rows + edges (a merge-path split of ``indptr``), so a tile of empty
rows and a tile inside a 55,750-edge row cost alike: a first kernel finds
each tile's bounds and the survivor counts of the row still open at its
end, a second ranks each tile's survivors and writes its rows' candidates
and exact counts (see the source's note). The kernel is bound by the bytes
of the candidates it writes, most of them the ghost fill.

``indptr`` must be non-decreasing (CSR); nothing checks it (a check would
sync). A CPU tensor goes to the plain version
(`repro_torch.kernels.stwig_expand.ref`); a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda import CudaKernel, check, on_cpu
from repro_torch.kernels.stwig_expand import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IA = ctypes.POINTER(ctypes.c_int)  # a host int array
MAX_CHILDREN = 16
MAX_CHILD_CAP = 1 << 20
TILE = 2048  # rows + edges a tile owns (kTile of the source, which checks the tile count)

EXPAND = CudaKernel(
    "stwig_expand",
    "stwig_expand",
    [_P, _I, _P, _P, _P, _P, _L, _I, _IA, _IA, _I, _I, _I, _P, _P, _P, _L, _P],
)


def n_tiles(cap: int, n_edges: int) -> int:
    """Tiles of the merge-path split: the ``cap + 1`` rows (the ghost row
    included) and at most every edge, `TILE` items a tile."""
    return -(-(cap + 1 + n_edges) // TILE)


def stwig_expand(
    words_k: torch.Tensor,     # (k, W) int32
    dst_ids: torch.Tensor,     # (E,) int32
    dst_labels: torch.Tensor,  # (E,) int32
    indptr: torch.Tensor,      # (cap+2,) int32
    root_ok: torch.Tensor,     # (E,) bool
    *,
    child_labels: tuple[int, ...],
    child_bound: tuple[bool, ...],
    child_cap: int,
    cap: int,
    n_total: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused filter + compaction: ``cand (k, cap+1, C)``, ``cnt (k, cap)``."""
    kw = dict(child_labels=child_labels, child_bound=child_bound,
              child_cap=child_cap, cap=cap, n_total=n_total)
    if on_cpu(words_k, dst_ids, dst_labels, indptr, root_ok):
        return ref.stwig_expand_reference(
            words_k, dst_ids, dst_labels, indptr, root_ok, **kw
        )
    k = len(child_labels)
    if not 1 <= k <= MAX_CHILDREN or len(child_bound) != k:
        raise ValueError(f"need 1..{MAX_CHILDREN} children with one bound flag each, got {k}")
    if not 0 <= child_cap <= MAX_CHILD_CAP:
        raise ValueError(f"child_cap must lie in [0, {MAX_CHILD_CAP}], got {child_cap}")
    check(words_k, "words_k", torch.int32, 2)
    check(dst_ids, "dst_ids", torch.int32, 1)
    check(dst_labels, "dst_labels", torch.int32, 1)
    check(indptr, "indptr", torch.int32, 1)
    check(root_ok, "root_ok", torch.bool, 1)
    E = dst_ids.shape[0]
    if words_k.shape[0] != k or dst_labels.shape[0] != E or root_ok.shape[0] != E:
        raise ValueError("words_k rows must equal k; dst_labels and root_ok must have E rows")
    if E >= 2**31:
        raise ValueError(f"at most 2**31 - 1 edges, got {E}")
    if indptr.shape[0] != cap + 2:
        raise ValueError(f"indptr must have cap+2 = {cap + 2} entries, got {indptr.shape[0]}")
    dev = dst_ids.device
    cand = torch.empty((k, cap + 1, child_cap), dtype=torch.int32, device=dev)
    cnt = torch.empty((k, cap), dtype=torch.int32, device=dev)
    tiles = n_tiles(cap, E)
    plan = torch.empty(2 * (tiles + 1), dtype=torch.int32, device=dev)  # tile bounds
    tail = torch.empty(tiles * k, dtype=torch.int32, device=dev)  # open rows' counts
    labels = (ctypes.c_int * k)(*child_labels)
    bound = (ctypes.c_int * k)(*(int(b) for b in child_bound))
    EXPAND(
        words_k.data_ptr(), words_k.shape[1], dst_ids.data_ptr(), dst_labels.data_ptr(),
        indptr.data_ptr(), root_ok.data_ptr(), E, k, labels, bound,
        child_cap, cap, n_total, cand.data_ptr(), cnt.data_ptr(), plan.data_ptr(), tiles,
        tail.data_ptr(),
    )
    return cand, cnt
