"""The sharded engine's collectives, over stacked shards on one device.

The JAX package (``src/repro/core/collectives.py``) runs one shard per
device of a mesh axis and moves data between them with ``ppermute`` and
``all_gather``. Here every shard lives on the same card as one slice of a
tensor whose dim 0 is the shard, so each collective becomes an operation
over that dimension:

  * `or_allreduce` — the bitwise OR of every shard's packed words, by
    halving dim 0 (``ceil(log2(S))`` ORs of half the stack each; an odd
    shard out is carried to the next step);
  * `gather_load_set` — the faithful load-set fetch (Theorem 4). An
    all-gather leaves every shard holding the same rows, so on one card the
    fetched columns are ONE shared ``(S·cap, w)`` view of the stack,
    shard-major as ``all_gather`` orders them; only the validity is per
    shard, ``(S, S·cap)``: row ``j·cap + i`` is valid for shard ``k`` when
    it was valid on shard ``j`` and ``j`` lies in ``k``'s load set;
  * `gather_load_set_ring` — the distance-bounded variant: ``torch.roll``
    along dim 0, sources ``[self, −1, +1, −2, +2, …]`` hops away, as the
    reference's forward and backward ``ppermute`` rings deliver them;
  * `fetch_load_set` — the one dispatch point between the two;
  * `pmax` — a max over dim 0;
  * `bool_allreduce_any` — the reference's ``pmax`` of a flag as int32,
    ``> 0``: True where any shard's is.

With one shard a process (`repro_torch.core.rank_dist`), the same
collectives move data between processes over a `torch.distributed` group:
`repro_torch.core.rank_collectives`, which reports to this module's
`recorder` too.

Every collective reports its call to `recorder` when one is installed: the
staticcheck pass `repro_torch.analysis.staticcheck.collective_safety`
checks that each call takes all S shards on dim 0, that the ring's source
maps are permutations, and that no fetch operand derives from the head
STwig table (Theorem 5).
"""
from __future__ import annotations

from typing import Callable

import torch

# staticcheck hook: called as recorder(name, operands, result, info) after
# every collective call — ``operands`` maps each tensor operand's name to
# it, ``info`` holds the call's static structure (None = disabled)
recorder: Callable[..., None] | None = None


def _note(name: str, operands: dict, result, **info) -> None:
    if recorder is not None:
        recorder(name, operands, result, info)


def or_allreduce(words: torch.Tensor) -> torch.Tensor:
    """``words (S, …)`` → the OR over the shards, shaped ``words[0]``."""
    stacked = words
    while words.shape[0] > 1:
        h = words.shape[0] // 2
        words = torch.cat([words[:h] | words[h : 2 * h], words[2 * h :]])
    _note("or_allreduce", {"words": stacked}, words[0])
    return words[0]


def pmax(x: torch.Tensor) -> torch.Tensor:
    """``x (S, …)`` → the max over the shards (bool: any)."""
    out = x.any(dim=0) if x.dtype == torch.bool else x.amax(dim=0)
    _note("pmax", {"x": x}, out)
    return out


def bool_allreduce_any(x: torch.Tensor) -> torch.Tensor:
    """``x (S, …)`` → True where any shard's ``x``, cast to int32, is
    positive: the reference's ``lax.pmax(x.astype(int32)) > 0``."""
    out = x.to(torch.int32).amax(dim=0) > 0
    _note("bool_allreduce_any", {"x": x}, out)
    return out


def gather_load_set(
    cols: torch.Tensor, valid: torch.Tensor, load: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cols (S, cap, w)``, ``valid (S, cap)``, ``load (S, S)`` bool (shard
    k loads from shard j) → the shared ``(S·cap, w)`` columns and the
    per-shard validity ``(S, S·cap)``."""
    S, cap = valid.shape
    flat = cols.reshape(S * cap, cols.shape[-1])
    mask = valid.reshape(1, S * cap) & load.repeat_interleave(cap, dim=1)
    _note("gather_load_set", {"cols": cols, "valid": valid, "load": load}, (flat, mask))
    return flat, mask


def gather_load_set_ring(
    cols: torch.Tensor, valid: torch.Tensor, load: torch.Tensor, max_dist: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cols (S, cap, w)``, ``valid (S, cap)``, ``load (S, S)`` → per-shard
    columns ``(S, (2h+1)·cap, w)`` and validity ``(S, (2h+1)·cap)``, with
    ``h = min(max_dist, (S−1)//2)``: the shard's own table, then the tables
    1, 2, … hops away on each side of the ring, each masked by the load set
    row of the shard it came from. Only valid when the cluster graph is (a
    subgraph of) the shard ring; the engine checks that on the host.

    Block by block the ``torch.roll`` shifts are ``[0, 1, −1, 2, −2, …]``:
    a shift ``s`` hands shard ``k`` the table of shard ``(k − s) mod S``."""
    S = valid.shape[0]
    k = torch.arange(S, device=valid.device)
    outs_c, outs_v, sources = [], [], []
    h = min(max_dist, (S - 1) // 2)
    shifts = [0] + [x for d in range(1, h + 1) for x in (d, -d)]
    for s in shifts:
        src = (k - s) % S
        sources.append(src)
        outs_c.append(torch.roll(cols, s, dims=0) if s else cols)
        rolled = torch.roll(valid, s, dims=0) if s else valid
        outs_v.append(rolled & load[k, src][:, None])
    out = torch.cat(outs_c, dim=1), torch.cat(outs_v, dim=1)
    _note("gather_load_set_ring", {"cols": cols, "valid": valid, "load": load}, out,
          shifts=tuple(shifts), sources=tuple(sources))
    return out


def fetch_load_set(
    cols: torch.Tensor,
    valid: torch.Tensor,
    load: torch.Tensor,
    *,
    ring_radius: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One STwig-table fetch bounded by each shard's load set (Theorem 4):
    the ring exchange when a radius is given (the engine verified it
    applies), the all-gather otherwise. Returns ``(cols, valid)`` with
    ``valid`` of shape ``(S, n)``: ``cols`` is ``(n, w)``, shared by every
    shard, after the all-gather and ``(S, n, w)`` after the ring."""
    if ring_radius is not None:
        out = gather_load_set_ring(cols, valid, load, ring_radius)
    else:
        out = gather_load_set(cols, valid, load)
    _note("fetch_load_set", {"cols": cols, "valid": valid, "load": load}, out,
          ring_radius=ring_radius)
    return out
