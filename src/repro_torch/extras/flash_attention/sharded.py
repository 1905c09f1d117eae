"""Attention on `DTensor` inputs: each rank runs the kernel on its own
``(batch, heads)`` block (`attention_on_shards`).

The prefill rules never shard the sequence or the head dim
(``launch/rules.py``), so a rank's block holds whole sequences: the kernel
needs nothing from another rank. A placement on either raises, as does a
partial sum. When q's heads are sharded and k/v's are not (``kv_heads`` is
replicated by every rule set), each rank passes the kernel only the kv
heads that its q heads read: global q head ``j`` reads kv head ``j // G``,
``G = Nq / Nkv``.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

__all__ = ["attention_on_shards"]

_BATCH, _SEQ, _HEADS, _HEAD_DIM = 0, 1, 2, 3


def _check(name: str, x: DTensor) -> None:
    for dim, p in enumerate(x.placements):
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in (_BATCH, _HEADS))):
            raise ValueError(
                f"attention on a mesh: {name}'s placement {p} on mesh dim {dim} (only the batch "
                "and the heads may be sharded, and no partial sum)")


def _kv_placements(q: DTensor, k: DTensor) -> tuple:
    """k/v's placements for q's: the batch sharded as q's, the heads kept
    sharded where both are, else replicated."""
    out = []
    for pq, pk in zip(q.placements, k.placements):
        if isinstance(pq, Shard) and pq.dim == _BATCH:
            out.append(Shard(_BATCH))
        elif isinstance(pq, Shard) and pq.dim == _HEADS and isinstance(pk, Shard) \
                and pk.dim == _HEADS:
            out.append(Shard(_HEADS))
        else:
            out.append(Replicate())
    return tuple(out)


def _kv_range(q: DTensor, k: DTensor, kv_pl: tuple) -> tuple[int, int]:
    """The local kv heads ``[lo, hi)`` (in k's local block) that this
    rank's q heads read; raises where the local heads do not form whole
    groups."""
    Nq, Nkv = q.shape[_HEADS], k.shape[_HEADS]
    if Nq % Nkv:
        raise ValueError(f"attention on a mesh: {Nq} query heads on {Nkv} kv heads")
    G = Nq // Nkv
    mesh = q.device_mesh
    q_shape, q_off = compute_local_shape_and_global_offset(q.shape, mesh, q.placements)
    k_shape, k_off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    o, n = q_off[_HEADS], q_shape[_HEADS]
    lo, hi = o // G, (o + n - 1) // G + 1
    groups_whole = (o % G == 0 and n % G == 0) or (G % n == 0 and o // G == (o + n - 1) // G)
    if not groups_whole or lo < k_off[_HEADS] or hi > k_off[_HEADS] + k_shape[_HEADS]:
        raise ValueError(f"attention on a mesh: local q heads [{o}, {o + n}) of {Nq} do not read "
                         f"whole groups of kv heads ({Nkv}, {G} a group) held on this rank")
    return lo - k_off[_HEADS], hi - k_off[_HEADS]


def attention_on_shards(attend, q: DTensor, k, v, **kw) -> DTensor:
    """``attend(q, k, v, **kw)`` (a `Kernels` backend's ``flash_attention``)
    on every rank's local ``(batch, heads)`` block, through `local_map`;
    the result has q's placements."""
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("attention on a mesh: q, k and v must all be DTensors")
    _check("q", q)
    kv_pl = _kv_placements(q, k)
    k = k.redistribute(q.device_mesh, kv_pl) if tuple(k.placements) != kv_pl else k
    v = v.redistribute(q.device_mesh, kv_pl) if tuple(v.placements) != kv_pl else v
    lo, hi = _kv_range(q, k, kv_pl)

    def body(q_l, k_l, v_l):
        if (lo, hi) != (0, k_l.shape[_HEADS]):
            k_l, v_l = k_l[:, :, lo:hi].contiguous(), v_l[:, :, lo:hi].contiguous()
        return attend(q_l, k_l, v_l, **kw)

    return local_map(body, out_placements=list(q.placements),
                     in_placements=(q.placements, kv_pl, kv_pl), device_mesh=q.device_mesh)(q, k, v)
