"""The sharded engine's collectives with one shard a process, over a
`torch.distributed` process group.

The port of ``src/repro/core/collectives.py`` for `RankMatcher`
(`repro_torch.core.rank_dist`): the reference's names and signatures, a
process group where the reference has ``axis_name``, and each function
takes this rank's shard, not a stack (the stacked versions, one card
holding every shard, are `repro_torch.core.collectives`):

  * `or_allreduce` — the recursive-doubling butterfly of bitwise ORs over
    packed binding words for a power-of-two group (``log2 S`` rounds, each
    a ``batch_isend_irecv`` pair ``i ↔ i ^ k`` moving the whole bitset),
    else an all-gather and OR. No ``ReduceOp.BOR``: NCCL has no bitwise
    reduction, and the same code is to run on a multi-card NCCL world. The
    words travel as their bytes and are only ever ORed whole, so every bit
    survives, the sign bit of the int32 view included;
  * `pmax`, `psum`, `bool_allreduce_any` — ``all_reduce`` of MAX / SUM
    (the flag as int32, ``> 0``);
  * `gather_load_set` — the all-gather of every rank's ``(cap, w)`` table
    into ``(S·cap, w)``, shard-major, its validity masked by this rank's
    load-set row (Theorem 4);
  * `gather_load_set_ring` — ``2h`` ring hops (``batch_isend_irecv``),
    blocks in the reference's ``[self, −1, +1, −2, +2, …]`` order;
  * `fetch_load_set` — the one dispatch point between the two;
  * `gather_rows` — every rank's variable-length rows, in rank order
    (counts first, then padded rows): the union of the per-shard results.

**Host staging.** A gloo group takes CUDA tensors for some ops and not for
others. The rule is fixed, keyed on the group's backend, the tensor's
device and the op (`GLOO_HOST_OPS`, found on the card's torch and held
there by ``tests/test_torch_cuda.py``): such an op's operands are copied to pinned
host memory, the op runs there, and its results are copied back.
`staged_bytes` counts the bytes so staged, per collective. There is no
retry on the host after a failure.

Every call reports to the same ``recorder`` hook as the stacked
collectives (`repro_torch.core.collectives.recorder`), with ``group_size``
and, for the butterfly and the ring, the source rank of each exchange for
every rank: the staticcheck pass
`repro_torch.analysis.staticcheck.collective_safety` reads them.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.core import collectives

# the ops a gloo group refuses with CUDA tensors on the card's torch
# (tests/test_torch_cuda.py; 2.11.0+cu128: a send of a device pointer fails
# in gloo's writev with "Bad address"): run on pinned host copies
GLOO_HOST_OPS = frozenset({"p2p"})

# the functional collectives (what DTensor's redistributions call) that a
# gloo group refuses with CUDA tensors on the card's torch
# (tests/test_torch_cuda.py; 2.11.0+cu128: all_gather_into_tensor on a CUDA
# tensor kills the process with SIGSEGV, while all_reduce, reduce_scatter
# and all_to_all take CUDA tensors): run on pinned host copies once
# `stage_functional_collectives` has registered the rule
GLOO_FUNCTIONAL_HOST_OPS = frozenset({"all_gather_into_tensor"})
_functional_rule = None

# bytes copied to pinned host memory (each operand, then each result, once)
# by the staging rule, per collective name
staged_bytes: collections.Counter = collections.Counter()


def reset_staged_bytes() -> None:
    staged_bytes.clear()


def _staged(op: str, group, t: torch.Tensor) -> bool:
    return t.is_cuda and op in GLOO_HOST_OPS and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor, name: str) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    staged_bytes[name] += t.numel() * t.element_size()
    return out


def _back(t: torch.Tensor, device, name: str) -> torch.Tensor:
    staged_bytes[name] += t.numel() * t.element_size()
    return t.to(device)


def _staged_all_gather_into_tensor(t: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` on a CUDA tensor of a
    gloo group: the operand to pinned host memory, the gather there, the
    result back to the card."""
    group = dist.distributed_c10d._resolve_process_group(group_name)
    if dist.get_backend(group) != "gloo":
        raise NotImplementedError(
            f"all_gather_into_tensor on a {dist.get_backend(group)} group: the port's mesh runs "
            "on gloo groups only (one card)")
    name = "all_gather_into_tensor"
    host = _host(t.contiguous(), name)
    out = torch.empty((group_size * t.shape[0], *t.shape[1:]), dtype=t.dtype, pin_memory=True)
    dist.all_gather_into_tensor(out, host, group=group)
    return _back(out, t.device, name)


def stage_functional_collectives() -> None:
    """Register the host staging of `GLOO_FUNCTIONAL_HOST_OPS` as the CUDA
    kernels of those ``_c10d_functional`` ops, once a process: DTensor's
    redistributions (an all-gather of an FSDP weight, Shard → Replicate)
    then reach the gloo group with host tensors. A mesh of device type
    ``"cuda"`` over a gloo world needs it (`launch.mesh.make_mesh` calls
    it); it changes nothing on the CPU."""
    global _functional_rule
    if _functional_rule is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _staged_all_gather_into_tensor, "CUDA")
    _functional_rule = lib


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor travels as its bytes (gloo's typed ops lack bool)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced by ``op`` over the group, into a new tensor."""
    t = x.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: ``(S, *x.shape)``."""
    t = _wire(x)
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return _unwire(torch.stack(parts), x.dtype)


def exchange(sends, recvs, group, name: str) -> list[torch.Tensor]:
    """One ``batch_isend_irecv``: each ``(tensor, peer)`` of ``sends`` goes
    to group rank ``peer``; each ``(like, peer)`` of ``recvs`` receives a
    tensor shaped as ``like`` from group rank ``peer``. The i-th send to a
    peer meets that peer's i-th receive from this rank (one tag a pair).
    Returns the received tensors, in ``recvs`` order."""
    if not sends and not recvs:
        return []
    dev = (sends or recvs)[0][0].device
    staged = _staged("p2p", group, (sends or recvs)[0][0])
    ops, outs, tags = [], [], collections.Counter()
    for t, peer in sends:
        w = _wire(t)
        w = _host(w, name) if staged else w
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, peer), group,
                              tags[("s", peer)]))
        tags[("s", peer)] += 1
    for like, peer in recvs:
        w = _wire(like)
        buf = torch.empty(w.shape, dtype=w.dtype, pin_memory=staged) if staged \
            else torch.empty_like(w)
        outs.append((buf, like.dtype))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group,
                              tags[("r", peer)]))
        tags[("r", peer)] += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    res = []
    for buf, dtype in outs:
        if staged:
            buf = _back(buf, dev, name)
        res.append(_unwire(buf, dtype))
    return res


def _sources(maps) -> tuple:
    return tuple(torch.tensor(m, dtype=torch.int64) for m in maps)


# ------------------------------------------------------------ reductions
def or_allreduce(words: torch.Tensor, group) -> torch.Tensor:
    """Bitwise-OR all-reduce of this rank's ``words`` over the group."""
    S, me = group_size(group), group_rank(group)
    out = words
    maps = []
    if S > 1 and S & (S - 1) == 0:
        k = 1
        while k < S:
            (got,) = exchange([(out, me ^ k)], [(out, me ^ k)], group, "or_allreduce")
            out = out | got
            maps.append([i ^ k for i in range(S)])
            k *= 2
    elif S > 1:
        g = all_gather(out, group)
        out = g[0]
        for i in range(1, S):
            out = out | g[i]
    collectives._note("or_allreduce", {"words": words}, out, group_size=S, rank=me,
                      sources=_sources(maps))
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The max of ``x`` over the group (bool: any)."""
    t = x.to(torch.int32) if x.dtype == torch.bool else x
    out = _reduce(t, dist.ReduceOp.MAX, group)
    out = out > 0 if x.dtype == torch.bool else out
    collectives._note("pmax", {"x": x}, out, group_size=group_size(group),
                      rank=group_rank(group))
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group."""
    out = _reduce(x, dist.ReduceOp.SUM, group)
    collectives._note("psum", {"x": x}, out, group_size=group_size(group),
                      rank=group_rank(group))
    return out


def bool_allreduce_any(x: torch.Tensor, group) -> torch.Tensor:
    """True where any rank's ``x``, cast to int32, is positive: the
    reference's ``lax.pmax(x.astype(int32)) > 0``."""
    out = _reduce(x.to(torch.int32), dist.ReduceOp.MAX, group) > 0
    collectives._note("bool_allreduce_any", {"x": x}, out, group_size=group_size(group),
                      rank=group_rank(group))
    return out


# ----------------------------------------------------------------- fetches
def gather_load_set(
    cols: torch.Tensor, valid: torch.Tensor, load_row: torch.Tensor, group
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cols (cap, w)``, ``valid (cap,)``, ``load_row (S,)`` bool (this
    rank loads from rank j) → every rank's columns ``(S·cap, w)``,
    shard-major, and their validity ``(S·cap,)``, masked by the load row."""
    S = group_size(group)
    cap, w = cols.shape
    g_cols = all_gather(cols, group).reshape(S * cap, w)
    g_valid = all_gather(valid, group) & load_row[:, None]
    out = g_cols, g_valid.reshape(S * cap)
    collectives._note("gather_load_set", {"cols": cols, "valid": valid, "load": load_row},
                      out, group_size=S, rank=group_rank(group))
    return out


def gather_load_set_ring(
    cols: torch.Tensor, valid: torch.Tensor, load_row: torch.Tensor, group, max_dist: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distance-bounded variant: ``2h`` ring hops, ``h = min(max_dist,
    (S−1)//2)``, instead of an all-gather. Returns ``((2h+1)·cap, w)``
    columns and their validity: this rank's own table, then for each hop
    ``d`` the tables of ranks ``me − d`` and ``me + d``, each masked by the
    load-row entry of the rank it came from. Only valid when the cluster
    graph is (a subgraph of) the shard ring; the engine checks that on the
    host."""
    S, me = group_size(group), group_rank(group)
    h = min(max_dist, (S - 1) // 2)
    outs_c, outs_v = [cols], [valid & load_row[me]]
    fwd, bwd = (cols, valid), (cols, valid)
    up, down = (me + 1) % S, (me - 1) % S
    maps = []
    for d in range(1, h + 1):
        fc, fv, bc, bv = exchange(
            [(fwd[0], up), (fwd[1], up), (bwd[0], down), (bwd[1], down)],
            [(cols, down), (valid, down), (cols, up), (valid, up)],
            group, "gather_load_set_ring")
        fwd, bwd = (fc, fv), (bc, bv)
        outs_c += [fc, bc]
        outs_v += [fv & load_row[(me - d) % S], bv & load_row[(me + d) % S]]
        maps += [[(i - d) % S for i in range(S)], [(i + d) % S for i in range(S)]]
    out = torch.cat(outs_c), torch.cat(outs_v)
    collectives._note("gather_load_set_ring",
                      {"cols": cols, "valid": valid, "load": load_row}, out,
                      group_size=S, rank=me, sources=_sources(maps))
    return out


def fetch_load_set(
    cols: torch.Tensor,
    valid: torch.Tensor,
    load_row: torch.Tensor,
    group,
    *,
    ring_radius: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One STwig-table fetch bounded by this rank's load set (Theorem 4):
    the ring exchange when a radius is given (the engine verified it
    applies), the all-gather otherwise."""
    if ring_radius is not None:
        out = gather_load_set_ring(cols, valid, load_row, group, ring_radius)
    else:
        out = gather_load_set(cols, valid, load_row, group)
    collectives._note("fetch_load_set", {"cols": cols, "valid": valid, "load": load_row},
                      out, group_size=group_size(group), rank=group_rank(group),
                      ring_radius=ring_radius)
    return out


def gather_rows(rows: torch.Tensor, group, limit: int = 0) -> list[torch.Tensor]:
    """Every rank's ``rows (n_k, w)``, in rank order: the counts are
    gathered first, then the rows padded to the largest count. With a
    ``limit``, only the first ``limit`` rows of the rank-major union are
    sent, rank 0's first."""
    n = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    counts = all_gather(n, group)[:, 0].tolist()
    if limit:
        before = 0
        for k, c in enumerate(counts):
            counts[k] = min(c, max(0, limit - before))
            before += c
    mine = counts[group_rank(group)]
    # one row at least: no rank sends an empty tensor
    pad = torch.zeros((max(max(counts), 1), rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    pad[:mine] = rows[:mine]
    g = all_gather(pad, group)
    out = [g[k, :c] for k, c in enumerate(counts)]
    collectives._note("gather_rows", {"rows": rows}, out, group_size=group_size(group),
                      rank=group_rank(group))
    return out
