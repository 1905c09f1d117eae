"""Vectorized MatchSTwig (paper Algorithm 1) on PyTorch tensors.

The paper's per-root loop

    for n in Index.getID(r):  c = Cloud.Load(n); filter children by label/binding

becomes one edge-parallel pass over the shard's CSR arrays, as in the JAX
package (``src/repro/core/match.py``):

  1. root candidates  = (label == r) ∧ binding-bit(root)           (node-parallel)
  2. child candidates = (label[dst] == l_i) ∧ binding-bit(dst)     (edge-parallel)
  3. per-root candidate lists, compacted in edge order
  4. STwig emission   = masked cross-product over per-root lists
  5. binding update   = packed bitsets built from the emitted columns

Steps 1-3 and 5 go through the `Kernels` backend (`bitset_lookup`,
`stwig_expand`, `bitset_build`). Everything is fixed-capacity (see plan.py);
the function reports exact counts and overflow flags so the engine can run
more rounds. JAX's clamped gathers and dropped scatters become explicit
clamps and the rank search `rank_select`, so no index is ever out of range
and nothing syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.backend import Kernels, get_kernels, n_words, rank_select
from repro_torch.core.plan import STwigSpec


class ShardGraph(NamedTuple):
    """One shard's slice of the partitioned graph, on one device."""

    labels: torch.Tensor        # (cap,) int32, pad = n_labels
    indptr: torch.Tensor        # (cap+1,) int32
    indices: torch.Tensor       # (edge_cap,) int32 global ids, pad = n_total
    edge_src: torch.Tensor      # (edge_cap,) int32 local rows, pad = cap
    n_local: int
    n_local_edges: int
    shard_id: int
    all_labels: torch.Tensor    # (n_total+1,) int32
    # derived once per graph (the JAX step recomputes them every call):
    dst_labels: torch.Tensor    # (edge_cap,) int32 label of each edge's dst
    indptr_pad: torch.Tensor    # (cap+2,) int32, ghost row owns the pad tail

    @staticmethod
    def from_partition(pg, shard: int, device, all_labels=None) -> "ShardGraph":
        """Shard ``shard`` of a `PartitionedGraph`, moved to ``device``.
        ``all_labels``: the global labels already on ``device``, to share
        one copy among the shards of one partition."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        indices = dev(pg.indices[shard])
        if all_labels is None:
            all_labels = dev(pg.all_labels)
        edge_cap = int(pg.indices.shape[1])
        n_total = int(pg.all_labels.shape[0]) - 1
        return ShardGraph(
            labels=dev(pg.labels[shard]),
            indptr=dev(pg.indptr[shard]),
            indices=indices,
            edge_src=dev(pg.edge_src[shard]),
            n_local=int(pg.n_local[shard]),
            n_local_edges=int(pg.n_local_edges[shard]),
            shard_id=int(shard),
            all_labels=all_labels,
            dst_labels=all_labels[torch.clamp(indices, 0, n_total).long()],
            indptr_pad=dev(np.append(pg.indptr[shard], np.int32(edge_cap))),
        )

    @property
    def cap(self) -> int:
        return self.labels.shape[0]

    @property
    def edge_cap(self) -> int:
        return self.indices.shape[0]

    @property
    def n_total(self) -> int:
        return self.all_labels.shape[0] - 1


class STwigTable(NamedTuple):
    """Fixed-capacity STwig match table G(q_i) for one shard/round."""

    cols: torch.Tensor      # (rows_cap, width) int32 global ids, pad = ghost
    valid: torch.Tensor     # (rows_cap,) bool
    n_rows: torch.Tensor    # () int32 exact count (may exceed rows_cap)
    n_roots: torch.Tensor   # () int32 total matching roots on this shard
    overflow: torch.Tensor  # () bool — any capacity exceeded this round


class Bindings(NamedTuple):
    """Packed binding bitsets H_x for every query node."""

    words: torch.Tensor  # (n_qnodes, n_words) int32

    @staticmethod
    def fresh(n_qnodes: int, n_bits: int, device) -> "Bindings":
        return Bindings(
            torch.zeros((n_qnodes, n_words(n_bits)), dtype=torch.int32, device=device)
        )


def compact_rows(
    keep: torch.Tensor, rows: torch.Tensor, out_cap: int, fill: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``keep`` rows of ``rows``, in order, in ``out_cap`` slots (those
    past ``out_cap`` are dropped); empty slots hold ``fill`` and are not
    valid. Returns ``(cols, valid)``."""
    n = rows.shape[0]
    src = rank_select(keep, 0, out_cap)
    valid = src < n
    picked = rows[torch.clamp(src, max=max(n - 1, 0))]
    return torch.where(valid[:, None], picked, fill), valid


def match_stwig_shard(
    g: ShardGraph,
    bind: Bindings,
    spec: STwigSpec,
    round_idx: int,
    kernels: Kernels | None = None,
) -> tuple[STwigTable, Bindings]:
    """Match one STwig on one shard (round ``round_idx`` of root chunks).

    Returns the local match table and *this shard's contribution* to the new
    bindings for the STwig's query nodes (the caller ORs it over rounds,
    then replaces rows of ``bind``)."""
    kern = kernels if kernels is not None else get_kernels("torch")
    dev = g.labels.device
    cap, edge_cap, n_total = g.cap, g.edge_cap, g.n_total
    k = spec.n_children
    C, R = spec.child_cap, spec.root_cap
    W = bind.words.shape[1]
    ghost = torch.full((), n_total, dtype=torch.int32, device=dev)

    node_slot = torch.arange(cap, dtype=torch.int32, device=dev)
    gid = g.shard_id * cap + node_slot

    # ---- step 1: root candidate mask (node-parallel) ----------------------
    root_mask = (g.labels == spec.root_label) & (node_slot < g.n_local)
    if spec.root_bound:
        root_mask &= kern.bitset_lookup(bind.words[spec.root_qnode], gid)

    # ---- steps 2-3: per-child candidate filter + per-root compaction ------
    e_valid = torch.arange(edge_cap, device=dev) < g.n_local_edges
    root_ok_e = (
        e_valid
        & root_mask[torch.clamp(g.edge_src, 0, cap - 1).long()]
        & (g.edge_src < cap)
    )
    words_k = bind.words[list(spec.child_qnodes)]  # a gather: a new contiguous tensor
    cand_k, cnt_k = kern.stwig_expand(
        words_k,
        g.indices,
        g.dst_labels,
        g.indptr_pad,
        root_ok_e,
        child_labels=spec.child_labels,
        child_bound=spec.child_bound,
        child_cap=C,
        cap=cap,
        n_total=n_total,
    )

    # ---- prune roots missing required children ----------------------------
    for i in range(k):
        root_mask &= cnt_k[i] >= spec.child_need[i]
    n_roots = root_mask.sum(dtype=torch.int32)

    # ---- select this round's chunk of roots --------------------------------
    roots_sel = rank_select(root_mask, round_idx * R, R)  # (R,), cap = none
    root_live = roots_sel < cap
    root_gid = torch.where(root_live, g.shard_id * cap + roots_sel.to(torch.int32), ghost)
    cand_sel = cand_k[:, roots_sel]                                   # (k, R, C)
    cnt_pad = torch.cat([cnt_k, cnt_k.new_zeros((k, 1))], dim=1)
    cnt_sel = cnt_pad[:, roots_sel]                                   # (k, R)

    # ---- step 4: masked cross-product emission -----------------------------
    grid = torch.as_tensor(
        np.indices((C,) * k, dtype=np.int64).reshape(k, -1), device=dev
    )  # (k, P), C-order as jnp.indices
    P = grid.shape[1]
    child_vals = [cand_sel[i][:, grid[i]] for i in range(k)]  # each (R, P)
    ok = root_live[:, None].expand(R, P)
    for i in range(k):
        ok = ok & (grid[i][None, :] < cnt_sel[i][:, None])
    for i, j in spec.same_label_child_pairs:
        ok = ok & (grid[i] != grid[j])[None, :]
    for i in spec.root_label_child_positions:
        ok = ok & (child_vals[i] != root_gid[:, None])
    flat_ok = ok.reshape(-1)
    rows = torch.stack(
        [root_gid[:, None].expand(R, P).reshape(-1)] + [v.reshape(-1) for v in child_vals],
        dim=1,
    )  # (R*P, width)

    n_rows = flat_ok.sum(dtype=torch.int32)
    cols, valid = compact_rows(flat_ok, rows, spec.rows_cap, ghost)
    overflow = (n_rows > spec.rows_cap) | (cnt_k.amax() > C)

    # ---- step 5: binding contributions -------------------------------------
    contrib = kern.bitset_build(cols, valid, W)  # (width, W), one bitset a column

    table = STwigTable(
        cols=cols, valid=valid, n_rows=n_rows, n_roots=n_roots, overflow=overflow
    )
    return table, Bindings(contrib)


def apply_binding_update(
    bind: Bindings, spec: STwigSpec, contrib_words: torch.Tensor
) -> Bindings:
    """Replace the binding rows of this STwig's query nodes with the
    contribution. Replacement is valid because emitted columns are always
    subsets of prior bindings for bound nodes (§4.2)."""
    words = bind.words.clone()
    words[list(spec.qnodes)] = contrib_words
    return Bindings(words)
