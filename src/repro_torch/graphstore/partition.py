"""Hash partitioning of a graph into the shard-block device layout.

The paper (§4.3) hash-partitions nodes across machines and keeps a *local*
string index per machine. The device layout re-labels nodes so that shard
``s`` owns the contiguous global-ID block ``[s*cap, (s+1)*cap)``:

  * ``shard_of(id) = id // cap`` is a shift, not a hash lookup;
  * every per-shard array is the same (padded) size, so the stacked arrays
    split evenly along the shard axis;
  * neighbor lists store *global* new IDs, so cross-shard exploration is a
    gather + bit-test instead of an RPC (see DESIGN.md §2).

Padded entries use sentinels: node slots → label ``n_labels`` (invalid),
edge slots → global id ``n_total`` (one-past-the-end ghost node whose label is
invalid and whose binding bits are never set).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.graphstore.csr import Graph


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mixer (the partitioning hash function)."""
    x = (x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def shard_of(old_ids: np.ndarray, n_shards: int, mode: str = "hash") -> np.ndarray:
    if mode == "hash":
        return (_splitmix64(np.asarray(old_ids)) % np.uint64(n_shards)).astype(
            np.int32
        )
    raise ValueError(f"unknown partition mode {mode!r}")


@dataclasses.dataclass
class PartitionedGraph:
    """Device-ready sharded graph. All stacked arrays have a leading shard
    axis and identical per-shard padding so they map onto a mesh axis."""

    n_shards: int
    n_nodes: int          # real node count (before padding)
    n_labels: int
    cap: int              # padded nodes per shard
    edge_cap: int         # padded edges per shard
    # --- stacked per-shard arrays, leading axis = shard -------------------
    labels: np.ndarray        # (S, cap) int32, pad = n_labels
    n_local: np.ndarray       # (S,) int32 real node count per shard
    n_local_edges: np.ndarray  # (S,) int32 real edge count per shard
    indptr: np.ndarray        # (S, cap+1) int32 local CSR
    indices: np.ndarray       # (S, edge_cap) int32 GLOBAL new ids, pad = n_total
    edge_src: np.ndarray      # (S, edge_cap) int32 local src row per edge, pad = cap
    label_indptr: np.ndarray  # (S, n_labels+1) int32
    nodes_by_label: np.ndarray  # (S, cap) int32 local ids grouped by label
    # --- replicated --------------------------------------------------------
    all_labels: np.ndarray    # (n_total+1,) int32 global labels, pad = n_labels
    freq: np.ndarray          # (n_labels,) int64 global label frequencies
    # --- host-only mappings -------------------------------------------------
    old_to_new: np.ndarray    # (n_nodes,) int64
    new_to_old: np.ndarray    # (n_total,) int64, pad slots = -1

    @property
    def n_total(self) -> int:
        return self.n_shards * self.cap

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(
        g: Graph,
        n_shards: int,
        *,
        mode: str = "hash",
        pad_to_multiple: int = 8,
    ) -> "PartitionedGraph":
        n = g.n_nodes
        if mode == "range":
            shard = (np.arange(n, dtype=np.int64) * n_shards // max(n, 1)).astype(
                np.int32
            )
        else:
            shard = shard_of(np.arange(n, dtype=np.int64), n_shards, mode)
        counts = np.bincount(shard, minlength=n_shards)
        cap = int(counts.max()) if n else 1
        cap = max(1, -(-cap // pad_to_multiple) * pad_to_multiple)
        n_total = n_shards * cap

        # stable order: sort nodes by shard → local slot = rank within shard
        order = np.argsort(shard, kind="stable")           # old ids grouped by shard
        local_rank = np.zeros(n, dtype=np.int64)
        local_rank[order] = np.arange(n) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        old_to_new = shard.astype(np.int64) * cap + local_rank
        new_to_old = np.full(n_total, -1, dtype=np.int64)
        new_to_old[old_to_new] = np.arange(n, dtype=np.int64)

        # relabeled global label array (+ ghost entry)
        all_labels = np.full(n_total + 1, g.n_labels, dtype=np.int32)
        all_labels[old_to_new] = g.labels

        # per-shard CSR over new ids (neighbors stay GLOBAL new ids)
        new_src = old_to_new[np.repeat(np.arange(n), np.diff(g.indptr))]
        new_dst = old_to_new[g.indices]
        e_order = np.argsort(new_src, kind="stable")
        new_src, new_dst = new_src[e_order], new_dst[e_order]
        e_shard = (new_src // cap).astype(np.int32)
        e_counts = np.bincount(e_shard, minlength=n_shards)
        edge_cap = int(e_counts.max()) if len(new_src) else 1
        edge_cap = max(1, -(-edge_cap // pad_to_multiple) * pad_to_multiple)

        labels_sh = np.full((n_shards, cap), g.n_labels, dtype=np.int32)
        indptr_sh = np.zeros((n_shards, cap + 1), dtype=np.int32)
        indices_sh = np.full((n_shards, edge_cap), n_total, dtype=np.int32)
        edge_src_sh = np.full((n_shards, edge_cap), cap, dtype=np.int32)
        label_indptr = np.zeros((n_shards, g.n_labels + 1), dtype=np.int32)
        nodes_by_label = np.full((n_shards, cap), cap, dtype=np.int32)

        e_starts = np.concatenate([[0], np.cumsum(e_counts)])
        for s in range(n_shards):
            nl = int(counts[s])
            lab = all_labels[s * cap : s * cap + cap]
            labels_sh[s] = lab
            # local CSR
            es, ee = e_starts[s], e_starts[s + 1]
            loc_src = (new_src[es:ee] - s * cap).astype(np.int32)
            ptr = np.zeros(cap + 1, dtype=np.int64)
            np.add.at(ptr, loc_src + 1, 1)
            indptr_sh[s] = np.cumsum(ptr).astype(np.int32)
            ne = ee - es
            indices_sh[s, :ne] = new_dst[es:ee].astype(np.int32)
            edge_src_sh[s, :ne] = loc_src
            # local label index: local ids grouped by label
            valid = np.arange(cap) < nl
            lab_valid = np.where(valid, lab, g.n_labels)
            lorder = np.argsort(lab_valid[:nl], kind="stable")
            nodes_by_label[s, :nl] = lorder.astype(np.int32)
            lptr = np.zeros(g.n_labels + 1, dtype=np.int64)
            np.add.at(lptr, lab_valid[:nl] + 1, 1)
            label_indptr[s] = np.cumsum(lptr)[: g.n_labels + 1].astype(np.int32)

        return PartitionedGraph(
            n_shards=n_shards,
            n_nodes=n,
            n_labels=g.n_labels,
            cap=cap,
            edge_cap=edge_cap,
            labels=labels_sh,
            n_local=counts.astype(np.int32),
            n_local_edges=e_counts.astype(np.int32),
            indptr=indptr_sh,
            indices=indices_sh,
            edge_src=edge_src_sh,
            label_indptr=label_indptr,
            nodes_by_label=nodes_by_label,
            all_labels=all_labels,
            freq=g.label_frequencies(),
            old_to_new=old_to_new,
            new_to_old=new_to_old,
        )

    @staticmethod
    def from_arrays(arrays: dict) -> "PartitionedGraph":
        """Rebuild a partition from its fields — e.g. ``dataclasses.asdict``
        of a partition built elsewhere — so the same graph state can be
        handed to the port without re-partitioning. Every field is required;
        array fields are copied as numpy arrays of their stored dtype."""
        fields = {f.name for f in dataclasses.fields(PartitionedGraph)}
        missing = fields - set(arrays)
        if missing:
            raise ValueError(f"missing partition fields: {sorted(missing)}")
        kw = {}
        for name in fields:
            v = arrays[name]
            kw[name] = np.array(v) if isinstance(v, np.ndarray) else int(v)
        return PartitionedGraph(**kw)

    def save(self, path) -> None:
        """Write every field into the directory ``path``: one ``.npy`` a
        array, the integers in ``scalars.json``. `load` maps them back."""
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        scalars = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                np.save(path / f"{f.name}.npy", v)
            else:
                scalars[f.name] = int(v)
        (path / "scalars.json").write_text(json.dumps(scalars))

    @staticmethod
    def load(path) -> "PartitionedGraph":
        """The partition `save` wrote to ``path``, its arrays memory-mapped
        copy-on-write: a process that opens one shard of it reads that
        shard's pages only, and processes share the replicated arrays'
        pages through the page cache."""
        path = pathlib.Path(path)
        kw = json.loads((path / "scalars.json").read_text())
        for f in dataclasses.fields(PartitionedGraph):
            if f.name not in kw:
                kw[f.name] = np.load(path / f"{f.name}.npy", mmap_mode="c")
        return PartitionedGraph(**kw)

    # --------------------------------------------------------------- helpers
    def shard_of_global(self, new_ids: np.ndarray) -> np.ndarray:
        return np.minimum(new_ids // self.cap, self.n_shards - 1)

    def edge_shard_pairs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src_shard, dst_shard, src_label, dst_label) per real edge —
        the input to cluster-graph preprocessing (§5.3)."""
        srcs, dsts = [], []
        for s in range(self.n_shards):
            ne = int(self.n_local_edges[s])
            loc = self.edge_src[s, :ne].astype(np.int64) + s * self.cap
            srcs.append(loc)
            dsts.append(self.indices[s, :ne].astype(np.int64))
        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        return (
            (src // self.cap).astype(np.int32),
            (dst // self.cap).astype(np.int32),
            self.all_labels[src],
            self.all_labels[dst],
        )

    def memory_bytes(self) -> int:
        tot = 0
        for f in (
            self.labels, self.indptr, self.indices, self.edge_src,
            self.label_indptr, self.nodes_by_label, self.all_labels,
        ):
            tot += f.nbytes
        return tot
