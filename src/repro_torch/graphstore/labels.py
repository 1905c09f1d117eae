"""Label index.

The paper's only index is the *string index* (label → node IDs): linear space,
linear build, O(1) update (Table 1 row "STwig"). Here the label alphabet is
already integer-coded, so the index is a per-shard counting sort — built once
in ``PartitionedGraph.build``; this module provides the query-side helpers.

The packed bitsets that replace Trinity's remote ``hasLabel`` / binding-set
RPCs live in `repro_torch.kernels.bitset.ref`; no bit twiddling happens in
this package.
"""
from __future__ import annotations

import numpy as np


class LabelIndex:
    """Query-side view over the per-shard label index built by
    ``PartitionedGraph.build`` — the paper's ``Index.getID(label)``."""

    def __init__(self, pg) -> None:
        self._pg = pg

    def get_ids(self, shard: int, label: int) -> np.ndarray:
        """Local ids of nodes with ``label`` on ``shard`` (host-side)."""
        s, e = self._pg.label_indptr[shard, label], self._pg.label_indptr[
            shard, label + 1
        ]
        return self._pg.nodes_by_label[shard, s:e]

    def count(self, shard: int, label: int) -> int:
        return int(
            self._pg.label_indptr[shard, label + 1]
            - self._pg.label_indptr[shard, label]
        )

    def has_label(self, global_ids: np.ndarray, label: int) -> np.ndarray:
        """The paper's ``Index.hasLabel`` — vectorized."""
        return self._pg.all_labels[np.asarray(global_ids)] == label
