"""Plain PyTorch version of the GNN message aggregation: the segment sum
that ``jax.ops.segment_sum`` computes (the JAX package's oracle,
``src/repro/extras/segment_mp/ref.py``, and every ``_seg_sum`` of
``models/gnn.py``). It needs no order of ``dst``; ids outside ``[0, n)``
are dropped, as ``segment_sum`` drops them."""
from __future__ import annotations

import torch


def segment_mp_reference(
    messages: torch.Tensor, dst: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """``messages (E, d)``, ``dst (E,)`` int → ``(n_nodes, d)``:
    row ``v`` is the sum of the messages whose ``dst`` is ``v``."""
    # an id out of range lands in a spare last row, which is cut off: no
    # host sync to ask whether any id is out of range
    out = torch.zeros((n_nodes + 1, messages.shape[1]), dtype=messages.dtype,
                      device=messages.device)
    keep = (dst >= 0) & (dst < n_nodes)
    idx = torch.where(keep, dst, n_nodes).long()
    return out.index_add_(0, idx, messages)[:n_nodes]
