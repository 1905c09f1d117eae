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
    out = torch.zeros((n_nodes, messages.shape[1]), dtype=messages.dtype,
                      device=messages.device)
    keep = (dst >= 0) & (dst < n_nodes)
    if bool(keep.all()):  # no copy of the messages when every id is in range
        return out.index_add_(0, dst.long(), messages)
    return out.index_add_(0, dst[keep].long(), messages[keep])
