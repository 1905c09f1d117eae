"""Entry point of the GNN message aggregation, as the JAX package's
``src/repro/extras/segment_mp/ops.py``: the kernel on the card, the plain
version (`repro_torch.extras.segment_mp.ref`) on the CPU. The GNN models
reach the same kernel through ``Kernels.segment_mp``."""
from __future__ import annotations

import torch

from repro_torch.extras.segment_mp import segment_mp as k


def aggregate(messages: torch.Tensor, dst_sorted: torch.Tensor, *, n_nodes: int) -> torch.Tensor:
    """Segment sum of ``messages (E, d)`` by ``dst_sorted (E,)`` into
    ``(n_nodes, d)``."""
    return k.segment_mp(messages, dst_sorted, n_nodes)
