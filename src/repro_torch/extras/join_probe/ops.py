"""Entry points of the join probe, as the JAX package's
``src/repro/extras/join_probe/ops.py``: the kernels on the card, the plain
versions (`repro_torch.extras.join_probe.ref`) on the CPU."""
from __future__ import annotations

import torch

from repro_torch.extras.join_probe import join_probe as k


def lower_bound(ka_sorted: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """``searchsorted(ka_sorted, kb, side="left")``, unsigned, int32."""
    return k.probe_lower_bound(ka_sorted, kb)


def window(ka_sorted: torch.Tensor, kb: torch.Tensor, lo: torch.Tensor, *,
           dup_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each probe row's ``dup_cap`` window: ``(hit, idx)``."""
    return k.probe_window(ka_sorted, kb, lo, dup_cap=dup_cap)
