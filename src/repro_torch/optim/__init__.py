"""The optimizer of the port, as ``src/repro/optim/``: AdamW with optional
int8 moments and its schedule. Gradient compression (``compression``)
waits for the port's ``torch.distributed`` path."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    QTensor,
    cosine_warmup,
    global_norm,
    init,
    update,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "QTensor",
    "cosine_warmup",
    "global_norm",
    "init",
    "update",
]
