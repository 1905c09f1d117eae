"""The optimizer of the port, as ``src/repro/optim/``: AdamW with optional
int8 moments and its schedule, and the int8 error-feedback gradient
all-reduce over a process group (``compression``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    QTensor,
    cosine_warmup,
    global_norm,
    init,
    update,
)
from repro_torch.optim.compression import EFState, compress_tree, compressed_psum, ef_init

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "EFState",
    "QTensor",
    "compress_tree",
    "compressed_psum",
    "cosine_warmup",
    "ef_init",
    "global_norm",
    "init",
    "update",
]
