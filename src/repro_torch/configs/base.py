"""Config dataclasses, copied from the JAX package's ``configs/base.py``:
only what a ported model path reads (the recsys family so far)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    bag_size: int = 1                # multi-hot bag length (EmbeddingBag)
    dtype: str = "float32"
