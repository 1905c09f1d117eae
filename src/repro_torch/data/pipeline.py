"""Seeded synthetic batches, copied from the JAX package's
``data/pipeline.py`` so that both packages see the same inputs from the same
seed. numpy only."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import RecSysConfig


def recsys_batch(
    cfg: RecSysConfig, batch: int, *, seed: int, step: int
) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ids = rng.zipf(1.2, size=(batch, cfg.n_sparse, cfg.bag_size))
    ids = (ids % cfg.vocab_per_field).astype(np.int32)
    mask = rng.random((batch, cfg.n_sparse, cfg.bag_size)) < 0.7
    mask[..., 0] = True  # at least one id per bag
    # labels correlated with a random linear model over first ids
    w = np.random.default_rng(seed).normal(size=cfg.n_sparse)
    score = (ids[..., 0] % 97 / 97.0) @ w
    labels = (score > np.median(score)).astype(np.int32)
    return {"ids": ids, "bag_mask": mask, "labels": labels}
