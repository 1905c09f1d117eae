"""Family-specific serving entry points, as the JAX package's
``train/step.make_serve_fns``. The port serves the recsys family (xDeepFM)
so far; training steps, and the LM and GNN families, are later slices
(ROADMAP Queue 1, item 10)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import RecSysConfig


def make_serve_fns(cfg, model) -> dict[str, Callable[..., Any]]:
    """The serving entry points of ``model`` (built for ``cfg``), run under
    `torch.inference_mode`. Inputs may be numpy arrays or tensors; they are
    moved to the model's device. For `RecSysConfig`:

      * ``"score"(ids, bag_mask)`` → the CTR logits ``(B,)``;
      * ``"retrieve"(ids, bag_mask, cand_ids)`` → candidate scores ``(Nc,)``.
    """
    if not isinstance(cfg, RecSysConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port serves the recsys family only; "
            "the other model families are ROADMAP Queue 1, item 10"
        )
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")

    def on(x):
        return torch.as_tensor(x, device=model.device)

    def score(ids, bag_mask):
        with torch.inference_mode():
            return model(on(ids), on(bag_mask))

    def retrieve(ids, bag_mask, cand_ids):
        with torch.inference_mode():
            return model.retrieval_score(on(ids), on(bag_mask), on(cand_ids))

    return {"score": score, "retrieve": retrieve}
