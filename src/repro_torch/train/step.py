"""Family-specific serving entry points, as the JAX package's
``train/step.make_serve_fns``. The port serves the GNN and recsys families
so far; training steps, and the LM family, are later slices (ROADMAP
Queue 1, item 10)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import GNNConfig, RecSysConfig
from repro_torch.models.gnn import batch_to


def make_serve_fns(cfg, model) -> dict[str, Callable[..., Any]]:
    """The serving entry points of ``model`` (built for ``cfg``), run under
    `torch.inference_mode`. Inputs may be numpy arrays or tensors; they are
    moved to the model's device. For `GNNConfig` (``model`` a
    `repro_torch.models.gnn.GNN`):

      * ``"infer"(graph)`` → the model's outputs for a `GraphBatch`.

    For `RecSysConfig` (``model`` a `repro_torch.models.recsys.XDeepFM`):

      * ``"score"(ids, bag_mask)`` → the CTR logits ``(B,)``;
      * ``"retrieve"(ids, bag_mask, cand_ids)`` → candidate scores ``(Nc,)``.
    """
    if not isinstance(cfg, (GNNConfig, RecSysConfig)):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port serves the GNN and recsys families only; "
            "the LM family is ROADMAP Queue 1, item 10"
        )
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")

    if isinstance(cfg, GNNConfig):
        def infer(graph):
            with torch.inference_mode():
                return model(batch_to(graph, model.device))

        return {"infer": infer}

    def on(x):
        return torch.as_tensor(x, device=model.device)

    def score(ids, bag_mask):
        with torch.inference_mode():
            return model(on(ids), on(bag_mask))

    def retrieve(ids, bag_mask, cand_ids):
        with torch.inference_mode():
            return model.retrieval_score(on(ids), on(bag_mask), on(cand_ids))

    return {"score": score, "retrieve": retrieve}
