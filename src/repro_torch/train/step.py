"""Family-specific serving entry points, as the JAX package's
``train/step.make_serve_fns``. The port serves the LM (dense, MoE and MLA),
GNN and recsys families; training steps are not ported yet."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.models.gnn import batch_to


def make_serve_fns(cfg, model) -> dict[str, Callable[..., Any]]:
    """The serving entry points of ``model`` (built for ``cfg``), run under
    `torch.inference_mode`. Inputs may be numpy arrays or tensors; they are
    moved to the model's device. For `LMConfig` (``model`` a
    `repro_torch.models.transformer.Transformer`: dense GQA/MQA, MoE, MLA):

      * ``"prefill"(tokens)`` → ``(logits (B, S, V), DecodeCache)``;
      * ``"decode"(cache, token, pos)`` → ``(logits (B, 1, V), DecodeCache)``
        for ``token (B, 1)`` at position ``pos`` (an int); the cache is
        written in place.

    For `GNNConfig` (``model`` a `repro_torch.models.gnn.GNN`):

      * ``"infer"(graph)`` → the model's outputs for a `GraphBatch`.

    For `RecSysConfig` (``model`` a `repro_torch.models.recsys.XDeepFM`):

      * ``"score"(ids, bag_mask)`` → the CTR logits ``(B,)``;
      * ``"retrieve"(ids, bag_mask, cand_ids)`` → candidate scores ``(Nc,)``.
    """
    if not isinstance(cfg, (LMConfig, GNNConfig, RecSysConfig)):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port serves the LM, GNN and recsys families; "
            "training is not ported yet")
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")

    def on(x):
        return torch.as_tensor(x, device=model.device)

    if isinstance(cfg, LMConfig):
        def prefill(tokens):
            with torch.inference_mode():
                return model.prefill(on(tokens))

        def decode(cache, token, pos):
            with torch.inference_mode():
                return model.decode_step(cache, on(token), pos)

        return {"prefill": prefill, "decode": decode}

    if isinstance(cfg, GNNConfig):
        def infer(graph):
            with torch.inference_mode():
                return model(batch_to(graph, model.device))

        return {"infer": infer}

    def score(ids, bag_mask):
        with torch.inference_mode():
            return model(on(ids), on(bag_mask))

    def retrieve(ids, bag_mask, cand_ids):
        with torch.inference_mode():
            return model.retrieval_score(on(ids), on(bag_mask), on(cand_ids))

    return {"score": score, "retrieve": retrieve}
