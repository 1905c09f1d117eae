"""Family-generic train and serve step builders: the port of
``src/repro/train/step.py``.

`make_train_step` returns ``step(model, opt_state, batch, step) →
(opt_state, metrics)``: the loss of the model's family (`loss_for`), its
gradients by autograd, then `repro_torch.optim.update` with the
`cosine_warmup` scale, which writes the parameters in place. With
``microbatches = n > 1`` the batch is split as the JAX package's
``_split_batch`` splits it (an array whose dim 0 divides by n is cut into n
parts, any other is given whole to every part), each part's gradients are
added into float32 buffers, and the step takes their mean and the mean of
the parts' losses — the JAX package's ``lax.scan`` over microbatches, as a
Python loop. A `GraphBatch` is refused there: the JAX rule would cut its
nodes and its edges apart independently (its edge ids then point past a
part's nodes, which JAX clamps and PyTorch refuses).

`make_serve_fns` gives the serving entry points of a model.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.launch.rules import make_rules
from repro_torch.launch.sharding import axis_rules, shard_input
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import GraphBatch, batch_to
from repro_torch.models.schema import trainable


def batch_on(batch, device: torch.device):
    """A batch (an LM's ``{"tokens"}``, a recsys ``{"ids", "bag_mask",
    "labels"}``, a GNN's ``{"graph": GraphBatch}``) with every array a
    tensor on ``device``."""
    out = {}
    for k, v in batch.items():
        out[k] = batch_to(v, device) if isinstance(v, GraphBatch) else torch.as_tensor(
            v, device=device)
    return out


def loss_for(cfg, batch) -> Callable[[torch.nn.Module], torch.Tensor]:
    """The loss of ``cfg``'s family on ``batch`` (tensors on the model's
    device), as a function of the model."""
    if isinstance(cfg, LMConfig):
        return lambda model: tf.loss_fn(cfg, model, batch["tokens"])
    if isinstance(cfg, GNNConfig):
        return lambda model: gnn_lib.loss_fn(cfg, model, batch["graph"])
    if isinstance(cfg, RecSysConfig):
        return lambda model: recsys_lib.loss_fn(
            cfg, model, batch["ids"], batch["bag_mask"], batch["labels"])
    raise TypeError(type(cfg))


def _split_batch(batch: dict, n: int) -> list[dict]:
    """The JAX package's ``_split_batch``: n parts of ``batch``."""
    parts = [{} for _ in range(n)]
    for k, x in batch.items():
        if isinstance(x, GraphBatch):
            raise NotImplementedError(
                "microbatches > 1 on a GraphBatch: the JAX package's split cuts its nodes "
                "and edges apart; give the GNN one batch a step")
        if x.ndim >= 1 and x.shape[0] % n == 0:
            for i, piece in enumerate(x.view(n, x.shape[0] // n, *x.shape[1:])):
                parts[i][k] = piece
        else:
            for part in parts:
                part[k] = x
    return parts


def grads_of(params: dict) -> dict:
    """Each parameter's gradient; zeros for one the loss does not reach (a
    serving-only leaf), as JAX's gradient of it is."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}


def make_train_step(
    cfg,
    opt_cfg: optim.AdamWConfig,
    *,
    total_steps: int = 10_000,
    warmup: int = 200,
    microbatches: int = 1,
):
    """``step(model, opt_state, batch, step) → (opt_state, metrics)`` with
    ``metrics`` ``{"loss", "grad_norm", "lr"}`` (0-dim tensors). ``batch``
    may hold numpy arrays; they are moved to the model's device. The model's
    parameters are turned trainable, updated in place, and left without
    gradients (``.grad`` is freed after the update)."""

    def train_step(model, opt_state, batch, step):
        trainable(model)
        params = dict(model.named_parameters())
        batch = batch_on(batch, model.device)
        model.zero_grad(set_to_none=True)
        if microbatches > 1:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in params.items()}
            lsum = 0.0
            for part in _split_batch(batch, microbatches):
                loss = loss_for(cfg, part)(model)
                loss.backward()
                for n, p in params.items():
                    if p.grad is not None:
                        gsum[n] += p.grad
                model.zero_grad(set_to_none=True)
                lsum = lsum + loss.detach()
            grads = {n: g / microbatches for n, g in gsum.items()}
            del gsum
            loss = lsum / microbatches
        else:
            loss = loss_for(cfg, batch)(model)
            loss.backward()
            loss = loss.detach()
            grads = grads_of(params)
        lr_scale = optim.cosine_warmup(step, warmup=warmup, total=total_steps).to(loss.device)
        opt_state, metrics = optim.update(opt_cfg, grads, opt_state, params, lr_scale)
        del grads
        model.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def supervised(model, step) -> tuple[Callable, dict]:
    """``(step_fn, params)`` for `repro_torch.runtime.TrainSupervisor`: its
    state is ``(params, opt_state)``, ``params`` the model's own
    ``{name: Parameter}``; a state restored from a checkpoint (other
    tensors) is copied into the model first. ``step`` is a
    `make_train_step` step."""
    params = dict(model.named_parameters())

    def step_fn(state, batch, s):
        p, opt_state = state
        if p is not params:
            with torch.no_grad():
                for name, t in p.items():
                    params[name].copy_(t)
        opt_state, metrics = step(model, opt_state, batch, s)
        return (params, opt_state), metrics

    return step_fn, params


def make_serve_fns(cfg, model) -> dict[str, Callable[..., Any]]:
    """The serving entry points of ``model`` (built for ``cfg``), run under
    `torch.inference_mode`. Inputs may be numpy arrays or tensors; they are
    moved to the model's device. For `LMConfig` (``model`` a
    `repro_torch.models.transformer.Transformer`: dense GQA/MQA, MoE, MLA):

      * ``"prefill"(tokens)`` → ``(logits (B, S, V), DecodeCache)``;
      * ``"decode"(cache, token, pos)`` → ``(logits (B, 1, V), DecodeCache)``
        for ``token (B, 1)`` at position ``pos`` (an int); the cache is
        written in place.

    A model on a mesh (``model.mesh``) runs each under
    ``axis_rules(mesh, make_rules(cfg, kind, mesh))``: its inputs enter as
    DTensors with the cell's axes (``("batch", "seq")`` for tokens) and its
    logits and cache come back as DTensors (``.full_tensor()`` gathers
    them); a decode's cache must have been placed by the ``decode`` rules
    once (`models.transformer.grow_cache` under them).

    For `GNNConfig` (``model`` a `repro_torch.models.gnn.GNN`):

      * ``"infer"(graph)`` → the model's outputs for a `GraphBatch`.

    For `RecSysConfig` (``model`` a `repro_torch.models.recsys.XDeepFM`):

      * ``"score"(ids, bag_mask)`` → the CTR logits ``(B,)``;
      * ``"retrieve"(ids, bag_mask, cand_ids)`` → candidate scores ``(Nc,)``.
    """
    if not isinstance(cfg, (LMConfig, GNNConfig, RecSysConfig)):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port serves the LM, GNN and recsys families")
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")

    def on(x):
        return torch.as_tensor(x, device=model.device)

    if isinstance(cfg, LMConfig):
        mesh = getattr(model, "mesh", None)

        def scope(kind):
            if mesh is None:
                return contextlib.nullcontext()
            return axis_rules(mesh, make_rules(cfg, kind, mesh))

        # DTensor parameters refuse inference mode (an inference tensor has
        # no version counter to give a view): a mesh runs under no_grad
        grad_off = torch.inference_mode if mesh is None else torch.no_grad

        def prefill(tokens):
            with grad_off(), scope("prefill"):
                return model.prefill(shard_input(on(tokens), "batch", "seq"))

        def decode(cache, token, pos):
            with grad_off(), scope("decode"):
                if mesh is not None:
                    tf.place_cache(cache)  # a prefill's cache: moved once
                return model.decode_step(cache, shard_input(on(token), "batch", None), pos)

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
