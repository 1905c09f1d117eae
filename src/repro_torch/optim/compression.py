"""Gradient compression for data parallelism across processes: the port of
``src/repro/optim/compression.py`` over a `torch.distributed` group.

int8 block-quantized all-reduce with error feedback (1-bit-Adam-style EF):
each rank quantizes (grad + carried error) with a scale shared by every
rank (the max of their ``absmax / 127``), all-reduces the int8 payload
summed as int32, dequantizes with that scale, and carries the quantization
residual into the next step. Rounding is half to even, as ``jnp.round``;
the payload is clipped to ±127. It cuts the gradient bytes on the wire 4×
against fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import rank_collectives as rc

__all__ = ["EFState", "compress_tree", "compressed_psum", "ef_init", "quantize"]


class EFState(NamedTuple):
    error: torch.Tensor  # fp32 residual carried between steps


def ef_init(param: torch.Tensor) -> EFState:
    return EFState(error=torch.zeros(param.shape, dtype=torch.float32, device=param.device))


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 payload of ``x`` at ``scale``: ``round(x / scale)``, half
    to even, clipped to ±127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compressed_psum(g: torch.Tensor, ef: EFState, group) -> tuple[torch.Tensor, EFState]:
    """Returns (the mean of every rank's gradient, as the int8 payloads
    carry it; the new error-feedback state)."""
    n = dist.get_world_size(group)
    x = g.to(torch.float32) + ef.error
    absmax = x.abs().max()
    # one scale on every rank, so the int8 payloads sum correctly
    scale = rc.pmax(torch.clamp(absmax / 127.0, min=1e-12), group)
    q = quantize(x, scale)
    err = x - q.to(torch.float32) * scale  # this rank's residual
    summed = rc.psum(q.to(torch.int32), group)
    out = summed.to(torch.float32) * scale / n
    return out.to(g.dtype), EFState(error=err)


def compress_tree(grads, ef_tree, group):
    """`compressed_psum` over every tensor of ``grads`` (nested dicts,
    lists and tuples of tensors) with the matching leaf of ``ef_tree``.
    Returns (reduced grads, new EF states), shaped as ``grads``."""
    if isinstance(grads, torch.Tensor):
        return compressed_psum(grads, ef_tree, group)
    if isinstance(grads, dict):
        pairs = {k: compress_tree(v, ef_tree[k], group) for k, v in grads.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    pairs = [compress_tree(v, e, group) for v, e in zip(grads, ef_tree)]
    return type(grads)(p[0] for p in pairs), type(grads)(p[1] for p in pairs)
