"""GPipe-style pipeline parallelism over a mesh dim: the port of
``src/repro/launch/pipeline.py`` over a `torch.distributed` group.

Each rank of the pipe dim holds one contiguous stage, and activations
travel stage → stage with ``batch_isend_irecv`` while microbatches fill
the pipeline: the classic GPipe schedule of ``M + S − 1`` ticks, bubble
fraction ``(S − 1) / (M + S − 1)``. The module is model-agnostic:
``stage_fn(stage_params, x)`` applies one stage, and the parameters arrive
pre-split, rank ``s`` holding stage ``s`` only (the memory scaling of
pipeline parallelism). A forward pipeline, for inference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import rank_collectives as rc

__all__ = ["bubble_fraction", "gpipe"]


def gpipe(stage_fn, mesh, *, axis: str = "pod"):
    """Build a pipelined apply: ``(stage_params, x) → y`` on every rank of
    ``mesh``'s ``axis`` dim. ``stage_params`` are this rank's stage's;
    ``x`` is ``(n_micro, mb, ...)``, the same on every rank. Returns ``y
    (n_micro, mb, ...)`` on every rank: the last stage's outputs, all-reduced
    by SUM from the zeros of the other stages, as the reference's ``psum``
    broadcasts them."""
    group = mesh.get_group(axis)
    S, stage = dist.get_world_size(group), dist.get_rank(group)

    def apply(stage_params, x: torch.Tensor) -> torch.Tensor:
        M = x.shape[0]
        y0 = torch.zeros_like(stage_fn(stage_params, x[0]))
        outs = x.new_zeros((M,) + y0.shape, dtype=y0.dtype)
        buf = y0
        for t in range(M + S - 1):
            mb = t - stage
            active = 0 <= mb < M
            y = stage_fn(stage_params, x[mb] if stage == 0 else buf) if active else y0
            if active and stage == S - 1:
                outs[mb] = y
            # each tick's activation to the next stage, the previous one's in
            sends = [(y, stage + 1)] if stage < S - 1 else []
            recvs = [(y0, stage - 1)] if stage > 0 else []
            got = rc.exchange(sends, recvs, group, "gpipe")
            buf = got[0] if got else y0
        return rc.psum(outs, group) if S > 1 else outs

    return apply


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S−1)/(M+S−1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
