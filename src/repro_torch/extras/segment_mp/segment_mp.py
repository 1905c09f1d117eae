"""Wrapper of the GNN message-aggregation CUDA kernel (``csrc/segment_mp.cu``).

`segment_mp` replaces ``segment_mp`` (and its Pallas pass
``segment_mp_partials``) of ``src/repro/extras/segment_mp/segment_mp.py``:
the segment sum of destination-sorted edge messages into ``(n, d)``. The
kernel cuts the edges into fixed chunks, one thread per (chunk, column);
segments inside a chunk are stored, the two at its ends added atomically.
`chunk_for` picks the chunk: 256 edges, halved (down to 16) until the grid
holds about a million threads, so that a small batch still fills the card.

A CPU tensor goes to the plain version (`repro_torch.extras.segment_mp.ref`);
a CUDA tensor launches the kernel or raises. ``dst_sorted`` must be
ascending on the card (nothing checks it: that would cost a sync).

`SegmentMP` is the differentiable entry (what ``Kernels.segment_mp`` of the
CUDA backend calls): its forward is `segment_mp`, its backward the plain
version's vector-Jacobian product, a gather ``grad_messages[e] =
grad_out[dst[e]]`` (0 for an id out of range). `segment_mp` itself refuses
an input that requires grad under grad mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.extras.segment_mp import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu, refuse_grad

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

SEGMENT_MP = CudaKernel("segment_mp", "segment_mp", [_P, _P, _L, _I, _I, _I, _P])
MIN_THREADS = 1 << 20


def chunk_for(n_edges: int, d: int) -> int:
    """Edges per chunk: 256, halved down to 16 while the grid of
    ``ceil(E / chunk) · d`` threads stays under `MIN_THREADS`."""
    chunk = 256
    while chunk > 16 and -(-n_edges // chunk) * d < MIN_THREADS:
        chunk //= 2
    return chunk


def segment_mp(messages: torch.Tensor, dst_sorted: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``messages (E, d)`` float32, ``dst_sorted (E,)`` int32 ascending →
    ``(n_nodes, d)`` float32; ids outside ``[0, n_nodes)`` are dropped."""
    refuse_grad("segment_mp", messages)
    if on_cpu(messages, dst_sorted):
        return ref.segment_mp_reference(messages, dst_sorted, n_nodes)
    check(messages, "messages", torch.float32, 2)
    check(dst_sorted, "dst_sorted", torch.int32, 1)
    E, d = messages.shape
    if dst_sorted.shape[0] != E:
        raise ValueError(f"dst_sorted has {dst_sorted.shape[0]} ids for {E} messages")
    if not 0 <= n_nodes < 2**31:
        raise ValueError(f"n_nodes {n_nodes} is not an int32 count")
    out = torch.zeros((n_nodes, d), dtype=torch.float32, device=messages.device)
    if E and d and n_nodes:
        SEGMENT_MP(messages.data_ptr(), dst_sorted.data_ptr(), E, d, n_nodes,
                   chunk_for(E, d), out.data_ptr())
    return out


class SegmentMP(torch.autograd.Function):
    """`segment_mp` with a gradient for ``messages``: ``SegmentMP.apply(
    messages, dst_sorted, n_nodes)``. ``aggregate`` (default `segment_mp`)
    runs the forward: the dry run (`repro_torch.extras.dryrun`) gives one
    that prices the kernel."""

    @staticmethod
    def forward(ctx, messages, dst_sorted, n_nodes, aggregate=segment_mp):
        ctx.save_for_backward(dst_sorted)
        ctx.n_nodes = n_nodes
        return aggregate(messages, dst_sorted, n_nodes)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (dst,) = ctx.saved_tensors
        keep = (dst >= 0) & (dst < ctx.n_nodes)
        if ctx.n_nodes == 0:
            grad = grad_out.new_zeros((dst.shape[0], grad_out.shape[1]))
        else:
            grad = grad_out.index_select(0, torch.where(keep, dst, 0).long())
            grad = torch.where(keep[:, None], grad, 0.0)
        return grad, None, None, None
