"""Wrapper of the fused CIN-layer CUDA kernel (``csrc/cin.cu``).

`cin_layer` replaces ``cin_layer`` of ``src/repro/kernels/cin/cin.py``.
A CPU tensor goes to the plain version (`repro_torch.kernels.cin.ref`); a
CUDA tensor launches the kernel or raises. The kernel never forms
``z = xk ⊗ x0``: for each ``h`` it takes ``P_h = w_hᵀ · x0`` (``K = m``) on
the tensor cores through TF32 ``wgmma`` in split TF32 (each operand as a
TF32 high part and its remainder, three products a term: fp32-level
accuracy) and adds ``xk[:, h] · P_h`` in fp32. It takes any number of
fields ``m``: ``x0`` is staged in chunks of them. When the column tiles
are too few to fill the card, `splits` divides the ``h`` range into parts
that a second kernel adds in a fixed order, so every run gives the same
bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cin import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu, refuse_grad

_P, _I = ctypes.c_void_p, ctypes.c_int

CIN = CudaKernel("cin", "cin_layer", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
COLS, ROWS = 64, 256  # a block's columns of N = B·d and rows of H' (kCols, kBlockH)
MAX_SPLITS = 8
SPLIT_COST = 0.03  # a split's extra set-up, partial stores and second pass, per split
GRAD_W_CHUNK_BYTES = 1 << 29  # a chunk's z in the backward's grad_w


def splits(N: int, Hp: int, H: int, sms: int) -> int:
    """Parts of the ``h`` range: the fewest waves of one block an SM per
    unit of work, each split past the first costing `SPLIT_COST` more
    (``chip_smoke.py`` ``[recsys]`` times serve_p99's layers at each count)."""
    tiles = -(-N // COLS) * -(-Hp // ROWS)
    cost = {k: -(-tiles * k // sms) / k * (1 + SPLIT_COST * (k - 1))
            for k in range(1, min(MAX_SPLITS, max(H, 1)) + 1)}
    return min(cost, key=cost.get)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xk (B, H, d)``, ``x0 (B, m, d)``, ``w (H·m, H')``, float32 →
    ``(B, H', d)`` float32."""
    refuse_grad("cin_layer", xk, x0, w)
    if on_cpu(xk, x0, w):
        return ref.cin_layer_reference(xk, x0, w)
    check(xk, "xk", torch.float32, 3)
    check(x0, "x0", torch.float32, 3)
    check(w, "w", torch.float32, 2)
    B, H, d = xk.shape
    m, Hp = x0.shape[1], w.shape[1]
    if x0.shape[0] != B or x0.shape[2] != d:
        raise ValueError(f"x0 {tuple(x0.shape)} does not match xk {tuple(xk.shape)}")
    if w.shape[0] != H * m:
        raise ValueError(f"w has {w.shape[0]} rows, expected H·m = {H}·{m}")
    out = torch.empty((B, Hp, d), dtype=torch.float32, device=xk.device)
    if out.numel():
        ks = splits(B * d, Hp, H, _sms(xk.device))
        part = torch.empty((ks, B, Hp, d) if ks > 1 else (0,), dtype=torch.float32,
                           device=xk.device)
        CIN(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(), B, H,
            m, d, Hp, ks)
    return out


def grad_w(xk: torch.Tensor, x0: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``Σ_{b,d} z[b, h·m + m′, d] · g[b, h′, d]`` → ``(H·m, H′)``, with
    ``z = xk ⊗ x0`` formed a chunk of the batch at a time."""
    B, H, d = xk.shape
    m, Hp = x0.shape[1], g.shape[1]
    chunk = max(1, GRAD_W_CHUNK_BYTES // max(1, H * m * d * xk.element_size()))
    out = torch.zeros((H * m, Hp), dtype=xk.dtype, device=xk.device)
    for i in range(0, B, chunk):
        # z laid out (h, m′, b, d), so that the contraction is one plain GEMM
        z = xk[i:i + chunk].transpose(0, 1)[:, None] * x0[i:i + chunk].transpose(0, 1)[None]
        out += z.reshape(H * m, -1) @ g[i:i + chunk].transpose(1, 2).reshape(-1, Hp)
    return out


class CinLayer(torch.autograd.Function):
    """`cin_layer` with gradients for xk, x0 and w:
    ``CinLayer.apply(xk, x0, w)``. ``layer`` (default `cin_layer`) is what
    runs each CIN layer, forward and backward: the dry run
    (`repro_torch.extras.dryrun`) gives one that prices the kernel."""

    @staticmethod
    def forward(ctx, xk, x0, w, layer=cin_layer):
        ctx.save_for_backward(xk, x0, w)
        ctx.layer = layer
        return layer(xk, x0, w)

    @staticmethod
    def backward(ctx, g):
        xk, x0, w = ctx.saved_tensors
        H, m, Hp = xk.shape[1], x0.shape[1], w.shape[1]
        g = g.contiguous()
        w3 = w.view(H, m, Hp)
        gxk = gx0 = gw = None
        if ctx.needs_input_grad[0]:
            gxk = ctx.layer(g, x0, w3.permute(2, 1, 0).reshape(Hp * m, H))
        if ctx.needs_input_grad[1]:
            gx0 = ctx.layer(g, xk, w3.permute(2, 0, 1).reshape(Hp * H, m))
        if ctx.needs_input_grad[2]:
            gw = grad_w(xk, x0, g)
        return gxk, gx0, gw, None
