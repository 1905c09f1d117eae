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
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu

_P, _I = ctypes.c_void_p, ctypes.c_int

CIN = CudaKernel("cin", "cin_layer", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
COLS, ROWS = 64, 256  # a block's columns of N = B·d and rows of H' (kCols, kBlockH)
MAX_SPLITS = 8
SPLIT_COST = 0.03  # a split's extra set-up, partial stores and second pass, per split


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
