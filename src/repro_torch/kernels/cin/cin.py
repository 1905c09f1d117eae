"""Wrapper of the fused CIN-layer CUDA kernel (``csrc/cin.cu``).

`cin_layer` replaces ``cin_layer`` of ``src/repro/kernels/cin/cin.py``.
A CPU tensor goes to the plain version (`repro_torch.kernels.cin.ref`); a
CUDA tensor launches the kernel or raises. The kernel is an fp32 GEMM
``out[h', (b, d)] = Σ_z w[z, h'] · Z[z, (b, d)]`` whose operand
``Z = xk ⊗ x0`` is generated tile by tile in shared memory and never
reaches device memory; its grid is computed in the C entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cin import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu

_P, _I = ctypes.c_void_p, ctypes.c_int

CIN = CudaKernel("cin", "cin_layer", [_P, _P, _P, _P, _I, _I, _I, _I, _I])


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
        CIN(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, m, d, Hp)
    return out
