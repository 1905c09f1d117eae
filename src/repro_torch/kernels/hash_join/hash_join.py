"""Wrapper of the join-probe CUDA kernel (``csrc/hash_join.cu``).

Replaces ``hash_join_probe`` of ``src/repro/kernels/hash_join/hash_join.py``:
each probe row's lower bound in the sorted build keys, then its ``dup_cap``
window with exact verification. Bound by the bytes of its ``(capB,
dup_cap)`` outputs. The kernel has two routes, chosen by size in its C
entry point (`last_route` says which the last launch took): where the build
side's ``capA · (5 + 4·nk)`` bytes fit ``kStageBudget`` of
``csrc/hash_join.cu`` (100 KB), each block of a persistent grid copies it
into shared memory once, as the TPU kernel holds it in VMEM; above that the
same kernel reads it from device memory.
Either way one thread a row searches a tile of probe rows, and the tile's
``hit`` and ``idx`` are written as one contiguous range of 16-byte stores.

A CPU tensor goes to the plain version (`repro_torch.kernels.hash_join.ref`);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda import CudaKernel, check, load, on_cpu
from repro_torch.kernels.hash_join import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

PROBE = CudaKernel(
    "hash_join", "hash_join_probe", [_P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _P, _P]
)


def last_route() -> str:
    """The route of this process's last launch of the kernel that wrote
    anything, as its C entry point recorded it: ``"shared"`` (the build side
    staged in shared memory), ``"global"`` (read from device memory) or
    ``"none"`` (no launch yet)."""
    return ("none", "global", "shared")[load("hash_join").hash_join_probe_last_route() + 1]


def hash_join_probe(
    ka_sorted: torch.Tensor,
    a_keys: torch.Tensor,
    a_valid: torch.Tensor,
    kb: torch.Tensor,
    b_keys: torch.Tensor,
    b_valid: torch.Tensor,
    *,
    dup_cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lower bound + window + exact verification; see `ref`."""
    if on_cpu(ka_sorted, a_keys, a_valid, kb, b_keys, b_valid):
        return ref.probe_reference(
            ka_sorted, a_keys, a_valid, kb, b_keys, b_valid, dup_cap=dup_cap
        )
    check(ka_sorted, "ka_sorted", torch.int32, 1)
    check(a_keys, "a_keys", torch.int32, 2)
    check(a_valid, "a_valid", torch.bool, 1)
    check(kb, "kb", torch.int32, 1)
    check(b_keys, "b_keys", torch.int32, 2)
    check(b_valid, "b_valid", torch.bool, 1)
    cap_a, nk = a_keys.shape
    cap_b = kb.shape[0]
    if cap_a < 1 or ka_sorted.shape[0] != cap_a or a_valid.shape[0] != cap_a:
        raise ValueError("the build side needs ≥1 row and matching ka/a_keys/a_valid rows")
    if b_keys.shape != (cap_b, nk) or b_valid.shape[0] != cap_b:
        raise ValueError("b_keys must be (capB, nk) and b_valid (capB,)")
    hit = torch.empty((cap_b, dup_cap), dtype=torch.bool, device=kb.device)
    idx = torch.empty((cap_b, dup_cap), dtype=torch.int32, device=kb.device)
    if cap_b and dup_cap:
        PROBE(
            ka_sorted.data_ptr(), a_keys.data_ptr(), a_valid.data_ptr(), cap_a,
            kb.data_ptr(), b_keys.data_ptr(), b_valid.data_ptr(), cap_b, nk, dup_cap,
            hit.data_ptr(), idx.data_ptr(),
        )
    return hit, idx
