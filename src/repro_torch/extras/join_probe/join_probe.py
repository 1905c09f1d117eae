"""Wrappers of the join-probe CUDA kernels (``csrc/join_probe.cu``).

`probe_lower_bound` and `probe_window` replace the functions of the same
names in ``src/repro/extras/join_probe/join_probe.py``: the lower bound of
each probe key in the sorted build keys (one thread per probe row, the
search ``csrc/hash_join.cu`` also runs, from ``csrc/probe.cuh``), then
each row's ``dup_cap`` window of ``(hit, idx)`` on key equality alone
(the outputs walked as one flat range in 16-byte stores, the walk of
``csrc/probe.cuh`` that ``hash_join_probe`` runs too). Exact key
verification is the caller's, as in the JAX package.

Keys are uint32 held as int32 bit patterns. A CPU tensor goes to the plain
version (`repro_torch.extras.join_probe.ref`); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.extras.join_probe import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LOWER_BOUND = CudaKernel("join_probe", "probe_lower_bound", [_P, _I, _P, _L, _P])
WINDOW = CudaKernel("join_probe", "probe_window", [_P, _I, _P, _P, _L, _I, _P, _P])


def _check_build_side(ka_sorted: torch.Tensor) -> int:
    check(ka_sorted, "ka_sorted", torch.int32, 1)
    cap_a = ka_sorted.shape[0]
    if not 1 <= cap_a < 2**31:
        raise ValueError(f"the build side has {cap_a} keys; it needs 1 to 2**31 - 1")
    return cap_a


def probe_lower_bound(ka_sorted: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """``ka_sorted (capA,)`` ascending unsigned, ``kb (capB,)`` → the lower
    bound of each probe key, ``(capB,)`` int32."""
    if on_cpu(ka_sorted, kb):
        return ref.lower_bound_reference(ka_sorted, kb)
    cap_a = _check_build_side(ka_sorted)
    check(kb, "kb", torch.int32, 1)
    # kb is a contiguous int32 vector, as lo is; naming the format spares
    # empty_like from working out strides on this short host path
    lo = torch.empty_like(kb, memory_format=torch.contiguous_format)
    if kb.numel():
        LOWER_BOUND(ka_sorted.data_ptr(), cap_a, kb.data_ptr(), kb.numel(), lo.data_ptr())
    return lo


def probe_window(
    ka_sorted: torch.Tensor, kb: torch.Tensor, lo: torch.Tensor, *, dup_cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``lo (capB,)`` int32 in ``[0, capA]`` (from `probe_lower_bound`) →
    ``hit (capB, dup_cap)`` bool and ``idx (capB, dup_cap)`` int32."""
    if on_cpu(ka_sorted, kb, lo):
        return ref.window_reference(ka_sorted, kb, lo, dup_cap=dup_cap)
    cap_a = _check_build_side(ka_sorted)
    check(kb, "kb", torch.int32, 1)
    check(lo, "lo", torch.int32, 1)
    if lo.shape != kb.shape:
        raise ValueError(f"lo {tuple(lo.shape)} does not match kb {tuple(kb.shape)}")
    if dup_cap < 0:
        raise ValueError(f"dup_cap {dup_cap} < 0")
    cap_b = kb.shape[0]
    hit = torch.empty((cap_b, dup_cap), dtype=torch.bool, device=kb.device)
    idx = torch.empty((cap_b, dup_cap), dtype=torch.int32, device=kb.device)
    if cap_b and dup_cap:
        WINDOW(ka_sorted.data_ptr(), cap_a, kb.data_ptr(), lo.data_ptr(), cap_b, dup_cap,
               hit.data_ptr(), idx.data_ptr())
    return hit, idx
