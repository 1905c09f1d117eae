"""Wrappers of the packed-bitset CUDA kernels (``csrc/bitset.cu``).

Each wrapper takes int32 word tensors (uint32 bit patterns). A CPU tensor
goes to the plain version in `repro_torch.kernels.bitset.ref`; a CUDA
tensor launches the kernel or raises.

  * `bitset_lookup` replaces ``bitset_lookup`` of
    ``src/repro/kernels/bitset/bitset.py`` — sixteen ids a thread, four
    16-byte loads, sixteen word gathers through L1, one 16-byte store;
  * `bitset_pack` replaces ``bitset_pack`` of the same file — one thread
    per word, two 16-byte loads of its 32 flags, one 4-byte store; its C
    entry point takes the number of flags, so `pack_flags` (what
    `mask_to_host` calls) packs a ragged mask without a padded copy;
  * `bitset_build` replaces the TPU backend's XLA scatter + ``bitset_pack``
    pair — Hopper has ``atomicOr``, so one thread per id ORs its bit into
    words the same call zeroed; given a round's ``(n, width)`` columns it
    builds all ``width`` bitsets in that one call;
  * `bitset_unpack` replaces ``bitset_unpack`` of the same file — a lane
    per half word (16 bits, one 2-byte load), one 16-byte store of its 16
    bools, a warp's store 512 contiguous bytes;
  * `candidate_filter` replaces ``candidate_filter`` of the same file —
    sixteen edges a thread, read lazily: one 16-byte load of their
    ``root_ok`` bytes, the labels only of flagged edges, the ids only of
    label matches, the bit test of ``csrc/bitset.cuh``, one 16-byte store.

All five move a few bytes per element and compute nearly nothing, so the
card's memory rate bounds them; the kernels read every input they need
once, coalesced, and write every output once. Any length and any start of
the 1-D inputs is taken: the C entry points send a ragged last group, and
arrays off 16-byte alignment (slices), down an element-by-element path in
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.bitset import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LOOKUP = CudaKernel("bitset", "bitset_lookup", [_P, _I, _P, _L, _P])
BUILD = CudaKernel("bitset", "bitset_build", [_P, _P, _L, _I, _P, _L])
PACK = CudaKernel("bitset", "bitset_pack", [_P, _L, _P])  # mask, its flag count, words
UNPACK = CudaKernel("bitset", "bitset_unpack", [_P, _L, _P])
FILTER = CudaKernel("bitset", "candidate_filter", [_P, _I, _P, _P, _P, _L, _I, _P])


def bitset_lookup(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(W,)`` int32 words, ``(n,)`` int32 ids → ``(n,)`` bool membership;
    negative and out-of-range ids are False."""
    if on_cpu(words, ids):
        return ref.lookup_reference(words, ids)
    check(words, "words", torch.int32, 1)
    check(ids, "ids", torch.int32, 1)
    out = torch.empty(ids.shape, dtype=torch.bool, device=ids.device)
    if ids.numel():
        LOOKUP(words.data_ptr(), words.shape[0], ids.data_ptr(), ids.numel(), out.data_ptr())
    return out


def bitset_build(ids: torch.Tensor, valid: torch.Tensor, nwords: int) -> torch.Tensor:
    """``(n,)`` int32 ids with ``(n,)`` bool validity → ``(nwords,)`` int32
    words with the valid ids' bits set (a negative id wraps once; an id
    still out of range is dropped). ``(n, width)`` ids — a round's columns —
    give ``(width, nwords)``: column ``p``'s bitset in row ``p``, one launch."""
    if on_cpu(ids, valid):
        return ref.build_reference(ids, valid, nwords)
    if ids.dim() not in (1, 2):
        raise ValueError(f"ids: expected rank 1 or 2, got shape {tuple(ids.shape)}")
    check(ids, "ids", torch.int32, ids.dim())
    check(valid, "valid", torch.bool, 1)
    if valid.shape[0] != ids.shape[0]:
        raise ValueError(f"valid {tuple(valid.shape)} does not match ids {tuple(ids.shape)}")
    width = ids.shape[1] if ids.dim() == 2 else 1
    words = torch.empty((width, nwords), dtype=torch.int32, device=ids.device)
    if words.numel():
        BUILD(ids.data_ptr(), valid.data_ptr(), ids.shape[0], width, words.data_ptr(), nwords)
    return words if ids.dim() == 2 else words[0]


def bitset_pack(mask: torch.Tensor) -> torch.Tensor:
    """``(n,)`` bool with ``n % 32 == 0`` → ``(n/32,)`` int32 words."""
    if on_cpu(mask):
        return ref.pack_reference(mask)
    check(mask, "mask", torch.bool, 1)
    if mask.shape[0] % ref.WORD_BITS:
        raise ValueError(f"mask length {mask.shape[0]} is not a whole number of words")
    return _pack(mask)


def pack_flags(mask: torch.Tensor) -> torch.Tensor:
    """``(n,)`` bool of any length → ``(ceil(n/32),)`` int32 words, the
    bits past ``n`` zero: `bitset_pack` without its whole-word rule, for
    `mask_to_host`."""
    if on_cpu(mask):
        return ref.pack_padded_reference(mask)
    check(mask, "mask", torch.bool, 1)
    return _pack(mask)


def _pack(mask: torch.Tensor) -> torch.Tensor:
    n = mask.shape[0]
    words = torch.empty(ref.n_words(n), dtype=torch.int32, device=mask.device)
    if n:
        PACK(mask.data_ptr(), n, words.data_ptr())
    return words


def bitset_unpack(words: torch.Tensor) -> torch.Tensor:
    """``(W,)`` int32 words → ``(W*32,)`` bool bits."""
    if on_cpu(words):
        return ref.unpack_reference(words)
    check(words, "words", torch.int32, 1)
    out = torch.empty(words.shape[0] * ref.WORD_BITS, dtype=torch.bool, device=words.device)
    if words.numel():
        UNPACK(words.data_ptr(), words.shape[0], out.data_ptr())
    return out


def candidate_filter(
    words: torch.Tensor,
    dst_ids: torch.Tensor,
    dst_labels: torch.Tensor,
    root_ok: torch.Tensor,
    child_label: int,
) -> torch.Tensor:
    """``(E,)`` bool: ``root_ok ∧ dst_labels == child_label ∧ bit(dst_ids)``
    over ``(W,)`` int32 words; an id outside the bitset is no member."""
    if on_cpu(words, dst_ids, dst_labels, root_ok):
        return ref.candidate_filter_reference(words, dst_ids, dst_labels, root_ok, child_label)
    check(words, "words", torch.int32, 1)
    check(dst_ids, "dst_ids", torch.int32, 1)
    check(dst_labels, "dst_labels", torch.int32, 1)
    check(root_ok, "root_ok", torch.bool, 1)
    n = dst_ids.shape[0]
    if dst_labels.shape[0] != n or root_ok.shape[0] != n:
        raise ValueError(
            f"edge arrays differ in length: dst_ids {n}, dst_labels "
            f"{dst_labels.shape[0]}, root_ok {root_ok.shape[0]}"
        )
    out = torch.empty(n, dtype=torch.bool, device=dst_ids.device)
    if n:
        FILTER(words.data_ptr(), words.shape[0], dst_ids.data_ptr(), dst_labels.data_ptr(),
               root_ok.data_ptr(), n, int(child_label), out.data_ptr())
    return out


def mask_to_host(pack, mask: torch.Tensor):
    """A device bool mask as a host numpy bool array, moved as packed words
    (32 times fewer bytes cross to the host). ``pack`` packs a mask of any
    length: `pack_flags`, or its plain version ``ref.pack_padded_reference``."""
    return ref.unpack_bitset(pack(mask).cpu().numpy(), mask.shape[0])
