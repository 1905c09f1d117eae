"""Packed bitsets: the plain PyTorch versions of the bitset kernels, and the
numpy host-side helpers (copied from the JAX package).

The convention is the JAX package's: bit ``i`` of word ``i // 32`` is
``(w >> (i % 32)) & 1``; a bitset covers global ids ``[0, n_total]``
inclusive of the always-zero ghost id. The JAX package stores words as
uint32. PyTorch's uint32 support is thin, so the port holds the same bit
patterns in ``torch.int32`` tensors (numpy: ``words.view(np.uint32)`` gives
the JAX package's values back).

This module and the CUDA sources are the only places that do packed-word
arithmetic; `repro_torch.kernels.stwig_expand` imports the bit test from
here.

Out-of-range semantics: ``lookup_reference`` maps negative or past-the-end
ids to ``False`` — an id that names no bit is a member of no set.
``build_reference`` follows the JAX scatter's ``mode="drop"``: a negative id
first wraps once (``id + n_bits``), and an id still outside
``[0, n_bits)`` is dropped.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def n_words(n_bits: int) -> int:
    return (n_bits + WORD_BITS - 1) // WORD_BITS


# --------------------------------------------------------------------- numpy
def pack_bitset(mask: np.ndarray) -> np.ndarray:
    """Pack a bool array (n,) into uint32 words (ceil(n/32),)."""
    n = mask.shape[0]
    pad = (-n) % WORD_BITS
    m = np.concatenate([mask.astype(np.uint8), np.zeros(pad, np.uint8)])
    bits = m.reshape(-1, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (bits << shifts).sum(axis=1, dtype=np.uint32)


def unpack_bitset(words: np.ndarray, n_bits: int) -> np.ndarray:
    """The first ``n_bits`` bits of int32 or uint32 ``words`` as bools,
    unpacked byte by byte: bit ``i`` is bit ``i % 8`` of the words'
    little-endian byte ``i // 8``."""
    data = np.ascontiguousarray(words.view(np.uint32), dtype="<u4").view(np.uint8)
    bits = np.unpackbits(data, count=min(n_bits, data.size * 8), bitorder="little")
    return bits.view(bool)


def bitset_test_np(words: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Host-side membership test; ids must be in range (no masking)."""
    w = words.view(np.uint32)[ids // WORD_BITS]
    return ((w >> (ids % WORD_BITS).astype(np.uint32)) & np.uint32(1)).astype(bool)


# --------------------------------------------------------------------- torch
def as_int32_words(u: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` → the same 32-bit patterns as int32."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def pack_reference(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool, n % 32 == 0 → (n/32,) int32 words."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    lanes = mask.reshape(-1, WORD_BITS).to(torch.int64) << shifts
    return as_int32_words(lanes.sum(dim=1))


def pack_padded_reference(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool of any length → (ceil(n/32),) int32 words; the flags past
    ``n`` read as zero (the mask zero-padded to whole words)."""
    pad = padded_bits(mask.shape[0]) - mask.shape[0]
    return pack_reference(torch.cat([mask, mask.new_zeros(pad)]) if pad else mask)


def padded_bits(n: int) -> int:
    """The bit count of the smallest whole-word bitset holding ``n`` bits."""
    return n_words(n) * WORD_BITS


def unpack_reference(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words → (W*32,) bool, bit ``i`` of word ``i // 32`` at
    position ``i``."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    # an arithmetic shift of the int32 pattern keeps bit s at position 0
    return (((words[:, None] >> shifts) & 1) > 0).reshape(-1)


def lookup_reference(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership of int32 ``ids`` in int32 ``words``. Negative or
    out-of-range ids are ``False`` (not clipped onto a real word)."""
    n_w = words.shape[0]
    in_range = (ids >= 0) & (ids < n_w * WORD_BITS)
    w = words[torch.clamp(ids >> 5, 0, max(n_w - 1, 0)).long()]
    # an arithmetic shift of the int32 pattern keeps bit s at position 0
    return (((w >> (ids & 31)) & 1) > 0) & in_range


def build_reference(
    ids: torch.Tensor, valid: torch.Tensor, nwords: int
) -> torch.Tensor:
    """A packed bitset of the valid ids (duplicates allowed); ``(n, width)``
    ids give ``(width, nwords)``, the 1-D version on each column."""
    if ids.dim() == 2:
        cols = [build_reference(ids[:, p], valid, nwords) for p in range(ids.shape[1])]
        if not cols:
            return torch.zeros((0, nwords), dtype=torch.int32, device=ids.device)
        return torch.stack(cols)
    n_bits = nwords * WORD_BITS
    wrapped = torch.where(ids < 0, ids + n_bits, ids)
    keep = valid & (wrapped >= 0) & (wrapped < n_bits)
    idx = torch.where(keep, wrapped, n_bits).long()  # n_bits = dump slot
    lanes = torch.zeros(n_bits + 1, dtype=torch.bool, device=ids.device)
    lanes[idx] = True
    return pack_reference(lanes[:n_bits])


def candidate_filter_reference(
    words: torch.Tensor,
    dst_ids: torch.Tensor,
    dst_labels: torch.Tensor,
    root_ok: torch.Tensor,
    child_label: int,
) -> torch.Tensor:
    """The fused MatchSTwig step-2 filter for one child label, per edge:
    ``root_ok ∧ dst_label == child_label ∧ bit(dst_id)``; a destination id
    outside the bitset is no member (`lookup_reference`)."""
    return root_ok & (dst_labels == child_label) & lookup_reference(words, dst_ids)
