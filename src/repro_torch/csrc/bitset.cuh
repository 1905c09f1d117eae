// Packed-bitset bit test shared by the CUDA kernels of the port.
//
// Words hold bit i at (words[i >> 5] >> (i & 31)) & 1, as in
// repro_torch/kernels/bitset/ref.py. An id outside [0, 32 * n_words) is a
// member of no set (lookup_reference's semantics), never a clipped word:
// its word is not read. The word is read through the read-only path (L1),
// where neighbouring ids' gathers of one word meet.
#pragma once

#include <cstdint>

__device__ __forceinline__ bool bit_test(const uint32_t* words, int n_words, int32_t id) {
    if (id < 0 || (long long)id >= 32LL * n_words) return false;
    return (__ldg(words + (id >> 5)) >> (id & 31)) & 1u;
}
