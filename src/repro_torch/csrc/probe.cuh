// Unsigned lower bound over sorted 32-bit keys, shared by the join kernels
// (hash_join.cu, join_probe.cu).
//
// searchsorted(ka, key, side="left") in unsigned order, as a branchy binary
// search of `steps` = bit_length(cap_a) guarded steps: the interval
// [0, cap_a] has cap_a + 1 states, and a converged interval (lo == hi)
// must not move again. bit_length(cap_a - 1) steps are one short when
// cap_a is a power of two (the reference's pinned off-by-one). hash_join.cu
// runs it over a copy of the keys in shared memory or over device memory:
// the caller passes either pointer.
#pragma once

#include <cstdint>

__device__ __forceinline__ int probe_lower_bound(const uint32_t* __restrict__ ka, int cap_a,
                                                 uint32_t key, int steps) {
    int lo = 0, hi = cap_a;
    for (int s = 0; s < steps; ++s) {
        if (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (ka[mid] < key) lo = mid + 1;
            else hi = mid;
        }
    }
    return lo;
}

// bit_length(cap_a) for cap_a >= 1: the search's step count.
inline int probe_steps(int cap_a) { return 32 - __builtin_clz((unsigned)cap_a); }
