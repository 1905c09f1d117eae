// Fused STwig expansion (MatchSTwig steps 2-3) for Hopper (sm_90a).
//
// Replaces stwig_expand of src/repro/kernels/stwig_expand/stwig_expand.py
// (its three Pallas kernels _mask_ics_kernel, _nxt_kernel, _emit_kernel).
// The TPU design needs a global prefix sum and a reverse suffix-min only
// because its grid runs in order on one core. Here every root's edges are
// already one contiguous CSR segment [indptr[r], indptr[r+1]), so one warp
// owns one root row r in [0, cap] (the ghost row cap included) and walks its
// segment in chunks of 32 edges, evaluating all k children on each edge:
// a ballot gives the chunk's survivor mask, a survivor's rank is
// running + popc(mask & lanemask_lt), and survivors of rank < C write
// cand[c, r, rank]. The running count keeps growing past C, so counts are
// exact. The remaining slots get the ghost id n_total.
//
// Bound: bytes. Each edge's dst, label and root_ok (9 bytes) are read once,
// coalesced, plus a 4-byte binding-word gather per bound child that hits
// L2; k * (cap+1) * C * 4 bytes of candidates are written. R-MAT degree
// skew leaves one warp walking the largest segment while others are done;
// balancing that is left for later.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitset.cuh"

namespace {

constexpr int kMaxChildren = 16;
constexpr int kWarpsPerBlock = 8;

struct Children {
    int k;
    int label[kMaxChildren];
    int bound[kMaxChildren];
};

__global__ void stwig_expand_kernel(const uint32_t* __restrict__ words_k, int n_words,
                                    const int32_t* __restrict__ dst,
                                    const int32_t* __restrict__ lab,
                                    const int32_t* __restrict__ indptr,
                                    const uint8_t* __restrict__ root_ok, long long E,
                                    Children ch, int C, int cap, int n_total,
                                    int32_t* __restrict__ cand, int32_t* __restrict__ cnt) {
    const int lane = threadIdx.x & 31;
    const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (r > cap) return;  // whole warps leave together
    const unsigned lt_mask = (1u << lane) - 1u;
    long long lo = indptr[r], hi = indptr[r + 1];
    lo = lo < 0 ? 0 : (lo > E ? E : lo);
    hi = hi < lo ? lo : (hi > E ? E : hi);

    int running[kMaxChildren];
#pragma unroll
    for (int c = 0; c < kMaxChildren; ++c) running[c] = 0;

    for (long long base = lo; base < hi; base += 32) {
        const long long e = base + lane;
        const bool live = e < hi;
        int32_t d = n_total, l = -1;
        bool ok = false;
        if (live) {
            d = dst[e];
            l = lab[e];
            ok = root_ok[e] != 0;
        }
#pragma unroll
        for (int c = 0; c < kMaxChildren; ++c) {
            if (c >= ch.k) break;
            bool s = ok && l == ch.label[c];
            if (s && ch.bound[c]) s = bit_test(words_k + (long long)c * n_words, n_words, d);
            const unsigned m = __ballot_sync(0xffffffffu, s);
            if (s) {
                const int rank = running[c] + __popc(m & lt_mask);
                if (rank < C) cand[((long long)c * (cap + 1) + r) * C + rank] = d;
            }
            running[c] += __popc(m);
        }
    }
#pragma unroll
    for (int c = 0; c < kMaxChildren; ++c) {
        if (c >= ch.k) break;
        int32_t* row = cand + ((long long)c * (cap + 1) + r) * C;
        for (int p = running[c] + lane; p < C; p += 32) row[p] = n_total;
        if (lane == 0 && r < cap) cnt[(long long)c * cap + r] = running[c];
    }
}

}  // namespace

extern "C" int stwig_expand(const void* words_k, int n_words, const void* dst,
                            const void* lab, const void* indptr, const void* root_ok,
                            long long E, int k, const int* child_labels,
                            const int* child_bound, int C, int cap, int n_total,
                            void* cand, void* cnt, void* stream) {
    if (k < 1 || k > kMaxChildren) return (int)cudaErrorInvalidValue;
    Children ch;
    ch.k = k;
    for (int c = 0; c < kMaxChildren; ++c) {
        ch.label[c] = c < k ? child_labels[c] : -1;
        ch.bound[c] = c < k ? child_bound[c] : 0;
    }
    const long long rows = (long long)cap + 1;
    const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    stwig_expand_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words_k, n_words, (const int32_t*)dst, (const int32_t*)lab,
        (const int32_t*)indptr, (const uint8_t*)root_ok, E, ch, C, cap, n_total,
        (int32_t*)cand, (int32_t*)cnt);
    return (int)cudaGetLastError();
}
