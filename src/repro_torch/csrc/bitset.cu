// Packed-bitset kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bitset/bitset.py:
//   bitset_lookup  <- bitset_lookup (_lookup_kernel)
//   bitset_pack    <- bitset_pack (_pack_kernel)
//   bitset_build   <- the XLA bool scatter + bitset_pack pair that the TPU
//                     backend runs for Kernels.bitset_build, for each of a
//                     round's columns (src/repro/core/match.py's loop)
//   bitset_unpack  <- bitset_unpack (_unpack_kernel)
//   candidate_filter <- candidate_filter (_cand_filter_kernel)
//
// All five are bound by bytes: each does O(1) integer work per element.
// lookup: one thread per id, a coalesced id read, one 4-byte word gather
// (the bitset is small enough to stay in L2) and a 1-byte store.
// build: Hopper has a scatter-OR, so there is no bool lane array and no
// pack pass. One call builds all `width` columns of a round's (n, width)
// ids: cudaMemsetAsync zeroes the (width, nwords) words, then one thread per
// (row, column) pair, reading the ids row-major and coalesced, does
// atomicOr into its column's words. At ~2 MB a round it is bound by its
// launch, so one launch a round replaces one a column.
// pack: one thread per word. Its 32 flag bytes come in as two 16-byte
// streaming loads; each 4-byte lane becomes 4 bits (a SIMD byte compare
// with zero, then one multiply gathers the four 0/1 bytes into a nibble),
// and one 4-byte store writes the word, a warp 128 contiguous bytes. The
// entry point takes the number of flags, not of words: flags past the end
// of the mask read as zero in the last word, so a ragged mask needs no
// padded copy. The last word, and every word of a mask whose data start
// off 16-byte alignment (a slice), read their bytes one at a time.
// unpack: the output (32 bytes per word) is 8 times the input, so the
// stores are what count: one thread per 4 bits writes its 4 bools as one
// 4-byte store, a warp 128 contiguous bytes; the word read is shared by 8
// neighbouring threads and comes from L1.
// candidate_filter: one thread per edge, coalesced reads of the three edge
// arrays and a 1-byte store; the bitset (0.47 MB for 3.77M ids) stays in L2
// for the gathers of the bit test (bitset.cuh, lookup's semantics).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitset.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lookup_kernel(const uint32_t* __restrict__ words, int n_words,
                              const int32_t* __restrict__ ids, long long n,
                              uint8_t* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = bit_test(words, n_words, ids[i]) ? 1 : 0;
}

__global__ void build_kernel(const int32_t* __restrict__ ids,
                             const uint8_t* __restrict__ valid, long long n, int width,
                             uint32_t* __restrict__ words, long long nwords) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // row i / width
    if (i >= n * width || !valid[i / width]) return;
    const long long n_bits = nwords * 32;
    long long id = ids[i];
    if (id < 0) id += n_bits;  // a negative index wraps once, as in JAX
    if (id < 0 || id >= n_bits) return;  // ... and what is still outside drops
    atomicOr(&words[(i % width) * nwords + (id >> 5)], 1u << (id & 31));
}

// Four flag bytes (little-endian: flag 0 in the lowest byte) as bits 0-3,
// each set where its byte is nonzero: the 0/1 bytes at bits 0, 8, 16, 24
// times kGather land, without carries, on bits 24, 25, 26, 27.
constexpr uint32_t kLaneOnes = 0x01010101u;
constexpr uint32_t kGather = 0x01020408u;
__device__ __forceinline__ uint32_t lane_bits(uint32_t x) {
    return ((__vcmpne4(x, 0u) & kLaneOnes) * kGather) >> 24;
}

__device__ __forceinline__ uint32_t vector_bits(uint4 v) {
    return lane_bits(v.x) | lane_bits(v.y) << 4 | lane_bits(v.z) << 8 | lane_bits(v.w) << 12;
}

__global__ void pack_kernel(const uint8_t* __restrict__ mask, long long n, long long n_words,
                            bool aligned, uint32_t* __restrict__ words) {
    const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= n_words) return;
    const long long f = 32 * w;  // the word's first flag
    uint32_t bits = 0;
    if (aligned && f + 32 <= n) {
        const uint4* src = (const uint4*)(mask + f);
        bits = vector_bits(__ldcs(src)) | vector_bits(__ldcs(src + 1)) << 16;
    } else {
        const int m = (int)min(32LL, n - f);
        for (int i = 0; i < m; ++i) bits |= (uint32_t)(mask[f + i] != 0) << i;
    }
    words[w] = bits;
}

__global__ void unpack_kernel(const uint32_t* __restrict__ words, long long n_quads,
                              uint32_t* __restrict__ out) {
    long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // bits 4q .. 4q+3
    if (q >= n_quads) return;
    uint32_t nib = (words[q >> 3] >> ((q & 7) * 4)) & 0xFu;
    // bool bytes, little-endian: bit 4q in the lowest byte
    out[q] = (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 | (nib >> 3) << 24;
}

__global__ void cand_filter_kernel(const uint32_t* __restrict__ words, int n_words,
                                   const int32_t* __restrict__ dst_ids,
                                   const int32_t* __restrict__ dst_labels,
                                   const uint8_t* __restrict__ root_ok, long long n,
                                   int32_t child_label, uint8_t* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = (root_ok[i] && dst_labels[i] == child_label &&
              bit_test(words, n_words, dst_ids[i])) ? 1 : 0;
}

unsigned blocks_for(long long n, int threads = kThreads) {
    return (unsigned)((n + threads - 1) / threads);
}

// 128-thread blocks for pack: the main path's 24,576 words then spread
// over 192 blocks, past the 132 SMs.
constexpr int kPackThreads = 128;

}  // namespace

extern "C" int bitset_lookup(const void* words, int n_words, const void* ids,
                             long long n, void* out, void* stream) {
    lookup_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const int32_t*)ids, n, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int bitset_build(const void* ids, const void* valid, long long n, int width,
                            void* words, long long nwords, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(words, 0, (size_t)width * nwords * 4, s);
    if (err != cudaSuccess || n * width == 0) return (int)err;
    build_kernel<<<blocks_for(n * width), kThreads, 0, s>>>(
        (const int32_t*)ids, (const uint8_t*)valid, n, width, (uint32_t*)words, nwords);
    return (int)cudaGetLastError();
}

// n flags → ceil(n / 32) words; launches nothing for n == 0.
extern "C" int bitset_pack(const void* mask, long long n, void* words, void* stream) {
    const long long n_words = (n + 31) / 32;
    if (n_words == 0) return 0;
    const bool aligned = ((uintptr_t)mask & 15) == 0;
    pack_kernel<<<blocks_for(n_words, kPackThreads), kPackThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, n, n_words, aligned, (uint32_t*)words);
    return (int)cudaGetLastError();
}

extern "C" int bitset_unpack(const void* words, long long n_words, void* out, void* stream) {
    long long n_quads = n_words * 8;
    unpack_kernel<<<blocks_for(n_quads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_quads, (uint32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int candidate_filter(const void* words, int n_words, const void* dst_ids,
                                const void* dst_labels, const void* root_ok, long long n,
                                int child_label, void* out, void* stream) {
    cand_filter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const int32_t*)dst_ids, (const int32_t*)dst_labels,
        (const uint8_t*)root_ok, n, (int32_t)child_label, (uint8_t*)out);
    return (int)cudaGetLastError();
}
