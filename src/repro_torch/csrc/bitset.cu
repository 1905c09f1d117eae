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
// pack: one warp per word, __ballot_sync gathers 32 bools into the word.
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

__global__ void pack_kernel(const uint8_t* __restrict__ mask, long long n_words,
                            uint32_t* __restrict__ words) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long w = i >> 5;
    if (w >= n_words) return;  // whole warps leave together: blockDim % 32 == 0
    unsigned bits = __ballot_sync(0xffffffffu, mask[i] != 0);
    if ((threadIdx.x & 31) == 0) words[w] = bits;
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

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

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

extern "C" int bitset_pack(const void* mask, long long n_words, void* words,
                           void* stream) {
    pack_kernel<<<blocks_for(n_words * 32), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, n_words, (uint32_t*)words);
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
