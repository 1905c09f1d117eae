// Packed-bitset kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bitset/bitset.py:
//   bitset_lookup  <- bitset_lookup (_lookup_kernel)
//   bitset_pack    <- bitset_pack (_pack_kernel)
//   bitset_build   <- the XLA bool scatter + bitset_pack pair that the TPU
//                     backend runs for Kernels.bitset_build
//
// All three are bound by bytes: each does O(1) integer work per element.
// lookup: one thread per id, a coalesced id read, one 4-byte word gather
// (the bitset is small enough to stay in L2) and a 1-byte store.
// build: Hopper has a scatter-OR, so there is no bool lane array and no
// pack pass: one thread per (id, valid) does atomicOr into the zeroed words.
// pack: one warp per word, __ballot_sync gathers 32 bools into the word.
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
                             const uint8_t* __restrict__ valid, long long n,
                             uint32_t* __restrict__ words, long long n_bits) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !valid[i]) return;
    long long id = ids[i];
    if (id < 0) id += n_bits;  // a negative index wraps once, as in JAX
    if (id < 0 || id >= n_bits) return;  // ... and what is still outside drops
    atomicOr(&words[id >> 5], 1u << (id & 31));
}

__global__ void pack_kernel(const uint8_t* __restrict__ mask, long long n_words,
                            uint32_t* __restrict__ words) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long w = i >> 5;
    if (w >= n_words) return;  // whole warps leave together: blockDim % 32 == 0
    unsigned bits = __ballot_sync(0xffffffffu, mask[i] != 0);
    if ((threadIdx.x & 31) == 0) words[w] = bits;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int bitset_lookup(const void* words, int n_words, const void* ids,
                             long long n, void* out, void* stream) {
    lookup_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const int32_t*)ids, n, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int bitset_build(const void* ids, const void* valid, long long n,
                            void* words, long long n_bits, void* stream) {
    build_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint8_t*)valid, n, (uint32_t*)words, n_bits);
    return (int)cudaGetLastError();
}

extern "C" int bitset_pack(const void* mask, long long n_words, void* words,
                           void* stream) {
    pack_kernel<<<blocks_for(n_words * 32), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, n_words, (uint32_t*)words);
    return (int)cudaGetLastError();
}
