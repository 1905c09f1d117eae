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
// lookup: sixteen ids a thread, read as four 16-byte loads (load_lanes),
// sixteen word gathers through L1 (the bitset is small enough to stay in
// L2, and the main path's ids are consecutive, so neighbouring ids share a
// word), and the sixteen bools stored as one 16-byte vector: 64 bytes in
// flight a thread where one id a thread had 4.
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
// stores are what count. A lane takes 16 bits, one 2-byte load of half a
// word (bits 16h .. 16h + 15 of the words on this little-endian card), and
// writes their 16 bools as one 16-byte store (bool_vector); lane t of a
// warp writes bytes 16t .. 16t + 15 of the warp's 512-byte span, so every
// store instruction of a warp covers 512 contiguous bytes, whole sectors.
// A warp walks kUnpackSpans such spans, a thread's loads all issued before
// its stores. The words of a slice start on a 4-byte boundary, so the
// half-word loads need no aligned path; the output (the wrapper's) starts
// on a 16-byte one, and the entry point refuses another.
// candidate_filter: sixteen edges a thread, read lazily by group. Their
// root_ok bytes come in as one 16-byte load; a group with no flag set
// stores sixteen zero bytes and reads nothing else, so a sparse root_ok
// (the main path's: ~1 edge in 418) costs about the two bytes an edge the
// bound counts. A group's labels are read only for its flagged edges, and
// its ids only for the edges whose label matched: as four 16-byte loads
// where every edge of the group needs them, else edge by edge. The bit test
// (bitset.cuh, lookup's semantics) gathers its word through L1 (the
// bitset, 0.47 MB for 3.77M ids, stays in L2), and the sixteen results are
// stored as one 16-byte vector.
// lookup and candidate_filter take the element-by-element path for the
// last, ragged group of a call, and for every group of a call whose arrays
// do not all start on a 16-byte boundary (a slice): never the plain
// version.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "bitset.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // ids (lookup) or edges (candidate_filter) a thread

// Four flags (bits 0-3) as four bool bytes, little-endian: flag 0 in the
// lowest byte.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nib) {
    return (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 | (nib >> 3 & 1u) << 24;
}

// Sixteen flags (bit i: element i) as the sixteen bool bytes of one vector.
__device__ __forceinline__ uint4 bool_vector(uint32_t bits) {
    return make_uint4(nibble_bytes(bits), nibble_bytes(bits >> 4), nibble_bytes(bits >> 8),
                      nibble_bytes(bits >> 12));
}

// The elements of p[0..16) whose bit is set in `lanes`, into v: as four
// 16-byte loads where all sixteen are wanted (p then on a 16-byte
// boundary), else one 4-byte load for each wanted element. The others are
// left as they were. Plain loads, kept in L1: each of a warp's four vector
// loads covers half of every 32-byte sector of the warp's 2 KB, and the
// next one the other half. Streaming (evict-first) loads lost the lines in
// between and fetched them twice, twice the bytes on inputs past L2.
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ p, uint32_t lanes,
                                           int32_t (&v)[kGroup]) {
    if (lanes == 0xFFFFu) {
        const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
        for (int j = 0; j < kGroup / 4; ++j) {
            const int4 a = q[j];
            v[4 * j] = a.x;
            v[4 * j + 1] = a.y;
            v[4 * j + 2] = a.z;
            v[4 * j + 3] = a.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
            if (lanes >> i & 1u) v[i] = p[i];
    }
}

__global__ void lookup_kernel(const uint32_t* __restrict__ words, int n_words,
                              const int32_t* __restrict__ ids, long long n, bool aligned,
                              uint8_t* __restrict__ out) {
    const long long f = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    if (f >= n) return;
    if (aligned && f + kGroup <= n) {
        int32_t v[kGroup];
        load_lanes(ids + f, 0xFFFFu, v);
        uint32_t hit = 0;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) hit |= (uint32_t)bit_test(words, n_words, v[i]) << i;
        *reinterpret_cast<uint4*>(out + f) = bool_vector(hit);
    } else {
        const int m = (int)min((long long)kGroup, n - f);
        for (int i = 0; i < m; ++i) out[f + i] = bit_test(words, n_words, ids[f + i]) ? 1 : 0;
    }
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

// 512-byte spans of output a warp: four half words a thread
constexpr int kUnpackSpans = 4;

__global__ void unpack_kernel(const uint16_t* __restrict__ halves, long long n_halves,
                              uint4* __restrict__ out) {
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long h0 = warp * 32 * kUnpackSpans + (threadIdx.x & 31);  // half words h0 + 32i
    uint32_t bits[kUnpackSpans];
#pragma unroll
    for (int i = 0; i < kUnpackSpans; ++i)
        bits[i] = h0 + 32 * i < n_halves ? halves[h0 + 32 * i] : 0u;
#pragma unroll
    for (int i = 0; i < kUnpackSpans; ++i)
        if (h0 + 32 * i < n_halves) out[h0 + 32 * i] = bool_vector(bits[i]);  // bit 16h first
}

__global__ void cand_filter_kernel(const uint32_t* __restrict__ words, int n_words,
                                   const int32_t* __restrict__ dst_ids,
                                   const int32_t* __restrict__ dst_labels,
                                   const uint8_t* __restrict__ root_ok, long long n,
                                   int32_t child_label, bool aligned,
                                   uint8_t* __restrict__ out) {
    const long long f = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
    if (f >= n) return;
    if (aligned && f + kGroup <= n) {
        const uint32_t ok = vector_bits(__ldcs(reinterpret_cast<const uint4*>(root_ok + f)));
        uint32_t hit = 0;
        if (ok) {
            int32_t v[kGroup] = {};
            load_lanes(dst_labels + f, ok, v);
            uint32_t want = 0;  // root_ok and the child's label
#pragma unroll
            for (int i = 0; i < kGroup; ++i)
                want |= (uint32_t)((ok >> i & 1u) && v[i] == child_label) << i;
            if (want) {
                load_lanes(dst_ids + f, want, v);
#pragma unroll
                for (int i = 0; i < kGroup; ++i)
                    if (want >> i & 1u) hit |= (uint32_t)bit_test(words, n_words, v[i]) << i;
            }
        }
        *reinterpret_cast<uint4*>(out + f) = bool_vector(hit);
    } else {
        const int m = (int)min((long long)kGroup, n - f);
        for (int i = 0; i < m; ++i) {
            const long long e = f + i;
            out[e] = (root_ok[e] && dst_labels[e] == child_label &&
                      bit_test(words, n_words, dst_ids[e])) ? 1 : 0;
        }
    }
}

unsigned blocks_for(long long n, int threads = kThreads) {
    return (unsigned)((n + threads - 1) / threads);
}

// 128-thread blocks for pack: the main path's 24,576 words then spread
// over 192 blocks, past the 132 SMs.
constexpr int kPackThreads = 128;

bool aligned16(std::initializer_list<const void*> ptrs) {
    uintptr_t any = 0;
    for (const void* p : ptrs) any |= (uintptr_t)p;
    return (any & 15) == 0;
}

}  // namespace

// n ids → n bools; launches nothing for n == 0.
extern "C" int bitset_lookup(const void* words, int n_words, const void* ids,
                             long long n, void* out, void* stream) {
    if (n == 0) return 0;
    lookup_kernel<<<blocks_for((n + kGroup - 1) / kGroup), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const int32_t*)ids, n, aligned16({ids, out}),
        (uint8_t*)out);
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
    pack_kernel<<<blocks_for(n_words, kPackThreads), kPackThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, n, n_words, aligned16({mask}), (uint32_t*)words);
    return (int)cudaGetLastError();
}

// n_words words → 32 · n_words bools, out 16-byte aligned; launches
// nothing for n_words == 0.
extern "C" int bitset_unpack(const void* words, long long n_words, void* out, void* stream) {
    if (n_words == 0) return 0;
    if (!aligned16({out})) return (int)cudaErrorMisalignedAddress;
    const long long n_halves = 2 * n_words;
    unpack_kernel<<<blocks_for((n_halves + kUnpackSpans - 1) / kUnpackSpans), kThreads, 0,
                    (cudaStream_t)stream>>>((const uint16_t*)words, n_halves, (uint4*)out);
    return (int)cudaGetLastError();
}

// n edges → n bools; launches nothing for n == 0.
extern "C" int candidate_filter(const void* words, int n_words, const void* dst_ids,
                                const void* dst_labels, const void* root_ok, long long n,
                                int child_label, void* out, void* stream) {
    if (n == 0) return 0;
    cand_filter_kernel<<<blocks_for((n + kGroup - 1) / kGroup), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const int32_t*)dst_ids, (const int32_t*)dst_labels,
        (const uint8_t*)root_ok, n, (int32_t)child_label,
        aligned16({dst_ids, dst_labels, root_ok, out}), (uint8_t*)out);
    return (int)cudaGetLastError();
}
