// GNN message aggregation for Hopper (sm_90a): the segment sum of
// destination-sorted edge messages into one row per node.
//
// Replaces segment_mp_partials / segment_mp of
// src/repro/extras/segment_mp/segment_mp.py. The TPU kernel ranks each
// edge block's destinations with a (BE x BE) comparison, contracts a rank
// one-hot against the messages on the MXU, recovers node ids by a float
// one-hot sum (exact below 2^24 only) and leaves an XLA scatter-add to
// join blocks. None of that fits this card: there is no matrix unit to
// feed, and nothing carries across blocks.
//
// Design: out (n, d) is zeroed first (by the wrapper). Edges are cut into
// fixed chunks of `chunk` edges; one thread owns one (chunk, column) pair,
// with consecutive threads on consecutive columns of one chunk, so a warp
// reads whole message rows. A thread walks its chunk keeping a running sum
// while dst is unchanged. A segment that starts and ends inside the chunk
// belongs to this chunk alone and is stored; the chunk's first and last
// segments may straddle a chunk edge and are added with atomicAdd. Work is
// the same for every chunk whatever the in-degrees, so an R-MAT hub with
// many thousands of in-edges is spread over many chunks instead of one
// warp. Ids outside [0, n) are dropped, as jax.ops.segment_sum drops them.
// dst must be ascending; the sum is then exact up to fp32 rounding, in an
// order that differs from the plain version's (and, for straddling
// segments, from run to run).
//
// Bound: bytes — the messages and dst read once, the output written once.
// Each thread keeps kUnroll loads in flight before it uses them.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ void flush(float* __restrict__ out, int n_nodes, int d, int c,
                                      int node, float acc, bool straddles) {
    if (node < 0 || node >= n_nodes) return;
    float* p = out + (long long)node * d + c;
    if (straddles) atomicAdd(p, acc);
    else *p = acc;
}

__global__ void segment_mp_kernel(const float* __restrict__ msg, const int32_t* __restrict__ dst,
                                  long long n_edges, int d, int n_nodes, int chunk,
                                  long long n_threads, float* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_threads) return;
    const long long ch = t / d;
    const int c = (int)(t - ch * d);
    const long long e0 = ch * chunk;
    const long long e1 = min(e0 + (long long)chunk, n_edges);
    int cur = dst[e0];
    float acc = 0.f;
    bool first = true;  // the running segment is the chunk's first
    for (long long base = e0; base < e1; base += kUnroll) {
        int ids[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const long long e = base + k;
            ids[k] = e < e1 ? dst[e] : 0;
            v[k] = e < e1 ? msg[e * d + c] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            if (base + k >= e1) break;
            if (ids[k] != cur) {
                flush(out, n_nodes, d, c, cur, acc, first);
                first = false;
                cur = ids[k];
                acc = 0.f;
            }
            acc += v[k];
        }
    }
    flush(out, n_nodes, d, c, cur, acc, true);  // the last segment may go on
}

}  // namespace

extern "C" int segment_mp(const void* msg, const void* dst, long long n_edges, int d,
                          int n_nodes, int chunk, void* out, void* stream) {
    const long long n_chunks = (n_edges + chunk - 1) / chunk;
    const long long n_threads = n_chunks * d;
    const unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
    segment_mp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)msg, (const int32_t*)dst, n_edges, d, n_nodes, chunk, n_threads,
        (float*)out);
    return (int)cudaGetLastError();
}
