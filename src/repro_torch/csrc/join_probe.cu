// The sort-merge join probe as two standalone kernels, for Hopper (sm_90a).
//
// Replaces probe_lower_bound and probe_window of
// src/repro/extras/join_probe/join_probe.py. Keys are uint32 values (int32
// bit patterns on the PyTorch side), compared unsigned.
//
//   probe_lower_bound: one thread per probe row runs probe.cuh's guarded
//     bit_length(capA)-step lower bound over the sorted build keys, the
//     search hash_join.cu runs. The TPU kernel holds the build keys in VMEM;
//     here they are read from device memory and their upper levels stay in
//     L1 and L2. Bound: bytes (capB keys in, capB ids out); the log2(capA)
//     dependent loads per thread are its latency. The keys are not staged
//     in shared memory, as hash_join.cu stages its build side: a call's time
//     is set by its host path, which staging does not shorten (PERF.md).
//   probe_window: one thread per output element (row j, slot w), so that
//     neighbouring threads write neighbouring bytes of hit (capB, dup_cap)
//     and idx (capB, dup_cap): p = lo[j] + w, idx = min(p, capA - 1),
//     hit = p < capA and ka[idx] == kb[j]. Bound: bytes, the 5 bytes of
//     output per element. lo must lie in [0, capA], as probe_lower_bound
//     gives it; idx is kept inside the build side whatever lo holds.
//
// Each entry point returns cudaGetLastError() after its launch;
// probe_lower_bound launches nothing when there is nothing to write.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lower_bound_kernel(const uint32_t* __restrict__ ka, int cap_a,
                                   const uint32_t* __restrict__ kb, long long cap_b, int steps,
                                   int32_t* __restrict__ lo) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= cap_b) return;
    lo[j] = probe_lower_bound(ka, cap_a, kb[j], steps);
}

__global__ void window_kernel(const uint32_t* __restrict__ ka, int cap_a,
                              const uint32_t* __restrict__ kb, const int32_t* __restrict__ lo,
                              long long n_out, int dup_cap, uint8_t* __restrict__ hit,
                              int32_t* __restrict__ idx) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_out) return;
    const long long j = t / dup_cap;
    const long long p = (long long)lo[j] + (t - j * dup_cap);
    const long long pc = p < cap_a ? (p < 0 ? 0 : p) : cap_a - 1;
    hit[t] = (p < cap_a && ka[pc] == kb[j]) ? 1 : 0;
    idx[t] = (int32_t)pc;
}

}  // namespace

extern "C" int probe_lower_bound(const void* ka, int cap_a, const void* kb, long long cap_b,
                                 void* lo, void* stream) {
    if (cap_b == 0) return 0;  // nothing to write
    const unsigned blocks = (unsigned)((cap_b + kThreads - 1) / kThreads);
    lower_bound_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ka, cap_a, (const uint32_t*)kb, cap_b, probe_steps(cap_a),
        (int32_t*)lo);
    return (int)cudaGetLastError();
}

extern "C" int probe_window(const void* ka, int cap_a, const void* kb, const void* lo,
                            long long cap_b, int dup_cap, void* hit, void* idx, void* stream) {
    const long long n_out = cap_b * dup_cap;
    const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
    window_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ka, cap_a, (const uint32_t*)kb, (const int32_t*)lo, n_out, dup_cap,
        (uint8_t*)hit, (int32_t*)idx);
    return (int)cudaGetLastError();
}
