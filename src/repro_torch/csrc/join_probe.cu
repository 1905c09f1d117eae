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
//   probe_window: p = lo[j] + w, idx = min(p, capA - 1), hit = p < capA and
//     ka[idx] == kb[j] for each slot w of row j's window. Bound: bytes, the
//     5 bytes of output per slot (83.9 of the 86.0 MB of the matcher's
//     8,192 x 262,144 join at dup 64). So the design is about the stores:
//     the outputs hit (capB, dup_cap) and idx (capB, dup_cap) are one flat
//     range of capB * dup_cap slots, which a persistent grid (as many
//     blocks an SM as stay resident) walks with probe.cuh's store_window,
//     the walk hash_join.cu runs over each of its tiles: a thread takes 16
//     slots of hit (one 16-byte streaming store) and four 4-slot pieces of
//     idx (four 16-byte stores) a step, each store a warp's 512 contiguous
//     bytes; its (row, slot) advances by a constant step (Walk), with no
//     division a slot; a row's lo and key are read once a piece, and the
//     16 keys of a piece inside one row and the build side are compared at
//     once. Only the end of the whole output has a scalar tail, so any
//     dup_cap and capB work. ka is read through L1 (32 KB on that join: it
//     stays there, and a staged copy would cost each of the grid's blocks
//     a 32 KB load from L2). lo must lie in [0, capA], as
//     probe_lower_bound gives it; idx is kept inside the build side
//     whatever lo holds (p clamped to [0, capA - 1]).
//
// Each entry point returns cudaGetLastError() after its launch and
// launches nothing when there is nothing to write; probe_window refuses
// outputs that are not 16-byte aligned (the wrapper allocates them).

#include <algorithm>
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

__global__ void __launch_bounds__(kThreads) window_kernel(const Window v, long long cap_b,
                                                          uint8_t* hit, int32_t* idx) {
    const unsigned long long t = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
    store_window<long long>(v, KeyOnly{}, hit, idx, (unsigned long long)cap_b * v.dup, t,
                            (unsigned long long)gridDim.x * kThreads);
}

Grid window_grid;

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
    if (cap_b == 0 || dup_cap == 0) return 0;  // nothing to write
    if (((uintptr_t)hit | (uintptr_t)idx) & 15) return (int)cudaErrorMisalignedAddress;
    const Window v{(const uint32_t*)ka, cap_a, dup_cap, (const int32_t*)lo, (const uint32_t*)kb};
    // a thread a 16-slot piece of hit, at most the resident grid
    const long long pieces = cap_b * dup_cap / 16;
    const long long want = std::max(1LL, (pieces + kThreads - 1) / kThreads);
    const int grid = window_grid.size((const void*)window_kernel, kThreads, 0);
    window_kernel<<<(unsigned)std::min(want, (long long)grid), kThreads, 0,
                    (cudaStream_t)stream>>>(v, cap_b, (uint8_t*)hit, (int32_t*)idx);
    return (int)cudaGetLastError();
}
