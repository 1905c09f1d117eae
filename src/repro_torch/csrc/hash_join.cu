// Sort-merge join probe for Hopper (sm_90a).
//
// Replaces hash_join_probe of src/repro/kernels/hash_join/hash_join.py
// (_probe_kernel). One thread per probe row: a lower-bound binary search of
// its hashed key over the sorted build keys (probe.cuh: bit_length(capA)
// guarded steps, keys compared as unsigned 32-bit values), then a dup_cap window
// with hit = hash equality ∧ both rows valid ∧ exact key-column equality.
// idx = min(lo + j, capA - 1) is written even where hit is false, as the
// TPU kernel does.
//
// The TPU kernel keeps the whole build side in VMEM. At real capacities it
// does not fit in a block's shared memory here, so the search reads it from
// device memory; its upper levels stay in L2, which is what the kernel
// leans on. Bound: bytes — capB * dup_cap * 5 bytes of output plus one
// pass over both sides; the search's log2(capA) dependent loads per thread
// are its latency.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void probe_kernel(const uint32_t* __restrict__ ka, const int32_t* __restrict__ a_keys,
                             const uint8_t* __restrict__ a_valid, int cap_a,
                             const uint32_t* __restrict__ kb, const int32_t* __restrict__ b_keys,
                             const uint8_t* __restrict__ b_valid, long long cap_b, int nk,
                             int dup_cap, int steps, uint8_t* __restrict__ hit,
                             int32_t* __restrict__ idx) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= cap_b) return;
    const uint32_t key = kb[j];
    const int lo = probe_lower_bound(ka, cap_a, key, steps);
    const bool bv = b_valid[j] != 0;
    const int32_t* bk = b_keys + j * nk;
    for (int w = 0; w < dup_cap; ++w) {
        const long long p = (long long)lo + w;
        const int pc = p < cap_a ? (int)p : cap_a - 1;
        bool h = p < cap_a && bv && ka[pc] == key && a_valid[pc] != 0;
        for (int t = 0; h && t < nk; ++t) h = a_keys[(long long)pc * nk + t] == bk[t];
        hit[j * dup_cap + w] = h ? 1 : 0;
        idx[j * dup_cap + w] = pc;
    }
}

}  // namespace

extern "C" int hash_join_probe(const void* ka, const void* a_keys, const void* a_valid,
                               int cap_a, const void* kb, const void* b_keys,
                               const void* b_valid, long long cap_b, int nk, int dup_cap,
                               int steps, void* hit, void* idx, void* stream) {
    const unsigned blocks = (unsigned)((cap_b + kThreads - 1) / kThreads);
    probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ka, (const int32_t*)a_keys, (const uint8_t*)a_valid, cap_a,
        (const uint32_t*)kb, (const int32_t*)b_keys, (const uint8_t*)b_valid, cap_b, nk,
        dup_cap, steps, (uint8_t*)hit, (int32_t*)idx);
    return (int)cudaGetLastError();
}
