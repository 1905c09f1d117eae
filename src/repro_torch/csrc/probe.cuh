// The pieces the join kernels share (hash_join.cu, join_probe.cu): the
// unsigned lower bound over sorted 32-bit keys, the walk that writes each
// probe row's window of (hit, idx) as one flat range of slots in 16-byte
// stores, and the persistent grid's size.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

// searchsorted(ka, key, side="left") in unsigned order, as a branchy binary
// search of `steps` = bit_length(cap_a) guarded steps: the interval
// [0, cap_a] has cap_a + 1 states, and a converged interval (lo == hi)
// must not move again. bit_length(cap_a - 1) steps are one short when
// cap_a is a power of two (the reference's pinned off-by-one). hash_join.cu
// runs it over a copy of the keys in shared memory or over device memory:
// the caller passes either pointer.
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

// ---------------------------------------------------------------- windows
// Row r's window has dup slots; slot w is build position p = lo[r] + w:
//   idx = p clamped to [0, cap_a - 1], written even where hit is false;
//   hit = p < cap_a ∧ ka[idx] == key[r] ∧ the kernel's own test.
// The outputs (rows, dup) are walked as one flat range of rows * dup slots:
// a thread takes 16 slots of hit (one 16-byte store) and four 4-slot pieces
// of idx (four 16-byte stores) a step, so that each store of a warp covers
// 512 contiguous bytes. Row is the row index's type (a tile's int, or a
// whole output's long long); lo and key are indexed by it.
struct Window {
    const uint32_t* ka;   // the sorted build keys (device or shared memory)
    int cap_a, dup;
    const int32_t* lo;    // each row's lower bound
    const uint32_t* key;  // each row's probe key
};

// A test that adds nothing to key equality (probe_window's).
struct KeyOnly {
    template <typename Row>
    __device__ bool row(Row) const { return true; }
    template <typename Row>
    __device__ bool slot(Row, int) const { return true; }
};

// A thread's walk over (row, slot) pairs, `stride` slots a step: one
// division at its start, then a constant step of (rows, slots).
template <typename Row>
struct Walk {
    Row r, dq;
    int w, dr, dup;
    __device__ Walk(unsigned long long first, unsigned long long stride, int dup_) : dup(dup_) {
        r = (Row)(first / (unsigned long long)dup);
        w = (int)(first - (unsigned long long)r * dup);
        dq = (Row)(stride / (unsigned long long)dup);
        dr = (int)(stride - (unsigned long long)dq * dup);
    }
    __device__ void step() {
        r += dq;
        w += dr;
        if (w >= dup) {
            w -= dup;
            ++r;
        }
    }
};

// hit of one slot. test.row(r) gates the whole row, test.slot(r, pos) a
// build position whose key equals the row's.
template <typename Row, typename Test>
__device__ __forceinline__ bool slot_hit(const Window& v, const Test& test, Row r, int w) {
    const long long p = (long long)v.lo[r] + w;
    const int pc = p < 0 ? 0 : (int)p;  // read only when p < cap_a
    return p < v.cap_a && test.row(r) && v.ka[pc] == v.key[r] && test.slot(r, pc);
}

// idx of one slot.
template <typename Row>
__device__ __forceinline__ int slot_idx(const Window& v, Row r, int w) {
    const long long p = (long long)v.lo[r] + w;
    return p < v.cap_a ? (p < 0 ? 0 : (int)p) : v.cap_a - 1;
}

// Four flags (bits 0-3 of m) as four bytes of 0 or 1, little-endian.
__device__ __forceinline__ uint32_t flag_bytes(unsigned m) {
    return ((m & 0xFu) * 0x00204081u) & 0x01010101u;
}

// hit of the 16 slots that start at (r, w), as 16 bytes. A piece in one row
// and inside the build side (nearly all, at dup >= 16) compares its 16 keys
// at once and runs the test only on the equal ones.
template <typename Row, typename Test>
__device__ __forceinline__ uint4 hit_vector(const Window& v, const Test& test, Row r, int w) {
    const long long pos = (long long)v.lo[r] + w;
    unsigned m = 0;  // bit i: slot i hits
    if ((long long)w + 16 <= v.dup && pos >= 0 && pos + 16 <= v.cap_a) {
        if (test.row(r)) {
            const uint32_t key = v.key[r];
            const uint32_t* kp = v.ka + pos;
#pragma unroll
            for (int i = 0; i < 16; ++i) m |= (unsigned)(kp[i] == key) << i;
            for (unsigned rest = m; rest; rest &= rest - 1) {
                const int i = __ffs(rest) - 1;
                if (!test.slot(r, (int)pos + i)) m &= ~(1u << i);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            if (slot_hit(v, test, r, w)) m |= 1u << i;
            if (++w == v.dup && i < 15) {  // the next slot is the next row's first
                w = 0;
                ++r;
            }
        }
    }
    return make_uint4(flag_bytes(m), flag_bytes(m >> 4), flag_bytes(m >> 8), flag_bytes(m >> 12));
}

// idx of the 4 slots that start at (r, w).
template <typename Row>
__device__ __forceinline__ int4 idx_vector(const Window& v, Row r, int w) {
    const long long pos = (long long)v.lo[r] + w;
    if ((long long)w + 4 <= v.dup && pos >= 0 && pos + 4 <= v.cap_a)  // one row, in range
        return make_int4((int)pos, (int)pos + 1, (int)pos + 2, (int)pos + 3);
    int out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[i] = slot_idx(v, r, w);
        if (++w == v.dup && i < 3) {
            w = 0;
            ++r;
        }
    }
    return make_int4(out[0], out[1], out[2], out[3]);
}

// Write hit and idx of the flat range of n_slots slots that starts at row 0
// slot 0, as thread t of nt: the steps over 16 * nt slots, then the scalar
// tails of the range (< 16 slots of hit, < 4 of idx). hit and idx must be
// 16-byte aligned. Streaming stores: the outputs are written once and not
// read again by the kernel.
template <typename Row, typename Test>
__device__ __forceinline__ void store_window(const Window& v, const Test& test, uint8_t* hit,
                                             int32_t* idx, unsigned long long n_slots,
                                             unsigned long long t, unsigned long long nt) {
    const unsigned long long n16 = n_slots / 16, n4 = n_slots / 4;
    Walk<Row> a(16 * t, 16 * nt, v.dup);
    Walk<Row> b(4 * t, 4 * nt, v.dup);
    for (unsigned long long u = t, q = t; q < n4; u += nt, a.step()) {
        if (u < n16) __stcs((uint4*)(hit + 16 * u), hit_vector(v, test, a.r, a.w));
#pragma unroll
        for (int m = 0; m < 4; ++m, q += nt, b.step())
            if (q < n4) __stcs((int4*)(idx + 4 * q), idx_vector(v, b.r, b.w));
    }
    for (unsigned long long l = 16 * n16 + t; l < n_slots; l += nt) {
        const Row r = (Row)(l / (unsigned long long)v.dup);
        hit[l] = slot_hit(v, test, r, (int)(l - (unsigned long long)r * v.dup));
    }
    for (unsigned long long l = 4 * n4 + t; l < n_slots; l += nt) {
        const Row r = (Row)(l / (unsigned long long)v.dup);
        idx[l] = slot_idx(v, r, (int)(l - (unsigned long long)r * v.dup));
    }
}

// ------------------------------------------------------------------ grids
// A kernel's persistent grid, set up at its first launch on each device:
// it lets the kernel take up to max_smem bytes of dynamic shared memory,
// and its size is the blocks that stay resident together on an SM at that
// much shared memory, registers counted (the occupancy query), times the
// SMs.
struct Grid {
    static constexpr int kDevices = 64;
    int blocks[kDevices] = {};

    int size(const void* kernel, int threads, int max_smem) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (dev < kDevices && blocks[dev]) return blocks[dev];
        int sms = 0, per_sm = 0;
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, max_smem);
        const int n = std::max(per_sm, 1) * sms;
        if (dev < kDevices) blocks[dev] = n;
        return n;
    }
};
