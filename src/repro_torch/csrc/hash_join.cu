// Sort-merge join probe for Hopper (sm_90a).
//
// Replaces hash_join_probe of src/repro/kernels/hash_join/hash_join.py
// (_probe_kernel). For probe row j and window slot w:
//   lo  = the unsigned lower bound of kb[j] in the sorted build keys
//         (probe.cuh: bit_length(capA) guarded steps);
//   p   = lo + w; idx = min(p, capA - 1), written even where hit is false,
//         as the TPU kernel does;
//   hit = p < capA ∧ ka[idx] == kb[j] ∧ a_valid[idx] ∧ b_valid[j] ∧ every
//         key column equal.
//
// Bound: bytes, and the outputs are nearly all of them: capB * dup_cap * 5
// bytes (83.9 of the 86.3 MB of the matcher's 8,192 x 262,144 join at dup
// 64). So the design is about the stores, and about reading the build side
// from somewhere faster than device memory:
//
// * Staged route. The TPU kernel keeps the whole build side in VMEM. Where
//   capA * (5 + 4 * nk) bytes fit kStageBudget (100 KB, so that two blocks
//   fit an SM; that join's is 72 KB), a block copies ka, a_keys and a_valid
//   into shared memory once, with 16-byte loads (stage_copy). The grid is
//   persistent: as many blocks an SM as stay resident together (Grid), each
//   looping over tiles of probe rows, so the build side crosses from L2
//   once a block, not once a tile.
// * Device-memory route. Above the budget a second instantiation of the
//   same kernel reads the build side where it lies (its upper search levels
//   stay in L1 and L2), on a persistent grid sized the same way. The entry
//   point chooses by size, and records the route it launched
//   (hash_join_probe_last_route, for the checks that both routes run);
//   both routes give the same bits.
// * A tile is kRows probe rows. One thread a row searches (the same code
//   over either copy) and leaves lo, the key and b_valid in shared memory;
//   the next tile's kb and b_valid are loaded into registers while this
//   tile stores.
// * The tile's outputs are the contiguous ranges [j0, j0 + kRows) * dup_cap
//   of hit and idx, and threads walk them in order, 16 * kThreads slots a
//   step: a thread's 16 slots of hit (one 16-byte store) and four 4-slot
//   pieces of idx (four 16-byte stores, each a warp's 512 contiguous
//   bytes), as streaming stores. A piece that lies in one row and inside
//   the build side (nearly all, at dup_cap >= 16) takes a path with no
//   wrap or clamp; a thread finds each piece's (row, slot) by adding a
//   constant step to the last (Walk), not by dividing. kRows is a multiple
//   of 16, so every tile's base is 16-byte aligned in both outputs whatever
//   dup_cap is, and only the last tile of capB can end in a scalar tail.
//
// The entry point returns cudaGetLastError() after its launch; it refuses
// outputs that are not 16-byte aligned (the wrapper allocates them) and
// launches nothing when there is nothing to write.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

// Build-side bytes, capA * (5 + 4 * nk), that a block may stage in shared
// memory.
constexpr long long kStageBudget = 102400;
constexpr int kThreads = 512;
constexpr int kRows = kThreads;  // one search thread a row
static_assert(kRows % 16 == 0, "a tile's outputs must start 16-byte aligned");
// the tile's lo (int32), key (uint32) and b_valid (uint8) of each row
constexpr int kTileScratch = 9 * kRows;
// a staged block: the budget, up to 30 bytes of placement slack for each
// of its three arrays (stage_offset) and 15 for the scratch's alignment
constexpr int kMaxSmem = (int)kStageBudget + 3 * 30 + 15 + kTileScratch;

// The first shared offset at or after `end` that is congruent to `ptr`
// mod 16. Each staged array sits at such an offset, so that stage_copy
// moves its body with 16-byte loads and stores and only a head and a tail
// of < 16 bytes one byte at a time, whatever the tensor's alignment.
long long stage_offset(long long end, const void* ptr) {
    return ((end + 15) & ~15LL) + (long long)((uintptr_t)ptr & 15);
}

// Copy n bytes from device memory to shared memory, every thread of the
// block taking part; dst must be congruent to src mod 16 (stage_offset).
__device__ __forceinline__ void stage_copy(uint8_t* dst, const void* src_v, long long n) {
    const uint8_t* src = (const uint8_t*)src_v;
    const int tid = threadIdx.x, nt = blockDim.x;
    const long long head = min(n, (long long)((16 - ((uintptr_t)src & 15)) & 15));
    const long long body = (n - head) / 16;
    const long long tail = n - head - 16 * body;
    if (tid < head) dst[tid] = src[tid];
    uint4* d = (uint4*)(dst + head);
    const uint4* s = (const uint4*)(src + head);
    long long i = tid;
    for (; i + 3 * nt < body; i += 4 * nt) {  // four 16-byte loads in flight a thread
        const uint4 a = s[i], b = s[i + nt], c = s[i + 2 * nt], e = s[i + 3 * nt];
        d[i] = a;
        d[i + nt] = b;
        d[i + 2 * nt] = c;
        d[i + 3 * nt] = e;
    }
    for (; i < body; i += nt) d[i] = s[i];
    if (tid < tail) dst[head + 16 * body + tid] = src[head + 16 * body + tid];
}

struct Probe {
    const uint32_t* ka;
    const int32_t* a_keys;
    const uint8_t* a_valid;
    int cap_a;
    const uint32_t* kb;
    const int32_t* b_keys;
    const uint8_t* b_valid;
    long long cap_b;
    int nk, dup_cap, steps;
    uint8_t* hit;
    int32_t* idx;
    int off_ka, off_keys, off_valid;  // the staged copies' shared offsets
    int off_tile;                     // the tile scratch's
};

// (row, slot) of the tile's slot l.
__device__ __forceinline__ void row_slot(const Probe& p, unsigned long long l, int& r, int& w) {
    const unsigned long long q = l / (unsigned long long)p.dup_cap;
    r = (int)q;
    w = (int)(l - q * (unsigned long long)p.dup_cap);
}

// A thread's walk over a tile's slots, `stride` slots a step: (row, slot)
// by one division at its start, then by adding stride's (rows, slots).
struct Walk {
    int r, w, dq, dr, dup;
    __device__ Walk(const Probe& p, unsigned long long first, int stride) : dup(p.dup_cap) {
        row_slot(p, first, r, w);
        dq = stride / dup;
        dr = stride - dq * dup;
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

// Build row pc is valid and its key columns equal probe row j's (the
// hashes are equal already; the caller has checked b_valid).
__device__ __forceinline__ bool verified(const Probe& p, const int32_t* a_keys,
                                         const uint8_t* a_valid, int pc, long long j) {
    if (!a_valid[pc]) return false;
    const int32_t* ak = a_keys + (long long)pc * p.nk;
    const int32_t* bk = p.b_keys + j * p.nk;
    for (int t = 0; t < p.nk; ++t)
        if (ak[t] != bk[t]) return false;
    return true;
}

// hit of build position pos = lo + w for probe row j, whose key and
// validity are key and bv.
__device__ __forceinline__ bool slot_hit(const Probe& p, const uint32_t* ka, const int32_t* a_keys,
                                         const uint8_t* a_valid, long long pos, uint32_t key,
                                         bool bv, long long j) {
    return bv && pos < p.cap_a && ka[pos] == key && verified(p, a_keys, a_valid, (int)pos, j);
}

// Four flags (bits 0-3 of m) as four bytes of 0 or 1, little-endian.
__device__ __forceinline__ uint32_t flag_bytes(unsigned m) {
    return ((m & 0xFu) * 0x00204081u) & 0x01010101u;
}

// hit of the 16 slots that start at the walk's (row, slot), as 16 bytes.
__device__ __forceinline__ uint4 hit_vector(const Probe& p, const uint32_t* ka,
                                            const int32_t* a_keys, const uint8_t* a_valid,
                                            const int32_t* s_lo, const uint32_t* s_key,
                                            const uint8_t* s_bv, long long j0, int r, int w) {
    const long long lo = s_lo[r];
    unsigned m = 0;  // bit i: slot i hits
    if ((long long)w + 16 <= p.dup_cap && lo + w + 16 <= p.cap_a) {  // one row, all in range
        if (s_bv[r]) {
            const uint32_t key = s_key[r];
            const uint32_t* kp = ka + lo + w;
#pragma unroll
            for (int i = 0; i < 16; ++i) m |= (unsigned)(kp[i] == key) << i;
            for (unsigned rest = m; rest; rest &= rest - 1) {
                const int i = __ffs(rest) - 1;
                if (!verified(p, a_keys, a_valid, (int)(lo + w + i), j0 + r)) m &= ~(1u << i);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            if (slot_hit(p, ka, a_keys, a_valid, (long long)s_lo[r] + w, s_key[r], s_bv[r], j0 + r))
                m |= 1u << i;
            if (++w == p.dup_cap && i < 15) {  // the next slot is the next row's first
                w = 0;
                ++r;
            }
        }
    }
    return make_uint4(flag_bytes(m), flag_bytes(m >> 4), flag_bytes(m >> 8), flag_bytes(m >> 12));
}

// idx of the 4 slots that start at the walk's (row, slot).
__device__ __forceinline__ int4 idx_vector(const Probe& p, const int32_t* s_lo, int r, int w) {
    const long long pos = (long long)s_lo[r] + w;
    if ((long long)w + 4 <= p.dup_cap && pos + 4 <= p.cap_a)  // one row, all in range
        return make_int4((int)pos, (int)pos + 1, (int)pos + 2, (int)pos + 3);
    int out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long q = (long long)s_lo[r] + w;
        out[i] = q < p.cap_a ? (int)q : p.cap_a - 1;
        if (++w == p.dup_cap && i < 3) {
            w = 0;
            ++r;
        }
    }
    return make_int4(out[0], out[1], out[2], out[3]);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) probe_kernel(const Probe p) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x;
    const uint32_t* ka = p.ka;
    const int32_t* a_keys = p.a_keys;
    const uint8_t* a_valid = p.a_valid;
    if constexpr (kStaged) {
        stage_copy(smem + p.off_ka, p.ka, 4LL * p.cap_a);
        stage_copy(smem + p.off_keys, p.a_keys, 4LL * p.cap_a * p.nk);
        stage_copy(smem + p.off_valid, p.a_valid, p.cap_a);
        ka = (const uint32_t*)(smem + p.off_ka);
        a_keys = (const int32_t*)(smem + p.off_keys);
        a_valid = smem + p.off_valid;
    }
    int32_t* s_lo = (int32_t*)(smem + p.off_tile);
    uint32_t* s_key = (uint32_t*)(s_lo + kRows);
    uint8_t* s_bv = (uint8_t*)(s_key + kRows);
    const long long n_tiles = (p.cap_b + kRows - 1) / kRows;

    // this thread's row of the block's next tile, loaded ahead
    uint32_t key = 0;
    uint8_t bv = 0;
    auto fetch = [&](long long tile) {
        const long long j = tile * kRows + tid;
        if (tile < n_tiles && j < p.cap_b) {
            key = p.kb[j];
            bv = p.b_valid[j];
        }
    };
    fetch(blockIdx.x);
    if constexpr (kStaged) __syncthreads();  // the staged copies are whole

    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long j0 = tile * kRows;
        const int rows = (int)min((long long)kRows, p.cap_b - j0);
        if (tid < rows) {
            s_lo[tid] = probe_lower_bound(ka, p.cap_a, key, p.steps);
            s_key[tid] = key;
            s_bv[tid] = bv;
        }
        fetch(tile + gridDim.x);
        __syncthreads();

        const unsigned long long n_slots = (unsigned long long)rows * p.dup_cap;
        uint8_t* hit = p.hit + j0 * p.dup_cap;
        int32_t* idx = p.idx + j0 * p.dup_cap;
        // hit 16 slots and idx 4 x 4 slots a thread a step, both over the
        // same 16 * kThreads slots; one 16-byte store each (a warp's: 512
        // contiguous bytes), streaming (the outputs outgrow L2, and this
        // kernel never reads them)
        const unsigned long long n16 = n_slots / 16, n4 = n_slots / 4;
        Walk a(p, 16ull * tid, 16 * kThreads);
        Walk b(p, 4ull * tid, 4 * kThreads);
        for (unsigned long long v = tid, q = tid; q < n4; v += kThreads, a.step()) {
            if (v < n16)
                __stcs((uint4*)(hit + 16 * v),
                       hit_vector(p, ka, a_keys, a_valid, s_lo, s_key, s_bv, j0, a.r, a.w));
#pragma unroll
            for (int m = 0; m < 4; ++m, q += kThreads, b.step())
                if (q < n4) __stcs((int4*)(idx + 4 * q), idx_vector(p, s_lo, b.r, b.w));
        }
        for (unsigned long long l = 16 * n16 + tid; l < n_slots; l += kThreads) {
            int r, w;
            row_slot(p, l, r, w);
            hit[l] = slot_hit(p, ka, a_keys, a_valid, (long long)s_lo[r] + w, s_key[r],
                              s_bv[r], j0 + r);
        }
        for (unsigned long long l = 4 * n4 + tid; l < n_slots; l += kThreads) {
            int r, w;
            row_slot(p, l, r, w);
            const long long pos = (long long)s_lo[r] + w;
            idx[l] = pos < p.cap_a ? (int)pos : p.cap_a - 1;
        }
        __syncthreads();  // the scratch is the next tile's
    }
}

// A route's persistent grid, set up at its first launch on each device: it
// lets the kernel take up to max_smem bytes of dynamic shared memory, and
// its size is the blocks that stay resident together on an SM at that much
// shared memory, registers counted (the occupancy query), times the SMs.
struct Grid {
    static constexpr int kDevices = 64;
    int blocks[kDevices] = {};

    int size(const void* kernel, int max_smem) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (dev < kDevices && blocks[dev]) return blocks[dev];
        int sms = 0, per_sm = 0;
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, max_smem);
        const int n = std::max(per_sm, 1) * sms;
        if (dev < kDevices) blocks[dev] = n;
        return n;
    }
};

Grid staged_grid, global_grid;
int last_route = -1;  // 1: staged, 0: device memory; -1: none launched yet

}  // namespace

// The route of this process's last launch that wrote anything: 1 for the
// build side staged in shared memory, 0 for device memory, -1 before any.
extern "C" int hash_join_probe_last_route() { return last_route; }

extern "C" int hash_join_probe(const void* ka, const void* a_keys, const void* a_valid,
                               int cap_a, const void* kb, const void* b_keys,
                               const void* b_valid, long long cap_b, int nk, int dup_cap,
                               void* hit, void* idx, void* stream) {
    if (cap_b == 0 || dup_cap == 0) return 0;  // nothing to write
    if (((uintptr_t)hit | (uintptr_t)idx) & 15) return (int)cudaErrorMisalignedAddress;
    Probe p{(const uint32_t*)ka, (const int32_t*)a_keys, (const uint8_t*)a_valid, cap_a,
            (const uint32_t*)kb, (const int32_t*)b_keys, (const uint8_t*)b_valid, cap_b,
            nk, dup_cap, probe_steps(cap_a),
            (uint8_t*)hit, (int32_t*)idx, 0, 0, 0, 0};
    const long long n_tiles = (cap_b + kRows - 1) / kRows;
    if ((long long)cap_a * (5 + 4LL * nk) <= kStageBudget) {
        long long end;
        p.off_ka = (int)stage_offset(0, ka);
        end = p.off_ka + 4LL * cap_a;
        p.off_keys = (int)stage_offset(end, a_keys);
        end = p.off_keys + 4LL * cap_a * nk;
        p.off_valid = (int)stage_offset(end, a_valid);
        end = p.off_valid + cap_a;
        p.off_tile = (int)((end + 15) & ~15LL);
        const int grid = staged_grid.size((const void*)probe_kernel<true>, kMaxSmem);
        const unsigned blocks = (unsigned)std::min(n_tiles, (long long)grid);
        last_route = 1;
        probe_kernel<true><<<blocks, kThreads, p.off_tile + kTileScratch, (cudaStream_t)stream>>>(p);
    } else {
        const int grid = global_grid.size((const void*)probe_kernel<false>, kTileScratch);
        const unsigned blocks = (unsigned)std::min(n_tiles, (long long)grid);
        last_route = 0;
        probe_kernel<false><<<blocks, kThreads, kTileScratch, (cudaStream_t)stream>>>(p);
    }
    return (int)cudaGetLastError();
}
