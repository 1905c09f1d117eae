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
//   persistent: as many blocks an SM as stay resident together (probe.cuh's
//   Grid), each looping over tiles of probe rows, so the build side crosses
//   from L2 once a block, not once a tile.
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
//   step (probe.cuh's store_window, which join_probe.cu's probe_window runs
//   over its whole output): a thread's 16 slots of hit (one 16-byte store)
//   and four 4-slot pieces of idx (four 16-byte stores, each a warp's 512
//   contiguous bytes), as streaming stores. A piece that lies in one row
//   and inside the build side (nearly all, at dup_cap >= 16) takes a path
//   with no wrap or clamp; a thread finds each piece's (row, slot) by
//   adding a constant step to the last (Walk), not by dividing. The slot
//   test beyond key equality (validity, key columns) is this file's
//   Verified. kRows is a multiple of 16, so every tile's base is 16-byte
//   aligned in both outputs whatever dup_cap is, and only the last tile of
//   capB can end in a scalar tail.
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

// The per-slot test beyond key equality (probe.cuh's Window test): probe
// row r of the tile is valid, build row pc is valid and its key columns
// equal the probe row's.
struct Verified {
    const int32_t* a_keys;
    const uint8_t* a_valid;
    const int32_t* b_keys;  // the tile's first probe row's
    const uint8_t* s_bv;
    int nk;
    __device__ bool row(int r) const { return s_bv[r]; }
    __device__ bool slot(int r, int pc) const {
        if (!a_valid[pc]) return false;
        const int32_t* ak = a_keys + (long long)pc * nk;
        const int32_t* bk = b_keys + (long long)r * nk;
        for (int t = 0; t < nk; ++t)
            if (ak[t] != bk[t]) return false;
        return true;
    }
};

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

        // the tile's outputs, 16-byte aligned (kRows % 16 == 0), walked
        // flat in probe.cuh's 16-byte stores
        const Window v{ka, p.cap_a, p.dup_cap, s_lo, s_key};
        const Verified test{a_keys, a_valid, p.b_keys + j0 * p.nk, s_bv, p.nk};
        store_window<int>(v, test, p.hit + j0 * p.dup_cap, p.idx + j0 * p.dup_cap,
                          (unsigned long long)rows * p.dup_cap, tid, kThreads);
        __syncthreads();  // the scratch is the next tile's
    }
}

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
        const int grid = staged_grid.size((const void*)probe_kernel<true>, kThreads, kMaxSmem);
        const unsigned blocks = (unsigned)std::min(n_tiles, (long long)grid);
        last_route = 1;
        probe_kernel<true><<<blocks, kThreads, p.off_tile + kTileScratch, (cudaStream_t)stream>>>(p);
    } else {
        const int grid = global_grid.size((const void*)probe_kernel<false>, kThreads, kTileScratch);
        const unsigned blocks = (unsigned)std::min(n_tiles, (long long)grid);
        last_route = 0;
        probe_kernel<false><<<blocks, kThreads, kTileScratch, (cudaStream_t)stream>>>(p);
    }
    return (int)cudaGetLastError();
}
