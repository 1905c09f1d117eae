// Fused STwig expansion (MatchSTwig steps 2-3) for Hopper (sm_90a).
//
// Replaces stwig_expand of src/repro/kernels/stwig_expand/stwig_expand.py
// (its three Pallas kernels _mask_ics_kernel, _nxt_kernel, _emit_kernel).
// The TPU design needs a global prefix sum and a reverse suffix-min only
// because its grid runs in order on one core. Here every root's edges are
// one contiguous CSR segment [indptr[r], indptr[r+1]), so a survivor's rank
// is its place among its own row's survivors.
//
// Bound: bytes, and mostly the output. cand is k * (cap+1) * C int32 and
// is written whole, mostly with the ghost id n_total (on the patents-shaped
// graph 58% of the rows have no edge and root_ok holds on ~1 edge in 418);
// the edges cost their root_ok byte, a label where root_ok holds, and a dst
// id and binding word where a child's label matches.
//
// Work is split evenly in rows + edges, not in rows: a warp per row left
// most lanes idle (median degree 0) and one warp walking a 55,750-edge row
// long after the rest were done. Rows' ends and edges are merged into one
// sequence (Merrill & Garland's merge-path split of CSR: a row's end comes
// after its edges) and cut into tiles of kTile items. Two kernels:
//
//   plan_kernel, a warp per tile: the tile's bounds by a binary search of
//     indptr on its diagonal, and the survivor counts of the row still open
//     at the tile's end (its edges in this tile);
//   emit_kernel, a block per tile: it reads its edges coalesced, ranks
//     survivors by ballots and one prefix over the tile's 64 ballot words,
//     and writes the rows whose end lies in the tile: cand[c, r0:r1, :] as
//     one contiguous run per child (16-byte stores, fill and survivors
//     together) and their exact counts. A row that began in an earlier tile
//     (a long row spans many) takes the survivor counts of those tiles from
//     plan_kernel: integer sums, the same in any order, so ranks and counts
//     are exact and no race decides one. Each tile writes the survivors of
//     rank < C of its open row itself; the row's owner skips those slots.
//     A child with no survivor in the tile (most tiles: root_ok is sparse)
//     writes its counts and its fill without a sync or a shared-memory read.
//
// Both kernels read an edge in steps (every root_ok, then the labels where
// root_ok holds, ...), so each step's loads are in flight together.
//
// indptr must be non-decreasing (CSR); its values are clamped into [0, E].
// Scratch (the tile bounds and the open rows' counts) comes from the
// wrapper. The entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitset.cuh"

namespace {

constexpr int kMaxChildren = 16;
constexpr int kThreads = 256;                  // a block: 8 warps
constexpr int kPerThread = 8;                  // edges a thread holds in emit_kernel
constexpr int kTile = kThreads * kPerThread;   // rows + edges a tile owns
constexpr int kWords = kTile / 32;             // ballot words of a tile's edges
static_assert(kWords == 64, "emit_kernel's prefix gives each lane two ballot words");
constexpr unsigned kFull = 0xffffffffu;

struct Children {
    int k;
    int label[kMaxChildren];
    int bound[kMaxChildren];
};

struct Graph {
    const uint32_t* words_k;
    int n_words;
    const int32_t* dst;
    const int32_t* lab;
    const int32_t* indptr;
    const uint8_t* root_ok;
    long long E;
    int cap;

    // indptr[r] clamped into [0, E]: where row r starts and row r - 1 ends
    __device__ long long at(long long r) const {
        const long long v = indptr[r];
        return v < 0 ? 0 : (v > E ? E : v);
    }
};

// The children each of N edges base + u * stride (those below end) survives
// for (bit c for child c), and where any does, its dst id. Reads lazily, a
// step at a time so that each step's N loads are in flight together: every
// root_ok, the labels where root_ok holds, the dst ids where a child's
// label matches, the binding words of bound children.
template <int N>
__device__ __forceinline__ void survivors(const Graph& g, const Children& ch, long long base,
                                          int stride, long long end, uint32_t (&m)[N],
                                          int32_t (&d)[N]) {
    bool ok[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
        const long long e = base + (long long)u * stride;
        ok[u] = e < end && g.root_ok[e] != 0;
    }
    int l[N];
#pragma unroll
    for (int u = 0; u < N; ++u) l[u] = ok[u] ? g.lab[base + (long long)u * stride] : 0;
#pragma unroll
    for (int u = 0; u < N; ++u) {
        m[u] = 0u;
        d[u] = 0;
#pragma unroll
        for (int c = 0; c < kMaxChildren; ++c) {
            if (c >= ch.k) break;
            if (ok[u] && l[u] == ch.label[c]) m[u] |= 1u << c;
        }
    }
#pragma unroll
    for (int u = 0; u < N; ++u)
        if (m[u]) d[u] = g.dst[base + (long long)u * stride];
#pragma unroll
    for (int u = 0; u < N; ++u) {
        if (!m[u]) continue;
#pragma unroll
        for (int c = 0; c < kMaxChildren; ++c) {
            if (c >= ch.k) break;
            if (((m[u] >> c) & 1u) && ch.bound[c] &&
                !bit_test(g.words_k + (long long)c * g.n_words, g.n_words, d[u]))
                m[u] &= ~(1u << c);
        }
    }
}

// The point after d items of the merged sequence (rows 0..cap end, edges
// e_begin.. are consumed; at a tie a row's end comes first): the rows ended
// and the absolute index of the next edge. Sixteen lanes search together,
// sixteen probes a step (~6 steps of dependent loads, not ~22); the lanes of
// `group` must all call it with the same d.
__device__ void merge_path(const Graph& g, long long e_begin, long long n_edges, long long d,
                           unsigned group, int& row, long long& edge) {
    const int sub = threadIdx.x & 15;
    long long lo = d > n_edges ? d - n_edges : 0;
    long long hi = d < (long long)g.cap + 1 ? d : (long long)g.cap + 1;
    while (lo < hi) {  // the answer lies in [lo, hi]: the first row not ended
        const long long step = (hi - lo + 15) / 16;
        const long long x = lo + sub * step;
        const bool ended = x < hi && g.at(x + 1) - e_begin <= d - x - 1;
        const int n = __popc(__ballot_sync(group, ended));  // ended rows probed: a prefix
        if (n == 0) {
            hi = lo;
        } else {
            const long long next = lo + n * step;
            lo += (n - 1) * step + 1;
            if (next < hi) hi = next;
        }
    }
    row = (int)lo;
    edge = e_begin + d - lo;
}

__global__ void __launch_bounds__(kThreads)
plan_kernel(Graph g, Children ch, long long n_tiles, int32_t* __restrict__ tile_row,
            int32_t* __restrict__ tile_edge, int32_t* __restrict__ tail) {
    const int lane = threadIdx.x & 31;
    const long long t = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (t >= n_tiles) return;  // whole warps leave together
    const long long e_begin = g.at(0), e_last = g.at((long long)g.cap + 1);
    const long long n_edges = e_last > e_begin ? e_last - e_begin : 0;
    const long long total = (long long)g.cap + 1 + n_edges;
    long long d = (t + (lane >> 4)) * kTile;  // lanes 0-15: the tile's start, 16-31: its end
    if (d > total) d = total;
    int row;
    long long edge;
    merge_path(g, e_begin, n_edges, d, 0xffffu << (lane & 16), row, edge);
    const long long j0 = __shfl_sync(kFull, edge, 0);
    const int r1 = __shfl_sync(kFull, row, 16);
    const long long j1 = __shfl_sync(kFull, edge, 16);
    if (lane == 16) {
        tile_row[t + 1] = row;
        tile_edge[t + 1] = (int32_t)edge;
    }
    if (t == 0 && lane == 0) {
        tile_row[0] = row;
        tile_edge[0] = (int32_t)edge;
    }
    // row r1 is still open at the tile's end: its survivors among the tile's
    // edges, counted per lane and summed across the warp at the end
    int count[kMaxChildren];
#pragma unroll
    for (int c = 0; c < kMaxChildren; ++c) count[c] = 0;
    if (r1 <= g.cap) {
        long long lo = g.at(r1);
        if (lo < j0) lo = j0;
        for (long long base = lo + lane; base < j1; base += 32 * kPerThread) {
            uint32_t m[kPerThread];
            int32_t d_id[kPerThread];
            survivors<kPerThread>(g, ch, base, 32, j1, m, d_id);
#pragma unroll
            for (int u = 0; u < kPerThread; ++u) {
#pragma unroll
                for (int c = 0; c < kMaxChildren; ++c) count[c] += (m[u] >> c) & 1u;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < kMaxChildren; ++c) {
        if (c >= ch.k) break;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) count[c] += __shfl_xor_sync(kFull, count[c], o);
        if (lane == 0) tail[t * ch.k + c] = count[c];
    }
}

// cand[ga, gb), a run of the owned rows from row0 (C slots a row): slot p
// of the run's row i holds value(i, p). 16 bytes a store where aligned.
template <class F>
__device__ __forceinline__ void write_run(int32_t* cand, long long ga, long long gb,
                                          long long row0, int C, F value) {
    long long va = (ga + 3) & ~3LL, vb = gb & ~3LL;
    if (va > gb) va = gb;
    if (vb < va) vb = va;
    auto one = [&](long long x) {
        const unsigned rel = (unsigned)(x - row0);
        return value((int)(rel / C), (int)(rel % C));
    };
    for (long long x = ga + threadIdx.x; x < va; x += kThreads) cand[x] = one(x);
    for (long long x = va + 4LL * threadIdx.x; x < vb; x += 4LL * kThreads) {
        const unsigned rel = (unsigned)(x - row0);
        int i = rel / C, p = rel % C;
        int32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            v[u] = value(i, p);
            if (++p == C) {
                p = 0;
                ++i;
            }
        }
        *reinterpret_cast<int4*>(cand + x) = make_int4(v[0], v[1], v[2], v[3]);
    }
    for (long long x = vb + threadIdx.x; x < gb; x += kThreads) cand[x] = one(x);
}

__global__ void __launch_bounds__(kThreads, 3)
emit_kernel(Graph g, Children ch, int C, int n_total, const int32_t* __restrict__ tile_row,
            const int32_t* __restrict__ tile_edge, const int32_t* __restrict__ tail,
            int32_t* __restrict__ cand, int32_t* __restrict__ cnt) {
    __shared__ int32_t s_end[kTile];  // each owned row's end, as an edge of the tile
    __shared__ int32_t s_cum[kTile];  // one child's survivors in the tile before that end
    __shared__ int32_t s_sl[kTile];   // one child's survivors' dst ids, in edge order
    __shared__ int32_t s_dv[kTile];   // each edge's dst id, where it survives for a child
    __shared__ uint16_t s_msk[kTile]; // each edge's survivor mask
    __shared__ uint32_t s_bal[kMaxChildren][kWords + 1];
    __shared__ int32_t s_pre[kMaxChildren][kWords + 1];
    __shared__ int32_t s_carry[kMaxChildren];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long t = blockIdx.x;
    const int i0 = tile_row[t], i1 = tile_row[t + 1];
    const long long j0 = tile_edge[t], j1 = tile_edge[t + 1];
    if (i0 == i1 && j0 == j1) return;  // past the last item: the whole block leaves
    const int n_own = i1 - i0;         // rows whose end lies in the tile: i0 .. i1-1
    const int k = ch.k;
    const long long rows = (long long)g.cap + 1;

    // the tile's edges, coalesced: edge el = it * kThreads + tid is thread
    // tid's; its mask and id go to shared memory, so that no register holds
    // them past this point
    bool any;
    {
        uint32_t msk[kPerThread];
        int32_t dv[kPerThread];
        survivors<kPerThread>(g, ch, j0 + tid, kThreads, j1, msk, dv);
        uint32_t mine = 0u;
#pragma unroll
        for (int it = 0; it < kPerThread; ++it) {
            s_msk[it * kThreads + tid] = (uint16_t)msk[it];
            s_dv[it * kThreads + tid] = dv[it];
            mine |= msk[it];
        }
        if (tid < kMaxChildren) s_carry[tid] = 0;
        any = __syncthreads_or(mine != 0u);  // a survivor in the tile, any child
    }

    // row i0 began in an earlier tile: its survivors there, from every tile
    // since the one that holds its first edge (each of them has it open at
    // its end). Integer sums: the same in any order.
    const long long rs0 = g.at(i0);
    if (rs0 < j0) {
        const long long t0 = ((long long)i0 + (rs0 - g.at(0))) / kTile;
        for (long long x = t0 * k + tid; x < t * k; x += kThreads)
            atomicAdd(&s_carry[x % k], tail[x]);
    }
    if (any) {
        for (int i = tid; i < n_own; i += kThreads)
            s_end[i] = (int)(g.at((long long)i0 + i + 1) - j0);
#pragma unroll
        for (int it = 0; it < kPerThread; ++it) {
            const uint32_t m = s_msk[it * kThreads + tid];
            for (int c = 0; c < k; ++c) {
                const unsigned b = __ballot_sync(kFull, (m >> c) & 1u);
                if (lane == 0) s_bal[c][it * (kThreads / 32) + warp] = b;
            }
        }
    }
    __syncthreads();
    if (any) {
        // each child's exclusive prefix over its 64 ballot words: warp w
        // takes children w, w + 8
        for (int c = warp; c < k; c += kThreads / 32) {
            const int a = __popc(s_bal[c][2 * lane]), b = __popc(s_bal[c][2 * lane + 1]);
            int x = a + b;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, x, o);
                if (lane >= o) x += y;
            }
            s_pre[c][2 * lane] = x - a - b;
            s_pre[c][2 * lane + 1] = x - b;
            if (lane == 31) {
                s_pre[c][kWords] = x;
                s_bal[c][kWords] = 0u;
            }
        }
        __syncthreads();
    }

    // survivors of child c among the tile's first pos edges (0 <= pos <= kTile)
    auto before = [&](int c, int pos) {
        const int w = pos >> 5;
        return s_pre[c][w] + __popc(s_bal[c][w] & ((1u << (pos & 31)) - 1u));
    };
    for (int c = 0; c < k; ++c) {
        const int carry = s_carry[c];
        const long long base = (long long)c * rows * C;
        const long long row0 = base + (long long)i0 * C;
        const long long ga = row0 + (carry < C ? carry : C), gb = base + (long long)i1 * C;
        if (!any || s_pre[c][kWords] == 0) {
            // no survivor of child c in the tile (the common case: root_ok
            // is sparse): row i0 counts its carry, the others 0, and every
            // slot of this tile's is the ghost id. No sync: the branch is
            // the whole block's.
            for (int i = tid; i < n_own; i += kThreads)
                if ((long long)i0 + i < g.cap) cnt[(long long)c * g.cap + i0 + i] = i ? 0 : carry;
            write_run(cand, ga, gb, row0, C, [&](int, int) { return n_total; });
            continue;
        }
        const int ts = n_own ? s_end[n_own - 1] : 0;  // the open row i1's first edge here
        // a survivor of the open row has rank before(c, el) - t_base; the
        // open row is row i0 itself (with its carry) when the tile owns no row
        const int t_base = before(c, ts) - (n_own ? 0 : carry);
        for (int el = tid; el < kTile; el += kThreads) {
            if (!((s_msk[el] >> c) & 1u)) continue;
            const int x = before(c, el);
            if (el >= ts) {
                const int rank = x - t_base;
                if (rank < C) cand[base + (long long)i1 * C + rank] = s_dv[el];
            } else {
                s_sl[x] = s_dv[el];
            }
        }
        for (int i = tid; i < n_own; i += kThreads) s_cum[i] = before(c, s_end[i]);
        __syncthreads();
        // exact counts of the owned rows (the ghost row cap has none)
        for (int i = tid; i < n_own; i += kThreads) {
            const long long r = (long long)i0 + i;
            if (r < g.cap) cnt[(long long)c * g.cap + r] = s_cum[i] - (i ? s_cum[i - 1] : -carry);
        }
        // slot p of owned row i holds its survivor of rank p (row i0's first
        // `carry` ranks lie in earlier tiles, which wrote those below C)
        auto pick = [&](int i, int p) -> int32_t {
            const int beg = i ? s_cum[i - 1] : 0;
            const int q = p - (i ? 0 : carry);
            return q < s_cum[i] - beg ? s_sl[beg + q] : n_total;
        };
        write_run(cand, ga, gb, row0, C, pick);
        __syncthreads();  // s_sl and s_cum are the next child's
    }
}

}  // namespace

extern "C" int stwig_expand(const void* words_k, int n_words, const void* dst,
                            const void* lab, const void* indptr, const void* root_ok,
                            long long E, int k, const int* child_labels,
                            const int* child_bound, int C, int cap, int n_total,
                            void* cand, void* cnt, void* plan, long long n_tiles, void* tail,
                            void* stream) {
    if (k < 1 || k > kMaxChildren || C < 0 || C > (1 << 20) ||
        n_tiles != ((long long)cap + 1 + E + kTile - 1) / kTile)
        return (int)cudaErrorInvalidValue;
    Children ch;
    ch.k = k;
    for (int c = 0; c < kMaxChildren; ++c) {
        ch.label[c] = c < k ? child_labels[c] : -1;
        ch.bound[c] = c < k ? child_bound[c] : 0;
    }
    const Graph g{(const uint32_t*)words_k, n_words, (const int32_t*)dst, (const int32_t*)lab,
                  (const int32_t*)indptr, (const uint8_t*)root_ok, E, cap};
    int32_t* tile_row = (int32_t*)plan;
    int32_t* tile_edge = tile_row + n_tiles + 1;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned plan_blocks = (unsigned)((n_tiles + kThreads / 32 - 1) / (kThreads / 32));
    plan_kernel<<<plan_blocks, kThreads, 0, s>>>(g, ch, n_tiles, tile_row, tile_edge,
                                                 (int32_t*)tail);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    emit_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(g, ch, C, n_total, tile_row, tile_edge,
                                                       (const int32_t*)tail, (int32_t*)cand,
                                                       (int32_t*)cnt);
    return (int)cudaGetLastError();
}
