// Causal GQA flash attention (forward), float32, for Hopper (sm_90a): P.V
// on the tensor cores in split TF32 (TF32 wgmma, three products a term),
// Q.K^T in fp32 FMAs on the CUDA cores in a warpgroup of its own, with TMA
// copies of every tile.
//
// Replaces flash_attention / _attn_kernel of
// src/repro/extras/flash_attention/flash_attention.py for float32 inputs
// whose shapes TMA can describe (the wrapper's rule: H and Hv multiples of
// 4, so that a row is whole 16-byte units, at most 256, at most 64 query
// heads a kv head); flash_attention_tc.cu takes bfloat16 of such shapes and
// flash_attention.cu's FMA kernel every other shape. What it computes is
// the FMA kernel's function: logits in fp32, scaled, tanh(x/c)*c with a
// softcap, the causal/window mask as -1e30, an online softmax with m
// started at -1e30 (a row whose first tiles are wholly masked sums exp(0)
// garbage until its first kept key, where corr = 0 wipes it), and
// acc / max(l, 1e-30), in the layout (B, S, Nq, H) with no transposes.
//
// Bound: operations. Q.K^T and P.V over the kept pairs are 2*(H + Hv)
// operations a pair, against 4*(H + Hv) bytes a row: at gemma-2b's served
// shape 5.5e11 operations, 1.11 ms at the 495 TFLOP/s of TF32 wgmma (3.33
// ms for split TF32's three products a term; 8.21 ms on fp32 CUDA cores).
// This design's own floor is higher: Q.K^T's half of the operations at the
// fp32 rate alone is 4.10 ms.
//
// Why Q.K^T is not on the tensor cores. The fp32 model is held layer by
// layer to the plain version (chip_smoke.py [lm]: 1e-4 of each row's max),
// and its random init makes logits of scale ~720 whose fp32 sums round by
// ~1e-3: there attention computed exactly (in float64) already lies 2.3e-4
// from the plain version at the first layer, and a split-TF32 Q.K^T (3
// products a term, the sum cut in 32-dim pieces; within 2e-5 of a row's
// max on N(0,1) inputs) failed that check on an H100 at layer 0.
// Only logits summed as the plain version sums them, one fp32 FMA a head dim
// in order h = 0, 1, ..., hold it; so Q.K^T is exactly the FMA kernel's sum
// (its logits bit for bit), and split TF32 stays where the rounding of the
// sum is benign: P.V, P in [0, 1].
//
// Design.
// - Warp roles, 256 threads (up to 255 registers a thread; no setmaxnreg),
//   each block 64 packed rows of one (batch, kv head): P = 64 / G positions
//   x the G query heads of the group, position-major, as
//   flash_attention_tc.cu. Warps 4-7, the Q.K^T group, copy Q (one TMA box
//   a 32 columns) and the K boxes of each tile (64 keys x 32 columns, the
//   128-byte swizzle) into a ring, and sum each tile's logits: a thread owns
//   4 rows x 8 keys in registers, each 16-byte Q chunk read serving 8 keys
//   and each K chunk 4 rows, 4 FMAs a chunk in h order. A tile's 64 x 64
//   logits go to the P.V group through one of two exchange buffers (rows 72
//   floats apart: the stores and the P.V group's float2 loads hit distinct
//   banks). Warps 0-3, the P.V group, copy the V boxes into a ring of their
//   own, and run the softmax, V's split and P.V.
// - Split TF32, as cin.cu does it: P and V are split into hi = x with the
//   low 13 mantissa bits cleared (a TF32 value) and lo = x - hi (exact in
//   fp32; the tensor core reads its top 10 mantissa bits), and a term is
//   lo*hi + hi*lo + hi*hi, in that order, summed in fp32. P is never rounded
//   to TF32 alone.
// - Short tensor-core sums. The tensor core truncates its fp32 sums, so each
//   tile's P.V for 32 columns (64 keys, 24 products) goes to a fresh
//   accumulator and is added to O with a rounded FMA that also applies the
//   softmax's rescale: O = O * corr + P.V.
// - V's split: a V box lands raw (64 keys x 32 columns, row-major) and the
//   P.V group transposes it over itself into hi and lo (each thread reads its
//   items, a named barrier, then the writes): TF32 wgmma reads a
//   shared-memory operand only K-major, and a V box's keys are its rows.
// - The softmax on the logits in registers (2 rows x 16 keys a thread, the
//   wgmma accumulator's layout, row max and sum over the quad by shuffles),
//   with the FMA kernel's arithmetic: x = s * scale, tanhf(x / c) * c with a
//   softcap, expf; the mask only on tiles that cut the diagonal or the
//   window's edge.
// - P.V: wgmma m64n32k8 for each 32 columns of Hv, A = P's hi and lo in
//   registers, B = the V box's parts (no swizzle: core matrices of 8
//   columns x 4 keys). A thread's accumulator holds keys 2t and 2t + 1 of
//   each 8-key step, and the TF32 A fragment takes keys t and t + 4, so the
//   transposed V box holds each 8-key step's keys in the order
//   0 2 4 6 1 3 5 7: the sum over keys does not care, and no register moves.
// - Shared memory at HD 256: Q 64 KB, the exchange 36 KB, 5 K slots of
//   8 KB, 5 V slots of 16 KB (raw, then hi and lo): 220 KB.
// - Tiles wholly above the diagonal or outside the window are skipped, and
//   the blocks of the last positions (the most tiles) run first.
// Q.K^T's FMAs set the pace (a tile's 2^20 FMAs are 8,192 clocks of the
// SM's 128 fp32 lanes; the P.V group's tile is about half that). Tried on
// an H100 and not kept: Q.K^T in split TF32 on the tensor cores (faster,
// but the layer check failed, as above); the FMAs in the P.V group itself
// (slower); a thread's logits as 2 rows x 16 keys, in the accumulator's
// layout (slower); two Q.K^T groups of 128 registers a thread beside a P.V
// group of 248 (no faster).
//
// The entry point returns cudaGetLastError() after its launch, the error
// of raising the shared-memory limit, -1 when the driver has no
// cuTensorMapEncodeTiled, or -2 when it refuses a descriptor.

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;         // the P.V warpgroup, then the Q.K^T warpgroup
constexpr int kGroup = 128;           // threads of a warpgroup
constexpr int kRows = 64;             // packed rows of the block
constexpr int kKeys = 64;             // keys of a tile
constexpr int kBoxCols = 32;          // fp32 columns of a box: 128 bytes
constexpr int kBoxBytes = 64 * 128;   // a box of 64 rows or keys
constexpr int kBoxVecs = kBoxBytes / 16;
constexpr int kItems = kBoxVecs / kGroup;  // 16-byte items of a V box a thread splits
// floats a row of the logits' exchange buffer: 8 (mod 32), so that the Q.K^T
// group's stores and the P.V group's float2 loads touch distinct banks
constexpr int kSRow = kKeys + 8;
constexpr uint32_t kHiMask = 0xffffe000u;  // a TF32 value's bits
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {  // byte offsets from a 1024-aligned base
    static constexpr int kBoxes = HD / kBoxCols;  // boxes of a row of Q
    static constexpr int kKSlots = HD == 256 ? 5 : HD == 128 ? 7 : 9;
    static constexpr int kVSlots = HD == 256 ? 5 : 6;
    static constexpr int q = 0;                   // [kBoxes] boxes, 128-byte swizzle
    static constexpr int s = q + kBoxes * kBoxBytes;           // [2][64 rows][kSRow]
    static constexpr int k = s + 2 * kRows * kSRow * 4;        // [kKSlots] K boxes
    static constexpr int v = k + kKSlots * kBoxBytes;          // [kVSlots][raw or hi, lo]
    static constexpr int k_loaded = v + kVSlots * 2 * kBoxBytes;  // barriers
    static constexpr int v_loaded = k_loaded + 8 * kKSlots;
    static constexpr int s_full = v_loaded + 8 * kVSlots;
    static constexpr int s_empty = s_full + 16;
    static constexpr int qbar = s_empty + 16;
    static constexpr int bytes = qbar + 8 + 1024;  // + alignment slack
    static_assert(bytes <= 232448, "over the 227 KB a block may have");
};

__device__ __forceinline__ float hi_of(float x) {
    return __uint_as_float(__float_as_uint(x) & kHiMask);
}
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
    hi = make_float4(hi_of(x.x), hi_of(x.y), hi_of(x.z), hi_of(x.w));
    lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// D (64 rows x 32 columns, fp32) (+)= A (64 x 8 keys, tf32, registers)
// B (8 keys x 32, tf32, K-major in shared memory).
__device__ __forceinline__ void wgmma_o(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                        int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, float* __restrict__ out,
                            int S, int Nq, int Nkv, int H, int Hv, float scale, int window,
                            float softcap, int n_qtiles) {
    using L = Smem<HD>;
    constexpr int kKSlots = L::kKSlots, kVSlots = L::kVSlots;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t base = (raw_addr + 1023u) & ~1023u;
    uint8_t* const gbase = smem_raw + (base - raw_addr);  // the same bytes, as a generic pointer
    const uint32_t k_loaded0 = base + L::k_loaded, v_loaded0 = base + L::v_loaded;
    const uint32_t s_full0 = base + L::s_full, s_empty0 = base + L::s_empty, qbar = base + L::qbar;

    const int G = Nq / Nkv;
    const int P = kRows / G;                                 // positions of the block
    const int n_bh = gridDim.x / n_qtiles;
    const int bh = blockIdx.x % n_bh;                        // (batch, kv head)
    const int qt = n_qtiles - 1 - (int)(blockIdx.x / n_bh);  // heaviest tiles first
    const int b = bh / Nkv;
    const int kvh = bh - b * Nkv;
    const int s0 = qt * P;
    const int s_hi = min(S - 1, s0 + P - 1);
    const int j_lo = window > 0 ? max(0, s0 - window + 1) : 0;
    const int kt_lo = j_lo / kKeys;
    const int n_tiles = s_hi / kKeys - kt_lo + 1;
    const int nqb = (H + kBoxCols - 1) / kBoxCols;   // K boxes of a tile
    const int nvb = (Hv + kBoxCols - 1) / kBoxCols;  // V boxes of a tile

    if (threadIdx.x == 0) {
        for (int i = 0; i < kKSlots; ++i) mbar_init(k_loaded0 + 8 * i, 1);
        for (int i = 0; i < kVSlots; ++i) mbar_init(v_loaded0 + 8 * i, 1);
        for (int i = 0; i < 2; ++i) {
            mbar_init(s_full0 + 8 * i, kGroup);
            mbar_init(s_empty0 + 8 * i, kGroup);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    // Both warpgroups give a thread the same rows and keys: t's warp w and
    // lane own rows w*16 + lane/4 (+ 8) of the block's 64 and keys
    // 8j + 2(lane % 4) (+ 1) of a tile, the wgmma accumulator's layout;
    // s[4j + 2r + e] is row r, key 8j + quad_col + e.
    const int t = threadIdx.x % kGroup;
    const int warp = t / 32, lane = t % 32;
    const int quad_row = lane / 4, quad_col = 2 * (lane % 4);
    const int row0 = warp * 16 + quad_row;
    float* const s_buf = reinterpret_cast<float*>(gbase + L::s);  // [2][64][kSRow]

    if (threadIdx.x >= kGroup) {
        // ---- Q.K^T warpgroup: fp32 FMAs, h = 0, 1, ... in order ---------------
        // Q (once) and the K boxes of each tile through TMA into a ring of
        // kKSlots; thread 0 of the group copies a box into a slot once the
        // whole group is done with the box before it there.
        const int n_k = n_tiles * nqb;
        auto copy_k = [&](int u) {
            const int st = u % kKSlots;
            mbar_expect_tx(k_loaded0 + 8 * st, kBoxBytes);
            tma_4d(base + L::k + st * kBoxBytes, &tm_k, k_loaded0 + 8 * st,
                   (u % nqb) * kBoxCols, kvh, (kt_lo + u / nqb) * kKeys, b);
        };
        if (t == 0) {
            mbar_expect_tx(qbar, nqb * G * P * 128);
            for (int c = 0; c < nqb; ++c)
                tma_5d(base + L::q + c * kBoxBytes, &tm_q, qbar, c * kBoxCols, 0, kvh, s0, b);
            for (int u = 0; u < min(kKSlots, n_k); ++u) copy_k(u);
        }
        // A thread's logits here: rows w*16 + lr + 4i (i < 4) and keys lk + 8j
        // (j < 8), lane = 8 lr + lk: 4 x 8 in registers, each Q chunk read
        // serving 8 keys and each K chunk 4 rows. 128-byte rows as TMA's
        // swizzle lays them out: 16-byte chunk ch of row r at chunk
        // ch ^ (r % 8).
        const int lr = lane / 8, lk = lane % 8;
        const float* q_base = reinterpret_cast<const float*>(gbase + L::q);
        mbar_wait(qbar, 0);
        for (int i = 0; i < n_tiles; ++i) {
            float acc[4][8];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
#pragma unroll 1
            for (int c = 0; c < nqb; ++c) {
                const int u = i * nqb + c, st = u % kKSlots;
                const float* kb = reinterpret_cast<const float*>(gbase + L::k + st * kBoxBytes);
                const float* qb = q_base + c * (kBoxBytes / 4);
                mbar_wait(k_loaded0 + 8 * st, (u / kKSlots) & 1);
#pragma unroll
                for (int ch = 0; ch < kBoxCols / 4; ++ch) {
                    if (c * kBoxCols + 4 * ch < H) {
                        float4 qv[4], kv[8];
#pragma unroll
                        for (int a = 0; a < 4; ++a) {
                            const int r = warp * 16 + lr + 4 * a;
                            qv[a] = *reinterpret_cast<const float4*>(qb + r * kBoxCols +
                                                                     4 * (ch ^ (r % 8)));
                        }
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            kv[j] = *reinterpret_cast<const float4*>(kb + (lk + 8 * j) * kBoxCols +
                                                                     4 * (ch ^ lk));
#pragma unroll
                        for (int a = 0; a < 4; ++a)
#pragma unroll
                            for (int j = 0; j < 8; ++j) {
                                float& z = acc[a][j];
                                z = fmaf(qv[a].x, kv[j].x, z);
                                z = fmaf(qv[a].y, kv[j].y, z);
                                z = fmaf(qv[a].z, kv[j].z, z);
                                z = fmaf(qv[a].w, kv[j].w, z);
                            }
                    }
                }
                asm volatile("bar.sync 2, %0;" ::"n"(kGroup) : "memory");  // the box is read
                if (t == 0 && u + kKSlots < n_k) copy_k(u + kKSlots);
            }
            // the tile's logits to the P.V group, as a (64 rows, 64 keys) array
            float* dst = s_buf + (i % 2) * kRows * kSRow;
            mbar_wait(s_empty0 + 8 * (i % 2), ((i / 2) & 1) ^ 1);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    dst[(warp * 16 + lr + 4 * a) * kSRow + lk + 8 * j] = acc[a][j];
            mbar_arrive(s_full0 + 8 * (i % 2));
        }
        return;
    }

    // ---- P.V warpgroup: the softmax, V's split, P.V on the tensor cores -------
    // The V boxes of each tile through TMA into a ring of kVSlots; thread 0
    // copies a box into a slot once the group is done with the box before it.
    const int n_v = n_tiles * nvb;
    auto copy_v = [&](int u) {
        const int st = u % kVSlots;
        mbar_expect_tx(v_loaded0 + 8 * st, kBoxBytes);
        tma_4d(base + L::v + st * 2 * kBoxBytes, &tm_v, v_loaded0 + 8 * st,
               (u % nvb) * kBoxCols, kvh, (kt_lo + u / nvb) * kKeys, b);
    };
    if (t == 0)
        for (int u = 0; u < min(kVSlots, n_v); ++u) copy_v(u);
    int row[2], pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        row[r] = row0 + 8 * r;
        pos[r] = row[r] < P * G ? s0 + row[r] / G : -1;  // -1: masked, not stored
    }
    const bool rows_full = P * G == kRows;  // no masked-out rows past P * G

    float o[HD / 2];  // o[16c + 4j + e]: row r = e / 2, column 32c + 8j + quad_col + e % 2
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};

    for (int i = 0; i < n_tiles; ++i) {
        const int key0 = (kt_lo + i) * kKeys;
        float s[32];  // s[4j + 2r + e]: row row0 + 8r, key 8j + quad_col + e
        {
            const float* src = s_buf + (i % 2) * kRows * kSRow + row0 * kSRow + quad_col;
            mbar_wait(s_full0 + 8 * (i % 2), (i / 2) & 1);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const float2 x = *reinterpret_cast<const float2*>(src + 8 * r * kSRow + 8 * j);
                    s[4 * j + 2 * r] = x.x;
                    s[4 * j + 2 * r + 1] = x.y;
                }
            mbar_arrive(s_empty0 + 8 * (i % 2));
        }

        // ---- scale, softcap, mask; the online softmax ------------------------
        // A tile whose keys every row of the block keeps skips the mask.
        const bool whole = rows_full && key0 + kKeys - 1 <= s0 &&
                           (window <= 0 || key0 > s0 + P - 1 - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int r = (j / 2) % 2;
            float x = s[j] * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            if (!whole) {
                const int key = key0 + (j / 4) * 8 + quad_col + (j % 2);
                const bool ok = key <= pos[r] && (window <= 0 || key > pos[r] - window);
                x = ok ? x : kNegInf;
            }
            s[j] = x;
            mx[r] = fmaxf(mx[r], x);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            corr[r] = expf(m_run[r] - m_new);
            m_run[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int r = (j / 2) % 2;
            s[j] = expf(s[j] - m_run[r]);
            sum[r] += s[j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];
        // P's parts as the A fragments of 8-key steps: (row, k t) is key 2t and
        // (row, k t + 4) key 2t + 1, the V box's order
        uint32_t ah[8][4], al[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = s[4 * kk + (e % 2) * 2 + e / 2];  // 4kk, 4kk+2, 4kk+1, 4kk+3
                const float h = hi_of(x);
                ah[kk][e] = __float_as_uint(h);
                al[kk][e] = __float_as_uint(x - h);
            }
        }

        // ---- O = O * corr + P V, 32 columns at a time ------------------------
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
            if (c < nvb) {
                const int u = i * nvb + c, st = u % kVSlots;
                float* hi = reinterpret_cast<float*>(gbase + L::v + st * 2 * kBoxBytes);
                float* lo = hi + kBoxBytes / 4;
                // V (64 keys x 32 columns, row-major, landed in hi) transposed
                // into hi and lo over itself: item (n, h, s) takes keys
                // 8s + h + 2i (i = 0..3) of column n to k positions 4h + i of
                // step s, one core-matrix row of 16 bytes (a step is 4 groups
                // of 8 columns x 2 halves of 4 keys x 32 floats). Every thread
                // reads its items before any writes over the box.
                float4 x[kItems];
                mbar_wait(v_loaded0 + 8 * st, (u / kVSlots) & 1);
#pragma unroll
                for (int k = 0; k < kItems; ++k) {
                    const int it = t + k * kGroup;
                    const int n = it % kBoxCols, h = (it / kBoxCols) % 2, sp = it / (2 * kBoxCols);
                    const float* src = hi + (8 * sp + h) * kBoxCols + n;
                    x[k] = make_float4(src[0], src[2 * kBoxCols], src[4 * kBoxCols],
                                       src[6 * kBoxCols]);
                }
                asm volatile("bar.sync 1, %0;" ::"n"(kGroup) : "memory");
#pragma unroll
                for (int k = 0; k < kItems; ++k) {
                    const int it = t + k * kGroup;
                    const int n = it % kBoxCols, h = (it / kBoxCols) % 2, sp = it / (2 * kBoxCols);
                    const int off = ((sp * 4 + n / 8) * 2 + h) * 32 + (n % 8) * 4;
                    float4 vh, vl;
                    split4(x[k], vh, vl);
                    *reinterpret_cast<float4*>(hi + off) = vh;
                    *reinterpret_cast<float4*>(lo + off) = vl;
                }
                fence_async_smem();  // the parts, for the wgmmas' reads
                asm volatile("bar.sync 1, %0;" ::"n"(kGroup) : "memory");

                const uint32_t v_hi = base + L::v + st * 2 * kBoxBytes, v_lo = v_hi + kBoxBytes;
                float f[16];
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    const uint32_t vo = kk * 1024;  // an 8-key step of 32 columns
                    wgmma_o(f, al[kk], desc_plain(v_hi + vo, 128, 256), kk > 0);
                    wgmma_o(f, ah[kk], desc_plain(v_lo + vo, 128, 256), 1);
                    wgmma_o(f, ah[kk], desc_plain(v_hi + vo, 128, 256), 1);
                }
                wg_commit();
                wg_wait_all();
                fence_regs(f);
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    o[16 * c + j] = fmaf(o[16 * c + j], corr[(j / 2) % 2], f[j]);
                asm volatile("bar.sync 1, %0;" ::"n"(kGroup) : "memory");  // the slot is read
                if (t == 0 && u + kVSlots < n_v) copy_v(u + kVSlots);
            }
        }
    }

    // ---- out = O / max(l, 1e-30) ------------------------------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (pos[r] < 0 || pos[r] >= S) continue;
        const int g = row[r] % G;
        float* dst = out + (((long long)b * S + pos[r]) * Nq + (long long)kvh * G + g) * Hv + quad_col;
        const float denom = fmaxf(l_part[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            if (8 * j + quad_col < Hv)  // Hv is a multiple of 4: a pair never straddles it
                *reinterpret_cast<float2*>(dst + 8 * j) =
                    make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
        }
    }
}

template <int HD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int B,
           int S, int Nq, int Nkv, int H, int Hv, float scale, int window, float softcap,
           cudaStream_t stream) {
    constexpr int bytes = Smem<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_tf32_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int P = kRows / (Nq / Nkv);
    const int n_qtiles = (S + P - 1) / P;
    const unsigned blocks = (unsigned)((long long)n_qtiles * B * Nkv);
    flash_attention_tf32_kernel<HD><<<blocks, kThreads, bytes, stream>>>(
        mq, mk, mv, (float*)out, S, Nq, Nkv, H, Hv, scale, window, softcap, n_qtiles);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out contiguous float32, 16-byte aligned; H, Hv multiples of 4 and
// at most 256; Nq % Nkv == 0 and Nq / Nkv <= 64 (the wrapper checks);
// window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_tf32(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int Nq, int Nkv, int H, int Hv, float scale,
                                    int window, float softcap, void* stream) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    const int G = Nq / Nkv, P = kRows / G;
    const cuuint64_t e = 4;  // bytes of a float
    const auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap mq, mk, mv;
    {  // q as (H, G, Nkv, S, B); a box is the 32 columns of P positions x G heads
        const cuuint64_t dims[5] = {(cuuint64_t)H, (cuuint64_t)G, (cuuint64_t)Nkv, (cuuint64_t)S,
                                    (cuuint64_t)B};
        const cuuint64_t strides[4] = {e * H, e * H * G, e * H * Nq, e * H * Nq * S};
        const cuuint32_t box[5] = {kBoxCols, (cuuint32_t)G, 1, (cuuint32_t)P, 1};
        if (!make_map(&mq, encode, kF32, CU_TENSOR_MAP_SWIZZLE_128B, q, 5, dims, strides, box))
            return -2;
    }
    {  // k, v as (H, Nkv, S, B); a box is the 32 columns of 64 keys (v unswizzled)
        const cuuint32_t box[4] = {kBoxCols, 1, kKeys, 1};
        const cuuint64_t kdims[4] = {(cuuint64_t)H, (cuuint64_t)Nkv, (cuuint64_t)S, (cuuint64_t)B};
        const cuuint64_t kstr[3] = {e * H, e * H * Nkv, e * H * Nkv * S};
        const cuuint64_t vdims[4] = {(cuuint64_t)Hv, (cuuint64_t)Nkv, (cuuint64_t)S, (cuuint64_t)B};
        const cuuint64_t vstr[3] = {e * Hv, e * Hv * Nkv, e * Hv * Nkv * S};
        if (!make_map(&mk, encode, kF32, CU_TENSOR_MAP_SWIZZLE_128B, k, 4, kdims, kstr, box) ||
            !make_map(&mv, encode, kF32, CU_TENSOR_MAP_SWIZZLE_NONE, v, 4, vdims, vstr, box))
            return -2;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = H > Hv ? H : Hv;
    if (hd <= 64)
        return launch<64>(mq, mk, mv, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, st);
    if (hd <= 128)
        return launch<128>(mq, mk, mv, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, st);
    return launch<256>(mq, mk, mv, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, st);
}
