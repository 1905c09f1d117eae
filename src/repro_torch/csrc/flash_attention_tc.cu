// Causal GQA flash attention (forward), bf16, on Hopper's tensor cores
// (sm_90a): wgmma for both products, TMA for every tile, and
// two consumer warpgroups handing tiles over through mbarriers.
//
// Replaces flash_attention / _attn_kernel of
// src/repro/extras/flash_attention/flash_attention.py for bfloat16 inputs
// whose shapes TMA can describe (the wrapper's rule: H and Hv multiples of 8,
// at most 256, at most 64 query heads a kv head); flash_attention_tf32.cu
// takes float32 of such shapes (H and Hv multiples of 4), and
// flash_attention.cu's fp32 FMA kernel every other shape. What it computes
// is the FMA kernel's function: logits in fp32, scaled, tanh(l/c)*c with a
// softcap, the causal/window mask as -1e30, an online softmax with m
// started at -1e30 (a row whose first tiles are wholly masked sums exp(0)
// garbage until its first kept key, where corr = 0 wipes it), and
// acc / max(l, 1e-30) in bf16, in the layout (B, S, Nq, H) with no
// transposes.
//
// Bound: operations. Q.K^T and P.V over the kept pairs are 2*(H + Hv)
// operations a pair, against 2*(H + Hv) bytes a row: at gemma-2b's served
// shape 5.5e11 operations, 0.556 ms at the 989 TFLOP/s of bf16 wgmma.
//
// Design.
// - Packed rows. A consumer warpgroup owns 64 rows of one (batch, kv head):
//   P = 64 / G positions x the G query heads of the group, position-major
//   (with gemma's MQA 8 positions x 8 heads), so every K/V tile serves all
//   G heads. For one (b, kv head) those rows are a box (H, G, 1, P, 1) of
//   the 5-D view (H, G, Nkv, S, B) of q, so one TMA copy per 64 columns
//   loads them; G * P < 64 (G = 3) leaves rows that are masked and never
//   stored. A block is 2 consumer warpgroups (2P positions) + 1 producer
//   warpgroup: 384 threads, 1 block an SM (192 KB of shared memory at HD
//   256).
// - Tiles. Every tile is a TMA box of 64 bf16 columns (one 128-byte row)
//   and 64 rows, stored with the 128-byte swizzle that the wgmma
//   descriptors name; H or Hv under a multiple of 64, and keys past S, are
//   zero-filled by TMA's out-of-bounds fill, which also pads head dims to
//   wgmma's depth of 16. The producer keeps two stages of K and V tiles (64
//   keys) in flight: it waits on a stage's "empty" barrier (all 256
//   consumer threads arrive after their P.V), then arms its "full" barrier
//   with the stage's byte count and issues the copies. (Separate K and V
//   barriers, K freed once S is done, ran slower on an H100.)
// - S = Q.K^T: wgmma m64n64k16, A = the warpgroup's Q rows, B = the K tile,
//   both K-major from shared memory, fp32 accumulate; bf16 x bf16 products
//   are exact in fp32, so the logits are the JAX kernel's up to summation
//   order.
// - The softmax on the accumulator in registers: each thread holds 2 rows x
//   16 keys; row max and sum over the quad by shuffles; m, l in registers;
//   in base 2 (logits times log2 e, one ex2 a key); the mask only on tiles
//   that cut the diagonal or the window's edge, O rescaled only when some
//   row of the warp has a new max.
// - O += P.V: P rounded to bf16 in registers is wgmma's register A operand
//   (the m64nNk16 accumulator's layout for 16 keys is the A fragment's, so
//   no data moves); B = the V tile, MN-major (transposed) from shared
//   memory; O (64 x HD fp32) stays in registers, HD/2 a thread. Rounding P
//   to bf16 is the only rounding the JAX kernel does not do.
// - Tiles wholly above the diagonal or outside the window are skipped, and
//   the blocks of the last positions (the most tiles) run first.
// - Registers: a warp's registers come from one of the SM's four 16K
//   files, so 384 threads start at 168 each, too few for O (128), S (32)
//   and P (16) a thread. The producer warpgroup gives its registers back
//   (setmaxnreg 24) and the consumers take them (setmaxnreg 240): 24 + 2 x
//   240 warps' worth fill a file. (288 threads, a producer warp alone,
//   would start at 168 too: three of its nine warps share a file.)
// The two warpgroups overlap each other's softmax and products only as the
// warp schedulers interleave them. Left for later: overlap within a
// warpgroup (S of the next tile issued with P.V, as FlashAttention-3 does;
// a first try here made ptxas serialize the wgmmas, C7514), ordering the
// warpgroups against each other (ping-pong), and TMA stores of the output.
//
// The mbarrier, TMA, wgmma-descriptor, setmaxnreg and tensor-map pieces are
// hopper.cuh's, shared with flash_attention_tf32.cu.
//
// The entry point returns cudaGetLastError() after its launch, the error
// of raising the shared-memory limit, -1 when the driver has no
// cuTensorMapEncodeTiled, or -2 when it refuses a descriptor.

#include <cstdint>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kRows = 64;                        // packed rows of a warpgroup
constexpr int kKeys = 64;                        // keys of a K/V tile
constexpr int kStages = 2;
constexpr int kBoxCols = 64;                     // bf16 columns of a box: 128 bytes
constexpr int kBoxBytes = 64 * 128;              // a box of 64 rows
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {  // byte offsets from a 1024-aligned base; boxes [.][HD / 64][64 rows][128 B]
    static constexpr int kBoxes = HD / kBoxCols;
    static constexpr int q = 0;
    static constexpr int k = q + kConsumers * kBoxes * kBoxBytes;
    static constexpr int v = k + kStages * kBoxes * kBoxBytes;
    static constexpr int full = v + kStages * kBoxes * kBoxBytes;  // kStages barriers
    static constexpr int empty = full + 8 * kStages;
    static constexpr int qbar = empty + 8 * kStages;
    static constexpr int bytes = qbar + 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-1e30 = +0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&p);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                          int S, int Nq, int Nkv, int H, int Hv, float scale, int window,
                          float softcap, int n_qtiles) {
    using L = Smem<HD>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    const uint32_t full0 = base + L::full, empty0 = base + L::empty, qbar = base + L::qbar;

    const int G = Nq / Nkv;
    const int P = kRows / G;                                  // positions a warpgroup
    const int n_bh = gridDim.x / n_qtiles;
    const int bh = blockIdx.x % n_bh;                         // (batch, kv head)
    const int qt = n_qtiles - 1 - (int)(blockIdx.x / n_bh);   // heaviest tiles first
    const int b = bh / Nkv;
    const int kvh = bh - b * Nkv;
    const int s0 = qt * kConsumers * P;
    const int s_hi = min(S - 1, s0 + kConsumers * P - 1);
    const int j_lo = window > 0 ? max(0, s0 - window + 1) : 0;
    const int kt_lo = j_lo / kKeys;
    const int n_tiles = s_hi / kKeys - kt_lo + 1;
    const int nqb = (H + kBoxCols - 1) / kBoxCols;   // boxes of a Q or K row
    const int nvb = (Hv + kBoxCols - 1) / kBoxCols;  // boxes of a V row

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 128 * kConsumers);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= 128 * kConsumers) {
        // ---- producer warpgroup: one thread issues every copy ---------------
        setmaxnreg_dec<24>();
        if (threadIdx.x != 128 * kConsumers) return;
        mbar_expect_tx(qbar, kConsumers * nqb * kBoxCols * G * P * 2);
        for (int w = 0; w < kConsumers; ++w)
            for (int c = 0; c < nqb; ++c)
                tma_5d(base + L::q + (w * L::kBoxes + c) * kBoxBytes, &tm_q, qbar, c * kBoxCols, 0,
                       kvh, s0 + w * P, b);
        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % kStages;
            mbar_wait(empty0 + 8 * st, ((i / kStages) & 1) ^ 1);
            mbar_expect_tx(full0 + 8 * st, (nqb + nvb) * kBoxBytes);
            const int key0 = (kt_lo + i) * kKeys;
            for (int c = 0; c < nqb; ++c)
                tma_4d(base + L::k + (st * L::kBoxes + c) * kBoxBytes, &tm_k, full0 + 8 * st,
                       c * kBoxCols, kvh, key0, b);
            for (int c = 0; c < nvb; ++c)
                tma_4d(base + L::v + (st * L::kBoxes + c) * kBoxBytes, &tm_v, full0 + 8 * st,
                       c * kBoxCols, kvh, key0, b);
        }
        return;
    }

    // ---- consumer warpgroups ------------------------------------------------
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad_row = lane / 4, quad_col = 2 * (lane % 4);
    // this thread's two rows of the warpgroup's 64: warp*16 + lane/4 (+ 8)
    int row[2], pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        row[r] = warp * 16 + quad_row + 8 * r;
        pos[r] = row[r] < P * G ? s0 + wg * P + row[r] / G : -1;  // -1: masked, not stored
    }
    const uint32_t q_base = base + L::q + wg * L::kBoxes * kBoxBytes;
    const int nqk = (H + 15) / 16;  // k16 steps of Q.K^T
    const bool rows_full = P * G == kRows;  // no masked-out rows past P * G
    const int wg_pos_lo = s0 + wg * P, wg_pos_hi = wg_pos_lo + P - 1;
    constexpr float kLog2e = 1.4426950408889634f;
    const float qk_scale = scale * kLog2e;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f, cap_out = softcap * kLog2e;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    __syncwarp();
    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int key0 = (kt_lo + i) * kKeys;
        const uint32_t k_base = base + L::k + st * L::kBoxes * kBoxBytes;
        const uint32_t v_base = base + L::v + st * L::kBoxes * kBoxBytes;
        mbar_wait(full0 + 8 * st, (i / kStages) & 1);
        __syncwarp();

        // ---- S = Q K^T ------------------------------------------------------
        float s[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
            if (kc < nqk) {
                const uint32_t off = (kc / 4) * kBoxBytes + (kc % 4) * 32;
                wgmma_qk(s, desc_sw128(q_base + off, 16, 1024), desc_sw128(k_base + off, 16, 1024),
                         kc > 0);
            }
        }
        wg_commit();
        wg_wait_all();
        fence_regs(s);

        // ---- scale, softcap, mask; the online softmax, in base 2 -----------
        // s[j]: row (j / 2) % 2, key key0 + (j / 4) * 8 + quad_col + j % 2.
        // Logits are kept times log2(e), so p = 2^(x - m) = e^(l - m); a
        // masked logit is -1e30 as in the JAX kernel. A tile whose keys every
        // row of the warpgroup keeps skips the mask.
        const bool whole = rows_full && key0 + kKeys - 1 <= wg_pos_lo &&
                           (window <= 0 || key0 > wg_pos_hi - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int r = (j / 2) % 2;
            float x = softcap > 0.f ? tanhf(s[j] * cap_in) * cap_out : s[j] * qk_scale;
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
            corr[r] = ex2(m_run[r] - m_new);
            m_run[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int r = (j / 2) % 2;
            s[j] = ex2(s[j] - m_run[r]);
            sum[r] += s[j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];
        // P in bf16 as wgmma's A fragments, 16 keys each
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        // O is rescaled only when some row of the warp has a new max
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
            for (int j = 0; j < HD / 2; ++j) o[j] *= corr[(j / 2) % 2];
        }

        // ---- O += P V ---------------------------------------------------------
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_pv(o, pa[kk], desc_sw128(v_base + kk * 16 * 128, kBoxBytes, 1024));
        wg_commit();
        wg_wait_all();
        fence_regs(o);
        mbar_arrive(empty0 + 8 * st);
    }

    // ---- out = O / max(l, 1e-30) ------------------------------------------------
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_part[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (pos[r] < 0 || pos[r] >= S) continue;
        const int g = row[r] % G;
        __nv_bfloat16* dst =
            out + (((long long)b * S + pos[r]) * Nq + (long long)kvh * G + g) * Hv + quad_col;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            if (8 * j + quad_col < Hv)  // Hv is even: a pair never straddles it
                *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                    __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
    }
}

template <int HD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int B,
           int S, int Nq, int Nkv, int H, int Hv, float scale, int window, float softcap,
           cudaStream_t stream) {
    constexpr int bytes = Smem<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int P = kRows / (Nq / Nkv);
    const int n_qtiles = (S + kConsumers * P - 1) / (kConsumers * P);
    const unsigned blocks = (unsigned)((long long)n_qtiles * B * Nkv);
    flash_attention_tc_kernel<HD><<<blocks, kThreads, bytes, stream>>>(
        mq, mk, mv, (__nv_bfloat16*)out, S, Nq, Nkv, H, Hv, scale, window, softcap, n_qtiles);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out contiguous bf16, 16-byte aligned; H, Hv multiples of 8 and at
// most 256; Nq % Nkv == 0 and Nq / Nkv <= 64 (the wrapper checks);
// window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int Nq, int Nkv, int H, int Hv, float scale, int window,
                                  float softcap, void* stream) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    const int G = Nq / Nkv, P = kRows / G;
    const cuuint64_t e = 2;  // bytes of a bf16
    const auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;
    CUtensorMap mq, mk, mv;
    {  // q as (H, G, Nkv, S, B); a box is the 64 columns of P positions x G heads
        const cuuint64_t dims[5] = {(cuuint64_t)H, (cuuint64_t)G, (cuuint64_t)Nkv, (cuuint64_t)S,
                                    (cuuint64_t)B};
        const cuuint64_t strides[4] = {e * H, e * H * G, e * H * Nq, e * H * Nq * S};
        const cuuint32_t box[5] = {kBoxCols, (cuuint32_t)G, 1, (cuuint32_t)P, 1};
        if (!make_map(&mq, encode, kBf16, kSw128, q, 5, dims, strides, box)) return -2;
    }
    {  // k, v as (H, Nkv, S, B); a box is the 64 columns of 64 keys
        const cuuint32_t box[4] = {kBoxCols, 1, kKeys, 1};
        const cuuint64_t kdims[4] = {(cuuint64_t)H, (cuuint64_t)Nkv, (cuuint64_t)S, (cuuint64_t)B};
        const cuuint64_t kstr[3] = {e * H, e * H * Nkv, e * H * Nkv * S};
        const cuuint64_t vdims[4] = {(cuuint64_t)Hv, (cuuint64_t)Nkv, (cuuint64_t)S, (cuuint64_t)B};
        const cuuint64_t vstr[3] = {e * Hv, e * Hv * Nkv, e * Hv * Nkv * S};
        if (!make_map(&mk, encode, kBf16, kSw128, k, 4, kdims, kstr, box) ||
            !make_map(&mv, encode, kBf16, kSw128, v, 4, vdims, vstr, box))
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
