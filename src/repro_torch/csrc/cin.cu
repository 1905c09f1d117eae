// Fused xDeepFM CIN layer for Hopper (sm_90a), on the tensor cores through
// TF32 wgmma in split TF32 (three TF32 products a term), fp32 accuracy kept.
//
// Replaces the TPU kernel cin_layer of src/repro/kernels/cin/cin.py
// (_cin_kernel): one layer of the Compressed Interaction Network,
//   out[b, h', dd] = sum_{h, m'} w[h*m + m', h'] * xk[b, h, dd] * x0[b, m', dd].
// What the TPU kernel keeps out of device memory is the outer product
// z = xk (x) x0 of shape (B, H*m, d), 82 GB at B = 262,144 and the xDeepFM
// widths. Here no z exists at all: with n = b*d + dd one of N = B*d columns,
//   out[h', n] = sum_h xk[n, h] * P_h[h', n],  P_h[h', n] = sum_m' w[h*m + m', h'] * x0[n, m'],
// so each h is a GEMM of K = m (W_h^T: H' x m' against X0: m' x N) whose
// result is scaled column by column by xk[:, h] and summed in fp32. At the
// xDeepFM widths (H' = 200, m = 39, H = 39 or 200) a column does about
// 2*H'*H*m operations for 4*(H + m + H') bytes: operations bound it, 0.032
// ms at the 495 TFLOP/s of TF32 at serve_p99's layer 1.
//
// Design.
// - Split TF32: each operand x is split into hi = x with its low 13
//   mantissa bits cleared (a TF32 value) and lo = x - hi (exact in fp32;
//   the tensor core reads its top 10 mantissa bits), and each product is
//   hi*hi + hi*lo + lo*hi, accumulated in fp32: the dropped lo*lo and lo's
//   truncation are ~2^-20 of a term. The tensor core's own fp32 sums
//   truncate, and over K = 7,800 terms that bias alone comes near the
//   bound; here the tensor cores sum only one h's m terms (P_h), and the
//   sum over h is a rounded fp32 FMA. Held to the fp32 plain version within
//   1e-4 * max|plain|.
// - wgmma m64n64k8 TF32. A = W_h^T from registers: TF32 wgmma takes a
//   shared-memory operand only K-major, and w is (H*m, H') row-major, but
//   register fragments may come from any layout, so each thread loads its
//   elements of W_h from a shared-memory stage of w's rows and splits them.
//   B = X0 (m' x 64 columns), K-major in shared memory (no swizzle: core
//   matrices of 8 columns x 16 bytes, LBO = 128 bytes to the next 4 of K,
//   SBO = 256 to the next 8 columns), hi and lo made once per block.
// - A block is 4 consumer warpgroups, each 64 rows of H' (256 a block;
//   H' = 200 wastes 22%, H' > 256 takes more blocks along y), and 64
//   columns of N. A unit is one h's rows of w, at most 40 (m > 40 takes
//   several units an h), staged by cp.async with xk[:, h] into a ring of
//   two stages, the next unit's copy overlapping this unit's products.
// - Any number of fields: X0 is staged in chunks of at most 280 of its m'
//   (kChunkUnits units of each h; the whole of it at xDeepFM's m = 39). A
//   block runs chunk by chunk, every h in each, remaking X0 between chunks;
//   a chunk of an h adds xk[:, h] * (its part of P_h) as a whole h does.
//   m > 280 takes its own instantiation (CHUNKS): the chunk loop's extra
//   live values made ptxas spill in the unit loop, and the one-chunk
//   kernel ran slower with them.
// - Filling the card: when the column tiles are too few for the SMs
//   (serve_p99: N = 5,120, 80 tiles for 132 SMs), the caller splits the h
//   range ks ways (blockIdx.z); each part is stored to its own slice of a
//   workspace and a second kernel adds the ks slices in a fixed order, so
//   every run gives the same bits. At serve_bulk ks = 1: plain stores, no
//   second pass.
//
// The entry point returns the error of raising the block's shared-memory
// limit, or cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;             // four consumer warpgroups
constexpr int kCols = 64;                 // columns of a block (wgmma N)
constexpr int kBlockH = 256;              // H' of a block, 64 a warpgroup (wgmma M)
constexpr int kUnitSteps = 5;             // k8 steps of a unit at most
constexpr int kUnitRows = 8 * kUnitSteps;
constexpr int kWStride = kBlockH + 8;     // floats a staged row of w: 8 (mod 32) banks on
constexpr int kStage = kUnitRows * kWStride + kCols;  // floats of a stage: w's rows, xk[:, h]
constexpr int kXStep = (kCols / 8) * 2 * 32;          // floats of one k8 step of X0
constexpr int kChunkUnits = 7;            // units an h of one chunk of X0
constexpr int kChunkSteps = kChunkUnits * kUnitSteps;  // 280 fields: 223 KB in all
static_assert((2 * kStage + 2 * kChunkSteps * kXStep) * 4 <= 227 * 1024, "over 227 KB");

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// A wgmma descriptor of a no-swizzle K-major tile: core matrices of 8 rows
// x 16 bytes, the next 4 of K 128 bytes on (LBO), the next 8 rows 256 (SBO).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// D (64 x 64, fp32) += A (64 x 8, tf32, registers) * B (8 x 64, tf32, shared
// memory, K-major, no swizzle); scale_d == 0 starts D at zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// A chunk's units run h by h over [h_begin, h_begin + nh), each h's units
// of the chunk in order: unit k of chunk c is h_begin + k / uc's unit k % uc
// of the chunk, uc = units_in_chunk(c).
__device__ __forceinline__ int units_in_chunk(int c, int n_units_h) {
    return min(kChunkUnits, n_units_h - c * kChunkUnits);
}

// B = X0's chunk c (hi, lo) for the block's columns: element (column, m'),
// zeros past m and past N.
__device__ __forceinline__ void make_x0(float* x_hi, float* x_lo, const float* __restrict__ x0,
                                        int c, int m, int d, long long col0, long long N) {
    const int mm0 = c * kChunkSteps * 8;
    const int rows = 8 * min(kChunkSteps, (m + 7) / 8 - c * kChunkSteps);
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
        const int col = i % kCols, mm = i / kCols;
        const long long n = col0 + col;
        float val = 0.f;
        if (mm0 + mm < m && n < N) {
            const long long bb = n / d;
            val = x0[(bb * m + mm0 + mm) * d + (n - bb * d)];
        }
        const int off = (((mm / 8) * (kCols / 8) + col / 8) * 2 + (mm % 8) / 4) * 32 +
                        (col % 8) * 4 + mm % 4;
        uint32_t hi, lo;
        split(val, hi, lo);
        x_hi[off] = __uint_as_float(hi);
        x_lo[off] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma's reads
}

// One unit into a stage, as one cp.async group: w's rows h*m + 8*step0 ..
// (zeros past m) at the block's columns of H', and xk[n, h] for the block's
// columns (zeros past N). VEC copies 16 bytes at a time (H' % 4 == 0 and w
// 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void load_unit(float* stage, const float* __restrict__ w,
                                          const float* __restrict__ xk, int h, int step0,
                                          int steps, int m, int Hp, int hp0, int H, int d,
                                          long long col0, long long N) {
    constexpr int kPerRow = VEC ? kBlockH / 4 : kBlockH;
    const int rows = 8 * steps;
    const int hp_n = min(kBlockH, Hp - hp0);
    for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
        const int r = i / kPerRow, c = i % kPerRow;
        const int mm = 8 * step0 + r;
        const bool valid = mm < m && (VEC ? 4 * c : c) < hp_n;
        const float* src = valid ? w + ((long long)h * m + mm) * Hp + hp0 + (VEC ? 4 * c : c) : w;
        if (VEC)
            cp_async16(stage + r * kWStride + 4 * c, src, valid);
        else
            cp_async4(stage + r * kWStride + c, src, valid);
    }
    if (threadIdx.x < kCols) {
        const long long n = col0 + threadIdx.x;
        const bool valid = n < N;
        const long long bb = valid ? n / d : 0;
        cp_async4(stage + kUnitRows * kWStride + threadIdx.x,
                  valid ? xk + (bb * H + h) * d + (n - bb * d) : xk, valid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// out (or, when ks > 1, slice blockIdx.z of part) = the block's h range.
// CHUNKS: m over kChunkSteps * 8 fields, X0 in several chunks (a separate
// build, so that the one-chunk loop keeps its registers).
template <bool VEC, bool CHUNKS>
__global__ void __launch_bounds__(kThreads, 1)
cin_tc_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
              const float* __restrict__ w, float* __restrict__ out, int B, int H, int m, int d,
              int Hp, int ks) {
    extern __shared__ float4 smem_f4[];
    const int ms = (m + 7) / 8;  // k8 steps of an h
    const int n_units_h = (ms + kUnitSteps - 1) / kUnitSteps;
    const int xs_steps = min(ms, kChunkSteps);          // k8 steps of a chunk of X0
    float* stages = reinterpret_cast<float*>(smem_f4);  // [2][kStage]
    float* x_hi = stages + 2 * kStage;                  // [xs_steps][kCols / 8][2][32]
    float* x_lo = x_hi + xs_steps * kXStep;
    const long long N = (long long)B * d;
    const long long col0 = (long long)blockIdx.x * kCols;
    const int hp0 = blockIdx.y * kBlockH;
    const int hp_n = min(kBlockH, Hp - hp0);
    const int h_begin = (int)((long long)H * blockIdx.z / ks);
    const int nh = (int)((long long)H * (blockIdx.z + 1) / ks) - h_begin;
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    if (ks > 1) out += (long long)blockIdx.z * N * Hp;

    const int n_chunks = CHUNKS ? (n_units_h + kChunkUnits - 1) / kChunkUnits : 1;
    if (nh > 0) load_unit<VEC>(stages, w, xk, h_begin, 0, min(kUnitSteps, ms), m, Hp, hp0, H, d,
                               col0, N);
    make_x0(x_hi, x_lo, x0, 0, m, d, col0, N);

    // this thread's rows of H': hw + warp*16 + g (+ 8) of the block's
    const int hw = wg * 64;
    const int row = hw + warp * 16 + g;
    const bool busy = hw < hp_n;  // the same for the whole warpgroup
    float acc[32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

    int u = 0;  // units run so far: the stage of the next
    for (int c = 0; c < n_chunks && nh > 0; ++c) {
        if (c > 0) {
            __syncthreads();  // every warp is done with chunk c - 1's X0
            make_x0(x_hi, x_lo, x0, c, m, d, col0, N);
        }
        const int uc = CHUNKS ? units_in_chunk(c, n_units_h) : n_units_h;
        for (int k = 0; k < nh * uc; ++k, ++u) {
            const float* st = stages + (u & 1) * kStage;
            const int j = k % uc;  // of h_begin + k / uc
            const int steps = min(kUnitSteps, ms - (c * kChunkUnits + j) * kUnitSteps);
            asm volatile("cp.async.wait_group 0;" ::: "memory");
            __syncthreads();  // unit u staged (and X0 made); every warp is done with unit u - 1
            if (k + 1 < nh * uc) {
                const int h1 = h_begin + (k + 1) / uc, j1 = (k + 1) % uc;
                const int step1 = (c * kChunkUnits + j1) * kUnitSteps;
                load_unit<VEC>(stages + ((u + 1) & 1) * kStage, w, xk, h1, step1,
                               min(kUnitSteps, ms - step1), m, Hp, hp0, H, d, col0, N);
            } else if (c + 1 < n_chunks) {
                const int step1 = (c + 1) * kChunkSteps;
                load_unit<VEC>(stages + ((u + 1) & 1) * kStage, w, xk, h_begin, step1,
                               min(kUnitSteps, ms - step1), m, Hp, hp0, H, d, col0, N);
            }
            if (!busy) continue;
            // ---- A = W_h^T fragments: rows row, row + 8; k 8s + t, 8s + t + 4 -------
            uint32_t ah[kUnitSteps][4], al[kUnitSteps][4];
#pragma unroll
            for (int s = 0; s < kUnitSteps; ++s) {
                if (s < steps) {
                    const float* lo_k = st + (8 * s + t) * kWStride + row;
                    const float* hi_k = lo_k + 4 * kWStride;
                    split(lo_k[0], ah[s][0], al[s][0]);
                    split(lo_k[8], ah[s][1], al[s][1]);
                    split(hi_k[0], ah[s][2], al[s][2]);
                    split(hi_k[8], ah[s][3], al[s][3]);
                }
            }
            // ---- P_h (+)= W_h^T X0 over this unit: lo*hi, hi*lo, hi*hi ----------
            const int cstep = j * kUnitSteps;  // the unit's first step in its chunk
            wg_fence();
#pragma unroll
            for (int s = 0; s < kUnitSteps; ++s) {
                if (s < steps) {
                    const uint64_t dh = smem_desc(x_hi + (cstep + s) * kXStep);
                    const uint64_t dl = smem_desc(x_lo + (cstep + s) * kXStep);
                    wgmma_tf32(part, al[s], dh, cstep > 0 || s > 0);
                    wgmma_tf32(part, ah[s], dl, 1);
                    wgmma_tf32(part, ah[s], dh, 1);
                }
            }
            wg_commit();
            wg_wait_all();
            fence_regs(part);
            if (j == uc - 1) {  // the unit ends its h's chunk: acc += xk[n, h] * P_h (over it)
                const float* xs = st + kUnitRows * kWStride;
#pragma unroll
                for (int i = 0; i < 32; i += 2) {
                    const int col = (i / 4) * 8 + 2 * t;
                    acc[i] = fmaf(xs[col], part[i], acc[i]);
                    acc[i + 1] = fmaf(xs[col + 1], part[i + 1], acc[i + 1]);
                }
            }
        }
    }

    // acc[4j + e]: row row + 8 (e / 2) of H', column 8j + 2t + e % 2
    if (!busy) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const int hp = hp0 + row + 8 * ((i / 2) % 2);
        const long long n = col0 + (i / 4) * 8 + 2 * t + (i % 2);
        if (n >= N || hp >= Hp) continue;
        const long long bb = n / d;
        out[(bb * Hp + hp) * d + (n - bb * d)] = acc[i];
    }
}

// out[i] = part[0][i] + part[1][i] + ... + part[ks - 1][i], in that order.
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ out, long long n,
                          int ks) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = part[i];
        for (int z = 1; z < ks; ++z) s += part[z * n + i];
        out[i] = s;
    }
}

template <bool VEC, bool CHUNKS>
int launch(const float* xk, const float* x0, const float* w, float* out, float* part, int B,
           int H, int m, int d, int Hp, int ks, cudaStream_t stream) {
    const int xs_steps = min((m + 7) / 8, kChunkSteps);
    const int bytes = (2 * kStage + 2 * xs_steps * kXStep) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(cin_tc_kernel<VEC, CHUNKS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long N = (long long)B * d;
    const dim3 grid((unsigned)((N + kCols - 1) / kCols), (unsigned)((Hp + kBlockH - 1) / kBlockH),
                    (unsigned)ks);
    cin_tc_kernel<VEC, CHUNKS><<<grid, kThreads, bytes, stream>>>(xk, x0, w, ks > 1 ? part : out,
                                                                  B, H, m, d, Hp, ks);
    if (ks > 1) {
        const long long n = N * Hp;
        const long long blocks = (n + 255) / 256;
        sum_parts<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(part, out, n,
                                                                                   ks);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// xk (B, H, d), x0 (B, m, d), w (H*m, Hp), out (B, Hp, d): contiguous fp32;
// ks >= 1 parts of the h range, and part (ks, B, Hp, d) when ks > 1.
extern "C" int cin_layer(const void* xk, const void* x0, const void* w, void* out, void* part,
                         int B, int H, int m, int d, int Hp, int ks, void* stream) {
    const auto* a = (const float*)xk;
    const auto* z = (const float*)x0;
    const auto* ww = (const float*)w;
    auto* o = (float*)out;
    auto* p = (float*)part;
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec = Hp % 4 == 0 && (uintptr_t)w % 16 == 0, chunks = m > kChunkSteps * 8;
    if (chunks)
        return vec ? launch<true, true>(a, z, ww, o, p, B, H, m, d, Hp, ks, st)
                   : launch<false, true>(a, z, ww, o, p, B, H, m, d, Hp, ks, st);
    return vec ? launch<true, false>(a, z, ww, o, p, B, H, m, d, Hp, ks, st)
               : launch<false, false>(a, z, ww, o, p, B, H, m, d, Hp, ks, st);
}
