// Fused xDeepFM CIN layer for Hopper (sm_90a).
//
// Replaces the TPU kernel cin_layer of src/repro/kernels/cin/cin.py
// (_cin_kernel): one layer of the Compressed Interaction Network,
//   out[b, h', dd] = sum_{h, m'} w[h*m + m', h'] * xk[b, h, dd] * x0[b, m', dd].
// What the TPU kernel keeps out of device memory is the outer product
// z = xk (x) x0 of shape (B, H*m, d), 82 GB at B = 262,144 and the xDeepFM
// widths. Here too z exists only as a shared-memory tile.
//
// Seen as a GEMM: out[h', n] = sum_k W[k, h'] * Z[k, n] with M = H' rows,
// K = H*m (h-major: k = h*m + m'), and N = B*d columns n = b*d + dd, where
// Z[k, n] = xk[b, k / m, dd] * x0[b, k % m, dd] is generated while a tile
// loads. At the xDeepFM widths (H' = 200, K = 1,521 or 7,800) a column does
// 2*H'*K FLOP for 4*(H + m + H') bytes, so the card's fp32 rate bounds it
// (67 TFLOP/s without tensor cores), not its bytes.
//
// Design: a plain shared-memory-tiled SGEMM. A block owns a 64 x 64 output
// tile (64 rows of H', 64 columns of N). Per K step of 16 it stages the
// 16 x 64 tile of W (coalesced rows of w) and generates the 16 x 64 tile of
// Z from xk and x0: each thread owns one column of it, so the column's
// (b, dd) and its base pointers are computed once. Each of the 256 threads
// keeps a 4 x 4 accumulator and reads both tiles as float4. fp32 FMA only,
// no TF32, so the result is held to the fp32 plain version. The ragged
// edges are masked: rows past H' and columns past N load zeros and are not
// stored. Left for a later PR: TF32 or wgmma (495 TFLOP/s), double
// buffering, and the 22% of rows wasted at H' = 200 (four tiles of 64).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kRowsPerPass = kThreads / BN;      // tile rows staged per pass
static_assert(BM == BN, "one thread column index serves both staged tiles");
static_assert(BK % kRowsPerPass == 0, "whole passes over a K step");

__global__ void __launch_bounds__(kThreads)
cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
           const float* __restrict__ w, float* __restrict__ out,
           int B, int H, int m, int d, int Hp) {
    __shared__ __align__(16) float Ws[BK][BM];
    __shared__ __align__(16) float Zs[BK][BN];
    const long long N = (long long)B * d;
    const int K = H * m;
    const int row0 = blockIdx.y * BM;
    const long long col0 = (long long)blockIdx.x * BN;
    const int tid = threadIdx.x;

    // staging: this thread's tile column lc, rows lk, lk + 4, ...
    const int lc = tid % BN;
    const int lk = tid / BN;
    const long long n = col0 + lc;
    const bool n_ok = n < N;
    const long long b = n_ok ? n / d : 0;
    const int dd = n_ok ? (int)(n - b * d) : 0;
    const float* xk_col = xk + b * H * d + dd;
    const float* x0_col = x0 + b * m * d + dd;
    const bool w_ok = row0 + lc < Hp;

    // compute: this thread's rows tr*4 .. +3 and columns tc*4 .. +3
    const int tr = tid / (BN / TN);
    const int tc = tid % (BN / TN);

    float acc[TM][TN] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int r = 0; r < BK; r += kRowsPerPass) {
            const int kk = lk + r;
            const int k = k0 + kk;
            float wv = 0.f, zv = 0.f;
            if (k < K) {
                if (w_ok) wv = w[(long long)k * Hp + row0 + lc];
                if (n_ok) {
                    const int h = k / m;
                    zv = xk_col[(long long)h * d] * x0_col[(long long)(k - h * m) * d];
                }
            }
            Ws[kk][lc] = wv;
            Zs[kk][lc] = zv;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&Ws[kk][tr * TM]);
            const float4 z = *reinterpret_cast<const float4*>(&Zs[kk][tc * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float zv[TN] = {z.x, z.y, z.z, z.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], zv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const long long nj = col0 + tc * TN + j;
        if (nj >= N) continue;
        const long long bj = nj / d;
        float* o = out + bj * Hp * d + (nj - bj * d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int row = row0 + tr * TM + i;
            if (row < Hp) o[(long long)row * d] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" int cin_layer(const void* xk, const void* x0, const void* w, void* out,
                         int B, int H, int m, int d, int Hp, void* stream) {
    const long long N = (long long)B * d;
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((Hp + BM - 1) / BM));
    cin_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xk, (const float*)x0, (const float*)w, (float*)out, B, H, m, d, Hp);
    return (int)cudaGetLastError();
}
