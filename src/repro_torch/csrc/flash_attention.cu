// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces flash_attention / _attn_kernel of
// src/repro/extras/flash_attention/flash_attention.py. That kernel runs the
// kv axis as the innermost, sequential grid dimension and carries the
// online-softmax state (m, l, acc) in VMEM from one grid step to the next,
// computing every kv tile, masked or not. Blocks here run in parallel in no
// order, so one block owns a tile of queries and walks its kv tiles itself,
// with m, l and acc in registers and shared memory, and it skips the tiles
// that lie wholly above the diagonal or wholly outside the window.
//
// What it computes, as the JAX kernel does: q (B,S,Nq,H), k (B,S,Nkv,H),
// v (B,S,Nkv,Hv), one dtype (float32 or bfloat16); logits in fp32, scaled,
// then tanh(l/c)*c with a softcap, then the mask (key j is kept for query i
// iff j <= i and, with a window, j > i - window; the rest become -1e30), an
// online softmax with fp32 m (started at -1e30), l and acc, and the output
// acc / max(l, 1e-30) in q's dtype, (B,S,Nq,Hv). Starting m at -1e30 keeps
// the JAX arithmetic: a row whose first tiles are wholly masked sums
// exp(0) garbage until its first kept key, where corr = exp(-1e30 - m)
// wipes it (every row keeps its own diagonal key, which lies in the
// block's last tile).
//
// Design: a block of 256 threads owns 64 rows of one (batch, kv head):
// rows are (position, query head of the group) pairs in that order, so
// with MQA (G = 8) a block takes 8 positions of all 8 heads and every K/V
// tile it loads serves all of them. Q (64 x HD), one K tile (64 x HD), one
// V tile (64 x HD) and the 64 x 64 logits live in shared memory as fp32
// (bf16 inputs are widened on load; HD is H and Hv rounded up to 64, 128
// or 256, zero-padded): 212 KB at HD = 256, so one block per SM, through
// dynamic shared memory. Per kv tile: (1) each thread computes a 4 x 4
// block of logits with fp32 FMAs over float4 loads; (2) four threads per
// row take the row's max, rescale factor and exp, and keep m and l in
// registers; (3) each thread rescales and accumulates a 4 x (HD/16) block
// of the output in registers (64 floats at HD = 256). Q and K rows are
// padded by 4 floats so a quarter-warp's float4 loads hit distinct banks.
// Blocks run the heaviest query tiles (last positions) first.
//
// Bound: operations. Q.K^T and P.V over the kept (query, key) pairs are
// 2*(H + Hv) operations a pair, against 2*(H + Hv) bytes a row moved;
// this kernel does them on fp32 CUDA cores (67 T/s), not on the bf16
// tensor cores (989 T/s): exact for both dtypes, and the redesign for the
// tensor cores (wgmma, TMA, warp specialisation) is later work.
//
// The entry point returns cudaGetLastError() after its launch (or the
// error of raising the block's shared-memory limit).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // (position, head) rows of one block
constexpr int kKeys = 64;   // keys of one kv tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {  // offsets in floats into dynamic shared memory
    static constexpr int kQK = HD + 4;      // row stride of the Q and K tiles
    static constexpr int kP = kKeys + 4;    // row stride of the logits
    static constexpr int q = 0;
    static constexpr int k = q + kRows * kQK;
    static constexpr int v = k + kKeys * kQK;
    static constexpr int p = v + kKeys * HD;
    static constexpr int corr = p + kRows * kP;
    static constexpr int l = corr + kRows;
    static constexpr int floats = l + kRows;
    static constexpr size_t bytes = floats * sizeof(float);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Four consecutive elements as floats; `vec` says 4-element loads are
// aligned (16 bytes for fp32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* src, bool vec) {
    if (vec) return *reinterpret_cast<const float4*>(src);
    return make_float4(src[0], src[1], src[2], src[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src, bool vec) {
    if (vec) {
        const uint2 raw = *reinterpret_cast<const uint2*>(src);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]), to_f(src[3]));
}

// Fill `rows` rows of a shared tile (row stride `stride`, HD columns) from
// global rows; row_ptr(r) is the row's first element or nullptr for a row
// past the end (zero-filled), and columns from n on are zero.
template <int HD, typename T, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int stride, int rows, int n, bool vec,
                                          RowPtr row_ptr) {
    constexpr int kGroups = HD / 4;
    for (int item = threadIdx.x; item < rows * kGroups; item += kThreads) {
        const int r = item / kGroups;
        const int c = (item - r * kGroups) * 4;
        const T* src = row_ptr(r);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (src != nullptr) {
            if (c + 4 <= n) {
                val = load4(src + c, vec);
            } else if (c < n) {  // the ragged last group of a row
                val.x = to_f(src[c]);
                if (c + 1 < n) val.y = to_f(src[c + 1]);
                if (c + 2 < n) val.z = to_f(src[c + 2]);
            }
        }
        *reinterpret_cast<float4*>(dst + r * stride + c) = val;
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int Nq, int Nkv,
                       int H, int Hv, float scale, int window, float softcap, int n_qtiles,
                       bool vec) {
    using L = Layout<HD>;
    constexpr int kJ = HD / 64;  // float4 output groups a thread owns per row
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    float* Qs = smem + L::q;
    float* Ks = smem + L::k;
    float* Vs = smem + L::v;
    float* Ps = smem + L::p;
    float* corr_s = smem + L::corr;
    float* l_s = smem + L::l;

    const int G = Nq / Nkv;
    const int n_bh = gridDim.x / n_qtiles;
    const int bh = blockIdx.x % n_bh;                        // (batch, kv head)
    const int qt = n_qtiles - 1 - blockIdx.x / n_bh;         // heaviest tiles first
    const int b = bh / Nkv;
    const int kvh = bh - b * Nkv;
    const long long n_rows = (long long)S * G;
    const long long t0 = (long long)qt * kRows;

    // ---- the block's queries, and the kv tiles they need ------------------
    load_tile<HD, T>(Qs, L::kQK, kRows, H, vec, [&](int r) -> const T* {
        const long long t = t0 + r;
        if (t >= n_rows) return nullptr;
        const long long s = t / G;
        const int g = (int)(t - s * G);
        return q + (((long long)b * S + s) * Nq + (long long)kvh * G + g) * H;
    });
    const int s_lo = (int)(t0 / G);
    const int s_hi = (int)min((long long)S - 1, (t0 + kRows - 1) / G);
    const int j_lo = window > 0 ? max(0, s_lo - window + 1) : 0;
    const int kt_lo = j_lo / kKeys;
    const int kt_hi = s_hi / kKeys;

    // phase 1/3 mapping: rows ty + 16 i; logits keys tx + 16 j; output
    // columns 4 (tx + 16 j) .. + 3
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    int pos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pos[i] = (int)((t0 + ty + 16 * i) / G);
    // phase 2 mapping: four threads a row, keys part + 4 c
    const int srow = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    float m_run = kNegInf, l_run = 0.f;

    float acc[4][kJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const long long kv_row0 = (long long)b * S;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int key0 = kt * kKeys;
        __syncthreads();  // the previous tile's K, V and logits are consumed
        load_tile<HD, T>(Ks, L::kQK, kKeys, H, vec, [&](int r) -> const T* {
            const int j = key0 + r;
            return j < S ? k + ((kv_row0 + j) * Nkv + kvh) * H : nullptr;
        });
        load_tile<HD, T>(Vs, HD, kKeys, Hv, vec, [&](int r) -> const T* {
            const int j = key0 + r;
            return j < S ? v + ((kv_row0 + j) * Nkv + kvh) * Hv : nullptr;
        });
        __syncthreads();

        // ---- (1) logits, masked ------------------------------------------
        {
            float s[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
            for (int h = 0; h < HD; h += 4) {
                float4 qa[4], ka[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::kQK + h);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::kQK + h);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
                        s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
                        s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
                        s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
                    }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int key = key0 + tx + 16 * j;
                    float x = s[i][j] * scale;
                    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                    const bool ok = key <= pos[i] && (window <= 0 || key > pos[i] - window);
                    Ps[(ty + 16 * i) * L::kP + tx + 16 * j] = ok ? x : kNegInf;
                }
        }
        __syncthreads();

        // ---- (2) online softmax: m, l, and p in place of the logits -------
        {
            float* prow = Ps + srow * L::kP + part;
            float mx = kNegInf;
#pragma unroll
            for (int c = 0; c < kKeys / 4; ++c) mx = fmaxf(mx, prow[4 * c]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run, mx);
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < kKeys / 4; ++c) {
                const float p = expf(prow[4 * c] - m_new);
                prow[4 * c] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const float corr = expf(m_run - m_new);
            l_run = l_run * corr + sum;
            m_run = m_new;
            if (part == 0) corr_s[srow] = corr;
        }
        __syncthreads();

        // ---- (3) acc = acc * corr + P V -------------------------------------
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float c = corr_s[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] *= c;
        }
#pragma unroll 2
        for (int kk = 0; kk < kKeys; kk += 4) {
            float4 pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::kP + kk);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float4 va[kJ];
#pragma unroll
                for (int j = 0; j < kJ; ++j)
                    va[j] = *reinterpret_cast<const float4*>(Vs + (kk + e) * HD + 4 * (tx + 16 * j));
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        acc[i][j][0] = fmaf(p, va[j].x, acc[i][j][0]);
                        acc[i][j][1] = fmaf(p, va[j].y, acc[i][j][1]);
                        acc[i][j][2] = fmaf(p, va[j].z, acc[i][j][2]);
                        acc[i][j][3] = fmaf(p, va[j].w, acc[i][j][3]);
                    }
                }
            }
        }
    }

    // ---- out = acc / max(l, 1e-30) ---------------------------------------
    if (part == 0) l_s[srow] = l_run;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long t = t0 + ty + 16 * i;
        if (t >= n_rows) continue;
        const long long s = t / G;
        const int g = (int)(t - s * G);
        T* dst = out + (((long long)b * S + s) * Nq + (long long)kvh * G + g) * Hv;
        const float denom = fmaxf(l_s[ty + 16 * i], 1e-30f);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * (tx + 16 * j) + e;
                if (c < Hv) from_f(dst + c, acc[i][j][e] / denom);
            }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Nq,
           int Nkv, int H, int Hv, float scale, int window, float softcap, bool vec,
           cudaStream_t stream) {
    constexpr size_t bytes = Layout<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const long long rows = (long long)S * (Nq / Nkv);
    const int n_qtiles = (int)((rows + kRows - 1) / kRows);
    const unsigned blocks = (unsigned)((long long)n_qtiles * B * Nkv);
    flash_attention_kernel<T, HD><<<blocks, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Nq, Nkv, H, Hv, scale, window,
        softcap, n_qtiles, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int Nq,
             int Nkv, int H, int Hv, float scale, int window, float softcap, bool vec,
             cudaStream_t stream) {
    const int hd = H > Hv ? H : Hv;
    if (hd <= 64)
        return launch<T, 64>(q, k, v, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, vec,
                             stream);
    if (hd <= 128)
        return launch<T, 128>(q, k, v, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, vec,
                              stream);
    return launch<T, 256>(q, k, v, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap, vec,
                          stream);
}

}  // namespace

// q, k, v, out contiguous; bf16 != 0 for bfloat16, else float32; window <= 0
// and softcap <= 0 mean none; H, Hv <= 256 and Nq % Nkv == 0 (the wrapper
// checks); vec != 0 when every pointer is 16-byte aligned and H, Hv are
// multiples of 4.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int Nq, int Nkv, int H, int Hv, float scale, int window,
                               float softcap, int bf16, int vec, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        return dispatch<__nv_bfloat16>(q, k, v, out, B, S, Nq, Nkv, H, Hv, scale, window,
                                       softcap, vec != 0, st);
    return dispatch<float>(q, k, v, out, B, S, Nq, Nkv, H, Hv, scale, window, softcap,
                           vec != 0, st);
}
