// Fused ragged batched chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ragged_prefill_attention.py,
// function ragged_prefill_attention (Pallas body _prefill_kernel).  Each
// row p is one prompt chunk of C tokens whose first token sits at absolute
// position starts[p]; its queries attend causally over the row's pages of
// the paged K/V pool (history plus the chunk just written), walking the
// block table inside the kernel.  Rows with limits[p] == 0 are scheduler
// filler: they read nothing and write exact zeros.
//
// What bounds it on the H100: at the serving shapes (C = 256 queries of
// G = 7 heads against one kv head) a key read from the pool feeds 4*C*G*D
// flops, so the arithmetic, not the bytes, is the floor.  This first
// version runs that arithmetic as f32 FMAs out of shared memory, not on the
// tensor cores, so it sits far above the bf16 tensor-core bound; wgmma and
// TMA staging are the later change.
//
// Design.  The TPU kernel steps a sequential grid (P, KV, W) and carries
// (acc, m, l) for all C x G query rows in VMEM across the page axis.  Here
// one thread block takes one (query-row tile, kv head, row): the C x G
// (token, head) pairs of that kv head are flattened and cut into tiles of
// THREADS rows, one query row per thread, its q vector and accumulator in
// registers.  The block loops over key tiles of KT keys between the
// tile's bounds: the causal bound start + c_max and, windowed, the window
// bound start + c_min - window + 1, so pages beyond causal reach or wholly
// below the window are never read.  Each key tile is staged in shared
// memory (block ids from the table) and every thread folds the keys it may
// see (kp <= qp and qp - kp < window, qp = start + c) into its online
// softmax in f32.  All threads of a warp read the same shared key at once
// (a broadcast), so staging is the only shared-memory traffic that can
// conflict.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // query rows per block

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ragged_prefill_kernel(
    const T* __restrict__ q,           // (P, C, H, D)
    const T* __restrict__ k_pool,      // (N, bs, KV, D)
    const T* __restrict__ v_pool,      // (N, bs, KV, D)
    const int* __restrict__ tables,    // (P, W)
    const int* __restrict__ starts,    // (P,)
    const int* __restrict__ limits,    // (P,)
    T* __restrict__ out,               // (P, C, H, D)
    int C, int H, int KV, int W, int bs, int window, float scale) {
    constexpr int KT = 4096 / D;       // keys per tile
    const int h = blockIdx.y;
    const int p = blockIdx.z;
    const int G = H / KV;
    const int rows = C * G;
    const int r0 = blockIdx.x * THREADS;
    const int r = r0 + threadIdx.x;
    const bool active = r < rows;
    const int c = active ? r / G : 0;
    const int g = active ? r % G : 0;
    const size_t o = (((size_t)p * C + c) * H + h * G + g) * D;

    if (limits[p] <= 0) {              // filler row: exact zeros, no reads
        if (active)
            for (int d = 0; d < D; ++d) out[o + d] = from_f<T>(0.f);
        return;
    }

    extern __shared__ float smem[];
    float* k_s = smem;                 // KT * D
    float* v_s = k_s + KT * D;         // KT * D

    const int start = starts[p];
    const int qp = start + c;
    const int c_lo = r0 / G;
    const int c_hi = min(rows - 1, r0 + THREADS - 1) / G;
    const int k_hi = min(W * bs, start + c_hi + 1);      // causal bound
    const int k_lo = window > 0 ? max(0, start + c_lo - window + 1) : 0;

    float qr[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = active ? to_f(q[o + d]) * scale : 0.f;
        acc[d] = 0.f;
    }
    float m = REPRO_NEG_INF, l = 0.f;

    for (int t0 = k_lo; t0 < k_hi; t0 += KT) {
        const int n = min(KT, k_hi - t0);
        __syncthreads();               // previous tile fully consumed
        for (int e = threadIdx.x; e < n * D; e += THREADS) {
            const int i = e / D, d = e % D;
            const int pos = t0 + i;
            const int bid = tables[(size_t)p * W + pos / bs];
            const size_t src = (((size_t)bid * bs + pos % bs) * KV + h) * D + d;
            k_s[e] = to_f(k_pool[src]);
            v_s[e] = to_f(v_pool[src]);
        }
        __syncthreads();
        if (!active) continue;
        for (int i = 0; i < n; ++i) {
            const int kp = t0 + i;
            if (kp > qp || (window > 0 && qp - kp >= window)) continue;
            const float* kr = k_s + i * D;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
            if (s > m) {               // new running max: rescale once
                const float corr = expf(m - s);
                l *= corr;
#pragma unroll
                for (int d = 0; d < D; ++d) acc[d] *= corr;
                m = s;
            }
            const float pe = expf(s - m);
            l += pe;
            const float* vr = v_s + i * D;
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] += pe * vr[d];
        }
    }
    if (active) {
        const float inv = 1.f / fmaxf(l, REPRO_L_FLOOR);
#pragma unroll
        for (int d = 0; d < D; ++d) out[o + d] = from_f<T>(acc[d] * inv);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* starts, const int* limits, void* out,
           int P, int C, int H, int KV, int W, int bs, int window, float scale,
           cudaStream_t stream) {
    constexpr int KT = 4096 / D;
    const size_t smem = sizeof(float) * 2 * KT * D;
    auto kernel = ragged_prefill_kernel<T, D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (C * (H / KV) + THREADS - 1) / THREADS;
    kernel<<<dim3(tiles, KV, P), THREADS, smem, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, starts,
        limits, (T*)out, C, H, KV, W, bs, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (P, C, H, D), pools (N, bs, KV, D), tables (P, W) int32, starts and
// limits (P,) int32, out like q; all contiguous on one device.  window <= 0
// means none.  Returns cudaGetLastError() after the launch, or
// REPRO_UNSUPPORTED.
extern "C" int ragged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* limits, void* out, int P, int C, int H,
    int KV, int D, int W, int bs, int window, float scale, int dtype,
    void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    const int* tab = (const int*)tables;
    const int* st0 = (const int*)starts;
    const int* lim = (const int*)limits;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(TYPE, DIM)                                              \
    return launch<TYPE, DIM>(q, k_pool, v_pool, tab, st0, lim, out, P, C, \
                             H, KV, W, bs, window, scale, st)
    if (dtype == REPRO_F32 && D == 64) REPRO_CASE(float, 64);
    if (dtype == REPRO_F32 && D == 128) REPRO_CASE(float, 128);
    if (dtype == REPRO_BF16 && D == 64) REPRO_CASE(__nv_bfloat16, 64);
    if (dtype == REPRO_BF16 && D == 128) REPRO_CASE(__nv_bfloat16, 128);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
