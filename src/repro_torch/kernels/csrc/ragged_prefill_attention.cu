// Fused ragged batched chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ragged_prefill_attention.py,
// function ragged_prefill_attention (:89, Pallas body _prefill_kernel).  Each
// row p is one prompt chunk of C tokens whose first token sits at absolute
// position starts[p]; its queries attend causally over the row's pages of
// the paged K/V pool (history plus the chunk just written), walking the
// block table inside the kernel.  Rows with limits[p] == 0 are scheduler
// filler: they read nothing and write exact zeros.
//
// What bounds it on the H100: at the serving shapes (C = 256 queries of
// G = 7 heads against one kv head) a key read from the pool feeds 4*C*G*D
// flops, so the arithmetic, not the bytes, is the floor of the visible
// work.  The kernel is held above it by the serial chain of each key tile
// (Q K^T, the softmax on the CUDA cores, P V in three bf16 parts) and, at
// recurrentgemma-2b's (10, 1, 256), by L2: the 40 query tiles of a row each
// read its ~2048 windowed keys, 64 KB a tile of 64 keys.
//
// Design.  The TPU kernel steps a sequential grid (P, KV, W) and carries
// (acc, m, l) for all C x G query rows in VMEM across the page axis.  Here
// one thread block takes one (query-row tile, kv head, row) and walks the
// row's keys itself with a body of common.cuh shared with
// flash_attention.cu; its address functor finds each key's block id in
// the row's table.  bf16 takes prefill_block_wgmma: a producer warpgroup
// gathers the pages of each 64-key tile with 16-byte cp.async into a ring
// of shared-memory stages behind mbarriers (one table read a key row,
// then the row's chunks), while one consumer warpgroup runs Q K^T and P V
// on wgmma and the online softmax on the accumulators.  f32 takes
// prefill_block (one query row per thread, f32 FMAs; it spills at D = 256
// and runs only in the f32 identity checks).  The tiles are taken in
// reverse along the grid, so every row's query tiles that reach the most
// keys start first.  A filler row returns before reading anything, its
// 64 or 128 rows written as exact zeros.  Head dims 64, 128 and 256.

#include "common.cuh"

namespace {

// Launch shape of each body: the tensor-core one for bf16, FMAs for f32.
template <typename T, int D>
struct Body {
    static constexpr int THREADS = PRE_THREADS, ROWS = PRE_THREADS;
    static constexpr int MIN_BLOCKS = 1;
    static constexpr size_t SMEM = pre_smem_bytes<D, D>();
};
template <int D>
struct Body<__nv_bfloat16, D> {
    static constexpr int THREADS = WG_THREADS, ROWS = WG_ROWS;
    static constexpr int MIN_BLOCKS = WgShape<D, D>::MIN_BLOCKS;
    static constexpr size_t SMEM = WgShape<D, D>::SMEM;
};

// Grid (kv head, row, query tile), the tiles in reverse: blocks start in
// blockIdx order, so every row's last query tiles, which reach the most
// keys, start first and the short ones fill in behind them.
template <typename T, int D>
__global__ void __launch_bounds__(Body<T, D>::THREADS, Body<T, D>::MIN_BLOCKS)
ragged_prefill_kernel(
    const T* __restrict__ q,           // (P, C, H, D)
    const T* __restrict__ k_pool,      // (N, bs, KV, D)
    const T* __restrict__ v_pool,      // (N, bs, KV, D)
    const int* __restrict__ tables,    // (P, W)
    const int* __restrict__ starts,    // (P,)
    const int* __restrict__ limits,    // (P,)
    T* __restrict__ out,               // (P, C, H, D)
    int C, int H, int KV, int W, int bs, int window, float scale) {
    using Bd = Body<T, D>;
    const int h = blockIdx.x;
    const int p = blockIdx.y;
    const int G = H / KV;
    const int r0 = (gridDim.z - 1 - blockIdx.z) * Bd::ROWS;
    const size_t row = (size_t)p * C * H * D;

    if (limits[p] <= 0) {              // filler row: exact zeros, no reads
        for (int e = threadIdx.x; e < Bd::ROWS * D; e += Bd::THREADS) {
            const int r = r0 + e / D;
            if (r < C * G)
                out[row + ((size_t)(r / G) * H + h * G + r % G) * D + e % D] =
                    from_f<T>(0.f);
        }
        return;
    }
    extern __shared__ __align__(16) unsigned char smem[];
    const PagedAddr<D> addr{tables + (size_t)p * W, bs, KV, h};
    if constexpr (sizeof(T) == 2)
        prefill_block_wgmma<D, D>(q + row, k_pool, v_pool, out + row, C, H,
                                  G, h, r0, starts[p], W * bs, true, window,
                                  scale, addr, addr, smem);
    else
        prefill_block<T, D, D>(q + row, k_pool, v_pool, out + row, C, H, G,
                               h, r0, starts[p], W * bs, true, window, scale,
                               addr, addr, reinterpret_cast<float*>(smem));
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* starts, const int* limits, void* out,
           int P, int C, int H, int KV, int W, int bs, int window, float scale,
           cudaStream_t stream) {
    using Bd = Body<T, D>;
    auto kernel = ragged_prefill_kernel<T, D>;
    cudaError_t err = reserve_smem(kernel, Bd::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (C * (H / KV) + Bd::ROWS - 1) / Bd::ROWS;
    kernel<<<dim3(KV, P, tiles), Bd::THREADS, Bd::SMEM, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, starts,
        limits, (T*)out, C, H, KV, W, bs, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (P, C, H, D), pools (N, bs, KV, D), tables (P, W) int32, starts and
// limits (P,) int32, out like q; all contiguous on one device, q and the
// pools 16-byte aligned.  window <= 0
// means none.  Returns cudaGetLastError() after the launch, or
// REPRO_UNSUPPORTED.
extern "C" int ragged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* limits, void* out, int P, int C, int H,
    int KV, int D, int W, int bs, int window, float scale, int dtype,
    void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)q | (size_t)k_pool | (size_t)v_pool) % 16 != 0)
        return REPRO_UNSUPPORTED;
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
    if (dtype == REPRO_F32 && D == 256) REPRO_CASE(float, 256);
    if (dtype == REPRO_BF16 && D == 256) REPRO_CASE(__nv_bfloat16, 256);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
