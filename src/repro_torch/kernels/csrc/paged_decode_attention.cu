// Fused paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py,
// function paged_decode_attention (:91, Pallas body _decode_kernel).  One query
// token per batch row attends over that row's pages of the paged K/V pool,
// walking the block table inside the kernel: no dense pool[block_tables]
// copy is made, and each live key is read from the pool once.
//
// What bounds it on the H100: bytes.  Per key it does 4*G*D flops against
// 2*D*itemsize bytes of K/V (about 7 flops per byte in bf16 at G = 7), far
// below the ~295 flops/byte the card needs before its tensor cores matter.
// So the design is about keeping many independent loads in flight.
//
// Design.  The TPU kernel steps a sequential grid (B, KV, W) and carries the
// running softmax (acc, m, l) in VMEM scratch across the page axis.  Hopper
// blocks run in parallel in no order, so one thread block per (kv head,
// batch row) walks the key range [lo, length) itself, lo = length - window
// when windowed (keys below it, and so the pages wholly below it, are never
// read).  The walk is decode_block of common.cuh (warp tiles of 16-byte
// loads, shuffle-reduced scores, an exp2 online softmax on all 32 lanes,
// the warps merged once per block), shared with decode_attention.cu; here
// its address functor finds each key's block id in the row's table.
//
// Masking is the reference's: keys with pos >= length (or below the window)
// score NEG_INF = -1e30, and the output divides by max(l, 1e-30), so a row
// of length 0 writes zeros.
//
// Head dims 64, 128 and 256 (recurrentgemma-2b); any number of query heads
// per kv head, in blocks of at most DEC_GMAX (common.cuh).
//
// Known limit, left for a later change: with B * KV = 16..32 blocks on 132
// SMs the card is underfilled, and the block of the longest row, one tile
// of loads in flight per warp, sets the time.  Splitting the key axis
// across blocks (split-K flash decode with a second combine pass) is the
// fix.

#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS) paged_decode_kernel(
    const T* __restrict__ q,           // (B, H, D)
    const T* __restrict__ k_pool,      // (N, bs, KV, D)
    const T* __restrict__ v_pool,      // (N, bs, KV, D)
    const int* __restrict__ tables,    // (B, W)
    const int* __restrict__ lengths,   // (B,)
    T* __restrict__ out,               // (B, H, D)
    int H, int KV, int W, int bs, int window, float scale) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / KV;
    const DecHeads hd(G);
    const int length = lengths[b];
    // valid keys: pos < length and, windowed, pos >= length - window
    const int k_hi = min(length, W * bs);
    const int k_lo = window > 0 ? max(0, length - window) : 0;
    const size_t row = ((size_t)b * H + h * G + hd.g0) * D;
    extern __shared__ __align__(16) float dec_smem[];
    decode_block<T, D>(q + row, k_pool, v_pool, out + row, hd.gn, k_lo, k_hi,
                       scale, PagedAddr<D>{tables + (size_t)b * W, bs, KV, h},
                       dec_smem);
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lengths, void* out, int B, int H,
           int KV, int W, int bs, int window, float scale,
           cudaStream_t stream) {
    constexpr size_t smem = dec_smem_bytes<D>();
    auto kernel = paged_decode_kernel<T, D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dec_grid(B, H, KV), DEC_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, lengths,
        (T*)out, H, KV, W, bs, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D), pools (N, bs, KV, D), tables (B, W) int32, lengths (B,)
// int32, out like q; all contiguous on one device, the pools 16-byte
// aligned.  window <= 0 means none.  Returns cudaGetLastError() after the
// launch, or REPRO_UNSUPPORTED.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int KV, int D, int W,
    int bs, int window, float scale, int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)k_pool | (size_t)v_pool) % 16 != 0) return REPRO_UNSUPPORTED;
    const int* tab = (const int*)tables;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(TYPE, DIM)                                             \
    return launch<TYPE, DIM>(q, k_pool, v_pool, tab, len, out, B, H, KV, \
                             W, bs, window, scale, st)
    if (dtype == REPRO_F32 && D == 64) REPRO_CASE(float, 64);
    if (dtype == REPRO_F32 && D == 128) REPRO_CASE(float, 128);
    if (dtype == REPRO_BF16 && D == 64) REPRO_CASE(__nv_bfloat16, 64);
    if (dtype == REPRO_BF16 && D == 128) REPRO_CASE(__nv_bfloat16, 128);
    if (dtype == REPRO_F32 && D == 256) REPRO_CASE(float, 256);
    if (dtype == REPRO_BF16 && D == 256) REPRO_CASE(__nv_bfloat16, 256);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
