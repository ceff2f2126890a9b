// Dense GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py, function
// decode_attention (:67, Pallas body _kernel :28-64).  One query token per
// batch row attends over that row's dense K/V cache (B, S, KV, D) up to a
// per-row length; it is the attention of Generator decode steps and of the
// composed paged lowering's decode (after the pool[block_tables] gather).
// Unlike the Pallas kernel it takes a sliding window, with the oracle's
// meaning (src/repro/kernels/ref.py:155-159): keys below length - window
// are masked, and are never read.
//
// What bounds it on the H100: bytes.  Per key it does 4*G*D flops against
// 2*D*itemsize bytes of K/V (about 7 flops per byte in bf16 at G = 7), far
// below the ~295 flops/byte the card needs before its tensor cores matter.
// Only the keys in [max(0, length - window), min(length, S)) are read.
//
// Design.  The TPU kernel steps a sequential grid (B*KV, S/bs) and carries
// (acc, m, l) in VMEM across the cache axis.  Hopper blocks run in
// parallel in no order, so one thread block per (kv head, batch row) walks
// the row's key range itself: decode_block of common.cuh, the warp-parallel
// body of paged_decode_attention.cu (warp tiles of 16-byte loads with the
// next tile in flight, shuffle-reduced scores, an exp2 online softmax on
// all 32 lanes, the warps merged once per block), here with the dense
// address ((b*S + pos)*KV + h)*D in place of a block-table walk.
//
// Head dims 64, 128 and 256 (recurrentgemma-2b); any number of query heads
// per kv head, in blocks of at most DEC_GMAX (common.cuh).
//
// Known limit, shared with the paged kernel: B * KV blocks (32 at the
// Generator's shapes, 16 at recurrentgemma's with its two head chunks)
// underfill 132 SMs; split-K over the cache axis with a combine pass is the
// later change, and lands in both kernels at once.

#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(
    const T* __restrict__ q,           // (B, H, D)
    const T* __restrict__ k_cache,     // (B, S, KV, D)
    const T* __restrict__ v_cache,     // (B, S, KV, D)
    const int* __restrict__ lengths,   // (B,)
    T* __restrict__ out,               // (B, H, D)
    int S, int H, int KV, int window, float scale) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / KV;
    const DecHeads hd(G);
    const int length = lengths[b];
    // valid keys: pos < length and, windowed, pos >= length - window
    const int k_hi = min(length, S);
    const int k_lo = window > 0 ? max(0, length - window) : 0;
    const size_t row = ((size_t)b * H + h * G + hd.g0) * D;
    extern __shared__ __align__(16) float dec_smem[];
    decode_block<T, D>(q + row, k_cache, v_cache, out + row, hd.gn, k_lo,
                       k_hi, scale, DenseAddr<D>{b, S, KV, h}, dec_smem);
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* lengths, void* out, int B, int S, int H, int KV,
           int window, float scale, cudaStream_t stream) {
    constexpr size_t smem = dec_smem_bytes<D>();
    auto kernel = decode_kernel<T, D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dec_grid(B, H, KV), DEC_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k_cache, (const T*)v_cache, lengths, (T*)out,
        S, H, KV, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D), caches (B, S, KV, D), lengths (B,) int32, out like q; all
// contiguous on one device, the caches 16-byte aligned.  window <= 0 means
// none.  Returns cudaGetLastError() after the launch, or REPRO_UNSUPPORTED.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int B, int S, int H, int KV, int D,
    int window, float scale, int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)k_cache | (size_t)v_cache) % 16 != 0)
        return REPRO_UNSUPPORTED;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(TYPE, DIM)                                               \
    return launch<TYPE, DIM>(q, k_cache, v_cache, len, out, B, S, H, KV,   \
                             window, scale, st)
    if (dtype == REPRO_F32 && D == 64) REPRO_CASE(float, 64);
    if (dtype == REPRO_F32 && D == 128) REPRO_CASE(float, 128);
    if (dtype == REPRO_BF16 && D == 64) REPRO_CASE(__nv_bfloat16, 64);
    if (dtype == REPRO_BF16 && D == 128) REPRO_CASE(__nv_bfloat16, 128);
    if (dtype == REPRO_F32 && D == 256) REPRO_CASE(float, 256);
    if (dtype == REPRO_BF16 && D == 256) REPRO_CASE(__nv_bfloat16, 256);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
