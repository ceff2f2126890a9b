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
// What matters is that enough blocks stream K/V at once: the Generator's
// shapes have B x KV = 8-16 (row, kv head) pairs for 132 SMs.
//
// Design (bf16).  The TPU kernel steps a sequential grid (B*KV, S/bs) and
// carries (acc, m, l) in VMEM across the cache axis.  Here the cache axis
// is split: a grid of (kv head x head chunk, row, split), the wrapper
// choosing the splits from S and the SM count (decode_splits) so that every
// SM streams keys for one block (two an SM measured slower on an H100: more
// partials to merge); each block clips its split to the
// row's visible range on the device (no host sync) and runs
// decode_split_block of common.cuh: all G query heads of its kv head (in
// chunks of 16 only above G = 16) as the 16 rows of mma.sync m16n8k16
// products, so K/V is read once for every head and the scores are
// tensor-core dot products with no shuffle reduction; P V on mma.sync with
// P in three bf16 parts.  The splits' partials (acc, m, l in f32) go to a
// workspace the wrapper allocates, and a second small kernel in the same
// call (decode_combine_kernel, one block a (row, head)) merges them in
// split order, so a run replays bit for bit and the wrapper still counts
// one launch a call.  A row whose keys are one split (a large batch)
// skips the workspace and the second kernel.
//
// f32 keeps decode_block (one block per (kv head, row) and 8 heads, the
// key loop on the CUDA cores): it runs only in the identity checks, where
// f32 must stay f32.  Head dims 64, 128 and 256; any G.

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
int launch_f32(const void* q, const void* k_cache, const void* v_cache,
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

// blockIdx: x = kv head * chunks + head chunk, y = row, z = split
template <int D>
__global__ void __launch_bounds__(DS_THREADS, 2) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, D)
    const __nv_bfloat16* __restrict__ k_cache,  // (B, S, KV, D)
    const __nv_bfloat16* __restrict__ v_cache,  // (B, S, KV, D)
    const int* __restrict__ lengths,            // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, H, D)
    float* __restrict__ part,                   // (B, H, splits, D + 2)
    int S, int H, int KV, int window, float scale, int split_len,
    int splits) {
    const int G = H / KV;
    const int chunks = (G + DS_HEADS - 1) / DS_HEADS;
    const int h = blockIdx.x / chunks, g0 = (blockIdx.x % chunks) * DS_HEADS;
    const int b = blockIdx.y, z = blockIdx.z;
    const int length = lengths[b];
    // visible keys, clipped to this split
    const int k_hi = min(min(length, S), (z + 1) * split_len);
    const int k_lo = max(window > 0 ? max(0, length - window) : 0,
                         z * split_len);
    const size_t head = (size_t)b * H + h * G + g0;
    extern __shared__ __align__(16) unsigned char ds_smem[];
    decode_split_block<D>(
        q + head * D, k_cache, v_cache, out + head * D,
        splits == 1 ? nullptr : part + (head * splits + z) * (D + 2),
        splits * (D + 2), min(DS_HEADS, G - g0), k_lo, k_hi, scale,
        DenseAddr<D>{b, S, KV, h}, ds_smem);
}

template <int D>
int launch_bf16(const void* q, const void* k_cache, const void* v_cache,
                const int* lengths, void* out, float* part, int B, int S,
                int H, int KV, int window, float scale, int splits,
                int split_len, cudaStream_t stream) {
    constexpr size_t smem = DsShape<D>::SMEM;
    auto kernel = decode_split_kernel<D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (H / KV + DS_HEADS - 1) / DS_HEADS;
    kernel<<<dim3(KV * chunks, B, splits), DS_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, lengths, (__nv_bfloat16*)out, part,
        S, H, KV, window, scale, split_len, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    decode_combine_kernel<D><<<B * H, DS_THREADS,
                               sizeof(float) * 2 * splits, stream>>>(
        part, (__nv_bfloat16*)out, splits);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D), caches (B, S, KV, D), lengths (B,) int32, out like q; all
// contiguous on one device, the caches 16-byte aligned.  window <= 0 means
// none.  bf16: the keys are cut into ``splits`` splits of ``split_len``
// (covering S; chosen by the wrapper), and ``part`` is a (B, H, splits,
// D + 2) f32 workspace when splits > 1; f32 ignores the three.  Returns
// cudaGetLastError() after the launches, or REPRO_UNSUPPORTED.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, void* part, int B, int S, int H, int KV,
    int D, int window, float scale, int splits, int split_len, int dtype,
    void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)k_cache | (size_t)v_cache) % 16 != 0)
        return REPRO_UNSUPPORTED;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_BF16) {
        if (splits < 1 || splits > DS_MAX_SPLITS || split_len < 1
            || (long long)splits * split_len < S
            || (splits > 1 && part == nullptr))
            return REPRO_UNSUPPORTED;
#define REPRO_CASE(DIM)                                                     \
        return launch_bf16<DIM>(q, k_cache, v_cache, len, out, (float*)part,\
                                B, S, H, KV, window, scale, splits,         \
                                split_len, st)
        if (D == 64) REPRO_CASE(64);
        if (D == 128) REPRO_CASE(128);
        if (D == 256) REPRO_CASE(256);
#undef REPRO_CASE
        return REPRO_UNSUPPORTED;
    }
    if (dtype == REPRO_F32) {
#define REPRO_CASE(DIM)                                                     \
        return launch_f32<float, DIM>(q, k_cache, v_cache, len, out, B, S, \
                                      H, KV, window, scale, st)
        if (D == 64) REPRO_CASE(64);
        if (D == 128) REPRO_CASE(128);
        if (D == 256) REPRO_CASE(256);
#undef REPRO_CASE
    }
    return REPRO_UNSUPPORTED;
}
