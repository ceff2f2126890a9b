// Fused paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py,
// function paged_decode_attention (:91, pl.pallas_call :135, Pallas body
// _decode_kernel).  One query token per batch row attends over that row's
// pages of the paged K/V pool, walking the block table inside the kernel:
// no dense pool[block_tables] copy is made, and each visible key is read
// from the pool once for all the query heads of its kv head.
//
// What bounds it on the H100: bytes.  Per key it does 4*G*D flops against
// 2*D*itemsize bytes of K/V (about 7 flops per byte in bf16 at G = 7, 10
// at G = 10), far below the ~295 flops/byte the card needs before its
// tensor cores matter.  Only the keys in [max(0, length - window),
// min(length, W * bs)) are read.  So the design is about keeping every SM
// streaming keys.
//
// Design (bf16).  The TPU kernel steps a sequential grid (B, KV, W) and
// carries the running softmax (acc, m, l) in VMEM scratch across the page
// axis.  Hopper blocks run in parallel in no order, so the key axis is
// split: a grid of (kv head x head chunk, row, split), the wrapper
// choosing the splits on the host from the shapes alone
// (decode_attention.paged_decode_splits: B, KV, G, D, the table's W * bs
// keys, the window and the SM count; no length is read back, so the call
// could be captured in a CUDA graph) so that the blocks give every SM four
// below D = 256 and one at D = 256, whose two 67 KB key stages fill the
// SM's shared memory (qwen2-0.5b's 16 seats: 16 splits of 128 keys, 512
// blocks).  A split
// covers whole DS_KT-key tiles and is placed relative to its row's lower
// bound: block z takes the keys [k_lo + z * split_len, k_lo + (z + 1) *
// split_len) clipped to k_hi, with k_lo = max(0, length - window) computed
// on the device.  So a windowed row's splits cover its window and none
// falls below it (recurrentgemma-2b: 16 rows of up to 2048 visible keys in
// a 3104-key table, 8 splits of 256 keys a row); a split past the row's
// keys writes an empty partial and exits.  Each block runs
// decode_split_block of common.cuh with a paged address: all G query
// heads of its kv head (in chunks of 16 only above G = 16) are the rows of
// mma.sync m16n8k16 products, so K/V is read once for every head (G = 10
// is one block, not two of 8 and 2 reading the window twice), and each
// thread reads the block ids of its keys of a tile before it issues their
// cp.async copies.  The splits' partials (acc, m, l in f32) go to a
// workspace the wrapper takes from its per-stream buffer, and
// decode_combine_kernel (one block a (row, head), in the same C call)
// merges them in split order, so a run replays bit for bit and the wrapper
// counts one launch a call.  A call whose plan is one split (the blocks
// alone fill the card) writes the output directly: no partials, no second
// kernel.
//
// Masking is the reference's: keys with pos >= length (or below the window)
// take no weight, and a row of length 0 writes zeros.
//
// f32 keeps decode_block (one block per (kv head, row) and 8 heads, the
// key loop on the CUDA cores, keys in [k_lo, k_hi) walked by one block):
// it runs only in the identity checks, where f32 must stay f32 (no TF32).
// Head dims 64, 128 and 256; any number of query heads per kv head.

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
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
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

// blockIdx: x = kv head * chunks + head chunk, y = row, z = split
template <int D>
__global__ void __launch_bounds__(DS_THREADS, 2) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, H, D)
    const __nv_bfloat16* __restrict__ k_pool,  // (N, bs, KV, D)
    const __nv_bfloat16* __restrict__ v_pool,  // (N, bs, KV, D)
    const int* __restrict__ tables,            // (B, W)
    const int* __restrict__ lengths,           // (B,)
    __nv_bfloat16* __restrict__ out,           // (B, H, D)
    float* __restrict__ part,                  // (B, H, splits, D + 2)
    int H, int KV, int W, int bs, int window, float scale, int split_len,
    int splits) {
    const int G = H / KV;
    const int chunks = (G + DS_HEADS - 1) / DS_HEADS;
    const int h = blockIdx.x / chunks, g0 = (blockIdx.x % chunks) * DS_HEADS;
    const int b = blockIdx.y, z = blockIdx.z;
    const int length = lengths[b];
    // the row's visible keys, then this split of them from its lower bound
    const int row_hi = min(length, W * bs);
    const int row_lo = window > 0 ? max(0, length - window) : 0;
    const int k_lo = row_lo + z * split_len;
    const int k_hi = min(row_hi, k_lo + split_len);
    const size_t head = (size_t)b * H + h * G + g0;
    extern __shared__ __align__(16) unsigned char ds_smem[];
    decode_split_block<D>(
        q + head * D, k_pool, v_pool, out + head * D,
        splits == 1 ? nullptr : part + (head * splits + z) * (D + 2),
        splits * (D + 2), min(DS_HEADS, G - g0), k_lo, k_hi, scale,
        PagedAddr<D>{tables + (size_t)b * W, bs, KV, h}, ds_smem);
}

template <int D>
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const int* tables, const int* lengths, void* out, float* part,
                int B, int H, int KV, int W, int bs, int window, float scale,
                int splits, int split_len, cudaStream_t stream) {
    constexpr size_t smem = DsShape<D>::SMEM;
    auto kernel = paged_decode_split_kernel<D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (H / KV + DS_HEADS - 1) / DS_HEADS;
    kernel<<<dim3(KV * chunks, B, splits), DS_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
        (const __nv_bfloat16*)v_pool, tables, lengths, (__nv_bfloat16*)out,
        part, H, KV, W, bs, window, scale, split_len, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    decode_combine_kernel<D><<<B * H, DS_THREADS,
                               sizeof(float) * 2 * splits, stream>>>(
        part, (__nv_bfloat16*)out, splits);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D), pools (N, bs, KV, D), tables (B, W) int32, lengths (B,)
// int32, out like q; all contiguous on one device, the pools 16-byte
// aligned.  window <= 0 means none.  bf16: each row's visible keys are cut
// into ``splits`` splits of ``split_len`` keys (whole DS_KT tiles, from the
// row's lower bound, together covering min(W * bs, window) keys windowed
// and W * bs without; chosen by the wrapper), and ``part`` is a (B, H,
// splits, D + 2) f32 workspace when splits > 1; f32 ignores the three.
// Returns cudaGetLastError() after the launches, or REPRO_UNSUPPORTED.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* part, int B, int H, int KV, int D,
    int W, int bs, int window, float scale, int splits, int split_len,
    int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)k_pool | (size_t)v_pool) % 16 != 0) return REPRO_UNSUPPORTED;
    const int* tab = (const int*)tables;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_BF16) {
        const long long keys = (long long)W * bs;
        const long long cover = window > 0 && window < keys ? window : keys;
        if (splits < 1 || splits > DS_MAX_SPLITS || split_len < DS_KT
            || split_len % DS_KT != 0
            || (long long)splits * split_len < cover
            || (splits > 1 && part == nullptr))
            return REPRO_UNSUPPORTED;
#define REPRO_CASE(DIM)                                                     \
        return launch_bf16<DIM>(q, k_pool, v_pool, tab, len, out,           \
                                (float*)part, B, H, KV, W, bs, window,      \
                                scale, splits, split_len, st)
        if (D == 64) REPRO_CASE(64);
        if (D == 128) REPRO_CASE(128);
        if (D == 256) REPRO_CASE(256);
#undef REPRO_CASE
        return REPRO_UNSUPPORTED;
    }
    if (dtype == REPRO_F32) {
#define REPRO_CASE(DIM)                                                     \
        return launch_f32<float, DIM>(q, k_pool, v_pool, tab, len, out, B, \
                                      H, KV, W, bs, window, scale, st)
        if (D == 64) REPRO_CASE(64);
        if (D == 128) REPRO_CASE(128);
        if (D == 256) REPRO_CASE(256);
#undef REPRO_CASE
    }
    return REPRO_UNSUPPORTED;
}
