// Dense blockwise GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py, function
// flash_attention (:87, Pallas body _kernel :32-84).  Queries (B, Sq, H,
// DK) at absolute positions q_offset[b] + [0, Sq) attend over keys (B, Sk,
// KV, DK) at positions [0, Sk) with values (B, Sk, KV, DV) (DK != DV for
// MLA's decompressed heads, whose keys carry the rope dims too): causal
// (kp <= qp) unless asked otherwise, and, windowed, qp - kp < window;
// (acc, m, l) in f32, NEG_INF = -1e30 scores
// and a 1e-30 denominator floor as in the reference.  It is the attention
// of the dense prefill (Generator, forward) with q_offset 0, and of the
// composed paged prefill with one offset per row (flash_rows: P rows in one
// launch, the Pallas kernel's static q_offset made a per-row tensor).
// (DK, DV) pairs built: (64, 64), (128, 128) and (256, 256) for GQA heads
// (the last recurrentgemma-2b's, whose tensor-core tiles take 67.6 KB of
// shared memory, reserved at launch; its f32 FMA body spills the 512-float
// q row and accumulator to local memory), (192, 128) for
// deepseek-v2-lite's MLA (128 nope + 64 rope dims) and (96, 64) for its
// reduced test config.
//
// What bounds it on the H100: operations.  At the dense prefill shapes
// (B = 4, Sq = Sk = 1024, H = 14, KV = 2, D = 64) the causal pairs need
// 7.5 GFLOP against 17 MB moved (queries, keys, values and output once
// each), about 450 flops per byte in bf16, above the card's ~295, and the
// ratio grows with the sequence length.  So bf16 runs on the tensor cores.
//
// Design.  The TPU kernel steps a sequential grid (B*KV, Sq/bq, Sk/bk),
// carries (acc, m, l) in VMEM across the key axis and skips blocks above
// the diagonal or outside the window.  Here one thread block takes one
// (query-row tile, kv head, batch row) and loops over the keys itself,
// with the dense addresses ((b*Sk + pos)*KV + h)*DK (keys) and *DV
// (values), and Sk as the keys'
// reach.  Keys beyond the tile's causal reach, or wholly below its window,
// are never read.  bf16 takes prefill_block_mma of common.cuh: 64 query
// rows per block, 16 per warp, mma.sync for Q K^T and for P V (P fed as
// two bf16 halves, so the result keeps f32-level accuracy), an f32 online
// softmax on the accumulators.  f32 takes prefill_block, the FMA body of
// ragged_prefill_attention.cu (one query row per thread), since the
// tensor cores' f32 input (TF32) keeps 10 bits.  A query with no visible
// key writes zeros (the oracle's is the mean of V; no causal query of the
// callers has none).  Next: ldmatrix fragment loads, a double-buffered
// cp.async or TMA tile ring, then wgmma.

#include "common.cuh"

namespace {

// Launch shape of each body: the tensor-core one for bf16, FMAs for f32.
template <typename T, int DK, int DV>
struct Body {
    static constexpr int THREADS = PRE_THREADS, ROWS = PRE_THREADS;
    static constexpr size_t SMEM = pre_smem_bytes<DK, DV>();
};
template <int DK, int DV>
struct Body<__nv_bfloat16, DK, DV> {
    static constexpr int THREADS = MMA_THREADS, ROWS = MMA_ROWS;
    static constexpr size_t SMEM = mma_smem_bytes<DK, DV>();
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Body<T, DK, DV>::THREADS) flash_kernel(
    const T* __restrict__ q,           // (B, Sq, H, DK)
    const T* __restrict__ k,           // (B, Sk, KV, DK)
    const T* __restrict__ v,           // (B, Sk, KV, DV)
    const int* __restrict__ q_offsets, // (B,) or null: q_offset for all
    int q_offset,
    T* __restrict__ out,               // (B, Sq, H, DV)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int G = H / KV;
    const size_t rows = (size_t)b * Sq * H;
    const int start = q_offsets != nullptr ? q_offsets[b] : q_offset;
    const int r0 = blockIdx.x * Body<T, DK, DV>::ROWS;
    const DenseAddr<DK> kaddr{b, Sk, KV, h};
    const DenseAddr<DV> vaddr{b, Sk, KV, h};
    extern __shared__ __align__(16) unsigned char smem[];
    if constexpr (sizeof(T) == 2)
        prefill_block_mma<DK, DV>(q + rows * DK, k, v, out + rows * DV, Sq,
                                  H, G, h, r0, start, Sk, causal != 0,
                                  window, scale, kaddr, vaddr,
                                  reinterpret_cast<__nv_bfloat16*>(smem));
    else
        prefill_block<T, DK, DV>(q + rows * DK, k, v, out + rows * DV, Sq, H,
                                 G, h, r0, start, Sk, causal != 0, window,
                                 scale, kaddr, vaddr,
                                 reinterpret_cast<float*>(smem));
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const int* q_offsets,
           int q_offset, void* out, int B, int Sq, int Sk, int H, int KV,
           int causal, int window, float scale, cudaStream_t stream) {
    using Bd = Body<T, DK, DV>;
    auto kernel = flash_kernel<T, DK, DV>;
    cudaError_t err = reserve_smem(kernel, Bd::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (Sq * (H / KV) + Bd::ROWS - 1) / Bd::ROWS;
    kernel<<<dim3(tiles, KV, B), Bd::THREADS, Bd::SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_offsets, q_offset, (T*)out,
        Sq, Sk, H, KV, causal, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, DK), k (B, Sk, KV, DK), v (B, Sk, KV, DV), out (B, Sq, H,
// DV); q_offsets (B,) int32 or null (then q_offset applies to every row);
// all contiguous on one device, k and v 16-byte aligned.  window <= 0 means
// none.  Returns cudaGetLastError() after the launch, or REPRO_UNSUPPORTED
// for a (dtype, DK, DV) no kernel was built for.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    int q_offset, void* out, int B, int Sq, int Sk, int H, int KV, int DK,
    int DV, int causal, int window, float scale, int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)k | (size_t)v) % 16 != 0) return REPRO_UNSUPPORTED;
    const int* offs = (const int*)q_offsets;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DIMK, DIMV)                                               \
    if (DK == DIMK && DV == DIMV) {                                          \
        if (dtype == REPRO_F32)                                              \
            return launch<float, DIMK, DIMV>(q, k, v, offs, q_offset, out,  \
                                             B, Sq, Sk, H, KV, causal,       \
                                             window, scale, st);             \
        if (dtype == REPRO_BF16)                                             \
            return launch<__nv_bfloat16, DIMK, DIMV>(                        \
                q, k, v, offs, q_offset, out, B, Sq, Sk, H, KV, causal,      \
                window, scale, st);                                          \
    }
    REPRO_CASE(64, 64)
    REPRO_CASE(128, 128)
    REPRO_CASE(256, 256)
    REPRO_CASE(192, 128)
    REPRO_CASE(96, 64)
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
