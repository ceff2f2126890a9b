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
// (the last recurrentgemma-2b's, whose f32 FMA body spills the 512-float q
// row and accumulator to local memory), (192, 128) for deepseek-v2-lite's
// MLA (128 nope + 64 rope dims) and (96, 64) for its reduced test config.
//
// What bounds it on the H100: the visible work is operations-bound (at
// B = 8, Sq = Sk = 1024, H = 14, KV = 2, D = 64 the causal pairs need 15
// GFLOP against 34 MB moved, ~450 flops a byte against the card's ~295),
// but the kernel is not: its time goes to the serial chain of each key tile
// (S = Q K^T, a wait, the softmax on the CUDA cores, P V in three bf16
// parts, a wait) and at (256, 256) also to L2: every 64-row tile re-reads
// its keys, 64 KB a tile.
//
// Design.  The TPU kernel steps a sequential grid (B*KV, Sq/bq, Sk/bk),
// carries (acc, m, l) in VMEM across the key axis and skips blocks above
// the diagonal or outside the window.  Here one thread block takes one
// (query-row tile, kv head, batch row) and loops over the keys itself,
// with the dense addresses ((b*Sk + pos)*KV + h)*DK (keys) and *DV
// (values), and Sk as the keys' reach.  Keys beyond the tile's causal
// reach, or wholly below its window, are never read.  bf16 takes
// prefill_block_wgmma of common.cuh, shared with the ragged prefill: a
// producer warpgroup keeps a ring of K/V tiles in flight with cp.async
// behind mbarriers while one consumer warpgroup runs Q K^T and P V on
// wgmma (P as three bf16 parts, so the result keeps f32-level accuracy)
// and the online softmax on the accumulators.  Dense K/V could be read
// with a TMA tensor map, but the paged pool cannot (a gather of 16-key
// pages), and one copy path keeps one body.  The tiles are taken in
// reverse along the grid, so the query tiles that reach the most keys
// start first.  f32 takes prefill_block, the FMA body (one query row per
// thread), since the tensor cores' f32 input (TF32) keeps 10 bits.  A
// query with no visible key writes zeros (the oracle's is the mean of V;
// no causal query of the callers has none).
//
// With a non-null ``lse`` the kernel also writes each query row's
// log-sum-exp of its scaled scores, (B, H, Sq) f32 in natural-log units
// (the bf16 body keeps its running max in log2 units and converts once at
// the end), which the backward (flash_attention_bwd.cu) recomputes P from;
// a query with no visible key gets +inf there, so its P is 0.  The serving
// callers pass null and run the instantiations without it (the LSE flag),
// which compile as before; with it, only the pairs the backward takes are
// built: (64, 64), (128, 128), (192, 128), (96, 64) and (256, 256).

#include "common.cuh"

namespace {

// Launch shape of each body: the Hopper tensor-core one for bf16 (two
// warpgroups, 128 registers a thread at launch, rebalanced inside), FMAs
// for f32.
template <typename T, int DK, int DV>
struct Body {
    static constexpr int THREADS = PRE_THREADS, ROWS = PRE_THREADS;
    static constexpr int MIN_BLOCKS = 1;
    static constexpr size_t SMEM = pre_smem_bytes<DK, DV>();
};
template <int DK, int DV>
struct Body<__nv_bfloat16, DK, DV> {
    static constexpr int THREADS = WG_THREADS, ROWS = WG_ROWS;
    static constexpr int MIN_BLOCKS = WgShape<DK, DV>::MIN_BLOCKS;
    static constexpr size_t SMEM = WgShape<DK, DV>::SMEM;
};

// Grid (kv head, batch row, query tile), the tiles in reverse: blocks start
// in blockIdx order, so the last query tiles, which reach the most keys,
// start first and the short ones fill in behind them.
template <typename T, int DK, int DV, bool LSE>
__global__ void __launch_bounds__(Body<T, DK, DV>::THREADS,
                                  Body<T, DK, DV>::MIN_BLOCKS)
flash_kernel(
    const T* __restrict__ q,           // (B, Sq, H, DK)
    const T* __restrict__ k,           // (B, Sk, KV, DK)
    const T* __restrict__ v,           // (B, Sk, KV, DV)
    const int* __restrict__ q_offsets, // (B,) or null: q_offset for all
    int q_offset,
    T* __restrict__ out,               // (B, Sq, H, DV)
    float* __restrict__ lse,           // (B, H, Sq) or null
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / KV;
    const size_t rows = (size_t)b * Sq * H;
    const int start = q_offsets != nullptr ? q_offsets[b] : q_offset;
    const int r0 = (gridDim.z - 1 - blockIdx.z) * Body<T, DK, DV>::ROWS;
    const DenseAddr<DK> kaddr{b, Sk, KV, h};
    const DenseAddr<DV> vaddr{b, Sk, KV, h};
    float* lse_rows = LSE ? lse + rows : nullptr;
    extern __shared__ __align__(16) unsigned char smem[];
    if constexpr (sizeof(T) == 2)
        prefill_block_wgmma<DK, DV, LSE>(q + rows * DK, k, v,
                                         out + rows * DV,
                                    Sq, H, G, h, r0, start, Sk, causal != 0,
                                    window, scale, kaddr, vaddr, smem,
                                    lse_rows);
    else
        prefill_block<T, DK, DV, LSE>(q + rows * DK, k, v, out + rows * DV,
                                      Sq, H,
                                 G, h, r0, start, Sk, causal != 0, window,
                                 scale, kaddr, vaddr,
                                 reinterpret_cast<float*>(smem), lse_rows);
}

template <typename T, int DK, int DV, bool LSE>
int launch(const void* q, const void* k, const void* v, const int* q_offsets,
           int q_offset, void* out, float* lse, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, float scale, cudaStream_t stream) {
    using Bd = Body<T, DK, DV>;
    auto kernel = flash_kernel<T, DK, DV, LSE>;
    cudaError_t err = reserve_smem(kernel, Bd::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (Sq * (H / KV) + Bd::ROWS - 1) / Bd::ROWS;
    kernel<<<dim3(KV, B, tiles), Bd::THREADS, Bd::SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_offsets, q_offset, (T*)out,
        lse, Sq, Sk, H, KV, causal, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, DK), k (B, Sk, KV, DK), v (B, Sk, KV, DV), out (B, Sq, H,
// DV); lse (B, H, Sq) f32 or null (the backward's row log-sum-exp);
// q_offsets (B,) int32 or null (then q_offset applies to every row);
// all contiguous on one device, q, k and v 16-byte aligned.  window <= 0 means
// none.  Returns cudaGetLastError() after the launch, or REPRO_UNSUPPORTED
// for a (dtype, DK, DV, lse or not) no kernel was built for.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    int q_offset, void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
    int DK, int DV, int causal, int window, float scale, int dtype,
    void* stream) {
    if (KV <= 0 || H % KV != 0) return REPRO_UNSUPPORTED;
    if (((size_t)q | (size_t)k | (size_t)v) % 16 != 0)
        return REPRO_UNSUPPORTED;
    const int* offs = (const int*)q_offsets;
    float* lse_f = (float*)lse;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DIMK, DIMV, LSE)                                          \
    if (DK == DIMK && DV == DIMV && (lse_f != nullptr) == LSE) {             \
        if (dtype == REPRO_F32)                                              \
            return launch<float, DIMK, DIMV, LSE>(                           \
                q, k, v, offs, q_offset, out, lse_f, B, Sq, Sk, H, KV,       \
                causal, window, scale, st);                                  \
        if (dtype == REPRO_BF16)                                             \
            return launch<__nv_bfloat16, DIMK, DIMV, LSE>(                   \
                q, k, v, offs, q_offset, out, lse_f, B, Sq, Sk, H, KV,       \
                causal, window, scale, st);                                  \
    }
    REPRO_CASE(64, 64, false)
    REPRO_CASE(128, 128, false)
    REPRO_CASE(256, 256, false)
    REPRO_CASE(192, 128, false)
    REPRO_CASE(96, 64, false)
    REPRO_CASE(64, 64, true)
    REPRO_CASE(128, 128, true)
    REPRO_CASE(192, 128, true)
    REPRO_CASE(96, 64, true)
    REPRO_CASE(256, 256, true)
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
