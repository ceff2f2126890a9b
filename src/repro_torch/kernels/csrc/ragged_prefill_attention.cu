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
// flops, so the arithmetic, not the bytes, is the floor.  This first
// version runs that arithmetic as f32 FMAs out of shared memory, not on the
// tensor cores, so it sits far above the bf16 tensor-core bound; wgmma and
// TMA staging are the later change.
//
// Design.  The TPU kernel steps a sequential grid (P, KV, W) and carries
// (acc, m, l) for all C x G query rows in VMEM across the page axis.  Here
// one thread block takes one (query-row tile, kv head, row) and walks the
// row's keys itself: prefill_block of common.cuh (one query row per
// thread, key tiles staged in shared memory, f32 online softmax), shared
// with flash_attention.cu; here its address functor finds each key's block
// id in the row's table, and a filler row returns before reading anything.
// Head dims 64, 128 and 256; at 256 a thread's q row and accumulator (512
// floats) exceed the 255 registers a thread may hold and spill to local
// memory: correct, and slow until the tensor-core body takes bf16.

#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(PRE_THREADS) ragged_prefill_kernel(
    const T* __restrict__ q,           // (P, C, H, D)
    const T* __restrict__ k_pool,      // (N, bs, KV, D)
    const T* __restrict__ v_pool,      // (N, bs, KV, D)
    const int* __restrict__ tables,    // (P, W)
    const int* __restrict__ starts,    // (P,)
    const int* __restrict__ limits,    // (P,)
    T* __restrict__ out,               // (P, C, H, D)
    int C, int H, int KV, int W, int bs, int window, float scale) {
    const int h = blockIdx.y;
    const int p = blockIdx.z;
    const int G = H / KV;
    const int r0 = blockIdx.x * PRE_THREADS;
    const size_t row = (size_t)p * C * H * D;

    if (limits[p] <= 0) {              // filler row: exact zeros, no reads
        const int r = r0 + threadIdx.x;
        if (r < C * G) {
            T* o = out + row + ((size_t)(r / G) * H + h * G + r % G) * D;
            for (int d = 0; d < D; ++d) o[d] = from_f<T>(0.f);
        }
        return;
    }
    extern __shared__ float smem[];
    const PagedAddr<D> addr{tables + (size_t)p * W, bs, KV, h};
    prefill_block<T, D, D>(q + row, k_pool, v_pool, out + row, C, H, G, h,
                           r0, starts[p], W * bs, true, window, scale, addr,
                           addr, smem);
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* starts, const int* limits, void* out,
           int P, int C, int H, int KV, int W, int bs, int window, float scale,
           cudaStream_t stream) {
    constexpr size_t smem = pre_smem_bytes<D, D>();
    auto kernel = ragged_prefill_kernel<T, D>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (C * (H / KV) + PRE_THREADS - 1) / PRE_THREADS;
    kernel<<<dim3(tiles, KV, P), PRE_THREADS, smem, stream>>>(
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
    if (dtype == REPRO_F32 && D == 256) REPRO_CASE(float, 256);
    if (dtype == REPRO_BF16 && D == 256) REPRO_CASE(__nv_bfloat16, 256);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
