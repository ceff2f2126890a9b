// The persistent bf16 grouped product of grouped_matmul.cu, shared with its
// backward (grouped_matmul_bwd.cu).  out[t] = a[t] @ B_e(t) for a (T, K)
// sorted by group, out (T, N), over a work list of (group, row tile, N
// tile) items built from the sizes on the device (grouped_matmul.cu's
// header says how).  KB picks the layout of the weights w (E, ., .):
//
//   KB = false: B_e = w[e] as it lies, (K, N) with N contiguous, read
//     MN-major (the forward: out = x @ w[e], K = D, N = F);
//   KB = true: B_e = w[e]^T, w[e] lying (N, K) with K contiguous, read
//     K-major (the backward's dx = dy @ w[e]^T, K = F, N = D): the same
//     tiles of 64 k values x 64 rows, so no transposed copy of any
//     expert's weights is made.
//
// Both read w through one tensor map of its rows, 64 x 64 boxes in the
// 128-byte swizzle: (E K, N) without KB, (E N, K) with it.  A box past K
// reads the next group's rows against a's zero columns (without KB) or
// zeros past the map's K columns (with KB); rows of B past N are the next
// group's or zeros: multiplied, never stored.
//
// STAGED picks the epilogue.  Without it (the forward's 64 x 128 tiles)
// each consumer thread stores its f32 accumulators as bf16 pairs straight
// to device memory.  With it (the forward's 128 x 256 tiles, and dx) the
// warpgroup writes its 64 x BN rows as bf16 into
// a buffer of its own in shared memory, in the 128-byte swizzle of a TMA
// box (conflict-free 4-byte stores), and one thread stores a whole tile
// with TMA (cp.async.bulk.tensor, shared to global) and goes on: the
// store drains under the next item's main loop, and the buffer is only
// waited for (bulk wait_group.read) when the next item's epilogue comes.
// A tile cut by its group's end is copied from the buffer in 16-byte rows
// instead, so that no row of the next group is written.  The buffer takes
// a ring stage's room: NS = 3.  Both stay because neither wins everywhere
// in the forward (kernel_ab.py, PERF.md section 6): at 128 x 256 (prefill)
// the staged epilogue is faster, at 64 x 128 (decode, where nearly every
// tile is cut by its group's end) the direct one with its 4-stage ring.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {

// ---- bf16: persistent, wgmma fed by TMA ----
constexpr int GW_BK = 64;
constexpr int GW_XROWS = 16;        // rows of one a box: a tile loads only
                                    // the boxes its group's rows reach

constexpr uint32_t GW_BOX = 64 * 128;  // bytes of a 64 x 64 bf16 box

template <int NC, bool STAGED = false>
struct GwShape {
    static constexpr int BM = 64 * NC;               // rows a tile
    static constexpr int BN = 128 * NC;              // columns a tile
    static constexpr int THREADS = 128 * NC + 32;    // consumers, producer
    static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
    static constexpr int NS = STAGED ? 3 : 4;        // ring stages
    static constexpr uint32_t X_BYTES = BM * GW_BK * 2;
    static constexpr uint32_t W_BYTES = GW_BK * BN * 2;
    static constexpr uint32_t STAGE = X_BYTES + W_BYTES;
    // a warpgroup's staged rows: BN / 64 boxes of 64 x 64
    static constexpr uint32_t OUT = STAGED ? BN / 64 * GW_BOX : 0;
    // the ring (1024-byte aligned), the staged rows, then the work list's
    // 2 (E + 1) ints
    static size_t smem(int E) {
        return 1024 + (size_t)NS * STAGE + (size_t)NC * OUT
             + sizeof(int) * 2 * (E + 1);
    }
};

// One work item: expert e, rows [r0, r1), columns from n0.
struct GwItem {
    int e, r0, r1, n0;
};

// Item i of the list: tile_at[e] is the first row tile of expert e (an
// exclusive prefix sum; tile_at[E] the total), row_at[e] its first row
// (row_at[e + 1] its end).  The expert is the last e with tile_at[e] <= the
// item's row tile, which skips the empty experts.
__device__ __forceinline__ GwItem gw_item(const int* tile_at,
                                          const int* row_at, int E, int nF,
                                          int BM, int BN, int i) {
    const int r = i / nF;
    int lo = 0, hi = E;
    while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (tile_at[mid] <= r) lo = mid;
        else hi = mid;
    }
    GwItem it;
    it.e = lo;
    it.r0 = row_at[lo] + (r - tile_at[lo]) * BM;
    it.r1 = min(it.r0 + BM, row_at[lo + 1]);
    it.n0 = (i % nF) * BN;
    return it;
}

// A value every thread of the warp holds, made warp-uniform in ptxas's
// eyes (a shuffle from lane 0).  A branch around wgmma or its accumulators
// that ptxas cannot prove uniform makes it serialize every wgmma of the
// kernel (its C7518 note), so the roles, the items and the loop bounds
// derived from shared memory go through this.
__device__ __forceinline__ int warp_uniform(int v) {
    return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ GwItem warp_uniform(GwItem it) {
    return {warp_uniform(it.e), warp_uniform(it.r0), warp_uniform(it.r1),
            warp_uniform(it.n0)};
}

// The work list, by the first warp: group bounds clamped to T and the row
// tiles of BM rows of each expert, prefix-summed 32 experts at a time.
__device__ __forceinline__ void gw_work_list(const int* __restrict__ sizes,
                                             int E, int T, int BM,
                                             int* tile_at, int* row_at) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int rows = 0, tiles = 0;                  // before this chunk of 32
    for (int c0 = 0; c0 < E; c0 += 32) {
        const int e = c0 + lane;
        const int n = e < E ? max(sizes[e], 0) : 0;
        int rs = n;                           // inclusive scan of sizes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, rs, off);
            if (lane >= off) rs += t;
        }
        const int lo = min(rows + rs - n, T), hi = min(rows + rs, T);
        const int nt = (hi - lo + BM - 1) / BM;
        int ts = nt;                          // inclusive scan of row tiles
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, ts, off);
            if (lane >= off) ts += t;
        }
        if (e < E) {
            row_at[e] = lo;
            tile_at[e] = tiles + ts - nt;
        }
        rows += __shfl_sync(0xffffffffu, rs, 31);
        tiles += __shfl_sync(0xffffffffu, ts, 31);
    }
    if (lane == 0) {
        row_at[E] = min(rows, T);
        tile_at[E] = tiles;
    }
}

// acc (64 x BN, f32) (+)= a b: one k16 step of a consumer warpgroup, a
// MN-major with TA, b MN-major with TB (else K-major)
template <int BN, int TA, int TB>
__device__ __forceinline__ void gw_mma(float (&acc)[BN / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
    if constexpr (BN == 128) wgmma_ss_mn128<TA, TB>(acc, a, b, accumulate);
    else wgmma_ss_mn256<TA, TB>(acc, a, b, accumulate);
}

// Rows [row0, row0 + 64) of a consumer warpgroup's accumulator (64 x BN,
// f32) to out (ld columns a row, bf16) at column n0: acc[4 j + 2 i + c] is
// row 16 warp + gid + 8 i, column 8 j + 2 tig + c.  Rows from row_end and
// columns from n_end are not stored (n_end even).
template <int BN>
__device__ __forceinline__ void gw_store(const float (&acc)[BN / 2],
                                         __nv_bfloat16* __restrict__ out,
                                         long long ld, int row0, int row_end,
                                         int n0, int n_end) {
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
        const int row = row0 + 16 * warp + gid + 8 * i2;
        if (row >= row_end) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int f = n0 + 8 * j + 2 * tig;
            if (f < n_end)
                *reinterpret_cast<__nv_bfloat162*>(
                    out + (long long)row * ld + f) = __floats2bfloat162_rn(
                    acc[4 * j + 2 * i2], acc[4 * j + 2 * i2 + 1]);
        }
    }
}

// TMA stores from shared memory: the box at shared address src to a 2D /
// 3D tensor map's (c0 innermost, ...), in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const void* map, int c0, int c1,
                                             uint32_t src) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%1, %2}], [%3];\n"
        :: "l"(map), "r"(c0), "r"(c1), "r"(src) : "memory");
}
__device__ __forceinline__ void tma_store_3d(const void* map, int c0, int c1,
                                             int c2, uint32_t src) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%1, %2, %3}], [%4];\n"
        :: "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(src) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// every bulk store this thread committed has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and has completed its writes
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A consumer warpgroup's accumulator (64 x BN, f32; acc[4 j + 2 i + c] row
// 16 warp + gid + 8 i, column 8 j + 2 tig + c) as bf16 into BN / 64 boxes
// of 64 x 64 at shared address buf (1024-byte aligned, GW_BOX apart) in
// the 128-byte swizzle: a row's 16-byte chunk ch at chunk ch ^ (row % 8),
// row % 8 being gid.  A warp's store covers 8 rows x 4 words, 32 distinct
// banks.  32-bit shared addresses: the consumers have no registers to
// spare for generic pointers.
template <int BN>
__device__ __forceinline__ void gw_stage(const float (&acc)[BN / 2],
                                         uint32_t buf) {
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
        const uint32_t row = buf + (16 * warp + gid + 8 * i2) * 128 + 4 * tig;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * i2],
                                                     acc[4 * j + 2 * i2 + 1]);
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(row + (j / 8) * GW_BOX
                                + (((j % 8) ^ gid) * 16)),
                            "r"(*reinterpret_cast<uint32_t*>(&v))
                         : "memory");
        }
    }
}

// The staged epilogue (STAGED): rows [row0, row0 + 64) of out (ld columns
// a row) at column n0 from a warpgroup's accumulator through its buffer
// buf; rows from row_end and columns from n_end are not stored.  Named
// barrier ``bar`` is the warpgroup's own.
template <int BN>
__device__ __forceinline__ void gw_store_staged(
    const float (&acc)[BN / 2], const CUtensorMap* out_map,
    __nv_bfloat16* __restrict__ out, long long ld, int row0, int row_end,
    int n0, int n_end, unsigned char* buf, int bar) {
    const int t = threadIdx.x % 128;
    if (t == 0) bulk_wait_read();      // the last tile's store has read buf
    named_barrier(bar, 128);
    gw_stage<BN>(acc, smem_u32(buf));
    fence_proxy_async();               // buf's writes, before TMA reads them
    named_barrier(bar, 128);
    const int rows = min(64, row_end - row0);
    if (rows == 64) {
        if (t == 0) {
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
                if (n0 + 64 * b < n_end)
                    tma_store_2d(out_map, n0 + 64 * b, row0,
                                 smem_u32(buf) + b * GW_BOX);
            bulk_commit();
        }
        return;
    }
    // a tile cut by its group: 16-byte rows of the buffer, masked
    constexpr int CH = BN / 8;         // 16-byte chunks a row
    for (int c = t; c < rows * CH; c += 128) {
        const int r = c / CH, ch = c % CH, col = n0 + 8 * ch;
        if (col < n_end)
            *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ld + col) =
                *reinterpret_cast<const uint4*>(
                    buf + (ch / 8) * GW_BOX + r * 128
                    + (((ch % 8) ^ (r % 8)) * 16));
    }
}

template <int NC, bool KB, bool STAGED>
__global__ void __launch_bounds__(GwShape<NC, STAGED>::THREADS,
                                  GwShape<NC, STAGED>::MIN_BLOCKS)
grouped_matmul_bf16_kernel(
    const __grid_constant__ CUtensorMap a_map,   // a (T, K): boxes 64 x 16
    const __grid_constant__ CUtensorMap w_map,   // w rows: boxes 64 x 64
    const __grid_constant__ CUtensorMap out_map, // out (T, N): 64 x 64
                                                 // boxes (STAGED only)
    const int* __restrict__ sizes,               // (E,)
    __nv_bfloat16* __restrict__ out,             // (T, N)
    int T, int K, int N, int E) {
    using Sh = GwShape<NC, STAGED>;
    constexpr int BM = Sh::BM, BN = Sh::BN, NS = Sh::NS;
    constexpr uint32_t STAGE = Sh::STAGE, X_BYTES = Sh::X_BYTES;
    using TX = WgTile<GW_BK>;                 // a rows: 64 k values
    __shared__ uint64_t full[NS], empty[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* tiles = smem_raw + (base - raw);
    unsigned char* staged = tiles + NS * STAGE;    // STAGED: NC buffers
    int* tile_at = reinterpret_cast<int*>(staged + NC * Sh::OUT);
    int* row_at = tile_at + E + 1;

    gw_work_list(sizes, E, T, BM, tile_at, row_at);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 1);            // the producer's expect_tx
            mbar_init(&empty[s], 4 * NC);      // one a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int nF = (N + BN - 1) / BN, nk = (K + GW_BK - 1) / GW_BK;
    const int items = warp_uniform(tile_at[E]) * nF;
    const int wg = warp_uniform(threadIdx.x / 128);   // NC: the producer

    if (wg == NC) {
        // ---- producer: one thread issues every stage's TMA boxes ----
        if (threadIdx.x != 128 * NC) return;
        int step = 0;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
            const GwItem it = gw_item(tile_at, row_at, E, nF, BM, BN, i);
            // a boxes that reach the group's rows (rows past it and past T
            // come in as the next group's or zeros: multiplied, not stored);
            // weight boxes that reach N
            const int xb = (it.r1 - it.r0 + GW_XROWS - 1) / GW_XROWS;
            const int wb = min(BN, N - it.n0 + 63) / 64;
            const uint32_t bytes = (xb * GW_XROWS + wb * GW_BK) * 128;
            for (int kt = 0; kt < nk; ++kt, ++step) {
                const int s = step % NS;
                if (step >= NS)
                    mbar_wait(&empty[s], ((step / NS) - 1) & 1);
                unsigned char* xs = tiles + s * STAGE;
                unsigned char* ws = xs + X_BYTES;
                mbar_arrive_expect_tx(&full[s], bytes);
                for (int b = 0; b < xb; ++b)
                    tma_load_2d(xs + b * GW_XROWS * 128, &a_map, kt * GW_BK,
                                it.r0 + b * GW_XROWS, &full[s]);
                // without KB: w rows e K + k (past K: the next expert's,
                // against a's zero columns), 64 columns n a box; with KB:
                // w rows e N + n, 64 columns k a box (zeros past K)
                for (int b = 0; b < wb; ++b) {
                    if constexpr (KB)
                        tma_load_2d(ws + b * (GW_BK * 128), &w_map,
                                    kt * GW_BK, it.e * N + it.n0 + b * 64,
                                    &full[s]);
                    else
                        tma_load_2d(ws + b * (GW_BK * 128), &w_map,
                                    it.n0 + b * 64, it.e * K + kt * GW_BK,
                                    &full[s]);
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile ----
    const int lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int step = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const GwItem it = warp_uniform(
            gw_item(tile_at, row_at, E, nF, BM, BN, i));
        const bool live = it.r0 + 64 * wg < it.r1;    // warpgroup-uniform
        for (int kt = 0; kt < nk; ++kt, ++step) {
            const int s = step % NS;
            mbar_wait(&full[s], (step / NS) & 1);
            if (!live) {                   // nothing to multiply: release
                if (lane == 0) mbar_arrive(&empty[s]);
                continue;
            }
            const uint32_t xa = base + s * STAGE + wg * (64 * 128);
            const uint32_t wa = base + s * STAGE + X_BYTES;
            wg_pin(acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < GW_BK / 16; ++kk) {
                // without KB, B is 16 k rows from kk * 16 (two 8-row groups
                // 1024 bytes apart), its 64-value column blocks 64 x 128
                // bytes apart; with KB, BN rows of 64 k values, as a's
                const uint64_t b = KB
                    ? TX::template desc<BN>(wa, kk * 16)
                    : wg_desc(wa + kk * 2048, GW_BK * 128, 1024, 1);
                gw_mma<BN, 0, KB ? 0 : 1>(
                    acc, TX::template desc<64>(xa, kk * 16), b,
                    kt > 0 || kk > 0);
            }
            wg_commit();
            wg_wait<1>();                  // step - 1's products are done
            wg_pin(acc);
            if (kt > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        }
        if (!live) continue;
        wg_wait<0>();
        wg_pin(acc);
        if (lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        if constexpr (STAGED)
            gw_store_staged<BN>(acc, &out_map, out, N, it.r0 + 64 * wg,
                                it.r1, it.n0, N, staged + wg * Sh::OUT,
                                2 + wg);
        else
            gw_store<BN>(acc, out, N, it.r0 + 64 * wg, it.r1, it.n0, N);
    }
    if constexpr (STAGED)
        if (threadIdx.x % 128 == 0) bulk_wait();   // before buf goes away
}

// A bf16 (rows, cols) row-major map with boxes of box_rows x 64 values in
// the 128-byte swizzle of WgTile; reads past the edges fill zeros.
int bf16_map(CUtensorMap* map, const void* base, long long rows, int cols,
             int box_rows) {
    EncodeTiled encode;
    const int rc = encode_tiled(encode);
    if (rc != 0) return rc;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : REPRO_UNSUPPORTED;
}

// Blocks of a persistent launch of Kernel: as many as fit on the card at
// once (threads and smem a block), and no more than ``items``.  The SM
// count and the blocks an SM are read once a device and shared-memory
// size, for each kernel.
template <auto Kernel>
int persistent_grid(int threads, size_t smem, long long items, int& grid) {
    static int cached_dev = -1, cached_sms = 0, cached_per_sm = 0;
    static size_t cached_smem = 0;
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev != cached_dev || smem != cached_smem) {
        int sms, per_sm;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, Kernel, threads, smem);
        if (err != cudaSuccess) return (int)err;
        cached_dev = dev;
        cached_sms = sms;
        cached_per_sm = per_sm;
        cached_smem = smem;
    }
    grid = (int)std::min(std::max(items, 1ll),
                         (long long)std::max(1, cached_per_sm) * cached_sms);
    return 0;
}

// out (T, N) = a (T, K) grouped against w (see the header: KB), all bf16,
// on ``stream``; the work list's items are every group's rows in whole
// tiles plus one partial tile for each non-empty group.  STAGED: the
// epilogue through shared memory and TMA stores (the header).
template <int NC, bool KB, bool STAGED = false>
int launch_grouped_bf16(const void* a, const void* w, const int* sizes,
                        void* out, int T, int K, int N, int E,
                        cudaStream_t stream) {
    using Sh = GwShape<NC, STAGED>;
    const size_t smem = Sh::smem(E);
    auto kernel = grouped_matmul_bf16_kernel<NC, KB, STAGED>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long items = ((long long)(T + Sh::BM - 1) / Sh::BM
                             + std::min(E, T)) * ((N + Sh::BN - 1) / Sh::BN);
    int grid;
    CUtensorMap a_map, w_map, out_map{};
    int rc = persistent_grid<grouped_matmul_bf16_kernel<NC, KB, STAGED>>(
        Sh::THREADS, smem, items, grid);
    if (rc == 0) rc = bf16_map(&a_map, a, T, K, GW_XROWS);
    if (rc == 0)
        rc = KB ? bf16_map(&w_map, w, (long long)E * N, K, GW_BK)
                : bf16_map(&w_map, w, (long long)E * K, N, GW_BK);
    if (rc == 0 && STAGED) rc = bf16_map(&out_map, out, T, N, 64);
    if (rc != 0) return rc;
    kernel<<<grid, Sh::THREADS, smem, stream>>>(
        a_map, w_map, out_map, sizes, (__nv_bfloat16*)out, T, K, N, E);
    return (int)cudaGetLastError();
}

// ---- f32: FMA tiles of GF_BM x GF_BN outputs, GF_BK deep, 256 threads
// of 4 x 4 outputs each ----
constexpr int GF_BM = 64, GF_BN = 64, GF_BK = 16, GF_THREADS = 256;

// This block's group [lo, hi) of rows: the first warp sums the sizes
// before expert e (the exclusive cumsum) with shuffles; rows clamped to T.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes,
                                           int e, int E, int T, int& lo,
                                           int& hi) {
    __shared__ int bounds[2];
    if (threadIdx.x < 32) {
        int before = 0, mine = 0;
        for (int i = threadIdx.x; i < E; i += 32) {
            const int n = sizes[i];
            before += i < e ? n : 0;
            mine += i == e ? n : 0;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            before += __shfl_xor_sync(0xffffffffu, before, off);
            mine += __shfl_xor_sync(0xffffffffu, mine, off);
        }
        if (threadIdx.x == 0) {
            bounds[0] = min(before, T);
            bounds[1] = min(before + mine, T);
        }
    }
    __syncthreads();
    lo = bounds[0];
    hi = bounds[1];
}

}  // namespace
