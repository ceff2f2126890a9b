// Ragged grouped matmul (MoE expert compute) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py, function
// grouped_matmul (:58, Pallas body _kernel :30-55).  out[t] = x[t] @
// w[expert_of(t)] for x (T, D) sorted by expert, w (E, D, F) and
// group_sizes (E,) int32 on the device (groups may be empty; row t belongs
// to expert e when offs[e] <= t < offs[e + 1], offs the exclusive cumsum).
// Sums in f32, one rounding to x's type.
//
// What bounds it on the H100: at serving shapes, bytes.  A decode step
// routes 16 tokens x top-6 = 96 rows over ~47 of the 64 experts: each
// non-empty expert's (D, F) weight is read for a handful of rows, 2
// flops per weight element read (2 bytes in bf16), far below the ~295
// flops per byte the card needs before its tensor cores matter.  A 4 x
// 256-token prefill call (6144 rows, ~96 per expert) reads 369 MB of
// weights for 35 GFLOP: still bytes (0.123 ms of bytes against 0.036 ms of
// tensor work).  So every weight byte of a non-empty expert is read once
// per launch, none of an empty one, and enough of them are in flight on
// every SM for the whole launch.  At decode the weights come as 128-byte
// rows of 64-row boxes at a 2816-byte stride; the kernel reaches ~2.2 TB/s
// there, as torch._grouped_mm does (PERF.md section 6).
//
// Design (bf16).  The TPU kernel steps a sequential grid (token tile,
// expert) and accumulates each output tile across the experts that overlap
// it, in VMEM scratch.  Here a persistent grid (as many blocks as fit on
// the card at once, no more than there can be items) walks a work list of
// (expert, row tile, F tile) items, item i to block i % gridDim.x.  Every
// block builds the list itself from the sizes on the device (no host
// sync): its first warp prefix-sums the clamped group bounds and each
// expert's row tiles into shared memory, and an item finds its expert by a
// binary search there; an empty expert adds no item.  So no wave is half
// empty, and the case where every row goes to one expert is 48 row tiles
// over that expert's weights, which stay in L2.  Items are ordered row
// tile major, so the blocks that run at once share their x tile in L2.
//
// A block is NC consumer warpgroups and one producer warp.  NC = 1 (tiles
// of 64 rows x 128 columns, two blocks an SM) when the rows an expert gets
// on average, T / E, the one thing the host knows without a sync, are at
// most 64, as at decode; NC = 2 (128 x 256, one block an SM) above, so that
// a prefill call's ~96 rows an expert take one tile, its weights are read
// once, and its x tile is read from L2 once per 256 columns (at 128, the
// x tiles move as many bytes from L2 into the SMs as the weights do).
// The producer's one thread keeps a ring of NS (4) stages full with TMA,
// each the x tile (BM x 64) and the weight tile (64 x BN) of one 64-deep k
// step, behind mbarriers (full: the stage's bytes have landed; empty: each
// consumer warp is done with it), and runs ahead across items, so one
// item's epilogue overlaps the next one's loads.  TMA and not cp.async: a
// producer warpgroup issuing 16-byte cp.async holds registers the 128 x
// 256 tile needs (with it and 128 x 128 tiles a prefill call's launch took
// 0.194-0.208 ms; with TMA and 128 x 256, 0.160, on an H100,
// kernel_ab.py); the tensor maps (x as (T, D), w as (E D, F), 128-byte swizzle, the
// layout of WgTile) are encoded on the host each launch through
// cudaGetDriverEntryPoint, since build.py links no libcuda.  x comes in
// boxes of 16 rows, only those its group's rows reach (at decode ~2 rows an
// expert: one box); rows past the group in a box are the next group's, or
// zeros past T, and rows past the boxes keep what the stage held: all are
// multiplied but never stored.  Weight boxes past F are not loaded;
// reads past D take the next expert's rows against x's zero columns.
//
// Each consumer warpgroup owns 64 rows of the tile and runs wgmma
// m64nBNk16 (wgmma_ss_mn128 / wgmma_ss_mn256, common.cuh): A the x tile,
// K-major; B the weight tile as it lies in memory, MN-major (its (d, f)
// rows with f contiguous, the transpose bit set), its 64-value column
// blocks one leading byte offset apart.  A stage is released once the
// wgmma group that reads it has completed (wait_group 1, one group in
// flight behind the issue).  f32 accumulators, rounded once to bf16 and
// stored for the rows inside the group and the columns inside F; a
// warpgroup whose rows all lie past the group only releases its stages.
// Each output element is one block's sum over D in a fixed order, so a
// run replays bit for bit.
//
// f32: an FMA tile per (F tile, expert) (each of 256 threads 4 x 4
// outputs), never TF32, which keeps 10 bits; it runs only in the identity
// checks.

#include <algorithm>

#include "common.cuh"

namespace {

// ---- bf16: persistent, wgmma fed by TMA ----
constexpr int GW_BK = 64;
constexpr int GW_XROWS = 16;        // rows of one x box: a tile loads only
                                    // the boxes its group's rows reach

template <int NC>
struct GwShape {
    static constexpr int BM = 64 * NC;               // rows a tile
    static constexpr int BN = 128 * NC;              // columns a tile
    static constexpr int THREADS = 128 * NC + 32;    // consumers, producer
    static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
    static constexpr int NS = 4;                     // ring stages
    static constexpr uint32_t X_BYTES = BM * GW_BK * 2;
    static constexpr uint32_t W_BYTES = GW_BK * BN * 2;
    static constexpr uint32_t STAGE = X_BYTES + W_BYTES;
    // the ring (1024-byte aligned), then the work list's 2 (E + 1) ints
    static size_t smem(int E) {
        return 1024 + (size_t)NS * STAGE + sizeof(int) * 2 * (E + 1);
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

// acc (64 x BN, f32) (+)= a b: one k16 step of a consumer warpgroup
template <int BN>
__device__ __forceinline__ void gw_mma(float (&acc)[BN / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
    if constexpr (BN == 128) wgmma_ss_mn128(acc, a, b, accumulate);
    else wgmma_ss_mn256(acc, a, b, accumulate);
}

template <int NC>
__global__ void __launch_bounds__(GwShape<NC>::THREADS,
                                  GwShape<NC>::MIN_BLOCKS)
grouped_matmul_bf16_kernel(
    const __grid_constant__ CUtensorMap x_map,   // x (T, D): boxes 64 x 16
    const __grid_constant__ CUtensorMap w_map,   // w (E D, F): boxes 64 x 64
    const int* __restrict__ sizes,               // (E,)
    __nv_bfloat16* __restrict__ out,             // (T, F)
    int T, int D, int F, int E) {
    using Sh = GwShape<NC>;
    constexpr int BM = Sh::BM, BN = Sh::BN, NS = Sh::NS;
    constexpr uint32_t STAGE = Sh::STAGE, X_BYTES = Sh::X_BYTES;
    using TX = WgTile<GW_BK>;                 // x rows: 64 k values
    __shared__ uint64_t full[NS], empty[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* tiles = smem_raw + (base - raw);
    int* tile_at = reinterpret_cast<int*>(tiles + NS * STAGE);
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
    const int nF = (F + BN - 1) / BN, nk = (D + GW_BK - 1) / GW_BK;
    const int items = tile_at[E] * nF;

    if (threadIdx.x >= 128 * NC) {
        // ---- producer: one thread issues every stage's TMA boxes ----
        if (threadIdx.x != 128 * NC) return;
        int step = 0;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
            const GwItem it = gw_item(tile_at, row_at, E, nF, BM, BN, i);
            // x boxes that reach the group's rows (rows past it and past T
            // come in as the next group's or zeros: multiplied, not stored);
            // weight boxes that reach F
            const int xb = (it.r1 - it.r0 + GW_XROWS - 1) / GW_XROWS;
            const int wb = min(BN, F - it.n0 + 63) / 64;
            const uint32_t bytes = (xb * GW_XROWS + wb * GW_BK) * 128;
            for (int kt = 0; kt < nk; ++kt, ++step) {
                const int s = step % NS;
                if (step >= NS)
                    mbar_wait(&empty[s], ((step / NS) - 1) & 1);
                unsigned char* xs = tiles + s * STAGE;
                unsigned char* ws = xs + X_BYTES;
                mbar_arrive_expect_tx(&full[s], bytes);
                for (int b = 0; b < xb; ++b)
                    tma_load_2d(xs + b * GW_XROWS * 128, &x_map, kt * GW_BK,
                                it.r0 + b * GW_XROWS, &full[s]);
                // w rows e D + k (past D: the next expert's, against x's
                // zero columns), 64 columns a box
                for (int b = 0; b < wb; ++b)
                    tma_load_2d(ws + b * (GW_BK * 128), &w_map,
                                it.n0 + b * 64, it.e * D + kt * GW_BK,
                                &full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile ----
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gid = lane / 4, tig = lane % 4;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int step = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const GwItem it = gw_item(tile_at, row_at, E, nF, BM, BN, i);
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
            for (int kk = 0; kk < GW_BK / 16; ++kk)
                // B: 16 k rows from kk * 16 (two 8-row groups 1024 bytes
                // apart), its 64-value column blocks 64 x 128 bytes apart
                gw_mma<BN>(acc, TX::template desc<64>(xa, kk * 16),
                           wg_desc(wa + kk * 2048, GW_BK * 128, 1024, 1),
                           kt > 0 || kk > 0);
            wg_commit();
            wg_wait<1>();                  // step - 1's products are done
            wg_pin(acc);
            if (kt > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        }
        if (!live) continue;
        wg_wait<0>();
        wg_pin(acc);
        if (lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        // acc[4 j + 2 i + c]: row gid + 8 i of the warp's 16, column
        // 8 j + 2 tig + c of the tile
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
            const int row = it.r0 + 64 * wg + 16 * warp + gid + 8 * i2;
            if (row >= it.r1) continue;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int f = it.n0 + 8 * j + 2 * tig;
                if (f < F)
                    *reinterpret_cast<__nv_bfloat162*>(
                        out + (size_t)row * F + f) = __floats2bfloat162_rn(
                        acc[4 * j + 2 * i2], acc[4 * j + 2 * i2 + 1]);
            }
        }
    }
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

// Blocks of a persistent launch: as many as fit on the card at once, and
// no more than the items there can be (every expert's rows in whole tiles,
// plus one partial tile for each non-empty expert).  The SM count and the
// blocks an SM are read once a device and shared-memory size.
template <int NC>
int gw_grid(int T, int E, int F, size_t smem, int& grid) {
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
                &per_sm, grouped_matmul_bf16_kernel<NC>,
                GwShape<NC>::THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        cached_dev = dev;
        cached_sms = sms;
        cached_per_sm = per_sm;
        cached_smem = smem;
    }
    constexpr int BM = GwShape<NC>::BM, BN = GwShape<NC>::BN;
    const long long items = ((long long)(T + BM - 1) / BM + std::min(E, T))
                          * ((F + BN - 1) / BN);
    grid = (int)std::min(items,
                         (long long)std::max(1, cached_per_sm) * cached_sms);
    return 0;
}

template <int NC>
int launch_bf16(const void* x, const void* w, const int* sizes, void* out,
                int T, int D, int F, int E, cudaStream_t stream) {
    const size_t smem = GwShape<NC>::smem(E);
    auto kernel = grouped_matmul_bf16_kernel<NC>;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    int grid;
    CUtensorMap x_map, w_map;
    int rc = gw_grid<NC>(T, E, F, smem, grid);
    if (rc == 0) rc = bf16_map(&x_map, x, T, D, GW_XROWS);
    if (rc == 0) rc = bf16_map(&w_map, w, (long long)E * D, F, GW_BK);
    if (rc != 0) return rc;
    kernel<<<grid, GwShape<NC>::THREADS, smem, stream>>>(
        x_map, w_map, sizes, (__nv_bfloat16*)out, T, D, F, E);
    return (int)cudaGetLastError();
}

// ---- f32: FMA tiles, one block per (F tile, expert) ----
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

__global__ void __launch_bounds__(GF_THREADS) grouped_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ sizes, float* __restrict__ out, int T, int D,
    int F) {
    const int n0 = blockIdx.x * GF_BN;
    const int e = blockIdx.y;
    int lo, hi;
    group_rows(sizes, e, gridDim.y, T, lo, hi);
    if (lo >= hi) return;
    __shared__ __align__(16) float a_s[GF_BK][GF_BM + 4];   // x tile, k-major
    __shared__ float b_s[GF_BK][GF_BN];
    const float* we = w + (size_t)e * D * F;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int m0 = 0; m0 < hi - lo; m0 += GF_BM) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < D; k0 += GF_BK) {
            __syncthreads();                   // previous tile consumed
            for (int c = threadIdx.x; c < GF_BM * GF_BK; c += GF_THREADS) {
                const int r = c / GF_BK, k = c % GF_BK;
                const int row = lo + m0 + r;
                a_s[k][r] = row < hi && k0 + k < D
                    ? x[(size_t)row * D + k0 + k] : 0.f;
            }
            for (int c = threadIdx.x; c < GF_BK * GF_BN; c += GF_THREADS) {
                const int k = c / GF_BN, n = c % GF_BN;
                b_s[k][n] = k0 + k < D && n0 + n < F
                    ? we[(size_t)(k0 + k) * F + n0 + n] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < GF_BK; ++k) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &a_s[k][ty * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float b = b_s[k][tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][j] += av[i] * b;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = lo + m0 + ty * 4 + i;
            if (row >= hi) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int f = n0 + tx + 16 * j;
                if (f < F) out[(size_t)row * F + f] = acc[i][j];
            }
        }
    }
}

}  // namespace

// x (T, D), w (E, D, F), group_sizes (E,) int32 summing to T (rows past T
// are never touched), out (T, F); all contiguous on one device, x and w
// 16-byte aligned, D and F multiples of 8.  Returns cudaGetLastError()
// after the launch, or REPRO_UNSUPPORTED.
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* group_sizes, void* out,
                                     int T, int D, int F, int E, int dtype,
                                     void* stream) {
    if (T <= 0 || E <= 0) return T == 0 ? 0 : REPRO_UNSUPPORTED;
    if (D % 8 != 0 || F % 8 != 0) return REPRO_UNSUPPORTED;
    if (((size_t)x | (size_t)w) % 16 != 0) return REPRO_UNSUPPORTED;
    cudaStream_t st = (cudaStream_t)stream;
    const int* sizes = (const int*)group_sizes;
    if (dtype == REPRO_BF16)
        return T > 64 * E
            ? launch_bf16<2>(x, w, sizes, out, T, D, F, E, st)
            : launch_bf16<1>(x, w, sizes, out, T, D, F, E, st);
    if (dtype == REPRO_F32) {
        const dim3 grid((F + GF_BN - 1) / GF_BN, E);
        grouped_matmul_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)x, (const float*)w, sizes, (float*)out, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}
