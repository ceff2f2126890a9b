// The backward of the ragged grouped matmul (grouped_matmul.cu) for Hopper
// (sm_90a): with out[t] = x[t] @ w[e(t)] and dy its gradient,
//
//   dx[t] = dy[t] @ w[e(t)]^T             (T, D)
//   dw[e] = sum over e's rows t of x[t]^T dy[t]   (E, D, F)
//
// x (T, D) and dy (T, F) sorted by expert, w (E, D, F), group_sizes (E,)
// int32 on the device, read there with no host sync, as the forward reads
// them.  Sums in f32, one rounding to the inputs' type; an empty group's
// dw[e] is exact zeros.
//
// Replaces no TPU kernel: the reference differentiates its oracle
// (ref.grouped_matmul) with jax.vjp, which XLA lowers to two gathers of
// each row's expert weights and dense products.  It is the gradient of
// grouped_matmul.cu, which replaces src/repro/kernels/grouped_matmul.py
// :58, and the train step under the ragged dispatch runs it (the GRPO
// learner of an MoE policy, whose actor serves under that dispatch).
//
// What bounds it on the H100: operations, at the train shape.  A
// deepseek-v2-lite step of 2 x 4096 tokens routes 49152 rows over 64
// experts (~768 an expert): dx is 2 T D F = 283 GFLOP against 0.71 GB of
// dy, w and dx (0.29 ms of tensor work, 0.21 ms of bytes), dw the same
// operations against as many bytes of x, dy and dw
// (perf_model.grouped_matmul_bwd_cost).
//
// dx (bf16) is the forward's persistent kernel (grouped_matmul.cuh) over
// the same work list of (expert, row tile, D tile) items, with dy as its
// K-major A and each expert's w[e] read K-major as B: w[e] lies (D, F), F
// contiguous, which is B = w[e]^T's K-major layout, so the TMA boxes of
// 64 f values x 64 d rows feed wgmma with no transpose bit and no
// transposed copy of the weights.
//
// dw (bf16) is one persistent kernel over (expert, D tile, F tile) items,
// expert-major (the blocks that run at once share an expert's rows in
// L2), tiles of 128 x 256 (two consumer warpgroups of 64 D rows each, one
// producer warp), each summing its expert's rows 64 at a time: x's rows
// are A read MN-major (a row's D values contiguous: the transpose bit) and
// dy's are B read MN-major, both through TMA boxes of 64 values x 64 rows
// in the forward's 4-stage ring.  A tile starts at its group's first row;
// its last k step reaches past the group into the next group's rows (or
// zeros past T), which must add nothing, so the consumers zero those rows
// of every box of that stage in shared memory before any warpgroup reads
// it (fence.proxy.async, then a named barrier of the consumers).  At the
// train shape that is 64 x 16 x 6 = 6144 items of ~12 k steps, 46 waves
// on 132 SMs: the sum over an expert's rows is serial inside its item, and
// the items give the card its parallelism.  An empty expert's items load
// nothing and store zeros.  Every output element is one item's sum in a
// fixed order, so a run replays bit for bit.
//
// f32 (the identity checks only): FMA tiles, never TF32.  dx a block per
// (D tile, expert) walking its rows; dw a block per (F tile, D tile,
// expert) walking its expert's rows 16 at a time.

#include "grouped_matmul.cuh"

namespace {

// ---- bf16 dw: persistent, wgmma on two MN-major operands ----
constexpr int DW_NC = 2;                      // consumer warpgroups

__global__ void __launch_bounds__(GwShape<DW_NC>::THREADS,
                                  GwShape<DW_NC>::MIN_BLOCKS)
grouped_matmul_dw_bf16_kernel(
    const __grid_constant__ CUtensorMap x_map,   // x (T, D): boxes 64 x 64
    const __grid_constant__ CUtensorMap dy_map,  // dy (T, F): boxes 64 x 64
    const int* __restrict__ sizes,               // (E,)
    __nv_bfloat16* __restrict__ dw,              // (E, D, F)
    int T, int D, int F, int E) {
    using Sh = GwShape<DW_NC>;
    constexpr int BM = Sh::BM, BN = Sh::BN, NS = Sh::NS;
    constexpr uint32_t STAGE = Sh::STAGE, X_BYTES = Sh::X_BYTES;
    constexpr int BOXES = (BM + BN) / 64;        // 64 x 64 boxes a stage
    constexpr uint32_t BOX = GW_BK * 128;        // bytes of one
    __shared__ uint64_t full[NS], empty[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* tiles = smem_raw + (base - raw);
    int* tile_at = reinterpret_cast<int*>(tiles + NS * STAGE);
    int* row_at = tile_at + E + 1;

    gw_work_list(sizes, E, T, GW_BK, tile_at, row_at);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 1);            // the producer's expect_tx
            mbar_init(&empty[s], 4 * DW_NC);   // one a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int nM = (D + BM - 1) / BM, nN = (F + BN - 1) / BN;
    const int items = E * nM * nN;

    if (threadIdx.x >= 128 * DW_NC) {
        // ---- producer: one thread issues every stage's TMA boxes ----
        if (threadIdx.x != 128 * DW_NC) return;
        int step = 0;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
            const int e = i / (nM * nN), r = i % (nM * nN);
            const int m0 = (r / nN) * BM, n0 = (r % nN) * BN;
            const int lo = row_at[e], nk = (row_at[e + 1] - lo + 63) / 64;
            // boxes that reach D and F (the others keep what the stage
            // held: they feed outputs past D or F, never stored)
            const int xb = min(BM, D - m0 + 63) / 64;
            const int wb = min(BN, F - n0 + 63) / 64;
            for (int kt = 0; kt < nk; ++kt, ++step) {
                const int s = step % NS;
                if (step >= NS)
                    mbar_wait(&empty[s], ((step / NS) - 1) & 1);
                unsigned char* xs = tiles + s * STAGE;
                unsigned char* ws = xs + X_BYTES;
                mbar_arrive_expect_tx(&full[s], (xb + wb) * BOX);
                const int row = lo + kt * GW_BK;
                for (int b = 0; b < xb; ++b)
                    tma_load_2d(xs + b * BOX, &x_map, m0 + b * 64, row,
                                &full[s]);
                for (int b = 0; b < wb; ++b)
                    tma_load_2d(ws + b * BOX, &dy_map, n0 + b * 64, row,
                                &full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroup wg: D rows 64 wg .. 64 wg + 63 of each tile --
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    float acc[BN / 2];
    int step = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int e = i / (nM * nN), r = i % (nM * nN);
        const int m0 = (r / nN) * BM, n0 = (r % nN) * BN;
        const int lo = row_at[e], hi = row_at[e + 1];
        const int nk = (hi - lo + 63) / 64;
        const bool live = m0 + 64 * wg < D;          // warpgroup-uniform
        for (int kt = 0; kt < nk; ++kt, ++step) {
            const int s = step % NS;
            mbar_wait(&full[s], (step / NS) & 1);
            const int valid = hi - (lo + kt * GW_BK);  // block-uniform
            if (valid < GW_BK) {
                // rows past the group: zero them in every box, by all the
                // consumers, before any of them multiplies the stage
                uint4* st = reinterpret_cast<uint4*>(tiles + s * STAGE);
                const int per_box = (GW_BK - valid) * 8;   // 16-byte chunks
                for (int c = threadIdx.x; c < BOXES * per_box;
                     c += 128 * DW_NC) {
                    const int box = c / per_box, chunk = c % per_box;
                    st[box * (BOX / 16) + valid * 8 + chunk] =
                        make_uint4(0u, 0u, 0u, 0u);
                }
                fence_proxy_async();
                named_barrier(1, 128 * DW_NC);
            }
            if (!live) {                   // nothing to multiply: release
                if (lane == 0) mbar_arrive(&empty[s]);
                continue;
            }
            const uint32_t xa = base + s * STAGE + wg * BOX;
            const uint32_t wa = base + s * STAGE + X_BYTES;
            wg_pin(acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < GW_BK / 16; ++kk)
                // A: 16 rows from kk * 16 of the warpgroup's x box, its 64
                // D values a row; B: the same rows of dy, its 64-value
                // column blocks one box apart
                gw_mma<BN, 1, 1>(acc, wg_desc(xa + kk * 2048, BOX, 1024, 1),
                                 wg_desc(wa + kk * 2048, BOX, 1024, 1),
                                 kt > 0 || kk > 0);
            wg_commit();
            wg_wait<1>();                  // step - 1's products are done
            wg_pin(acc);
            if (kt > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        }
        if (!live) continue;
        if (nk > 0) {
            wg_wait<0>();
            wg_pin(acc);
            if (lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
        } else {                           // an empty expert: zeros
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
        }
        gw_store<BN>(acc, dw + (long long)e * D * F, F, m0 + 64 * wg, D, n0,
                     F);
    }
}

int launch_dw_bf16(const void* x, const void* dy, const int* sizes,
                   void* dw, int T, int D, int F, int E,
                   cudaStream_t stream) {
    using Sh = GwShape<DW_NC>;
    const size_t smem = Sh::smem(E);
    auto kernel = grouped_matmul_dw_bf16_kernel;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long items = (long long)E * ((D + Sh::BM - 1) / Sh::BM)
                          * ((F + Sh::BN - 1) / Sh::BN);
    int grid;
    CUtensorMap x_map, dy_map;
    int rc = persistent_grid<grouped_matmul_dw_bf16_kernel>(
        Sh::THREADS, smem, items, grid);
    if (rc == 0) rc = bf16_map(&x_map, x, T, D, GW_BK);
    if (rc == 0) rc = bf16_map(&dy_map, dy, T, F, GW_BK);
    if (rc != 0) return rc;
    kernel<<<grid, Sh::THREADS, smem, stream>>>(
        x_map, dy_map, sizes, (__nv_bfloat16*)dw, T, D, F, E);
    return (int)cudaGetLastError();
}

// ---- f32 dx: a block per (D tile, expert), FMA tiles ----
__global__ void __launch_bounds__(GF_THREADS) grouped_matmul_dx_f32_kernel(
    const float* __restrict__ dy, const float* __restrict__ w,
    const int* __restrict__ sizes, float* __restrict__ dx, int T, int D,
    int F) {
    const int n0 = blockIdx.x * GF_BN;         // columns of dx: D
    const int e = blockIdx.y;
    int lo, hi;
    group_rows(sizes, e, gridDim.y, T, lo, hi);
    if (lo >= hi) return;
    __shared__ __align__(16) float a_s[GF_BK][GF_BM + 4];   // dy, k-major
    __shared__ float b_s[GF_BK][GF_BN + 1];                  // w[e]^T
    const float* we = w + (size_t)e * D * F;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int m0 = 0; m0 < hi - lo; m0 += GF_BM) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < F; k0 += GF_BK) {
            __syncthreads();                   // previous tile consumed
            for (int c = threadIdx.x; c < GF_BM * GF_BK; c += GF_THREADS) {
                const int r = c / GF_BK, k = c % GF_BK;
                const int row = lo + m0 + r;
                a_s[k][r] = row < hi && k0 + k < F
                    ? dy[(size_t)row * F + k0 + k] : 0.f;
            }
            // w[e][d][f] at (k = f, n = d): 16 contiguous f a row of w
            for (int c = threadIdx.x; c < GF_BK * GF_BN; c += GF_THREADS) {
                const int n = c / GF_BK, k = c % GF_BK;
                b_s[k][n] = k0 + k < F && n0 + n < D
                    ? we[(size_t)(n0 + n) * F + k0 + k] : 0.f;
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
                const int d = n0 + tx + 16 * j;
                if (d < D) dx[(size_t)row * D + d] = acc[i][j];
            }
        }
    }
}

// ---- f32 dw: a block per (F tile, D tile, expert), FMA tiles ----
__global__ void __launch_bounds__(GF_THREADS) grouped_matmul_dw_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const int* __restrict__ sizes, float* __restrict__ dw, int T, int D,
    int F) {
    const int n0 = blockIdx.x * GF_BN, m0 = blockIdx.y * GF_BM;
    const int e = blockIdx.z;
    int lo, hi;
    group_rows(sizes, e, gridDim.z, T, lo, hi);
    __shared__ __align__(16) float a_s[GF_BK][GF_BM + 4];   // x rows
    __shared__ float b_s[GF_BK][GF_BN];                      // dy rows
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[4][4] = {};
    for (int r0 = lo; r0 < hi; r0 += GF_BK) {
        __syncthreads();                       // previous rows consumed
        for (int c = threadIdx.x; c < GF_BK * GF_BM; c += GF_THREADS) {
            const int k = c / GF_BM, m = c % GF_BM;
            a_s[k][m] = r0 + k < hi && m0 + m < D
                ? x[(size_t)(r0 + k) * D + m0 + m] : 0.f;
        }
        for (int c = threadIdx.x; c < GF_BK * GF_BN; c += GF_THREADS) {
            const int k = c / GF_BN, n = c % GF_BN;
            b_s[k][n] = r0 + k < hi && n0 + n < F
                ? dy[(size_t)(r0 + k) * F + n0 + n] : 0.f;
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
    float* dwe = dw + (size_t)e * D * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int d = m0 + ty * 4 + i;
        if (d >= D) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int f = n0 + tx + 16 * j;
            if (f < F) dwe[(size_t)d * F + f] = acc[i][j];
        }
    }
}

int check(int T, int D, int F, int E, const void* a, const void* b) {
    if (T <= 0 || E <= 0) return REPRO_UNSUPPORTED;
    if (D % 8 != 0 || F % 8 != 0) return REPRO_UNSUPPORTED;
    if (((size_t)a | (size_t)b) % 16 != 0) return REPRO_UNSUPPORTED;
    return 0;
}

}  // namespace

// dx (T, D) = each row of dy (T, F) against its expert's w (E, D, F)
// transposed; group_sizes (E,) int32 summing to T.  All contiguous on one
// device, dy and w 16-byte aligned, D and F multiples of 8, T > 0.
// Returns cudaGetLastError() after the launch, or REPRO_UNSUPPORTED.
extern "C" int grouped_matmul_bwd_dx_launch(const void* dy, const void* w,
                                            const void* group_sizes,
                                            void* dx, int T, int D, int F,
                                            int E, int dtype, void* stream) {
    const int rc = check(T, D, F, E, dy, w);
    if (rc != 0) return rc;
    cudaStream_t st = (cudaStream_t)stream;
    const int* sizes = (const int*)group_sizes;
    if (dtype == REPRO_BF16)
        return T > 64 * E
            ? launch_grouped_bf16<2, true>(dy, w, sizes, dx, T, F, D, E, st)
            : launch_grouped_bf16<1, true>(dy, w, sizes, dx, T, F, D, E, st);
    if (dtype == REPRO_F32) {
        const dim3 grid((D + GF_BN - 1) / GF_BN, E);
        grouped_matmul_dx_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)dy, (const float*)w, sizes, (float*)dx, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}

// dw (E, D, F): dw[e] = x_e^T dy_e over expert e's rows of x (T, D) and dy
// (T, F), zeros for an empty group; the same requirements as dx's.
extern "C" int grouped_matmul_bwd_dw_launch(const void* x, const void* dy,
                                            const void* group_sizes,
                                            void* dw, int T, int D, int F,
                                            int E, int dtype, void* stream) {
    const int rc = check(T, D, F, E, x, dy);
    if (rc != 0) return rc;
    cudaStream_t st = (cudaStream_t)stream;
    const int* sizes = (const int*)group_sizes;
    if (dtype == REPRO_BF16)
        return launch_dw_bf16(x, dy, sizes, dw, T, D, F, E, st);
    if (dtype == REPRO_F32) {
        const dim3 grid((F + GF_BN - 1) / GF_BN, (D + GF_BM - 1) / GF_BM, E);
        grouped_matmul_dw_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)x, (const float*)dy, sizes, (float*)dw, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}
