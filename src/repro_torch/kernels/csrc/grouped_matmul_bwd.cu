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
// transposed copy of the weights, and its epilogue through shared memory
// and TMA stores that drain under the next item's 22 k steps; a tile cut
// by its group's end is copied out in 16-byte rows, masked.
//
// dw (bf16) is one persistent kernel over (expert, D tile, F tile) items,
// expert-major (the blocks that run at once share an expert's rows in
// L2), each summing its expert's rows 64 at a time: x's rows are A read
// MN-major (a row's D values contiguous: the transpose bit) and dy's are
// B read MN-major, both through TMA boxes of 64 values x 64 rows in a
// 3-stage ring fed by one producer thread.  Two consumer warpgroups take
// 64 D rows each of a 128 x 256 tile, one m64n256k16 a k16 slice.  At
// the train shape (~768 rows an expert) an item is ~12 k steps, so its
// epilogue weighs: it goes through shared memory and TMA stores (dw's (E,
// D, F) map clips at D and F), as dx's.  A tile starts at its group's
// first row; on its last k step the k16 slices past the group are skipped
// and only the rows of the slice the group ends in (at most 15) are zeroed
// in the stage, in both operands (0 x NaN is NaN), by all the consumers
// (fence.proxy.async, then a named barrier of both warpgroups), so no row
// of another group adds anything.  An empty expert's zeros come from a
// wgmma on a zero block.
//
// Registers: 168 a thread at most (9 warps, one SM's 64 K registers; a
// sub-partition holds 3 of them), 128 of them the accumulators.  What
// keeps the consumers under that with no spill: every branch around wgmma
// or the accumulators warp-uniform (grouped_matmul.cuh's warp_uniform),
// only wgmma writing the accumulators (an empty expert's zeros from a
// wgmma on the zero block), and 32-bit shared addresses.
//
// At the train shape that is 64 x 16 x 6 = 6144 items, 47 waves on 132
// SMs: the sum over an expert's rows is serial inside its item, and the
// items give the card its parallelism.  An empty expert's items load
// nothing.  Every output element is one item's sum in a fixed order, so a
// run replays bit for bit.
//
// f32 (the identity checks only): FMA tiles, never TF32.  dx a block per
// (D tile, expert) walking its rows; dw a block per (F tile, D tile,
// expert) walking its expert's rows 16 at a time.

#include "grouped_matmul.cuh"

namespace {

// ---- bf16 dw: persistent, wgmma on two MN-major operands ----
struct DwShape {
    static constexpr int BM = 128;                // D rows a tile
    static constexpr int BN = 256;                // F columns a tile
    static constexpr int THREADS = 288;           // 2 consumer warpgroups,
                                                  // a producer warp
    static constexpr int NS = 3;                  // ring stages
    static constexpr uint32_t X_BYTES = BM / 64 * GW_BOX;
    static constexpr uint32_t STAGE = X_BYTES + BN / 64 * GW_BOX;
    static constexpr uint32_t OUT = BN / 64 * GW_BOX;  // a warpgroup's
    static constexpr uint32_t ZERO = 4 * 2048;    // zeros: 16 k rows x 256
    // the ring, two staged tiles, the zeros (all 1024-byte aligned), then
    // the work list's 2 (E + 1) ints
    static size_t smem(int E) {
        return 1024 + (size_t)NS * STAGE + 2 * OUT + ZERO
             + sizeof(int) * 2 * (E + 1);
    }
};

__global__ void __launch_bounds__(288, 1) grouped_matmul_dw_bf16_kernel(
    const __grid_constant__ CUtensorMap x_map,   // x (T, D): boxes 64 x 64
    const __grid_constant__ CUtensorMap dy_map,  // dy (T, F): boxes 64 x 64
    const __grid_constant__ CUtensorMap dw_map,  // dw (E, D, F): 64 x 64 x 1
    const int* __restrict__ sizes,               // (E,)
    int T, int D, int F, int E) {
    using Sh = DwShape;
    constexpr int BM = Sh::BM, BN = Sh::BN, NS = Sh::NS;
    constexpr uint32_t STAGE = Sh::STAGE, X_BYTES = Sh::X_BYTES;
    constexpr int BOXES = (BM + BN) / 64;         // 64 x 64 boxes a stage
    __shared__ uint64_t full[NS], empty[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* tiles = smem_raw + (base - raw);
    unsigned char* staged = tiles + NS * STAGE;
    unsigned char* zero = staged + 2 * Sh::OUT;
    int* tile_at = reinterpret_cast<int*>(zero + Sh::ZERO);
    int* row_at = tile_at + E + 1;

    gw_work_list(sizes, E, T, GW_BK, tile_at, row_at);
    for (int c = threadIdx.x; c < (int)Sh::ZERO / 16; c += Sh::THREADS)
        reinterpret_cast<uint4*>(zero)[c] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 1);            // the producer's expect_tx
            mbar_init(&empty[s], 8);           // one a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int nM = (D + BM - 1) / BM, nN = (F + BN - 1) / BN;
    const int items = E * nM * nN;
    const int wg = warp_uniform(threadIdx.x / 128);   // 2: the producer

    if (wg == 2) {
        // ---- producer: one thread issues every stage's TMA boxes ----
        if (threadIdx.x != 256) return;
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
                mbar_arrive_expect_tx(&full[s], (xb + wb) * GW_BOX);
                const int row = lo + kt * GW_BK;
                for (int b = 0; b < xb; ++b)
                    tma_load_2d(xs + b * GW_BOX, &x_map, m0 + b * 64, row,
                                &full[s]);
                for (int b = 0; b < wb; ++b)
                    tma_load_2d(ws + b * GW_BOX, &dy_map, n0 + b * 64, row,
                                &full[s]);
            }
        }
    } else {
        // ---- consumer warpgroup wg: D rows 64 wg .. 64 wg + 63 of each
        // tile, one m64n256k16 a k16 slice ----
        const int lane = threadIdx.x % 32;
        const uint32_t buf = base + NS * STAGE + wg * Sh::OUT;
        float acc[BN / 2];
        int step = 0;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
            const int e = i / (nM * nN), r = i % (nM * nN);
            const int m0 = (r / nN) * BM + 64 * wg, n0 = (r % nN) * BN;
            const int lo = warp_uniform(row_at[e]);
            const int hi = warp_uniform(row_at[e + 1]);
            const int nk = (hi - lo + 63) / 64;
            const bool live = m0 < D;
            for (int kt = 0; kt < nk; ++kt, ++step) {
                const int s = step % NS;
                mbar_wait(&full[s], (step / NS) & 1);
                // the group's rows in this step: k16 slices from kn on are
                // past it and skipped; rows valid .. 16 kn - 1
                // of the last slice (the next group's, or zeros past T) are
                // zeroed in every box, both operands (0 x NaN is NaN), by all
                // the consumers before any of them multiplies the stage
                const int valid = hi - (lo + kt * GW_BK);  // block-uniform
                const int kn = min(4, (valid + 15) / 16);
                if (valid < 16 * kn) {
                    const uint32_t st = base + s * STAGE + valid * 128;
                    const int per_box = (16 * kn - valid) * 8;  // chunks
                    for (int c = threadIdx.x; c < BOXES * per_box; c += 256) {
                        const int box = c / per_box, chunk = c % per_box;
                        asm volatile(
                            "st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                            :: "r"(st + box * GW_BOX + chunk * 16), "r"(0)
                            : "memory");
                    }
                    fence_proxy_async();
                    named_barrier(1, 256);
                }
                if (!live) {                   // nothing to multiply: release
                    if (lane == 0) mbar_arrive(&empty[s]);
                    continue;
                }
                const uint32_t xa = base + s * STAGE + wg * GW_BOX;
                const uint32_t wa = base + s * STAGE + X_BYTES;
                wg_pin(acc);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < GW_BK / 16; ++kk) {
                    // A: 16 rows from kk * 16 of an x box, its 64 D values
                    // a row; B: the same rows of the dy boxes (64-value
                    // column blocks one box apart); a slice past the group
                    // is skipped (kn is warp-uniform)
                    if (kk >= kn) continue;
                    gw_mma<BN, 1, 1>(acc,
                                     wg_desc(xa + kk * 2048, GW_BOX, 1024, 1),
                                     wg_desc(wa + kk * 2048, GW_BOX, 1024, 1),
                                     kt > 0 || kk > 0);
                }
                wg_commit();
                wg_wait<1>();                  // step - 1's products are done
                wg_pin(acc);
                if (kt > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
            }
            if (!live) continue;
            if (nk == 0) {
                // an empty expert: its zeros from a product of the zero
                // block, so that only wgmma writes the accumulators (a
                // store to them in a branch makes ptxas serialize every
                // wgmma of the kernel)
                const uint64_t z = wg_desc(base + NS * STAGE + 2 * Sh::OUT,
                                           2048, 1024, 1);
                wg_fence();
                gw_mma<BN, 1, 1>(acc, z, z, 0);
                wg_commit();
            }
            wg_wait<0>();
            wg_pin(acc);
            if (nk > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
            // the epilogue: the tile into this warpgroup's buffer, then TMA
            // stores that drain under the next item's main loop
            const bool issuer = threadIdx.x % 128 == 0;
            if (issuer) bulk_wait_read();  // the last store has read buf
            named_barrier(2 + wg, 128);
            gw_stage<BN>(acc, buf);
            fence_proxy_async();
            named_barrier(2 + wg, 128);
            if (issuer) {
#pragma unroll
                for (int box = 0; box < BN / 64; ++box)
                    if (n0 + 64 * box < F)
                        tma_store_3d(&dw_map, n0 + 64 * box, m0, e,
                                     buf + box * GW_BOX);
                bulk_commit();
            }
        }
        if (threadIdx.x % 128 == 0) bulk_wait();   // the last stores land
    }
}

// dw's (E, D, F) bf16 map: boxes of 64 F values x 64 D rows of one expert
// in the 128-byte swizzle; stores past D or F are clipped
int dw_map_3d(CUtensorMap* map, void* dw, int E, int D, int F) {
    EncodeTiled encode;
    const int rc = encode_tiled(encode);
    if (rc != 0) return rc;
    const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)F * 2,
                                   (cuuint64_t)D * F * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dw, dims, strides, box,
        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : REPRO_UNSUPPORTED;
}

int launch_dw_bf16(const void* x, const void* dy, const int* sizes,
                   void* dw, int T, int D, int F, int E,
                   cudaStream_t stream) {
    using Sh = DwShape;
    const size_t smem = Sh::smem(E);
    auto kernel = grouped_matmul_dw_bf16_kernel;
    cudaError_t err = reserve_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long items = (long long)E * ((D + Sh::BM - 1) / Sh::BM)
                          * ((F + Sh::BN - 1) / Sh::BN);
    int grid;
    CUtensorMap x_map, dy_map, dw_map;
    int rc = persistent_grid<grouped_matmul_dw_bf16_kernel>(
        Sh::THREADS, smem, items, grid);
    if (rc == 0) rc = bf16_map(&x_map, x, T, D, GW_BK);
    if (rc == 0) rc = bf16_map(&dy_map, dy, T, F, GW_BK);
    if (rc == 0) rc = dw_map_3d(&dw_map, dw, E, D, F);
    if (rc != 0) return rc;
    kernel<<<grid, Sh::THREADS, smem, stream>>>(x_map, dy_map, dw_map, sizes,
                                                T, D, F, E);
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
// transposed; group_sizes (E,) int32 summing to T (with fewer, the rows
// past the sum are left as they were, as the forward leaves its output's).
// All contiguous on one device, dy, w and dx 16-byte aligned, D and F
// multiples of 8, T > 0.  bf16 takes the forward's tiles: 128 x 256 when
// an expert gets more than 64 rows on average, else 64 x 128.  Returns
// cudaGetLastError() after the launch, or REPRO_UNSUPPORTED.
extern "C" int grouped_matmul_bwd_dx_launch(const void* dy, const void* w,
                                            const void* group_sizes,
                                            void* dx, int T, int D, int F,
                                            int E, int dtype, void* stream) {
    const int rc = check(T, D, F, E, dy, w);
    if (rc != 0 || (size_t)dx % 16 != 0) return rc ? rc : REPRO_UNSUPPORTED;
    cudaStream_t st = (cudaStream_t)stream;
    const int* sizes = (const int*)group_sizes;
    if (dtype == REPRO_BF16)
        return T > 64 * E
            ? launch_grouped_bf16<2, true, true>(dy, w, sizes, dx, T, F, D, E,
                                                 st)
            : launch_grouped_bf16<1, true, true>(dy, w, sizes, dx, T, F, D, E,
                                                 st);
    if (dtype == REPRO_F32) {
        const dim3 grid((D + GF_BN - 1) / GF_BN, E);
        grouped_matmul_dx_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)dy, (const float*)w, sizes, (float*)dx, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}

// dw (E, D, F): dw[e] = x_e^T dy_e over expert e's rows of x (T, D) and dy
// (T, F), zeros for an empty group; group_sizes summing to at most T (the
// rows past the sum belong to no expert and add nothing); otherwise the
// same requirements as dx's (dw 16-byte aligned).
extern "C" int grouped_matmul_bwd_dw_launch(const void* x, const void* dy,
                                            const void* group_sizes,
                                            void* dw, int T, int D, int F,
                                            int E, int dtype, void* stream) {
    const int rc = check(T, D, F, E, x, dy);
    if (rc != 0 || (size_t)dw % 16 != 0) return rc ? rc : REPRO_UNSUPPORTED;
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
