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
// routes 16 tokens x top-6 = 96 rows over ~50 of the 64 experts: each
// non-empty expert's (D, F) weight is read for a handful of rows, 2
// flops per weight element read (2 bytes in bf16), far below the ~295
// flops per byte the card needs before its tensor cores matter.  So the
// kernel reads every weight byte of a non-empty expert once per launch and
// none of an empty one.  A 4 x 256-token prefill call (6144 rows, ~96 per
// expert) is near the balance point.
//
// Design.  The TPU kernel steps a sequential grid (token tile, expert) and
// accumulates each output tile across the (at most two) experts that
// overlap it, in VMEM scratch.  Blocks on Hopper run in parallel in no
// order, so nothing carries across experts: one thread block takes one
// (F tile, expert), finds its group's rows [offs[e], offs[e+1]) from the
// sizes on the device (no host sync: the grid depends only on E and F),
// returns before any load when the group is empty, and loops over the
// group's rows in tiles of BM rows; per row tile it streams the expert's
// (D, GM_BN) weight slice once through a GM_STAGES-deep cp.async ring of
// (GM_BK x GM_BN) tiles with the matching x tiles (rows past the group are
// zero-filled, nothing read).  The row tile adapts to the rows an expert
// gets on average, T / E, the one thing the host knows without a sync: 64
// rows (four warps) when that is at most 64, as at decode, where more idle
// warps and shared memory a block would only cost blocks in flight; 128
// (eight warps) above, so that a prefill call's ~96 rows an expert take one
// pass and its weights are read once there too.  bf16: 16 rows a warp,
// mma.sync m16n8k16 with f32 accumulators, the fragments loaded with
// ldmatrix (transposed for w's (k, n) rows); a warp whose rows all lie
// past the group skips its products.  f32: an FMA
// tile (each of 256 threads 4 x 4 outputs), never TF32, which keeps 10
// bits.  Next: a persistent grid and wgmma for the prefill's larger
// groups; split over D for decode, where each block's slice is 256 KB
// streamed by one block.

#include "common.cuh"

namespace {

constexpr int GM_BN = 64, GM_BK = 32, GM_STAGES = 4;
constexpr int GM_LDA = GM_BK + 8;            // staged row strides, elements:
constexpr int GM_LDB = GM_BN + 8;            // padded against bank conflicts
constexpr int GM_B = GM_BK * GM_LDB;

// One bf16 row tile of BM rows: 16 rows a warp.
template <int BM>
struct GmTile {
    static constexpr int THREADS = BM / 16 * 32;
    static constexpr int A = BM * GM_LDA;    // x tile, elements
    static constexpr int STAGE = A + GM_B;
    static constexpr size_t SMEM = (size_t)GM_STAGES * STAGE
                                 * sizeof(__nv_bfloat16);
};

// f32 FMA tiles
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

// Start the copies of k-tile kt of row tile m0 into stage buffers a_s, b_s.
template <int BM>
__device__ __forceinline__ void gm_load_stage(
    __nv_bfloat16* a_s, __nv_bfloat16* b_s,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    int lo, int hi, int m0, int n0, int kt, int D, int F) {
    constexpr int THREADS = GmTile<BM>::THREADS;
    const int k0 = kt * GM_BK;
    // x tile: BM rows x GM_BK cols = 4 chunks of 8 per row
    for (int c = threadIdx.x; c < BM * (GM_BK / 8); c += THREADS) {
        const int r = c / (GM_BK / 8), ch = c % (GM_BK / 8);
        const int row = lo + m0 + r, col = k0 + ch * 8;
        const bool ok = row < hi && col < D;
        cp_async16(a_s + r * GM_LDA + ch * 8,
                   ok ? x + (size_t)row * D + col : x, ok);
    }
    // w tile: GM_BK rows (d) x GM_BN cols (f) = 8 chunks of 8 per row
    for (int c = threadIdx.x; c < GM_BK * (GM_BN / 8); c += THREADS) {
        const int r = c / (GM_BN / 8), ch = c % (GM_BN / 8);
        const int d = k0 + r, f = n0 + ch * 8;
        const bool ok = d < D && f < F;
        cp_async16(b_s + r * GM_LDB + ch * 8,
                   ok ? w + (size_t)d * F + f : w, ok);
    }
}

template <int BM>
__global__ void __launch_bounds__(GmTile<BM>::THREADS)
grouped_matmul_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,   // (T, D), sorted by expert
    const __nv_bfloat16* __restrict__ w,   // (E, D, F)
    const int* __restrict__ sizes,         // (E,)
    __nv_bfloat16* __restrict__ out,       // (T, F)
    int T, int D, int F) {
    const int n0 = blockIdx.x * GM_BN;
    const int e = blockIdx.y;
    int lo, hi;
    group_rows(sizes, e, gridDim.y, T, lo, hi);
    if (lo >= hi) return;                  // empty group: no loads at all
    constexpr int STAGE = GmTile<BM>::STAGE, A = GmTile<BM>::A;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const __nv_bfloat16* we = w + (size_t)e * D * F;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int nk = (D + GM_BK - 1) / GM_BK;

    for (int m0 = 0; m0 < hi - lo; m0 += BM) {
        const bool live = m0 + warp * 16 < hi - lo;   // warp-uniform
        float acc[GM_BN / 8][4];
#pragma unroll
        for (int nt = 0; nt < GM_BN / 8; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
        for (int s = 0; s < GM_STAGES - 1; ++s) {
            if (s < nk)
                gm_load_stage<BM>(smem + s * STAGE, smem + s * STAGE + A, x,
                                  we, lo, hi, m0, n0, s, D, F);
            cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
            cp_async_wait<GM_STAGES - 2>();    // k-tile kt has landed
            __syncthreads();                   // and kt - 1 is consumed
            const int next = kt + GM_STAGES - 1;
            if (next < nk) {
                __nv_bfloat16* st = smem + (next % GM_STAGES) * STAGE;
                gm_load_stage<BM>(st, st + A, x, we, lo, hi, m0, n0, next, D,
                                  F);
            }
            cp_async_commit();
            if (!live) continue;
            const __nv_bfloat16* a_s = smem + (kt % GM_STAGES) * STAGE;
            const __nv_bfloat16* b_s = a_s + A;
#pragma unroll
            for (int kk = 0; kk < GM_BK / 16; ++kk) {
                // A: rows lane % 16 of the warp's 16, columns +8 past lane 15
                uint32_t a[4];
                ldsm_x4<false>(a, a_s + (warp * 16 + (lane & 15)) * GM_LDA
                                      + kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int nt = 0; nt < GM_BN / 8; nt += 2) {
                    // B of n-tiles nt and nt + 1: k rows lane % 8 (+8 for
                    // lanes 8-15 and 24-31), columns +8 past lane 15
                    uint32_t b[4];
                    ldsm_x4<true>(b, b_s + (kk * 16 + (lane & 7)
                                            + ((lane >> 3) & 1) * 8) * GM_LDB
                                         + (nt + (lane >> 4)) * 8);
                    mma_bf16(acc[nt], a, b[0], b[1]);
                    mma_bf16(acc[nt + 1], a, b[2], b[3]);
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();                       // buffers free for m0 + BM
        if (!live) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = lo + m0 + warp * 16 + gid + 8 * i;
            if (row >= hi) continue;
#pragma unroll
            for (int nt = 0; nt < GM_BN / 8; ++nt) {
                const int f = n0 + nt * 8 + tig * 2;
                if (f < F)
                    *reinterpret_cast<__nv_bfloat162*>(
                        out + (size_t)row * F + f) = __floats2bfloat162_rn(
                        acc[nt][2 * i], acc[nt][2 * i + 1]);
            }
        }
    }
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

template <int BM>
int launch_bf16(dim3 grid, const void* x, const void* w, const int* sizes,
                void* out, int T, int D, int F, cudaStream_t stream) {
    using Tl = GmTile<BM>;
    auto kernel = grouped_matmul_bf16_kernel<BM>;
    cudaError_t err = reserve_smem(kernel, Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, sizes,
        (__nv_bfloat16*)out, T, D, F);
    return (int)cudaGetLastError();
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
    if (dtype == REPRO_BF16) {
        const dim3 grid((F + GM_BN - 1) / GM_BN, E);
        return T > 64 * E
            ? launch_bf16<128>(grid, x, w, sizes, out, T, D, F, st)
            : launch_bf16<64>(grid, x, w, sizes, out, T, D, F, st);
    }
    if (dtype == REPRO_F32) {
        const dim3 grid((F + GF_BN - 1) / GF_BN, E);
        grouped_matmul_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)x, (const float*)w, sizes, (float*)out, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}
