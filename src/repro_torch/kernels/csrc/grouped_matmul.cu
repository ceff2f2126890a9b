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
// The producer's one thread keeps a ring of NS stages (4 at 64 x 128, 3 at
// 128 x 256, whose epilogue takes a stage's room) full with TMA,
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
// stored for the rows inside the group and the columns inside F: at 128 x
// 256 through shared memory and a TMA store that drains under the next
// item, at 64 x 128 straight from registers (grouped_matmul.cuh's header
// says why both); a warpgroup whose rows all lie past the group only
// releases its stages.
// Each output element is one block's sum over D in a fixed order, so a
// run replays bit for bit.
//
// The bf16 body lives in grouped_matmul.cuh, where the backward's dx
// product (grouped_matmul_bwd.cu) takes it with the weights read K-major.
//
// f32: an FMA tile per (F tile, expert) (each of 256 threads 4 x 4
// outputs), never TF32, which keeps 10 bits; it runs only in the identity
// checks.

#include "grouped_matmul.cuh"

namespace {

// ---- f32: FMA tiles, one block per (F tile, expert) ----
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
// are never touched), out (T, F); all contiguous on one device, x, w and
// out 16-byte aligned, D and F multiples of 8.  Returns cudaGetLastError()
// after the launch, or REPRO_UNSUPPORTED.
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* group_sizes, void* out,
                                     int T, int D, int F, int E, int dtype,
                                     void* stream) {
    if (T <= 0 || E <= 0) return T == 0 ? 0 : REPRO_UNSUPPORTED;
    if (D % 8 != 0 || F % 8 != 0) return REPRO_UNSUPPORTED;
    if (((size_t)x | (size_t)w | (size_t)out) % 16 != 0)
        return REPRO_UNSUPPORTED;
    cudaStream_t st = (cudaStream_t)stream;
    const int* sizes = (const int*)group_sizes;
    if (dtype == REPRO_BF16)
        return T > 64 * E
            ? launch_grouped_bf16<2, false, true>(x, w, sizes, out, T, D, F,
                                                  E, st)
            : launch_grouped_bf16<1, false>(x, w, sizes, out, T, D, F, E, st);
    if (dtype == REPRO_F32) {
        const dim3 grid((F + GF_BN - 1) / GF_BN, E);
        grouped_matmul_f32_kernel<<<grid, GF_THREADS, 0, st>>>(
            (const float*)x, (const float*)w, sizes, (float*)out, T, D, F);
        return (int)cudaGetLastError();
    }
    return REPRO_UNSUPPORTED;
}
