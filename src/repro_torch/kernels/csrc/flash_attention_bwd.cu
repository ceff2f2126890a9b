// Backward of the dense GQA flash attention (flash_attention.cu) for
// Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py (flash_attention,
// :87) has no backward: the reference differentiates its oracle
// (repro/kernels/ref.py) off the TPU.  Here the forward runs as a kernel
// behind a torch.autograd.Function, which saves q, k, v, the output o and
// each query row's log-sum-exp lse (natural log, (B, H, Sq) f32), and this
// file is its backward, recomputing the scores from lse instead of storing
// P:
//
//   S = scale Q K^T,  P = exp(S - lse) on the visible pairs, else 0,
//   dV = P^T dO,  dP = dO V^T,  D_i = sum_d dO_i o_i,
//   dS = P o (dP - D),  dQ = scale dS K,  dK = scale dS^T Q.
//
// Visible: causal (kp <= qp) unless asked otherwise, and, windowed, qp - kp
// < window, with query positions [0, Sq) (q_offset 0: training passes no
// other).  Three kernels, launched in order by flash_attention_bwd_launch:
//
//   flash_bwd_dot   D_i, (B, H, Sq) f32, one warp a (token, head) row;
//   flash_bwd_dkdv  grid (64-key tile, kv head, batch row): the block holds
//                   its keys' K and V and walks the G query heads of its kv
//                   head and, for each, the 64-row query tiles in the key
//                   tile's reach (queries >= the tile's first key when
//                   causal, below its last key + window when windowed: the
//                   transpose of a query tile's reach), accumulating dK and
//                   dV in registers, and writes them once.  The G heads are
//                   summed in order inside one block: no atomics, a run
//                   replays bit for bit;
//   flash_bwd_dq    grid (64-row query tile, head, batch row): the block
//                   holds its queries' Q, dO, lse and D and walks the key
//                   tiles in reach, accumulating dQ in registers, written
//                   once.
//
// What bounds it on the H100: the work is operations: 2 x visible pairs x
// (3 DK + 2 DV) flops (perf_model.flash_attention_bwd_cost), ~2200 flops a
// byte at qwen2's train shape against the card's ~295.  Both kernels
// recompute S and dP (the dK/dV and the dQ pass each need dS), so they do
// 2 x pairs x (4 DK + 3 DV) flops, and more on the tensor cores (below).
// Two bodies, chosen by dtype and head dim:
//
//   bf16 at (64, 64), qwen2's heads: mma.sync (flash_bwd_dkdv_mma,
//     flash_bwd_dq_mma, further down): S and dP from the bf16 tiles, P and
//     dS in three bf16 parts for their products, f32 sums;
//   f32, and bf16 at (128, 128): the FMA body on the CUDA cores, all in
//     f32 (bf16 widened on load; never TF32).  Each thread of a 256-thread
//     block owns a 4 x 4 tile of the 64 x 64 scores (rows ty + 16 i, keys
//     tx + 16 j) and, for the accumulations, 4 keys (or queries) x DK / 16
//     dims, reading shared tiles padded to an odd row length so that
//     neither the row-strided nor the column reads conflict.  At (128, 128)
//     a warp's mma accumulators for dK and dV (16 keys x 128 dims each)
//     would not fit beside the scores' in registers.
//
// dq, dk and dv are rounded once, at the store.  (DK, DV) pairs built:
// (64, 64) and (128, 128).

#include "common.cuh"

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_T = 64;              // query rows and keys a tile
constexpr int BWD_LDP = BWD_T + 1;     // padded row of the P and dS tiles

template <int D>
struct BwdShape {
    static constexpr int LD = D + 1;   // padded row of a Q, dO, K or V tile
    // Q, dO, K, V tiles, P and dS tiles, lse and D of the query tile
    static constexpr size_t SMEM =
        sizeof(float) * (4 * BWD_T * LD + 2 * BWD_T * BWD_LDP + 2 * BWD_T);
};

// Rows [r0, r0 + n) of a (B, S, heads, D) tensor at head ``hh`` into a
// 64 x (D + 1) f32 tile, zeros past n.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int S, int heads, int hh,
                                          int r0, int n) {
    constexpr int LD = BwdShape<D>::LD;
    for (int e = threadIdx.x; e < BWD_T * D; e += BWD_THREADS) {
        const int i = e / D, d = e % D;
        dst[i * LD + d] = i < n
            ? to_f(src[(((size_t)b * S + r0 + i) * heads + hh) * D + d]) : 0.f;
    }
}

// A query tile's lse and D (rows past nq: lse 0, D 0; they are masked).
__device__ __forceinline__ void load_rows(float* lse_s, float* dd_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ dd,
                                          size_t base, int nq) {
    if (threadIdx.x < BWD_T) {
        const int i = threadIdx.x;
        lse_s[i] = i < nq ? lse[base + i] : 0.f;
        dd_s[i] = i < nq ? dd[base + i] : 0.f;
    }
}

// P and scale dS of the tile pair in shared memory into Ps / dSs (either
// may be null): this thread's query rows ty + 16 i of the tile at q0 and
// keys tx + 16 j of the tile at k0.
template <int D>
__device__ __forceinline__ void probs(const float* Qs, const float* dOs,
                                      const float* Ks, const float* Vs,
                                      const float* lse_s, const float* dd_s,
                                      float* Ps, float* dSs, int q0, int k0,
                                      int Sq, int Sk, bool causal, int window,
                                      float scale) {
    constexpr int LD = BwdShape<D>::LD;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float a[4], c[4], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a[i] = Qs[(ty + 16 * i) * LD + d];
            c[i] = dOs[(ty + 16 * i) * LD + d];
            kk[i] = Ks[(tx + 16 * i) * LD + d];
            vv[i] = Vs[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = fmaf(a[i], kk[j], s[i][j]);
                dp[i][j] = fmaf(c[i], vv[j], dp[i][j]);
            }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = ty + 16 * i, qp = q0 + qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int kj = tx + 16 * j, kp = k0 + kj;
            const bool vis = qp < Sq && kp < Sk && (!causal || kp <= qp)
                && (window <= 0 || qp - kp < window);
            const float p = vis ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
            if (Ps != nullptr) Ps[qi * BWD_LDP + kj] = p;
            if (dSs != nullptr)
                dSs[qi * BWD_LDP + kj] = p * (dp[i][j] - dd_s[qi]) * scale;
        }
    }
}

// D_i = sum_d dO_i o_i over DV values, one warp a (b, s, h) row.
template <typename T, int DV>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dot(
    const T* __restrict__ out,         // (B, Sq, H, DV)
    const T* __restrict__ dout,        // (B, Sq, H, DV)
    float* __restrict__ dd,            // (B, H, Sq)
    int rows, int Sq, int H) {
    const int row = (int)((blockIdx.x * (size_t)BWD_THREADS + threadIdx.x)
                          / 32);
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    float acc = 0.f;
#pragma unroll
    for (int d = lane; d < DV; d += 32)
        acc = fmaf(to_f(out[(size_t)row * DV + d]),
                   to_f(dout[(size_t)row * DV + d]), acc);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
        const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
        dd[((size_t)b * H + h) * Sq + s] = acc;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dkdv(
    const T* __restrict__ q,           // (B, Sq, H, D)
    const T* __restrict__ k,           // (B, Sk, KV, D)
    const T* __restrict__ v,           // (B, Sk, KV, D)
    const T* __restrict__ dout,        // (B, Sq, H, D)
    const float* __restrict__ lse,     // (B, H, Sq)
    const float* __restrict__ dd,      // (B, H, Sq)
    T* __restrict__ dk,                // (B, Sk, KV, D)
    T* __restrict__ dv,                // (B, Sk, KV, D)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    constexpr int LD = BwdShape<D>::LD, NJ = D / 16;
    const int k0 = blockIdx.x * BWD_T, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV, nk = min(BWD_T, Sk - k0);
    extern __shared__ float sm[];
    float* Ks = sm;
    float* Vs = Ks + BWD_T * LD;
    float* Qs = Vs + BWD_T * LD;
    float* dOs = Qs + BWD_T * LD;
    float* Ps = dOs + BWD_T * LD;
    float* dSs = Ps + BWD_T * BWD_LDP;
    float* lse_s = dSs + BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, D>(Ks, k, b, Sk, KV, kvh, k0, nk);
    load_tile<T, D>(Vs, v, b, Sk, KV, kvh, k0, nk);

    // the query rows that see a key of [k0, k0 + nk): qp >= k0 when causal,
    // qp < k0 + nk - 1 + window when windowed
    const int q_lo = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float adk[4][NJ], adv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

    for (int g = 0; g < G; ++g) {
        const int hh = kvh * G + g;
        for (int q0 = q_lo / BWD_T * BWD_T; q0 < q_end; q0 += BWD_T) {
            const int nq = min(BWD_T, Sq - q0);
            __syncthreads();           // the previous tile is consumed
            load_tile<T, D>(Qs, q, b, Sq, H, hh, q0, nq);
            load_tile<T, D>(dOs, dout, b, Sq, H, hh, q0, nq);
            load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0,
                      nq);
            __syncthreads();
            probs<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, dSs, q0, k0, Sq, Sk,
                     causal != 0, window, scale);
            __syncthreads();
            // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, dims tx + 16 j
            for (int qi = 0; qi < nq; ++qi) {
                float p[4], ds[4], o[NJ], a[NJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = Ps[qi * BWD_LDP + ty + 16 * i];
                    ds[i] = dSs[qi * BWD_LDP + ty + 16 * i];
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    o[j] = dOs[qi * LD + tx + 16 * j];
                    a[j] = Qs[qi * LD + tx + 16 * j];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        adv[i][j] = fmaf(p[i], o[j], adv[i][j]);
                        adk[i][j] = fmaf(ds[i], a[j], adk[i][j]);
                    }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = ty + 16 * i;
        if (kj >= nk) continue;
        const size_t at = (((size_t)b * Sk + k0 + kj) * KV + kvh) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            dk[at + tx + 16 * j] = from_f<T>(adk[i][j]);
            dv[at + tx + 16 * j] = from_f<T>(adv[i][j]);
        }
    }
}

// Grid (query tile, head, batch row), the tiles in reverse: the last query
// tiles reach the most keys and start first.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq,                // (B, Sq, H, D)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    constexpr int LD = BwdShape<D>::LD, NJ = D / 16;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_T;
    const int hh = blockIdx.y, b = blockIdx.z;
    const int kvh = hh / (H / KV), nq = min(BWD_T, Sq - q0);
    extern __shared__ float sm[];
    float* Ks = sm;
    float* Vs = Ks + BWD_T * LD;
    float* Qs = Vs + BWD_T * LD;
    float* dOs = Qs + BWD_T * LD;
    float* dSs = dOs + BWD_T * LD;
    float* lse_s = dSs + 2 * BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, D>(Qs, q, b, Sq, H, hh, q0, nq);
    load_tile<T, D>(dOs, dout, b, Sq, H, hh, q0, nq);
    load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0, nq);

    // the keys the tile's queries see: kp <= q0 + nq - 1 when causal,
    // kp > q0 - window when windowed
    const int k_end = causal ? min(Sk, q0 + nq) : Sk;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float adq[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

    for (int k0 = k_lo / BWD_T * BWD_T; k0 < k_end; k0 += BWD_T) {
        const int nk = min(BWD_T, Sk - k0);
        __syncthreads();               // the previous tile is consumed
        load_tile<T, D>(Ks, k, b, Sk, KV, kvh, k0, nk);
        load_tile<T, D>(Vs, v, b, Sk, KV, kvh, k0, nk);
        __syncthreads();
        probs<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, nullptr, dSs, q0, k0, Sq, Sk,
                 causal != 0, window, scale);
        __syncthreads();
        // dQ += dS K: query rows ty + 16 i, dims tx + 16 j
        for (int kj = 0; kj < nk; ++kj) {
            float ds[4], kk[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ds[i] = dSs[(ty + 16 * i) * BWD_LDP + kj];
#pragma unroll
            for (int j = 0; j < NJ; ++j) kk[j] = Ks[kj * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    adq[i][j] = fmaf(ds[i], kk[j], adq[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = ty + 16 * i;
        if (qi >= nq) continue;
        const size_t at = (((size_t)b * Sq + q0 + qi) * H + hh) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            dq[at + tx + 16 * j] = from_f<T>(adq[i][j]);
    }
}

// ---------------------------------------------------------------------------
// the bf16 (64, 64) body on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
// The same two kernels for qwen2's heads in bf16, with every product on the
// tensor cores: S (or S^T) and dP (dP^T) straight from the bf16 tiles,
// f32 sums; P and dS, f32, enter their products (dV, dK, dQ) as three
// bf16 parts (split3_bf16, about 24 bits), as the forward's P V does, so
// the result keeps f32-level accuracy.  Four warps a block, 16 keys (dK/dV)
// or 16 query rows (dQ) a warp over a 64-wide tile of the other side.  The
// dK/dV kernel computes S^T = K Q^T: its accumulators (keys x queries) are
// the A fragments of P^T dO and dS^T Q as they stand, and the dQ kernel
// computes S = Q K^T for dS K likewise.  Tiles are bf16 in shared memory,
// rows padded to 72 values so that ldmatrix reads them without conflicts,
// filled by cp.async (zeros past the last row).
constexpr int MMA_THREADS = 128;
constexpr int MMA_LD = 64 + 8;         // padded bf16 row of a tile
constexpr size_t MMA_SMEM = sizeof(__nv_bfloat16) * 4 * BWD_T * MMA_LD
                          + sizeof(float) * 2 * BWD_T;

// Rows [r0, r0 + n) of a (B, S, heads, 64) bf16 tensor at head ``hh`` into a
// 64 x MMA_LD tile by 16-byte cp.async copies, zeros past n.
__device__ __forceinline__ void mma_load_tile(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int b, int S,
    int heads, int hh, int r0, int n) {
    for (int e = threadIdx.x; e < BWD_T * 8; e += MMA_THREADS) {
        const int i = e / 8, ch = e % 8;
        const bool ok = i < n;
        cp_async16(dst + i * MMA_LD + ch * 8,
                   src + (ok ? (((size_t)b * S + r0 + i) * heads + hh) * 64
                                   + ch * 8 : 0), ok);
    }
}

// acc (16 rows x 64) += X (16 x 64 rows of a tile at x) Y^T (Y: 64 rows of a
// tile at y): the accumulator of n-tile j holds rows gid (+8), columns
// 8 j + 2 tig (+1).
__device__ __forceinline__ void mma_xyt(float (&acc)[8][4],
                                        const __nv_bfloat16* x,
                                        const __nv_bfloat16* y, int lane) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm_x4<false>(a, x + (lane & 15) * MMA_LD + kk * 16
                              + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4<false>(b, y + (np * 16 + (lane >> 4) * 8 + (lane & 7))
                                      * MMA_LD
                                  + kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(acc[2 * np], a, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
    }
}

// acc (16 x 64 dims) += F (16 x 64, f32 in the accumulator layout of
// mma_xyt) Z (Z: the 64 x 64 tile at z, rows the sum's index), F in three
// bf16 parts.  The tile's product is summed on the tensor cores into a
// fresh accumulator and then added to acc on the CUDA cores: the tensor
// cores' f32 accumulation does not round to nearest, and chained over
// the hundreds of tiles a row of dK, dV or dQ sums (448 at qwen2's train
// shape) it drifted by ~6e-4 of the sum, past the bf16 half-step rule;
// twelve products a tile drift by ~1e-6.
__device__ __forceinline__ void mma_fz(float (&acc)[8][4],
                                       const float (&f)[8][4],
                                       const __nv_bfloat16* z, int lane) {
    float t[8][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        uint32_t p[4][3];
        split3_bf16(f[2 * j][0], f[2 * j][1], p[0]);
        split3_bf16(f[2 * j][2], f[2 * j][3], p[1]);
        split3_bf16(f[2 * j + 1][0], f[2 * j + 1][1], p[2]);
        split3_bf16(f[2 * j + 1][2], f[2 * j + 1][3], p[3]);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
            uint32_t b[4];
            ldsm_x4<true>(b, z + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8)
                                     * MMA_LD
                                 + (n + (lane >> 4)) * 8);
#pragma unroll
            for (int part = 0; part < 3; ++part) {
                const uint32_t a[4] = {p[0][part], p[1][part], p[2][part],
                                       p[3][part]};
                mma_bf16(t[n], a, b[0], b[1]);
                mma_bf16(t[n + 1], a, b[2], b[3]);
            }
        }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] += t[n][c];
}

// Write a warp's 16 x 64 f32 accumulator as bf16 rows row0 + gid (+8) of
// a (B, S, heads, 64) tensor at head hh, rows at or past n skipped.
__device__ __forceinline__ void mma_store(__nv_bfloat16* __restrict__ dst,
                                          const float (&acc)[8][4], int b,
                                          int S, int heads, int hh, int row0,
                                          int r, int n, int lane) {
    const int gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
        const int i = r + gid + 8 * h2;
        if (i >= n) continue;
        __nv_bfloat16* row = dst
            + (((size_t)b * S + row0 + i) * heads + hh) * 64 + 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * h2], acc[j][2 * h2 + 1]);
    }
}

__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkdv_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int KV,
    int causal, int window, float scale) {
    const int k0 = blockIdx.x * BWD_T, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV, nk = min(BWD_T, Sk - k0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Vs = Ks + BWD_T * MMA_LD;
    __nv_bfloat16* Qs = Vs + BWD_T * MMA_LD;
    __nv_bfloat16* dOs = Qs + BWD_T * MMA_LD;
    float* lse_s = reinterpret_cast<float*>(dOs + BWD_T * MMA_LD);
    float* dd_s = lse_s + BWD_T;
    mma_load_tile(Ks, k, b, Sk, KV, kvh, k0, nk);
    mma_load_tile(Vs, v, b, Sk, KV, kvh, k0, nk);
    cp_async_commit();

    const int q_lo = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    // this lane's two keys: kp[h2] = k0 + 16 warp + gid + 8 h2
    const int kw = k0 + 16 * warp + gid;
    float adk[8][4] = {}, adv[8][4] = {};
    for (int g = 0; g < G; ++g) {
        const int hh = kvh * G + g;
        for (int q0 = q_lo / BWD_T * BWD_T; q0 < q_end; q0 += BWD_T) {
            const int nq = min(BWD_T, Sq - q0);
            __syncthreads();           // the previous tile is consumed
            mma_load_tile(Qs, q, b, Sq, H, hh, q0, nq);
            mma_load_tile(dOs, dout, b, Sq, H, hh, q0, nq);
            cp_async_commit();
            load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0,
                      nq);
            cp_async_wait_all();
            __syncthreads();
            // S^T and dP^T: rows this warp's 16 keys, columns the queries
            float st[8][4] = {}, dpt[8][4] = {};
            mma_xyt(st, Ks + 16 * warp * MMA_LD, Qs, lane);
            mma_xyt(dpt, Vs + 16 * warp * MMA_LD, dOs, lane);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int qi = 8 * j + 2 * tig + (c & 1);
                    const int qp = q0 + qi, kp = kw + 8 * (c / 2);
                    const bool vis = qi < nq && kp < Sk
                        && (!causal || kp <= qp)
                        && (window <= 0 || qp - kp < window);
                    const float p = vis ? expf(st[j][c] * scale - lse_s[qi])
                                        : 0.f;
                    st[j][c] = p;
                    dpt[j][c] = p * (dpt[j][c] - dd_s[qi]) * scale;
                }
            mma_fz(adv, st, dOs, lane);      // dV += P^T dO
            mma_fz(adk, dpt, Qs, lane);      // dK += scale dS^T Q
        }
    }
    cp_async_wait_all();               // K and V, when no query sees them
    mma_store(dk, adk, b, Sk, KV, kvh, k0, 16 * warp, nk, lane);
    mma_store(dv, adv, b, Sk, KV, kvh, k0, 16 * warp, nk, lane);
}

__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int KV, int causal, int window, float scale) {
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_T;
    const int hh = blockIdx.y, b = blockIdx.z;
    const int kvh = hh / (H / KV), nq = min(BWD_T, Sq - q0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Vs = Ks + BWD_T * MMA_LD;
    __nv_bfloat16* Qs = Vs + BWD_T * MMA_LD;
    __nv_bfloat16* dOs = Qs + BWD_T * MMA_LD;
    float* lse_s = reinterpret_cast<float*>(dOs + BWD_T * MMA_LD);
    float* dd_s = lse_s + BWD_T;
    mma_load_tile(Qs, q, b, Sq, H, hh, q0, nq);
    mma_load_tile(dOs, dout, b, Sq, H, hh, q0, nq);
    cp_async_commit();
    load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0, nq);

    const int k_end = causal ? min(Sk, q0 + nq) : Sk;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    // this lane's two query rows: 16 warp + gid + 8 h2 of the tile
    const int qr = 16 * warp + gid;
    float adq[8][4] = {};
    for (int k0 = k_lo / BWD_T * BWD_T; k0 < k_end; k0 += BWD_T) {
        const int nk = min(BWD_T, Sk - k0);
        __syncthreads();               // the previous tile is consumed
        mma_load_tile(Ks, k, b, Sk, KV, kvh, k0, nk);
        mma_load_tile(Vs, v, b, Sk, KV, kvh, k0, nk);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        // S and dP: rows this warp's 16 queries, columns the keys
        float s[8][4] = {}, dp[8][4] = {};
        mma_xyt(s, Qs + 16 * warp * MMA_LD, Ks, lane);
        mma_xyt(dp, dOs + 16 * warp * MMA_LD, Vs, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int qi = qr + 8 * (c / 2), kp = k0 + 8 * j + 2 * tig
                    + (c & 1);
                const int qp = q0 + qi;
                const bool vis = qi < nq && kp < Sk
                    && (!causal || kp <= qp)
                    && (window <= 0 || qp - kp < window);
                const float p = vis ? expf(s[j][c] * scale - lse_s[qi])
                                    : 0.f;
                s[j][c] = p * (dp[j][c] - dd_s[qi]) * scale;
            }
        mma_fz(adq, s, Ks, lane);            // dQ += scale dS K
    }
    cp_async_wait_all();               // Q and dO, when no key is in reach
    mma_store(dq, adq, b, Sq, H, hh, q0, 16 * warp, nq, lane);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dd, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, float scale, cudaStream_t stream) {
    constexpr bool MMA = sizeof(T) == 2 && D == 64;     // the body (above)
    if (MMA && ((size_t)q | (size_t)k | (size_t)v | (size_t)dout) % 16 != 0)
        return REPRO_UNSUPPORTED;          // read by 16-byte copies
    const int rows = B * Sq * H;
    flash_bwd_dot<T, D><<<(rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32),
                          BWD_THREADS, 0, stream>>>(
        (const T*)out, (const T*)dout, dd, rows, Sq, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 kgrid((Sk + BWD_T - 1) / BWD_T, KV, B);
    const dim3 qgrid((Sq + BWD_T - 1) / BWD_T, H, B);
    if constexpr (MMA) {
        using bf = __nv_bfloat16;
        flash_bwd_dkdv_mma<<<kgrid, MMA_THREADS, MMA_SMEM, stream>>>(
            (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse,
            dd, (bf*)dk, (bf*)dv, Sq, Sk, H, KV, causal, window, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        flash_bwd_dq_mma<<<qgrid, MMA_THREADS, MMA_SMEM, stream>>>(
            (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse,
            dd, (bf*)dq, Sq, Sk, H, KV, causal, window, scale);
    } else {
        constexpr size_t SMEM = BwdShape<D>::SMEM;
        auto dkdv = flash_bwd_dkdv<T, D>;
        auto dqk = flash_bwd_dq<T, D>;
        err = reserve_smem(dkdv, SMEM);
        if (err == cudaSuccess) err = reserve_smem(dqk, SMEM);
        if (err != cudaSuccess) return (int)err;
        dkdv<<<kgrid, BWD_THREADS, SMEM, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
            (T*)dk, (T*)dv, Sq, Sk, H, KV, causal, window, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        dqk<<<qgrid, BWD_THREADS, SMEM, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
            (T*)dq, Sq, Sk, H, KV, causal, window, scale);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, DK), k (B, Sk, KV, DK), v (B, Sk, KV, DV), out and dout (B,
// Sq, H, DV), lse (B, H, Sq) f32 from the forward; dd: (B, H, Sq) f32
// workspace for D; dq, dk, dv shaped like q, k, v.  All contiguous on one
// device.  window <= 0 means none; queries at positions [0, Sq).  Launches
// the three kernels on ``stream`` and returns the first cudaGetLastError()
// that is not cudaSuccess, or REPRO_UNSUPPORTED for a (dtype, DK, DV) no
// kernel was built for.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int DK, int DV,
    int causal, int window, float scale, int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
        return REPRO_UNSUPPORTED;
    const float* lse_f = (const float*)lse;
    float* dd_f = (float*)dd;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DIM)                                                      \
    if (DK == DIM && DV == DIM) {                                            \
        if (dtype == REPRO_F32)                                              \
            return launch<float, DIM>(q, k, v, out, dout, lse_f, dd_f, dq,   \
                                      dk, dv, B, Sq, Sk, H, KV, causal,      \
                                      window, scale, st);                    \
        if (dtype == REPRO_BF16)                                             \
            return launch<__nv_bfloat16, DIM>(q, k, v, out, dout, lse_f,     \
                                              dd_f, dq, dk, dv, B, Sq, Sk,   \
                                              H, KV, causal, window, scale,  \
                                              st);                           \
    }
    REPRO_CASE(64)
    REPRO_CASE(128)
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
