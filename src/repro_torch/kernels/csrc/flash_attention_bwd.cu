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
// other).  The reach of a key tile is the transpose of a query tile's:
// queries at or past its first key when causal, below its last key +
// window when windowed.
//
// What bounds it on the H100: operations.  The visible work is 2 x pairs
// x (3 DK + 2 DV) flops a query head (perf_model.flash_attention_bwd_cost:
// S, dP, dV, dK, dQ), ~2200 flops a byte at qwen2's train shape against
// the card's ~295.  Three bodies, chosen by the wrapper before the launch
// (flash_attention.flash_bwd_body) and refused here for a shape they do
// not take:
//
// Tensor-core body (bf16 at fb_pair (DK, DV): (64, 64), (128, 128) and,
// with the columns split between the warpgroups instead of the keys,
// (192, 128): flash_bwd_wgmma_cols below), three kernels:
//
//   flash_bwd_prep   one warp a (b, s, h) row: D_i, and lse_i log2(e),
//                    into a (B, H, query tile, 2, 64) f32 workspace, one
//                    512-byte piece a (row, head, tile) that a ring stage
//                    takes in one bulk copy (rows past Sq: lse +inf, so
//                    their P is 0); it zeroes the row's f32 dQ sums;
//   flash_bwd_wgmma  one pass over the (key tile, query tile) pairs: S and
//                    dP once a pair, and every gradient from them.  Grid
//                    (b x kv head, 128-key tile), key tiles in ascending
//                    order so that the longest walks (causal: key tile 0
//                    sees every query tile) start first.  A block is two
//                    warpgroups, 64 keys each, whose K and V stay in
//                    shared memory; it walks the G query heads of its kv
//                    head and, for each, the 64-row query tiles in reach.
//                    Their Q, dO and lse/D rows come by TMA (128-byte
//                    swizzle, WgTile's layout) into a ring of NS stages
//                    behind mbarriers; thread 0 refills a stage once every
//                    thread has passed the step after the one that read it
//                    (no producer warp: a ninth warp would put three warps
//                    on one of the SM's four register files and hold every
//                    thread to 168 registers, which spilled).  Per step,
//                    each warpgroup:
//                      S^T = K Q^T, dP^T = V dO^T  (wgmma; at (64, 64) K
//                        and V as register A fragments, loaded once by
//                        ldmatrix, so that only Q and dO are read from
//                        shared memory, whose bandwidth the products of
//                        64-wide tiles share; at (128, 128) both operands
//                        from shared memory, K-major);
//                      P^T and dS^T = P^T (dP^T - D) on its registers;
//                      dS^T to shared memory in two bf16 parts;
//                      dV += P^T dO  (A from registers: the S^T
//                        accumulator layout is wgmma's A fragment layout,
//                        as the forward's P V; dO read MN-major);
//                      dK += dS^T Q  (A the dS^T parts, Q read MN-major);
//                      dQ = dS K over the block's 128 keys (after a barrier
//                        of both warpgroups), this warpgroup's half of the
//                        columns (dS^T read transposed, K MN-major), added
//                        into an f32 (B, Sq, H, DK) sum by 8-byte atomics;
//                    dK and dV stay in registers and are written once.  P
//                    and dS enter their products as two bf16 parts (hi =
//                    bf16(x), lo = bf16(x - hi), about 16 bits; a part
//                    errs by up to 2^-17 of a weight): the work on the
//                    tensor cores is 2 x pairs x (5 DK + 3 DV) flops, 1024
//                    a pair and head at (64, 64), 1.6x the counted.  Three
//                    parts (1408) held the same bf16 shares at 4 x 4096 and
//                    took 1.19x the time (PERF.md section 6).  Each tile's
//                    dK and dV product starts from a fresh accumulator and
//                    is added on the CUDA cores: the tensor cores' f32
//                    accumulation does not round to nearest, and chained
//                    over the hundreds of tiles a row of dK sums (448 at
//                    qwen2's train shape) it drifted past the bf16
//                    half-step rule;
//   flash_bwd_dq_out scale, one rounding to bf16.
//
//   dK and dV are each one block's sums in a fixed order, so they replay
//   bit for bit.  dQ's f32 sums arrive by atomics in the order the blocks
//   reach them, so bf16 dq can differ by one rounding between runs.
//
// FMA body (f32, where f32 must stay f32: never TF32; bf16 at (96, 64),
// whose 96 is no multiple of the tensor-core body's 64-value column
// blocks; and bf16 at the tensor-core body's pairs when torch's
// deterministic switch is on, for a dQ without atomics: tiles widened to
// f32 on load, outputs rounded once), three kernels:
//
//   flash_bwd_dot   D_i, (B, H, Sq) f32, one warp a (token, head) row;
//   flash_bwd_dkdv  grid (64-key tile, kv head, batch row): the block holds
//                   its keys' K and V and walks the G query heads of its kv
//                   head and, for each, the 64-row query tiles in the key
//                   tile's reach, accumulating dK and dV in registers, and
//                   writes them once (no atomics: replays bit for bit);
//   flash_bwd_dq    grid (64-row query tile, head, batch row): the block
//                   holds its queries' Q, dO, lse and D and walks the key
//                   tiles in reach, accumulating dQ in registers.
//
//   Each thread of a 256-thread block owns a 4 x 4 tile of the 64 x 64
//   scores (rows ty + 16 i, keys tx + 16 j) and, for the accumulations, 4
//   keys (or queries) x DK / 16 dims, reading shared tiles padded to an odd
//   row length so that neither the row-strided nor the column reads
//   conflict.  It recomputes S and dP in its dQ kernel.
//
// At (256, 256) (recurrentgemma-2b's LOCAL_ATTN) two bodies, each a dK/dV
// pass and a dQ pass with no atomics (one kv head over 4096 keys gives
// only 64 key tiles, and dQ's atomics from every key block would be ~1 GB
// of f32 adds a call there):
//
//   bf16 (flash_attention.flash_bwd_body "wide"): flash_bwd_wide_dkdv and
//   flash_bwd_wide_dq on wgmma, each a block a 64-row tile fed by TMA
//   through a ring behind mbarriers, the warpgroups splitting the queries
//   (or keys) of S and dP and the head dims of dK and dV (or dQ); every
//   tile of 256 bf16 head dims whole in shared memory, 226 KB and 210 KB a
//   block (see the section's comment below);
//   f32 (the identity runs): flash_bwd_dkdv_wide and flash_bwd_dq_wide on
//   FMAs.  The four whole 64 x 257 f32 tiles would take 263 KB of shared
//   memory, past the 227 KB a block has, so each holds the block's own two
//   tiles whole (K and V, or Q and dO) and takes the other side's in
//   64-dim chunks, S and dP summed over the chunks and dK, dV or dQ formed
//   a chunk of dims at a time (their 64 or 128 accumulators a thread stay
//   in registers); the other side's tiles are read twice a tile pair.
//
// Both give each query head its own dK/dV block and flash_bwd_wide_sum
// adds a kv head's f32 partials in order.
//
// dq, dk and dv are rounded once, at the store.  (DK, DV) pairs built:
// (64, 64), (128, 128) and (192, 128) in both bodies (the FMA body in f32
// and bf16), (96, 64) in the FMA body (f32 and bf16), (256, 256) in the
// wide bodies (FMAs in f32, wgmma in bf16).

#include "common.cuh"

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_T = 64;              // query rows and keys a tile
constexpr int BWD_LDP = BWD_T + 1;     // padded row of the P and dS tiles

template <int DK, int DV>
struct BwdShape {
    // padded rows of a Q or K tile and of a dO or V tile (odd lengths)
    static constexpr int LDK = DK + 1, LDV = DV + 1;
    // Q, K, dO, V tiles, P and dS tiles, lse and D of the query tile
    static constexpr size_t SMEM =
        sizeof(float) * (2 * BWD_T * (LDK + LDV) + 2 * BWD_T * BWD_LDP
                         + 2 * BWD_T);
};

// Rows [r0, r0 + n) of a (B, S, heads, D) tensor at head ``hh`` into a
// 64 x (D + 1) f32 tile, zeros past n.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int b, int S, int heads, int hh,
                                          int r0, int n) {
    constexpr int LD = D + 1;
    for (int e = threadIdx.x; e < BWD_T * D; e += BWD_THREADS) {
        const int i = e / D, d = e % D;
        dst[i * LD + d] = i < n
            ? to_f(src[(((size_t)b * S + r0 + i) * heads + hh) * D + d])
            : 0.f;
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
template <int DK, int DV>
__device__ __forceinline__ void probs(const float* Qs, const float* dOs,
                                      const float* Ks, const float* Vs,
                                      const float* lse_s, const float* dd_s,
                                      float* Ps, float* dSs, int q0, int k0,
                                      int Sq, int Sk, bool causal, int window,
                                      float scale) {
    constexpr int LDK = BwdShape<DK, DV>::LDK, LDV = BwdShape<DK, DV>::LDV;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a[i] = Qs[(ty + 16 * i) * LDK + d];
            kk[i] = Ks[(tx + 16 * i) * LDK + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
        float c[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            c[i] = dOs[(ty + 16 * i) * LDV + d];
            vv[i] = Vs[(tx + 16 * i) * LDV + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dp[i][j] = fmaf(c[i], vv[j], dp[i][j]);
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

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dkdv(
    const T* __restrict__ q,           // (B, Sq, H, DK)
    const T* __restrict__ k,           // (B, Sk, KV, DK)
    const T* __restrict__ v,           // (B, Sk, KV, DV)
    const T* __restrict__ dout,        // (B, Sq, H, DV)
    const float* __restrict__ lse,     // (B, H, Sq)
    const float* __restrict__ dd,      // (B, H, Sq)
    T* __restrict__ dk,                // (B, Sk, KV, DK)
    T* __restrict__ dv,                // (B, Sk, KV, DV)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    constexpr int LDK = BwdShape<DK, DV>::LDK, LDV = BwdShape<DK, DV>::LDV;
    constexpr int NK = DK / 16, NV = DV / 16;
    const int k0 = blockIdx.x * BWD_T, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV, nk = min(BWD_T, Sk - k0);
    extern __shared__ float sm[];
    float* Ks = sm;
    float* Qs = Ks + BWD_T * LDK;
    float* Vs = Qs + BWD_T * LDK;
    float* dOs = Vs + BWD_T * LDV;
    float* Ps = dOs + BWD_T * LDV;
    float* dSs = Ps + BWD_T * BWD_LDP;
    float* lse_s = dSs + BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, DK>(Ks, k, b, Sk, KV, kvh, k0, nk);
    load_tile<T, DV>(Vs, v, b, Sk, KV, kvh, k0, nk);

    // the query rows that see a key of [k0, k0 + nk): qp >= k0 when causal,
    // qp < k0 + nk - 1 + window when windowed
    const int q_lo = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float adk[4][NK], adv[4][NV];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NK; ++j) adk[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) adv[i][j] = 0.f;
    }

    for (int g = 0; g < G; ++g) {
        const int hh = kvh * G + g;
        for (int q0 = q_lo / BWD_T * BWD_T; q0 < q_end; q0 += BWD_T) {
            const int nq = min(BWD_T, Sq - q0);
            __syncthreads();           // the previous tile is consumed
            load_tile<T, DK>(Qs, q, b, Sq, H, hh, q0, nq);
            load_tile<T, DV>(dOs, dout, b, Sq, H, hh, q0, nq);
            load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0,
                      nq);
            __syncthreads();
            probs<DK, DV>(Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, dSs, q0, k0, Sq,
                          Sk, causal != 0, window, scale);
            __syncthreads();
            // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, dims tx + 16 j
            for (int qi = 0; qi < nq; ++qi) {
                float p[4], ds[4], o[NV], a[NK];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = Ps[qi * BWD_LDP + ty + 16 * i];
                    ds[i] = dSs[qi * BWD_LDP + ty + 16 * i];
                }
#pragma unroll
                for (int j = 0; j < NV; ++j) o[j] = dOs[qi * LDV + tx + 16 * j];
#pragma unroll
                for (int j = 0; j < NK; ++j) a[j] = Qs[qi * LDK + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int j = 0; j < NV; ++j)
                        adv[i][j] = fmaf(p[i], o[j], adv[i][j]);
#pragma unroll
                    for (int j = 0; j < NK; ++j)
                        adk[i][j] = fmaf(ds[i], a[j], adk[i][j]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = ty + 16 * i;
        if (kj >= nk) continue;
        const size_t at = ((size_t)b * Sk + k0 + kj) * KV + kvh;
#pragma unroll
        for (int j = 0; j < NK; ++j)
            dk[at * DK + tx + 16 * j] = from_f<T>(adk[i][j]);
#pragma unroll
        for (int j = 0; j < NV; ++j)
            dv[at * DV + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
}

// Grid (query tile, head, batch row), the tiles in reverse: the last query
// tiles reach the most keys and start first.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq,                // (B, Sq, H, DK)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    constexpr int LDK = BwdShape<DK, DV>::LDK, LDV = BwdShape<DK, DV>::LDV;
    constexpr int NK = DK / 16;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_T;
    const int hh = blockIdx.y, b = blockIdx.z;
    const int kvh = hh / (H / KV), nq = min(BWD_T, Sq - q0);
    extern __shared__ float sm[];
    float* Ks = sm;
    float* Qs = Ks + BWD_T * LDK;
    float* Vs = Qs + BWD_T * LDK;
    float* dOs = Vs + BWD_T * LDV;
    float* dSs = dOs + BWD_T * LDV;
    float* lse_s = dSs + 2 * BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, DK>(Qs, q, b, Sq, H, hh, q0, nq);
    load_tile<T, DV>(dOs, dout, b, Sq, H, hh, q0, nq);
    load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0, nq);

    // the keys the tile's queries see: kp <= q0 + nq - 1 when causal,
    // kp > q0 - window when windowed
    const int k_end = causal ? min(Sk, q0 + nq) : Sk;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float adq[4][NK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) adq[i][j] = 0.f;

    for (int k0 = k_lo / BWD_T * BWD_T; k0 < k_end; k0 += BWD_T) {
        const int nk = min(BWD_T, Sk - k0);
        __syncthreads();               // the previous tile is consumed
        load_tile<T, DK>(Ks, k, b, Sk, KV, kvh, k0, nk);
        load_tile<T, DV>(Vs, v, b, Sk, KV, kvh, k0, nk);
        __syncthreads();
        probs<DK, DV>(Qs, dOs, Ks, Vs, lse_s, dd_s, nullptr, dSs, q0, k0, Sq,
                      Sk, causal != 0, window, scale);
        __syncthreads();
        // dQ += dS K: query rows ty + 16 i, dims tx + 16 j
        for (int kj = 0; kj < nk; ++kj) {
            float ds[4], kk[NK];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ds[i] = dSs[(ty + 16 * i) * BWD_LDP + kj];
#pragma unroll
            for (int j = 0; j < NK; ++j) kk[j] = Ks[kj * LDK + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NK; ++j)
                    adq[i][j] = fmaf(ds[i], kk[j], adq[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = ty + 16 * i;
        if (qi >= nq) continue;
        const size_t at = (((size_t)b * Sq + q0 + qi) * H + hh) * DK;
#pragma unroll
        for (int j = 0; j < NK; ++j)
            dq[at + tx + 16 * j] = from_f<T>(adq[i][j]);
    }
}

// ---------------------------------------------------------------------------
// the FMA body at (256, 256): the head dims in 64-wide chunks
// ---------------------------------------------------------------------------
constexpr int BW_DC = 64;              // head dims a chunk
constexpr int BW_LDC = BW_DC + 1;      // its padded row

template <int D>
struct BwdWide {
    static constexpr int LD = D + 1;
    // the block's own two tiles whole (K and V, or Q and dO), a chunk of
    // each of the other side's two, P and dS (or dS and a spare), lse, D
    static constexpr size_t SMEM =
        sizeof(float) * (2 * BWD_T * LD + 2 * BWD_T * BW_LDC
                         + 2 * BWD_T * BWD_LDP + 2 * BWD_T);
};

// Dims [c0, c0 + 64) of rows [r0, r0 + n) of a (B, S, heads, D) tensor at
// head ``hh`` into a 64 x 65 f32 tile, zeros past n.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const T* __restrict__ src, int b,
                                           int S, int heads, int hh, int r0,
                                           int n, int c0) {
    for (int e = threadIdx.x; e < BWD_T * BW_DC; e += BWD_THREADS) {
        const int i = e / BW_DC, d = e % BW_DC;
        dst[i * BW_LDC + d] = i < n
            ? to_f(src[(((size_t)b * S + r0 + i) * heads + hh) * D + c0 + d])
            : 0.f;
    }
}

// P and scale dS of a tile pair from the scores s and dP accumulated by
// this thread (query rows ty + 16 i, keys tx + 16 j), as probs() forms them
__device__ __forceinline__ void wide_probs(const float (&s)[4][4],
                                           const float (&dp)[4][4],
                                           const float* lse_s,
                                           const float* dd_s, float* Ps,
                                           float* dSs, int q0, int k0,
                                           int Sq, int Sk, bool causal,
                                           int window, float scale) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
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
            dSs[qi * BWD_LDP + kj] = p * (dp[i][j] - dd_s[qi]) * scale;
        }
    }
}

// s += A B^T over one chunk: A rows ty + 16 i of a, B rows tx + 16 j of bb
// (row lengths lda, ldb), 64 dims from column ca of a and cb of bb
__device__ __forceinline__ void wide_scores(float (&s)[4][4], const float* a,
                                            int lda, int ca, const float* bb,
                                            int ldb, int cb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int d = 0; d < BW_DC; ++d) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[i] = a[(ty + 16 * i) * lda + ca + d];
            y[i] = bb[(tx + 16 * i) * ldb + cb + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
}

// Row of query head hh's partial for key j of row b: the partials are laid
// out (G, B, Sk, KV, 2 D), so a kv head's G partials of one key lie a
// (B Sk KV) row apart for flash_bwd_wide_sum
__device__ __forceinline__ size_t wide_part_row(int b, int j, int hh, int Sk,
                                                int H, int KV) {
    const int G = H / KV;
    return ((size_t)(hh % G) * gridDim.z + b) * Sk * KV
           + (size_t)j * KV + hh / G;
}

// One block a (key tile, query head, row): it writes the head's f32
// partial dK and dV, and flash_bwd_wide_sum adds the kv head's G partials
// in order.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dkdv_wide(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ part, int Sq, int Sk, int H, int KV, int causal,
    int window, float scale) {
    constexpr int LD = BwdWide<D>::LD, NJ = D / 16, NC = D / BW_DC;
    const int k0 = blockIdx.x * BWD_T, b = blockIdx.z, hh = blockIdx.y;
    const int kvh = hh / (H / KV), nk = min(BWD_T, Sk - k0);
    extern __shared__ float sm[];
    float* Ks = sm;
    float* Vs = Ks + BWD_T * LD;
    float* Qc = Vs + BWD_T * LD;
    float* dOc = Qc + BWD_T * BW_LDC;
    float* Ps = dOc + BWD_T * BW_LDC;
    float* dSs = Ps + BWD_T * BWD_LDP;
    float* lse_s = dSs + BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, D>(Ks, k, b, Sk, KV, kvh, k0, nk);
    load_tile<T, D>(Vs, v, b, Sk, KV, kvh, k0, nk);
    const int q_lo = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float adk[4][NJ], adv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

    for (int q0 = q_lo / BWD_T * BWD_T; q0 < q_end; q0 += BWD_T) {
        const int nq = min(BWD_T, Sq - q0);
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        for (int c = 0; c < NC; ++c) {
            __syncthreads();       // the chunks and rows consumed
            if (c == 0)
                load_rows(lse_s, dd_s, lse, dd,
                          ((size_t)b * H + hh) * Sq + q0, nq);
            load_chunk<T, D>(Qc, q, b, Sq, H, hh, q0, nq, c * BW_DC);
            load_chunk<T, D>(dOc, dout, b, Sq, H, hh, q0, nq, c * BW_DC);
            __syncthreads();
            wide_scores(s, Qc, BW_LDC, 0, Ks, LD, c * BW_DC);
            wide_scores(dp, dOc, BW_LDC, 0, Vs, LD, c * BW_DC);
        }
        wide_probs(s, dp, lse_s, dd_s, Ps, dSs, q0, k0, Sq, Sk,
                   causal != 0, window, scale);
        // dV += P^T dO, dK += dS^T Q a chunk of dims at a time: keys
        // ty + 16 i, dims 64 c + tx + 16 jj
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            __syncthreads();       // P and dS written, Qc free
            load_chunk<T, D>(Qc, q, b, Sq, H, hh, q0, nq, c * BW_DC);
            load_chunk<T, D>(dOc, dout, b, Sq, H, hh, q0, nq, c * BW_DC);
            __syncthreads();
            for (int qi = 0; qi < nq; ++qi) {
                float p[4], ds[4], o[4], a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = Ps[qi * BWD_LDP + ty + 16 * i];
                    ds[i] = dSs[qi * BWD_LDP + ty + 16 * i];
                    o[i] = dOc[qi * BW_LDC + tx + 16 * i];
                    a[i] = Qc[qi * BW_LDC + tx + 16 * i];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        adv[i][4 * c + jj] =
                            fmaf(p[i], o[jj], adv[i][4 * c + jj]);
                        adk[i][4 * c + jj] =
                            fmaf(ds[i], a[jj], adk[i][4 * c + jj]);
                    }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = ty + 16 * i;
        if (kj >= nk) continue;
        // the head's f32 partials, dK then dV
        float* pp = part + wide_part_row(b, k0 + kj, hh, Sk, H, KV) * 2 * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            pp[tx + 16 * j] = adk[i][j];
            pp[D + tx + 16 * j] = adv[i][j];
        }
    }
}

// dK and dV from the query heads' f32 partials, a kv head's G summed in
// head order and rounded once: one thread a value of the (rows = B Sk KV,
// 2 D) outputs, the partials (G, rows, 2 D)
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_wide_sum(
    const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    size_t rows, int G) {
    const size_t i = (size_t)blockIdx.x * BWD_THREADS + threadIdx.x;
    if (i >= rows * 2 * D) return;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += part[g * rows * 2 * D + i];
    const size_t row = i / (2 * D);
    const int d = (int)(i % (2 * D));
    if (d < D) dk[row * D + d] = from_f<T>(acc);
    else dv[row * D + d - D] = from_f<T>(acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_dq_wide(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
    int window, float scale) {
    constexpr int LD = BwdWide<D>::LD, NJ = D / 16, NC = D / BW_DC;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_T;
    const int hh = blockIdx.y, b = blockIdx.z;
    const int kvh = hh / (H / KV), nq = min(BWD_T, Sq - q0);
    extern __shared__ float sm[];
    float* Qs = sm;
    float* dOs = Qs + BWD_T * LD;
    float* Kc = dOs + BWD_T * LD;
    float* Vc = Kc + BWD_T * BW_LDC;
    float* dSs = Vc + BWD_T * BW_LDC;
    float* lse_s = dSs + 2 * BWD_T * BWD_LDP;
    float* dd_s = lse_s + BWD_T;
    load_tile<T, D>(Qs, q, b, Sq, H, hh, q0, nq);
    load_tile<T, D>(dOs, dout, b, Sq, H, hh, q0, nq);
    load_rows(lse_s, dd_s, lse, dd, ((size_t)b * H + hh) * Sq + q0, nq);
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
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        for (int c = 0; c < NC; ++c) {
            __syncthreads();           // the chunks consumed
            load_chunk<T, D>(Kc, k, b, Sk, KV, kvh, k0, nk, c * BW_DC);
            load_chunk<T, D>(Vc, v, b, Sk, KV, kvh, k0, nk, c * BW_DC);
            __syncthreads();
            wide_scores(s, Qs, LD, c * BW_DC, Kc, BW_LDC, 0);
            wide_scores(dp, dOs, LD, c * BW_DC, Vc, BW_LDC, 0);
        }
        wide_probs(s, dp, lse_s, dd_s, nullptr, dSs, q0, k0, Sq, Sk,
                   causal != 0, window, scale);
        // dQ += dS K a chunk of dims at a time: query rows ty + 16 i, dims
        // 64 c + tx + 16 jj
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            __syncthreads();           // dS written, Kc free
            load_chunk<T, D>(Kc, k, b, Sk, KV, kvh, k0, nk, c * BW_DC);
            __syncthreads();
            for (int kj = 0; kj < nk; ++kj) {
                float ds[4], kk[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    ds[i] = dSs[(ty + 16 * i) * BWD_LDP + kj];
                    kk[i] = Kc[kj * BW_LDC + tx + 16 * i];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        adq[i][4 * c + jj] =
                            fmaf(ds[i], kk[jj], adq[i][4 * c + jj]);
            }
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
// the tensor-core body (bf16): one fused wgmma pass (see the header)
// ---------------------------------------------------------------------------
constexpr int FB_KEYS = 128;        // keys a block: 64 a consumer warpgroup
constexpr int FB_Q = 64;            // query rows a ring stage
constexpr int FB_THREADS = 256;     // two warpgroups
constexpr int FB_PREP_THREADS = 256;
constexpr float FB_LOG2E = 1.4426950408889634f;

// (DK, DV) pairs of the tensor-core body: the key split, then the column
// split (flash_bwd_wgmma_cols)
__host__ __device__ constexpr bool fb_cols(int dk, int dv) {
    return dk == 192 && dv == 128;
}
__host__ __device__ constexpr bool fb_pair(int dk, int dv) {
    return (dk == 64 && dv == 64) || (dk == 128 && dv == 128)
        || fb_cols(dk, dv);
}

// Shared memory, from a 1024-byte aligned base: the two warpgroups' K and
// V tiles, the ring's Q and dO tiles, two buffers (a step's and the one
// before, still read by the other warpgroup's dQ) of both warpgroups' dS^T
// parts, then each stage's lse log2(e) and D rows.  Every tile is one or
// more 64-row, 128-byte swizzle blocks (WgTile) on a 1024-byte boundary.
template <int DK, int DV>
struct FbShape {
    static constexpr int NS = DK + DV > 128 ? 2 : 3;   // ring stages
    static constexpr uint32_t KH = 64 * DK * 2;        // a warpgroup's K
    static constexpr uint32_t VH = 64 * DV * 2;
    static constexpr uint32_t QT = FB_Q * DK * 2;      // a stage's Q
    static constexpr uint32_t OT = FB_Q * DV * 2;      // its dO
    static constexpr uint32_t STAGE = QT + OT;
    static constexpr uint32_t DS = 64 * FB_Q * 2;      // one dS^T part
    static constexpr uint32_t V_AT = 2 * KH;
    static constexpr uint32_t RING_AT = V_AT + 2 * VH;
    static constexpr uint32_t DS_AT = RING_AT + NS * STAGE;
    static constexpr uint32_t ROWS_AT = DS_AT + 2 * 2 * 2 * DS;
    static constexpr uint32_t ROWS = 2 * FB_Q * 4;     // a stage's lse, D
    static constexpr size_t SMEM = 1024 + ROWS_AT + NS * ROWS;
};

// Keeps the parts of a register A operand untouched until its wgmma group
// is waited for: the tensor cores read them after the issuing asm.
__device__ __forceinline__ void keep_parts(const uint32_t (&pp)[2][4][4]) {
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                asm volatile("" :: "r"(pp[part][kk][x]) : "memory");
}

// dS^T part ``part`` of warpgroup ``w`` in buffer ``buf``, from the base
template <int DK, int DV>
__device__ __forceinline__ uint32_t fb_ds(int buf, int w, int part) {
    using Sh = FbShape<DK, DV>;
    return Sh::DS_AT + ((buf * 2 + w) * 2 + part) * Sh::DS;
}

// D_i = sum_d dO_i o_i and lse_i log2(e) into the ring's row pieces, one
// warp a (b, s, h) row for s < the padded Sq, h fastest; a row's f32 dQ
// sum zeroed (dq_acc null: none, the (256, 256) body sums dQ in
// registers).  Rows past Sq: lse +inf (their P is 0), D 0.
template <int DK, int DV>
__global__ void __launch_bounds__(FB_PREP_THREADS) flash_bwd_prep(
    const __nv_bfloat16* __restrict__ out,    // (B, Sq, H, DV)
    const __nv_bfloat16* __restrict__ dout,   // (B, Sq, H, DV)
    const float* __restrict__ lse,            // (B, H, Sq)
    float* __restrict__ rows,                 // (B, H, nqt, 2, 64)
    float* __restrict__ dq_acc,               // (B, Sq, H, DK) or null
    int B, int Sq, int H, int nqt) {
    const long long row = ((long long)blockIdx.x * FB_PREP_THREADS
                           + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    const int sp = nqt * FB_Q;
    if (row >= (long long)B * sp * H) return;
    const int h = (int)(row % H), s = (int)(row / H % sp);
    const int b = (int)(row / ((long long)H * sp));
    float* dst = rows + (((size_t)b * H + h) * nqt + s / FB_Q) * (2 * FB_Q)
               + s % FB_Q;
    if (s >= Sq) {
        if (lane == 0) {
            dst[0] = INFINITY;
            dst[FB_Q] = 0.f;
        }
        return;
    }
    const size_t at = ((size_t)b * Sq + s) * H + h;
    float acc = 0.f;
#pragma unroll
    for (int d = 2 * lane; d < DV; d += 64) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + at * DV + d));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + at * DV + d));
        acc = fmaf(o.x, g.x, fmaf(o.y, g.y, acc));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (dq_acc != nullptr)
#pragma unroll
        for (int d = 2 * lane; d < DK; d += 64)
            *reinterpret_cast<float2*>(dq_acc + at * DK + d) =
                make_float2(0.f, 0.f);
    if (lane == 0) {
        dst[0] = lse[((size_t)b * H + h) * Sq + s] * FB_LOG2E;
        dst[FB_Q] = acc;
    }
}

// Step t's loads into ring stage t % NS of a ring of Q/dO stages (shape
// Sh), by one thread: Q and dO of query head kvh G + t / nt, query tile
// t_lo + t % nt, and the tile's lse log2(e) and D rows
template <typename Sh, int DK, int DV>
__device__ __forceinline__ void fb_load_step(
    unsigned char* sm, uint64_t* full, const CUtensorMap* q_map,
    const CUtensorMap* do_map, const float* __restrict__ rows, int t, int b,
    int kvh, int G, int H, int nt, int t_lo, int nqt) {
    const int s = t % Sh::NS, hh = kvh * G + t / nt, qt = t_lo + t % nt;
    unsigned char* st = sm + Sh::RING_AT + s * Sh::STAGE;
    mbar_arrive_expect_tx(&full[s], Sh::STAGE + Sh::ROWS);
#pragma unroll
    for (int c = 0; c < DK / 64; ++c)
        tma_load_4d(st + c * 8192, q_map, c * 64, hh, qt * FB_Q, b, &full[s]);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
        tma_load_4d(st + Sh::QT + c * 8192, do_map, c * 64, hh, qt * FB_Q, b,
                    &full[s]);
    bulk_load(sm + Sh::ROWS_AT + s * Sh::ROWS,
              rows + (((size_t)b * H + hh) * nqt + qt) * (2 * FB_Q), Sh::ROWS,
              &full[s]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_wgmma(
    const __grid_constant__ CUtensorMap q_map,    // q (B, Sq, H, DK)
    const __grid_constant__ CUtensorMap k_map,    // k (B, Sk, KV, DK)
    const __grid_constant__ CUtensorMap v_map,    // v (B, Sk, KV, DV)
    const __grid_constant__ CUtensorMap do_map,   // dout (B, Sq, H, DV)
    const float* __restrict__ rows,               // flash_bwd_prep's
    float* __restrict__ dq_acc,                   // (B, Sq, H, DK), zeroed
    __nv_bfloat16* __restrict__ dk,               // (B, Sk, KV, DK)
    __nv_bfloat16* __restrict__ dv,               // (B, Sk, KV, DV)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    static_assert(DK % 64 == 0 && DV % 64 == 0, "64-value column blocks");
    using Sh = FbShape<DK, DV>;
    using TK = WgTile<DK>;
    using TV = WgTile<DV>;
    using TS = WgTile<FB_Q>;
    constexpr int NS = Sh::NS;
    __shared__ uint64_t kv_full, full[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* sm = smem_raw + (base - raw);

    const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
    const int k0 = blockIdx.y * FB_KEYS;
    const int G = H / KV, nk = min(FB_KEYS, Sk - k0);
    const int nqt = (Sq + FB_Q - 1) / FB_Q;
    // the query tiles in the key tile's reach, [t_lo, t_lo + nt), for each
    // of the G heads: a step is one (head, query tile)
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int t_lo = causal ? k0 / FB_Q : 0;
    const int nt = max(0, (q_end + FB_Q - 1) / FB_Q - t_lo);
    const int steps = G * nt;

    // step t's loads into its ring stage, by thread 0
    auto load_step = [&](int t) {
        fb_load_step<Sh, DK, DV>(sm, full, &q_map, &do_map, rows, t, b, kvh,
                                 G, H, nt, t_lo, nqt);
    };
    if (threadIdx.x == 0) {
        mbar_init(&kv_full, 1);
#pragma unroll
        for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // the block's K and V once, the first NS steps' stages
        mbar_arrive_expect_tx(&kv_full, 2 * (Sh::KH + Sh::VH));
#pragma unroll
        for (int w = 0; w < 2; ++w) {
#pragma unroll
            for (int c = 0; c < DK / 64; ++c)
                tma_load_4d(sm + w * Sh::KH + c * 8192, &k_map, c * 64, kvh,
                            k0 + 64 * w, b, &kv_full);
#pragma unroll
            for (int c = 0; c < DV / 64; ++c)
                tma_load_4d(sm + Sh::V_AT + w * Sh::VH + c * 8192, &v_map,
                            c * 64, kvh, k0 + 64 * w, b, &kv_full);
        }
        for (int t = 0; t < min(NS, steps); ++t) load_step(t);
    }
    __syncthreads();

    // ---- consumer warpgroup wg: keys k0 + 64 wg .. + 63 ----
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    const int kb = k0 + 64 * wg;
    const int kr = kb + 16 * warp + gid;   // this thread's keys kr, kr + 8
    const float sl2 = scale * FB_LOG2E;
    const uint32_t ka = base + wg * Sh::KH, va = base + Sh::V_AT + wg * Sh::VH;
    // dK and dV: acc[4 j + 2 i + c] is key kr + 8 i, column 8 j + 2 tig + c
    float adk[DK / 2], adv[DV / 2];
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) adk[j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) adv[j] = 0.f;
    mbar_wait(&kv_full, 0);
    // at (64, 64) this warp's K and V rows as wgmma A fragments, held for
    // the whole walk (ldmatrix: lanes 0-15 give rows 16 warp + lane of the
    // first 8 values of a 16-value step, lanes 16-31 of the second 8)
    constexpr bool KV_REGS = DK == 64 && DV == 64;
    uint32_t kf[KV_REGS ? 4 : 1][4], vf[KV_REGS ? 4 : 1][4];
    if constexpr (KV_REGS) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = TK::template at<64>(16 * warp + (lane & 15),
                                                     2 * kk + (lane >> 4));
            ldsm_x4<false>(kf[kk], reinterpret_cast<const __nv_bfloat16*>(
                sm + wg * Sh::KH + off));
            ldsm_x4<false>(vf[kk], reinterpret_cast<const __nv_bfloat16*>(
                sm + Sh::V_AT + wg * Sh::VH + off));
        }
    }

    for (int t = 0; t < steps; ++t) {
        const int s = t % NS, hh = kvh * G + t / nt;
        const int q0 = (t_lo + t % nt) * FB_Q;
        mbar_wait(&full[s], (t / NS) & 1);
        const uint32_t qa = base + Sh::RING_AT + s * Sh::STAGE;
        const uint32_t oa = qa + Sh::QT;

        // S^T = K Q^T and dP^T = V dO^T: st[4 j + 2 i + c] is key kr + 8 i,
        // query q0 + 8 j + 2 tig + c
        float st[32], dpt[32];
        wg_fence();
        if constexpr (KV_REGS) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<0>(st, kf[kk], TK::template desc<FB_Q>(qa, kk * 16),
                            kk > 0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<0>(dpt, vf[kk],
                            TV::template desc<FB_Q>(oa, kk * 16), kk > 0);
        } else {
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk)
                wgmma_ss(st, TK::template desc<64>(ka, kk * 16),
                         TK::template desc<FB_Q>(qa, kk * 16), kk > 0);
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk)
                wgmma_ss(dpt, TV::template desc<64>(va, kk * 16),
                         TV::template desc<FB_Q>(oa, kk * 16), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        wg_pin(st);
        wg_pin(dpt);

        // P^T = 2^(S^T scale log2 e - lse log2 e) where visible, else 0;
        // dS^T = P^T (dP^T - D) (scale at the end).  A tile every pair of
        // which is visible needs no mask; query rows past Sq have lse +inf.
        const float* lr = reinterpret_cast<const float*>(
            sm + Sh::ROWS_AT + s * Sh::ROWS);
        const bool whole = kb + 63 < Sk
            && (!causal || kb + 63 <= q0)
            && (window <= 0 || q0 + FB_Q - 1 - kb < window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                lr + 8 * j + 2 * tig);
            const float2 dd = *reinterpret_cast<const float2*>(
                lr + FB_Q + 8 * j + 2 * tig);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int x = 4 * j + e, c = e & 1;
                float p = exp2_ftz(fmaf(st[x], sl2, -(c ? l2.y : l2.x)));
                if (!whole) {
                    const int kp = kr + 8 * (e / 2);
                    const int qp = q0 + 8 * j + 2 * tig + c;
                    const bool vis = kp < Sk && (!causal || kp <= qp)
                        && (window <= 0 || qp - kp < window);
                    p = vis ? p : 0.f;
                }
                st[x] = p;
                dpt[x] = p * (dpt[x] - (c ? dd.y : dd.x));
            }
        }

        // dS^T in two bf16 parts into this step's buffer, rows this
        // thread's keys, columns the queries (a 32-bit pair a store)
        const int buf = t & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint32_t hi, lo;
                split2_bf16(dpt[4 * j + 2 * i], dpt[4 * j + 2 * i + 1], hi,
                            lo);
                const uint32_t off = TS::template at<64>(
                    16 * warp + gid + 8 * i, j) + 4 * tig;
                *reinterpret_cast<uint32_t*>(
                    sm + fb_ds<DK, DV>(buf, wg, 0) + off) = hi;
                *reinterpret_cast<uint32_t*>(
                    sm + fb_ds<DK, DV>(buf, wg, 1) + off) = lo;
            }
        fence_proxy_async();

        // dV tile = P^T dO from a fresh accumulator: P^T's A fragments
        // (queries 16 kk + 2 tig (+ 8): accumulator entries 8 kk .. 8 kk +
        // 7) in two bf16 parts, pp[part][kk]; dO's 16 rows of a step two
        // 8-row groups 1024 bytes apart, its 64-value column block nb 8 KB
        // on
        uint32_t pp[2][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                split2_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1],
                            pp[0][kk][x], pp[1][kk][x]);
        // (one 64-column block at a time where there are two, so that the
        // parts, the tile and dK and dV fit the registers together)
        float tv[32];
#pragma unroll
        for (int nb = 0; nb < DV / 64; ++nb) {
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int part = 0; part < 2; ++part)
                    wgmma_rs<1>(tv, pp[part][kk],
                                wg_desc(oa + nb * 8192 + kk * 2048, 1024,
                                        1024, 1), kk + part > 0);
            wg_commit();
            if constexpr (DV > 64) {
                wg_wait<0>();
                wg_pin(tv);
#pragma unroll
                for (int x = 0; x < 32; ++x) adv[nb * 32 + x] += tv[x];
            }
        }
        if constexpr (DV > 64) keep_parts(pp);

        // both warpgroups' dS^T are written, and step t - 1 is done with
        // its stage: thread 0 refills it for step t - 1 + NS
        named_barrier(1, 256);
        if (threadIdx.x == 0 && t > 0 && t - 1 + NS < steps)
            load_step(t - 1 + NS);

        // dK tile = dS^T Q from a fresh accumulator: dS^T's parts K-major,
        // Q MN-major as dO above
        float tk[DK / 64][32];
        wg_fence();
#pragma unroll
        for (int nb = 0; nb < DK / 64; ++nb)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int part = 0; part < 2; ++part)
                    wgmma_ss_mn<0>(
                        tk[nb],
                        TS::template desc<64>(
                            base + fb_ds<DK, DV>(buf, wg, part), kk * 16),
                        wg_desc(qa + nb * 8192 + kk * 2048, 1024, 1024, 1),
                        kk + part > 0);
        wg_commit();

        // dQ = dS K over the 128 keys, columns DK / 2 wg .. + DK / 2: dS
        // read transposed from both warpgroups' parts (16 keys a step: the
        // 16 rows of a 64-key part), K MN-major (the same 16 rows)
        float tq[DK / 4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int part = 0; part < 2; ++part) {
                const uint64_t a = wg_desc(
                    base + fb_ds<DK, DV>(buf, kk / 4, part) + kk % 4 * 2048,
                    1024, 1024, 1);
                const uint64_t bq = wg_desc(
                    base + kk / 4 * Sh::KH + (kk % 4) * 2048
                        + (DK == 64 ? wg * 64 : wg * 8192),
                    1024, 1024, 1);
                if constexpr (DK == 64)
                    wgmma_ss32<1, 1>(tq, a, bq, kk + part > 0);
                else
                    wgmma_ss_mn<1>(tq, a, bq, kk + part > 0);
            }
        wg_commit();

        if constexpr (DV == 64) {
            wg_wait<2>();              // dV's tile
            wg_pin(tv);
#pragma unroll
            for (int x = 0; x < 32; ++x) adv[x] += tv[x];
            keep_parts(pp);
        }
        wg_wait<1>();                  // dK's tile
#pragma unroll
        for (int nb = 0; nb < DK / 64; ++nb) {
            wg_pin(tk[nb]);
#pragma unroll
            for (int x = 0; x < 32; ++x) adk[nb * 32 + x] += tk[nb][x];
        }
        wg_wait<0>();                  // dQ's tile
        wg_pin(tq);
        // tq[4 j + 2 i + c]: query q0 + 16 warp + gid + 8 i, column
        // DK / 2 wg + 8 j + 2 tig + c
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qp = q0 + 16 * warp + gid + 8 * i;
            if (qp >= Sq) continue;
            float* row = dq_acc + (((size_t)b * Sq + qp) * H + hh) * DK
                       + DK / 2 * wg + 2 * tig;
#pragma unroll
            for (int j = 0; j < DK / 16; ++j)
                atomicAdd(reinterpret_cast<float2*>(row + 8 * j),
                          make_float2(tq[4 * j + 2 * i],
                                      tq[4 * j + 2 * i + 1]));
        }
    }

    // dK = scale dS^T Q and dV, rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kp = kr + 8 * i;
        if (kp >= Sk) continue;
        const size_t at = (size_t)b * Sk + kp;
#pragma unroll
        for (int j = 0; j < DK / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                dk + (at * KV + kvh) * DK + 8 * j + 2 * tig) =
                __floats2bfloat162_rn(adk[4 * j + 2 * i] * scale,
                                      adk[4 * j + 2 * i + 1] * scale);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                dv + (at * KV + kvh) * DV + 8 * j + 2 * tig) =
                __floats2bfloat162_rn(adv[4 * j + 2 * i],
                                      adv[4 * j + 2 * i + 1]);
    }
}

// The column split, (DK, DV) = (192, 128): deepseek-v2-lite's MLA heads.
// The key split above does not fit there: a warpgroup of 64 keys would
// hold dK^T 64 x 192 and dV^T 64 x 128 (160 f32 a thread) beside S^T and
// dP^T (64), and FbShape<192, 128> leaves 1 KB of the block's shared
// memory.  So a block takes 64 keys, both warpgroups work on all of them,
// and they split the rest:
//   S^T = K Q^T, dP^T = V dO^T: warpgroup w the 32 queries 32 w .. of the
//     step's 64 (m64n32, 16 + 16 f32 a thread);
//   P^T, dS^T = P^T (dP^T - D): each into this step's buffer in two bf16
//     parts, the warpgroup's 32 query columns; a barrier of both;
//   dV tile = P^T dO: the 64 columns 64 w .. of DV;
//   dK tile = dS^T Q and dQ = dS K (the 64 keys): the 64 columns 64 w ..
//     of DK and the 32 columns 128 + 32 w .. (a product's N never crosses a
//     64-value swizzle block: its 32-wide piece starts at byte 0 or 64 of a
//     128-byte row).
// dK and dV stay in registers, 48 + 32 f32 a thread.  The ring, the row
// pieces, dQ by f32 atomics, the two bf16 parts and the fresh tile
// accumulators added on the CUDA cores are the key split's.
constexpr int FC_KEYS = 64;         // keys a block, shared by both warpgroups

// Shared memory, from a 1024-byte aligned base: the block's K and V tiles,
// the ring's Q and dO tiles, two buffers (a step's and the one before) of
// P^T and dS^T in two parts each, then each stage's lse log2(e) and D rows.
template <int DK, int DV>
struct FcShape {
    static constexpr int NS = 2;                        // ring stages
    static constexpr uint32_t KT = 64 * DK * 2;
    static constexpr uint32_t VT = 64 * DV * 2;
    static constexpr uint32_t QT = FB_Q * DK * 2;       // a stage's Q
    static constexpr uint32_t OT = FB_Q * DV * 2;       // its dO
    static constexpr uint32_t STAGE = QT + OT;
    static constexpr uint32_t PART = 64 * FB_Q * 2;     // one bf16 part
    static constexpr uint32_t BUF = 4 * PART;           // P^T, dS^T parts
    static constexpr uint32_t V_AT = KT;
    static constexpr uint32_t RING_AT = V_AT + VT;
    static constexpr uint32_t BUF_AT = RING_AT + NS * STAGE;
    static constexpr uint32_t ROWS_AT = BUF_AT + 2 * BUF;
    static constexpr uint32_t ROWS = 2 * FB_Q * 4;
    static constexpr size_t SMEM = 1024 + ROWS_AT + NS * ROWS;
};

template <int DK, int DV>
__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_wgmma_cols(
    const __grid_constant__ CUtensorMap q_map,    // q (B, Sq, H, DK)
    const __grid_constant__ CUtensorMap k_map,    // k (B, Sk, KV, DK)
    const __grid_constant__ CUtensorMap v_map,    // v (B, Sk, KV, DV)
    const __grid_constant__ CUtensorMap do_map,   // dout (B, Sq, H, DV)
    const float* __restrict__ rows,               // flash_bwd_prep's
    float* __restrict__ dq_acc,                   // (B, Sq, H, DK), zeroed
    __nv_bfloat16* __restrict__ dk,               // (B, Sk, KV, DK)
    __nv_bfloat16* __restrict__ dv,               // (B, Sk, KV, DV)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    static_assert(fb_cols(DK, DV), "the column split's pair");
    using Sh = FcShape<DK, DV>;
    using TK = WgTile<DK>;
    using TV = WgTile<DV>;
    using TS = WgTile<FB_Q>;
    constexpr int NS = Sh::NS;
    __shared__ uint64_t kv_full, full[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* sm = smem_raw + (base - raw);

    const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
    const int k0 = blockIdx.y * FC_KEYS;
    const int G = H / KV, nk = min(FC_KEYS, Sk - k0);
    const int nqt = (Sq + FB_Q - 1) / FB_Q;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int t_lo = causal ? k0 / FB_Q : 0;
    const int nt = max(0, (q_end + FB_Q - 1) / FB_Q - t_lo);
    const int steps = G * nt;

    auto load_step = [&](int t) {
        fb_load_step<Sh, DK, DV>(sm, full, &q_map, &do_map, rows, t, b, kvh,
                                 G, H, nt, t_lo, nqt);
    };
    if (threadIdx.x == 0) {
        mbar_init(&kv_full, 1);
#pragma unroll
        for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arrive_expect_tx(&kv_full, Sh::KT + Sh::VT);
#pragma unroll
        for (int c = 0; c < DK / 64; ++c)
            tma_load_4d(sm + c * 8192, &k_map, c * 64, kvh, k0, b, &kv_full);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
            tma_load_4d(sm + Sh::V_AT + c * 8192, &v_map, c * 64, kvh, k0, b,
                        &kv_full);
        for (int t = 0; t < min(NS, steps); ++t) load_step(t);
    }
    __syncthreads();

    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    const int kr = k0 + 16 * warp + gid;   // this thread's keys kr, kr + 8
    const float sl2 = scale * FB_LOG2E;
    const uint32_t ka = base, va = base + Sh::V_AT;
    // adk[4 j + 2 i + c]: key kr + 8 i, column 64 wg + 8 j + 2 tig + c (j <
    // 8), then 128 + 32 wg + 8 (j - 8) + 2 tig + c; adv[4 j + 2 i + c]: key
    // kr + 8 i, column 64 wg + 8 j + 2 tig + c
    float adk[48], adv[32];
#pragma unroll
    for (int j = 0; j < 48; ++j) adk[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) adv[j] = 0.f;
    mbar_wait(&kv_full, 0);

    for (int t = 0; t < steps; ++t) {
        const int s = t % NS, hh = kvh * G + t / nt;
        const int q0 = (t_lo + t % nt) * FB_Q;
        const int qw = q0 + 32 * wg;       // this warpgroup's 32 queries
        mbar_wait(&full[s], (t / NS) & 1);
        const uint32_t qa = base + Sh::RING_AT + s * Sh::STAGE;
        const uint32_t oa = qa + Sh::QT;

        // S^T = K Q^T and dP^T = V dO^T over this warpgroup's queries (rows
        // 32 wg .. of the stage's tiles, 4 KB on): st[4 j + 2 i + c] is key
        // kr + 8 i, query qw + 8 j + 2 tig + c
        float st[16], dpt[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss32<0, 0>(st, TK::template desc<64>(ka, kk * 16),
                             TK::template desc<FB_Q>(qa + 4096 * wg, kk * 16),
                             kk > 0);
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
            wgmma_ss32<0, 0>(dpt, TV::template desc<64>(va, kk * 16),
                             TV::template desc<FB_Q>(oa + 4096 * wg, kk * 16),
                             kk > 0);
        wg_commit();
        wg_wait<0>();
        wg_pin(st);
        wg_pin(dpt);

        // P^T and dS^T = P^T (dP^T - D) (scale at the end), masked as the
        // key split's
        const float* lr = reinterpret_cast<const float*>(
            sm + Sh::ROWS_AT + s * Sh::ROWS) + 32 * wg;
        const bool whole = k0 + 63 < Sk
            && (!causal || k0 + 63 <= qw)
            && (window <= 0 || qw + 31 - k0 < window);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                lr + 8 * j + 2 * tig);
            const float2 dd = *reinterpret_cast<const float2*>(
                lr + FB_Q + 8 * j + 2 * tig);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int x = 4 * j + e, c = e & 1;
                float p = exp2_ftz(fmaf(st[x], sl2, -(c ? l2.y : l2.x)));
                if (!whole) {
                    const int kp = kr + 8 * (e / 2);
                    const int qp = qw + 8 * j + 2 * tig + c;
                    const bool vis = kp < Sk && (!causal || kp <= qp)
                        && (window <= 0 || qp - kp < window);
                    p = vis ? p : 0.f;
                }
                st[x] = p;
                dpt[x] = p * (dpt[x] - (c ? dd.y : dd.x));
            }
        }

        // both into this step's buffer: rows this thread's keys, columns
        // this warpgroup's queries (a 32-bit pair a store); parts P^T hi,
        // lo, dS^T hi, lo
        const uint32_t pb = Sh::BUF_AT + (t & 1) * Sh::BUF;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t off = pb + TS::template at<64>(
                    16 * warp + gid + 8 * i, 4 * wg + j) + 4 * tig;
                uint32_t hi, lo;
                split2_bf16(st[4 * j + 2 * i], st[4 * j + 2 * i + 1], hi, lo);
                *reinterpret_cast<uint32_t*>(sm + off) = hi;
                *reinterpret_cast<uint32_t*>(sm + off + Sh::PART) = lo;
                split2_bf16(dpt[4 * j + 2 * i], dpt[4 * j + 2 * i + 1], hi,
                            lo);
                *reinterpret_cast<uint32_t*>(sm + off + 2 * Sh::PART) = hi;
                *reinterpret_cast<uint32_t*>(sm + off + 3 * Sh::PART) = lo;
            }
        fence_proxy_async();

        // both warpgroups' halves are written, and step t - 1 is done with
        // its stage: thread 0 refills it for step t - 1 + NS
        named_barrier(1, 256);
        if (threadIdx.x == 0 && t > 0 && t - 1 + NS < steps)
            load_step(t - 1 + NS);

        // dV tile = P^T dO and dK tile = dS^T Q from fresh accumulators:
        // the parts K-major, dO and Q MN-major (16 query rows a step, 2 KB)
        float tv[32], tk[32], tk2[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int part = 0; part < 2; ++part)
                wgmma_ss_mn<0>(
                    tv, TS::template desc<64>(base + pb + part * Sh::PART,
                                              kk * 16),
                    wg_desc(oa + wg * 8192 + kk * 2048, 1024, 1024, 1),
                    kk + part > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int part = 0; part < 2; ++part) {
                const uint64_t a = TS::template desc<64>(
                    base + pb + (2 + part) * Sh::PART, kk * 16);
                wgmma_ss_mn<0>(
                    tk, a, wg_desc(qa + wg * 8192 + kk * 2048, 1024, 1024, 1),
                    kk + part > 0);
                wgmma_ss32<0, 1>(
                    tk2, a,
                    wg_desc(qa + 2 * 8192 + kk * 2048 + 64 * wg, 1024, 1024,
                            1),
                    kk + part > 0);
            }
        wg_commit();
        wg_wait<0>();
        wg_pin(tv);
        wg_pin(tk);
        wg_pin(tk2);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
            adv[x] += tv[x];
            adk[x] += tk[x];
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) adk[32 + x] += tk2[x];

        // dQ = dS K over the block's 64 keys, this warpgroup's columns: dS
        // read transposed from the dS^T parts (16 keys a step), K MN-major
        float tq[32], tq2[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int part = 0; part < 2; ++part) {
                const uint64_t a = wg_desc(
                    base + pb + (2 + part) * Sh::PART + kk * 2048, 1024, 1024,
                    1);
                wgmma_ss_mn<1>(
                    tq, a, wg_desc(ka + wg * 8192 + kk * 2048, 1024, 1024, 1),
                    kk + part > 0);
                wgmma_ss32<1, 1>(
                    tq2, a,
                    wg_desc(ka + 2 * 8192 + kk * 2048 + 64 * wg, 1024, 1024,
                            1),
                    kk + part > 0);
            }
        wg_commit();
        wg_wait<0>();
        wg_pin(tq);
        wg_pin(tq2);
        // tq[4 j + 2 i + c]: query q0 + 16 warp + gid + 8 i, column 64 wg +
        // 8 j + 2 tig + c; tq2 the same at column 128 + 32 wg + 8 j + ...
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qp = q0 + 16 * warp + gid + 8 * i;
            if (qp >= Sq) continue;
            float* row = dq_acc + (((size_t)b * Sq + qp) * H + hh) * DK
                       + 2 * tig;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                atomicAdd(reinterpret_cast<float2*>(row + 64 * wg + 8 * j),
                          make_float2(tq[4 * j + 2 * i],
                                      tq[4 * j + 2 * i + 1]));
#pragma unroll
            for (int j = 0; j < 4; ++j)
                atomicAdd(reinterpret_cast<float2*>(row + 128 + 32 * wg
                                                    + 8 * j),
                          make_float2(tq2[4 * j + 2 * i],
                                      tq2[4 * j + 2 * i + 1]));
        }
    }

    // dK = scale dS^T Q and dV, rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kp = kr + 8 * i;
        if (kp >= Sk) continue;
        const size_t at = ((size_t)b * Sk + kp) * KV + kvh;
        __nv_bfloat16* dkr = dk + at * DK + 2 * tig;
        __nv_bfloat16* dvr = dv + at * DV + 64 * wg + 2 * tig;
#pragma unroll
        for (int j = 0; j < 12; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                dkr + (j < 8 ? 64 * wg + 8 * j : 128 + 32 * wg + 8 * (j - 8)))
                = __floats2bfloat162_rn(adk[4 * j + 2 * i] * scale,
                                        adk[4 * j + 2 * i + 1] * scale);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j) =
                __floats2bfloat162_rn(adv[4 * j + 2 * i],
                                      adv[4 * j + 2 * i + 1]);
    }
}

// ---------------------------------------------------------------------------
// (256, 256) in bf16 on wgmma: a dK/dV pass and a dQ pass
// ---------------------------------------------------------------------------
// recurrentgemma-2b's LOCAL_ATTN heads.  Neither fused pass above fits: a
// key split would hold dK^T and dV^T 64 x 256 each (256 f32 a thread), and
// adding dQ by f32 atomics from every key block would be some 1 GB of
// atomic adds a call at its train shape.  So two passes, each a block a
// 64-row tile, each fed by TMA through a ring of two stages behind
// mbarriers, with no atomics:
//
//   flash_bwd_wide_dkdv  grid (row x query head, 64-key tile), key tiles
//     in ascending order (the longest walks first).  The block's K and V
//     stay in shared memory; it walks the query tiles in its keys' reach,
//     their Q, dO and lse/D rows arriving through the ring.  Per step:
//       S^T = K Q^T, dP^T = V dO^T: warpgroup w the 32 queries 32 w .. of
//         the step's 64 (m64n32, 16 + 16 f32 a thread), as the column
//         split's;
//       P^T and dS^T = P^T (dP^T - D) into one buffer in two bf16 parts
//         each (32 KB), after a barrier that also frees the step before's
//         stage for the step after;
//       dV += P^T dO, dK += dS^T Q: warpgroup w the 128 head dims 128 w ..
//         of both (64 + 64 f32 a thread), each 64-column piece from a fresh
//         accumulator (32 f32) added on the CUDA cores.
//     Each block writes its query head's f32 partial dK and dV, and
//     flash_bwd_wide_sum adds a kv head's G partials in order (two heads a
//     block, half the partials, timed no faster: PERF.md section 6).
//     Shared memory:
//     K and V 64 KB, two 64 KB stages, the parts 32 KB, the rows: 226 KB
//     with the alignment, one block an SM;
//   flash_bwd_wide_dq  grid (row x query head, 64-row query tile), the
//     tiles in descending order.  The block holds Q, dO and the tile's
//     lse/D rows; K and V come through the ring a key tile a stage.  Per
//     step S = Q K^T and dP = dO V^T (warpgroup w the keys 32 w .., m64n32),
//     dS = P (dP - D) in two bf16 parts into one 16 KB buffer, then dQ +=
//     dS K over the 64 keys, warpgroup w the head dims 128 w .. (m64n128
//     from a fresh accumulator, 64 + 64 f32 a thread).
//
// As everywhere in this file: P and dS enter the products in two bf16
// parts, each tile's product starts from a fresh accumulator and is added
// in f32 on the CUDA cores, and dK, dV and dQ are each one block's sums
// (then the ordered partial sum) in a fixed order, so all three replay bit
// for bit.  The masks are the key split's: causal, window, keys past Sk;
// rows past Sq read as zeros with lse +inf (their P is 0).
constexpr int FW_D = 256;      // head dims

// The dK/dV pass's shared memory from a 1024-byte aligned base: K, V, the
// ring's Q and dO tiles, the P^T and dS^T parts, each stage's rows.  Every
// tile is four 64-row, 128-byte swizzle blocks (WgTile<256>) of 8 KB.
struct FwShape {
    static constexpr int NS = 2;                        // ring stages
    static constexpr uint32_t TILE = 64 * FW_D * 2;     // 64 rows x 256
    static constexpr uint32_t V_AT = TILE;
    static constexpr uint32_t QT = TILE;                // a stage's Q
    static constexpr uint32_t RING_AT = 2 * TILE;
    static constexpr uint32_t STAGE = 2 * TILE;         // Q, then dO
    static constexpr uint32_t PART = 64 * FB_Q * 2;     // one bf16 part
    static constexpr uint32_t BUF_AT = RING_AT + NS * STAGE;
    static constexpr uint32_t ROWS_AT = BUF_AT + 4 * PART;
    static constexpr uint32_t ROWS = 2 * FB_Q * 4;      // a stage's lse, D
    static constexpr size_t SMEM = 1024 + ROWS_AT + NS * ROWS;
};

// The dQ pass's: Q, dO, the ring's K and V tiles, the dS parts, the rows.
struct FqShape {
    static constexpr int NS = 2;
    static constexpr uint32_t TILE = 64 * FW_D * 2;
    static constexpr uint32_t O_AT = TILE;
    static constexpr uint32_t RING_AT = 2 * TILE;
    static constexpr uint32_t STAGE = 2 * TILE;         // K, then V
    static constexpr uint32_t PART = 64 * 64 * 2;
    static constexpr uint32_t BUF_AT = RING_AT + NS * STAGE;
    static constexpr uint32_t ROWS_AT = BUF_AT + 2 * PART;
    static constexpr uint32_t ROWS = 2 * FB_Q * 4;
    static constexpr size_t SMEM = 1024 + ROWS_AT + ROWS;
};

__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_wide_dkdv(
    const __grid_constant__ CUtensorMap q_map,    // q (B, Sq, H, 256)
    const __grid_constant__ CUtensorMap k_map,    // k (B, Sk, KV, 256)
    const __grid_constant__ CUtensorMap v_map,    // v (B, Sk, KV, 256)
    const __grid_constant__ CUtensorMap do_map,   // dout (B, Sq, H, 256)
    const float* __restrict__ rows,               // flash_bwd_prep's
    float* __restrict__ part,                     // (G, B, Sk, KV, 512)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    using Sh = FwShape;
    using TK = WgTile<FW_D>;
    using TS = WgTile<FB_Q>;
    constexpr int NS = Sh::NS;
    __shared__ uint64_t kv_full, full[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* sm = smem_raw + (base - raw);

    const int hh = blockIdx.x % H, b = blockIdx.x / H, B = gridDim.x / H;
    const int G = H / KV, kvh = hh / G;
    const int k0 = blockIdx.y * 64, nk = min(64, Sk - k0);
    const int nqt = (Sq + FB_Q - 1) / FB_Q;
    const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
    const int t_lo = causal ? k0 / FB_Q : 0;
    const int steps = max(0, (q_end + FB_Q - 1) / FB_Q - t_lo);

    auto load_step = [&](int t) {
        fb_load_step<Sh, FW_D, FW_D>(sm, full, &q_map, &do_map, rows, t, b,
                                     hh, 1, H, steps, t_lo, nqt);
    };
    if (threadIdx.x == 0) {
        mbar_init(&kv_full, 1);
#pragma unroll
        for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arrive_expect_tx(&kv_full, 2 * Sh::TILE);
#pragma unroll
        for (int c = 0; c < FW_D / 64; ++c) {
            tma_load_4d(sm + c * 8192, &k_map, c * 64, kvh, k0, b, &kv_full);
            tma_load_4d(sm + Sh::V_AT + c * 8192, &v_map, c * 64, kvh, k0, b,
                        &kv_full);
        }
        for (int t = 0; t < min(NS, steps); ++t) load_step(t);
    }
    __syncthreads();

    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    const int kr = k0 + 16 * warp + gid;   // this thread's keys kr, kr + 8
    const float sl2 = scale * FB_LOG2E;
    const uint32_t ka = base, va = base + Sh::V_AT;
    const uint32_t pb = base + Sh::BUF_AT;
    // adk[32 c + 4 j + 2 i + e], adv the same: key kr + 8 i, column 128 wg +
    // 64 c + 8 j + 2 tig + e
    float adk[64], adv[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) adk[j] = adv[j] = 0.f;
    mbar_wait(&kv_full, 0);

    for (int t = 0; t < steps; ++t) {
        const int s = t % NS;
        const int q0 = (t_lo + t) * FB_Q;
        const int qw = q0 + 32 * wg;       // this warpgroup's 32 queries
        // both warpgroups are past step t - 1: the parts buffer is free,
        // and so is its stage, which thread 0 refills for step t + 1
        named_barrier(1, 256);
        if (threadIdx.x == 0 && t > 0 && t + 1 < steps) load_step(t + 1);
        mbar_wait(&full[s], (t / NS) & 1);
        const uint32_t qa = base + Sh::RING_AT + s * Sh::STAGE;
        const uint32_t oa = qa + Sh::TILE;

        // S^T = K Q^T and dP^T = V dO^T over this warpgroup's queries (rows
        // 32 wg .. of the stage's tiles, 4 KB on): st[4 j + 2 i + e] is key
        // kr + 8 i, query qw + 8 j + 2 tig + e
        float st[16], dpt[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FW_D / 16; ++kk)
            wgmma_ss32<0, 0>(st, TK::desc<64>(ka, kk * 16),
                             TK::desc<FB_Q>(qa + 4096 * wg, kk * 16),
                             kk > 0);
#pragma unroll
        for (int kk = 0; kk < FW_D / 16; ++kk)
            wgmma_ss32<0, 0>(dpt, TK::desc<64>(va, kk * 16),
                             TK::desc<FB_Q>(oa + 4096 * wg, kk * 16),
                             kk > 0);
        wg_commit();
        wg_wait<0>();
        wg_pin(st);
        wg_pin(dpt);

        // P^T and dS^T = P^T (dP^T - D) (scale at the end)
        const float* lr = reinterpret_cast<const float*>(
            sm + Sh::ROWS_AT + s * Sh::ROWS) + 32 * wg;
        const bool whole = k0 + 63 < Sk
            && (!causal || k0 + 63 <= qw)
            && (window <= 0 || qw + 31 - k0 < window);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                lr + 8 * j + 2 * tig);
            const float2 dd = *reinterpret_cast<const float2*>(
                lr + FB_Q + 8 * j + 2 * tig);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int x = 4 * j + e, c = e & 1;
                float p = exp2_ftz(fmaf(st[x], sl2, -(c ? l2.y : l2.x)));
                if (!whole) {
                    const int kp = kr + 8 * (e / 2);
                    const int qp = qw + 8 * j + 2 * tig + c;
                    const bool vis = kp < Sk && (!causal || kp <= qp)
                        && (window <= 0 || qp - kp < window);
                    p = vis ? p : 0.f;
                }
                st[x] = p;
                dpt[x] = p * (dpt[x] - (c ? dd.y : dd.x));
            }
        }
        // rows this thread's keys, columns this warpgroup's queries; parts
        // P^T hi, lo, dS^T hi, lo
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t off = Sh::BUF_AT + TS::at<64>(
                    16 * warp + gid + 8 * i, 4 * wg + j) + 4 * tig;
                uint32_t hi, lo;
                split2_bf16(st[4 * j + 2 * i], st[4 * j + 2 * i + 1], hi, lo);
                *reinterpret_cast<uint32_t*>(sm + off) = hi;
                *reinterpret_cast<uint32_t*>(sm + off + Sh::PART) = lo;
                split2_bf16(dpt[4 * j + 2 * i], dpt[4 * j + 2 * i + 1], hi,
                            lo);
                *reinterpret_cast<uint32_t*>(sm + off + 2 * Sh::PART) = hi;
                *reinterpret_cast<uint32_t*>(sm + off + 3 * Sh::PART) = lo;
            }
        fence_proxy_async();
        named_barrier(1, 256);             // both halves of the parts

        // dV += P^T dO and dK += dS^T Q, 64 columns a product from a fresh
        // accumulator: the parts K-major, dO and Q MN-major (16 query rows
        // a k step, 2 KB)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const uint32_t cb = (2 * wg + c) * 8192;
            float tv[32];
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int pt = 0; pt < 2; ++pt)
                    wgmma_ss_mn<0>(
                        tv, TS::desc<64>(pb + pt * Sh::PART,
                                                  kk * 16),
                        wg_desc(oa + cb + kk * 2048, 1024, 1024, 1),
                        kk + pt > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(tv);
#pragma unroll
            for (int x = 0; x < 32; ++x) adv[32 * c + x] += tv[x];
            float tk[32];
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int pt = 0; pt < 2; ++pt)
                    wgmma_ss_mn<0>(
                        tk, TS::desc<64>(
                                pb + (2 + pt) * Sh::PART, kk * 16),
                        wg_desc(qa + cb + kk * 2048, 1024, 1024, 1),
                        kk + pt > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(tk);
#pragma unroll
            for (int x = 0; x < 32; ++x) adk[32 * c + x] += tk[x];
        }
    }

    // the head's f32 partials, scale dS^T Q then P^T dO
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kp = kr + 8 * i;
        if (kp >= Sk) continue;
        float* pp = part + ((((size_t)(hh % G) * B + b) * Sk + kp) * KV + kvh)
                               * (2 * FW_D)
                  + 128 * wg + 2 * tig;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int x = 32 * c + 4 * j + 2 * i, d = 64 * c + 8 * j;
                *reinterpret_cast<float2*>(pp + d) =
                    make_float2(adk[x] * scale, adk[x + 1] * scale);
                *reinterpret_cast<float2*>(pp + FW_D + d) =
                    make_float2(adv[x], adv[x + 1]);
            }
    }
}

__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_wide_dq(
    const __grid_constant__ CUtensorMap q_map,    // q (B, Sq, H, 256)
    const __grid_constant__ CUtensorMap k_map,    // k (B, Sk, KV, 256)
    const __grid_constant__ CUtensorMap v_map,    // v (B, Sk, KV, 256)
    const __grid_constant__ CUtensorMap do_map,   // dout (B, Sq, H, 256)
    const float* __restrict__ rows,               // flash_bwd_prep's
    __nv_bfloat16* __restrict__ dq,               // (B, Sq, H, 256)
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
    using Sh = FqShape;
    using TK = WgTile<FW_D>;
    using TS = WgTile<64>;
    constexpr int NS = Sh::NS;
    __shared__ uint64_t q_full, full[NS];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* sm = smem_raw + (base - raw);

    const int hh = blockIdx.x % H, b = blockIdx.x / H, kvh = hh / (H / KV);
    const int nqt = (Sq + FB_Q - 1) / FB_Q, qt = nqt - 1 - blockIdx.y;
    const int q0 = qt * FB_Q, nq = min(FB_Q, Sq - q0);
    const int k_end = causal ? min(Sk, q0 + nq) : Sk;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int kt_lo = k_lo / 64;
    const int nt = max(0, (k_end + 63) / 64 - kt_lo);

    auto load_step = [&](int t) {
        const int s = t % NS, kt = kt_lo + t;
        unsigned char* st = sm + Sh::RING_AT + s * Sh::STAGE;
        mbar_arrive_expect_tx(&full[s], Sh::STAGE);
#pragma unroll
        for (int c = 0; c < FW_D / 64; ++c) {
            tma_load_4d(st + c * 8192, &k_map, c * 64, kvh, kt * 64, b,
                        &full[s]);
            tma_load_4d(st + Sh::TILE + c * 8192, &v_map, c * 64, kvh,
                        kt * 64, b, &full[s]);
        }
    };
    if (threadIdx.x == 0) {
        mbar_init(&q_full, 1);
#pragma unroll
        for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arrive_expect_tx(&q_full, 2 * Sh::TILE + Sh::ROWS);
#pragma unroll
        for (int c = 0; c < FW_D / 64; ++c) {
            tma_load_4d(sm + c * 8192, &q_map, c * 64, hh, q0, b, &q_full);
            tma_load_4d(sm + Sh::O_AT + c * 8192, &do_map, c * 64, hh, q0, b,
                        &q_full);
        }
        bulk_load(sm + Sh::ROWS_AT,
                  rows + (((size_t)b * H + hh) * nqt + qt) * (2 * FB_Q),
                  Sh::ROWS, &q_full);
        for (int t = 0; t < min(NS, nt); ++t) load_step(t);
    }
    __syncthreads();

    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    const int qr = q0 + 16 * warp + gid;   // this thread's rows qr, qr + 8
    const float sl2 = scale * FB_LOG2E;
    const uint32_t qa = base, oa = base + Sh::O_AT;
    const uint32_t pb = base + Sh::BUF_AT;
    mbar_wait(&q_full, 0);
    const float* lr = reinterpret_cast<const float*>(sm + Sh::ROWS_AT);
    const float l2[2] = {lr[qr - q0], lr[qr - q0 + 8]};
    const float dd[2] = {lr[FB_Q + qr - q0], lr[FB_Q + qr - q0 + 8]};
    // adq[4 j + 2 i + e]: query qr + 8 i, column 128 wg + 8 j + 2 tig + e
    float adq[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) adq[j] = 0.f;

    for (int t = 0; t < nt; ++t) {
        const int s = t % NS;
        const int kw = (kt_lo + t) * 64 + 32 * wg;   // this warpgroup's keys
        named_barrier(1, 256);
        if (threadIdx.x == 0 && t > 0 && t + 1 < nt) load_step(t + 1);
        mbar_wait(&full[s], (t / NS) & 1);
        const uint32_t ka = base + Sh::RING_AT + s * Sh::STAGE;
        const uint32_t va = ka + Sh::TILE;

        // S = Q K^T, dP = dO V^T over this warpgroup's 32 keys:
        // sc[4 j + 2 i + e] is query qr + 8 i, key kw + 8 j + 2 tig + e
        float sc[16], dp[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FW_D / 16; ++kk)
            wgmma_ss32<0, 0>(sc, TK::desc<64>(qa, kk * 16),
                             TK::desc<64>(ka + 4096 * wg, kk * 16),
                             kk > 0);
#pragma unroll
        for (int kk = 0; kk < FW_D / 16; ++kk)
            wgmma_ss32<0, 0>(dp, TK::desc<64>(oa, kk * 16),
                             TK::desc<64>(va + 4096 * wg, kk * 16),
                             kk > 0);
        wg_commit();
        wg_wait<0>();
        wg_pin(sc);
        wg_pin(dp);

        const bool whole = kw + 31 < Sk && (!causal || kw + 31 <= q0)
            && (window <= 0 || q0 + 63 - kw < window);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int x = 4 * j + e, i = e / 2;
                float p = exp2_ftz(fmaf(sc[x], sl2, -l2[i]));
                if (!whole) {
                    const int kp = kw + 8 * j + 2 * tig + (e & 1);
                    const int qp = qr + 8 * i;
                    const bool vis = kp < Sk && (!causal || kp <= qp)
                        && (window <= 0 || qp - kp < window);
                    p = vis ? p : 0.f;
                }
                dp[x] = p * (dp[x] - dd[i]);
            }
        // dS into the buffer: rows this thread's queries, columns this
        // warpgroup's keys, in two parts
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t off = Sh::BUF_AT + TS::at<64>(
                    16 * warp + gid + 8 * i, 4 * wg + j) + 4 * tig;
                uint32_t hi, lo;
                split2_bf16(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1], hi, lo);
                *reinterpret_cast<uint32_t*>(sm + off) = hi;
                *reinterpret_cast<uint32_t*>(sm + off + Sh::PART) = lo;
            }
        fence_proxy_async();
        named_barrier(1, 256);             // both halves of dS

        // dQ += dS K over the 64 keys, this warpgroup's 128 columns from a
        // fresh accumulator: dS K-major, K MN-major (its two 64-column
        // blocks 8 KB apart)
        float tq[64];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
                wgmma_ss_mn128(
                    tq, TS::desc<64>(pb + pt * Sh::PART, kk * 16),
                    wg_desc(ka + 2 * wg * 8192 + kk * 2048, 8192, 1024, 1),
                    kk + pt > 0);
        wg_commit();
        wg_wait<0>();
        wg_pin(tq);
#pragma unroll
        for (int x = 0; x < 64; ++x) adq[x] += tq[x];
    }

    // dq = scale dS K, rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qp = qr + 8 * i;
        if (qp >= Sq) continue;
        __nv_bfloat16* row = dq + (((size_t)b * Sq + qp) * H + hh) * FW_D
                           + 128 * wg + 2 * tig;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
                __floats2bfloat162_rn(adq[4 * j + 2 * i] * scale,
                                      adq[4 * j + 2 * i + 1] * scale);
    }
}

// dq = bf16(scale dq_acc), four values a thread
__global__ void __launch_bounds__(FB_PREP_THREADS) flash_bwd_dq_out(
    const float4* __restrict__ acc, __nv_bfloat162* __restrict__ dq,
    size_t n4, float scale) {
    const size_t i = (size_t)blockIdx.x * FB_PREP_THREADS + threadIdx.x;
    if (i >= n4) return;
    const float4 a = acc[i];
    dq[2 * i] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    dq[2 * i + 1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
}

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* ws, void* dq, void* dk, void* dv, int B, int Sq,
                 int Sk, int H, int KV, int causal, int window, float scale,
                 cudaStream_t stream) {
    using bf = __nv_bfloat16;
    const int nqt = (Sq + FB_Q - 1) / FB_Q;
    float* rows = ws;
    float* dq_acc = ws + (size_t)B * H * nqt * 2 * FB_Q;
    const long long prep_rows = (long long)B * nqt * FB_Q * H;
    flash_bwd_prep<DK, DV><<<(unsigned)((prep_rows + FB_PREP_THREADS / 32 - 1)
                                        / (FB_PREP_THREADS / 32)),
                             FB_PREP_THREADS, 0, stream>>>(
        (const bf*)out, (const bf*)dout, lse, rows, dq_acc, B, Sq, H, nqt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap q_map, k_map, v_map, do_map;
    int rc = bf16_rows_map(&q_map, q, DK, H, Sq, B);
    if (rc == 0) rc = bf16_rows_map(&k_map, k, DK, KV, Sk, B);
    if (rc == 0) rc = bf16_rows_map(&v_map, v, DV, KV, Sk, B);
    if (rc == 0) rc = bf16_rows_map(&do_map, dout, DV, H, Sq, B);
    if (rc != 0) return rc;
    auto run = [&](auto kernel, size_t smem, int keys) {
        const cudaError_t e = reserve_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<dim3(B * KV, (Sk + keys - 1) / keys), FB_THREADS, smem,
                 stream>>>(q_map, k_map, v_map, do_map, rows, dq_acc,
                           (bf*)dk, (bf*)dv, Sq, Sk, H, KV, causal, window,
                           scale);
        return cudaGetLastError();
    };
    if constexpr (fb_cols(DK, DV)) {
        auto kernel = flash_bwd_wgmma_cols<DK, DV>;
        err = run(kernel, FcShape<DK, DV>::SMEM, FC_KEYS);
    } else {
        auto kernel = flash_bwd_wgmma<DK, DV>;
        err = run(kernel, FbShape<DK, DV>::SMEM, FB_KEYS);
    }
    if (err != cudaSuccess) return (int)err;
    const size_t n4 = (size_t)B * Sq * H * DK / 4;
    flash_bwd_dq_out<<<(unsigned)((n4 + FB_PREP_THREADS - 1)
                                  / FB_PREP_THREADS),
                       FB_PREP_THREADS, 0, stream>>>(
        (const float4*)dq_acc, (__nv_bfloat162*)dq, n4, scale);
    return (int)cudaGetLastError();
}

// The (256, 256) backward on FMAs (f32): the row dots, the dK/dV pass (a
// block a query head) and its partials' sum, the dQ pass
template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v,
                const void* out, const void* dout, const float* lse,
                float* dd, void* dq, void* dk, void* dv, int B, int Sq,
                int Sk, int H, int KV, int causal, int window, float scale,
                cudaStream_t stream) {
    using cT = const T*;
    const int rows = B * Sq * H;
    flash_bwd_dot<T, D><<<(rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32),
                          BWD_THREADS, 0, stream>>>((cT)out, (cT)dout, dd,
                                                    rows, Sq, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // after the row dots, on a 16-byte boundary (the float2 stores)
    float* part = dd + ((size_t)B * H * Sq + 3) / 4 * 4;
    constexpr size_t SMEM = BwdWide<D>::SMEM;
    auto dkdv = flash_bwd_dkdv_wide<T, D>;
    err = reserve_smem(dkdv, SMEM);
    if (err == cudaSuccess) err = reserve_smem(flash_bwd_dq_wide<T, D>, SMEM);
    if (err != cudaSuccess) return (int)err;
    dkdv<<<dim3((Sk + BWD_T - 1) / BWD_T, H, B), BWD_THREADS, SMEM,
           stream>>>((cT)q, (cT)k, (cT)v, (cT)dout, lse, dd, part, Sq, Sk, H,
                     KV, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t kv_rows = (size_t)B * Sk * KV;
    flash_bwd_wide_sum<T, D><<<(unsigned)((kv_rows * 2 * D + BWD_THREADS - 1)
                                         / BWD_THREADS),
                               BWD_THREADS, 0, stream>>>(
        part, (T*)dk, (T*)dv, kv_rows, H / KV);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_wide<T, D><<<dim3((Sq + BWD_T - 1) / BWD_T, H, B),
                              BWD_THREADS, SMEM, stream>>>(
        (cT)q, (cT)k, (cT)v, (cT)dout, lse, dd, (T*)dq, Sq, Sk, H, KV,
        causal, window, scale);
    return (int)cudaGetLastError();
}

// The (256, 256) backward in bf16 on wgmma: the row pieces (flash_bwd_prep,
// no dQ sums), the dK/dV pass and its heads' ordered sum, the dQ pass
int launch_wide_wg(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* ws, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int causal, int window,
                   float scale, cudaStream_t stream) {
    using bf = __nv_bfloat16;
    const int nqt = (Sq + FB_Q - 1) / FB_Q, nkt = (Sk + 63) / 64;
    float* rows = ws;
    float* part = ws + (size_t)B * H * nqt * 2 * FB_Q;
    const long long prep_rows = (long long)B * nqt * FB_Q * H;
    flash_bwd_prep<FW_D, FW_D><<<(unsigned)((prep_rows + FB_PREP_THREADS / 32
                                             - 1) / (FB_PREP_THREADS / 32)),
                                 FB_PREP_THREADS, 0, stream>>>(
        (const bf*)out, (const bf*)dout, lse, rows, nullptr, B, Sq, H, nqt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap q_map, k_map, v_map, do_map;
    int rc = bf16_rows_map(&q_map, q, FW_D, H, Sq, B);
    if (rc == 0) rc = bf16_rows_map(&k_map, k, FW_D, KV, Sk, B);
    if (rc == 0) rc = bf16_rows_map(&v_map, v, FW_D, KV, Sk, B);
    if (rc == 0) rc = bf16_rows_map(&do_map, dout, FW_D, H, Sq, B);
    if (rc != 0) return rc;
    err = reserve_smem(flash_bwd_wide_dkdv, FwShape::SMEM);
    if (err == cudaSuccess)
        err = reserve_smem(flash_bwd_wide_dq, FqShape::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_wide_dkdv<<<dim3(B * H, nkt), FB_THREADS, FwShape::SMEM,
                          stream>>>(q_map, k_map, v_map, do_map, rows, part,
                                    Sq, Sk, H, KV, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t kv_rows = (size_t)B * Sk * KV;
    flash_bwd_wide_sum<bf, FW_D><<<(unsigned)((kv_rows * 2 * FW_D
                                               + BWD_THREADS - 1)
                                              / BWD_THREADS),
                                   BWD_THREADS, 0, stream>>>(
        part, (bf*)dk, (bf*)dv, kv_rows, H / KV);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_wide_dq<<<dim3(B * H, nqt), FB_THREADS, FqShape::SMEM,
                        stream>>>(q_map, k_map, v_map, do_map, rows,
                                  (bf*)dq, Sq, Sk, H, KV, causal, window,
                                  scale);
    return (int)cudaGetLastError();
}

template <typename T, int DK, int DV>
int launch_fma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* dd, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int causal, int window, float scale, cudaStream_t stream) {
    using cT = const T*;
    const int rows = B * Sq * H;
    flash_bwd_dot<T, DV><<<(rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32),
                           BWD_THREADS, 0, stream>>>((cT)out, (cT)dout, dd,
                                                     rows, Sq, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr size_t SMEM = BwdShape<DK, DV>::SMEM;
    auto dkdv = flash_bwd_dkdv<T, DK, DV>;
    auto dqk = flash_bwd_dq<T, DK, DV>;
    err = reserve_smem(dkdv, SMEM);
    if (err == cudaSuccess) err = reserve_smem(dqk, SMEM);
    if (err != cudaSuccess) return (int)err;
    dkdv<<<dim3((Sk + BWD_T - 1) / BWD_T, KV, B), BWD_THREADS, SMEM,
           stream>>>((cT)q, (cT)k, (cT)v, (cT)dout, lse, dd, (T*)dk, (T*)dv,
                     Sq, Sk, H, KV, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dqk<<<dim3((Sq + BWD_T - 1) / BWD_T, H, B), BWD_THREADS, SMEM, stream>>>(
        (cT)q, (cT)k, (cT)v, (cT)dout, lse, dd, (T*)dq, Sq, Sk, H, KV, causal,
        window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, DK), k (B, Sk, KV, DK), v (B, Sk, KV, DV), out and dout (B,
// Sq, H, DV), lse (B, H, Sq) f32 from the forward; dq, dk, dv shaped like
// q, k, v; all contiguous on one device.  ws: f32 workspace
// (flash_attention.flash_bwd_workspace): the tensor-core bodies' B H
// ceil(Sq / 64) 128 row values, then the fused pass's B Sq H DK dQ sums
// or the (256, 256) pass's G x B Sk KV 2 DK partial dK and dV; the
// FMA body's B H Sq row dots, at (256, 256) padded to a multiple of 4 and
// then G x B Sk KV 2 DK partials.  window <= 0 means none; queries at
// positions [0, Sq).  body: 0 the FMA body, 1 the fused tensor-core body
// (bf16 at fb_pair (DK, DV)), 2 the (256, 256) wgmma body (bf16); q, k, v
// and dout 16-byte aligned for 1 and 2, as flash_attention.flash_bwd_body
// chooses.  Launches the body's kernels on ``stream`` and returns the
// first cudaGetLastError() that is not cudaSuccess, or REPRO_UNSUPPORTED
// for what the body does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int DK, int DV,
    int causal, int window, float scale, int dtype, int body, void* stream) {
    if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
        return REPRO_UNSUPPORTED;
    const float* lse_f = (const float*)lse;
    float* ws_f = (float*)ws;
    cudaStream_t st = (cudaStream_t)stream;
    if (body == 1) {
        if (dtype != REPRO_BF16 || !fb_pair(DK, DV)
            || ((size_t)q | (size_t)k | (size_t)v | (size_t)dout) % 16 != 0)
            return REPRO_UNSUPPORTED;
#define REPRO_CASE(DIMK, DIMV)                                               \
        if (DK == DIMK && DV == DIMV)                                        \
            return launch_wgmma<DIMK, DIMV>(q, k, v, out, dout, lse_f, ws_f, \
                                            dq, dk, dv, B, Sq, Sk, H, KV,    \
                                            causal, window, scale, st);
        REPRO_CASE(64, 64)
        REPRO_CASE(128, 128)
        REPRO_CASE(192, 128)
#undef REPRO_CASE
        return REPRO_UNSUPPORTED;
    }
    if (body == 2) {
        if (dtype != REPRO_BF16 || DK != FW_D || DV != FW_D
            || ((size_t)q | (size_t)k | (size_t)v | (size_t)dout) % 16 != 0)
            return REPRO_UNSUPPORTED;
        return launch_wide_wg(q, k, v, out, dout, lse_f, ws_f, dq, dk, dv, B,
                              Sq, Sk, H, KV, causal, window, scale, st);
    }
    if (body != 0) return REPRO_UNSUPPORTED;
#define REPRO_CASE(T, CODE, DIMK, DIMV)                                      \
    if (dtype == CODE && DK == DIMK && DV == DIMV)                           \
        return launch_fma<T, DIMK, DIMV>(q, k, v, out, dout, lse_f, ws_f, dq, \
                                         dk, dv, B, Sq, Sk, H, KV, causal,   \
                                         window, scale, st);
    REPRO_CASE(float, REPRO_F32, 64, 64)
    REPRO_CASE(float, REPRO_F32, 128, 128)
    REPRO_CASE(float, REPRO_F32, 192, 128)
    REPRO_CASE(float, REPRO_F32, 96, 64)
    REPRO_CASE(__nv_bfloat16, REPRO_BF16, 96, 64)
    // bf16 at the tensor-core body's pairs: the deterministic backward
    // (flash_attention.flash_bwd_body under torch's deterministic switch)
    REPRO_CASE(__nv_bfloat16, REPRO_BF16, 64, 64)
    REPRO_CASE(__nv_bfloat16, REPRO_BF16, 128, 128)
    REPRO_CASE(__nv_bfloat16, REPRO_BF16, 192, 128)
#undef REPRO_CASE
    if (dtype == REPRO_F32 && DK == 256 && DV == 256)
        return launch_wide<float, 256>(q, k, v, out, dout, lse_f, ws_f, dq, dk,
                                       dv, B, Sq, Sk, H, KV, causal, window,
                                       scale, st);
    return REPRO_UNSUPPORTED;
}
