// Fused paged MLA decode attention (absorbed form) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py,
// function paged_mla_decode_attention (:189, Pallas body _mla_kernel
// :150-186).  One decode token per batch row attends, in the rank-R latent
// space, over that row's pages of the latent pools: score = (q_lat . ckv
// + q_rope . krope) * scale for keys pos < length (NEG_INF beyond), an
// online softmax, and out = P . ckv returned in f32 (B, H, R) whatever the
// input type.  The W_uk absorption before and the W_uv read-out after stay
// outside, as in the reference (models/mla.py).  The block table is walked
// inside the kernel: no dense pool[block_tables] copy exists.
//
// What bounds it on the H100: bytes.  Per key it reads R + r latent and
// rope values (576 at deepseek-v2-lite's R = 512, r = 64; 1152 bytes in
// bf16) and does 2 H (2R + r) flops (about 34 K at H = 16), 30 flops per
// byte, below the ~295 the card needs before its tensor cores matter.
//
// Design.  The TPU kernel steps a sequential grid (B, W) and carries (acc,
// m, l) in VMEM across the pages.  Here, in bf16, a grid of (row, key
// split) blocks walks each row's keys: the wrapper cuts the table's W * bs
// keys into splits of whole ML_KT tiles on the host, from B, W, bs and the
// SM count alone (mla_decode_splits: no length is read back), so that the
// blocks give every SM one where the keys allow (16 seats over a 96-block
// table: 8 splits of 192 keys, 128 blocks, where one block a row left 116
// of 132 SMs idle and the longest row set the time).  A block clips its
// split to its row's length on the device; a split at or past it writes
// an empty partial (m = -inf, l = 0) and exits.  Each split's block walks
// its keys in tiles of ML_KT: all H heads share the one latent key stream,
// so each key is read once for every head.  A tile's ckv and
// krope rows are staged in shared memory side by side (one (R + r)-wide
// row per key) through a two-deep cp.async ring, the next tile in flight
// while this one is used.  bf16 runs on the tensor cores: H <= 16 heads are
// exactly the M of mma.sync m16n8k16, for the scores (depth R + r, warp w
// takes keys 8w..8w+7) and for P . ckv (N = R, warp w takes R / 8 columns),
// their fragments read from shared memory by ldmatrix (one instruction for
// four 8 x 8 tiles); the softmax runs in f32 between them (two rows per
// warp, exp2).  A warp of a tile's gather reads its eight keys' block-table
// entries before any of their copies.  P goes
// to the tensor cores as two bf16 halves, hi = bf16(P) and lo = bf16(P -
// hi), so the output keeps f32-level error against the oracle, which does
// not round P (the Pallas kernel does).  A split writes its partial (the
// unnormalised f32 read-out, m in log2 units, l) per head to a workspace
// of (B, H, splits, R + 2) floats, and a second kernel in the same C call
// (mla_combine_kernel, one block a (row, head), decode_combine of
// common.cuh) merges a row's splits in split order, so a run replays bit
// for bit; with one split the block writes the output itself.  The
// partials cost H (R + 2) 4 bytes a split (32.9 KB at H = 16, R = 512),
// written once and read once, against at least MLA_MIN_SPLIT = 128 keys of
// 1152 bytes a split: at most 22% of the key bytes (4.2 MB against 16.5 MB
// at the serving decode).  f32 runs one block a row on FMAs (the identity
// runs only).

#include "common.cuh"

namespace {

constexpr int ML_H = 16;                    // head rows of a block (M = 16)
constexpr int ML_WARPS = 8, ML_THREADS = ML_WARPS * 32;
constexpr int ML_KT = 64;                   // keys per tile, bf16
constexpr int ML_KT32 = 32;                 // keys per tile, f32
constexpr int ML_LDP = ML_KT + 4;           // score row stride, floats

template <int R, int RR>
struct Mla {
    static_assert(R % (8 * ML_WARPS) == 0 && RR % 16 == 0
                  && (R + RR) % 32 == 0, "tile shape");
    static constexpr int K = R + RR;        // score depth
    static constexpr int LD = K + 8;        // bf16 staged row stride
    static constexpr int LD32 = K + 1;      // f32 staged row stride
    static constexpr int NTW = R / 8 / ML_WARPS;   // P.ckv n-tiles per warp
    static constexpr size_t SMEM_BF16 =
        (size_t)(ML_H + 2 * ML_KT) * LD * 2 + ML_H * ML_LDP * 4
        + 3 * ML_H * 4;
    static constexpr size_t SMEM_F32 =
        ((size_t)ML_H * LD32 + ML_KT32 * LD32 + ML_H * ML_KT32 + 3 * ML_H)
        * 4;
};

// Element offset of key ``pos``'s row in a pool of ``width``-wide rows.
__device__ __forceinline__ size_t pool_row(const int* table, int pos, int bs,
                                           int width) {
    return ((size_t)__ldg(table + pos / bs) * bs + pos % bs) * width;
}

// Stage keys [t0, t0 + ML_KT) of the row (zeros at and past k_hi): ckv in
// columns [0, R), krope in [R, R + RR) of each LD-wide row.  Warp w stages
// keys 8 w .. 8 w + 7, its lanes the 16-byte chunks of each; the eight
// block-table reads come first, so no copy waits on its own table read.
template <int R, int RR>
__device__ __forceinline__ void mla_load_tile(
    __nv_bfloat16* kv_s, const __nv_bfloat16* __restrict__ ckv,
    const __nv_bfloat16* __restrict__ krope, const int* table, int t0,
    int k_hi, int bs) {
    using M = Mla<R, RR>;
    constexpr int CH = M::K / 8, CR = R / 8;   // 16-byte chunks per row
    constexpr int KW = ML_KT / ML_WARPS;       // keys a warp
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int blk[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) {
        const int pos = t0 + warp * KW + j;
        blk[j] = pos < k_hi ? __ldg(table + pos / bs) : -1;
    }
#pragma unroll
    for (int j = 0; j < KW; ++j) {
        const int i = warp * KW + j, pos = t0 + i;
        const bool ok = blk[j] >= 0;
        const size_t row = ok ? (size_t)blk[j] * bs + pos % bs : 0;
#pragma unroll
        for (int ch = lane; ch < CH; ch += 32) {
            const __nv_bfloat16* src =
                ch < CR ? ckv + row * R + ch * 8
                        : krope + row * RR + (ch - CR) * 8;
            cp_async16(kv_s + i * M::LD + ch * 8, src, ok);
        }
    }
}

template <int R, int RR>
__global__ void __launch_bounds__(ML_THREADS) mla_decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q_lat,   // (B, H, R)
    const __nv_bfloat16* __restrict__ q_rope,  // (B, H, RR)
    const __nv_bfloat16* __restrict__ ckv,     // (N, bs, R)
    const __nv_bfloat16* __restrict__ krope,   // (N, bs, RR)
    const int* __restrict__ tables,            // (B, W)
    const int* __restrict__ lengths,           // (B,)
    float* __restrict__ out,                   // (B, H, R), one split
    float* __restrict__ part,                  // (B, H, splits, R + 2)
    int H, int W, int bs, float scale, int split_len, int splits) {
    using M = Mla<R, RR>;
    constexpr int LD = M::LD;
    const int b = blockIdx.x, z = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* kv_s = q_s + ML_H * LD;             // 2 x ML_KT x LD
    float* p_s = reinterpret_cast<float*>(kv_s + 2 * ML_KT * LD);
    float* m_s = p_s + ML_H * ML_LDP;
    float* l_s = m_s + ML_H;
    float* c_s = l_s + ML_H;

    const int* table = tables + (size_t)b * W;
    // this split's keys [k_lo, k_hi), clipped to the row's length
    const int k_lo = z * split_len;
    const int k_hi = min(min(lengths[b], W * bs), k_lo + split_len);
    const int ntiles = k_hi > k_lo ? (k_hi - k_lo + ML_KT - 1) / ML_KT : 0;
    const int cb = warp * M::NTW * 8;                  // this warp's columns
    float* out_b = out + (size_t)b * H * R;
    // head h's partial: part_b[h * part_h + d]
    const size_t part_h = (size_t)splits * (R + 2);
    float* part_b = part == nullptr
        ? nullptr : part + ((size_t)b * H * splits + z) * (R + 2);
    if (ntiles == 0 && part_b != nullptr) {   // nothing visible: empty partial
        for (int e = threadIdx.x; e < H * (R + 2); e += ML_THREADS) {
            const int h = e / (R + 2), d = e % (R + 2);
            part_b[h * part_h + d] = d == R ? -INFINITY : 0.f;
        }
        return;
    }

    // queries (rows past H are zeros), then the first key tile
    for (int c = threadIdx.x; c < ML_H * (M::K / 8); c += ML_THREADS) {
        const int h = c / (M::K / 8), ch = c % (M::K / 8);
        const bool ok = h < H;
        const __nv_bfloat16* src = q_lat;
        if (ok)
            src = ch < R / 8 ? q_lat + ((size_t)b * H + h) * R + ch * 8
                             : q_rope + ((size_t)b * H + h) * RR
                                      + (ch - R / 8) * 8;
        cp_async16(q_s + h * LD + ch * 8, src, ok);
    }
    if (threadIdx.x < ML_H) {
        m_s[threadIdx.x] = -INFINITY;
        l_s[threadIdx.x] = 0.f;
    }
    if (ntiles > 0)
        mla_load_tile<R, RR>(kv_s, ckv, krope, table, k_lo, k_hi, bs);
    cp_async_commit();

    const float sl2 = scale * 1.4426950408889634f;     // scores in log2 units
    float o[M::NTW][4];
#pragma unroll
    for (int nt = 0; nt < M::NTW; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
            mla_load_tile<R, RR>(kv_s + ((t + 1) & 1) * ML_KT * LD, ckv,
                                 krope, table, k_lo + (t + 1) * ML_KT, k_hi,
                                 bs);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                   // tile t (and the queries) landed
        const __nv_bfloat16* kv = kv_s + (t & 1) * ML_KT * LD;

        // S = Q K^T for this warp's 8 keys, depth R + RR, two 16-deep steps
        // a pass, each into its own accumulator (half the chain of
        // dependent mma): Q's A fragments and K's B fragments by ldmatrix
        // (lanes 8 m .. 8 m + 7 address matrix m: for K, keys 0-7 at dims
        // + 8 m)
        float s[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 3
        for (int kk = 0; kk < M::K / 16; kk += 2) {
            uint32_t a0[4], a1[4], bk[4];
            ldsm_x4<false>(a0, q_s + (lane & 15) * LD + kk * 16
                                   + (lane >> 4) * 8);
            ldsm_x4<false>(a1, q_s + (lane & 15) * LD + kk * 16 + 16
                                   + (lane >> 4) * 8);
            ldsm_x4<false>(bk, kv + (warp * 8 + (lane & 7)) * LD + kk * 16
                                   + (lane >> 3) * 8);
            mma_bf16(s, a0, bk[0], bk[1]);
            mma_bf16(s1, a1, bk[2], bk[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] += s1[c];
        {
            const int key = k_lo + t * ML_KT + warp * 8 + tig * 2;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float2 v = make_float2(
                    key < k_hi ? s[2 * i] * sl2 : -INFINITY,
                    key + 1 < k_hi ? s[2 * i + 1] * sl2 : -INFINITY);
                *reinterpret_cast<float2*>(
                    p_s + (gid + 8 * i) * ML_LDP + warp * 8 + tig * 2) = v;
            }
        }
        __syncthreads();

        // online softmax: warp w takes rows 2w and 2w + 1, 4 keys a lane
        {
            const int row = 2 * warp + lane / 16, l16 = lane % 16;
            float4 v = *reinterpret_cast<float4*>(p_s + row * ML_LDP
                                                  + l16 * 4);
            float tmax = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, tmax);
            const float ref = m_new == -INFINITY ? 0.f : m_new;
            v.x = exp2f(v.x - ref);
            v.y = exp2f(v.y - ref);
            v.z = exp2f(v.z - ref);
            v.w = exp2f(v.w - ref);
            float sum = (v.x + v.y) + (v.z + v.w);
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            *reinterpret_cast<float4*>(p_s + row * ML_LDP + l16 * 4) = v;
            __syncwarp();
            if (l16 == 0) {
                const float corr = exp2f(m_old - ref);
                m_s[row] = m_new;
                l_s[row] = l_s[row] * corr + sum;
                c_s[row] = corr;
            }
        }
        __syncthreads();

        // O = O * corr + P ckv for this warp's columns
        {
            const float c0 = c_s[gid], c1 = c_s[gid + 8];
#pragma unroll
            for (int nt = 0; nt < M::NTW; ++nt) {
                o[nt][0] *= c0;
                o[nt][1] *= c0;
                o[nt][2] *= c1;
                o[nt][3] *= c1;
            }
#pragma unroll
            for (int kk = 0; kk < ML_KT / 16; ++kk) {
                const float* p0 = p_s + gid * ML_LDP + kk * 16 + tig * 2;
                const float* p1 = p0 + 8 * ML_LDP;
                uint32_t ph[4], pl[4];
                split_bf16(p0[0], p0[1], ph[0], pl[0]);
                split_bf16(p1[0], p1[1], ph[1], pl[1]);
                split_bf16(p0[8], p0[9], ph[2], pl[2]);
                split_bf16(p1[8], p1[9], ph[3], pl[3]);
                // ckv's B fragments of columns nt, nt + 1 by ldmatrix.trans
                // (an odd last column tile, R = 64, element by element)
#pragma unroll
                for (int nt = 0; nt < M::NTW; nt += 2) {
                    if (nt + 1 < M::NTW) {
                        uint32_t bv[4];
                        ldsm_x4<true>(bv, kv + (kk * 16 + (lane & 7)
                                                + ((lane >> 3) & 1) * 8) * LD
                                             + cb + (nt + (lane >> 4)) * 8);
                        mma_bf16(o[nt], ph, bv[0], bv[1]);
                        mma_bf16(o[nt], pl, bv[0], bv[1]);
                        mma_bf16(o[nt + 1], ph, bv[2], bv[3]);
                        mma_bf16(o[nt + 1], pl, bv[2], bv[3]);
                    } else {
                        const __nv_bfloat16* vr = kv + (kk * 16 + tig * 2) * LD
                                                + cb + nt * 8 + gid;
                        const uint32_t b0 = pack_bf16(vr[0], vr[LD]);
                        const uint32_t b1 = pack_bf16(vr[8 * LD], vr[9 * LD]);
                        mma_bf16(o[nt], ph, b0, b1);
                        mma_bf16(o[nt], pl, b0, b1);
                    }
                }
            }
        }
        __syncthreads();                   // tile and scores consumed
    }
    cp_async_wait<0>();                    // the queries, for an empty row
    __syncthreads();

    // the output (one split), or this split's partial: O unnormalised,
    // then m (log2 units) and l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int h = gid + 8 * i;
        if (h >= H) continue;
        if (part_b == nullptr) {
            const float inv = 1.f / fmaxf(l_s[h], REPRO_L_FLOOR);
#pragma unroll
            for (int nt = 0; nt < M::NTW; ++nt)
                *reinterpret_cast<float2*>(out_b + (size_t)h * R + cb
                                           + nt * 8 + tig * 2) =
                    make_float2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
            continue;
        }
        float* ph = part_b + h * part_h;
#pragma unroll
        for (int nt = 0; nt < M::NTW; ++nt)
            *reinterpret_cast<float2*>(ph + cb + nt * 8 + tig * 2) =
                make_float2(o[nt][2 * i], o[nt][2 * i + 1]);
        if (warp == 0 && tig == 0) {
            ph[R] = m_s[h];
            ph[R + 1] = l_s[h];
        }
    }
}

// Merges a row's split partials per (row, head): blockIdx.x = b * H + h.
template <int R>
__global__ void __launch_bounds__(DS_THREADS) mla_combine_kernel(
    const float* __restrict__ part, float* __restrict__ out, int splits) {
    extern __shared__ float w_s[];
    decode_combine<R, float>(part + (size_t)blockIdx.x * splits * (R + 2),
                             splits, out + (size_t)blockIdx.x * R, w_s);
}

template <int R, int RR>
__global__ void __launch_bounds__(ML_THREADS) mla_decode_f32_kernel(
    const float* __restrict__ q_lat, const float* __restrict__ q_rope,
    const float* __restrict__ ckv, const float* __restrict__ krope,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int W, int bs, float scale) {
    using M = Mla<R, RR>;
    constexpr int K = M::K, LD = M::LD32, KT = ML_KT32;
    constexpr int NC = R / 16;                 // output columns a thread owns
    const int b = blockIdx.x;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);   // ML_H x LD
    float* kv_s = q_s + ML_H * LD;                      // KT x LD
    float* p_s = kv_s + KT * LD;                        // ML_H x KT
    float* m_s = p_s + ML_H * KT;
    float* l_s = m_s + ML_H;
    float* c_s = l_s + ML_H;

    const int* table = tables + (size_t)b * W;
    const int k_hi = min(lengths[b], W * bs);
    const float sl2 = scale * 1.4426950408889634f;
    for (int e = threadIdx.x; e < ML_H * K; e += ML_THREADS) {
        const int h = e / K, d = e % K;
        float v = 0.f;
        if (h < H)
            v = d < R ? q_lat[((size_t)b * H + h) * R + d]
                      : q_rope[((size_t)b * H + h) * RR + d - R];
        q_s[h * LD + d] = v;
    }
    if (threadIdx.x < ML_H) {
        m_s[threadIdx.x] = -INFINITY;
        l_s[threadIdx.x] = 0.f;
    }
    // scores: thread -> (head sh, keys sj and sj + 16); read-out: thread
    // -> (head sh, columns sj + 16 i)
    const int sh = threadIdx.x / 16, sj = threadIdx.x % 16;
    float acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.f;

    for (int t0 = 0; t0 < k_hi; t0 += KT) {
        __syncthreads();                       // previous tile consumed
        for (int e = threadIdx.x; e < KT * K; e += ML_THREADS) {
            const int i = e / K, d = e % K, pos = t0 + i;
            float v = 0.f;
            if (pos < k_hi)
                v = d < R ? ckv[pool_row(table, pos, bs, R) + d]
                          : krope[pool_row(table, pos, bs, RR) + d - R];
            kv_s[i * LD + d] = v;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j = sj + 16 * u;
            const float* qr = q_s + sh * LD;
            const float* kr = kv_s + j * LD;
            float s = 0.f;
            for (int d = 0; d < K; ++d) s += qr[d] * kr[d];
            p_s[sh * KT + j] = t0 + j < k_hi ? s * sl2 : -INFINITY;
        }
        __syncthreads();
        {   // online softmax: warp w takes rows 2w and 2w + 1, 2 keys a lane
            const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
            const int row = 2 * warp + lane / 16, l16 = lane % 16;
            float v0 = p_s[row * KT + l16], v1 = p_s[row * KT + l16 + 16];
            float tmax = fmaxf(v0, v1);
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, tmax);
            const float ref = m_new == -INFINITY ? 0.f : m_new;
            v0 = exp2f(v0 - ref);
            v1 = exp2f(v1 - ref);
            float sum = v0 + v1;
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            p_s[row * KT + l16] = v0;
            p_s[row * KT + l16 + 16] = v1;
            __syncwarp();
            if (l16 == 0) {
                const float corr = exp2f(m_old - ref);
                m_s[row] = m_new;
                l_s[row] = l_s[row] * corr + sum;
                c_s[row] = corr;
            }
        }
        __syncthreads();
        const float corr = c_s[sh];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] *= corr;
        for (int j = 0; j < KT; ++j) {
            const float p = p_s[sh * KT + j];
            const float* vr = kv_s + j * LD + sj;
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[i] += p * vr[16 * i];
        }
    }
    if (sh < H) {
        const float inv = 1.f / fmaxf(l_s[sh], REPRO_L_FLOOR);
        float* o = out + ((size_t)b * H + sh) * R + sj;
#pragma unroll
        for (int i = 0; i < NC; ++i) o[16 * i] = acc[i] * inv;
    }
}

template <int R, int RR>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const int* tables, const int* lengths,
           float* out, float* part, int B, int H, int W, int bs, float scale,
           int splits, int split_len, int dtype, cudaStream_t stream) {
    using M = Mla<R, RR>;
    if (dtype == REPRO_BF16) {
        auto kernel = mla_decode_bf16_kernel<R, RR>;
        cudaError_t err = reserve_smem(kernel, M::SMEM_BF16);
        if (err != cudaSuccess) return (int)err;
        kernel<<<dim3(B, splits), ML_THREADS, M::SMEM_BF16, stream>>>(
            (const __nv_bfloat16*)q_lat, (const __nv_bfloat16*)q_rope,
            (const __nv_bfloat16*)ckv, (const __nv_bfloat16*)krope, tables,
            lengths, out, splits == 1 ? nullptr : part, H, W, bs, scale,
            split_len, splits);
        err = cudaGetLastError();
        if (err != cudaSuccess || splits == 1) return (int)err;
        mla_combine_kernel<R><<<B * H, DS_THREADS,
                                sizeof(float) * 2 * splits, stream>>>(
            part, out, splits);
        return (int)cudaGetLastError();
    }
    auto kernel = mla_decode_f32_kernel<R, RR>;
    cudaError_t err = reserve_smem(kernel, M::SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, ML_THREADS, M::SMEM_F32, stream>>>(
        (const float*)q_lat, (const float*)q_rope, (const float*)ckv,
        (const float*)krope, tables, lengths, out, H, W, bs, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q_lat (B, H, R), q_rope (B, H, RR), ckv_pool (N, bs, R), krope_pool (N,
// bs, RR), tables (B, W) int32, lengths (B,) int32, out (B, H, R) f32; all
// contiguous on one device and 16-byte aligned.  H <= 16.  (R, RR) built:
// (512, 64), deepseek-v2-lite's, and (64, 32), its reduced test config.
// bf16: the W * bs keys are cut into ``splits`` splits of ``split_len``
// keys (a multiple of 64, chosen by the wrapper), and ``part`` is a (B, H,
// splits, R + 2) f32 workspace when splits > 1; f32 ignores the three.
// Returns cudaGetLastError() after the launches, or REPRO_UNSUPPORTED.
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_rope, const void* ckv_pool,
    const void* krope_pool, const void* tables, const void* lengths,
    void* out, void* part, int B, int H, int R, int RR, int W, int bs,
    float scale, int splits, int split_len, int dtype, void* stream) {
    if (H <= 0 || H > ML_H) return REPRO_UNSUPPORTED;
    if (dtype != REPRO_BF16 && dtype != REPRO_F32) return REPRO_UNSUPPORTED;
    if (dtype == REPRO_BF16
        && (splits < 1 || splits > DS_MAX_SPLITS || split_len < ML_KT
            || split_len % ML_KT != 0
            || (long long)splits * split_len < (long long)W * bs
            || (splits > 1 && part == nullptr)))
        return REPRO_UNSUPPORTED;
    if (((size_t)q_lat | (size_t)q_rope | (size_t)ckv_pool
         | (size_t)krope_pool) % 16 != 0)
        return REPRO_UNSUPPORTED;
    const int* tab = (const int*)tables;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(RANK, ROPE)                                              \
    if (R == RANK && RR == ROPE)                                            \
        return launch<RANK, ROPE>(q_lat, q_rope, ckv_pool, krope_pool, tab, \
                                  len, (float*)out, (float*)part, B, H, W,  \
                                  bs, scale, splits, split_len, dtype, st);
    REPRO_CASE(512, 64)
    REPRO_CASE(64, 32)
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
