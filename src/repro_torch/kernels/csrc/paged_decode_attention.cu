// Fused paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py,
// function paged_decode_attention (Pallas body _decode_kernel).  One query
// token per batch row attends over that row's pages of the paged K/V pool,
// walking the block table inside the kernel: no dense pool[block_tables]
// copy is made, and each live key is read from the pool once.
//
// What bounds it on the H100: bytes.  Per key it does 4*G*D flops against
// 2*D*itemsize bytes of K/V (about 7 flops per byte in bf16 at G = 7), far
// below the ~295 flops/byte the card needs before its tensor cores matter.
// So the design is about keeping many independent loads in flight.
//
// Design.  The TPU kernel steps a sequential grid (B, KV, W) and carries the
// running softmax (acc, m, l) in VMEM scratch across the page axis.  Hopper
// blocks run in parallel in no order, so one thread block per (kv head,
// batch row) walks the key range [lo, length) itself, lo = length - window
// when windowed (keys below it, and so the pages wholly below it, are never
// read).  The range is cut into warp tiles of TK keys, dealt round-robin to
// the block's WARPS warps; the block id of each key comes from the table.
// Inside a warp tile every lane owns one 8-element chunk of the head dim
// for NJ keys, read with 16-byte vector loads straight into registers (no
// shared-memory staging, no block barrier in the key loop), and the next
// tile's loads are issued before the current tile is folded in.  The G
// query vectors (pre-scaled) sit in shared memory and a lane keeps the G
// accumulator slices of its chunk: partial dot products are summed across
// the D/8 lanes of a key with shuffles, the tile max across the warp with
// shuffles, and every lane updates its own (acc, l) with the warp's running
// max m, so the softmax runs on all 32 lanes at once, in log2 units (exp2
// is one instruction).  At the end each warp sums (acc, l) across its key
// lanes, and the warps' (m, l, acc) are merged through shared memory into
// the output (the flash-decoding combine, done inside the block).  bf16
// and f32 are widened to f32 on load; sums stay in f32.
//
// Masking is the reference's: keys with pos >= length (or below the window)
// score NEG_INF = -1e30, and the output divides by max(l, 1e-30), so a row
// of length 0 writes zeros.
//
// Known limit, left for a later change: with B * KV = 16..32 blocks on 132
// SMs the card is underfilled, and the block of the longest row, one tile
// of loads in flight per warp, sets the time.  Splitting the key axis
// across blocks (split-K flash decode with a second combine pass) is the
// fix.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GMAX = 8;  // query heads per kv head this kernel takes

// Eight consecutive elements of one row, read with 16-byte vector loads.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
    uint4 raw;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        raw = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
    __device__ __forceinline__ void widen(float (&f)[8]) const {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 t = __bfloat1622float2(h[i]);
            f[2 * i] = t.x;
            f[2 * i + 1] = t.y;
        }
    }
};

template <>
struct Vec8<float> {
    float4 a, b;
    __device__ __forceinline__ void load(const float* p) {
        a = __ldg(reinterpret_cast<const float4*>(p));
        b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    }
    __device__ __forceinline__ void zero() {
        a = make_float4(0.f, 0.f, 0.f, 0.f);
        b = a;
    }
    __device__ __forceinline__ void widen(float (&f)[8]) const {
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
};

template <typename T, int D>
struct Tile {
    static constexpr int CPK = D / 8;        // lanes sharing one key
    static constexpr int KPS = 32 / CPK;     // keys per warp-wide step
    static constexpr int NJ = sizeof(T) == 2 ? 4 : 2;  // steps per tile
    static constexpr int TK = KPS * NJ;      // keys per warp tile
};

// Issue one warp tile's K/V loads; keys at or past k_hi are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(
    Vec8<T> (&k)[Tile<T, D>::NJ], Vec8<T> (&v)[Tile<T, D>::NJ],
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ table, int t0, int k_hi, int bs, int KV, int h,
    int lane) {
    using Tl = Tile<T, D>;
    const int kr = lane / Tl::CPK, dc = lane % Tl::CPK;
#pragma unroll
    for (int j = 0; j < Tl::NJ; ++j) {
        const int pos = t0 + j * Tl::KPS + kr;
        if (pos < k_hi) {
            const int bid = __ldg(table + pos / bs);
            const size_t src =
                (((size_t)bid * bs + pos % bs) * KV + h) * D + dc * 8;
            k[j].load(k_pool + src);
            v[j].load(v_pool + src);
        } else {
            k[j].zero();
            v[j].zero();
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,           // (B, H, D)
    const T* __restrict__ k_pool,      // (N, bs, KV, D)
    const T* __restrict__ v_pool,      // (N, bs, KV, D)
    const int* __restrict__ tables,    // (B, W)
    const int* __restrict__ lengths,   // (B,)
    T* __restrict__ out,               // (B, H, D)
    int H, int KV, int W, int bs, int window, float scale) {
    using Tl = Tile<T, D>;
    constexpr int NJ = Tl::NJ;
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int kr = lane / Tl::CPK, dc = lane % Tl::CPK;
    const int G = H / KV;

    // queries pre-scaled by scale * log2(e); every lane of a key repeats
    // the tile's exponentials, so they are exp2, not exp
    __shared__ __align__(16) float q_s[GMAX][D];
    __shared__ float m_s[WARPS][GMAX];
    __shared__ float l_s[WARPS][GMAX];
    __shared__ float acc_s[WARPS][GMAX][D];

    const int length = lengths[b];
    // valid keys: pos < length and, windowed, pos >= length - window
    const int k_hi = min(length, W * bs);
    const int k_lo = window > 0 ? max(0, length - window) : 0;
    const int* table = tables + (size_t)b * W;

    const float qscale = scale * 1.4426950408889634f;   // * log2(e)
    for (int e = threadIdx.x; e < GMAX * D; e += THREADS) {
        const int g = e / D, d = e % D;
        q_s[g][d] = g < G ? to_f(q[((size_t)b * H + h * G + g) * D + d])
                                * qscale
                          : 0.f;
    }
    float acc[GMAX][8], m[GMAX], l[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
        m[g] = REPRO_NEG_INF;
        l[g] = 0.f;
    }
    __syncthreads();

    constexpr int STRIDE = WARPS * Tl::TK;
    Vec8<T> ck[NJ], cv[NJ];
    int t0 = k_lo + warp * Tl::TK;
    load_tile<T, D>(ck, cv, k_pool, v_pool, table, t0, k_hi, bs, KV, h, lane);
    for (; t0 < k_hi; t0 += STRIDE) {
        Vec8<T> nk[NJ], nv[NJ];    // next tile's loads, in flight meanwhile
        load_tile<T, D>(nk, nv, k_pool, v_pool, table, t0 + STRIDE, k_hi, bs,
                        KV, h, lane);
        // partial scores over this lane's 8 dims, then whole dot products
        // summed over the CPK lanes of a key
        float s[GMAX][NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            float kf[8];
            ck[j].widen(kf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
                const float4* qv = reinterpret_cast<const float4*>(
                    &q_s[g][dc * 8]);
                const float4 q0 = qv[0], q1 = qv[1];
                s[g][j] = q0.x * kf[0] + q0.y * kf[1] + q0.z * kf[2]
                        + q0.w * kf[3] + q1.x * kf[4] + q1.y * kf[5]
                        + q1.z * kf[6] + q1.w * kf[7];
            }
        }
#pragma unroll
        for (int off = 1; off < Tl::CPK; off <<= 1)
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], off);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            if (t0 + j * Tl::KPS + kr >= k_hi)
#pragma unroll
                for (int g = 0; g < GMAX; ++g) s[g][j] = REPRO_NEG_INF;
        // online softmax: the tile max over the warp, then s becomes p
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            float tmax = s[g][0];
#pragma unroll
            for (int j = 1; j < NJ; ++j) tmax = fmaxf(tmax, s[g][j]);
#pragma unroll
            for (int off = Tl::CPK; off < 32; off <<= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            const float m_new = fmaxf(m[g], tmax);
            const float corr = exp2f(m[g] - m_new);
            m[g] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                s[g][j] = exp2f(s[g][j] - m_new);
                sum += s[g][j];
            }
            l[g] = l[g] * corr + sum;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            float vf[8];
            cv[j].widen(vf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[g][e] += s[g][j] * vf[e];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            ck[j] = nk[j];
            cv[j] = nv[j];
        }
    }

    // this warp's (acc, l): sum over the lanes that hold other keys
#pragma unroll
    for (int off = Tl::CPK; off < 32; off <<= 1)
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        }
    if (kr == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc_s[warp][g][dc * 8 + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            m_s[warp][g] = m[g];
            l_s[warp][g] = l[g];
        }
    }
    __syncthreads();

    // merge the warps' partial softmaxes
    for (int e = threadIdx.x; e < G * D; e += THREADS) {
        const int g = e / D, d = e % D;
        float mx = m_s[0][g];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float c = exp2f(m_s[w][g] - mx);
            num += acc_s[w][g][d] * c;
            den += l_s[w][g] * c;
        }
        out[((size_t)b * H + h * G + g) * D + d] =
            from_f<T>(num / fmaxf(den, REPRO_L_FLOOR));
    }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lengths, void* out, int B, int H,
           int KV, int W, int bs, int window, float scale,
           cudaStream_t stream) {
    paged_decode_kernel<T, D><<<dim3(KV, B), THREADS, 0, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, lengths,
        (T*)out, H, KV, W, bs, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D), pools (N, bs, KV, D), tables (B, W) int32, lengths (B,)
// int32, out like q; all contiguous on one device, the pools 16-byte
// aligned.  window <= 0 means none.  Returns cudaGetLastError() after the
// launch, or REPRO_UNSUPPORTED.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int KV, int D, int W,
    int bs, int window, float scale, int dtype, void* stream) {
    if (KV <= 0 || H % KV != 0 || H / KV > GMAX) return REPRO_UNSUPPORTED;
    if (((size_t)k_pool | (size_t)v_pool) % 16 != 0) return REPRO_UNSUPPORTED;
    const int* tab = (const int*)tables;
    const int* len = (const int*)lengths;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(TYPE, DIM)                                             \
    return launch<TYPE, DIM>(q, k_pool, v_pool, tab, len, out, B, H, KV, \
                             W, bs, window, scale, st)
    if (dtype == REPRO_F32 && D == 64) REPRO_CASE(float, 64);
    if (dtype == REPRO_F32 && D == 128) REPRO_CASE(float, 128);
    if (dtype == REPRO_BF16 && D == 64) REPRO_CASE(__nv_bfloat16, 64);
    if (dtype == REPRO_BF16 && D == 128) REPRO_CASE(__nv_bfloat16, 128);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
