// Shared device code of the hand-written kernels.
//
// Four block bodies carry the four GQA attention kernels, each
// parameterised by how a key's address is found (an "address" functor: key
// position -> element offset of that key's values for the block's kv head):
//
//   decode_block   one query token per row, G query heads per kv head:
//                  paged_decode_attention.cu (block table) and
//                  decode_attention.cu in f32 (dense cache);
//   decode_split_block  the same for bf16 on the tensor cores, one split
//                  of a row's keys for all G heads (mma.sync), its partial
//                  merged by decode_combine: decode_attention.cu and
//                  paged_decode_attention.cu in bf16 (a paged address
//                  reads a tile's block ids before its copies);
//                  paged_mla_decode_attention.cu merges its own splits'
//                  partials with decode_combine too;
//   prefill_block  a tile of (token, head) query rows, causal with a query
//                  offset, f32 FMAs: ragged_prefill_attention.cu and
//                  flash_attention.cu in f32, where the tensor cores'
//                  TF32 would not keep f32 tokens identical;
//   prefill_block_wgmma  the same for bf16 on Hopper's tensor cores: a
//                  producer warpgroup fills a ring of K/V tiles with
//                  cp.async behind mbarriers, a consumer warpgroup runs
//                  Q K^T and P V on wgmma; both prefill kernels in bf16.
//
// The prefill bodies take separate key and value widths (DK, DV) and
// address functors, for MLA's decompressed heads.  A kernel file resolves
// its block's row, bounds and address functors and calls one of them, so a
// faster body lifts each of its kernels at once.  The mma.sync and
// cp.async helpers below also serve paged_mla_decode_attention.cu, and
// the wgmma, mbarrier and TMA helpers grouped_matmul.cu and
// flash_attention_bwd.cu.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Masked-score value and softmax floor of the reference kernels.
#define REPRO_NEG_INF (-1e30f)
#define REPRO_L_FLOOR (1e-30f)

// dtype codes shared with the Python wrappers
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

// returned for a configuration no kernel was instantiated for
#define REPRO_UNSUPPORTED (-1)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Sets the dynamic shared-memory ceiling when a launch needs more than
// the 48 KB a block gets without asking.
template <typename K>
inline cudaError_t reserve_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// ---------------------------------------------------------------------------
// key addresses
// ---------------------------------------------------------------------------
// Paged pool (N, bs, KV, D): key ``pos`` of a row lives in block
// ``table[pos / bs]`` at offset ``pos % bs``.  ``kPaged`` tells the split
// body to read a tile's block ids (``block``) before it issues the tile's
// copies (``at``), so no copy waits on its own table read.
template <int D>
struct PagedAddr {
    static constexpr bool kPaged = true;
    const int* table;   // this row's block table
    int bs, KV, h;
    __device__ __forceinline__ int block(int pos) const {
        return __ldg(table + pos / bs);
    }
    __device__ __forceinline__ size_t at(int bid, int pos) const {
        return (((size_t)bid * bs + pos % bs) * KV + h) * D;
    }
    __device__ __forceinline__ size_t operator()(int pos) const {
        return at(block(pos), pos);
    }
};

// Dense cache (B, S, KV, D): key ``pos`` of row ``b`` at ((b*S + pos)*KV + h)*D.
template <int D>
struct DenseAddr {
    static constexpr bool kPaged = false;
    int b, S, KV, h;
    __device__ __forceinline__ size_t operator()(int pos) const {
        return (((size_t)b * S + pos) * KV + h) * D;
    }
};

// ---------------------------------------------------------------------------
// decode: one query token against a row's keys
// ---------------------------------------------------------------------------
// One thread block per (kv head, row) walks the key range [k_lo, k_hi).
// The range is cut into warp tiles of TK keys, dealt round-robin to the
// block's DEC_WARPS warps.  Inside a warp tile every lane owns one
// 8-element chunk of the head dim for NJ keys, read with 16-byte vector
// loads straight into registers (no shared-memory staging, no block
// barrier in the key loop), and the next tile's loads start before the
// current tile is folded in.  The G query vectors (pre-scaled) sit in
// shared memory and a lane keeps the G accumulator slices of its chunk:
// partial dot products are summed across the D/8 lanes of a key with
// shuffles, the tile max across the warp with shuffles, and every lane
// updates its own (acc, l) with the warp's running max m, so the softmax
// runs on all 32 lanes at once, in log2 units (exp2 is one instruction).
// At the end each warp sums (acc, l) across its key lanes, and the warps'
// (m, l, acc) are merged through shared memory into the output (the
// flash-decoding combine, done inside the block).  bf16 and f32 are
// widened to f32 on load; sums stay in f32.  Keys outside [k_lo, k_hi)
// score NEG_INF and the output divides by max(l, 1e-30), so an empty
// range writes zeros.
//
// A block takes at most DEC_GMAX query heads of its kv head: a lane holds
// DEC_GMAX x 8 accumulators and DEC_GMAX x NJ scores in registers, and
// more would spill them.  A group of G > DEC_GMAX heads (recurrentgemma's
// 10 over one kv head) is cut into ceil(G / DEC_GMAX) chunks along a third
// grid axis (dec_grid): each chunk's block walks the same keys, the second
// read coming from L2, and twice the blocks fill more of the card where
// B x KV is small.  The combine buffer, DEC_WARPS x DEC_GMAX x D floats
// (64 KB at D = 256), lives in dynamic shared memory (dec_smem_bytes),
// which a launch above 48 KB reserves (reserve_smem).

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_GMAX = 8;  // query heads of one kv head a block takes

template <int D>
__host__ __device__ constexpr size_t dec_smem_bytes() {
    return sizeof(float) * DEC_WARPS * DEC_GMAX * D;
}

// Grid of a decode launch: (kv head, row, chunk of DEC_GMAX query heads).
inline dim3 dec_grid(int B, int H, int KV) {
    return dim3(KV, B, (H / KV + DEC_GMAX - 1) / DEC_GMAX);
}

// This block's query heads: the first (``g0``, within the group of G) and
// how many (``gn``), from blockIdx.z.
struct DecHeads {
    int g0, gn;
    __device__ __forceinline__ DecHeads(int G)
        : g0(blockIdx.z * DEC_GMAX), gn(min(DEC_GMAX, G - g0)) {}
};

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
struct DecTile {
    static constexpr int CPK = D / 8;        // lanes sharing one key
    static constexpr int KPS = 32 / CPK;     // keys per warp-wide step
    static constexpr int NJ = sizeof(T) == 2 ? 4 : 2;  // steps per tile
    static constexpr int TK = KPS * NJ;      // keys per warp tile
};

// Start one warp tile's K/V loads; keys at or past k_hi are zeros.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void dec_load_tile(
    Vec8<T> (&k)[DecTile<T, D>::NJ], Vec8<T> (&v)[DecTile<T, D>::NJ],
    const T* __restrict__ k_src, const T* __restrict__ v_src,
    const Addr& addr, int t0, int k_hi, int lane) {
    using Tl = DecTile<T, D>;
    const int kr = lane / Tl::CPK, dc = lane % Tl::CPK;
#pragma unroll
    for (int j = 0; j < Tl::NJ; ++j) {
        const int pos = t0 + j * Tl::KPS + kr;
        if (pos < k_hi) {
            const size_t src = addr(pos) + dc * 8;
            k[j].load(k_src + src);
            v[j].load(v_src + src);
        } else {
            k[j].zero();
            v[j].zero();
        }
    }
}

// q_row / out_row: this block's G <= DEC_GMAX query heads of its kv head,
// (G, D) contiguous; k_src / v_src: the whole K and V arrays, indexed by
// addr; acc_s: dec_smem_bytes<D>() of dynamic shared memory.  Call with
// DEC_THREADS threads.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q_row, const T* __restrict__ k_src,
    const T* __restrict__ v_src, T* __restrict__ out_row, int G, int k_lo,
    int k_hi, float scale, const Addr& addr, float* __restrict__ acc_s) {
    using Tl = DecTile<T, D>;
    constexpr int NJ = Tl::NJ;
    constexpr int GMAX = DEC_GMAX;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int kr = lane / Tl::CPK, dc = lane % Tl::CPK;

    // queries pre-scaled by scale * log2(e); every lane of a key repeats
    // the tile's exponentials, so they are exp2, not exp
    __shared__ __align__(16) float q_s[GMAX][D];
    __shared__ float m_s[DEC_WARPS][GMAX];
    __shared__ float l_s[DEC_WARPS][GMAX];

    const float qscale = scale * 1.4426950408889634f;   // * log2(e)
    for (int e = threadIdx.x; e < GMAX * D; e += DEC_THREADS) {
        const int g = e / D, d = e % D;
        q_s[g][d] = g < G ? to_f(q_row[(size_t)g * D + d]) * qscale : 0.f;
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

    constexpr int STRIDE = DEC_WARPS * Tl::TK;
    Vec8<T> ck[NJ], cv[NJ];
    int t0 = k_lo + warp * Tl::TK;
    dec_load_tile<T, D>(ck, cv, k_src, v_src, addr, t0, k_hi, lane);
    for (; t0 < k_hi; t0 += STRIDE) {
        Vec8<T> nk[NJ], nv[NJ];    // next tile's loads, in flight meanwhile
        dec_load_tile<T, D>(nk, nv, k_src, v_src, addr, t0 + STRIDE, k_hi,
                            lane);
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
            for (int e = 0; e < 8; ++e)
                acc_s[(warp * GMAX + g) * D + dc * 8 + e] = acc[g][e];
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
    for (int e = threadIdx.x; e < G * D; e += DEC_THREADS) {
        const int g = e / D, d = e % D;
        float mx = m_s[0][g];
#pragma unroll
        for (int w = 1; w < DEC_WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) {
            const float c = exp2f(m_s[w][g] - mx);
            num += acc_s[(w * GMAX + g) * D + d] * c;
            den += l_s[w][g] * c;
        }
        out_row[(size_t)g * D + d] =
            from_f<T>(num / fmaxf(den, REPRO_L_FLOOR));
    }
}

// ---------------------------------------------------------------------------
// prefill: a tile of query rows, causal with a query offset
// ---------------------------------------------------------------------------
// One thread block takes one (query-row tile, kv head, row): the C x G
// (token, head) pairs of that kv head are flattened and cut into tiles of
// PRE_THREADS rows, one query row per thread, its q vector and accumulator
// in registers.  The block loops over key tiles of PRE_KT keys between the
// tile's bounds: the causal bound start + c_max (all k_max keys when not
// causal) and, windowed, the window bound start + c_min - window + 1, so
// keys beyond causal reach or wholly below the window are never read.
// Each key tile is staged in shared memory (addresses from the functors)
// and every thread folds the keys it may see (kp <= qp unless not causal,
// and qp - kp < window; qp = start + c) into its online softmax in f32.
// All threads of a warp read the same shared key at once (a broadcast), so
// staging is the only shared-memory traffic that can conflict.  Keys have
// DK values and values DV (MLA's decompressed heads: DK = DV + rope dims);
// kaddr and vaddr find a key's K and V rows.

constexpr int PRE_THREADS = 128;   // query rows per block

template <int DK, int DV>
__host__ __device__ constexpr int pre_key_tile() {   // keys per staged tile
    return 8192 / (DK + DV);
}

template <int DK, int DV>
__host__ __device__ constexpr size_t pre_smem_bytes() {
    return sizeof(float) * pre_key_tile<DK, DV>() * (DK + DV);
}

// q_rows / out_rows: this row's (C, H, DK) queries and (C, H, DV) outputs;
// k_src / v_src: the whole K and V arrays, indexed by kaddr / vaddr over
// [0, k_max).  smem: pre_smem_bytes<DK, DV>() of dynamic shared memory.
// With LSE, lse_rows is this row's (H, C) f32 log-sum-exp of the scaled
// scores, natural log, written for the backward (flash_attention_bwd.cu);
// a query with no visible key gets +inf, so a recompute exp(s - lse) gives
// it P = 0.  A template flag, so the instantiations without it (serving)
// compile as they did before it existed.  Call with PRE_THREADS threads.
template <typename T, int DK, int DV, bool LSE = false, typename KAddr,
          typename VAddr>
__device__ __forceinline__ void prefill_block(
    const T* __restrict__ q_rows, const T* __restrict__ k_src,
    const T* __restrict__ v_src, T* __restrict__ out_rows, int C, int H,
    int G, int h, int r0, int start, int k_max, bool causal, int window,
    float scale, const KAddr& kaddr, const VAddr& vaddr, float* smem,
    float* __restrict__ lse_rows = nullptr) {
    constexpr int KT = pre_key_tile<DK, DV>();
    const int rows = C * G;
    const int r = r0 + threadIdx.x;
    const bool active = r < rows;
    const int c = active ? r / G : 0;
    const int g = active ? r % G : 0;
    const size_t head = (size_t)c * H + h * G + g;

    float* k_s = smem;                 // KT * DK
    float* v_s = k_s + KT * DK;        // KT * DV

    const int qp = start + c;
    const int c_lo = r0 / G;
    const int c_hi = min(rows - 1, r0 + PRE_THREADS - 1) / G;
    const int k_hi = causal ? min(k_max, start + c_hi + 1) : k_max;
    const int k_lo = window > 0 ? max(0, start + c_lo - window + 1) : 0;

    float qr[DK], acc[DV];
#pragma unroll
    for (int d = 0; d < DK; ++d)
        qr[d] = active ? to_f(q_rows[head * DK + d]) * scale : 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[d] = 0.f;
    float m = REPRO_NEG_INF, l = 0.f;

    for (int t0 = k_lo; t0 < k_hi; t0 += KT) {
        const int n = min(KT, k_hi - t0);
        __syncthreads();               // previous tile fully consumed
        if constexpr (DK == DV) {
            for (int e = threadIdx.x; e < n * DK; e += PRE_THREADS) {
                const int i = e / DK, d = e % DK;
                const size_t src = kaddr(t0 + i) + d;
                k_s[e] = to_f(k_src[src]);
                v_s[e] = to_f(v_src[src]);
            }
        } else {
            for (int e = threadIdx.x; e < n * DK; e += PRE_THREADS)
                k_s[e] = to_f(k_src[kaddr(t0 + e / DK) + e % DK]);
            for (int e = threadIdx.x; e < n * DV; e += PRE_THREADS)
                v_s[e] = to_f(v_src[vaddr(t0 + e / DV) + e % DV]);
        }
        __syncthreads();
        if (!active) continue;
        for (int i = 0; i < n; ++i) {
            const int kp = t0 + i;
            if ((causal && kp > qp) || (window > 0 && qp - kp >= window))
                continue;
            const float* kr = k_s + i * DK;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < DK; ++d) s += qr[d] * kr[d];
            if (s > m) {               // new running max: rescale once
                const float corr = expf(m - s);
                l *= corr;
#pragma unroll
                for (int d = 0; d < DV; ++d) acc[d] *= corr;
                m = s;
            }
            const float pe = expf(s - m);
            l += pe;
            const float* vr = v_s + i * DV;
#pragma unroll
            for (int d = 0; d < DV; ++d) acc[d] += pe * vr[d];
        }
    }
    if (active) {
        const float inv = 1.f / fmaxf(l, REPRO_L_FLOOR);
#pragma unroll
        for (int d = 0; d < DV; ++d)
            out_rows[head * DV + d] = from_f<T>(acc[d] * inv);
        if constexpr (LSE)             // m and the scores: natural units
            lse_rows[(size_t)(h * G + g) * C + c] =
                l > 0.f ? m + logf(l) : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// mma.sync helpers (grouped_matmul.cu, paged_mla_decode_attention.cu)
// ---------------------------------------------------------------------------
// c += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
    hi = pack_bf16(h0, h1);
    lo = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                   __float2bfloat16(x1 - __bfloat162float(h1)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory (ldmatrix): lane l gives the
// 16-byte row address of row l % 8 of matrix l / 8, and receives element
// pair (row lane / 4, columns 2 (lane % 4), +1) of each matrix, or with
// ``trans`` the pair (rows 2 (lane % 4), +1; column lane / 4): the mma.sync
// A fragment of a row-major tile, and the B fragment of a row-major (k, n)
// tile.
template <bool trans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    if constexpr (trans)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                     "{%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(a));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                     "{%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(a));
}

// ---------------------------------------------------------------------------
// asynchronous 16-byte copies into shared memory (cp.async, sm_80+)
// ---------------------------------------------------------------------------
// Copies 16 bytes from src to the shared dst, or writes 16 zero bytes and
// reads nothing when !full (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}


// cp.async.wait_all: every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, wgmma, register rebalancing (sm_90a)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// One arrival on ``bar`` once every cp.async this thread issued so far has
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A phase
// that has not completed after 2^35 clocks (about 17 s) means a fault of the
// kernel: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    const long long t0 = clock64();
    for (;;) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(a), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 35)) __trap();
    }
}

// One arrival on ``bar`` that also expects ``bytes`` of asynchronous copies
// (TMA) to complete the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA: the box of a 2D tensor map at (c0 inner, c1 outer) into shared
// memory at dst, completing ``bytes`` of ``bar``'s expected transactions.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            int c0, int c1, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1),
           "r"(smem_u32(bar)) : "memory");
}

// TMA: the box of a 4D tensor map at (c0 innermost .. c3) into shared
// memory at dst, completing its bytes on ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
           "r"(smem_u32(bar)) : "memory");
}

// A bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime once
// (build.py links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline int encode_tiled(EncodeTiled& fn) {
    static EncodeTiled cached = nullptr;
    if (cached == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
        if (err != cudaSuccess) return (int)err;
        if (q != cudaDriverEntryPointSuccess || p == nullptr)
            return REPRO_UNSUPPORTED;
        cached = reinterpret_cast<EncodeTiled>(p);
    }
    fn = cached;
    return 0;
}

// A bf16 map of a contiguous (batch, seq, heads, d) tensor with boxes of
// one head's 64 values (128 bytes, WgTile's 128-byte swizzle) x 64 rows of
// seq: coordinates (d0, head, row, batch); rows past seq read as zeros.
inline int bf16_rows_map(CUtensorMap* map, const void* base, int d,
                         int heads, int seq, int batch) {
    EncodeTiled encode;
    const int rc = encode_tiled(encode);
    if (rc != 0) return rc;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                   (cuuint64_t)heads * d * 2,
                                   (cuuint64_t)seq * heads * d * 2};
    const cuuint32_t box[4] = {64, 1, 64, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : REPRO_UNSUPPORTED;
}

// Orders this thread's generic-proxy view of shared memory (st.shared,
// cp.async) before the async proxy that wgmma reads it through.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory operand of wgmma: start address, leading and stride byte
// offsets, swizzle mode (1: 128-byte rows, 2: 64-byte rows).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint64_t mode) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator across a wgmma wait: its
// registers are written asynchronously, after the asm that names them.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, f32) = a b + (accumulate ? d : 0), a from shared memory
// (64 x 16, K-major), b from shared memory (16 x 64, K-major: the rows of
// K), both bf16.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = a b + (accumulate ? d : 0), a from registers (the
// m16n8k16 A fragments of the warpgroup's four warps), b from shared
// memory, both bf16: with TB MN-major (16 rows of 64 contiguous values:
// V's rows), else K-major (as wgmma_ss's).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
}

// d (64 x 64, f32) = a b + (accumulate ? d : 0) from two shared operands,
// b MN-major (as wgmma_rs<1>'s); a K-major, or with TA MN-major (its 16
// K rows of 64 contiguous M values, read transposed).
template <int TA>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA));
}

// d (64 x 32, f32) = a b + (accumulate ? d : 0) from two shared operands,
// each K-major, or with TA / TB MN-major (as wgmma_ss_mn's): with TB, b
// holds 32 values of its rows, from byte 0 or 64 of a 128-byte swizzle
// row.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128, f32) = a b + (accumulate ? d : 0), a from shared memory
// (64 x 16, K-major, or with TA MN-major: its 16 K rows of 64 contiguous M
// values), b from shared memory MN-major (16 rows of 128 contiguous values
// in two 64-value column blocks, the leading byte offset of the descriptor
// apart: grouped_matmul.cu's weight tiles), or with TB = 0 K-major (128
// rows of 16 values, as a's), both bf16.  The transpose bits read each
// operand as it lies, no transpose through registers.
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_ss_mn128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// As wgmma_ss_mn128 at N = 256: b holds four 64-value column blocks (TB),
// or 256 K-major rows (TB = 0).
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_ss_mn256(float (&d)[128], uint64_t a,
                                               uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// prefill on Hopper's tensor cores (bf16): wgmma fed by an asynchronous ring
// ---------------------------------------------------------------------------
// The same function as prefill_block for bf16 inputs.  A block of
// WG_THREADS threads takes WG_ROWS = 64 flattened (token, head) query rows
// of one kv head, so the G heads of a kv head share every K/V tile, in two
// warpgroups with their own roles:
//
//   producer (threads 128-255): walks the key tiles of WG_KT keys, and for
//     each finds every key row's address once (its functor: a block-table
//     read for a paged pool) into a small table in shared memory, then
//     copies the K and V rows into a ring of NS stages with 16-byte
//     cp.async, dealt over the warpgroup.  A paged pool is a gather (one
//     table entry per 16 keys), which no single tensor map describes, so
//     the dense keys take the same path: one body for both kernels.  Keys
//     past the tile's end are written as zeros.  A stage is announced on
//     its ``full`` mbarrier when each thread's copies have landed
//     (cp.async.mbarrier.arrive), and refilled once the consumers have
//     arrived on its ``empty`` mbarrier;
//   consumer (threads 0-127): Q sits in shared memory, loaded once, as
//     wgmma's A operand.  Per stage, S = Q K^T (64 x 64, f32) by DK / 16
//     wgmma m64n64k16 from two shared operands; the mask (causal, window,
//     the tile's end; skipped on a tile every row sees whole) and the
//     online softmax on the accumulator registers (row maxima over the 4
//     lanes of a row, exp2 in f32); then O = O * corr + P V by wgmma with
//     P from registers: the S accumulator's layout is the A fragment
//     layout, so P never touches shared memory.  P goes in as three bf16
//     parts, hi = bf16(P), mid = bf16(P - hi), lo = bf16(P - hi - mid):
//     one bf16 P errs by up to 2^-9 of each weight, and hi + lo by up to
//     2^-18, which at |O| ~ 3 (a short window) is still more than half a
//     bf16 step of the f32 plain version allows; three parts keep about 24
//     bits, so the P V work is three times the counted.  V is read
//     MN-major (its rows of DV contiguous values; no transpose).
//
// Tiles are stored as wgmma's canonical swizzled layouts: column blocks of
// one swizzle row (128 bytes, or 64 when DK = 96 is no multiple of 64
// values), the 16-byte chunks of a row XORed with the address bits above
// the row (WgTile::at), every tile 1024-byte aligned.  Shared memory: Q 64
// x DK plus NS stages of 64 x (DK + DV) bf16 (160 KB at (256, 256), two
// stages, one block an SM; two blocks an SM for the narrower pairs).
// Registers: O is DV / 2 f32 a thread (128 at DV = 256), S 32, one step's
// P parts 12; a thread may hold 255 at one block an SM (under 240 used
// at (256, 256), no spill) and 128 at two.  setmaxnreg, which would move
// the producer's registers to the consumers, does not help here: this ptxas
// compiles the whole kernel to the launch budget (at 384 threads, two
// consumer warpgroups, the consumers were held to 168 and spilled), so
// the producer warpgroup simply keeps its share.  Masked scores are -inf
// and a row whose maximum is still -inf takes 0 as its reference, so a row
// with no visible key writes zeros.

constexpr int WG_THREADS = 256;   // the consumer warpgroup, then the producer
constexpr int WG_ROWS = 64;       // query rows a block: one wgmma M tile
constexpr int WG_KT = 64;         // keys a ring stage

// Ring stages and blocks an SM for a (DK, DV) pair: two blocks an SM (their
// consumer warpgroups hide each other's latencies; 128 registers a thread)
// where the shared memory allows, one for (256, 256).
template <int DK, int DV>
struct WgShape {
    static constexpr int NS = DK + DV >= 256 ? 2 : 3;
    static constexpr size_t SMEM = 1024    // alignment slack
        + sizeof(__nv_bfloat16) * ((size_t)WG_ROWS * DK
                                   + (size_t)NS * WG_KT * (DK + DV));
    static constexpr int MIN_BLOCKS = DK + DV > 320 ? 1 : 2;
};

// A tile of rows of D bf16 values in wgmma's swizzled layout.
template <int D>
struct WgTile {
    static_assert(D % 32 == 0, "head dims are multiples of 32");
    static constexpr int RW = D % 64 == 0 ? 128 : 64;   // swizzle row bytes
    static constexpr int EPR = RW / 2;                   // values a row
    static constexpr int CPR = RW / 16;                  // chunks a row
    static constexpr uint64_t MODE = RW == 128 ? 1 : 2;
    // byte offset of 16-byte chunk ``ch`` of row ``i`` in a tile of R rows
    template <int R>
    __device__ static __forceinline__ uint32_t at(int i, int ch) {
        const uint32_t off = (ch / CPR) * (R * RW) + i * RW + (ch % CPR) * 16;
        return off ^ (((off >> 7) & (CPR - 1)) << 4);
    }
    // K-major descriptor of the 16 values from ``k`` on of a tile of R rows
    template <int R>
    __device__ static __forceinline__ uint64_t desc(uint32_t base, int k) {
        return wg_desc(base + (k / EPR) * (R * RW) + (k % EPR) * 2, 16,
                       8 * RW, MODE);
    }
};

// 2^x by the special-function unit; results below 2^-126 flush to zero (a
// softmax weight that small adds nothing an f32 sum keeps)
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// (x0, x1) -> two bf16 pairs whose sum is x to about 16 bits: hi =
// bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2_bf16(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) -> three bf16 pairs whose sum is x to about 24 bits: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
__device__ __forceinline__ void split3_bf16(float x0, float x1,
                                            uint32_t (&p)[3]) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
    p[0] = *reinterpret_cast<const uint32_t*>(&h);
    p[1] = *reinterpret_cast<const uint32_t*>(&m);
    p[2] = *reinterpret_cast<const uint32_t*>(&l);
}

// Arguments as prefill_block's (LSE too); smem: WgShape<DK, DV>::SMEM
// bytes of dynamic shared memory; q_rows, k_src and v_src 16-byte aligned.
// Call with WG_THREADS threads from a kernel bounded by (WG_THREADS,
// WgShape<DK, DV>::MIN_BLOCKS), r0 a multiple of WG_ROWS.
template <int DK, int DV, bool LSE = false, typename KAddr, typename VAddr>
__device__ __forceinline__ void prefill_block_wgmma(
    const __nv_bfloat16* __restrict__ q_rows,
    const __nv_bfloat16* __restrict__ k_src,
    const __nv_bfloat16* __restrict__ v_src,
    __nv_bfloat16* __restrict__ out_rows, int C, int H, int G, int h, int r0,
    int start, int k_max, bool causal, int window, float scale,
    const KAddr& kaddr, const VAddr& vaddr, unsigned char* smem,
    float* __restrict__ lse_rows = nullptr) {
    static_assert(DV % 64 == 0, "P V takes 64-value column blocks of V");
    constexpr int NS = WgShape<DK, DV>::NS, KT = WG_KT;
    using TK = WgTile<DK>;
    using TV = WgTile<DV>;
    constexpr int CHK = DK / 8, CHV = DV / 8;      // 16-byte chunks a row
    constexpr uint32_t Q_BYTES = WG_ROWS * DK * 2;
    constexpr uint32_t K_BYTES = KT * DK * 2, V_BYTES = KT * DV * 2;
    constexpr uint32_t STAGE = K_BYTES + V_BYTES;
    __shared__ uint64_t full[NS], empty[NS];
    __shared__ size_t k_ofs[NS][KT], v_ofs[NS][KT];  // a stage's key rows

    const uint32_t raw = smem_u32(smem);
    const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms align
    unsigned char* tiles = smem + (base - raw);
    const int rows = C * G;
    const int c_lo = r0 / G;
    const int c_hi = min(rows - 1, r0 + WG_ROWS - 1) / G;
    const int k_hi = causal ? min(k_max, start + c_hi + 1) : k_max;
    const int k_lo = window > 0 ? max(0, start + c_lo - window + 1) : 0;
    const int ntiles = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 128);      // one arrival a producer thread
            mbar_init(&empty[s], 128);     // one a consumer thread
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // ---- producer warpgroup: the K/V ring ----
        const int pt = threadIdx.x - 128;
        for (int t = 0; t < ntiles; ++t) {
            const int s = t % NS;
            if (t >= NS) mbar_wait(&empty[s], ((t / NS) - 1) & 1);
            const int t0 = k_lo + t * KT, n = min(KT, k_hi - t0);
            // each key row's address once (a block-table read for pages),
            // then 16-byte copies of its chunks, dealt over the warpgroup
            if (pt < n) {
                k_ofs[s][pt] = kaddr(t0 + pt);
                v_ofs[s][pt] = vaddr(t0 + pt);
            }
            named_barrier(2, 128);
            unsigned char* ks = tiles + Q_BYTES + s * STAGE;
            unsigned char* vs = ks + K_BYTES;
            for (int e = pt; e < KT * CHK; e += 128) {
                const int i = e / CHK, ch = e % CHK;
                const bool ok = i < n;
                cp_async16(ks + TK::template at<KT>(i, ch),
                           k_src + (ok ? k_ofs[s][i] + ch * 8 : 0), ok);
            }
            for (int e = pt; e < KT * CHV; e += 128) {
                const int i = e / CHV, ch = e % CHV;
                const bool ok = i < n;
                cp_async16(vs + TV::template at<KT>(i, ch),
                           v_src + (ok ? v_ofs[s][i] + ch * 8 : 0), ok);
            }
            mbar_arrive_on_copies(&full[s]);
        }
        cp_async_wait_all();
    } else {
        // ---- consumer warpgroup ----
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int gid = lane / 4, tig = lane % 4;

        // Q tile, zeros for rows past the last
        for (int e = threadIdx.x; e < WG_ROWS * CHK; e += 128) {
            const int i = e / CHK, ch = e % CHK, r = r0 + i;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (r < rows)
                v = __ldg(reinterpret_cast<const uint4*>(
                    q_rows + ((size_t)(r / G) * H + h * G + r % G) * DK
                    + ch * 8));
            *reinterpret_cast<uint4*>(tiles + TK::template at<WG_ROWS>(i, ch))
                = v;
        }
        fence_proxy_async();
        named_barrier(1, 128);

        // this thread's two query rows (gid and gid + 8 of its warp's 16)
        // and the keys each may see, [lo, hi]; a row past the last sees none
        bool act[2];
        int lo[2], hi[2];
        size_t off[2];                 // the rows' output offsets, elements
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = r0 + warp * 16 + gid + 8 * i;
            act[i] = r < rows;
            const int c = act[i] ? r / G : 0, g = act[i] ? r % G : 0;
            const int qp = start + c;
            hi[i] = !act[i] ? -1 : causal ? min(qp, k_hi - 1) : k_hi - 1;
            lo[i] = window > 0 ? qp - window + 1 : 0;
            off[i] = ((size_t)c * H + h * G + g) * DV;
        }
        // the block's first and last query positions: a key tile that
        // every row sees whole needs no mask
        const int q_first = start + c_lo, q_last = start + c_hi;

        constexpr int NB = DV / 64;    // 64-wide column blocks of O
        float o[NB][32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 32; ++j) o[nb][j] = 0.f;
        const float sl2 = scale * 1.4426950408889634f;   // log2 units

        for (int t = 0; t < ntiles; ++t) {
            const int s = t % NS;
            const int t0 = k_lo + t * KT;
            mbar_wait(&full[s], (t / NS) & 1);
            fence_proxy_async();
            // the base passes through an asm the compiler cannot hoist, so
            // that the DK / 16 descriptors of Q are not held across tiles
            uint32_t qa;
            asm volatile("mov.b32 %0, %1;\n" : "=r"(qa) : "r"(base));
            const uint32_t ka = qa + Q_BYTES + s * STAGE, va = ka + K_BYTES;

            // S = Q K^T; sc[4 nt + j] is row gid + 8 (j / 2), key 8 nt +
            // 2 tig + j % 2 of the tile
            float sc[32];
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk)
                wgmma_ss(sc, TK::template desc<WG_ROWS>(qa, kk * 16),
                         TK::template desc<KT>(ka, kk * 16), kk > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(sc);

            float mx[2] = {-INFINITY, -INFINITY};
            const bool whole = t0 + KT <= k_hi
                && (!causal || t0 + KT - 1 <= q_first)
                && (window <= 0 || t0 >= q_last - window + 1);
            if (whole) {
#pragma unroll
                for (int j = 0; j < 32; ++j)
                    mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
            } else {
                int a[2], b[2];        // [lo, hi] from this lane's first key
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    a[i] = lo[i] - (t0 + 2 * tig);
                    b[i] = hi[i] - (t0 + 2 * tig);
                }
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    const int i = (j / 2) % 2, c = (j / 4) * 8 + (j & 1);
                    sc[j] = c >= a[i] && c <= b[i] ? sc[j] : -INFINITY;
                    mx[i] = fmaxf(mx[i], sc[j]);
                }
            }
            // maxima of the raw scores, then p = 2^(s sl2 - max) in one FMA
            float corr[2], ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i] * sl2);
                ref[i] = m_new == -INFINITY ? 0.f : m_new;
                corr[i] = exp2_ftz(m[i] - ref[i]);
                m[i] = m_new;
            }
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                sc[j] = exp2_ftz(fmaf(sc[j], sl2, -ref[(j / 2) % 2]));
                rs[(j / 2) % 2] += sc[j];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int j = 0; j < 32; ++j) o[nb][j] *= corr[(j / 2) % 2];

            // O += P V, one 16-key step at a time: P's A fragments (keys
            // 16 kk + 2 tig (+ 8), rows gid and gid + 8: accumulator
            // entries 8 kk .. 8 kk + 7) in three bf16 parts; V's 16 rows
            // are two 8-row groups 1024 bytes apart, its 64-value column
            // block nb a KT x 128-byte block.  A step's wgmmas finish
            // before the next step's parts are written, so the registers
            // the tensor cores read are never reused under them.
#pragma unroll
            for (int kk = 0; kk < KT / 16; ++kk) {
                uint32_t p[4][3];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    split3_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1],
                                p[x]);
                wg_fence();
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                    const uint64_t vd = wg_desc(
                        va + nb * (KT * 128) + kk * 2048, 1024, 1024,
                        TV::MODE);
#pragma unroll
                    for (int part = 0; part < 3; ++part) {
                        const uint32_t a[4] = {p[0][part], p[1][part],
                                               p[2][part], p[3][part]};
                        wgmma_rs<1>(o[nb], a, vd);
                    }
                }
                wg_commit();
                wg_wait<0>();
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) wg_pin(o[nb]);
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    asm volatile("" :: "r"(p[x][0]), "r"(p[x][1]),
                                 "r"(p[x][2]) : "memory");
            }
            mbar_arrive(&empty[s]);    // this tile's K and V are read
        }

        // each row's denominator: the sum over the 4 lanes that hold it
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            if (!act[i]) continue;
            const float inv = 1.f / fmaxf(l[i], REPRO_L_FLOOR);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int j8 = 0; j8 < 8; ++j8) {
                    const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                        o[nb][4 * j8 + 2 * i] * inv,
                        o[nb][4 * j8 + 2 * i + 1] * inv);
                    *reinterpret_cast<__nv_bfloat162*>(
                        out_rows + off[i] + nb * 64 + j8 * 8 + tig * 2) = v2;
                }
            // m is in log2 units of the raw scores times sl2 and l sums
            // 2^(s sl2 - m), so ln(sum exp(s scale)) = (m + log2 l) ln 2
            if (LSE && tig == 0) {
                const int r = r0 + warp * 16 + gid + 8 * i;
                lse_rows[(size_t)(h * G + r % G) * C + r / G] =
                    l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f
                               : INFINITY;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// decode on the tensor cores, split over the keys (bf16)
// ---------------------------------------------------------------------------
// The same function as decode_block for bf16 inputs, for one split of a
// row's keys: a block takes the keys [k_lo, k_hi) (its split clipped to
// the row's visible range) for up to DS_HEADS query heads of one kv head,
// so K and V are read once for all of them.  Keys arrive in tiles of DS_KT
// in a ring of DsShape<D>::NS stages filled with 16-byte cp.async by all
// threads (K and V rows padded by 16 bytes, so ldmatrix reads them without
// bank conflicts); each of the DS_WARPS warps takes 16 keys of a tile:
//
//   S = Q K^T on mma.sync m16n8k16, the heads as the 16 rows (zeros past
//     G), Q and K loaded with ldmatrix from shared memory.  q enters
//     unscaled (it is exact in bf16) and scale * log2(e) is applied to the
//     f32 scores;
//   an online softmax in log2 units on the accumulator registers (row
//     maxima over the 4 lanes of a row, ex2); keys past k_hi score -inf and
//     a row whose maximum is still -inf takes 0 as its reference;
//   O += P V on mma.sync with P from registers (the S accumulator layout is
//     the A fragment layout) in three bf16 parts (split3_bf16: one part
//     errs by up to 2^-9 of a weight, two by 2^-18, which the half-step
//     rule at |O| ~ 3 does not allow; three keep ~24 bits), V's fragments
//     by ldmatrix.trans.
//
// Then the warps' (m, l, O) are merged through shared memory (the stage
// buffers, free by then), and the block writes either the normalised
// output (``part`` null: the row's keys are one split) or the split's
// partial (acc = O unnormalised, m in log2 units, l) to ``part``: for head
// g, part[g * part_stride + d] is acc[d] (d < D), then m, then l.  An empty
// range writes acc = 0, m = -inf, l = 0, or zeros as output.
// decode_combine merges the partials of a row's splits in split order, so
// a run replays bit for bit.

constexpr int DS_WARPS = 4;
constexpr int DS_THREADS = DS_WARPS * 32;
constexpr int DS_KT = DS_WARPS * 16;   // keys a tile: 16 a warp
constexpr int DS_HEADS = 16;           // query heads a block: the mma rows
constexpr int DS_MAX_SPLITS = 4096;    // the combine's weights: 32 KB

template <int D>
struct DsShape {
    static constexpr int LD = D + 8;   // padded row, elements
    // two stages, so a tile's copies overlap the previous tile's math: at
    // D = 256 a 64-key tile is 67 KB and the block takes 143 KB, one an SM
    static constexpr int NS = 2;
    static constexpr size_t Q_BYTES = sizeof(__nv_bfloat16) * DS_HEADS * LD;
    static constexpr size_t TILE = sizeof(__nv_bfloat16) * DS_KT * LD;
    static constexpr size_t SMEM = Q_BYTES + (size_t)NS * 2 * TILE;
    static_assert(sizeof(float) * DS_WARPS * DS_HEADS * D
                  <= (size_t)NS * 2 * TILE, "the merge reuses the stages");
};

// q_row: this block's G <= DS_HEADS query heads, (G, D) contiguous; k_src /
// v_src: the whole K and V arrays, indexed by addr; out_row: (G, D) of the
// output, used when part is null.  smem: DsShape<D>::SMEM bytes of dynamic
// shared memory, 16-byte aligned.  Call with DS_THREADS threads.
template <int D, typename Addr>
__device__ __forceinline__ void decode_split_block(
    const __nv_bfloat16* __restrict__ q_row,
    const __nv_bfloat16* __restrict__ k_src,
    const __nv_bfloat16* __restrict__ v_src,
    __nv_bfloat16* __restrict__ out_row, float* __restrict__ part,
    int part_stride, int G, int k_lo, int k_hi, float scale,
    const Addr& addr, unsigned char* smem) {
    using Sh = DsShape<D>;
    constexpr int LD = Sh::LD, NS = Sh::NS, CH = D / 8;
    __shared__ float m_s[DS_WARPS][DS_HEADS], l_s[DS_WARPS][DS_HEADS];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* stages =
        reinterpret_cast<__nv_bfloat16*>(smem + Sh::Q_BYTES);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int ntiles = k_hi > k_lo ? (k_hi - k_lo + DS_KT - 1) / DS_KT : 0;

    if (ntiles == 0) {                 // nothing visible in this split
        for (int e = threadIdx.x; e < G * (D + 2); e += DS_THREADS) {
            const int g = e / (D + 2), d = e % (D + 2);
            if (part == nullptr) {
                if (d < D) out_row[(size_t)g * D + d] = __float2bfloat16(0.f);
            } else {
                part[(size_t)g * part_stride + d] =
                    d == D ? -INFINITY : 0.f;
            }
        }
        return;
    }

    // the copies of key tile t into stage t % NS; keys past k_hi are zeros.
    // Through a block table, thread x copies 16-byte piece x % CH of keys
    // x / CH + j KP (j < NP), reading the block ids of NB of its keys
    // before it issues their copies.
    auto load = [&](int t) {
        __nv_bfloat16* ks = stages + (size_t)(t % NS) * 2 * DS_KT * LD;
        __nv_bfloat16* vs = ks + DS_KT * LD;
        const int t0 = k_lo + t * DS_KT;
        if constexpr (Addr::kPaged) {
            constexpr int KP = DS_THREADS / CH, NP = DS_KT / KP;
            constexpr int NB = NP < 8 ? NP : 8;
            const int i0 = threadIdx.x / CH, ch = threadIdx.x % CH;
#pragma unroll
            for (int j0 = 0; j0 < NP; j0 += NB) {
                int bid[NB];
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const int pos = t0 + i0 + (j0 + j) * KP;
                    bid[j] = pos < k_hi ? addr.block(pos) : -1;
                }
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const int i = i0 + (j0 + j) * KP;
                    const bool ok = bid[j] >= 0;
                    const size_t src = ok ? addr.at(bid[j], t0 + i) + ch * 8
                                          : 0;
                    cp_async16(ks + i * LD + ch * 8, k_src + src, ok);
                    cp_async16(vs + i * LD + ch * 8, v_src + src, ok);
                }
            }
        } else {
            for (int e = threadIdx.x; e < DS_KT * CH; e += DS_THREADS) {
                const int i = e / CH, ch = e % CH;
                const bool ok = t0 + i < k_hi;
                const size_t src = ok ? addr(t0 + i) + ch * 8 : 0;
                cp_async16(ks + i * LD + ch * 8, k_src + src, ok);
                cp_async16(vs + i * LD + ch * 8, v_src + src, ok);
            }
        }
    };

    const float sl2 = scale * 1.4426950408889634f;   // log2 units
    float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

#pragma unroll
    for (int p = 0; p < NS - 1; ++p) {
        if (p < ntiles) load(p);
        cp_async_commit();
    }
    // Q, zeros past the G heads, while the first keys are in flight
    if ((reinterpret_cast<size_t>(q_row) & 15) == 0) {
        for (int e = threadIdx.x; e < DS_HEADS * CH; e += DS_THREADS) {
            const int g = e / CH, ch = e % CH;
            *reinterpret_cast<uint4*>(q_s + g * LD + ch * 8) = g < G
                ? __ldg(reinterpret_cast<const uint4*>(q_row
                                                       + (size_t)g * D) + ch)
                : make_uint4(0, 0, 0, 0);
        }
    } else {
        for (int e = threadIdx.x; e < DS_HEADS * D; e += DS_THREADS) {
            const int g = e / D, d = e % D;
            q_s[g * LD + d] = g < G ? q_row[(size_t)g * D + d]
                                    : __float2bfloat16(0.f);
        }
    }
    for (int t = 0; t < ntiles; ++t) {
        if (t + NS - 1 < ntiles) load(t + NS - 1);
        cp_async_commit();
        cp_async_wait<NS - 1>();       // tile t has landed
        __syncthreads();               // for every thread (and Q too)
        const int k0 = k_lo + t * DS_KT + 16 * warp;   // this warp's keys
        if (k0 < k_hi) {               // warp-uniform
            const __nv_bfloat16* ks =
                stages + (size_t)(t % NS) * 2 * DS_KT * LD + 16 * warp * LD;
            const __nv_bfloat16* vs = ks + DS_KT * LD;
            // S: sc[j][c] is head gid + 8 (c / 2), key 8 j + 2 tig + c % 2
            float sc[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t a[4], b[4];
                ldsm_x4<false>(a, q_s + (lane & 15) * LD + kk * 16
                                      + (lane >> 4) * 8);
                // keys 0-7 then 8-15, dims +8 for lanes 8-15 and 24-31
                ldsm_x4<false>(b, ks + ((lane >> 4) * 8 + (lane & 7)) * LD
                                      + kk * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(sc[0], a, b[0], b[1]);
                mma_bf16(sc[1], a, b[2], b[3]);
            }
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const bool in = k0 + 8 * j + 2 * tig + (c & 1) < k_hi;
                    sc[j][c] = in ? sc[j][c] * sl2 : -INFINITY;
                    mx[c / 2] = fmaxf(mx[c / 2], sc[j][c]);
                }
            float corr[2], ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                ref[i] = m_new == -INFINITY ? 0.f : m_new;
                corr[i] = exp2_ftz(m[i] - ref[i]);
                m[i] = m_new;
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    sc[j][c] = exp2_ftz(sc[j][c] - ref[c / 2]);
                    rs[c / 2] += sc[j][c];
                }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
#pragma unroll
                for (int c = 0; c < 4; ++c) o[n][c] *= corr[c / 2];
            // P's A fragments (rows gid, gid + 8; keys 2 tig (+8)) in three
            // bf16 parts
            uint32_t p[4][3];
            split3_bf16(sc[0][0], sc[0][1], p[0]);
            split3_bf16(sc[0][2], sc[0][3], p[1]);
            split3_bf16(sc[1][0], sc[1][1], p[2]);
            split3_bf16(sc[1][2], sc[1][3], p[3]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                // V of dims 8 n .. 8 n + 15: keys lane % 8 (+8 for lanes
                // 8-15 and 24-31), dims +8 past lane 15, transposed
                uint32_t b[4];
                ldsm_x4<true>(b, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                     + (n + (lane >> 4)) * 8);
#pragma unroll
                for (int part3 = 0; part3 < 3; ++part3) {
                    const uint32_t a[4] = {p[0][part3], p[1][part3],
                                           p[2][part3], p[3][part3]};
                    mma_bf16(o[n], a, b[0], b[1]);
                    mma_bf16(o[n + 1], a, b[2], b[3]);
                }
            }
        }
        __syncthreads();               // stage t % NS free for tile t + NS
    }

    // each row's l over its 4 lanes; the warps' (m, l, O) into shared memory
    float* o_s = reinterpret_cast<float*>(stages);   // [warp][head][D]
    __shared__ float f_s[DS_WARPS][DS_HEADS], mx_s[DS_HEADS], den_s[DS_HEADS];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (tig == 0) {
            m_s[warp][gid + 8 * i] = m[i];
            l_s[warp][gid + 8 * i] = l[i];
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(
                o_s + (warp * DS_HEADS + gid + 8 * i) * D + 8 * n + 2 * tig)
                = make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
    __syncthreads();
    // each head's maximum over the warps, the warps' factors, its l
    if (threadIdx.x < DS_HEADS) {
        const int g = threadIdx.x;
        float mx = m_s[0][g];
#pragma unroll
        for (int w = 1; w < DS_WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < DS_WARPS; ++w) {
            f_s[w][g] = m_s[w][g] == -INFINITY ? 0.f
                                               : exp2_ftz(m_s[w][g] - mx);
            den += l_s[w][g] * f_s[w][g];
        }
        mx_s[g] = mx;
        den_s[g] = den;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G * D; e += DS_THREADS) {
        const int g = e / D, d = e % D;
        const float mx = mx_s[g], den = den_s[g];
        float num = 0.f;
#pragma unroll
        for (int w = 0; w < DS_WARPS; ++w)
            num += o_s[(w * DS_HEADS + g) * D + d] * f_s[w][g];
        if (part == nullptr) {
            out_row[(size_t)g * D + d] =
                __float2bfloat16(num / fmaxf(den, REPRO_L_FLOOR));
        } else {
            float* pg = part + (size_t)g * part_stride;
            pg[d] = num;
            if (d == 0) {
                pg[D] = mx;
                pg[D + 1] = den;
            }
        }
    }
}

// Merges the split partials of one (row, query head) per block of
// DS_THREADS threads: part (splits, D + 2) as decode_split_block (or the
// MLA decode kernel) writes them; out: that head's D outputs, in T.  The splits' maxima and weights are
// read in parallel into w_s (2 x splits floats of dynamic shared memory),
// the denominator summed by the first warp in a fixed tree, and each output
// sums its splits in split order, so a run replays bit for bit.  A split
// with m = -inf weighs 0 (its acc is zeros); a row with no visible key
// writes zeros.
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void decode_combine(
    const float* __restrict__ part, int splits, T* __restrict__ out,
    float* w_s) {
    __shared__ float red[DS_WARPS], den_s;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float mx = -INFINITY;
    for (int z = threadIdx.x; z < splits; z += DS_THREADS)
        mx = fmaxf(mx, part[(size_t)z * (D + 2) + D]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
#pragma unroll
    for (int w = 1; w < DS_WARPS; ++w) mx = fmaxf(mx, red[w]);
    for (int z = threadIdx.x; z < splits; z += DS_THREADS) {
        const float* pz = part + (size_t)z * (D + 2);
        const float c = pz[D] == -INFINITY ? 0.f : exp2_ftz(pz[D] - mx);
        w_s[z] = c;
        w_s[splits + z] = c * pz[D + 1];
    }
    __syncthreads();
    if (warp == 0) {
        float den = 0.f;
        for (int z = lane; z < splits; z += 32) den += w_s[splits + z];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            den += __shfl_xor_sync(0xffffffffu, den, off);
        if (lane == 0) den_s = den;
    }
    __syncthreads();
    const float inv = 1.f / fmaxf(den_s, REPRO_L_FLOOR);
    for (int d = threadIdx.x; d < D; d += DS_THREADS) {
        float num = 0.f;
#pragma unroll 8
        for (int z = 0; z < splits; ++z)
            num += part[(size_t)z * (D + 2) + d] * w_s[z];
        out[d] = from_f<T>(num * inv);
    }
}

// The second kernel of a split bf16 decode: one block of DS_THREADS a (row,
// query head), blockIdx.x = b * H + head, over part (B, H, splits, D + 2),
// and 2 x splits floats of dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(DS_THREADS) decode_combine_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
    int splits) {
    extern __shared__ float w_s[];
    decode_combine<D>(part + (size_t)blockIdx.x * splits * (D + 2), splits,
                      out + (size_t)blockIdx.x * D, w_s);
}

// ---------------------------------------------------------------------------
// RG-LRU gates, shared by rglru_scan.cu and rglru_scan_bwd.cu (whose
// recomputed h must be the forward's)
// ---------------------------------------------------------------------------
// a_t and beta_t of one step from x = log_at = c log_a a_gate (<= 0).
// f32 (the token identity runs) takes the library's expf, expm1f and
// sqrtf.  bf16, whose h rounds to 8 bits, takes them branch-free, so the
// compiler interleaves the steps: e = expm1(x) by its Taylor polynomial to
// x^7 above -0.35 (error below 2^-25 of e there) and exp(x) - 1 by ex2.approx
// below (|e| > 0.29, so no cancellation), a_t = 1 + e and beta =
// sqrt(-e (2 + e)) = sqrt(1 - a_t^2) by sqrt.approx.  x = -0 (padding)
// gives e = -0, a_t = 1 and beta = 0 in both.
template <typename T>
__device__ __forceinline__ void rg_gates(float x, float& a_t, float& beta) {
    if constexpr (sizeof(T) == 4) {
        a_t = expf(x);
        beta = sqrtf(-expm1f(2.f * x));
    } else {
        const float p = x * (1.f + x * (0.5f + x * (1.f / 6 + x * (1.f / 24
            + x * (1.f / 120 + x * (1.f / 720 + x * (1.f / 5040)))))));
        const float e = x > -0.35f ? p : __expf(x) - 1.f;
        a_t = 1.f + e;
        asm("sqrt.approx.f32 %0, %1;" : "=f"(beta) : "f"(-e * (2.f + e)));
    }
}
