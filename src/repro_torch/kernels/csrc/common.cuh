// Shared device code of the hand-written kernels.
//
// Three block bodies carry the four GQA attention kernels, each
// parameterised by how a key's address is found (an "address" functor: key
// position -> element offset of that key's values for the block's kv head):
//
//   decode_block   one query token per row, G query heads per kv head:
//                  paged_decode_attention.cu (block table) and
//                  decode_attention.cu (dense cache);
//   prefill_block  a tile of (token, head) query rows, causal with a query
//                  offset, f32 FMAs: ragged_prefill_attention.cu (block
//                  table) and flash_attention.cu in f32 (dense keys);
//   prefill_block_mma  the same on the tensor cores for bf16:
//                  flash_attention.cu in bf16 (the ragged prefill takes it
//                  with one template change, measured on its own).
//
// The prefill bodies take separate key and value widths (DK, DV) and
// address functors, for MLA's decompressed heads.  A kernel file resolves
// its block's row, bounds and address functors and calls one of them, so a
// faster body (tensor-core tiles, split-K) lifts each of its kernels at
// once.  The mma.sync and cp.async helpers below also serve
// grouped_matmul.cu and paged_mla_decode_attention.cu.
#pragma once

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
// ``table[pos / bs]`` at offset ``pos % bs``.
template <int D>
struct PagedAddr {
    const int* table;   // this row's block table
    int bs, KV, h;
    __device__ __forceinline__ size_t operator()(int pos) const {
        const int bid = __ldg(table + pos / bs);
        return (((size_t)bid * bs + pos % bs) * KV + h) * D;
    }
};

// Dense cache (B, S, KV, D): key ``pos`` of row ``b`` at ((b*S + pos)*KV + h)*D.
template <int D>
struct DenseAddr {
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
// Call with PRE_THREADS threads.
template <typename T, int DK, int DV, typename KAddr, typename VAddr>
__device__ __forceinline__ void prefill_block(
    const T* __restrict__ q_rows, const T* __restrict__ k_src,
    const T* __restrict__ v_src, T* __restrict__ out_rows, int C, int H,
    int G, int h, int r0, int start, int k_max, bool causal, int window,
    float scale, const KAddr& kaddr, const VAddr& vaddr, float* smem) {
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
    }
}

// ---------------------------------------------------------------------------
// prefill on the tensor cores (bf16)
// ---------------------------------------------------------------------------
// The same function as prefill_block for bf16 inputs, with both products on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style.  A
// block of MMA_THREADS threads takes MMA_ROWS flattened (token, head) query
// rows: each warp owns 16 rows, its Q fragments in registers for the whole
// key loop.  Key tiles of MMA_KT keys are staged in shared memory as bf16
// with 16-byte loads (rows padded by 8 elements, so fragment reads hit 32
// distinct banks).  Per tile a warp computes S = Q K^T (16 x MMA_KT) in
// f32, masks it (causal, window, the tile's end), folds it into the online
// softmax (row maxima over the 4 lanes of a row by shuffles, exp2 in f32),
// and accumulates O += P V.  P is fed to the tensor cores as two bf16
// halves, hi = bf16(P) and lo = bf16(P - hi): one bf16 P would add an
// error of up to 2^-9 of each weight, far more than the f32 plain version
// allows; hi + lo keeps about 16 bits, so O stays within f32-level error
// of the plain version.  Masked scores are -inf and a row whose maximum is
// still -inf takes 0 as its reference, so a row with no visible key yet
// accumulates nothing and a row with none at all writes zeros.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_ROWS = MMA_WARPS * 16;   // query rows per block
constexpr int MMA_KT = 64;                 // keys per staged tile

template <int DK, int DV>
__host__ __device__ constexpr size_t mma_smem_bytes() {
    return MMA_KT * ((DK + 8) + (DV + 8)) * sizeof(__nv_bfloat16);
}

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

// Arguments as prefill_block's; smem: mma_smem_bytes<DK, DV>() bytes,
// 16-byte aligned; k_src / v_src 16-byte aligned.  Call with MMA_THREADS
// threads, r0 a multiple of MMA_ROWS.
template <int DK, int DV, typename KAddr, typename VAddr>
__device__ __forceinline__ void prefill_block_mma(
    const __nv_bfloat16* __restrict__ q_rows,
    const __nv_bfloat16* __restrict__ k_src,
    const __nv_bfloat16* __restrict__ v_src,
    __nv_bfloat16* __restrict__ out_rows, int C, int H, int G, int h, int r0,
    int start, int k_max, bool causal, int window, float scale,
    const KAddr& kaddr, const VAddr& vaddr, __nv_bfloat16* smem) {
    constexpr int KT = MMA_KT;
    constexpr int LDK = DK + 8, LDV = DV + 8;  // staged row strides, elements
    constexpr int NT = KT / 8;               // 8-key column tiles of S
    constexpr int KS = DK / 16;              // 16-deep steps of Q K^T
    constexpr int DN = DV / 8;               // 8-wide column tiles of O
    constexpr int CHK = DK / 8, CHV = DV / 8;  // 16-byte chunks per row
    __nv_bfloat16* k_s = smem;
    __nv_bfloat16* v_s = smem + KT * LDK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int rows = C * G;

    // this lane's two query rows: gid and gid + 8 of its warp's 16
    bool act[2];
    int qp[2];
    size_t off[2];                     // the rows' query offsets, elements
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + warp * 16 + gid + 8 * i;
        act[i] = r < rows;
        const int c = act[i] ? r / G : 0, g = act[i] ? r % G : 0;
        qp[i] = start + c;
        off[i] = ((size_t)c * H + h * G + g) * DK;
    }
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        const int d = kk * 16 + tig * 2;
        qa[kk][0] = act[0] ? ld32(q_rows + off[0] + d) : 0u;
        qa[kk][1] = act[1] ? ld32(q_rows + off[1] + d) : 0u;
        qa[kk][2] = act[0] ? ld32(q_rows + off[0] + d + 8) : 0u;
        qa[kk][3] = act[1] ? ld32(q_rows + off[1] + d + 8) : 0u;
    }
    float o[DN][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;

    const int c_lo = r0 / G;
    const int c_hi = min(rows - 1, r0 + MMA_ROWS - 1) / G;
    const int k_hi = causal ? min(k_max, start + c_hi + 1) : k_max;
    const int k_lo = window > 0 ? max(0, start + c_lo - window + 1) : 0;
    const float sl2 = scale * 1.4426950408889634f;     // scores in log2 units

    for (int t0 = k_lo; t0 < k_hi; t0 += KT) {
        const int n = min(KT, k_hi - t0);
        __syncthreads();               // previous tile fully consumed
        if constexpr (DK == DV) {
            for (int e = threadIdx.x; e < KT * CHK; e += MMA_THREADS) {
                const int i = e / CHK, ch = e % CHK;
                uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
                if (i < n) {
                    const size_t src = kaddr(t0 + i) + ch * 8;
                    kv = __ldg(reinterpret_cast<const uint4*>(k_src + src));
                    vv = __ldg(reinterpret_cast<const uint4*>(v_src + src));
                }
                *reinterpret_cast<uint4*>(k_s + i * LDK + ch * 8) = kv;
                *reinterpret_cast<uint4*>(v_s + i * LDV + ch * 8) = vv;
            }
        } else {
            for (int e = threadIdx.x; e < KT * CHK; e += MMA_THREADS) {
                const int i = e / CHK, ch = e % CHK;
                uint4 kv = make_uint4(0, 0, 0, 0);
                if (i < n)
                    kv = __ldg(reinterpret_cast<const uint4*>(
                        k_src + kaddr(t0 + i) + ch * 8));
                *reinterpret_cast<uint4*>(k_s + i * LDK + ch * 8) = kv;
            }
            for (int e = threadIdx.x; e < KT * CHV; e += MMA_THREADS) {
                const int i = e / CHV, ch = e % CHV;
                uint4 vv = make_uint4(0, 0, 0, 0);
                if (i < n)
                    vv = __ldg(reinterpret_cast<const uint4*>(
                        v_src + vaddr(t0 + i) + ch * 8));
                *reinterpret_cast<uint4*>(v_s + i * LDV + ch * 8) = vv;
            }
        }
        __syncthreads();

        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const __nv_bfloat16* kr = k_s + (nt * 8 + gid) * LDK
                                        + kk * 16 + tig * 2;
                mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
            }
        // mask and scale; s[nt][j] is row (j / 2), key nt*8 + tig*2 + j%2
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = j / 2;
                const int kp = t0 + nt * 8 + tig * 2 + (j & 1);
                const bool ok = act[i] && kp < k_hi
                    && !(causal && kp > qp[i])
                    && !(window > 0 && qp[i] - kp >= window);
                s[nt][j] = ok ? s[nt][j] * sl2 : -INFINITY;
                mx[i] = fmaxf(mx[i], s[nt][j]);
            }
        float corr[2], ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m[i], mx[i]);
            ref[i] = m_new == -INFINITY ? 0.f : m_new;
            corr[i] = exp2f(m[i] - ref[i]);
            m[i] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[nt][j] = exp2f(s[nt][j] - ref[j / 2]);
                rs[j / 2] += s[nt][j];
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
            o[dn][0] *= corr[0];
            o[dn][1] *= corr[0];
            o[dn][2] *= corr[1];
            o[dn][3] *= corr[1];
        }
        // O += P V over 16-key steps; P's accumulator layout is the A
        // fragment layout of two adjacent 8-key column tiles
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
            uint32_t ph[4], pl[4];
            split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
            split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
            for (int dn = 0; dn < DN; ++dn) {
                const __nv_bfloat16* vr = v_s + (kk * 16 + tig * 2) * LDV
                                        + dn * 8 + gid;
                const uint32_t b0 = pack_bf16(vr[0], vr[LDV]);
                const uint32_t b1 = pack_bf16(vr[8 * LDV], vr[9 * LDV]);
                mma_bf16(o[dn], ph, b0, b1);
                mma_bf16(o[dn], pl, b0, b1);
            }
        }
    }

    // each row's denominator: the sum over the 4 lanes that hold it
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (!act[i]) continue;
        const float inv = 1.f / fmaxf(l[i], REPRO_L_FLOOR);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
            *reinterpret_cast<__nv_bfloat162*>(
                out_rows + off[i] / DK * DV + dn * 8 + tig * 2) = v2;
        }
    }
}
