// Backward of the Mamba-2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a).
//
// The TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, :70) has no
// backward: the reference differentiates its oracle ref.ssd_scan
// (src/repro/kernels/ref.py:282) with jax.grad.  Here the forward runs as
// a kernel behind a torch.autograd.Function (ssd_scan.SSDScanFn), and this
// file is its backward, the counterpart of jax.vjp through the oracle.
// With cs the running sum of dt A inside a chunk, L_qk = exp(cs_q - cs_k)
// for k <= q, G = C B^T (shared by the heads), M = L o G, S_c the state
// carried into chunk c and g_c the adjoint of the state at its end (dfin
// after the last chunk; g_{c-1} = exp(cs_last) g_c + R_c with R_c =
// sum_q exp(cs_q) dy_q^T C_q):
//
//   d(x dt)_k = sum_{q >= k} M_qk dy_q + exp(cs_last - cs_k) g_c B_k
//   dx = dt d(x dt),  ddt = <x, d(x dt)> + d(dt A) A
//   dG_qk = sum_h L_qk dy_q . (x dt)_k
//   dC_q = sum_k dG_qk B_k + sum_h exp(cs_q) dy_q S_c
//   dB_k = sum_q dG_qk C_q + sum_h exp(cs_last - cs_k) (x dt)_k g_c
//   d cs: from L (row and column sums of dG o G o L per head), from the
//   read-out exp(cs_q) and the update's exp(cs_last - cs_k), and from the
//   chunk decay exp(cs_last) (<g_c, S_c> exp(cs_last)); its reverse running
//   sum in the chunk is d(dt A), and dA = sum d(dt A) dt.
//
// What bounds it on the H100.  Its visible work
// (perf_model.ssd_scan_bwd_cost) at mamba2-370m's train shape (4 x 4096,
// H = 32, (P, N) = (64, 128), chunks of 256) is 61.3 GFLOP over 222 MB,
// 276 flops a byte: just under the ~295 at which the bf16 tensor cores
// would bind, so its bound is bytes; but far above the ~20 a byte of the
// CUDA cores' f32 FMAs, so the FMA bodies are bound by their arithmetic
// (and by the shared-memory reads that feed it), and in bf16 every
// product runs on the tensor cores.
//
// Design.  Bm and Cm are shared by the H heads, so per-head partials of dB
// and dC in f32 would move more bytes than x, dy and dx together; every
// head-summed quantity is summed inside one block that walks the heads in
// order (no atomics: the backward replays bit for bit).  Every f32 operand
// of a tensor-core product goes in three bf16 parts (split3_bf16: about
// 24 bits; two break the bf16 half-step rule, csrc/ssd_scan.cu), every
// sum stays in f32, and no decay is formed as exp(cs_q) exp(-cs_k).  Two
// bodies, fixed by the types (ssd_scan.ssd_bwd_body):
//
// Tensor-core body (bf16 at (P, N) = (64, 128), any chunk), five kernels:
//
//   ssd_bwd_states    grid (h, b), two warpgroups, each one half of N,
//                     walking the chunks forward and then backward (the
//                     forward kernel's scheme, csrc/ssd_scan.cu): per
//                     chunk the running sum cs (kept in the workspace for
//                     the others), then wgmma products over its 64-key
//                     tiles of (x o w)^T B, w_k = dt_k exp(cs_last - cs_k),
//                     forward, and of R_c = (dy o e^{cs})^T C backward, the
//                     f32 left side as register A fragments in three parts
//                     (ldmatrix.trans of the staged rows times the weights),
//                     B or C MN-major and exact, each 64-key tile's product
//                     fresh and added to the carried state in f32.  The
//                     state S (forward) and the adjoint g (backward) stay
//                     in registers; each S_c (carried into chunk c) and g_c
//                     (at its end) is written once, already in its three
//                     bf16 parts, the operands the other passes read; d
//                     cs_last = exp(cs_last) <g_c, S_c> is summed in-block
//                     in a fixed order (S_c read back from its parts); d
//                     init_state is g after the first chunk.  The next
//                     chunk's rows land by cp.async in a second stage (96
//                     KB each) while the current chunk's products run;
//   ssd_bwd_keys_mma  grid (key tile, chunk, b) of 32 keys, ordered so that
//                     the heaviest tiles (key tile j does the 8 - j query
//                     tiles past it) start first within windows of 16
//                     (chunk, b) pairs, walking the heads: G's columns
//                     once, then per head on mma.sync u = B g^T and dB's
//                     state term x g (g_c's parts, copied as they lie), the
//                     decayed scores' dM = dy x^T and M^T dy (M in three
//                     parts); dB and dG's columns summed over the heads in
//                     registers and shared memory, then dB and dG out.  The
//                     next head's g_c parts, x rows, cs and dt land by
//                     cp.async in a second stage, and the next dy tile in
//                     registers, while the current one is computed;
//   ssd_bwd_queries_wg grid (64-query tile, chunk, b), two warpgroups, each
//                     one half of N: dC = dG B by wgmma (dG's rows as
//                     register A fragments in three parts, B MN-major), then
//                     per head dy_q S_c by wgmma from two shared operands
//                     (dy K-major, S_c's three parts MN-major), the
//                     read-out's d cs from it, exp(cs_q) dy_q S_c added to
//                     dC; the next head's dy rows and S_c parts land in a
//                     second stage (56 KB each) while the current ones are
//                     computed;
//   ssd_bwd_dt, ssd_bwd_da as below.
//
// FMA body (f32, the identity runs, which must stay f32: no TF32; and the
// reduced (32, 16)), six kernels, all 256 threads, every product an FMA
// loop over shared tiles (sb_mm: a thread owns rows ty + 16 r and columns
// tx + 16 c, tiles padded to odd rows so that neither access conflicts),
// 32-row tiles of keys and queries (a chunk of 256 has an L of 256 KB in
// f32; it is never held whole):
//
//   ssd_bwd_chunk    grid (h, chunk, b): the running sum cs, the chunk's
//                    own state sum_k x_k dt_k exp(cs_last - cs_k) B_k^T
//                    and R_c;
//   ssd_bwd_pass     grid (h, b, a split of the P N entries: 1024 a
//                    block): the recurrence over chunks forward (each
//                    chunk's state carried in) and backward (each chunk's
//                    g_c), the splits' parts of the chunk decays' d
//                    cs_last, and the initial state's gradient;
//   ssd_bwd_keys     grid (key tile, chunk, b), walking the heads: G's
//                    columns once, then per head d(x dt) of its 32 keys
//                    (dx, the direct part of ddt), their d cs, the row sums
//                    of the key tile's part of d cs; dG's columns and the
//                    dB state term summed over the heads in shared memory
//                    and registers; then dB (one write) and dG (for the
//                    query pass);
//   ssd_bwd_queries  grid (query tile, chunk, b): dC = dG B over the key
//                    tiles up to the diagonal, then per head exp(cs_q)
//                    dy_q S_c and the read-out's d cs;
//   ssd_bwd_dt       grid (h, b): d cs assembled in a fixed order, its
//                    reverse running sum, ddt, and dA's per-row part;
//   ssd_bwd_da       dA: the rows' parts summed in order.
//
// Sums in f32; dx, dBm and dCm rounded once to the working type, ddt and
// dA f32, d init_state in init's type.  Q from 1 to 256 dividing S;
// (P, N) = (64, 128) or (32, 16).

#include "common.cuh"

namespace {

constexpr int SB_THREADS = 256;
constexpr int SB_T = 32;            // keys and queries a tile
constexpr int SB_TL = SB_T + 1;     // padded row of a 32-wide tile
constexpr int SB_K1 = 64;           // positions a tile of ssd_bwd_chunk
constexpr int SB_QMAX = 256;        // longest chunk
constexpr int SB_PASS_SPLITS = 8;   // most blocks an (h, b) of ssd_bwd_pass

struct SbArgs {
    const void* x;          // (B, S, H, P)  all contiguous
    const float* dt;        // (B, S, H)
    const float* A;         // (H,)
    const void* Bm;         // (B, S, N)
    const void* Cm;         // (B, S, N)
    const void* init;       // (B, H, P, N) or null
    const void* dy;         // (B, S, H, P)
    const void* dfin;       // (B, H, P, N) or null
    void* dx;               // (B, S, H, P)
    float* ddt;             // (B, S, H)
    float* dA;              // (H,)
    void* dB;               // (B, S, N)
    void* dC;               // (B, S, N)
    void* dinit;            // (B, H, P, N) or null
    // the workspace's parts
    float* cs;              // (B, H, S) running sums of dt A in a chunk
    float* ct;              // (B, H, S) d cs of the key pass
    float* rd;              // (B, H, S) d cs of the read-out
    float* st;              // (B, H, nc, P, N) own states, then carried in;
                            // tensor-core body: (B, H, nc, 3, P, N) bf16,
                            // the carried states' parts
    float* rt;              // (B, H, nc, P, N) R_c, then g_c; tensor-core
                            // body: g_c's parts, as st's
    float* dg;              // (B, nc, Q, Q) dG, head-summed
    float* rows;            // (B, H, nc, nt, Q) key tiles' row sums
    float* lastp;           // (B, H, nc, nt) key tiles' d cs_last
    float* dcl;             // (B, H, nc, splits) the chunk decays' d cs_last
    float* dap;             // (B, H) dA's per-row parts
    int B, S, H, Q, nc, nt, init_f32, dfin_f32, splits;
};

// acc[r][c] += sum_{k < K} A(ty + 16 r, k) B(k, tx + 16 c), with A(m, k)
// at A[m sam + k sak] and B(k, n) at B[k sbk + n sbn] in shared memory.
template <int TM, int TN>
__device__ __forceinline__ void sb_mm(float (&acc)[TM][TN], const float* A,
                                      int sam, int sak, const float* B,
                                      int sbk, int sbn, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = A[(ty + 16 * r) * sam + k * sak];
#pragma unroll
        for (int c = 0; c < TN; ++c) b[c] = B[k * sbk + (tx + 16 * c) * sbn];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
}

template <int TM, int TN>
__device__ __forceinline__ void sb_zero(float (&acc)[TM][TN]) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
}

// the sum over the 16 threads of a row (tx = 0..15 of one ty), in every one
__device__ __forceinline__ float sb_row_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// the block's sum of v, in thread 0 (fixed order)
__device__ __forceinline__ float sb_block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();                      // red free
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
    if (threadIdx.x == 0)
        for (int w = 0; w < SB_THREADS / 32; ++w) s += red[w];
    return s;
}

template <typename T>
__device__ __forceinline__ float sb_state(const void* p, int is_f32,
                                          size_t i) {
    return is_f32 ? ((const float*)p)[i] : to_f(((const T*)p)[i]);
}

// Rows [r0, r0 + SB_T) of a (B, S, [heads,] D) tensor at head hh (per-row
// stride ``rs`` elements, ``hs`` between heads) into a SB_T x (D + 1) f32
// tile, scaled by scale[row] when given; zeros at and past n rows.
template <typename T, int D>
__device__ __forceinline__ void sb_rows(float* dst, const T* src, size_t row0,
                                        size_t rs, int n,
                                        const float* scale = nullptr) {
    for (int e = threadIdx.x; e < SB_T * D; e += SB_THREADS) {
        const int i = e / D, d = e % D;
        float v = 0.f;
        if (i < n) {
            v = to_f(src[(row0 + i) * rs + d]);
            if (scale != nullptr) v *= scale[i];
        }
        dst[i * (D + 1) + d] = v;
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk: cs, the chunk's own state and R_c
// ---------------------------------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(SB_THREADS) ssd_bwd_chunk(SbArgs a) {
    constexpr int TP = P / 16, TN = N / 16, LP = P + 1, LN = N + 1;
    const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int Q = a.Q, H = a.H, S = a.S, t0 = c * Q, tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    extern __shared__ float sm[];
    float* cs = sm;                       // [SB_QMAX]
    float* wq = cs + SB_QMAX;             // [SB_QMAX] row weights
    float* Xs = wq + SB_QMAX;             // [SB_K1][LP]
    float* Ns = Xs + SB_K1 * LP;          // [SB_K1][LN]
    __shared__ float wsum[SB_THREADS / 32];
    const size_t row = (size_t)b * H + h;
    const T* x = (const T*)a.x;
    const T* dy = (const T*)a.dy;

    // 1. the inclusive running sum of dt A, a position a thread
    float d = 0.f, v = 0.f;
    if (tid < Q) {
        d = a.dt[((size_t)b * S + t0 + tid) * H + h];
        v = d * a.A[h];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < Q) {
        cs[tid] = v;
        a.cs[row * S + t0 + tid] = v;
    }
    __syncthreads();
    const float last = cs[Q - 1];

    // 2. the chunk's own state sum_k (x_k w_k)^T B_k, w_k = dt_k
    //    exp(cs_last - cs_k), then 3. R_c = sum_q (dy_q e^{cs_q})^T C_q
    float* out[2] = {a.st, a.rt};
    for (int part = 0; part < 2; ++part) {
        __syncthreads();                  // wq, Xs and Ns free
        if (tid < Q)
            wq[tid] = part == 0 ? d * expf(last - cs[tid]) : expf(cs[tid]);
        float acc[TP][TN];
        sb_zero(acc);
        for (int k0 = 0; k0 < Q; k0 += SB_K1) {
            const int n = min(SB_K1, Q - k0);
            __syncthreads();
            for (int e = tid; e < SB_K1 * P; e += SB_THREADS) {
                const int i = e / P, p = e % P;
                const T* src = part == 0 ? x : dy;
                Xs[i * LP + p] = i < n
                    ? to_f(src[(((size_t)b * S + t0 + k0 + i) * H + h) * P + p])
                        * wq[k0 + i]
                    : 0.f;
            }
            const T* src = (const T*)(part == 0 ? a.Bm : a.Cm);
            for (int e = tid; e < SB_K1 * N; e += SB_THREADS) {
                const int i = e / N, nn = e % N;
                Ns[i * LN + nn] = i < n
                    ? to_f(src[((size_t)b * S + t0 + k0 + i) * N + nn]) : 0.f;
            }
            __syncthreads();
            // A(p, k) = Xs[k][p], B(k, n) = Ns[k][n]
            sb_mm(acc, Xs, 1, LP, Ns, LN, 1, n);
        }
        const int ty = tid / 16, tx = tid % 16;
        float* o = out[part] + (row * a.nc + c) * P * N;
#pragma unroll
        for (int r = 0; r < TP; ++r)
#pragma unroll
            for (int cc = 0; cc < TN; ++cc)
                o[(ty + 16 * r) * N + tx + 16 * cc] = acc[r][cc];
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_pass: the recurrences over chunks, forward then backward
// ---------------------------------------------------------------------------
// state entries a thread of ssd_bwd_pass, and the blocks (h, b) splits
// the P N entries over: 4 a thread, 8 blocks at (64, 128)
template <int P, int N>
struct SbPass {
    static constexpr int E = P * N >= 4 * SB_THREADS ? 4 : P * N / SB_THREADS;
    static constexpr int SPLITS = P * N / (E * SB_THREADS);
    static_assert(E * SB_THREADS * SPLITS == P * N, "P N a multiple of 256");
    static_assert(SPLITS <= SB_PASS_SPLITS, "the workspace's d cs_last");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(SB_THREADS) ssd_bwd_pass(SbArgs a) {
    constexpr int E = SbPass<P, N>::E, SPLITS = SbPass<P, N>::SPLITS;
    const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
    const int tid = threadIdx.x, e0 = split * E * SB_THREADS + tid;
    const size_t row = (size_t)b * a.H + h;
    const int nc = a.nc, Q = a.Q;
    __shared__ float red[SB_THREADS / 32];
    float s[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
        s[e] = a.init != nullptr
            ? sb_state<T>(a.init, a.init_f32, row * P * N + e0 + SB_THREADS * e)
            : 0.f;
    // forward: slot c of st takes the state carried into chunk c
    for (int c = 0; c < nc; ++c) {
        float* stc = a.st + (row * nc + c) * P * N;
        const float dec = expf(a.cs[row * a.S + (size_t)c * Q + Q - 1]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int i = e0 + SB_THREADS * e;
            const float own = stc[i];
            stc[i] = s[e];
            s[e] = fmaf(dec, s[e], own);
        }
    }
    // backward: slot c of rt takes g_c, the adjoint of chunk c's end state
#pragma unroll
    for (int e = 0; e < E; ++e)
        s[e] = a.dfin != nullptr
            ? sb_state<T>(a.dfin, a.dfin_f32, row * P * N + e0 + SB_THREADS * e)
            : 0.f;
    for (int c = nc - 1; c >= 0; --c) {
        float* rtc = a.rt + (row * nc + c) * P * N;
        const float* stc = a.st + (row * nc + c) * P * N;
        const float dec = expf(a.cs[row * a.S + (size_t)c * Q + Q - 1]);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int i = e0 + SB_THREADS * e;
            const float r = rtc[i];
            rtc[i] = s[e];
            dot = fmaf(s[e], stc[i], dot);
            s[e] = fmaf(dec, s[e], r);
        }
        // this block's part of d cs_last; ssd_bwd_dt adds the splits'
        const float tot = sb_block_sum(dot, red);
        if (tid == 0) a.dcl[(row * nc + c) * SPLITS + split] = dec * tot;
    }
    if (a.dinit != nullptr) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const size_t i = row * P * N + e0 + SB_THREADS * e;
            if (a.init_f32) ((float*)a.dinit)[i] = s[e];
            else ((T*)a.dinit)[i] = from_f<T>(s[e]);
        }
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_keys: a key tile of a chunk, walking the heads
// ---------------------------------------------------------------------------
template <int P, int N>
struct SbKeys {     // float offsets into dynamic shared memory
    static constexpr int LP = P + 1, LN = N + 1;
    static constexpr int BJ = 0;                        // [SB_T][LN] keys' B
    static constexpr int CT = BJ + SB_T * LN;           // [SB_T][LN] a C tile
    static constexpr int GC = CT + SB_T * LN;           // [QMAX][TL] G cols
    static constexpr int DG = GC + SB_QMAX * SB_TL;     // [QMAX][TL] dG cols
    static constexpr int GE = DG + SB_QMAX * SB_TL;     // [P][LN] g_c
    static constexpr int XJ = GE + P * LN;              // [SB_T][LP] x
    static constexpr int XD = XJ + SB_T * LP;           // [SB_T][LP] x dt
    static constexpr int DY = XD + SB_T * LP;           // [SB_T][LP] dy
    static constexpr int MT = DY + SB_T * LP;           // [SB_T][TL] M tile
    static constexpr int CS = MT + SB_T * SB_TL;        // [QMAX] cs
    static constexpr int DT = CS + SB_QMAX;             // [QMAX] dt
    static constexpr int RED = DT + SB_QMAX;            // [16][SB_T]
    static constexpr int SD = RED + 16 * SB_T;          // [SB_T]
    static constexpr size_t BYTES = sizeof(float) * (SD + SB_T);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(SB_THREADS, 1) ssd_bwd_keys(SbArgs a) {
    using L = SbKeys<P, N>;
    constexpr int LP = L::LP, LN = L::LN, TP = P / 16, TN = N / 16;
    const int j = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int Q = a.Q, H = a.H, S = a.S, t0 = c * Q, k0 = j * SB_T;
    const int nk = min(SB_T, Q - k0);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    extern __shared__ float sm[];
    float* Bj = sm + L::BJ;
    float* Ct = sm + L::CT;
    float* Gc = sm + L::GC;
    float* Dg = sm + L::DG;
    float* Ge = sm + L::GE;
    float* Xj = sm + L::XJ;
    float* Xd = sm + L::XD;
    float* Dy = sm + L::DY;
    float* Mt = sm + L::MT;
    float* cs = sm + L::CS;
    float* dts = sm + L::DT;
    float* red = sm + L::RED;
    float* sds = sm + L::SD;
    const T* x = (const T*)a.x;
    const T* dy = (const T*)a.dy;
    const size_t pos0 = (size_t)b * S + t0;       // the chunk's first row

    // the keys' B rows; G's columns G[q][k] = C_q . B_k for q >= k0, and
    // dG's zeroed
    sb_rows<T, N>(Bj, (const T*)a.Bm, pos0 + k0, N, nk);
    for (int q0 = k0; q0 < Q; q0 += SB_T) {
        __syncthreads();                  // Bj landed, Ct free
        sb_rows<T, N>(Ct, (const T*)a.Cm, pos0 + q0, N, min(SB_T, Q - q0));
        __syncthreads();
        float g[2][2];
        sb_zero(g);
        // A(q, n) = Ct[q][n], B(n, k) = Bj[k][n]
        sb_mm(g, Ct, LN, 1, Bj, 1, LN, N);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
                const int q = q0 + ty + 16 * r, kk = tx + 16 * cc;
                Gc[q * SB_TL + kk] = g[r][cc];
                Dg[q * SB_TL + kk] = 0.f;
            }
    }

    float dbs[2][TN];                     // dB's state term, over heads
    sb_zero(dbs);
    for (int h = 0; h < H; ++h) {
        const size_t row = (size_t)b * H + h;
        __syncthreads();                  // the last head's tiles consumed
        for (int q = tid; q < Q; q += SB_THREADS) {
            cs[q] = a.cs[row * S + t0 + q];
            dts[q] = a.dt[(pos0 + q) * H + h];
        }
        const float* ge = a.rt + (row * a.nc + c) * P * N;
        for (int e = tid; e < P * N; e += SB_THREADS)
            Ge[e / N * LN + e % N] = ge[e];
        sb_rows<T, P>(Xj, x + h * P, pos0 + k0, (size_t)H * P, nk);
        __syncthreads();
        for (int e = tid; e < SB_T * P; e += SB_THREADS) {
            const int kk = e / P, p = e % P;
            Xd[kk * LP + p] = kk < nk ? Xj[kk * LP + p] * dts[k0 + kk] : 0.f;
        }
        __syncthreads();
        const float last = cs[Q - 1];
        float dec[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int kk = ty + 16 * r;
            dec[r] = kk < nk ? expf(last - cs[k0 + kk]) : 0.f;
        }
        // d(x dt) starts at the state's part exp(cs_last - cs_k) g B_k;
        // u_k = g B_k: A(k, n) = Bj[k][n], B(n, p) = Ge[p][n]
        float dxd[2][TP];
        sb_zero(dxd);
        sb_mm(dxd, Bj, LN, 1, Ge, 1, LN, N);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float part = 0.f;
            const int kk = ty + 16 * r;
#pragma unroll
            for (int cc = 0; cc < TP; ++cc) {
                part = fmaf(Xd[kk * LP + tx + 16 * cc], dxd[r][cc], part);
                dxd[r][cc] *= dec[r];
            }
            // d cs of the update's decay: exp(cs_last - cs_k) <(x dt)_k, u_k>
            part = sb_row_sum(part);
            if (tx == 0) sds[kk] = kk < nk ? dec[r] * part : 0.f;
        }
        // dB's state term: exp(cs_last - cs_k) (x dt)_k g,
        // A(k, p) = Xd[k][p], B(p, n) = Ge[p][n]
        {
            float tmp[2][TN];
            sb_zero(tmp);
            sb_mm(tmp, Xd, LP, 1, Ge, LN, 1, P);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int cc = 0; cc < TN; ++cc)
                    dbs[r][cc] = fmaf(dec[r], tmp[r][cc], dbs[r][cc]);
        }
        float colT[2] = {0.f, 0.f};       // sum_q dM o M at keys tx + 16 cc
        for (int q0 = k0; q0 < Q; q0 += SB_T) {
            __syncthreads();              // Dy and Mt free
            sb_rows<T, P>(Dy, dy + h * P, pos0 + q0, (size_t)H * P,
                          min(SB_T, Q - q0));
            __syncthreads();
            // dM = dy_q . (x dt)_k: A(q, p) = Dy[q][p], B(p, k) = Xd[k][p]
            float dm[2][2];
            sb_zero(dm);
            sb_mm(dm, Dy, LP, 1, Xd, 1, LP, P);
            float rowT[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int ql = ty + 16 * r, q = q0 + ql;
#pragma unroll
                for (int cc = 0; cc < 2; ++cc) {
                    const int kk = tx + 16 * cc, k = k0 + kk;
                    const bool vis = q < Q && kk < nk && k <= q;
                    const float l = vis ? expf(cs[q] - cs[k]) : 0.f;
                    const float m = l * Gc[q * SB_TL + kk];
                    Mt[ql * SB_TL + kk] = m;
                    Dg[q * SB_TL + kk] = fmaf(dm[r][cc], l,
                                              Dg[q * SB_TL + kk]);
                    const float t = dm[r][cc] * m;
                    rowT[r] += t;
                    colT[cc] += t;
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float v = sb_row_sum(rowT[r]);
                const int q = q0 + ty + 16 * r;
                if (tx == 0 && q < Q)
                    a.rows[((row * a.nc + c) * a.nt + j) * Q + q] = v;
            }
            __syncthreads();              // Mt complete
            // d(x dt) += M^T dy: A(k, q) = Mt[q][k], B(q, p) = Dy[q][p]
            sb_mm(dxd, Mt, 1, SB_TL, Dy, LP, 1, SB_T);
        }
        // dx = dt d(x dt); the direct part of ddt, <x_k, d(x dt)_k>
        T* dx = (T*)a.dx;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int kk = ty + 16 * r;
            float part = 0.f;
#pragma unroll
            for (int cc = 0; cc < TP; ++cc) {
                const int p = tx + 16 * cc;
                part = fmaf(Xj[kk * LP + p], dxd[r][cc], part);
                if (kk < nk)
                    dx[((pos0 + k0 + kk) * H + h) * P + p] =
                        from_f<T>(dxd[r][cc] * dts[k0 + kk]);
            }
            part = sb_row_sum(part);
            if (tx == 0 && kk < nk) a.ddt[(pos0 + k0 + kk) * H + h] = part;
        }
        // the keys' d cs: minus the column sums of dM o M, minus the
        // update's decay term; and the tile's share of d cs_last
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) red[ty * SB_T + tx + 16 * cc] = colT[cc];
        __syncthreads();
        if (tid < SB_T && tid < nk) {
            float col = 0.f;
            for (int y = 0; y < 16; ++y) col += red[y * SB_T + tid];
            a.ct[row * S + t0 + k0 + tid] = -col - sds[tid];
        }
        if (tid == SB_T) {
            float s = 0.f;
            for (int kk = 0; kk < nk; ++kk) s += sds[kk];
            a.lastp[(row * a.nc + c) * a.nt + j] = s;
        }
    }

    // dB = sum_q dG_qk C_q + the state term; dG's columns out
    float db[2][TN];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int cc = 0; cc < TN; ++cc) db[r][cc] = dbs[r][cc];
    for (int q0 = k0; q0 < Q; q0 += SB_T) {
        __syncthreads();                  // Ct free, Dg complete
        sb_rows<T, N>(Ct, (const T*)a.Cm, pos0 + q0, N, min(SB_T, Q - q0));
        __syncthreads();
        // A(k, q) = Dg[q0 + q][k], B(q, n) = Ct[q][n]
        sb_mm(db, Dg + q0 * SB_TL, 1, SB_TL, Ct, LN, 1, SB_T);
    }
    T* dB = (T*)a.dB;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int kk = ty + 16 * r;
        if (kk >= nk) continue;
#pragma unroll
        for (int cc = 0; cc < TN; ++cc)
            dB[(pos0 + k0 + kk) * N + tx + 16 * cc] = from_f<T>(db[r][cc]);
    }
    float* dg = a.dg + ((size_t)b * a.nc + c) * Q * Q;
    for (int e = tid; e < (Q - k0) * SB_T; e += SB_THREADS) {
        const int q = k0 + e / SB_T, kk = e % SB_T;
        if (kk < nk) dg[(size_t)q * Q + k0 + kk] = Dg[q * SB_TL + kk];
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_keys_mma: the key pass on the tensor cores (bf16, (P, N) = (64,
// 128)); the same work, workspace parts and outputs as ssd_bwd_keys
// ---------------------------------------------------------------------------
// Every product of the head loop is mma.sync m16n8k16 over bf16 tiles in
// shared memory (ldmatrix fragments; rows skewed by 16 bytes so neither
// ldmatrix nor the stores conflict): G = C B^T and dM = dy x^T (x, dy, B
// and C are the inputs' bf16 values, exact), u = B g^T and x g (g, the f32
// adjoint, in the three bf16 parts ssd_bwd_states wrote), M^T dy (M in
// three parts), and after the heads dG^T C (dG in three parts).  Each of
// the 8 warps owns a fixed part of every product's 32-row output: rows 16
// (warp % 2) .. +15 and a quarter (warp / 2) of the columns, so the
// head-summed dB and the d(x dt) of the keys stay in its registers.  Row
// and column sums of the f32 elementwise results meet in shared memory and
// add in a fixed order: the backward replays bit for bit, as the FMA body
// does.  A head's g_c parts, x rows, cs and dt sit in one of two stages:
// the next head's are copied in by cp.async while this head's products
// run; the next 32 rows of dy wait in registers.
constexpr int SM_P = 64, SM_N = 128;
constexpr int SM_LDN = SM_N + 8;    // bf16 rows of N values (skewed)
constexpr int SM_LDP = SM_P + 8;    // bf16 rows of P values
constexpr int SM_LDT = SB_T + 8;    // bf16 rows of 32 values
constexpr int SM_WINDOW = 16;       // (chunk, b) pairs the block order
                                    // sorts by key tile at a time

struct SmKeys {     // byte offsets into dynamic shared memory
    using bf = __nv_bfloat16;
    static constexpr size_t BJ = 0;                              // [32][LDN]
    static constexpr size_t CQ = BJ + SB_T * SM_LDN * 2;         // [32][LDN]
    static constexpr size_t DY = CQ + SB_T * SM_LDN * 2;         // [32][LDP]
    static constexpr size_t MT = DY + SB_T * SM_LDP * 2;         // 3 [32][LDT]
    static constexpr size_t GC = MT + 3 * SB_T * SM_LDT * 2;     // f32 [QMAX][TL]
    static constexpr size_t DG = GC + SB_QMAX * SB_TL * 4;       // f32 [QMAX][TL]
    static constexpr size_t RED = DG + SB_QMAX * SB_TL * 4;      // f32 [4][32] x 3
    // a head's stage, two of them from ST on
    static constexpr size_t GE = 0;                              // 3 [P][LDN]
    static constexpr size_t XJ = GE + 3 * SM_P * SM_LDN * 2;     // [32][LDP]
    static constexpr size_t CS = XJ + SB_T * SM_LDP * 2;         // f32 [QMAX]
    static constexpr size_t DT = CS + SB_QMAX * 4;               // f32 [QMAX]
    static constexpr size_t STAGE = DT + SB_QMAX * 4;
    static constexpr size_t ST = RED + 3 * 4 * SB_T * 4;
    static constexpr size_t BYTES = ST + 2 * STAGE;
    static_assert(BYTES <= 232448, "one block an SM");
};

// 4 bytes from src to the shared dst by cp.async (rows of f32 values with
// a stride, where 16-byte copies do not apply)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
}

// mma.sync fragments from bf16 tiles in shared memory (ld elements a row)
// A (16 rows x 16 k) of a[row][k]
__device__ __forceinline__ void sm_a(uint32_t (&r)[4],
                                     const __nv_bfloat16* a, int ld, int m0,
                                     int k0) {
    const int lane = threadIdx.x % 32;
    ldsm_x4<false>(r, a + (m0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// A (16 rows x 16 k) of a tile stored as t[k][row]
__device__ __forceinline__ void sm_a_t(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int ld, int m0,
                                       int k0) {
    const int lane = threadIdx.x % 32;
    ldsm_x4<true>(r, t + (k0 + lane % 8 + (lane / 16) * 8) * ld + m0
                         + ((lane / 8) % 2) * 8);
}
// B of the n8 tiles n0 (r[0], r[1]) and n0 + 8 (r[2], r[3]) over k0 .. k0
// + 15, from b[n][k]
__device__ __forceinline__ void sm_b_nk(uint32_t (&r)[4],
                                        const __nv_bfloat16* b, int ld,
                                        int n0, int k0) {
    const int lane = threadIdx.x % 32;
    ldsm_x4<false>(r, b + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0
                         + ((lane / 8) % 2) * 8);
}
// B of the n8 tile n0 over k0 .. k0 + 15 (r[0], r[1]) and k0 + 16 .. k0 +
// 31 (r[2], r[3]), from b[n][k]
__device__ __forceinline__ void sm_b_nk2(uint32_t (&r)[4],
                                         const __nv_bfloat16* b, int ld,
                                         int n0, int k0) {
    const int lane = threadIdx.x % 32;
    ldsm_x4<false>(r, b + (n0 + lane % 8) * ld + k0 + (lane / 8) * 8);
}
// B of the n8 tiles n0 and n0 + 8 over k0 .. k0 + 15, from b[k][n]
__device__ __forceinline__ void sm_b_kn(uint32_t (&r)[4],
                                        const __nv_bfloat16* b, int ld,
                                        int n0, int k0) {
    const int lane = threadIdx.x % 32;
    ldsm_x4<true>(r, b + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0
                        + (lane / 16) * 8);
}

// rows [r0, r0 + SB_T) of a bf16 (rows, D) matrix with row stride rs
// elements (16-byte aligned rows) into a [SB_T][LD] tile, zeros at and
// past n rows, 16 bytes a copy
template <int D, int LD>
__device__ __forceinline__ void sm_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, size_t r0,
                                        size_t rs, int n) {
    for (int e = threadIdx.x; e < SB_T * D / 8; e += SB_THREADS) {
        const int i = e / (D / 8), c = e % (D / 8);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (i < n)
            v = *reinterpret_cast<const uint4*>(src + (r0 + i) * rs + c * 8);
        *reinterpret_cast<uint4*>(dst + i * LD + c * 8) = v;
    }
}

// A head's stage: g_c's three parts (rows p of N values, as
// ssd_bwd_states wrote them), the key tile's x rows (zeros past nk), and
// the chunk's cs and dt, by cp.async; the caller commits the group.
__device__ __forceinline__ void sm_stage(unsigned char* st, const SbArgs& a,
                                         int h, int c, int b, int k0,
                                         int nk) {
    using bf = __nv_bfloat16;
    constexpr int P = SM_P, N = SM_N;
    const int Q = a.Q, H = a.H, S = a.S, tid = threadIdx.x;
    const size_t row = (size_t)b * H + h, pos0 = (size_t)b * S + c * Q;
    const bf* ge = (const bf*)a.rt + (row * a.nc + c) * 3 * P * N;
    bf* Ge = reinterpret_cast<bf*>(st + SmKeys::GE);
    for (int e = tid; e < 3 * P * N / 8; e += SB_THREADS) {
        const int k = e / (P * N / 8), pp = e / (N / 8) % P, ch = e % (N / 8);
        cp_async16(Ge + (k * P + pp) * SM_LDN + ch * 8,
                   ge + ((size_t)k * P + pp) * N + ch * 8, true);
    }
    {
        const int i = tid / (P / 8), ch = tid % (P / 8);   // 32 rows x 8
        const bool ok = i < nk;
        cp_async16(st + SmKeys::XJ + (i * SM_LDP + ch * 8) * 2,
                   (const bf*)a.x + ((pos0 + k0 + (ok ? i : 0)) * H + h) * P
                       + ch * 8, ok);
    }
    float* cs = reinterpret_cast<float*>(st + SmKeys::CS);
    float* dts = reinterpret_cast<float*>(st + SmKeys::DT);
    for (int q = tid; q < Q; q += SB_THREADS) {
        cp_async4(cs + q, a.cs + row * S + c * Q + q);
        cp_async4(dts + q, a.dt + (pos0 + q) * H + h);
    }
}

// 32 rows of dy from q0 of head h (zeros past Q): thread tid's 16 bytes,
// row tid / 8, chunk tid % 8
__device__ __forceinline__ uint4 sm_dy_rows(const SbArgs& a, size_t pos0,
                                            int h, int q0) {
    const int i = threadIdx.x / (SM_P / 8), ch = threadIdx.x % (SM_P / 8);
    if (q0 + i >= a.Q) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(
        (const __nv_bfloat16*)a.dy + ((pos0 + q0 + i) * a.H + h) * SM_P
        + ch * 8);
}

__global__ void __launch_bounds__(SB_THREADS, 1) ssd_bwd_keys_mma(SbArgs a) {
    using bf = __nv_bfloat16;
    using L = SmKeys;
    constexpr int P = SM_P, N = SM_N;
    // the block's key tile j and (c, b): within each window of SM_WINDOW
    // (chunk, b) pairs, every pair's key tile 0 first (the most query
    // tiles), then every pair's key tile 1, and so on, so that the long
    // blocks start first and the short ones fill the tail
    const int pairs = a.nc * a.B, L0 = blockIdx.x;
    const int w0 = L0 / (a.nt * SM_WINDOW) * SM_WINDOW;
    const int wn = min(SM_WINDOW, pairs - w0);
    const int r0 = L0 - w0 * a.nt;
    const int j = r0 / wn, pair = w0 + r0 % wn;
    const int c = pair % a.nc, b = pair / a.nc;
    const int Q = a.Q, H = a.H, S = a.S, t0 = c * Q, k0 = j * SB_T;
    const int nk = min(SB_T, Q - k0);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int mt = warp % 2, wq = warp / 2;   // 16-row tile, column quarter
    const int g = lane / 4, t4 = lane % 4;    // accumulator row, column pair
    extern __shared__ __align__(16) unsigned char sm_raw[];
    bf* Bj = reinterpret_cast<bf*>(sm_raw + L::BJ);
    bf* Cq = reinterpret_cast<bf*>(sm_raw + L::CQ);
    bf* Dy = reinterpret_cast<bf*>(sm_raw + L::DY);
    bf* Mt = reinterpret_cast<bf*>(sm_raw + L::MT);
    float* Gc = reinterpret_cast<float*>(sm_raw + L::GC);
    float* Dg = reinterpret_cast<float*>(sm_raw + L::DG);
    float* red_a = reinterpret_cast<float*>(sm_raw + L::RED);   // [4][32]
    float* red_b = red_a + 4 * SB_T;                            // [4][32]
    float* red_c = red_b + 4 * SB_T;                            // [4][32]
    const size_t pos0 = (size_t)b * S + t0;
    // this thread's accumulator rows (of a 32-row output) and their keys
    const int rr[2] = {16 * mt + g, 16 * mt + g + 8};

    // head 0's stage in flight from the start, and its first dy rows
    sm_stage(sm_raw + L::ST, a, 0, c, b, k0, nk);
    cp_async_commit();
    uint4 dyv = sm_dy_rows(a, pos0, 0, k0);

    // the keys' B rows; G's columns G[q][k] = C_q . B_k for q >= k0 (warp:
    // rows 16 mt of the query tile, keys 8 wq), and dG's zeroed
    sm_rows<N, SM_LDN>(Bj, (const bf*)a.Bm + pos0 * N, k0, N, nk);
    for (int q0 = k0; q0 < Q; q0 += SB_T) {
        __syncthreads();                  // Bj landed, Cq free
        sm_rows<N, SM_LDN>(Cq, (const bf*)a.Cm + pos0 * N, q0, N,
                           min(SB_T, Q - q0));
        __syncthreads();
        float gt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kp = 0; kp < N / 32; ++kp) {
            uint32_t bf4[4], af[4];
            sm_b_nk2(bf4, Bj, SM_LDN, 8 * wq, 32 * kp);
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2) {
                sm_a(af, Cq, SM_LDN, 16 * mt, 32 * kp + 16 * s2);
                mma_bf16(gt, af, bf4[2 * s2], bf4[2 * s2 + 1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int q = q0 + rr[e / 2], kk = 8 * wq + 2 * t4 + e % 2;
            Gc[q * SB_TL + kk] = gt[e];
            Dg[q * SB_TL + kk] = 0.f;
        }
    }

    float dbs[4][4];                      // dB's state term, over heads
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dbs[t][e] = 0.f;
    for (int h = 0; h < H; ++h) {
        const size_t row = (size_t)b * H + h;
        unsigned char* st = sm_raw + L::ST + (h % 2) * L::STAGE;
        const bf* Ge = reinterpret_cast<const bf*>(st + L::GE);
        const bf* Xj = reinterpret_cast<const bf*>(st + L::XJ);
        const float* cs = reinterpret_cast<const float*>(st + L::CS);
        const float* dts = reinterpret_cast<const float*>(st + L::DT);
        cp_async_wait_all();              // this head's stage, my copies
        __syncthreads();                  // everyone's; the last head's
                                          // tiles and stage consumed
        if (h + 1 < H) {                  // the next head's, meanwhile
            sm_stage(sm_raw + L::ST + ((h + 1) % 2) * L::STAGE, a, h + 1, c,
                     b, k0, nk);
            cp_async_commit();
        }
        const float last = cs[Q - 1];
        float dec[2], dtk[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int kk = rr[i];
            dec[i] = kk < nk ? expf(last - cs[k0 + kk]) : 0.f;
            dtk[i] = kk < nk ? dts[k0 + kk] : 0.f;
        }
        // u = B_k g^T (keys x P; warp: P columns 16 wq .. +15), the state's
        // part of d(x dt) after the decay, and its d cs: exp(cs_last - cs_k)
        // dt_k <x_k, u_k>
        float dxd[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) dxd[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t af[4];
            sm_a(af, Bj, SM_LDN, 16 * mt, 16 * ks);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                uint32_t bf4[4];
                sm_b_nk(bf4, Ge + k * P * SM_LDN, SM_LDN, 16 * wq, 16 * ks);
                mma_bf16(dxd[0], af, bf4[0], bf4[1]);
                mma_bf16(dxd[1], af, bf4[2], bf4[3]);
            }
        }
        {
            float part[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e / 2;
                    const int pp = 16 * wq + 8 * t + 2 * t4 + e % 2;
                    part[i] = fmaf(__bfloat162float(Xj[rr[i] * SM_LDP + pp]),
                                   dxd[t][e], part[i]);
                    dxd[t][e] *= dec[i];
                }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float v = part[i];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                if (t4 == 0) red_a[wq * SB_T + rr[i]] = dec[i] * dtk[i] * v;
            }
        }
        // dB's state term: exp(cs_last - cs_k) dt_k x_k g (keys x N; warp:
        // N columns 32 wq .. +31)
        {
            float tm[4][4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) tm[t][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < P / 16; ++ks) {
                uint32_t af[4];
                sm_a(af, Xj, SM_LDP, 16 * mt, 16 * ks);
#pragma unroll
                for (int k = 0; k < 3; ++k)
#pragma unroll
                    for (int pr = 0; pr < 2; ++pr) {
                        uint32_t bf4[4];
                        sm_b_kn(bf4, Ge + k * P * SM_LDN, SM_LDN,
                                32 * wq + 16 * pr, 16 * ks);
                        mma_bf16(tm[2 * pr], af, bf4[0], bf4[1]);
                        mma_bf16(tm[2 * pr + 1], af, bf4[2], bf4[3]);
                    }
            }
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dbs[t][e] = fmaf(dec[e / 2] * dtk[e / 2], tm[t][e],
                                     dbs[t][e]);
        }
        float colT[2] = {0.f, 0.f};       // sum over q of dM o M, my columns
        for (int q0 = k0; q0 < Q; q0 += SB_T) {
            __syncthreads();              // Dy, Mt and red_b free
            *reinterpret_cast<uint4*>(Dy + (tid / 8) * SM_LDP + tid % 8 * 8) =
                dyv;
            // the next 32 rows of dy: this head's next query tile, or the
            // next head's first
            if (q0 + SB_T < Q) dyv = sm_dy_rows(a, pos0, h, q0 + SB_T);
            else if (h + 1 < H) dyv = sm_dy_rows(a, pos0, h + 1, k0);
            __syncthreads();
            // dM = dy_q . x_k (queries x keys; warp: keys 8 wq .. +7), then
            // x dt: times dt_k
            float dm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kp = 0; kp < P / 32; ++kp) {
                uint32_t bf4[4], af[4];
                sm_b_nk2(bf4, Xj, SM_LDP, 8 * wq, 32 * kp);
#pragma unroll
                for (int s2 = 0; s2 < 2; ++s2) {
                    sm_a(af, Dy, SM_LDP, 16 * mt, 32 * kp + 16 * s2);
                    mma_bf16(dm, af, bf4[2 * s2], bf4[2 * s2 + 1]);
                }
            }
            float rowT[2] = {0.f, 0.f};
            float mv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ql = rr[e / 2], q = q0 + ql;
                const int kk = 8 * wq + 2 * t4 + e % 2, k = k0 + kk;
                const bool vis = q < Q && kk < nk && k <= q;
                const float dmv = vis ? dm[e] * dts[k] : 0.f;
                const float l = vis ? expf(cs[q] - cs[k]) : 0.f;
                mv[e] = l * Gc[q * SB_TL + kk];
                Dg[q * SB_TL + kk] = fmaf(dmv, l, Dg[q * SB_TL + kk]);
                const float tv = dmv * mv[e];
                rowT[e / 2] += tv;
                colT[e % 2] += tv;
            }
            // M in three bf16 parts, rows q of 32 keys
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint32_t part[3];
                split3_bf16(mv[2 * i], mv[2 * i + 1], part);
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    *reinterpret_cast<uint32_t*>(
                        Mt + k * SB_T * SM_LDT + rr[i] * SM_LDT + 8 * wq
                        + 2 * t4) = part[k];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float v = rowT[i];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                if (t4 == 0) red_b[wq * SB_T + rr[i]] = v;
            }
            __syncthreads();              // Mt and red_b complete
            if (tid < SB_T && q0 + tid < Q)
                a.rows[((row * a.nc + c) * a.nt + j) * Q + q0 + tid] =
                    red_b[tid] + red_b[SB_T + tid] + red_b[2 * SB_T + tid]
                    + red_b[3 * SB_T + tid];
            // d(x dt) += M^T dy (keys x P; warp: P columns 16 wq .. +15)
#pragma unroll
            for (int ks = 0; ks < SB_T / 16; ++ks) {
                uint32_t bf4[4];
                sm_b_kn(bf4, Dy, SM_LDP, 16 * wq, 16 * ks);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    uint32_t af[4];
                    sm_a_t(af, Mt + k * SB_T * SM_LDT, SM_LDT, 16 * mt,
                           16 * ks);
                    mma_bf16(dxd[0], af, bf4[0], bf4[1]);
                    mma_bf16(dxd[1], af, bf4[2], bf4[3]);
                }
            }
        }
        // dx = dt d(x dt), two values a store; the direct part of ddt,
        // <x_k, d(x dt)_k>
        bf* dx = (bf*)a.dx;
        {
            float part[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int kk = rr[i];
                    const int pp = 16 * wq + 8 * t + 2 * t4;
                    const float v0 = dxd[t][2 * i], v1 = dxd[t][2 * i + 1];
                    part[i] = fmaf(__bfloat162float(Xj[kk * SM_LDP + pp]), v0,
                                   part[i]);
                    part[i] = fmaf(__bfloat162float(Xj[kk * SM_LDP + pp + 1]),
                                   v1, part[i]);
                    if (kk < nk)
                        *reinterpret_cast<__nv_bfloat162*>(
                            dx + ((pos0 + k0 + kk) * H + h) * P + pp) =
                            __floats2bfloat162_rn(v0 * dtk[i], v1 * dtk[i]);
                }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float v = part[i];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                if (t4 == 0) red_c[wq * SB_T + rr[i]] = v;
            }
        }
        // the column sums over q: this warp's 16 rows, then the two warps
        // of a column quarter
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float v = colT[e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            colT[e] = v;
        }
        __syncthreads();                  // red_a, red_c; red_b free
        if (g == 0) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
                red_b[mt * SB_T + 8 * wq + 2 * t4 + e] = colT[e];
        }
        __syncthreads();
        if (tid < SB_T && tid < nk) {
            const int kk = tid;
            const float sd = red_a[kk] + red_a[SB_T + kk]
                + red_a[2 * SB_T + kk] + red_a[3 * SB_T + kk];
            const float col = red_b[kk] + red_b[SB_T + kk];
            a.ct[row * S + t0 + k0 + kk] = -col - sd;
            a.ddt[(pos0 + k0 + kk) * H + h] = red_c[kk] + red_c[SB_T + kk]
                + red_c[2 * SB_T + kk] + red_c[3 * SB_T + kk];
        }
        if (tid == SB_T) {
            float s = 0.f;
            for (int kk = 0; kk < nk; ++kk)
                s += red_a[kk] + red_a[SB_T + kk] + red_a[2 * SB_T + kk]
                     + red_a[3 * SB_T + kk];
            a.lastp[(row * a.nc + c) * a.nt + j] = s;
        }
    }

    // dB = sum_q dG_qk C_q + the state term (keys x N; warp: N columns 32
    // wq .. +31), dG in three bf16 parts a query tile; dG's columns out
    for (int q0 = k0; q0 < Q; q0 += SB_T) {
        __syncthreads();                  // Cq and Mt free, Dg complete
        sm_rows<N, SM_LDN>(Cq, (const bf*)a.Cm + pos0 * N, q0, N,
                           min(SB_T, Q - q0));
        for (int e = tid; e < SB_T * SB_T / 2; e += SB_THREADS) {
            const int ql = 2 * e / SB_T, kk = 2 * e % SB_T;
            uint32_t part[3];
            split3_bf16(Dg[(q0 + ql) * SB_TL + kk],
                        Dg[(q0 + ql) * SB_TL + kk + 1], part);
#pragma unroll
            for (int k = 0; k < 3; ++k)
                *reinterpret_cast<uint32_t*>(Mt + k * SB_T * SM_LDT
                                             + ql * SM_LDT + kk) = part[k];
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < SB_T / 16; ++ks)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                uint32_t af[4];
                sm_a_t(af, Mt + k * SB_T * SM_LDT, SM_LDT, 16 * mt, 16 * ks);
#pragma unroll
                for (int pr = 0; pr < 2; ++pr) {
                    uint32_t bf4[4];
                    sm_b_kn(bf4, Cq, SM_LDN, 32 * wq + 16 * pr, 16 * ks);
                    mma_bf16(dbs[2 * pr], af, bf4[0], bf4[1]);
                    mma_bf16(dbs[2 * pr + 1], af, bf4[2], bf4[3]);
                }
            }
    }
    bf* dB = (bf*)a.dB;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int kk = rr[i];
            if (kk < nk)
                *reinterpret_cast<__nv_bfloat162*>(
                    dB + (pos0 + k0 + kk) * N + 32 * wq + 8 * t + 2 * t4) =
                    __floats2bfloat162_rn(dbs[t][2 * i], dbs[t][2 * i + 1]);
        }
    float* dgo = a.dg + ((size_t)b * a.nc + c) * Q * Q;
    for (int e = tid; e < (Q - k0) * SB_T; e += SB_THREADS) {
        const int q = k0 + e / SB_T, kk = e % SB_T;
        if (kk < nk) dgo[(size_t)q * Q + k0 + kk] = Dg[q * SB_TL + kk];
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_queries: a query tile of a chunk, walking the heads
// ---------------------------------------------------------------------------
template <int P, int N>
struct SbQueries {
    static constexpr int LP = P + 1, LN = N + 1;
    static constexpr int PV = 0;                        // [P][LN] S_c
    static constexpr int DY = PV + P * LN;              // [SB_T][LP]
    static constexpr int CI = DY + SB_T * LP;           // [SB_T][LN] C
    static constexpr int BT = CI + SB_T * LN;           // [SB_T][LN] B
    static constexpr int GT = BT + SB_T * LN;           // [SB_T][TL] dG
    static constexpr int ES = GT + SB_T * SB_TL;        // [SB_T] exp(cs)
    static constexpr size_t BYTES = sizeof(float) * (ES + SB_T);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(SB_THREADS) ssd_bwd_queries(SbArgs a) {
    using L = SbQueries<P, N>;
    constexpr int LP = L::LP, LN = L::LN, TN = N / 16;
    const int i = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int Q = a.Q, H = a.H, S = a.S, t0 = c * Q, q0 = i * SB_T;
    const int nq = min(SB_T, Q - q0);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    extern __shared__ float sm[];
    float* Pv = sm + L::PV;
    float* Dy = sm + L::DY;
    float* Ci = sm + L::CI;
    float* Bt = sm + L::BT;
    float* Gt = sm + L::GT;
    float* es = sm + L::ES;
    const size_t pos0 = (size_t)b * S + t0;
    sb_rows<T, N>(Ci, (const T*)a.Cm, pos0 + q0, N, nq);
    float dc[2][TN];
    sb_zero(dc);
    // dC = sum_k dG_qk B_k over the key tiles up to the diagonal
    const float* dg = a.dg + ((size_t)b * a.nc + c) * Q * Q;
    for (int k0 = 0; k0 <= q0; k0 += SB_T) {
        const int nk = min(SB_T, Q - k0);
        __syncthreads();
        sb_rows<T, N>(Bt, (const T*)a.Bm, pos0 + k0, N, nk);
        for (int e = tid; e < SB_T * SB_T; e += SB_THREADS) {
            const int ql = e / SB_T, kk = e % SB_T;
            Gt[ql * SB_TL + kk] = ql < nq && kk < nk
                ? dg[(size_t)(q0 + ql) * Q + k0 + kk] : 0.f;
        }
        __syncthreads();
        // A(q, k) = Gt[q][k], B(k, n) = Bt[k][n]
        sb_mm(dc, Gt, SB_TL, 1, Bt, LN, 1, SB_T);
    }
    for (int h = 0; h < H; ++h) {
        const size_t row = (size_t)b * H + h;
        __syncthreads();                  // the last head's tiles consumed
        const float* pv = a.st + (row * a.nc + c) * P * N;
        for (int e = tid; e < P * N; e += SB_THREADS)
            Pv[e / N * LN + e % N] = pv[e];
        sb_rows<T, P>(Dy, (const T*)a.dy + h * P, pos0 + q0, (size_t)H * P,
                      nq);
        if (tid < SB_T) es[tid] = tid < nq ? expf(a.cs[row * S + t0 + q0 + tid])
                                           : 0.f;
        __syncthreads();
        // w = dy_q S_c: A(q, p) = Dy[q][p], B(p, n) = Pv[p][n]
        float w[2][TN];
        sb_zero(w);
        sb_mm(w, Dy, LP, 1, Pv, LN, 1, P);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int ql = ty + 16 * r;
            const float e = es[ql];
            float part = 0.f;
#pragma unroll
            for (int cc = 0; cc < TN; ++cc) {
                part = fmaf(Ci[ql * LN + tx + 16 * cc], w[r][cc], part);
                dc[r][cc] = fmaf(e, w[r][cc], dc[r][cc]);
            }
            // d cs of the read-out: exp(cs_q) C_q . (dy_q S_c)
            part = sb_row_sum(part);
            if (tx == 0 && ql < nq) a.rd[row * S + t0 + q0 + ql] = e * part;
        }
    }
    T* dC = (T*)a.dC;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int ql = ty + 16 * r;
        if (ql >= nq) continue;
#pragma unroll
        for (int cc = 0; cc < TN; ++cc)
            dC[(pos0 + q0 + ql) * N + tx + 16 * cc] = from_f<T>(dc[r][cc]);
    }
}

// ---------------------------------------------------------------------------
// the tensor-core body's wgmma kernels (bf16, (P, N) = (64, 128))
// ---------------------------------------------------------------------------
constexpr int BW_T = 64;                     // rows a tile: wgmma's M
constexpr int BW_TILES = SB_QMAX / BW_T;     // tiles a chunk, at most
using BwN = WgTile<SM_N>;                    // rows of N values: B, C, states
using BwP = WgTile<SM_P>;                    // rows of P values: x, dy
constexpr uint32_t BW_NT = BW_T * SM_N * 2;  // a 64-row tile of N values
constexpr uint32_t BW_XT = BW_T * SM_P * 2;  // a 64-row tile of P values
constexpr uint32_t BW_PARTS = 3 * SM_P * SM_N;   // bf16 values of a state

// wgmma's MN-major B operand: 16 rows (K) from row 16 kk of column block
// ``cb`` (64 N values) of a 64-row tile of N values at ``tile``
__device__ __forceinline__ uint64_t bw_b_desc(uint32_t tile, int cb, int kk) {
    return wg_desc(tile + cb * (BW_T * 128) + kk * 2048, 1024, 1024,
                   BwN::MODE);
}

// Entry (p, n) of a warpgroup's 64 x 64 accumulator: element 4 nt + j of
// thread tid is row 16 w + gid + 8 (j / 2) and column 8 nt + 2 tig + j % 2
// of the warpgroup's half of N (w the warp in the warpgroup).
__device__ __forceinline__ int bw_row(int j) {
    return 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4 + 8 * (j / 2);
}
__device__ __forceinline__ int bw_col(int nt) {
    return 64 * (threadIdx.x / 128) + 8 * nt + 2 * (threadIdx.x % 4);
}

// A state (p, n) from device memory into the accumulator layout: bf16 or
// (f32) float32, zeros for null
__device__ __forceinline__ void bw_load_state(float (&s)[32], const void* src,
                                              int f32, size_t off) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const size_t i = off + (size_t)bw_row(2 * hh) * SM_N + bw_col(nt);
            float2 v = make_float2(0.f, 0.f);
            if (src != nullptr)
                v = f32 ? *reinterpret_cast<const float2*>((const float*)src + i)
                        : __bfloat1622float2(*reinterpret_cast<
                              const __nv_bfloat162*>(
                              (const __nv_bfloat16*)src + i));
            s[4 * nt + 2 * hh] = v.x;
            s[4 * nt + 2 * hh + 1] = v.y;
        }
}

// The chunk's rows for one step of ssd_bwd_states into a stage: rows q of
// N values (B or C) and of P values (x or dy) in 64-row swizzled tiles,
// zeros past Q, announced on ``bar``.
__device__ __forceinline__ void bw_stage(unsigned char* st, uint64_t* bar,
                                         const __nv_bfloat16* nrow,
                                         const __nv_bfloat16* prow,
                                         size_t pstride, int Q, int nq) {
    const int tid = threadIdx.x, cc = tid % 16, cx = tid % 8;
    for (int r = 0; r < nq; ++r) {
#pragma unroll
        for (int u = 0; u < BW_T / 16; ++u) {
            const int i = tid / 16 + 16 * u, q = r * BW_T + i;
            const bool ok = q < Q;
            cp_async16(st + r * BW_NT + BwN::at<BW_T>(i, cc),
                       nrow + (size_t)(ok ? q : 0) * SM_N + cc * 8, ok);
        }
#pragma unroll
        for (int u = 0; u < BW_T / 32; ++u) {
            const int i = tid / 8 + 32 * u, q = r * BW_T + i;
            const bool ok = q < Q;
            cp_async16(st + BW_TILES * BW_NT + r * BW_XT + BwP::at<BW_T>(i, cx),
                       prow + (size_t)(ok ? q : 0) * pstride + cx * 8, ok);
        }
    }
    mbar_arrive_on_copies(bar);
}

// ---------------------------------------------------------------------------
// ssd_bwd_states: cs, the carried states S_c and the adjoints g_c
// ---------------------------------------------------------------------------
struct BwStates {   // byte offsets from the 1024-aligned base
    static constexpr uint32_t STAGE = BW_TILES * (BW_NT + BW_XT);   // 96 KB
    static constexpr size_t SMEM = 1024 + 2 * STAGE;
};

__global__ void __launch_bounds__(SB_THREADS, 1) ssd_bwd_states(SbArgs a) {
    using bf = __nv_bfloat16;
    constexpr int P = SM_P, N = SM_N;
    const int h = blockIdx.x, b = blockIdx.y;
    const int Q = a.Q, H = a.H, S = a.S, nc = a.nc;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wg = tid / 128, ww = warp % 4, tig = lane % 4;
    const int nq = (Q + BW_T - 1) / BW_T;
    const size_t row = (size_t)b * H + h;
    extern __shared__ __align__(16) unsigned char sm_raw[];
    __shared__ float cs_s[SB_QMAX], w_s[SB_QMAX];
    __shared__ float wsum[SB_THREADS / 32], red[SB_THREADS / 32];
    __shared__ uint64_t full[2];              // a stage's copies landed
    const uint32_t raw = smem_u32(sm_raw);
    const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms align
    unsigned char* tiles = sm_raw + (base - raw);
    const float A = a.A[h];

    if (tid == 0) {
        mbar_init(&full[0], SB_THREADS);
        mbar_init(&full[1], SB_THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // step t < nc walks chunk t forward (x and B), step t >= nc chunk 2 nc
    // - 1 - t backward (dy and C); a step's rows land in stage t % 2
    auto chunk_of = [nc](int t) { return t < nc ? t : 2 * nc - 1 - t; };
    auto stage = [&](int t) {
        const size_t pos0 = (size_t)b * S + (size_t)chunk_of(t) * Q;
        bw_stage(tiles + (t % 2) * BwStates::STAGE, &full[t % 2],
                 (const bf*)(t < nc ? a.Bm : a.Cm) + pos0 * N,
                 (const bf*)(t < nc ? a.x : a.dy) + (pos0 * H + h) * P,
                 (size_t)H * P, Q, nq);
    };
    auto dt_of = [&](int t) {
        return tid < Q ? a.dt[((size_t)b * S + (size_t)chunk_of(t) * Q + tid)
                              * H + h] : 0.f;
    };
    stage(0);
    float dnext = dt_of(0);
    // S, the state carried into the chunk; after the forward walk, g, the
    // adjoint of the state at the chunk's end (dfin, or zeros, at the last)
    float s[32];
    bw_load_state(s, a.init, a.init_f32, row * P * N);
    for (int t = 0; t < 2 * nc; ++t) {
        const bool fwd = t < nc;
        const int c = chunk_of(t);
        const float d = dnext;
        if (t + 1 < 2 * nc) {             // the next step's rows, meanwhile
            stage(t + 1);
            dnext = dt_of(t + 1);
        }
        if (t == nc) bw_load_state(s, a.dfin, a.dfin_f32, row * P * N);
        // S_c (forward) or g_c (backward) out in its three parts; backward,
        // S_c's parts back at this thread's own entries
        bf* out = (bf*)(fwd ? a.st : a.rt) + (row * nc + c) * BW_PARTS;
        const bf* sc = (const bf*)a.st + (row * nc + c) * BW_PARTS;
        uint32_t sv[3][16];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int off = bw_row(2 * hh) * N + bw_col(nt);
                uint32_t part[3];
                split3_bf16(s[4 * nt + 2 * hh], s[4 * nt + 2 * hh + 1], part);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    *reinterpret_cast<uint32_t*>(out + k * P * N + off) =
                        part[k];
                    sv[k][2 * nt + hh] = fwd ? 0u
                        : *reinterpret_cast<const uint32_t*>(sc + k * P * N
                                                             + off);
                }
            }
        // the inclusive running sum of dt A, a position a thread (past Q,
        // dt = 0)
        float v = d * A;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane == 31) wsum[warp] = v;
        __syncthreads();
        for (int w = 0; w < warp; ++w) v += wsum[w];
        cs_s[tid] = v;
        __syncthreads();
        const float last = cs_s[Q - 1];
        // the rows' weights: forward w_k = dt_k exp(cs_last - cs_k), the
        // own state's; backward exp(cs_q), R_c's
        if (fwd) {
            w_s[tid] = tid < Q ? d * expf(last - v) : 0.f;
            if (tid < Q) a.cs[row * S + (size_t)c * Q + tid] = v;
        } else {
            w_s[tid] = tid < Q ? expf(v) : 0.f;
        }
        // backward: this thread's share of <g_c, S_c>
        float dot = 0.f;
        if (!fwd) {
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                float2 f = make_float2(0.f, 0.f);
#pragma unroll
                for (int k = 2; k >= 0; --k) {
                    const float2 pk = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&sv[k][e]));
                    f.x += pk.x;
                    f.y += pk.y;
                }
                const int nt = e / 2, hh = e % 2;
                dot = fmaf(s[4 * nt + 2 * hh], f.x, dot);
                dot = fmaf(s[4 * nt + 2 * hh + 1], f.y, dot);
            }
        }
        const float dec = expf(last);
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] *= dec;
        __syncthreads();                  // w_s visible
        mbar_wait(&full[t % 2], (t / 2) & 1);
        fence_proxy_async();
        // s += (X o w)^T N over the chunk's key tiles: A = (X o w)^T, rows
        // p (this warp's 16), keys 16 kk .. +15, as register fragments in
        // three parts (ldmatrix.trans of the X tile: matrix m holds keys +
        // 8 (m / 2), rows p + 8 (m % 2)); N's rows MN-major and exact; each
        // tile's product fresh, added in f32
        const uint32_t sbase = base + (t % 2) * BwStates::STAGE;
        const unsigned char* xt = tiles + (t % 2) * BwStates::STAGE
            + BW_TILES * BW_NT;
        for (int j = 0; j < nq; ++j) {
            const unsigned char* xs = xt + j * BW_XT;
            uint32_t pp[4][4][3];
#pragma unroll
            for (int kk = 0; kk < BW_T / 16; ++kk) {
                const int m = lane / 8;
                const int kr = 16 * kk + 8 * (m / 2) + lane % 8;
                uint32_t xf[4];
                ldsm_x4<true>(xf, reinterpret_cast<const bf*>(
                                      xs + BwP::at<BW_T>(kr, 2 * ww + m % 2)));
                const int kw = j * BW_T + 16 * kk + 2 * tig;
                const float2 wlo = make_float2(w_s[kw], w_s[kw + 1]);
                const float2 whi = make_float2(w_s[kw + 8], w_s[kw + 9]);
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const float2 xv = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&xf[f]));
                    const float2 wk = f < 2 ? wlo : whi;
                    split3_bf16(xv.x * wk.x, xv.y * wk.y, pp[kk][f]);
                }
            }
            float u[32];
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BW_T / 16; ++kk)
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const uint32_t af[4] = {pp[kk][0][k], pp[kk][1][k],
                                            pp[kk][2][k], pp[kk][3][k]};
                    wgmma_rs<1>(u, af, bw_b_desc(sbase + j * BW_NT, wg, kk),
                                kk > 0 || k > 0);
                }
            wg_commit();
            wg_wait<0>();
            wg_pin(u);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int f = 0; f < 4; ++f)
                    asm volatile("" :: "r"(pp[kk][f][0]), "r"(pp[kk][f][1]),
                                 "r"(pp[kk][f][2]) : "memory");
#pragma unroll
            for (int e = 0; e < 32; ++e) s[e] += u[e];
        }
        if (!fwd) {
            // d cs_last of the chunk decay: exp(cs_last) <g_c, S_c>, the
            // block's sum in a fixed order (ssd_bwd_dt adds it)
            const float tot = sb_block_sum(dot, red);
            if (tid == 0) a.dcl[row * nc + c] = dec * tot;
        }
        __syncthreads();                  // the stage's tiles, cs_s and w_s
                                          // consumed
    }
    // d init_state: the adjoint after the first chunk
    if (a.dinit != nullptr) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const size_t i = row * P * N + (size_t)bw_row(2 * hh) * N
                    + bw_col(nt);
                const float v0 = s[4 * nt + 2 * hh], v1 = s[4 * nt + 2 * hh + 1];
                if (a.init_f32) {
                    *reinterpret_cast<float2*>((float*)a.dinit + i) =
                        make_float2(v0, v1);
                } else {
                    *reinterpret_cast<__nv_bfloat162*>((bf*)a.dinit + i) =
                        __floats2bfloat162_rn(v0, v1);
                }
            }
    }
}

// ---------------------------------------------------------------------------
// ssd_bwd_queries_wg: a 64-query tile of a chunk, walking the heads
// ---------------------------------------------------------------------------
struct BwQueries {  // byte offsets from the 1024-aligned base
    static constexpr uint32_t BT = 0;                        // B's key tiles
    static constexpr uint32_t ST = BW_TILES * BW_NT;         // two stages
    static constexpr uint32_t DY = 0;                        // + stage: dy
    static constexpr uint32_t SP = BW_XT;                    // + stage: S_c
    static constexpr uint32_t STAGE = BW_XT + 3 * BW_NT;     // 56 KB
    static constexpr size_t SMEM = 1024 + ST + 2 * STAGE;
};

// A head's dy rows (the tile's 64 queries, zeros past Q) and S_c's three
// parts (rows p of N values) into a stage, announced on ``bar``
__device__ __forceinline__ void bw_query_stage(unsigned char* st,
                                               uint64_t* bar, const SbArgs& a,
                                               int h, int c, int b, int q0) {
    using bf = __nv_bfloat16;
    constexpr int P = SM_P, N = SM_N;
    const int tid = threadIdx.x, Q = a.Q, H = a.H;
    const size_t pos0 = (size_t)b * a.S + (size_t)c * Q;
#pragma unroll
    for (int u = 0; u < BW_T / 32; ++u) {
        const int i = tid / 8 + 32 * u, q = q0 + i;
        const bool ok = q < Q;
        cp_async16(st + BwQueries::DY + BwP::at<BW_T>(i, tid % 8),
                   (const bf*)a.dy + ((pos0 + (ok ? q : 0)) * H + h) * P
                       + tid % 8 * 8, ok);
    }
    const bf* sp = (const bf*)a.st
        + (((size_t)b * H + h) * a.nc + c) * BW_PARTS;
    for (int e = tid; e < 3 * P * N / 8; e += SB_THREADS) {
        const int k = e / (P * N / 8), p = e / (N / 8) % P, ch = e % (N / 8);
        cp_async16(st + BwQueries::SP + k * BW_NT + BwN::at<BW_T>(p, ch),
                   sp + ((size_t)k * P + p) * N + ch * 8, true);
    }
    mbar_arrive_on_copies(bar);
}

__global__ void __launch_bounds__(SB_THREADS, 1) ssd_bwd_queries_wg(SbArgs a) {
    using bf = __nv_bfloat16;
    using L = BwQueries;
    constexpr int N = SM_N;
    const int i = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int Q = a.Q, H = a.H, S = a.S, t0 = c * Q, q0 = i * BW_T;
    const int tid = threadIdx.x, lane = tid % 32;
    const int wg = tid / 128, tig = lane % 4;
    const size_t pos0 = (size_t)b * S + t0;
    extern __shared__ __align__(16) unsigned char sm_raw[];
    __shared__ float red[2][2][BW_T];         // head parity, warpgroup, row
    __shared__ float es[2][BW_T];             // head parity, row: exp(cs_q)
    __shared__ uint64_t bfull, full[2];
    const uint32_t raw = smem_u32(sm_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* tiles = sm_raw + (base - raw);

    if (tid == 0) {
        mbar_init(&bfull, SB_THREADS);
        mbar_init(&full[0], SB_THREADS);
        mbar_init(&full[1], SB_THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // B's key tiles up to the diagonal (dG B's MN-major operand), then the
    // first two heads' stages
    {
        const int cc = tid % 16;
        for (int j = 0; j <= i; ++j)
#pragma unroll
            for (int u = 0; u < BW_T / 16; ++u) {
                const int r = tid / 16 + 16 * u, k = j * BW_T + r;
                const bool ok = k < Q;
                cp_async16(tiles + L::BT + j * BW_NT + BwN::at<BW_T>(r, cc),
                           (const bf*)a.Bm + (pos0 + (ok ? k : 0)) * N
                               + cc * 8, ok);
            }
        mbar_arrive_on_copies(&bfull);
    }
    for (int h = 0; h < min(2, H); ++h)
        bw_query_stage(tiles + L::ST + h * L::STAGE, &full[h], a, h, c, b,
                       q0);

    // this thread's rows, their C values (this warpgroup's half of N) and
    // head 0's cs
    int qr[2];
    uint32_t cv[16];
    float csn[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        qr[hh] = q0 + bw_row(2 * hh);
        csn[hh] = qr[hh] < Q ? a.cs[(size_t)b * H * S + t0 + qr[hh]] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
            cv[2 * nt + hh] = qr[hh] < Q
                ? *reinterpret_cast<const uint32_t*>(
                      (const bf*)a.Cm + (pos0 + qr[hh]) * N + bw_col(nt))
                : 0u;
    }

    // dC = dG B over the key tiles up to the diagonal: dG's rows (causal:
    // k <= q) as register A fragments in three parts; each tile's product
    // fresh, added in f32
    float dc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dc[e] = 0.f;
    mbar_wait(&bfull, 0);
    fence_proxy_async();
    const float* dg = a.dg + ((size_t)b * a.nc + c) * Q * Q;
    for (int j = 0; j <= i; ++j) {
        uint32_t pp[4][4][3];
#pragma unroll
        for (int kk = 0; kk < BW_T / 16; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int q = qr[f % 2];
                const int k = j * BW_T + 16 * kk + 8 * (f / 2) + 2 * tig;
                const bool ok = q < Q;
                const float v0 = ok && k <= q ? dg[(size_t)q * Q + k] : 0.f;
                const float v1 = ok && k + 1 <= q ? dg[(size_t)q * Q + k + 1]
                                                  : 0.f;
                split3_bf16(v0, v1, pp[kk][f]);
            }
        float u[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BW_T / 16; ++kk)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const uint32_t af[4] = {pp[kk][0][k], pp[kk][1][k],
                                        pp[kk][2][k], pp[kk][3][k]};
                wgmma_rs<1>(u, af, bw_b_desc(base + L::BT + j * BW_NT, wg, kk),
                            kk > 0 || k > 0);
            }
        wg_commit();
        wg_wait<0>();
        wg_pin(u);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f)
                asm volatile("" :: "r"(pp[kk][f][0]), "r"(pp[kk][f][1]),
                             "r"(pp[kk][f][2]) : "memory");
#pragma unroll
        for (int e = 0; e < 32; ++e) dc[e] += u[e];
    }

    for (int h = 0; h < H; ++h) {
        const size_t row = (size_t)b * H + h;
        float e[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            e[hh] = qr[hh] < Q ? expf(csn[hh]) : 0.f;
            if (h + 1 < H)                // the next head's, meanwhile
                csn[hh] = qr[hh] < Q ? a.cs[(row + 1) * S + t0 + qr[hh]]
                                     : 0.f;
        }
        mbar_wait(&full[h % 2], (h / 2) & 1);
        fence_proxy_async();
        // w = dy_q S_c (64 queries x this warpgroup's 64 columns of N):
        // dy K-major, S_c's three parts MN-major
        const uint32_t sb = base + L::ST + (h % 2) * L::STAGE;
        float w[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < SM_P / 16; ++kk)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                wgmma_ss_mn<0>(w, BwP::desc<BW_T>(sb + L::DY, kk * 16),
                               bw_b_desc(sb + L::SP + k * BW_NT, wg, kk),
                               kk > 0 || k > 0);
        wg_commit();
        wg_wait<0>();
        wg_pin(w);
        // dC += exp(cs_q) w; the read-out's d cs, exp(cs_q) C_q . w_q: this
        // warpgroup's half of the row, then both halves in order
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const float2 cf = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(
                        &cv[2 * nt + hh]));
                const int x0 = 4 * nt + 2 * hh;
                part[hh] = fmaf(cf.x, w[x0], part[hh]);
                part[hh] = fmaf(cf.y, w[x0 + 1], part[hh]);
                dc[x0] = fmaf(e[hh], w[x0], dc[x0]);
                dc[x0 + 1] = fmaf(e[hh], w[x0 + 1], dc[x0 + 1]);
            }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float v = part[hh];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tig == 0) {
                red[h % 2][wg][bw_row(2 * hh)] = v;
                if (wg == 0) es[h % 2][bw_row(2 * hh)] = e[hh];
            }
        }
        __syncthreads();                  // red complete; the stage consumed
        if (h + 2 < H)
            bw_query_stage(tiles + L::ST + (h % 2) * L::STAGE, &full[h % 2],
                           a, h + 2, c, b, q0);
        if (tid < BW_T && q0 + tid < Q)
            a.rd[row * S + t0 + q0 + tid] =
                es[h % 2][tid] * (red[h % 2][0][tid] + red[h % 2][1][tid]);
    }
    bf* dC = (bf*)a.dC;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
            if (qr[hh] < Q)
                *reinterpret_cast<__nv_bfloat162*>(
                    dC + (pos0 + qr[hh]) * N + bw_col(nt)) =
                    __floats2bfloat162_rn(dc[4 * nt + 2 * hh],
                                          dc[4 * nt + 2 * hh + 1]);
}

// ---------------------------------------------------------------------------
// ssd_bwd_dt: d cs, its reverse running sum, ddt and dA's per-row part
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SB_THREADS) ssd_bwd_dt(SbArgs a) {
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int Q = a.Q, S = a.S, H = a.H, nt = a.nt;
    const size_t row = (size_t)b * H + h;
    const float A = a.A[h];
    __shared__ float dcs[SB_QMAX];
    __shared__ float wsum[SB_THREADS / 32];
    __shared__ float red[SB_THREADS / 32];
    float dap = 0.f;
    for (int c = 0; c < a.nc; ++c) {
        const int t0 = c * Q;
        const size_t base = row * a.nc + c;
        __syncthreads();                  // dcs and wsum free
        if (tid < Q) {
            const int q = tid;
            float v = 0.f;
            for (int jj = 0; jj <= q / SB_T; ++jj)
                v += a.rows[(base * nt + jj) * Q + q];
            v += a.ct[row * S + t0 + q] + a.rd[row * S + t0 + q];
            if (q == Q - 1) {
                for (int jj = 0; jj < nt; ++jj) v += a.lastp[base * nt + jj];
                for (int sp = 0; sp < a.splits; ++sp)
                    v += a.dcl[base * a.splits + sp];
            }
            dcs[q] = v;
        }
        __syncthreads();
        // thread tid takes q = Q - 1 - tid: an inclusive scan from the end
        const int q = Q - 1 - tid;
        float v = q >= 0 ? dcs[q] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane == 31) wsum[warp] = v;
        __syncthreads();
        for (int w = 0; w < warp; ++w) v += wsum[w];
        if (q >= 0) {
            const size_t at = ((size_t)b * S + t0 + q) * H + h;
            a.ddt[at] = fmaf(v, A, a.ddt[at]);
            dap = fmaf(v, a.dt[at], dap);
        }
    }
    const float tot = sb_block_sum(dap, red);
    if (tid == 0) a.dap[row] = tot;
}

__global__ void ssd_bwd_da(const float* __restrict__ dap,
                           float* __restrict__ dA, int B, int H) {
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    if (h >= H) return;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dap[(size_t)b * H + h];
    dA[h] = s;
}

// The tensor-core body for bf16 at (64, 128), the FMA body for the rest:
// fixed by the types, so no other pairing is built
template <typename T, int P, int N>
int launch(const SbArgs& a, cudaStream_t st) {
    constexpr bool MMA = sizeof(T) == 2 && P == SM_P && N == SM_N;
    cudaError_t err;
    if constexpr (MMA) {
        err = reserve_smem(ssd_bwd_states, BwStates::SMEM);
        if (err == cudaSuccess)
            err = reserve_smem(ssd_bwd_keys_mma, SmKeys::BYTES);
        if (err == cudaSuccess)
            err = reserve_smem(ssd_bwd_queries_wg, BwQueries::SMEM);
        if (err != cudaSuccess) return (int)err;
        ssd_bwd_states<<<dim3(a.H, a.B), SB_THREADS, BwStates::SMEM, st>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        ssd_bwd_keys_mma<<<a.nt * a.nc * a.B, SB_THREADS, SmKeys::BYTES,
                           st>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        ssd_bwd_queries_wg<<<dim3((a.Q + BW_T - 1) / BW_T, a.nc, a.B),
                             SB_THREADS, BwQueries::SMEM, st>>>(a);
    } else {
        const size_t chunk_smem =
            sizeof(float) * (2 * SB_QMAX + SB_K1 * (P + 1) + SB_K1 * (N + 1));
        auto k1 = ssd_bwd_chunk<T, P, N>;
        auto k3 = ssd_bwd_keys<T, P, N>;
        auto k4 = ssd_bwd_queries<T, P, N>;
        err = reserve_smem(k1, chunk_smem);
        if (err == cudaSuccess) err = reserve_smem(k3, SbKeys<P, N>::BYTES);
        if (err == cudaSuccess) err = reserve_smem(k4, SbQueries<P, N>::BYTES);
        if (err != cudaSuccess) return (int)err;
        k1<<<dim3(a.H, a.nc, a.B), SB_THREADS, chunk_smem, st>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        ssd_bwd_pass<T, P, N><<<dim3(a.H, a.B, SbPass<P, N>::SPLITS),
                                SB_THREADS, 0, st>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        k3<<<dim3(a.nt, a.nc, a.B), SB_THREADS, SbKeys<P, N>::BYTES, st>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        k4<<<dim3(a.nt, a.nc, a.B), SB_THREADS, SbQueries<P, N>::BYTES,
             st>>>(a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dt<<<dim3(a.H, a.B), SB_THREADS, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_da<<<(a.H + 127) / 128, 128, 0, st>>>(a.dap, a.dA, a.B, a.H);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(SbArgs a, int P, int N, cudaStream_t st) {
    if (P == 64 && N == 128) {
        a.splits = sizeof(T) == 2 ? 1 : SbPass<64, 128>::SPLITS;
        return launch<T, 64, 128>(a, st);
    }
    if (P == 32 && N == 16) {
        a.splits = SbPass<32, 16>::SPLITS;
        return launch<T, 32, 16>(a, st);
    }
    return REPRO_UNSUPPORTED;
}

}  // namespace

// x, dy (B, S, H, P), Bm, Cm (B, S, N) contiguous in the working type; dt
// (B, S, H) and A (H,) float32 contiguous; init and dfin (B, H, P, N)
// contiguous in the working type or (init_f32, dfin_f32) float32, or null
// for zeros.  Outputs: dx, dB, dC like x, Bm, Cm; ddt (B, S, H) and dA (H,)
// float32; dinit like init (null when init is).  ws: the f32 workspace of
// ssd_scan.ssd_bwd_workspace for this body, 16-byte aligned.  1 <= Q <= 256
// divides S; (P, N) in {(64, 128), (32, 16)}.  body: 0 the FMA body, 1 the
// tensor-core one, as ssd_scan.ssd_bwd_body chooses: 1 exactly for bf16 at
// (64, 128), which also needs x, Bm, Cm and dy on 16-byte boundaries; any
// other body is refused.  Launches the body's kernels on ``stream`` and
// returns the first cudaGetLastError() that is not cudaSuccess, or
// REPRO_UNSUPPORTED.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, const void* dy, const void* dfin,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit, void* ws,
    int B, int S, int H, int P, int N, int Q, int dtype, int init_f32,
    int dfin_f32, int body, void* stream) {
    const bool mma = dtype == REPRO_BF16 && P == SM_P && N == SM_N;
    if (B <= 0 || S <= 0 || H <= 0 || body != (int)mma)
        return REPRO_UNSUPPORTED;
    // the tensor-core body copies its rows in 16-byte pieces
    if (mma && ((size_t)x | (size_t)Bm | (size_t)Cm | (size_t)dy | (size_t)ws)
                   % 16 != 0)
        return REPRO_UNSUPPORTED;
    if (Q < 1 || Q > SB_QMAX || S % Q != 0) return REPRO_UNSUPPORTED;
    const int nc = S / Q, nt = (Q + SB_T - 1) / SB_T;
    const size_t bhs = (size_t)B * H * S, bhc = (size_t)B * H * nc;
    // the states: f32, or three bf16 parts (1.5 f32 values an entry)
    const size_t state = bhc * P * N * (mma ? 3 : 2) / 2;
    float* w = (float*)ws;
    SbArgs a;
    a.x = x; a.dt = (const float*)dt; a.A = (const float*)A; a.Bm = Bm;
    a.Cm = Cm; a.init = init; a.dy = dy; a.dfin = dfin; a.dx = dx;
    a.ddt = (float*)ddt; a.dA = (float*)dA; a.dB = dB; a.dC = dC;
    a.dinit = init != nullptr ? dinit : nullptr;
    a.st = w;
    a.rt = a.st + state;
    a.cs = a.rt + state;
    a.ct = a.cs + bhs;
    a.rd = a.ct + bhs;
    a.dg = a.rd + bhs;
    a.rows = a.dg + (size_t)B * nc * Q * Q;
    a.lastp = a.rows + bhc * nt * Q;
    a.dcl = a.lastp + bhc * nt;
    a.dap = a.dcl + bhc * (mma ? 1 : SB_PASS_SPLITS);
    a.B = B; a.S = S; a.H = H; a.Q = Q; a.nc = nc; a.nt = nt;
    a.init_f32 = init_f32; a.dfin_f32 = dfin_f32;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_BF16) return launch_dims<__nv_bfloat16>(a, P, N, st);
    if (dtype == REPRO_F32) return launch_dims<float>(a, P, N, st);
    return REPRO_UNSUPPORTED;
}
