// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py, function ssd_scan
// (:70, Pallas body _kernel :22-67), and computes what the oracle
// ref.ssd_scan (src/repro/kernels/ref.py:282-335) computes, init_state
// included (the Pallas kernel asserts it is None; serving prefill passes
// one).  For x (B, S, H, P), dt (B, S, H) float32, A (H,) float32, Bm and
// Cm (B, S, N) shared by the heads, chunks of Q positions and cs the
// running sum of dt * A inside a chunk:
//   y_q   = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k
//         + exp(cs_q) C_q . S^T                 (S: state at chunk start)
//   S    <- exp(cs_last) S + sum_k (x_k dt_k exp(cs_last - cs_k))^T B_k
// Sums in float32; y and the final state rounded once to x's type.
//
// What bounds it on the H100: at serving shapes, operations on this
// design.  The visible work (perf_model.ssd_scan_cost) is ~4 Q N + 4 Q P
// + 2 Q^2 (N + P) / 2 flops a (position, head) over ~2 P + 2 N / H bytes,
// far above the card's ~20 float32 flops a byte, so the first kernel is
// bound by its float32 FMAs and shared-memory loads, not by HBM.
//
// Design.  The TPU grid steps (b*h, chunk) in order with the (P, N) state
// in VMEM scratch.  Here one thread block takes one (b, h) and walks its
// chunks in order, the float32 state in shared memory (32 KB at P = 64,
// N = 128), so nothing carries between blocks.  Per chunk: the dt tile
// and a block-wide inclusive scan of dt * A; then per 64-query tile the
// read-out of the old state (exp(cs_q) C_q . S^T), and per 64-key tile up
// to the diagonal the score tile C B^T over N, decayed and causally
// masked, times the dt-scaled x tile; then, after every query tile has
// read the old state, the state update over 64-key tiles.  Each thread
// keeps a 4 x (P / 16) tile of y (and of the scores a 4 x 4 tile) in
// registers; C and B tiles are stored n-major with a padded row so the
// coalesced global loads write them without bank conflicts.  Q is any
// divisor of S from 1 to 256: rows and keys past Q are zero-filled and
// masked.  Positions with dt = 0 (a prompt's padding) give exp(0) = 1 and
// no input, exactly.  FMAs only, for bf16 too: the decayed scores and the
// state are not bf16 values, and rounding either breaks the parity rule.
// Next: the C B^T tile on the tensor cores (exact in bf16) shared by the
// heads of a row, chunk-parallel states, wgmma and TMA.

#include "common.cuh"

namespace {

constexpr int SSD_THREADS = 256;
constexpr int SSD_T = 64;               // query and key tile
constexpr int SSD_TL = SSD_T + 1;       // padded n-major row of C/B tiles
constexpr int SSD_QMAX = 256;           // chunk length <= threads

template <int P, int N>
struct SsdLayout {
    static_assert(P % 16 == 0 && N % 16 == 0, "P, N multiples of 16");
    static constexpr int ST = N * P;            // state, n-major
    static constexpr int CT = N * SSD_TL;       // C tile, n-major
    static constexpr int BT = N * SSD_TL;       // B tile, n-major
    static constexpr int XS = SSD_T * P;        // x tile (k, p)
    static constexpr int GS = SSD_T * SSD_TL;   // score tile (q, k)
    static constexpr int FLOATS = ST + CT + BT + XS + GS + 2 * SSD_QMAX + 8;
    static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
};

struct SsdArgs {
    const void* x;          // (B, S, H, P), p contiguous
    const float* dt;        // (B, S, H)
    const float* A;         // (H,)
    const void* Bm;         // (B, S, N), n contiguous
    const void* Cm;         // (B, S, N), n contiguous
    const void* init;       // (B, H, P, N) contiguous, or null
    void* y;                // (B, S, H, P) contiguous
    void* fin;              // (B, H, P, N) contiguous
    int S, H, Q, init_f32;
    long long xb, xs, xh, db, ds, dh, bb, bs, cb, cs;   // element strides
};

// Load the keys [k0, k0 + T) of a chunk starting at t0: B into Bt (n-major)
// and x * scale_k into Xs (k-major), zero past Q.  ``decay_to`` < 0: scale
// dt_k; else dt_k exp(cs[decay_to] - cs_k) (the state update's weights).
template <typename T, int P, int N>
__device__ __forceinline__ void ssd_load_keys(
    const SsdArgs& a, int b, int h, int t0, int k0, const float* dts,
    const float* cs, int decay_to, float* Bt, float* Xs) {
    const T* Bm = (const T*)a.Bm;
    const T* x = (const T*)a.x;
    for (int e = threadIdx.x; e < SSD_T * N; e += SSD_THREADS) {
        const int kk = e / N, n = e % N, k = k0 + kk;
        Bt[n * SSD_TL + kk] = k < a.Q
            ? to_f(Bm[b * a.bb + (long long)(t0 + k) * a.bs + n]) : 0.f;
    }
    for (int e = threadIdx.x; e < SSD_T * P; e += SSD_THREADS) {
        const int kk = e / P, p = e % P, k = k0 + kk;
        float v = 0.f;
        if (k < a.Q) {
            float s = dts[k];
            if (decay_to >= 0) s *= expf(cs[decay_to] - cs[k]);
            v = to_f(x[b * a.xb + (long long)(t0 + k) * a.xs + h * a.xh + p])
                * s;
        }
        Xs[e] = v;
    }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_kernel(SsdArgs a) {
    using L = SsdLayout<P, N>;
    constexpr int PJ = P / 16, NI = N / 16;
    const int h = blockIdx.x, b = blockIdx.y, H = a.H, Q = a.Q;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    extern __shared__ __align__(16) float sm[];
    float* St = sm;                 // [N][P]
    float* Ct = St + L::ST;         // [N][SSD_TL]
    float* Bt = Ct + L::CT;         // [N][SSD_TL]
    float* Xs = Bt + L::BT;         // [SSD_T][P]
    float* Gs = Xs + L::XS;         // [SSD_T][SSD_TL]
    float* cs = Gs + L::GS;         // [SSD_QMAX]
    float* dts = cs + SSD_QMAX;     // [SSD_QMAX]
    float* wsum = dts + SSD_QMAX;   // [8] warp totals of the scan
    const float A = a.A[h];
    const T* Cm = (const T*)a.Cm;
    T* y = (T*)a.y;

    for (int e = tid; e < N * P; e += SSD_THREADS) {
        const int n = e / P, p = e % P;
        float v = 0.f;
        if (a.init != nullptr) {
            const long long off = (((long long)b * H + h) * P + p) * N + n;
            v = a.init_f32 ? ((const float*)a.init)[off]
                           : to_f(((const T*)a.init)[off]);
        }
        St[e] = v;
    }

    for (int t0 = 0; t0 < a.S; t0 += Q) {
        // 1. dt of the chunk and the inclusive scan of dt * A
        __syncthreads();                      // the last chunk is done
        float v = 0.f;
        if (tid < Q) {
            const float d = a.dt[b * a.db + (long long)(t0 + tid) * a.ds
                                 + h * a.dh];
            dts[tid] = d;
            v = d * A;
        }
        const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane == 31) wsum[warp] = v;
        __syncthreads();
        for (int w = 0; w < warp; ++w) v += wsum[w];
        if (tid < Q) cs[tid] = v;
        __syncthreads();

        // 2. the outputs, one tile of 64 queries at a time
        for (int q0 = 0; q0 < Q; q0 += SSD_T) {
            __syncthreads();                  // Ct free
            for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
                const int qq = e / N, n = e % N, q = q0 + qq;
                Ct[n * SSD_TL + qq] = q < Q
                    ? to_f(Cm[b * a.cb + (long long)(t0 + q) * a.cs + n])
                    : 0.f;
            }
            __syncthreads();
            float acc[4][PJ];
            // read-out of the state at the chunk's start
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int j = 0; j < PJ; ++j) acc[r][j] = 0.f;
            for (int n = 0; n < N; ++n) {
                float cv[4], sv[PJ];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = Ct[n * SSD_TL + ty * 4 + r];
#pragma unroll
                for (int j = 0; j < PJ; ++j) sv[j] = St[n * P + tx + 16 * j];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int j = 0; j < PJ; ++j) acc[r][j] += cv[r] * sv[j];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int q = q0 + ty * 4 + r;
                const float dq = q < Q ? expf(cs[q]) : 0.f;
#pragma unroll
                for (int j = 0; j < PJ; ++j) acc[r][j] *= dq;
            }
            // the chunk's own keys up to the diagonal
            for (int k0 = 0; k0 <= q0; k0 += SSD_T) {
                __syncthreads();              // Bt, Xs, Gs free
                ssd_load_keys<T, P, N>(a, b, h, t0, k0, dts, cs, -1, Bt, Xs);
                __syncthreads();
                float g[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
                for (int n = 0; n < N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        cv[r] = Ct[n * SSD_TL + ty * 4 + r];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        bv[c] = Bt[n * SSD_TL + tx + 16 * c];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) g[r][c] += cv[r] * bv[c];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int q = q0 + ty * 4 + r;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int k = k0 + tx + 16 * c;
                        Gs[(ty * 4 + r) * SSD_TL + tx + 16 * c] =
                            (q < Q && k <= q)
                                ? g[r][c] * expf(cs[q] - cs[k]) : 0.f;
                    }
                }
                __syncthreads();
                for (int kk = 0; kk < SSD_T; ++kk) {
                    float gv[4], xv[PJ];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        gv[r] = Gs[(ty * 4 + r) * SSD_TL + kk];
#pragma unroll
                    for (int j = 0; j < PJ; ++j) xv[j] = Xs[kk * P + tx + 16 * j];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int j = 0; j < PJ; ++j) acc[r][j] += gv[r] * xv[j];
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int q = q0 + ty * 4 + r;
                if (q >= Q) continue;
                T* yr = y + (((long long)b * a.S + t0 + q) * H + h) * P;
#pragma unroll
                for (int j = 0; j < PJ; ++j)
                    yr[tx + 16 * j] = from_f<T>(acc[r][j]);
            }
        }

        // 3. the state update, after every query tile read the old state
        float su[NI][PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) su[i][j] = 0.f;
        for (int k0 = 0; k0 < Q; k0 += SSD_T) {
            __syncthreads();                  // Bt, Xs free
            ssd_load_keys<T, P, N>(a, b, h, t0, k0, dts, cs, Q - 1, Bt, Xs);
            __syncthreads();
            for (int kk = 0; kk < SSD_T; ++kk) {
                float bv[NI], xv[PJ];
#pragma unroll
                for (int i = 0; i < NI; ++i)
                    bv[i] = Bt[(ty + 16 * i) * SSD_TL + kk];
#pragma unroll
                for (int j = 0; j < PJ; ++j) xv[j] = Xs[kk * P + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < NI; ++i)
#pragma unroll
                    for (int j = 0; j < PJ; ++j) su[i][j] += xv[j] * bv[i];
            }
        }
        const float dec = expf(cs[Q - 1]);
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
                float& s = St[(ty + 16 * i) * P + tx + 16 * j];
                s = dec * s + su[i][j];       // this thread's own entries
            }
    }
    __syncthreads();
    T* fin = (T*)a.fin;
    for (int e = tid; e < P * N; e += SSD_THREADS) {
        const int p = e / N, n = e % N;
        fin[(((long long)b * H + h) * P + p) * N + n] = from_f<T>(St[n * P + p]);
    }
}

template <typename T, int P, int N>
int launch(const SsdArgs& a, int B, cudaStream_t stream) {
    auto kernel = ssd_scan_kernel<T, P, N>;
    cudaError_t err = reserve_smem(kernel, SsdLayout<P, N>::BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(a.H, B), SSD_THREADS, SsdLayout<P, N>::BYTES, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const SsdArgs& a, int B, int P, int N, cudaStream_t stream) {
    if (P == 64 && N == 128) return launch<T, 64, 128>(a, B, stream);
    if (P == 32 && N == 16) return launch<T, 32, 16>(a, B, stream);
    return REPRO_UNSUPPORTED;
}

}  // namespace

// x (B, S, H, P) and Bm, Cm (B, S, N) in the working type with their last
// dim contiguous and the other strides given in elements; dt (B, S, H)
// float32 with strides; A (H,) float32; init (B, H, P, N) contiguous in the
// working type (init_f32 = 0) or float32 (init_f32 = 1), or null for a zero
// state; y (B, S, H, P) and fin (B, H, P, N) contiguous in the working
// type.  1 <= Q <= 256 divides S; (P, N) in {(64, 128), (32, 16)}.
// Returns cudaGetLastError() after the launch, or REPRO_UNSUPPORTED.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, void* y, void* fin, int B, int S,
    int H, int P, int N, int Q, int dtype, int init_f32, long long xb,
    long long xs, long long xh, long long db, long long ds, long long dh,
    long long bb, long long bs, long long cb, long long cs, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0) return REPRO_UNSUPPORTED;
    if (Q < 1 || Q > SSD_QMAX || S % Q != 0) return REPRO_UNSUPPORTED;
    SsdArgs a{x, (const float*)dt, (const float*)A, Bm, Cm, init, y, fin,
              S, H, Q, init_f32, xb, xs, xh, db, ds, dh, bb, bs, cb, cs};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_BF16) return launch_dims<__nv_bfloat16>(a, B, P, N, st);
    if (dtype == REPRO_F32) return launch_dims<float>(a, B, P, N, st);
    return REPRO_UNSUPPORTED;
}
