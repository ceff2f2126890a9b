// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py, function
// rglru_scan (:66, pl.pallas_call :76), and computes what its oracle
// ref.rglru_scan (src/repro/kernels/ref.py:359) computes, init_state
// included (the Pallas kernel refuses one; serving prefill passes one):
//
//   log_at = c * log_a * a_gate,  a_t = exp(log_at),
//   beta_t = sqrt(-expm1(2 log_at)),
//   h_t = a_t h_{t-1} + beta_t (input_gate_t x_t),  h_{-1} = init or 0,
//
// all in f32, h and the final state written in x's type.  expm1f keeps
// beta exact where a_t is near 1 (1 - expf would cancel), and a_gate = 0
// (padding past a row's limit) gives log_at = -0, a_t = 1 and beta =
// sqrtf(-expm1f(-0)) = sqrtf(0) = 0: the state passes through exactly.
//
// What bounds it on the H100: bytes.  Per element it reads three inputs
// and writes one output (8 bytes in bf16) for about ten flops, far below
// the ~20 flops per byte where the card's f32 units would bind; but the
// recurrence is sequential in t, so the walk is latency-bound unless
// enough independent channels keep loads in flight.
//
// Design.  The TPU kernel steps a sequential grid over blocks of the
// sequence with the (1, W) state in VMEM scratch, and solves each block
// with a log-depth associative scan on the vector unit.  On Hopper the
// channels are independent, so one thread owns one (row, channel) and
// walks t in order with its carry in a register: no shared memory, no
// barrier, no carry between blocks.  A warp's 32 threads are 32
// consecutive channels, so every load and store is coalesced along W.  The
// inputs of the next RG_U steps are loaded while the current RG_U are
// folded in (two register buffers), and the gates of those steps (exp,
// expm1, sqrt) do not depend on the carry, so only one FMA per step sits
// on the dependent chain.
//
// Known limits, left for a later change: at a serving prefill call
// (4 rows x 2560 channels) there are 10240 threads, under 3 warps an SM,
// too few loads in flight to reach the byte bound; and each thread walks
// all S steps.  A chunked scan with parallel carries (a chunk's local
// scan, then the carries of the chunks, then a fix-up) is the fix.

#include "common.cuh"

namespace {

constexpr int RG_THREADS = 64;   // channels per block
constexpr int RG_U = 16;         // steps whose inputs are loaded together

template <typename T>
struct RgIn {                    // one row's input at channel w, strided
    const T* __restrict__ p;
    long long ss;                // stride between steps, elements
    __device__ __forceinline__ T at(int t) const {
        return p[(long long)t * ss];
    }
};

template <typename T>
__device__ __forceinline__ void rg_load(T (&x)[RG_U], T (&ig)[RG_U],
                                        T (&ag)[RG_U], const RgIn<T>& xi,
                                        const RgIn<T>& ii, const RgIn<T>& ai,
                                        int t0, int S) {
#pragma unroll
    for (int u = 0; u < RG_U; ++u) {
        const int t = t0 + u;
        if (t < S) {
            x[u] = xi.at(t);
            ig[u] = ii.at(t);
            ag[u] = ai.at(t);
        } else {
            x[u] = from_f<T>(0.f);
            ig[u] = x[u];
            ag[u] = x[u];
        }
    }
}

template <typename T, typename S0>
__global__ void __launch_bounds__(RG_THREADS) rglru_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ ig,
    const T* __restrict__ ag,        // (B, S, W), strided over (B, S)
    const float* __restrict__ log_a, // (W,)
    const S0* __restrict__ init,     // (B, W) or null
    T* __restrict__ h,               // (B, S, W)
    T* __restrict__ fin,             // (B, W)
    int S, int W, long long xb, long long xs, long long ib, long long is,
    long long ab, long long as, float c) {
    const int w = blockIdx.x * RG_THREADS + threadIdx.x;
    const int b = blockIdx.y;
    if (w >= W) return;
    const RgIn<T> xi{x + b * xb + w, xs}, ii{ig + b * ib + w, is},
        ai{ag + b * ab + w, as};
    T* hp = h + (size_t)b * S * W + w;
    const float cla = c * log_a[w];
    float carry = init != nullptr ? to_f(init[(size_t)b * W + w]) : 0.f;

    T cx[RG_U], ci[RG_U], ca[RG_U];
    rg_load(cx, ci, ca, xi, ii, ai, 0, S);
    for (int t0 = 0; t0 < S; t0 += RG_U) {
        T nx[RG_U], ni[RG_U], na[RG_U];    // the next steps' loads, in flight
        rg_load(nx, ni, na, xi, ii, ai, t0 + RG_U, S);
#pragma unroll
        for (int u = 0; u < RG_U; ++u) {
            const float log_at = cla * to_f(ca[u]);
            const float a_t = expf(log_at);
            const float beta = sqrtf(-expm1f(2.f * log_at));
            const float bt = beta * (to_f(ci[u]) * to_f(cx[u]));
            carry = a_t * carry + bt;
            if (t0 + u < S) hp[(size_t)(t0 + u) * W] = from_f<T>(carry);
        }
#pragma unroll
        for (int u = 0; u < RG_U; ++u) {
            cx[u] = nx[u];
            ci[u] = ni[u];
            ca[u] = na[u];
        }
    }
    fin[(size_t)b * W + w] = from_f<T>(carry);
}

template <typename T, typename S0>
int launch(const void* x, const void* ig, const void* ag, const float* log_a,
           const void* init, void* h, void* fin, int B, int S, int W,
           long long xb, long long xs, long long ib, long long is,
           long long ab, long long as, float c, cudaStream_t stream) {
    const dim3 grid((W + RG_THREADS - 1) / RG_THREADS, B);
    rglru_scan_kernel<T, S0><<<grid, RG_THREADS, 0, stream>>>(
        (const T*)x, (const T*)ig, (const T*)ag, log_a, (const S0*)init,
        (T*)h, (T*)fin, S, W, xb, xs, ib, is, ab, as, c);
    return (int)cudaGetLastError();
}

}  // namespace

// x, ig, ag (B, S, W) in dtype with unit stride along W and strides
// (xb, xs), (ib, is), (ab, as) elements along (B, S); log_a (W,) f32; init
// (B, W) contiguous, in dtype or (init_f32) f32, or null for zeros; h
// (B, S, W) and fin (B, W) contiguous in dtype.  Returns cudaGetLastError()
// after the launch, or REPRO_UNSUPPORTED.
extern "C" int rglru_scan_launch(
    const void* x, const void* ig, const void* ag, const void* log_a,
    const void* init, void* h, void* fin, int B, int S, int W, int dtype,
    int init_f32, long long xb, long long xs, long long ib, long long is,
    long long ab, long long as, float c, void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return REPRO_UNSUPPORTED;
    const float* la = (const float*)log_a;
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(TYPE, STATE)                                              \
    return launch<TYPE, STATE>(x, ig, ag, la, init, h, fin, B, S, W, xb, xs, \
                               ib, is, ab, as, c, st)
    if (dtype == REPRO_F32) REPRO_CASE(float, float);
    if (dtype == REPRO_BF16 && init_f32) REPRO_CASE(__nv_bfloat16, float);
    if (dtype == REPRO_BF16) REPRO_CASE(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_CASE
    return REPRO_UNSUPPORTED;
}
