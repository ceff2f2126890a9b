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
// the ~20 flops per byte where the card's f32 units would bind.  The
// recurrence is sequential in t, so the design is about keeping enough
// independent loads in flight while the carry walks the time axis.
//
// Design.  The TPU kernel steps a sequential grid over blocks of the
// sequence with the (1, W) state in VMEM scratch, and solves each block
// with a log-depth associative scan on the vector unit.  Here one block
// takes (row, tile of 32 channels) and walks S in segments of RG_NW x RG_L
// steps, its RG_NW warps each taking RG_L consecutive steps of a segment
// (lane l: channel l of the tile, so a warp's load of one step is 64
// contiguous bytes in bf16).  In each segment:
//   - each warp scans its RG_L steps from a zero carry, keeping the local
//     h and the running product of a_t of every step in registers;
//   - the warps' chunk pairs (prod a, local h at the chunk's end) meet in
//     shared memory (double-buffered, one barrier a segment), and every
//     warp folds those of the warps before it into the segment's carry to
//     get its carry-in, and all of them to get the next segment's carry;
//   - each warp writes h_t = local_t + prod_t carry_in (one fmaf a step,
//     none of them on a dependent chain).
// The next segment's loads are issued before this segment's math, and the
// gates never wait on a carry.  One read and one write of each element,
// one launch.  Steps past S load zeros, which pass the carry through
// exactly, so the last segment's carry is the final state.  A padding step
// leaves the product (x 1) and the local sum (+ 0) unchanged and the
// fix-up and the carry fold are the same fmaf, so the final state of a
// padded row equals its state at the limit bit for bit.  The rounding
// order is "chunks, then carries", neither the plain version's log-depth
// tree nor a walk in order; f32 and bf16 share the body (f32 arithmetic,
// no tensor cores), and only the gates' functions differ (rg_gates).
//
// RG_NW = 4, RG_L = 8, one channel a thread, chosen on an H100 with
// kernel_ab.py at a serving prefill call (4 rows x 256 x 2560: 320 blocks
// of 128 threads walking 8 segments) and the Generator prefill (8 x 1024:
// 640 blocks walking 32; PERF.md section 6).  Against it, in one call
// each: two channels a thread (bf16x2 loads, half the blocks) ran 1.4x
// and 2.0x slower; 8 warps ran as fast at the serving call and 1.09x
// slower at the Generator (with chunks of 4 steps 0.96x and 1.07x); 4
// warps with chunks of 4 steps 1.12x and 1.08x; the library's expf,
// expm1f and sqrtf in bf16 1.4x and 1.2x slower.

#include "common.cuh"

namespace {

constexpr int RG_NW = 4;                 // warps a block: a segment's chunks
constexpr int RG_L = 8;                  // steps a warp's chunk
constexpr int RG_THREADS = RG_NW * 32;   // one channel a lane

template <typename T>
struct RgIn {                    // one row's input at this lane's channel
    const T* __restrict__ p;
    long long ss;                // stride between steps, elements
    __device__ __forceinline__ T at(int t) const {
        return p[(long long)t * ss];
    }
};

// The inputs of steps t0 .. t0 + RG_L - 1; zeros at and past S (and for a
// lane past W), which pass the carry through.
template <typename T>
__device__ __forceinline__ void rg_load(T (&x)[RG_L], T (&ig)[RG_L],
                                        T (&ag)[RG_L], const RgIn<T>& xi,
                                        const RgIn<T>& ii, const RgIn<T>& ai,
                                        int t0, int S, bool live) {
#pragma unroll
    for (int u = 0; u < RG_L; ++u) {
        if (live && t0 + u < S) {
            x[u] = xi.at(t0 + u);
            ig[u] = ii.at(t0 + u);
            ag[u] = ai.at(t0 + u);
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
    constexpr int SEG = RG_NW * RG_L;
    __shared__ float a_s[2][RG_NW][32], b_s[2][RG_NW][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int w = blockIdx.x * 32 + lane;
    const int b = blockIdx.y;
    const bool live = w < W;
    const int wl = live ? w : 0;
    const RgIn<T> xi{x + b * xb + wl, xs}, ii{ig + b * ib + wl, is},
        ai{ag + b * ab + wl, as};
    T* hp = h + (size_t)b * S * W + wl;
    const float cla = live ? c * log_a[w] : 0.f;
    float carry = live && init != nullptr ? to_f(init[(size_t)b * W + w])
                                          : 0.f;

    T cx[RG_L], ci[RG_L], ca[RG_L];
    rg_load(cx, ci, ca, xi, ii, ai, warp * RG_L, S, live);
    for (int s0 = 0, buf = 0; s0 < S; s0 += SEG, buf ^= 1) {
        T nx[RG_L], ni[RG_L], na[RG_L];    // the next segment's loads
        rg_load(nx, ni, na, xi, ii, ai, s0 + SEG + warp * RG_L, S, live);
        // this warp's chunk from a zero carry: local h and prod a
        float loc[RG_L], pr[RG_L];
#pragma unroll
        for (int u = 0; u < RG_L; ++u) {
            float a_t, beta;
            rg_gates<T>(cla * to_f(ca[u]), a_t, beta);
            const float bt = beta * (to_f(ci[u]) * to_f(cx[u]));
            loc[u] = u == 0 ? bt : fmaf(a_t, loc[u - 1], bt);
            pr[u] = u == 0 ? a_t : pr[u - 1] * a_t;
        }
        a_s[buf][warp][lane] = pr[RG_L - 1];
        b_s[buf][warp][lane] = loc[RG_L - 1];
        __syncthreads();
        // the carry into this warp's chunk, and out of the segment
        float cin = carry;
#pragma unroll
        for (int v = 0; v < RG_NW; ++v) {
            if (v == warp) cin = carry;
            carry = fmaf(a_s[buf][v][lane], carry, b_s[buf][v][lane]);
        }
        const int t0 = s0 + warp * RG_L;
#pragma unroll
        for (int u = 0; u < RG_L; ++u)
            if (live && t0 + u < S)
                hp[(size_t)(t0 + u) * W] = from_f<T>(fmaf(pr[u], cin,
                                                          loc[u]));
#pragma unroll
        for (int u = 0; u < RG_L; ++u) {
            cx[u] = nx[u];
            ci[u] = ni[u];
            ca[u] = na[u];
        }
    }
    if (live && warp == 0) fin[(size_t)b * W + w] = from_f<T>(carry);
}

template <typename T, typename S0>
int launch(const void* x, const void* ig, const void* ag, const float* log_a,
           const void* init, void* h, void* fin, int B, int S, int W,
           long long xb, long long xs, long long ib, long long is,
           long long ab, long long as, float c, cudaStream_t stream) {
    const dim3 grid((W + 31) / 32, B);
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
