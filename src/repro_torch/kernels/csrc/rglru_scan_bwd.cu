// Backward of the RG-LRU gated linear recurrence (rglru_scan.cu) for
// Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan, :66) has no
// backward: the reference differentiates its oracle ref.rglru_scan
// (src/repro/kernels/ref.py:359, an associative scan) with jax.grad.  Here
// the forward runs as a kernel behind a torch.autograd.Function
// (rglru_scan.RGLRUScanFn), and this file is its backward, the
// counterpart of jax.vjp through the oracle.  With log_at = c log_a a_gate,
// a_t = exp(log_at), beta_t = sqrt(-expm1(2 log_at)) and h the forward's
// f32 state:
//
//   g_t = dh_t + a_{t+1} g_{t+1},  g_{S-1} = dh_{S-1} + dfin
//   d log_at = g_t h_{t-1} a_t - g_t (i_t x_t) a_t^2 / beta_t
//   dx = g beta i,  d input_gate = g beta x,  d a_gate = d log_at c log_a,
//   d log_a = sum_{b,t} d log_at c a_gate,  d init = a_0 g_0.
//
// What bounds it on the H100: bytes.  Per element it reads x, input_gate
// and a_gate twice (the carries' pass and the backward's) and dh once, and
// writes three gradients: 10 elements, 20 bytes in bf16, for some 40
// flops.  At recurrentgemma-2b's train shape (one row of 2560 channels)
// the grid is only 80 blocks, so what sets the time is how many loads
// each SM keeps in flight while the carries walk the sequence twice:
// RG_NW = 8 warps a block, twice the forward kernel's (with its 4 this
// backward took 1.2277 ms there on an H100 80GB HBM3 at 700 W; PERF.md
// section 6).
//
// Design.  The forward returns h rounded to bf16, and d log_at needs
// h_{t-1} in f32, so the backward recomputes it: one block per (row, tile
// of 32 channels), as the forward kernel's, first walks the sequence
// forward in segments of RG_NW x RG_L steps (the forward's time-parallel
// carries: each warp scans its RG_L steps from a zero carry, the warps'
// (prod a, local h) pairs fold through shared memory) and writes the f32
// carry into each segment to the workspace; then walks the segments in
// reverse.  In each it recomputes h from the segment's carry in the same
// way, and runs the adjoint's recurrence, a reverse linear recurrence in
// the coefficients a'_t = a_{t+1}, by the same scheme with time reversed:
// each warp scans its steps backwards from a zero carry, keeping the local
// g and the running product of a', the warps' pairs fold from the last
// warp to the first, and g_t = local_t + prod_t carry_in.  a'_t of a warp's
// last step is the next warp's first a_t (through shared memory), or the
// next segment's (kept from the segment walked before), 1 past the end
// (where g carries dfin).  Each thread keeps its channel's d log_a sum; the
// warps' sums meet in shared memory, the rows' in a second kernel, in a
// fixed order (no atomics: the backward replays bit for bit).  a_t and
// beta_t come from the forward's own gate functions (rg_gates in
// common.cuh: the library's in f32, a polynomial and sqrt.approx in
// bf16), so the recomputed h is the forward's.

#include "common.cuh"

namespace {

constexpr int RG_NW = 8;                 // warps a block: a segment's chunks
constexpr int RG_L = 8;                  // steps a warp's chunk
constexpr int RG_THREADS = RG_NW * 32;   // one channel a lane
constexpr int RG_SEG = RG_NW * RG_L;     // rglru_scan.RG_BWD_SEG

struct RbArgs {
    const void* x; const void* ig; const void* ag;   // (B, S, W) contiguous
    const float* log_a;                              // (W,)
    const void* init;                                // (B, W) or null
    const void* dh;                                  // (B, S, W)
    const void* dfin;                                // (B, W) or null
    void* dx; void* dig; void* dag;                  // (B, S, W)
    void* dinit;                                     // (B, W) or null
    float* carries;                                  // (B, nseg, W)
    float* part;                                     // (B, W) d log_a
    int S, W, nseg, init_f32, dfin_f32;
    float c;
};

template <typename T>
__device__ __forceinline__ float rb_state(const void* p, int is_f32,
                                          size_t i) {
    return is_f32 ? ((const float*)p)[i] : to_f(((const T*)p)[i]);
}

// One warp's RG_L steps from t0, from a zero carry: the inputs (zeros at
// and past S, which pass a carry through: a = 1, beta = 0), the gates,
// the local h and the running product of a.
template <typename T>
struct RbChunk {
    float x[RG_L], ig[RG_L], ag[RG_L], a[RG_L], beta[RG_L], loc[RG_L],
        pr[RG_L];

    __device__ __forceinline__ void run(const T* xp, const T* ip,
                                        const T* ap, int t0, int S, int W,
                                        bool live, float cla) {
#pragma unroll
        for (int u = 0; u < RG_L; ++u) {
            x[u] = ig[u] = ag[u] = 0.f;
            if (live && t0 + u < S) {
                const size_t i = (size_t)(t0 + u) * W;
                x[u] = to_f(xp[i]);
                ig[u] = to_f(ip[i]);
                ag[u] = to_f(ap[i]);
            }
        }
#pragma unroll
        for (int u = 0; u < RG_L; ++u) {
            rg_gates<T>(cla * ag[u], a[u], beta[u]);
            const float bt = beta[u] * (ig[u] * x[u]);
            loc[u] = u == 0 ? bt : fmaf(a[u], loc[u - 1], bt);
            pr[u] = u == 0 ? a[u] : pr[u - 1] * a[u];
        }
    }
};

template <typename T>
__global__ void __launch_bounds__(RG_THREADS) rglru_bwd_kernel(RbArgs r) {
    // the warps' chunk pairs: forward (prod a, local h), reverse (prod a',
    // local g); each warp's first a; the warps' d log_a sums
    __shared__ float a_s[RG_NW][32], b_s[RG_NW][32], ra_s[RG_NW][32],
        rb_s[RG_NW][32], f_s[RG_NW][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int w = blockIdx.x * 32 + lane, b = blockIdx.y;
    const int S = r.S, W = r.W;
    const bool live = w < W;
    const int wl = live ? w : 0;
    const size_t base = (size_t)b * S * W + wl;
    const T* xp = (const T*)r.x + base;
    const T* ip = (const T*)r.ig + base;
    const T* ap = (const T*)r.ag + base;
    const T* dhp = (const T*)r.dh + base;
    const float la = live ? r.log_a[w] : 0.f;
    const float cla = r.c * la;
    float* carries = r.carries + (size_t)b * r.nseg * W + wl;
    RbChunk<T> ch;

    // 1. forward: the f32 carry into every segment
    float carry = live && r.init != nullptr
        ? rb_state<T>(r.init, r.init_f32, (size_t)b * W + w) : 0.f;
    for (int s = 0; s < r.nseg; ++s) {
        if (live && warp == 0) carries[(size_t)s * W] = carry;
        ch.run(xp, ip, ap, s * RG_SEG + warp * RG_L, S, W, live, cla);
        a_s[warp][lane] = ch.pr[RG_L - 1];
        b_s[warp][lane] = ch.loc[RG_L - 1];
        __syncthreads();
#pragma unroll
        for (int v = 0; v < RG_NW; ++v)
            carry = fmaf(a_s[v][lane], carry, b_s[v][lane]);
        __syncthreads();                  // a_s, b_s free
    }

    // 2. backward, the segments in reverse
    float gcarry = live && r.dfin != nullptr
        ? rb_state<T>(r.dfin, r.dfin_f32, (size_t)b * W + w) : 0.f;
    float a_next = 1.f;                   // a of the step after the segment
    float dla = 0.f;
    T* dxp = (T*)r.dx + base;
    T* dip = (T*)r.dig + base;
    T* dap = (T*)r.dag + base;
    for (int s = r.nseg - 1; s >= 0; --s) {
        const int t0 = s * RG_SEG + warp * RG_L;
        ch.run(xp, ip, ap, t0, S, W, live, cla);
        float dh[RG_L];
#pragma unroll
        for (int u = 0; u < RG_L; ++u)
            dh[u] = live && t0 + u < S ? to_f(dhp[(size_t)(t0 + u) * W]) : 0.f;
        a_s[warp][lane] = ch.pr[RG_L - 1];
        b_s[warp][lane] = ch.loc[RG_L - 1];
        f_s[warp][lane] = ch.a[0];
        __syncthreads();
        // h's carry into this warp's chunk, folded from the segment's
        float cin = carries[(size_t)s * W];
        for (int v = 0; v < warp; ++v)
            cin = fmaf(a_s[v][lane], cin, b_s[v][lane]);
        // the adjoint's local reverse scan in a'_t = a_{t+1}
        const float a_last = warp + 1 < RG_NW ? f_s[warp + 1][lane] : a_next;
        float gl[RG_L], gp[RG_L];         // local g, prod of a' to the end
#pragma unroll
        for (int u = RG_L - 1; u >= 0; --u) {
            const float an = u == RG_L - 1 ? a_last : ch.a[u + 1];
            gl[u] = u == RG_L - 1 ? dh[u] : fmaf(an, gl[u + 1], dh[u]);
            gp[u] = u == RG_L - 1 ? an : gp[u + 1] * an;
        }
        ra_s[warp][lane] = gp[0];
        rb_s[warp][lane] = gl[0];
        const float a_first = f_s[0][lane];
        __syncthreads();
        // g after this warp's last step, folded from the segment's end; and
        // g at the segment's first step, the carry of the segment before
        float gin = gcarry;
        for (int v = RG_NW - 1; v > warp; --v)
            gin = fmaf(ra_s[v][lane], gin, rb_s[v][lane]);
#pragma unroll
        for (int v = RG_NW - 1; v >= 0; --v)
            gcarry = fmaf(ra_s[v][lane], gcarry, rb_s[v][lane]);
        a_next = a_first;
#pragma unroll
        for (int u = 0; u < RG_L; ++u) {
            const float g = fmaf(gp[u], gin, gl[u]);
            const float hp = u == 0 ? cin : fmaf(ch.pr[u - 1], cin,
                                                 ch.loc[u - 1]);
            const float a = ch.a[u], be = ch.beta[u];
            const float ix = ch.ig[u] * ch.x[u];
            // beta = 0 only at a_gate = 0 (padding past a limit, or the
            // steps past S), where the oracle's derivative of sqrt is
            // infinite: those steps take 0 here (training has no padding)
            const float db = be > 0.f ? g * ix * a * a / be : 0.f;
            const float dl = g * hp * a - db;
            dla = fmaf(dl * r.c, ch.ag[u], dla);
            if (live && t0 + u < S) {
                const size_t i = (size_t)(t0 + u) * W;
                dxp[i] = from_f<T>(g * be * ch.ig[u]);
                dip[i] = from_f<T>(g * be * ch.x[u]);
                dap[i] = from_f<T>(dl * cla);
            }
            if (u == 0 && s == 0 && warp == 0 && live
                && r.dinit != nullptr) {
                const size_t i = (size_t)b * W + w;
                if (r.init_f32) ((float*)r.dinit)[i] = a * g;
                else ((T*)r.dinit)[i] = from_f<T>(a * g);
            }
        }
        __syncthreads();                  // the shared pairs free
    }
    // the row's d log_a at this channel: the warps' sums in order
    a_s[warp][lane] = dla;
    __syncthreads();
    if (warp == 0 && live) {
        float t = 0.f;
#pragma unroll
        for (int v = 0; v < RG_NW; ++v) t += a_s[v][lane];
        r.part[(size_t)b * W + w] = t;
    }
}

// d log_a: the rows' parts summed in order
__global__ void rglru_bwd_dloga(const float* __restrict__ part,
                                float* __restrict__ dla, int B, int W) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    float t = 0.f;
    for (int b = 0; b < B; ++b) t += part[(size_t)b * W + w];
    dla[w] = t;
}

template <typename T>
int launch(const RbArgs& r, int B, float* dla, cudaStream_t st) {
    rglru_bwd_kernel<T><<<dim3((r.W + 31) / 32, B), RG_THREADS, 0, st>>>(r);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_dloga<<<(r.W + 255) / 256, 256, 0, st>>>(r.part, dla, B, r.W);
    return (int)cudaGetLastError();
}

}  // namespace

// x, ig, ag, dh (B, S, W) contiguous in the working type; log_a (W,) f32;
// init and dfin (B, W) in the working type or (init_f32, dfin_f32) f32, or
// null for zeros.  Outputs dx, dig, dag (B, S, W) in the working type,
// dla (W,) f32, dinit (B, W) like init (null when init is).  ws: the f32
// workspace of rglru_scan.rglru_bwd_workspace.  Launches the two kernels on
// ``stream`` and returns the first cudaGetLastError() that is not
// cudaSuccess, or REPRO_UNSUPPORTED.
extern "C" int rglru_scan_bwd_launch(
    const void* x, const void* ig, const void* ag, const void* log_a,
    const void* init, const void* dh, const void* dfin, void* dx, void* dig,
    void* dag, void* dla, void* dinit, void* ws, int B, int S, int W,
    int dtype, int init_f32, int dfin_f32, float c, void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return REPRO_UNSUPPORTED;
    const int nseg = (S + RG_SEG - 1) / RG_SEG;
    RbArgs r;
    r.x = x; r.ig = ig; r.ag = ag; r.log_a = (const float*)log_a;
    r.init = init; r.dh = dh; r.dfin = dfin; r.dx = dx; r.dig = dig;
    r.dag = dag; r.dinit = init != nullptr ? dinit : nullptr;
    r.carries = (float*)ws;
    r.part = r.carries + (size_t)B * nseg * W;
    r.S = S; r.W = W; r.nseg = nseg; r.init_f32 = init_f32;
    r.dfin_f32 = dfin_f32; r.c = c;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_F32) return launch<float>(r, B, (float*)dla, st);
    if (dtype == REPRO_BF16)
        return launch<__nv_bfloat16>(r, B, (float*)dla, st);
    return REPRO_UNSUPPORTED;
}
