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
// What bounds it on the H100: bytes.  Per element it reads x, input_gate,
// a_gate and dh twice and writes three gradients: 22 bytes in bf16 for
// some 50 flops (~231 MB at recurrentgemma-2b's train shape, one row of
// 4096 x 2560).  Walking the whole sequence in one block per channel tile
// gave that shape 80 blocks, and its time was set by how few loads they
// kept in flight, not by the bytes.
//
// Design: the time axis is split over blocks, in chunks of RB_CH = 64
// steps, and the two recurrences (h forward, the adjoint g backward) are
// joined across chunks by a short pass over the chunks' pairs.  A block
// of RB_NW = 8 warps takes (32 channels, one chunk, one row), one channel a
// lane, each warp RB_L = 8 consecutive steps of the chunk, all its loads
// issued at once (RbSteps): one load round a chunk, as the forward
// kernel's segments.  Three kernels and the d log_a sum:
//
//   rglru_bwd_chunks   from zero carries, each chunk's pairs: the product
//                      P = prod a over its steps, the local h at its end,
//                      and the adjoint's local sum G = sum_t (prod_{t0..t}
//                      a) dh_t.  G is a_{t0} times the local g at the
//                      chunk's first step, so the adjoint's carry out of a
//                      chunk, E = a_{t1} g_{t1} (t1 the next chunk's first
//                      step), folds as E_{c-1} = P_c E_c + G_c: both
//                      recurrences fold with the one product P, and no
//                      chunk reads its neighbour's a.  The warps' pairs
//                      fold the same way through shared memory;
//   rglru_bwd_carries  a block a (32 channels, row), each warp RB_L chunks
//                      a round: the h carry into every chunk from
//                      init_state, forward, and E out of every chunk from
//                      dfin, backward, the warps' folds meeting in shared
//                      memory.  What falls out of the first chunk is a_0
//                      g_0, d init_state;
//   rglru_bwd_grads    each chunk again, the same loads: every warp's
//                      carries from the chunk's (h through the warps
//                      before it, E through the warps after it), h_{t-1}
//                      forward over its steps in registers, then the steps
//                      in reverse, g_t = dh_t + m with m = a_{t+1} g_{t+1},
//                      writing dx, d input_gate and d a_gate; the warps'
//                      d log_a sums meet in shared memory in order, one
//                      partial a (row, chunk, channel);
//   rglru_bwd_dloga    the (row, chunk) partials of each channel summed in
//                      a fixed order: no atomics, the backward replays bit
//                      for bit.
//
// At one row of 4096 x 2560 that is 5120 blocks a chunk kernel (80
// channel tiles x 64 chunks) against the old 80.  a_t and beta_t come from
// the forward's own gate functions (rg_gates in common.cuh: the library's
// in f32, a polynomial and sqrt.approx in bf16), so the recomputed h is
// the forward's up to the order of its sums.  Steps past S load zeros (a =
// 1, beta = 0, dh = 0: the carries pass through) and write nothing.  f32
// and bf16 share the body.  A first version walked each chunk in one
// thread a channel, 8 steps' loads at a time (eight load rounds a chunk,
// the inputs read a third time from L2) and the chunks' carries one chunk
// a step: 0.2781 ms at that shape against this one's 0.1840 on an H100
// 80GB HBM3 at 700 W (kernel_ab.py; PERF.md section 6).

#include "common.cuh"

namespace {

constexpr int RB_NW = 8;                 // warps a block
constexpr int RB_L = 8;                  // steps (or chunks) a warp
constexpr int RB_THREADS = RB_NW * 32;   // one channel a lane
constexpr int RB_CH = RB_NW * RB_L;      // rglru_scan.RG_BWD_CHUNK

struct RbArgs {
    const void* x; const void* ig; const void* ag;   // (B, S, W) contiguous
    const float* log_a;                              // (W,)
    const void* init;                                // (B, W) or null
    const void* dh;                                  // (B, S, W)
    const void* dfin;                                // (B, W) or null
    void* dx; void* dig; void* dag;                  // (B, S, W)
    void* dinit;                                     // (B, W) or null
    float* pairs;   // (3, B, nc, W): P, local h, G of each chunk
    float* carry;   // (2, B, nc, W): h into each chunk, E out of it
    float* part;    // (B, nc, W): each chunk's d log_a
    int B, S, W, nc, init_f32, dfin_f32;
    float c;
};

template <typename T>
__device__ __forceinline__ float rb_state(const void* p, int is_f32,
                                          size_t i) {
    return is_f32 ? ((const float*)p)[i] : to_f(((const T*)p)[i]);
}

// One warp's RB_L steps from t0, one channel a lane: the inputs (zeros at
// and past S, which pass every carry through: a = 1, beta = 0, dh = 0),
// the gates, and the local pairs from zero carries: P = prod a, Hl the
// local h at the last step, G = sum_t (prod_{t0..t} a) dh_t.
template <typename T>
struct RbSteps {
    float x[RB_L], ig[RB_L], ag[RB_L], dh[RB_L], a[RB_L], be[RB_L];
    float P, Hl, G;

    __device__ __forceinline__ void run(const RbArgs& r, size_t at, int t0,
                                        bool live, float cla) {
        const int W = r.W;
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            x[u] = ig[u] = ag[u] = dh[u] = 0.f;
            if (live && t0 + u < r.S) {
                const size_t i = at + (size_t)u * W;
                x[u] = to_f(((const T*)r.x)[i]);
                ig[u] = to_f(((const T*)r.ig)[i]);
                ag[u] = to_f(((const T*)r.ag)[i]);
                dh[u] = to_f(((const T*)r.dh)[i]);
            }
        }
        P = 1.f;
        Hl = G = 0.f;
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            rg_gates<T>(cla * ag[u], a[u], be[u]);
            Hl = fmaf(a[u], Hl, be[u] * (ig[u] * x[u]));
            P *= a[u];
            G = fmaf(P, dh[u], G);
        }
    }
};

// This thread's (channel, chunk, row) in a grid of (channel tiles of 32,
// chunks, rows): its channel, its warp's first step and element, and the
// chunk's entry in the (B, nc, W) planes
struct RbAt {
    int w, t0;
    bool live;
    size_t elem, plane_at;
    __device__ __forceinline__ RbAt(const RbArgs& r) {
        const int warp = threadIdx.x / 32, ch = blockIdx.y, b = blockIdx.z;
        w = blockIdx.x * 32 + threadIdx.x % 32;
        live = w < r.W;
        const int wl = live ? w : 0;
        t0 = ch * RB_CH + warp * RB_L;
        elem = ((size_t)b * r.S + min(t0, r.S - 1)) * r.W + wl;
        plane_at = ((size_t)b * r.nc + ch) * r.W + wl;
    }
};

template <typename T>
__global__ void __launch_bounds__(RB_THREADS) rglru_bwd_chunks(RbArgs r) {
    __shared__ float p_s[RB_NW][32], h_s[RB_NW][32], g_s[RB_NW][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const RbAt at(r);
    RbSteps<T> st;
    st.run(r, at.elem, at.t0, at.live, r.c * (at.live ? r.log_a[at.w] : 0.f));
    p_s[warp][lane] = st.P;
    h_s[warp][lane] = st.Hl;
    g_s[warp][lane] = st.G;
    __syncthreads();
    if (warp != 0 || !at.live) return;
    // the warps' pairs folded in order
    float P = 1.f, Hl = 0.f, G = 0.f;
#pragma unroll
    for (int v = 0; v < RB_NW; ++v) {
        Hl = fmaf(p_s[v][lane], Hl, h_s[v][lane]);
        G = fmaf(P, g_s[v][lane], G);
        P *= p_s[v][lane];
    }
    const size_t plane = (size_t)r.B * r.nc * r.W;
    r.pairs[at.plane_at] = P;
    r.pairs[plane + at.plane_at] = Hl;
    r.pairs[2 * plane + at.plane_at] = G;
}

// Grid (channel tiles of 32, rows): the chunks' carries, RB_NW x RB_L
// chunks a round, each warp folding its RB_L chunks' pairs from zero and
// the warps' folds meeting in shared memory, as the steps do above.
template <typename T>
__global__ void __launch_bounds__(RB_THREADS) rglru_bwd_carries(RbArgs r) {
    __shared__ float p_s[RB_NW][32], q_s[RB_NW][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int w = blockIdx.x * 32 + lane, b = blockIdx.y;
    const bool live = w < r.W;
    const int wl = live ? w : 0, nc = r.nc;
    const size_t plane = (size_t)r.B * nc * r.W;
    const size_t first = (size_t)b * nc * r.W + wl;
    const float* Pp = r.pairs + first;
    const float* Hp = Pp + plane;
    const float* Gp = Pp + 2 * plane;
    float* hin = r.carry + first;
    float* ext = hin + plane;
    const size_t i = (size_t)b * r.W + wl;
    float P[RB_L], Q[RB_L];

    // h into every chunk, from init_state
    float h = live && r.init != nullptr
        ? rb_state<T>(r.init, r.init_f32, i) : 0.f;
    for (int c0 = 0; c0 < nc; c0 += RB_NW * RB_L) {
        const int cw = c0 + warp * RB_L;
        float Pw = 1.f, Hw = 0.f;
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            const bool in = live && cw + u < nc;
            P[u] = in ? Pp[(size_t)(cw + u) * r.W] : 1.f;
            Q[u] = in ? Hp[(size_t)(cw + u) * r.W] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            Hw = fmaf(P[u], Hw, Q[u]);
            Pw *= P[u];
        }
        p_s[warp][lane] = Pw;
        q_s[warp][lane] = Hw;
        __syncthreads();
        float hw = h;
        for (int v = 0; v < warp; ++v)
            hw = fmaf(p_s[v][lane], hw, q_s[v][lane]);
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            if (live && cw + u < nc) hin[(size_t)(cw + u) * r.W] = hw;
            hw = fmaf(P[u], hw, Q[u]);
        }
#pragma unroll
        for (int v = 0; v < RB_NW; ++v)
            h = fmaf(p_s[v][lane], h, q_s[v][lane]);
        __syncthreads();
    }

    // E out of every chunk, from dfin, the rounds and chunks in reverse
    float e = live && r.dfin != nullptr
        ? rb_state<T>(r.dfin, r.dfin_f32, i) : 0.f;
    const int last = (nc - 1) / (RB_NW * RB_L) * (RB_NW * RB_L);
    for (int c0 = last; c0 >= 0; c0 -= RB_NW * RB_L) {
        const int cw = c0 + warp * RB_L;
        float Pw = 1.f, Ew = 0.f;
#pragma unroll
        for (int u = 0; u < RB_L; ++u) {
            const bool in = live && cw + u < nc;
            P[u] = in ? Pp[(size_t)(cw + u) * r.W] : 1.f;
            Q[u] = in ? Gp[(size_t)(cw + u) * r.W] : 0.f;
        }
#pragma unroll
        for (int u = RB_L - 1; u >= 0; --u) {
            Ew = fmaf(P[u], Ew, Q[u]);
            Pw *= P[u];
        }
        p_s[warp][lane] = Pw;
        q_s[warp][lane] = Ew;
        __syncthreads();
        float ew = e;
        for (int v = RB_NW - 1; v > warp; --v)
            ew = fmaf(p_s[v][lane], ew, q_s[v][lane]);
#pragma unroll
        for (int u = RB_L - 1; u >= 0; --u) {
            if (live && cw + u < nc) ext[(size_t)(cw + u) * r.W] = ew;
            ew = fmaf(P[u], ew, Q[u]);
        }
#pragma unroll
        for (int v = RB_NW - 1; v >= 0; --v)
            e = fmaf(p_s[v][lane], e, q_s[v][lane]);
        __syncthreads();
    }
    if (warp == 0 && live && r.dinit != nullptr) {       // a_0 g_0
        if (r.init_f32) ((float*)r.dinit)[i] = e;
        else ((T*)r.dinit)[i] = from_f<T>(e);
    }
}

template <typename T>
__global__ void __launch_bounds__(RB_THREADS) rglru_bwd_grads(RbArgs r) {
    __shared__ float p_s[RB_NW][32], h_s[RB_NW][32], g_s[RB_NW][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const RbAt at(r);
    const float cla = r.c * (at.live ? r.log_a[at.w] : 0.f);
    RbSteps<T> st;
    st.run(r, at.elem, at.t0, at.live, cla);
    p_s[warp][lane] = st.P;
    h_s[warp][lane] = st.Hl;
    g_s[warp][lane] = st.G;
    __syncthreads();
    // h into this warp's steps, from the chunk's carry through the warps
    // before; m = a g after its last step, from the chunk's E through the
    // warps after
    const size_t plane = (size_t)r.B * r.nc * r.W;
    float h = r.carry[at.plane_at], m = r.carry[plane + at.plane_at];
    for (int v = 0; v < warp; ++v) h = fmaf(p_s[v][lane], h, h_s[v][lane]);
    for (int v = RB_NW - 1; v > warp; --v)
        m = fmaf(p_s[v][lane], m, g_s[v][lane]);
    float hp[RB_L];                       // h_{t-1} of each step
#pragma unroll
    for (int u = 0; u < RB_L; ++u) {
        hp[u] = h;
        h = fmaf(st.a[u], h, st.be[u] * (st.ig[u] * st.x[u]));
    }
    float dla = 0.f;
    T* dxp = (T*)r.dx + at.elem;
    T* dip = (T*)r.dig + at.elem;
    T* dap = (T*)r.dag + at.elem;
#pragma unroll
    for (int u = RB_L - 1; u >= 0; --u) {
        const float a = st.a[u], be = st.be[u];
        const float g = st.dh[u] + m;
        const float ix = st.ig[u] * st.x[u];
        // beta = 0 only at a_gate = 0 (padding past a limit, or the steps
        // past S), where the oracle's derivative of sqrt is infinite:
        // those steps take 0 here (training has no padding)
        const float db = be > 0.f ? g * ix * a * a / be : 0.f;
        const float dl = g * hp[u] * a - db;
        dla = fmaf(dl * r.c, st.ag[u], dla);
        if (at.live && at.t0 + u < r.S) {
            const size_t i = (size_t)u * r.W;
            dxp[i] = from_f<T>(g * be * st.ig[u]);
            dip[i] = from_f<T>(g * be * st.x[u]);
            dap[i] = from_f<T>(dl * cla);
        }
        m = a * g;
    }
    // the chunk's d log_a at this channel: the warps' sums in order
    __syncthreads();                      // the pairs read
    p_s[warp][lane] = dla;
    __syncthreads();
    if (warp == 0 && at.live) {
        float t = 0.f;
#pragma unroll
        for (int v = 0; v < RB_NW; ++v) t += p_s[v][lane];
        r.part[at.plane_at] = t;
    }
}

// d log_a: the (row, chunk) partials summed in order
__global__ void rglru_bwd_dloga(const float* __restrict__ part,
                                float* __restrict__ dla, int rows, int W) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    float t = 0.f;
    for (int j = 0; j < rows; ++j) t += part[(size_t)j * W + w];
    dla[w] = t;
}

template <typename T>
int launch(const RbArgs& r, float* dla, cudaStream_t st) {
    const int tiles = (r.W + 31) / 32;
    rglru_bwd_chunks<T><<<dim3(tiles, r.nc, r.B), RB_THREADS, 0, st>>>(r);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_carries<T><<<dim3(tiles, r.B), RB_THREADS, 0, st>>>(r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_grads<T><<<dim3(tiles, r.nc, r.B), RB_THREADS, 0, st>>>(r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_dloga<<<(r.W + 255) / 256, 256, 0, st>>>(r.part, dla,
                                                       r.B * r.nc, r.W);
    return (int)cudaGetLastError();
}

}  // namespace

// x, ig, ag, dh (B, S, W) contiguous in the working type; log_a (W,) f32;
// init and dfin (B, W) in the working type or (init_f32, dfin_f32) f32, or
// null for zeros.  Outputs dx, dig, dag (B, S, W) in the working type,
// dla (W,) f32, dinit (B, W) like init (null when init is).  ws: the f32
// workspace of rglru_scan.rglru_bwd_workspace, 6 B ceil(S / RB_CH) W
// values.  Launches the four kernels on ``stream`` and returns the first
// cudaGetLastError() that is not cudaSuccess, or REPRO_UNSUPPORTED.
extern "C" int rglru_scan_bwd_launch(
    const void* x, const void* ig, const void* ag, const void* log_a,
    const void* init, const void* dh, const void* dfin, void* dx, void* dig,
    void* dag, void* dla, void* dinit, void* ws, int B, int S, int W,
    int dtype, int init_f32, int dfin_f32, float c, void* stream) {
    if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return REPRO_UNSUPPORTED;
    const int nc = (S + RB_CH - 1) / RB_CH;
    const size_t plane = (size_t)B * nc * W;
    RbArgs r;
    r.x = x; r.ig = ig; r.ag = ag; r.log_a = (const float*)log_a;
    r.init = init; r.dh = dh; r.dfin = dfin; r.dx = dx; r.dig = dig;
    r.dag = dag; r.dinit = init != nullptr ? dinit : nullptr;
    r.pairs = (float*)ws;
    r.carry = r.pairs + 3 * plane;
    r.part = r.carry + 2 * plane;
    r.B = B; r.S = S; r.W = W; r.nc = nc; r.init_f32 = init_f32;
    r.dfin_f32 = dfin_f32; r.c = c;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == REPRO_F32) return launch<float>(r, (float*)dla, st);
    if (dtype == REPRO_BF16)
        return launch<__nv_bfloat16>(r, (float*)dla, st);
    return REPRO_UNSUPPORTED;
}
