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
// What bounds it on the H100.  Its visible work (perf_model.ssd_scan_cost)
// is bound by bytes: 1.65 GFLOP over 13.2 MB at the serving prefill call
// (4 x 256, H = 32), 125 flops a byte, under the ~295 a byte at which the
// bf16 tensor cores become the limit.  But that is far above the ~20
// float32 flops a byte of the CUDA cores, so an FMA body is bound by its
// arithmetic; on the tensor cores the three-part operands below triple
// the P x, read-out and update products, and what sets the time is how
// busy one warpgroup keeps them between its waits.
//
// Two bodies, chosen by the wrapper from the shapes before the launch
// (ssd_scan.ssd_body): the tensor-core body for bf16 at (P, N) = (64, 128)
// with Q >= 16, the FMA body for float32 (the identity runs, where f32
// must stay f32: no TF32), for bf16 chunks shorter than 16 positions, and
// for the reduced (32, 16).  Both take one thread block per (b, h) that
// walks its chunks in order, the state carried inside the block, so
// nothing carries between blocks (the TPU grid steps (b*h, chunk) in order
// with the (P, N) state in VMEM scratch).
//
// Tensor-core body (ssd_scan_wgmma_kernel; two warpgroups, 256 threads).
// The intra-chunk part has the shape of causal attention with a decay
// mask in place of the softmax (C plays Q, B plays K, x plays V), so it is
// built as prefill_block_wgmma of common.cuh is, from its helpers.  Per
// chunk, all of the chunk's C, B and x rows are staged in bf16 with 16-byte
// cp.async by every thread, each 64-row tile announced on its own mbarrier,
// in wgmma's swizzled layout (WgTile): C and B as rows of N values
// (K-major for the scores, and B MN-major for the state update), x as rows
// of P values (MN-major).  A tile's rows land while the tiles before it
// are computed.  dt and the running sum cs of dt * A sit in shared memory.
// The (P, N) = 64 x 128 f32 state lives in shared memory as three bf16
// parts (hi, mid, lo: about 24 bits; split3_bf16), the read-out's operand.
// The two warpgroups share the query tiles, dealt so that each takes the
// same number of (query, key) tile pairs ({0, 3} and {1, 2} of four), and
// per 64-query tile:
//   read-out   y = C_i S^T: wgmma m64n64k16 from two shared operands, C_i
//              and the three state parts, then each row scaled by
//              exp(cs_q), before the intra-chunk products add into it;
//   scores     G = C_i B_j^T for each key tile j <= i (wgmma, exact: bf16
//              products summed in f32), then in registers G * exp(cs_q -
//              cs_k) * dt_k, causal and past-Q rows masked by a select
//              before the exponential (never exp(cs_q) G exp(-cs_k): cs
//              reaches about -200 in a chunk of 256 and exp(-cs) overflows).
//              Below the diagonal, where cs does not rise (always, for
//              Mamba-2's A < 0 and dt >= 0; checked per tile pair), the
//              decay factors about the end r of key tile j into exp(cs_q -
//              r) exp(r - cs_k), both at most 1: two exponentials a thread
//              and a tile pair instead of 32;
//   P x        the decayed f32 scores as wgmma's register A operand in three
//              bf16 parts (two break the bf16 half-step rule, PERF.md), x as
//              the exact bf16 MN-major B operand (dt folded into the scores'
//              column scale, so x needs no rounding), one wgmma group a
//              tile pair;
//   y          rounded into the C tile it no longer needs, and written out in
//              16-byte pieces of whole rows.
// After every query tile has read the old state, each warpgroup updates
// its half of the state's columns, S <- exp(cs_last) S + (x o w)^T B with
// w_k = dt_k exp(cs_last - cs_k), in registers (32 a thread, rebuilt from
// the parts to within an f32 ulp): (x o w)^T as register A fragments
// (ldmatrix.trans of the x tile, times w, in three bf16 parts), B MN-major
// and exact; then writes it back as parts, or, after the last chunk,
// rounds it once to the output.  The tensor-core work at Q = 256 is ~51
// MFLOP a (b, h) chunk with the three-part operands.  Shared memory: the
// chunk's tiles (160 KB) and the state parts (48 KB), 209 KB: one block an
// SM.  A ring of tiles small enough for two blocks an SM would read each B
// and x tile up to five times a chunk instead of once; the second
// warpgroup gives the SM the overlap a second block would (one warpgroup's
// decays run beside the other's wgmma).  C and B (shared by the heads) are
// read from device memory once a row: the blocks of one row are neighbours
// in the grid (h fastest), so the other heads' copies are L2 hits.  Rows
// and keys past Q are zero-filled and masked; positions with dt = 0 (a
// prompt's padding) decay by exp(0) = 1 and add nothing, exactly.
//
// FMA body (ssd_scan_kernel; 256 threads).  Per chunk: the dt tile and a
// block-wide inclusive scan of dt * A; then per 64-query tile the read-out
// of the old state (exp(cs_q) C_q . S^T), and per 64-key tile up to the
// diagonal the score tile C B^T over N, decayed and causally masked, times
// the dt-scaled x tile; then, after every query tile has read the old
// state, the state update over 64-key tiles.  The float32 state (32 KB at
// P = 64, N = 128) sits in shared memory.  Each thread keeps a 4 x (P /
// 16) tile of y (and of the scores a 4 x 4 tile) in registers; C and B
// tiles are stored n-major with a padded row so the coalesced global loads
// write them without bank conflicts.  Q is any divisor of S from 1 to 256.

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

// ---------------------------------------------------------------------------
// tensor-core body: bf16, (P, N) = (64, 128), two warpgroups (header)
// ---------------------------------------------------------------------------
constexpr int SW_WG = 2;                    // consumer warpgroups
constexpr int SW_THREADS = 128 * SW_WG;
constexpr int SW_T = 64;                    // rows a tile: wgmma's M
constexpr int SW_TILES = SSD_QMAX / SW_T;   // tiles a chunk, at most
constexpr int SW_P = 64, SW_N = 128;

struct SwLayout {   // byte offsets from the 1024-aligned base
    using TN = WgTile<SW_N>;                 // C, B and state rows
    using TX = WgTile<SW_P>;                 // x and y rows
    static constexpr uint32_t NT = SW_T * SW_N * 2;   // a C, B or state tile
    static constexpr uint32_t XT = SW_T * SW_P * 2;   // an x tile
    static constexpr uint32_t C0 = 0;
    static constexpr uint32_t B0 = C0 + SW_TILES * NT;
    static constexpr uint32_t X0 = B0 + SW_TILES * NT;
    static constexpr uint32_t S0 = X0 + SW_TILES * XT;   // three state parts
    static constexpr size_t SMEM = 1024 + S0 + 3 * NT;   // + alignment slack
};

// The state's half nb (columns n of 64 nb .. 64 nb + 63) held by a
// warpgroup as wgmma's accumulator (s[4 nt + j] is (p, n) = (16 w + gid +
// 8 (j / 2), 64 nb + 8 nt + 2 tig + j % 2), w the warp in the warpgroup),
// to and from its three bf16 parts in shared memory (rows p of N values,
// WgTile), the operand of the read-out.  A thread touches only its own
// entries.
__device__ __forceinline__ uint32_t sw_state_off(int nb, int nt, int hh) {
    const int w = threadIdx.x / 32 % 4, gid = threadIdx.x % 32 / 4,
              tig = threadIdx.x % 4;
    return SwLayout::TN::at<SW_T>(16 * w + gid + 8 * hh, 8 * nb + nt)
        + 4 * tig;
}

__device__ __forceinline__ void sw_store_parts(const float (&s)[32], int nb,
                                               unsigned char* parts) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            uint32_t part[3];
            split3_bf16(s[4 * nt + 2 * hh], s[4 * nt + 2 * hh + 1], part);
            const uint32_t off = sw_state_off(nb, nt, hh);
#pragma unroll
            for (int k = 0; k < 3; ++k)
                *reinterpret_cast<uint32_t*>(parts + k * SwLayout::NT + off)
                    = part[k];
        }
}

// s = lo + mid + hi: the f32 state to within an ulp (the parts keep ~24
// bits), so a chunk's update starts from what its read-out used
__device__ __forceinline__ void sw_load_parts(float (&s)[32], int nb,
                                              const unsigned char* parts) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const uint32_t off = sw_state_off(nb, nt, hh);
            float2 v = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 2; k >= 0; --k) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(
                        parts + k * SwLayout::NT + off));
                v.x += f.x;
                v.y += f.y;
            }
            s[4 * nt + 2 * hh] = v.x;
            s[4 * nt + 2 * hh + 1] = v.y;
        }
}

// The query tiles warpgroup wg takes of a chunk's nq: tile i costs i + 1
// key tiles, dealt from the largest to the lighter warpgroup ({0, 3} and
// {1, 2} at nq = 4).  A bit mask of tiles.
__device__ __forceinline__ unsigned sw_tiles_of(int wg, int nq) {
    unsigned mask = 0;
    int load0 = 0, load1 = 0;
    for (int i = nq - 1; i >= 0; --i) {
        if (load0 <= load1) {
            load0 += i + 1;
            if (wg == 0) mask |= 1u << i;
        } else {
            load1 += i + 1;
            if (wg == 1) mask |= 1u << i;
        }
    }
    return mask;
}

__global__ void __launch_bounds__(SW_THREADS, 1) ssd_scan_wgmma_kernel(
    SsdArgs a) {
    using L = SwLayout;
    using TN = L::TN;
    using TX = L::TX;
    constexpr int P = SW_P, N = SW_N;
    const int h = blockIdx.x, b = blockIdx.y, H = a.H, Q = a.Q;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wg = tid / 128, wt = tid % 128, ww = warp % 4;  // in the wg
    const int gid = lane / 4, tig = lane % 4;
    const int nq = (Q + SW_T - 1) / SW_T;     // 64-row tiles of a chunk
    const unsigned mine = sw_tiles_of(wg, nq);
    extern __shared__ __align__(16) unsigned char sw_smem[];
    __shared__ float cs_s[SSD_QMAX], dt_s[SSD_QMAX], w_s[SSD_QMAX];
    __shared__ float cf_s[SSD_QMAX];          // dt_k exp(cs_end(k) - cs_k)
    __shared__ float wsum[SW_THREADS / 32], cs_lo[SW_THREADS / 32],
        cs_hi[SW_THREADS / 32];               // a warp's cs: sum, min, max
    __shared__ uint64_t full[SW_TILES];       // a tile's copies landed
    const uint32_t raw = smem_u32(sw_smem);
    const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms align
    unsigned char* tiles = sw_smem + (base - raw);
    const float A = a.A[h];
    const __nv_bfloat16* x = (const __nv_bfloat16*)a.x;
    const __nv_bfloat16* Bm = (const __nv_bfloat16*)a.Bm;
    const __nv_bfloat16* Cm = (const __nv_bfloat16*)a.Cm;
    __nv_bfloat16* y = (__nv_bfloat16*)a.y;
    __nv_bfloat16* fin = (__nv_bfloat16*)a.fin;

    if (tid == 0) {
#pragma unroll
        for (int r = 0; r < SW_TILES; ++r) mbar_init(&full[r], SW_THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    int chunk = 0;
    for (int t0 = 0; t0 < a.S; t0 += Q, ++chunk) {
        __syncthreads();                  // the last chunk is done with smem
        float d = 0.f;                    // this thread's dt, read first
        if (tid < Q)
            d = a.dt[b * a.db + (long long)(t0 + tid) * a.ds + h * a.dh];
        // 1. the chunk's C, B and x rows into their tiles, each tile's
        //    copies announced on its mbarrier: thread tid copies 16-byte
        //    chunk tid % 16 of C and B rows tid / 16 + 16 u, and chunk
        //    tid % 8 of x rows tid / 8 + 32 u
        {
            const int cc = tid % 16, cx = tid % 8;
            const __nv_bfloat16* crow = Cm + b * a.cb + cc * 8;
            const __nv_bfloat16* brow = Bm + b * a.bb + cc * 8;
            const __nv_bfloat16* xrow = x + b * a.xb + h * a.xh + cx * 8;
            for (int r = 0; r < nq; ++r) {
#pragma unroll
                for (int u = 0; u < SW_T / 16; ++u) {
                    const int i = tid / 16 + 16 * u, q = r * SW_T + i;
                    const bool ok = q < Q;
                    const long long t = ok ? t0 + q : 0;
                    cp_async16(tiles + L::C0 + r * L::NT + TN::at<SW_T>(i, cc),
                               crow + t * a.cs, ok);
                    cp_async16(tiles + L::B0 + r * L::NT + TN::at<SW_T>(i, cc),
                               brow + t * a.bs, ok);
                }
#pragma unroll
                for (int u = 0; u < SW_T / 32; ++u) {
                    const int i = tid / 8 + 32 * u, q = r * SW_T + i;
                    const bool ok = q < Q;
                    const long long t = ok ? t0 + q : 0;
                    cp_async16(tiles + L::X0 + r * L::XT + TX::at<SW_T>(i, cx),
                               xrow + t * a.xs, ok);
                }
                mbar_arrive_on_copies(&full[r]);
            }
        }
        // the initial state (zeros without one) as its parts, four values
        // of a row a thread (8 bytes in bf16, 16 in f32), while the first
        // chunk's copies are in flight
        if (chunk == 0) {
            for (int e = tid; e < P * N / 4; e += SW_THREADS) {
                const int p = e / (N / 4), n = e % (N / 4) * 4;
                float v[4] = {0.f, 0.f, 0.f, 0.f};
                if (a.init != nullptr) {
                    const size_t off = (((size_t)b * H + h) * P + p) * N + n;
                    if (a.init_f32) {
                        const float4 f = *reinterpret_cast<const float4*>(
                            (const float*)a.init + off);
                        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
                    } else {
                        const uint2 u = *reinterpret_cast<const uint2*>(
                            (const __nv_bfloat16*)a.init + off);
                        const float2 f0 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
                        const float2 f1 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
                        v[0] = f0.x; v[1] = f0.y; v[2] = f1.x; v[3] = f1.y;
                    }
                }
                uint32_t lo[3], hi[3];
                split3_bf16(v[0], v[1], lo);
                split3_bf16(v[2], v[3], hi);
                const uint32_t off = TN::at<SW_T>(p, n / 8) + (n % 8) * 2;
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    *reinterpret_cast<uint2*>(tiles + L::S0 + k * L::NT + off) =
                        make_uint2(lo[k], hi[k]);
            }
        }
        // 2. the inclusive scan of dt * A, a position a thread (past Q,
        //    dt = 0), then the state update's weights w_k = dt_k
        //    exp(cs_last - cs_k)
        {
            const float v = d * A;
            float inc = v;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float u = __shfl_up_sync(0xffffffffu, inc, off);
                if (lane >= off) inc += u;
            }
            if (lane == 31) wsum[warp] = inc;
            __syncthreads();
            for (int w = 0; w < warp; ++w) inc += wsum[w];
            cs_s[tid] = inc;
            dt_s[tid] = d;
            float lo = inc, hi = inc;     // this warp's least and largest cs
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
                hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
            }
            if (lane == 0) {
                cs_lo[warp] = lo;
                cs_hi[warp] = hi;
            }
        }
        fence_proxy_async();              // the state parts, for wgmma
        __syncthreads();                  // cs, dt and the parts visible
        // the state update's weights w_k = dt_k exp(cs_last - cs_k), and
        // the column factors of the factored decay (below), relative to
        // the end of the key's tile
        w_s[tid] = tid < Q ? dt_s[tid] * expf(cs_s[Q - 1] - cs_s[tid]) : 0.f;
        cf_s[tid] = tid < Q
            ? dt_s[tid] * expf(cs_s[min(tid | (SW_T - 1), Q - 1)] - cs_s[tid])
            : 0.f;
        __syncthreads();

        // 3. this warpgroup's query tiles, 64 queries each
        for (int i = 0; i < nq; ++i) {
            if (!(mine >> i & 1)) continue;
            mbar_wait(&full[i], chunk & 1);   // tiles 0..i landed
            fence_proxy_async();
            const uint32_t ca = base + L::C0 + i * L::NT;
            int qr[2];
            float csq[2], eq[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                qr[hh] = i * SW_T + 16 * ww + gid + 8 * hh;
                csq[hh] = qr[hh] < Q ? cs_s[qr[hh]] : 0.f;
                eq[hh] = qr[hh] < Q ? expf(csq[hh]) : 0.f;
            }
            // read-out of the state at the chunk's start, rows scaled by
            // exp(cs_q) before the chunk's own keys add in
            float acc[32];
            wg_fence();
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int kk = 0; kk < N / 16; ++kk)
                    wgmma_ss(acc, TN::desc<SW_T>(ca, kk * 16),
                             TN::desc<SW_T>(base + L::S0 + k * L::NT,
                                            kk * 16),
                             k > 0 || kk > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(acc);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e] *= eq[(e / 2) % 2];

            for (int j = 0; j <= i; ++j) {
                const uint32_t ba = base + L::B0 + j * L::NT;
                const uint32_t xa = base + L::X0 + j * L::XT;
                // G = C_i B_j^T; sc[4 nt + jj] is query qr[jj / 2], key
                // 64 j + 8 nt + 2 tig + jj % 2
                float sc[32];
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < N / 16; ++kk)
                    wgmma_ss(sc, TN::desc<SW_T>(ca, kk * 16),
                             TN::desc<SW_T>(ba, kk * 16), kk > 0);
                // Decay: exp(cs_q - cs_k) dt_k, the mask by a select before
                // the exponential.  Below the diagonal, where cs does not
                // rise (dt A <= 0, as Mamba-2's A < 0 and dt >= 0 make it)
                // from tile j's end r on through tile i, it factors as
                // exp(cs_q - r) exp(r - cs_k): both factors at most 1, so
                // neither overflows, and one that underflows drops only a
                // term below e^-87 of its product.  Checked per tile pair
                // on the card's cs (r the least of tile j, tile i's largest
                // at most r); else each entry takes its own exponential.
                const float r = cs_s[j * SW_T + SW_T - 1];
                const bool fact = j < i
                    && r == fminf(cs_lo[2 * j], cs_lo[2 * j + 1])
                    && fmaxf(cs_hi[2 * i], cs_hi[2 * i + 1]) <= r;
                float rf[2];
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                    rf[hh] = fact && qr[hh] < Q ? expf(csq[hh] - r) : 0.f;
                wg_commit();
                wg_wait<0>();
                wg_pin(sc);
                // decayed and masked, then as the A fragments of the P x
                // product (16 keys a step, entries 8 kk .. 8 kk + 7) in
                // three bf16 parts
                uint32_t pp[4][4][3];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const int k0 = j * SW_T + 8 * nt + 2 * tig;
                    if (fact) {
                        const float cf[2] = {cf_s[k0], cf_s[k0 + 1]};
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj)
                            sc[4 * nt + jj] *= rf[jj / 2] * cf[jj % 2];
                    } else {
                        const float ck[2] = {cs_s[k0], cs_s[k0 + 1]};
                        const float dk[2] = {dt_s[k0], dt_s[k0 + 1]};
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj) {
                            const int hh = jj / 2, u = jj % 2;
                            const bool in = k0 + u <= qr[hh] && qr[hh] < Q;
                            float& g = sc[4 * nt + jj];
                            g = in ? g * (expf(csq[hh] - ck[u]) * dk[u])
                                   : 0.f;
                        }
                    }
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh)
                        split3_bf16(sc[4 * nt + 2 * hh],
                                    sc[4 * nt + 2 * hh + 1],
                                    pp[nt / 2][2 * (nt % 2) + hh]);
                }
                // y += (decayed G) x_j in one group: x's 16 rows of a step
                // are two 8-row groups 1024 bytes apart
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < SW_T / 16; ++kk) {
                    const uint64_t xd =
                        wg_desc(xa + kk * 2048, 1024, 1024, TX::MODE);
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        const uint32_t af[4] = {pp[kk][0][k], pp[kk][1][k],
                                                pp[kk][2][k], pp[kk][3][k]};
                        wgmma_rs<1>(acc, af, xd);
                    }
                }
                wg_commit();
                wg_wait<0>();
                wg_pin(acc);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int m = 0; m < 4; ++m)
                        asm volatile("" :: "r"(pp[kk][m][0]), "r"(pp[kk][m][1]),
                                     "r"(pp[kk][m][2]) : "memory");
            }
            // y rounded into the C tile it no longer needs (rows q of 64
            // values, swizzled), then out in 16-byte row pieces
            unsigned char* ys = tiles + L::C0 + i * L::NT;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                    *reinterpret_cast<__nv_bfloat162*>(
                        ys + TX::at<SW_T>(16 * ww + gid + 8 * hh, nt)
                        + 4 * tig) =
                        __floats2bfloat162_rn(acc[4 * nt + 2 * hh],
                                              acc[4 * nt + 2 * hh + 1]);
            named_barrier(1 + wg, 128);
#pragma unroll
            for (int u = 0; u < SW_T * 8 / 128; ++u) {
                const int e = wt + 128 * u, r = e / 8, c = e % 8;
                const int q = i * SW_T + r;
                if (q < Q)
                    *reinterpret_cast<uint4*>(
                        y + (((size_t)b * a.S + t0 + q) * H + h) * P + c * 8)
                        = *reinterpret_cast<const uint4*>(
                            ys + TX::at<SW_T>(r, c));
            }
        }
        __syncthreads();                  // every read-out read the state

        // 4. the state update of this warpgroup's half of the columns:
        //    S <- exp(cs_last) S + (x o w)^T B over the chunk's key tiles
        mbar_wait(&full[nq - 1], chunk & 1);  // every tile landed
        float s[32];
        sw_load_parts(s, wg, tiles + L::S0);
        {
            const float dec = expf(cs_s[Q - 1]);
#pragma unroll
            for (int e = 0; e < 32; ++e) s[e] *= dec;
        }
        for (int j = 0; j < nq; ++j) {
            const uint32_t ba = base + L::B0 + j * L::NT + wg * (SW_T * 128);
            const unsigned char* xs = tiles + L::X0 + j * L::XT;
            // A = (x o w)^T, rows p (this warp's 16), keys 16 kk .. +15:
            // matrix m of ldmatrix.trans holds keys + 8 (m / 2), rows p + 8
            // (m % 2); lane l reads key row l % 8 of matrix l / 8.
            // Fragments 0, 1 hold keys 2 tig (+1); 2, 3 keys 8 + 2 tig (+1).
            uint32_t pp[4][4][3];
#pragma unroll
            for (int kk = 0; kk < SW_T / 16; ++kk) {
                const int m = lane / 8;
                const int kr = 16 * kk + 8 * (m / 2) + lane % 8;
                uint32_t xf[4];
                ldsm_x4<true>(xf, reinterpret_cast<const __nv_bfloat16*>(
                                      xs + TX::at<SW_T>(kr, 2 * ww + m % 2)));
                const int kw = j * SW_T + 16 * kk + 2 * tig;
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
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < SW_T / 16; ++kk) {
                const uint64_t bd =
                    wg_desc(ba + kk * 2048, 1024, 1024, TN::MODE);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const uint32_t af[4] = {pp[kk][0][k], pp[kk][1][k],
                                            pp[kk][2][k], pp[kk][3][k]};
                    wgmma_rs<1>(s, af, bd);
                }
            }
            wg_commit();
            wg_wait<0>();
            wg_pin(s);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int f = 0; f < 4; ++f)
                    asm volatile("" :: "r"(pp[kk][f][0]), "r"(pp[kk][f][1]),
                                 "r"(pp[kk][f][2]) : "memory");
        }
        if (t0 + Q < a.S) {               // the next chunk reads its parts
            sw_store_parts(s, wg, tiles + L::S0);
            continue;
        }
        // the final state, rounded once into the free C tiles (rows p of
        // N values), then out in 16-byte row pieces
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<__nv_bfloat162*>(
                    tiles + L::C0 + sw_state_off(wg, nt, hh)) =
                    __floats2bfloat162_rn(s[4 * nt + 2 * hh],
                                          s[4 * nt + 2 * hh + 1]);
        __syncthreads();
        for (int e = tid; e < P * N / 8; e += SW_THREADS) {
            const int p = e / (N / 8), c = e % (N / 8);
            *reinterpret_cast<uint4*>(
                fin + (((size_t)b * H + h) * P + p) * N + c * 8) =
                *reinterpret_cast<const uint4*>(tiles + L::C0
                                                + TN::at<SW_T>(p, c));
        }
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

int launch_wgmma(const SsdArgs& a, int B, cudaStream_t stream) {
    auto kernel = ssd_scan_wgmma_kernel;
    cudaError_t err = reserve_smem(kernel, SwLayout::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(a.H, B), SW_THREADS, SwLayout::SMEM, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) and Bm, Cm (B, S, N) in the working type with their last
// dim contiguous and the other strides given in elements; dt (B, S, H)
// float32 with strides; A (H,) float32; init (B, H, P, N) contiguous in the
// working type (init_f32 = 0) or float32 (init_f32 = 1), or null for a zero
// state; y (B, S, H, P) and fin (B, H, P, N) contiguous in the working
// type.  1 <= Q <= 256 divides S; (P, N) in {(64, 128), (32, 16)}.
// body: 0 the FMA body, 1 the tensor-core body (bf16, (P, N) = (64, 128),
// x, Bm, Cm and init starting on 16-byte boundaries, the strides of x, Bm
// and Cm whole 16 bytes), as the wrapper chooses.  Returns cudaGetLastError() after the
// launch, or REPRO_UNSUPPORTED.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, void* y, void* fin, int B, int S,
    int H, int P, int N, int Q, int dtype, int init_f32, int body,
    long long xb, long long xs, long long xh, long long db, long long ds,
    long long dh, long long bb, long long bs, long long cb, long long cs,
    void* stream) {
    if (B <= 0 || S <= 0 || H <= 0) return REPRO_UNSUPPORTED;
    if (Q < 1 || Q > SSD_QMAX || S % Q != 0) return REPRO_UNSUPPORTED;
    SsdArgs a{x, (const float*)dt, (const float*)A, Bm, Cm, init, y, fin,
              S, H, Q, init_f32, xb, xs, xh, db, ds, dh, bb, bs, cb, cs};
    cudaStream_t st = (cudaStream_t)stream;
    if (body == 1) {
        const bool aligned =
            ((size_t)x | (size_t)Bm | (size_t)Cm | (size_t)init) % 16 == 0
            && (xb | xs | xh | bb | bs | cb | cs) % 8 == 0;
        if (dtype != REPRO_BF16 || P != SW_P || N != SW_N || !aligned)
            return REPRO_UNSUPPORTED;
        return launch_wgmma(a, B, st);
    }
    if (body != 0) return REPRO_UNSUPPORTED;
    if (dtype == REPRO_BF16) return launch_dims<__nv_bfloat16>(a, B, P, N, st);
    if (dtype == REPRO_F32) return launch_dims<float>(a, B, P, N, st);
    return REPRO_UNSUPPORTED;
}
