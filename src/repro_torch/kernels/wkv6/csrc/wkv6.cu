// WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/kernel.py::
// wkv6_pallas (its body _kernel), and returns the final state as well, which
// serving prefill keeps for the decode cache.
//
// What it computes, per batch row b and head h, for r, k, v (B, S, H, K) of
// one type (f32 or bf16, widened to f32 on load), log_w (B, S, H, K) f32
// (<= 0), u (H, K) f32 and an optional initial state S0 (B, H, K, K) f32
// (zeros when null), with V = K:
//   y_t[v] = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//   S[k][v] <- exp(log_w_t[k]) * S[k][v] + k_t[k] * v_t[v]
// Outputs: y (B, S, H, K) f32 and the final S (B, H, K, K) f32.  Every
// exponent is a log_w_t <= 0, so a strong decay underflows to an exact 0 and
// nothing overflows.  All arithmetic is f32 on the CUDA cores: TF32 keeps
// about three digits and would not hold the reference's 2e-3 (1e-4 under
// strong decay).
//
// Bound.  Operations: 5 * K * V per token and head (for each state element,
// y += r * S is one FMA and S = w * S + k * v a multiply and an FMA; the
// bonus, (sum_k r u k) * v, is O(K + V)), over 67 TFLOP/s of f32 on an H100
// SXM.  Bytes: r, k, v, log_w and y each moved once, and S0 and S_out, over
// 3.35 TB/s.  At rwkv6-3b's prefill shapes (K = V = 64, r/k/v in bf16) the
// operations bound it, narrowly: 5 * 64 = 320 operations per 14 bytes of
// each (token, head, k), 23 per byte against the card's 20.
//
// Design, and what it does about that bound.
//   * The chunked algebra of the Pallas kernel exists to feed the TPU's
//     matrix unit.  In f32 on CUDA cores it would cost more operations than
//     the scan (the pairwise decay alone is L/2 exps per token and k), so
//     this kernel runs the exact per-token scan, which is also the
//     reference's oracle.  The state never leaves registers: the TPU's
//     sequential chunk axis becomes a loop over tokens inside the block.
//   * Columns of the state are independent (y[:, v] reads only S[:, v] and
//     v[:, v]), so a block of 64 threads owns one (b, h) and VB of its
//     columns, and the grid (K / VB, H, B) fills the card without any
//     cross-block reduction.  Each thread holds R = K / KS rows of C
//     columns in registers.
//   * What bounds a scan like this on the CUDA cores is shared memory: a
//     thread reads r, k and w of each row for every token.  With one column
//     a thread (C = 1), those reads cost as much shared-memory bandwidth as
//     the three f32 instructions they feed (two FMAs and a multiply) cost
//     issue slots, and the first version was bound by them; with C = 4 each
//     read feeds four columns.  K = 16 keeps C = 1 (its row slices would
//     otherwise be one row).
//   * KS, the number of row slices, sets how many blocks there are: the
//     fewest built split that gives two blocks per SM (KS = 4 for a batch
//     of 8 x 40 heads at K = 64, 320 blocks).  Where B * H cannot give that
//     (one long prompt of 40 heads), the sequence is cut into segments,
//     each scanned at KS = 4 by its own blocks from the state the segments
//     before it leave (the sequence-parallel passes below): 13 segments of
//     40 blocks fill the card's 132 SMs with four blocks each, where one
//     pass at KS = 16 had 160 thin blocks whose thread each holds 4 rows.
//   * TT tokens at a time are staged in shared memory: r, k and exp(log_w)
//     (one exp per element and block), v of the block's columns, and the
//     products r u k, whose sum over k (the bonus of each token) four
//     groups of threads take in parts.  The row slice of each KS group is
//     padded by 4 floats, so that the groups' 16-byte reads of one token fall
//     on different banks.  The ragged tail is padded with k = v = 0 and
//     log_w = 0, which leaves the state as it is.  The next TT tokens are
//     loaded into registers before the current ones are scanned, so that
//     the loads' latency hides behind the scan (a first version that loaded
//     each chunk only when it was needed spent most of its time waiting).
//   * Each thread's partial sums of y for each token go to shared memory;
//     after the TT tokens, the KS partials of each (token, column) are added
//     in row-slice order, the bonus is added, and y is written.  Every sum
//     has a fixed order, so results are bitwise deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define WKV_THREADS 64
#define WKV_TT 16                          // tokens staged at a time
#define WKV_PARTS (WKV_THREADS / WKV_TT)   // parts of a token's bonus sum

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int K, int KS, int C>
struct WkvShape {
    static constexpr int R = K / KS;                        // state rows of a thread
    static constexpr int VB = WKV_THREADS * C / KS;         // state columns of a block
    static constexpr int CG = VB / C;                       // column groups of a block
    static constexpr int RP = R + 4;                        // padded row slice
    static constexpr int KP = KS * RP;                      // padded token row
    static_assert(R % 4 == 0, "a thread's row slice is read as float4");
    static_assert(VB <= K && K % VB == 0, "a block's columns tile K");
    static_assert(K % WKV_PARTS == 0, "the bonus sum splits K in parts");
};

// Position of key row j in a padded token row (row slices of R, each
// followed by 4 floats of padding).
template <int R>
__device__ __forceinline__ int padded(int j) {
    return (j / R) * (R + 4) + j % R;
}

template <typename T, int K, int KS, int C>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ log_w, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
            int S, int H, int n_seg, int seg_len) {
    using Sh = WkvShape<K, KS, C>;
    constexpr int R = Sh::R, VB = Sh::VB, CG = Sh::CG, RP = Sh::RP, KP = Sh::KP;
    __shared__ __align__(16) float sr[WKV_TT][KP];
    __shared__ __align__(16) float sk[WKV_TT][KP];
    __shared__ __align__(16) float sw[WKV_TT][KP];
    __shared__ __align__(16) float sv[WKV_TT][VB];
    __shared__ __align__(16) float sy[WKV_TT][KS * VB];  // partial y of each row slice
    __shared__ float sp[WKV_TT][K + 1];                  // r u k, per token and key row
    __shared__ float sb[WKV_PARTS][WKV_TT];              // the bonus of each token, in parts
    __shared__ float su[K];

    const int tid = threadIdx.x;
    const int cg = tid % CG;            // which group of C columns
    const int ks = tid / CG;            // which row slice
    const int col0 = blockIdx.x * VB;
    const int h = blockIdx.y, b = blockIdx.z / n_seg, seg = blockIdx.z % n_seg;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int64_t stride_t = (int64_t)H * K;                 // one token of (B, S, H, K)
    const int64_t base = ((int64_t)b * S * H + h) * K;       // token 0 of (b, h)
    const int64_t sbase = ((int64_t)b * H + h) * K * K;      // (b, h) of the final state
    const int64_t start = (((int64_t)b * H + h) * n_seg + seg) * K * K;  // the segment's first state

    for (int j = tid; j < K; j += WKV_THREADS) su[j] = u[h * K + j];
    float st[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c)
            st[i][c] = s0 ? s0[start + (int64_t)(ks * R + i) * K + col0 + cg * C + c] : 0.f;

    // The next chunk's inputs wait in registers while the current chunk is
    // scanned, so that their loads are in flight during the scan.
    constexpr int PER = WKV_TT * K / WKV_THREADS;            // r/k/log_w elements a thread stages
    constexpr int PER_V = (WKV_TT * VB + WKV_THREADS - 1) / WKV_THREADS;
    T nr[PER], nk[PER], nv[PER_V];
    float nw[PER];
    auto fetch = [&](int t0) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int idx = tid + m * WKV_THREADS, t = idx / K, j = idx - t * K;
            if (t0 + t < t_end) {
                const int64_t o = base + (int64_t)(t0 + t) * stride_t + j;
                nr[m] = r[o];
                nk[m] = k[o];
                nw[m] = log_w[o];
            }
        }
#pragma unroll
        for (int m = 0; m < PER_V; ++m) {
            const int idx = tid + m * WKV_THREADS, t = idx / VB, cc = idx - t * VB;
            if (idx < WKV_TT * VB && t0 + t < t_end) nv[m] = v[base + (int64_t)(t0 + t) * stride_t + col0 + cc];
        }
    };
    // stage a fetched chunk; tokens past the segment get k = v = 0 and log_w = 0
    auto stage = [&](int t0) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int idx = tid + m * WKV_THREADS, t = idx / K, j = idx - t * K, p = padded<R>(j);
            const bool in = t0 + t < t_end;
            const float rv = in ? widen(nr[m]) : 0.f, kv = in ? widen(nk[m]) : 0.f;
            sr[t][p] = rv;
            sk[t][p] = kv;
            sw[t][p] = in ? expf(nw[m]) : 1.f;
            sp[t][j] = rv * su[j] * kv;
        }
#pragma unroll
        for (int m = 0; m < PER_V; ++m) {
            const int idx = tid + m * WKV_THREADS, t = idx / VB, cc = idx - t * VB;
            if (idx < WKV_TT * VB) sv[t][cc] = t0 + t < t_end ? widen(nv[m]) : 0.f;
        }
    };
    fetch(t_begin);
    __syncthreads();

    for (int t0 = t_begin; t0 < t_end; t0 += WKV_TT) {
        stage(t0);
        __syncthreads();
        if (t0 + WKV_TT < t_end) fetch(t0 + WKV_TT);

        // the bonus sum_k r u k of each token, in WKV_PARTS parts of K /
        // WKV_PARTS rows (read after the next barrier)
        {
            const int t = tid % WKV_TT, part = tid / WKV_TT;
            constexpr int PK = K / WKV_PARTS;
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < PK; ++j) a += sp[t][part * PK + j];
            sb[part][t] = a;
        }
        // the scan over the staged tokens: each r, k, w read feeds C columns
#pragma unroll
        for (int t = 0; t < WKV_TT; ++t) {
            float vv[C], yp[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                vv[c] = sv[t][cg * C + c];
                yp[c] = 0.f;
            }
            const float* pr = &sr[t][ks * RP];
            const float* pk = &sk[t][ks * RP];
            const float* pw = &sw[t][ks * RP];
#pragma unroll
            for (int q = 0; q < R; q += 4) {
                const float4 r4 = *reinterpret_cast<const float4*>(pr + q);
                const float4 k4 = *reinterpret_cast<const float4*>(pk + q);
                const float4 w4 = *reinterpret_cast<const float4*>(pw + q);
                const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
                const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
                const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        yp[c] = fmaf(rr[i], st[q + i][c], yp[c]);
                        st[q + i][c] = fmaf(st[q + i][c], ww[i], kk[i] * vv[c]);
                    }
            }
            if constexpr (C == 4) {  // one 16-byte store: the lanes' column groups are adjacent
                *reinterpret_cast<float4*>(&sy[t][ks * VB + cg * C]) = make_float4(yp[0], yp[1], yp[2], yp[3]);
            } else {
#pragma unroll
                for (int c = 0; c < C; ++c) sy[t][ks * VB + cg * C + c] = yp[c];
            }
        }
        __syncthreads();

        // y = the KS partials in row-slice order, plus the bonus
        for (int idx = tid; idx < WKV_TT * VB; idx += WKV_THREADS) {
            const int t = idx / VB, cc = idx - t * VB;
            if (t0 + t < t_end) {
                float acc = 0.f;
#pragma unroll
                for (int q = 0; q < KS; ++q) acc += sy[t][q * VB + cc];
                float a = 0.f;
#pragma unroll
                for (int q = 0; q < WKV_PARTS; ++q) a += sb[q][t];
                acc = fmaf(sv[t][cc], a, acc);
                y[base + (int64_t)(t0 + t) * stride_t + col0 + cc] = acc;
            }
        }
        __syncthreads();
    }
    if (seg != n_seg - 1) return;  // the last segment leaves the final state
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) s_out[sbase + (int64_t)(ks * R + i) * K + col0 + cg * C + c] = st[i][c];
}

// ---------------------------------------------------------------------------
// Sequence-parallel passes, for when B * H cannot fill the card (one long
// prompt): the S tokens of each (b, h) are cut into n_seg segments of
// seg_len tokens.
//   1. wkv6_states: per (b, h, segment but the last), in parallel, the state
//      the segment leaves from zero, E = sum_j (k_j * exp(tot - cum_j)) v_j^T,
//      and its decay D = exp(tot), where cum is the running sum of log_w
//      within the segment and tot its last value (every exponent <= 0).
//   2. wkv6_carry: per (b, h) and state element, in order over segments,
//      start[0] = S0 (or 0) and start[s + 1] = D_s * start[s] + E_s, in
//      place of E.
//   3. wkv6_kernel (the scan above) per (b, h, segment) from start[s]; the
//      last segment writes the final state.
// ---------------------------------------------------------------------------

#define WKV_ST_THREADS 256
#define WKV_ST_TT 32                       // tokens staged at a time
#define WKV_CARRY_STEP 8

// One block of 256 threads per (segment, h, b): each thread owns a
// (K / 16) x (K / 16) tile of E and adds k~_j v_j^T token by token (K / 16
// squared FMAs per two 16-byte shared reads at K = 64), where k~_j = k_j *
// exp(sum of log_w after j in the segment).  Those suffix sums are taken
// walking the segment from its end, WKV_ST_TT tokens at a time, split over
// the threads of each key row in WKV_ST_THREADS / K groups.
template <typename T, int K>
__global__ void __launch_bounds__(WKV_ST_THREADS)
wkv6_states(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ log_w,
            float* __restrict__ e_out, float* __restrict__ d_out, int S, int H, int n_seg, int seg_len) {
    constexpr int TR = K / 16;                          // rows and columns of a thread's tile
    constexpr int G = WKV_ST_THREADS / K;               // groups of a key row's threads
    constexpr int TPG = WKV_ST_TT / G;                  // tokens of a group
    static_assert(WKV_ST_TT % G == 0, "the staged tokens split over the groups");
    __shared__ __align__(16) float sk[WKV_ST_TT][K];    // k, then k~
    __shared__ __align__(16) float sv[WKV_ST_TT][K];
    __shared__ float sw[WKV_ST_TT][K];                  // log_w
    __shared__ float gsum[G][K];                        // each group's sum of log_w
    __shared__ float suf[K];                            // log_w summed after the staged tokens

    const int tid = threadIdx.x;
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int64_t stride_t = (int64_t)H * K;
    const int64_t base = ((int64_t)b * S * H + h) * K;
    const int ti = tid / 16, tj = tid % 16;             // the thread's tile of E
    const int kr = tid % K, g = tid / K;                // the thread's key row and group
    float e[TR][TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) e[i][j] = 0.f;
    if (tid < K) suf[tid] = 0.f;

    // The next chunk's inputs wait in registers while the current chunk is
    // folded, as in the scan.
    constexpr int PER = WKV_ST_TT * K / WKV_ST_THREADS;     // elements of each input a thread stages
    T nk[PER], nv[PER];
    float nw[PER];
    auto fetch = [&](int c0) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int idx = tid + m * WKV_ST_THREADS, t = idx / K, j = idx - t * K;
            if (c0 + t < t_end) {
                const int64_t o = base + (int64_t)(c0 + t) * stride_t + j;
                nk[m] = k[o];
                nv[m] = v[o];
                nw[m] = log_w[o];
            }
        }
    };
    // tokens past the segment get k = v = 0 and log_w = 0, which add nothing
    auto stage = [&](int c0) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int idx = tid + m * WKV_ST_THREADS, t = idx / K, j = idx - t * K;
            const bool in = c0 + t < t_end;
            sk[t][j] = in ? widen(nk[m]) : 0.f;
            sv[t][j] = in ? widen(nv[m]) : 0.f;
            sw[t][j] = in ? nw[m] : 0.f;
        }
    };
    const int n_chunks = (t_end - t_begin + WKV_ST_TT - 1) / WKV_ST_TT;
    if (n_chunks > 0) fetch(t_begin + (n_chunks - 1) * WKV_ST_TT);
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int c0 = t_begin + c * WKV_ST_TT;
        stage(c0);
        __syncthreads();
        if (c > 0) fetch(c0 - WKV_ST_TT);
        {
            float part = 0.f;
#pragma unroll
            for (int q = 0; q < TPG; ++q) part += sw[g * TPG + q][kr];
            gsum[g][kr] = part;
        }
        __syncthreads();
        {
            float acc = suf[kr];
            for (int q = G - 1; q > g; --q) acc += gsum[q][kr];
#pragma unroll
            for (int q = TPG - 1; q >= 0; --q) {
                const int t = g * TPG + q;
                sk[t][kr] *= expf(acc);
                acc += sw[t][kr];
            }
        }
        __syncthreads();
        if (g == 0) {
            float acc = suf[kr];
            for (int q = G - 1; q >= 0; --q) acc += gsum[q][kr];
            suf[kr] = acc;
        }
#pragma unroll 4
        for (int t = 0; t < WKV_ST_TT; ++t) {
            float kk[TR], vv[TR];
            if constexpr (TR == 4) {
                const float4 k4 = *reinterpret_cast<const float4*>(&sk[t][ti * 4]);
                const float4 v4 = *reinterpret_cast<const float4*>(&sv[t][tj * 4]);
                kk[0] = k4.x; kk[1] = k4.y; kk[2] = k4.z; kk[3] = k4.w;
                vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
            } else {
#pragma unroll
                for (int i = 0; i < TR; ++i) {
                    kk[i] = sk[t][ti * TR + i];
                    vv[i] = sv[t][tj * TR + i];
                }
            }
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TR; ++j) e[i][j] = fmaf(kk[i], vv[j], e[i][j]);
        }
        __syncthreads();
    }
    const int64_t cell = ((int64_t)b * H + h) * n_seg + seg;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) e_out[cell * K * K + (int64_t)(ti * TR + i) * K + tj * TR + j] = e[i][j];
    if (tid < K) d_out[cell * K + tid] = expf(suf[tid]);
}

// One thread per (b, h, row, column) of the state: the segments' first
// states, in place of their E (the last segment's E is never made).
__global__ void wkv6_carry(float* __restrict__ states, const float* __restrict__ decay,
                           const float* __restrict__ s0, int BH, int K, int n_seg) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t kk = (int64_t)K * K;
    if (i >= BH * kk) return;
    const int64_t bh = i / kk, cell = i - bh * kk, row = cell / K;
    float st = s0 ? s0[i] : 0.f;
    // WKV_CARRY_STEP segments' E and decay are loaded before they are used
    for (int s0_ = 0; s0_ < n_seg; s0_ += WKV_CARRY_STEP) {
        float e[WKV_CARRY_STEP], d[WKV_CARRY_STEP];
#pragma unroll
        for (int j = 0; j < WKV_CARRY_STEP; ++j) {
            const int s = s0_ + j;
            const bool has_e = s + 1 < n_seg;
            e[j] = has_e ? states[(bh * n_seg + s) * kk + cell] : 0.f;
            d[j] = has_e ? decay[(bh * n_seg + s) * K + row] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < WKV_CARRY_STEP; ++j) {
            const int s = s0_ + j;
            if (s < n_seg) states[(bh * n_seg + s) * kk + cell] = st;
            if (s + 1 < n_seg) st = fmaf(d[j], st, e[j]);
        }
    }
}

template <typename T, int K, int KS, int C>
static int launch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                  const float* s0, float* y, float* s_out, int B, int S, int H, int n_seg,
                  int seg_len, float* states, float* decay, cudaStream_t stream) {
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const float* starts = s0;
    if (n_seg > 1) {
        wkv6_states<T, K><<<dim3(n_seg - 1, H, B), WKV_ST_THREADS, 0, stream>>>(
            kt, vt, log_w, states, decay, S, H, n_seg, seg_len);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int64_t cells = (int64_t)B * H * K * K;
        wkv6_carry<<<(int)((cells + 255) / 256), 256, 0, stream>>>(states, decay, s0, B * H, K, n_seg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        starts = states;
    }
    const dim3 grid(K / WkvShape<K, KS, C>::VB, H, B * n_seg);
    wkv6_kernel<T, K, KS, C><<<grid, WKV_THREADS, 0, stream>>>(
        static_cast<const T*>(r), kt, vt, log_w, u, starts, y, s_out, S, H, n_seg, seg_len);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                    const float* s0, float* y, float* s_out, int B, int S, int H, int K, int ks,
                    int n_seg, int seg_len, float* states, float* decay, cudaStream_t stream) {
#define WKV_ARGS r, k, v, log_w, u, s0, y, s_out, B, S, H, n_seg, seg_len, states, decay, stream
    if (K == 16 && ks == 4) return launch<T, 16, 4, 1>(WKV_ARGS);
    if (K == 64 && ks == 4) return launch<T, 64, 4, 4>(WKV_ARGS);
    if (K == 64 && ks == 8) return launch<T, 64, 8, 4>(WKV_ARGS);
    if (K == 64 && ks == 16) return launch<T, 64, 16, 4>(WKV_ARGS);
#undef WKV_ARGS
    return (int)cudaErrorInvalidValue;
}

static int run(const void* r, const void* k, const void* v, const void* log_w, const void* u,
               const void* s0, void* y, void* s_out, int dtype, int B, int S, int H, int K, int ks,
               int n_seg, int seg_len, void* states, void* decay, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || H == 0) return 0;
    if (n_seg < 1 || (n_seg > 1 && (states == nullptr || decay == nullptr))) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* lw = static_cast<const float*>(log_w);
    const float* uu = static_cast<const float*>(u);
    const float* st = static_cast<const float*>(s0);
    float* yo = static_cast<float*>(y);
    float* so = static_cast<float*>(s_out);
    float* ws = static_cast<float*>(states);
    float* wd = static_cast<float*>(decay);
    if (dtype == DT_F32) return dispatch<float>(r, k, v, lw, uu, st, yo, so, B, S, H, K, ks, n_seg, seg_len, ws, wd, s);
    if (dtype == DT_BF16)
        return dispatch<__nv_bfloat16>(r, k, v, lw, uu, st, yo, so, B, S, H, K, ks, n_seg, seg_len, ws, wd, s);
    return (int)cudaErrorInvalidValue;
}

// One launch on `stream` of the device `device` (this library carries its
// own CUDA runtime, so the launch names its device), in one pass over the
// sequence.  (K, ks) is one of (16, 4), (64, 4), (64, 8), (64, 16); dtype is
// DT_F32 or DT_BF16 for r, k and v; s0 may be null.  Returns a cudaError_t,
// 0 on success.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* log_w,
                           const void* u, const void* s0, void* y, void* s_out, int dtype, int B,
                           int S, int H, int K, int ks, int device, void* stream) {
    return run(r, k, v, log_w, u, s0, y, s_out, dtype, B, S, H, K, ks, 1, S, nullptr, nullptr, device, stream);
}

// The same over n_seg segments of seg_len tokens (the last may be shorter;
// none empty), with workspace states (B, H, n_seg, K, K) and decay (B, H,
// n_seg, K), both f32.
extern "C" int wkv6_launch_segmented(const void* r, const void* k, const void* v, const void* log_w,
                                     const void* u, const void* s0, void* y, void* s_out, int dtype,
                                     int B, int S, int H, int K, int ks, int n_seg, int seg_len,
                                     void* states, void* decay, int device, void* stream) {
    return run(r, k, v, log_w, u, s0, y, s_out, dtype, B, S, H, K, ks, n_seg, seg_len, states, decay,
               device, stream);
}
