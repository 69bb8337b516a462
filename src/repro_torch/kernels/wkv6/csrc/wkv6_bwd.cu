// The gradient of the WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper
// (sm_90a): a walk back over the sequence, token by token.
//
// Replaces no TPU kernel: the JAX package trains rwkv6 by autodiff of its
// plain chunked form (src/repro/models/rwkv6.py:148, _wkv_chunked), which
// XLA differentiates.  The port's forward is a hand-written kernel
// (csrc/wkv6.cu), so its gradient is one too (ops.WKV6); ref.wkv6_bwd_plain
// is its plain version.
//
// What it computes, per batch row b and head h, for r, k, v (B, S, H, K) of
// one type (f32 or bf16, widened to f32 on load), log_w (B, S, H, K) f32,
// u (H, K) f32, an optional S0 (B, H, K, K) f32, dy (B, S, H, K) f32 and an
// optional dS_out (B, H, K, K) f32 (zeros when null).  Walking t from S - 1
// down to 0, with dS = dL/dS_t (from dS_out), w_t = e^{log_w_t} and S_{t-1}
// the state before token t:
//   dr_t[i]     = sum_j S_{t-1}[i,j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
//   du_i       += r_t[i] k_t[i] (v_t . dy_t)
//   dk_t[i]     = sum_j dS[i,j] v_t[j] + r_t[i] u_i (v_t . dy_t)
//   dv_t[j]     = sum_i dS[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dlog_w_t[i] = w_t[i] sum_j S_{t-1}[i,j] dS[i,j]
//   dS         <- diag(w_t) dS + r_t dy_t^T          (dS0 is the last dS)
// Outputs: dr, dk, dv in r's type, dlog_w f32, du in u's type (f32 or
// bf16), dS0 f32.
//
// Bound.  At rwkv6-3b's training microbatch (2 x 2048, 40 heads of 64, r/k/v
// bf16): the bytes, r, k, v in bf16 and log_w, dy in f32 read, dr, dk, dv in
// bf16 and dlog_w in f32 written (24 bytes an element of 10,485,760), take
// 0.075 ms at 3.35 TB/s; the operations, about six K x K products a token
// and head (12 K^2 FLOPs, 8.05 GFLOP), 0.12 ms on the f32 CUDA cores (67
// TFLOP/s).  Operations bound it (chip_smoke.wkv6_bwd_bound).
//
// Measured on an H100 (chip_smoke.py phase 17, PERF.md §6): 2.46 ms at the
// training microbatch (the walk 2.26, the partials' sum 0.20), 20x the
// bound: the walk issues one token a thread step.
//
// Design (a simple first kernel; the chunked form on wgmma is later work).
//   * The value columns split the work.  Column j of S and of dS reads only
//     column j of v and dy, beside r, k and w, so one block walks one
//     (b, h, slice of 16 value columns): K / 16 blocks a head, 320 at the
//     training microbatch against 132 SMs.  dv of the slice is complete in
//     its block; dr, dk, dlog_w (sums over j) and du (a sum over t, b and
//     j) are written as the slice's partials, which a second launch sums in
//     a fixed order.  No float atomics anywhere: two runs on the same inputs
//     give the same bits.
//   * A thread holds one row i and four columns of the slice: K x 4 threads.
//     Sums over j take four in registers and two shuffles; the sum over i
//     of dv takes three shuffles in the warp and one sum over the warps a
//     stage, through shared memory.
//   * S_{t-1} is rebuilt, never recovered by dividing out the decay (which
//     underflows to 0 at the clip's strongest, e^{-54.6}).  A first walk
//     forward from S0 writes the state at every stage start (every T = 8
//     tokens) to the workspace; the walk back re-walks each stage forward
//     from its state, keeping its T states in registers, then walks it
//     back.  dlog_w is taken directly, as above, never by the
//     reverse-cumsum identity (a difference of two sums that grow with S).
//   * Each stage's inputs (r, k, w = e^{log_w} over all K rows, v and dy
//     over the slice) are staged in shared memory, the next stage's loads in
//     flight in registers while this one is walked.  A ragged tail is
//     padded with r = k = v = dy = 0 and w = 1, which changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int JS = 16;  // value columns a block
constexpr int CQ = 4;   // value columns a thread
constexpr int T = 8;    // tokens a stage: the interval of the stored states
// Blocks of the walk an SM holds at once: the registers a thread may take
// are cut to fit them (65,536 / (256 threads x 3) = 85 at K = 64; ptxas
// gives it 80, no spills), so that the 320 blocks of the training
// microbatch run in one wave on 132 SMs (at two an SM, 105 registers, they
// took two: 3.57 against 2.48 ms in turns, scripts/wkv6_bwd_shapes.py on
// an H100).
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename In> __device__ __forceinline__ In narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

struct BwdArgs {
    const void* r;
    const void* k;
    const void* v;
    const float* log_w;
    const float* u;
    const float* s0;      // may be null: zeros
    const float* dy;
    const float* ds_out;  // may be null: zeros
    void* dv;
    float* ds0;
    float* states;  // (B, H, n_stages, K, K): the state before each stage
    float* part;    // (n_slices, 3, B, S, H, K): dr, dk, dlog_w partials
    float* du_part; // (B, n_slices, H, K)
    int B, S, H, n_stages, n_slices;
};

// One stage's inputs in shared memory, and the loads of the next in
// registers.  Thread tid loads elements tid + e * NT of the stage's T x K
// rows (T * K / NT = 2 of r, k, w each) and of its T x JS slice of v, dy.
template <typename In, int K>
struct Stage {
    static constexpr int NT = K * CQ;
    static constexpr int NR = T * K / NT;             // 2
    static constexpr int NV = (T * JS + NT - 1) / NT; // 1 (K = 64) or 2 (K = 16)
    float r[NR], k[NR], w[NR], v[NV], dy[NV];

    __device__ __forceinline__ void load(const BwdArgs& a, int b, int h, int slice, int t0, bool with_grad) {
        const In* rp = static_cast<const In*>(a.r);
        const In* kp = static_cast<const In*>(a.k);
        const In* vp = static_cast<const In*>(a.v);
        const int tid = threadIdx.x;
#pragma unroll
        for (int e = 0; e < NR; ++e) {
            const int idx = tid + e * NT, tt = idx / K, i = idx % K, t = t0 + tt;
            if (t < a.S) {
                const int64_t o = (((int64_t)b * a.S + t) * a.H + h) * K + i;
                k[e] = widen(kp[o]);
                w[e] = expf(a.log_w[o]);
                r[e] = with_grad ? widen(rp[o]) : 0.f;
            } else {
                k[e] = 0.f;
                w[e] = 1.f;
                r[e] = 0.f;
            }
        }
#pragma unroll
        for (int e = 0; e < NV; ++e) {
            const int idx = tid + e * NT, tt = idx / JS, c = idx % JS, t = t0 + tt;
            v[e] = dy[e] = 0.f;
            if (idx < T * JS && t < a.S) {
                const int64_t o = (((int64_t)b * a.S + t) * a.H + h) * K + slice * JS + c;
                v[e] = widen(vp[o]);
                if (with_grad) dy[e] = a.dy[o];
            }
        }
    }

    __device__ __forceinline__ void store(float (*sr)[K], float (*sk)[K], float (*sw)[K], float (*sv)[JS],
                                          float (*sdy)[JS]) const {
        const int tid = threadIdx.x;
#pragma unroll
        for (int e = 0; e < NR; ++e) {
            const int idx = tid + e * NT, tt = idx / K, i = idx % K;
            sr[tt][i] = r[e];
            sk[tt][i] = k[e];
            sw[tt][i] = w[e];
        }
#pragma unroll
        for (int e = 0; e < NV; ++e) {
            const int idx = tid + e * NT;
            if (idx < T * JS) {
                sv[idx / JS][idx % JS] = v[e];
                sdy[idx / JS][idx % JS] = dy[e];
            }
        }
    }
};

}  // namespace

// The kernels stand outside the anonymous namespace, so that a trace names
// them plainly (wkv6_bwd_walk, wkv6_bwd_sum, wkv6_bwd_du).
template <typename In, int K>
__global__ void __launch_bounds__(K * CQ, MIN_BLOCKS)
wkv6_bwd_walk(const BwdArgs a) {
    constexpr int NT = K * CQ;
    constexpr int NW = NT / 32;
    __shared__ __align__(16) float sr[T][K];
    __shared__ __align__(16) float sk[T][K];
    __shared__ __align__(16) float sw[T][K];
    __shared__ __align__(16) float sv[T][JS];
    __shared__ __align__(16) float sdy[T][JS];
    __shared__ __align__(16) float sdv[T][NW][JS];  // the warps' sums over their rows of dS k
    __shared__ float su[K];
    __shared__ float s_vdy[T];  // v_t . dy_t over the slice
    __shared__ float s_ruk[T];  // sum_i r_t[i] u_i k_t[i] over all K rows

    const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int i = tid >> 2, q = tid & 3;
    const int col = slice * JS + q * CQ;  // this thread's first value column
    const int64_t head = (int64_t)b * a.H + h;
    const int64_t cell = (int64_t)i * K + col;  // (i, col) in a K x K state
    const int64_t plane = (int64_t)a.B * a.S * a.H * K;  // one partial array

    if (tid < K) su[tid] = a.u[h * K + tid];

    // --- the walk forward: the state before every stage ----------------------
    float s[CQ];
    {
        const float4 s0 = a.s0 ? *reinterpret_cast<const float4*>(a.s0 + head * K * K + cell)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        s[0] = s0.x, s[1] = s0.y, s[2] = s0.z, s[3] = s0.w;
    }
    Stage<In, K> st;
    if (a.n_stages > 0) st.load(a, b, h, slice, 0, false);
    for (int c = 0; c < a.n_stages; ++c) {
        __syncthreads();
        st.store(sr, sk, sw, sv, sdy);
        __syncthreads();
        if (c + 1 < a.n_stages) st.load(a, b, h, slice, (c + 1) * T, false);
        *reinterpret_cast<float4*>(a.states + (head * a.n_stages + c) * K * K + cell) =
            make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
        for (int tt = 0; tt < T; ++tt) {
            const float kk = sk[tt][i], ww = sw[tt][i];
            const float4 vv = *reinterpret_cast<const float4*>(&sv[tt][q * CQ]);
            s[0] = fmaf(ww, s[0], kk * vv.x);
            s[1] = fmaf(ww, s[1], kk * vv.y);
            s[2] = fmaf(ww, s[2], kk * vv.z);
            s[3] = fmaf(ww, s[3], kk * vv.w);
        }
    }

    // --- the walk back ---------------------------------------------------------
    float ds[CQ];
    {
        const float4 d = a.ds_out ? *reinterpret_cast<const float4*>(a.ds_out + head * K * K + cell)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        ds[0] = d.x, ds[1] = d.y, ds[2] = d.z, ds[3] = d.w;
    }
    float du = 0.f;
    const float ui = a.u[h * K + i];
    In* dvp = static_cast<In*>(a.dv);
    if (a.n_stages > 0) st.load(a, b, h, slice, (a.n_stages - 1) * T, true);
    for (int c = a.n_stages - 1; c >= 0; --c) {
        const int t0 = c * T;
        __syncthreads();  // the stage before is done with shared memory
        st.store(sr, sk, sw, sv, sdy);
        __syncthreads();
        if (c > 0) st.load(a, b, h, slice, t0 - T, true);
        const float4 sc = *reinterpret_cast<const float4*>(a.states + (head * a.n_stages + c) * K * K + cell);
        // the stage's two sums a token, one warp a token
        for (int tt = warp; tt < T; tt += NW) {
            float ruk = 0.f;
            for (int j = lane; j < K; j += 32) ruk = fmaf(sr[tt][j] * su[j], sk[tt][j], ruk);
            float vdy = lane < JS ? sv[tt][lane] * sdy[tt][lane] : 0.f;
#pragma unroll
            for (int m = 16; m >= 1; m >>= 1) {
                ruk += __shfl_xor_sync(0xffffffffu, ruk, m);
                vdy += __shfl_xor_sync(0xffffffffu, vdy, m);
            }
            if (lane == 0) {
                s_ruk[tt] = ruk;
                s_vdy[tt] = vdy;
            }
        }
        // re-walk the stage forward from its state, keeping S_{t-1}
        float sp[T][CQ];
        s[0] = sc.x, s[1] = sc.y, s[2] = sc.z, s[3] = sc.w;
#pragma unroll
        for (int tt = 0; tt < T; ++tt) {
            const float kk = sk[tt][i], ww = sw[tt][i];
            const float4 vv = *reinterpret_cast<const float4*>(&sv[tt][q * CQ]);
#pragma unroll
            for (int x = 0; x < CQ; ++x) sp[tt][x] = s[x];
            s[0] = fmaf(ww, s[0], kk * vv.x);
            s[1] = fmaf(ww, s[1], kk * vv.y);
            s[2] = fmaf(ww, s[2], kk * vv.z);
            s[3] = fmaf(ww, s[3], kk * vv.w);
        }
        __syncthreads();  // s_ruk, s_vdy
#pragma unroll
        for (int tt = T - 1; tt >= 0; --tt) {
            const int t = t0 + tt;
            const float rr = sr[tt][i], kk = sk[tt][i], ww = sw[tt][i];
            const float4 v4 = *reinterpret_cast<const float4*>(&sv[tt][q * CQ]);
            const float4 g4 = *reinterpret_cast<const float4*>(&sdy[tt][q * CQ]);
            const float vv[CQ] = {v4.x, v4.y, v4.z, v4.w}, gg[CQ] = {g4.x, g4.y, g4.z, g4.w};
            const float vdy = s_vdy[tt];
            float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f, dvs[CQ];
#pragma unroll
            for (int x = 0; x < CQ; ++x) {
                a_dr = fmaf(sp[tt][x], gg[x], a_dr);
                a_dk = fmaf(ds[x], vv[x], a_dk);
                a_dw = fmaf(sp[tt][x], ds[x], a_dw);
                dvs[x] = ds[x] * kk;
            }
            // sums over the slice's columns: the four threads of a row
#pragma unroll
            for (int m = 1; m <= 2; m <<= 1) {
                a_dr += __shfl_xor_sync(0xffffffffu, a_dr, m);
                a_dk += __shfl_xor_sync(0xffffffffu, a_dk, m);
                a_dw += __shfl_xor_sync(0xffffffffu, a_dw, m);
            }
            // sums over the warp's eight rows, one column group a thread
#pragma unroll
            for (int m = 4; m <= 16; m <<= 1) {
#pragma unroll
                for (int x = 0; x < CQ; ++x) dvs[x] += __shfl_xor_sync(0xffffffffu, dvs[x], m);
            }
            if (t < a.S) {
                const int64_t o = (((int64_t)b * a.S + t) * a.H + h) * K + i + (int64_t)slice * 3 * plane;
                if (q == 0) a.part[o] = fmaf(ui * kk, vdy, a_dr);
                if (q == 1) a.part[o + plane] = fmaf(rr * ui, vdy, a_dk);
                if (q == 2) a.part[o + 2 * plane] = ww * a_dw;
            }
            if (lane < CQ) *reinterpret_cast<float4*>(&sdv[tt][warp][q * CQ]) = make_float4(dvs[0], dvs[1], dvs[2], dvs[3]);
            du = fmaf(rr * kk, vdy, du);
#pragma unroll
            for (int x = 0; x < CQ; ++x) ds[x] = fmaf(ww, ds[x], rr * gg[x]);
        }
        __syncthreads();  // sdv
        for (int e = tid; e < T * JS; e += NT) {
            const int tt = e / JS, j = e % JS, t = t0 + tt;
            if (t >= a.S) continue;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w) sum += sdv[tt][w][j];
            sum = fmaf(s_ruk[tt], sdy[tt][j], sum);
            dvp[(((int64_t)b * a.S + t) * a.H + h) * K + slice * JS + j] = narrow<In>(sum);
        }
    }
    *reinterpret_cast<float4*>(a.ds0 + head * K * K + cell) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    if (q == 0) a.du_part[(((int64_t)b * a.n_slices + slice) * a.H + h) * K + i] = du;
}

// The slices' partials summed in slice order: dr, dk in r's type, dlog_w
// f32; four elements a thread.
template <typename In>
__global__ void __launch_bounds__(256)
wkv6_bwd_sum(const float* __restrict__ part, int n_slices, int64_t plane, In* __restrict__ dr,
             In* __restrict__ dk, float* __restrict__ dlog_w) {
    const int64_t quads = plane / 4;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < quads;
         e += (int64_t)gridDim.x * blockDim.x) {
        float4 acc[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int sl = 0; sl < n_slices; ++sl) {
                const float4 p = reinterpret_cast<const float4*>(part + ((int64_t)sl * 3 + g) * plane)[e];
                acc[g].x += p.x, acc[g].y += p.y, acc[g].z += p.z, acc[g].w += p.w;
            }
        }
        const int64_t o = e * 4;
        dr[o] = narrow<In>(acc[0].x), dr[o + 1] = narrow<In>(acc[0].y);
        dr[o + 2] = narrow<In>(acc[0].z), dr[o + 3] = narrow<In>(acc[0].w);
        dk[o] = narrow<In>(acc[1].x), dk[o + 1] = narrow<In>(acc[1].y);
        dk[o + 2] = narrow<In>(acc[1].z), dk[o + 3] = narrow<In>(acc[1].w);
        reinterpret_cast<float4*>(dlog_w)[e] = acc[2];
    }
}

// du: the (b, slice) partials summed in that order, in u's type.
template <typename U>
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, int B, int n_slices, int HK, U* __restrict__ du) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= HK) return;
    float sum = 0.f;
    for (int p = 0; p < B * n_slices; ++p) sum += du_part[(int64_t)p * HK + e];
    du[e] = narrow<U>(sum);
}

namespace {

int64_t work_floats(int B, int S, int H, int K) {
    const int64_t n_stages = (S + T - 1) / T, n_slices = K / JS;
    return (int64_t)B * H * n_stages * K * K + 3 * n_slices * (int64_t)B * S * H * K + (int64_t)B * n_slices * H * K;
}

template <typename In, int K>
int launch(BwdArgs a, void* dr, void* dk, float* dlog_w, void* du, int u_dtype, cudaStream_t s) {
    wkv6_bwd_walk<In, K><<<dim3(a.n_slices, a.H, a.B), K * CQ, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t plane = (int64_t)a.B * a.S * a.H * K;
    if (plane > 0) {
        const int64_t quads = plane / 4;
        const int blocks = (int)((quads + 255) / 256 < 132 * 16 ? (quads + 255) / 256 : 132 * 16);
        wkv6_bwd_sum<In><<<blocks, 256, 0, s>>>(a.part, a.n_slices, plane, static_cast<In*>(dr),
                                                 static_cast<In*>(dk), dlog_w);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int HK = a.H * K;
    if (u_dtype == DT_F32)
        wkv6_bwd_du<float><<<(HK + 255) / 256, 256, 0, s>>>(a.du_part, a.B, a.n_slices, HK, static_cast<float*>(du));
    else
        wkv6_bwd_du<__nv_bfloat16><<<(HK + 255) / 256, 256, 0, s>>>(a.du_part, a.B, a.n_slices, HK,
                                                                    static_cast<__nv_bfloat16*>(du));
    return (int)cudaGetLastError();
}

}  // namespace

// One backward on `stream` of device `device` (this library carries its own
// CUDA runtime, so the launch names its device): the walk, the sum of the
// slices' partials, and du's sum.  K is 16 or 64; dtype DT_F32 or DT_BF16
// for r, k, v (and dr, dk, dv), u_dtype for du; s0 and ds_out may be null;
// `work` holds `work_n` floats, at least work_floats() (the states before
// every stage, the slices' partials of dr, dk, dlog_w and of du; Python's
// kernel.bwd_work_floats); every pointer
// 16-byte aligned.  Returns a cudaError_t, 0 on success.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                               const float* s0, const float* dy, const float* ds_out, void* dr, void* dk, void* dv,
                               float* dlog_w, void* du, float* ds0, float* work, int64_t work_n, int dtype,
                               int u_dtype, int B, int S, int H, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if ((K != 16 && K != 64) || (dtype != DT_F32 && dtype != DT_BF16) || (u_dtype != DT_F32 && u_dtype != DT_BF16))
        return (int)cudaErrorInvalidValue;
    if (work_n < work_floats(B, S, H, K)) return (int)cudaErrorInvalidValue;
    if (B == 0 || H == 0) return 0;
    BwdArgs a;
    a.r = r, a.k = k, a.v = v, a.log_w = log_w, a.u = u, a.s0 = s0, a.dy = dy, a.ds_out = ds_out;
    a.dv = dv, a.ds0 = ds0;
    a.B = B, a.S = S, a.H = H, a.n_stages = (S + T - 1) / T, a.n_slices = K / JS;
    a.states = work;
    a.part = work + (int64_t)B * H * a.n_stages * K * K;
    a.du_part = a.part + 3 * (int64_t)a.n_slices * B * S * H * K;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return K == 16 ? launch<float, 16>(a, dr, dk, dlog_w, du, u_dtype, s)
                       : launch<float, 64>(a, dr, dk, dlog_w, du, u_dtype, s);
    return K == 16 ? launch<__nv_bfloat16, 16>(a, dr, dk, dlog_w, du, u_dtype, s)
                   : launch<__nv_bfloat16, 64>(a, dr, dk, dlog_w, du, u_dtype, s);
}
