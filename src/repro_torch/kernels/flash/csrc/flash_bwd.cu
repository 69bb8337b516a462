// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_fwd.cu, in bf16 with f32 accumulation.
//
// Replaces no TPU kernel: the JAX package trains through flash_attention_jnp
// (src/repro/models/attention.py:54) and takes its gradient from XLA's
// autodiff of that scan.  This is how the port computes the same gradient on
// the card (kernels/flash/ops.py::FlashAttention.backward).
//
// What it computes, for q (B, S, H, D) and k, v (B, S, Hkv, D) in bf16, all
// contiguous, query head h reading kv head h / (H / Hkv), given the
// forward's output out and its gradient dout (B, S, H, D) bf16:
//   s     = (q . k^T) * scale;  s = c * tanh(s / c) when softcap c > 0
//   mask  = the forward's (causal, and q - k < window when window > 0;
//           queries and keys of one length S)
//   lse   = log(sum over unmasked keys of exp(s))  per (b, query, h)
//   p     = exp(s - lse) for unmasked keys, 0 for masked ones
//   delta = rowsum(dout * out);  dp = dout . v^T
//   ds    = p * (dp - delta);  ds *= 1 - (s / c)^2 (softcap)
//   dq    = scale * ds . k;  dk = scale * sum over the G heads of ds^T . q;
//   dv    = sum over the G heads of p^T . dout
// lse, p's row statistics, is recomputed here: the forward kernel returns
// none.  p and ds are rounded to bf16 only as operands of the products; the
// outputs are cast to bf16 once, at the end.
//
// Rows whose gradient cancels.  In a trained model's layers the keys of a
// head are close to one vector, so dq = ds . k sums terms that cancel
// while sum over keys of ds is 0; and a row whose output is one key's value
// (query 0 under a causal mask; a saturated softmax) has dp - delta = 0 for
// that key in exact arithmetic.  So delta is taken by the same products as
// dp (dout times out's rows, where dp is dout times v's), which makes dp -
// delta exactly 0 there, as in the float64 plain version; and ds enters
// dq's product as two bf16 parts (its rounding and the rounding's
// residue), so its rounding does not swamp what survives the cancellation.
// (With ds rounded once and delta a separate f32 sum, the kernel read up to
// 2.2x the per-element limit of ref.BWD_TOL on starcoder2-3b's layers in
// chip_smoke.py's phase 15, and SDPA's backward up to 1.9x on the same
// calls; with both changes the kernel read at most 0.55x, NVIDIA H100 80GB
// HBM3.)
//
// Two launches, neither with atomics, so reruns are bitwise equal:
//   1. flash_bwd_dq_kernel: one block of 4 warps per (b, h, 64 queries),
//      16 query rows a warp.  It takes each row's delta (a warp's dout .
//      out^T over its 16 rows, the diagonal), then pass 1 walks the key
//      tiles the block's queries may see, 32 keys a tile, and keeps each
//      row's running max and sum (the statistics pass: one extra q . k^T);
//      it writes lse and delta.  Pass 2 walks the same tiles again for s,
//      dp and ds and accumulates dq = ds . k in registers.
//   2. flash_bwd_dkv_kernel: one block of 8 warps per (b, kv head, 64 keys):
//      4 slices of 16 keys, each taken by two warps, one for either half of
//      a 64-query tile.  It walks the G query heads of its kv head and, for
//      each, the query tiles that may see its keys, computing the tile
//      transposed (s^T = k . q^T, rows are keys) so that p^T and ds^T are
//      the A operands of dv += p^T . dout and dk += ds^T . q straight from
//      the accumulator registers.  dk and dv stay in registers until the
//      block ends; then the second half's sums go through shared memory to
//      the first half's warps, which add them in a fixed order.  The
//      parts are BW_PARTS and the slices BW_SLICES: 4 warps a block (one
//      part) left the tensor cores waiting, and blocks of 32 keys in 2
//      slices x 4 parts ran slower, loading each query tile for half the
//      work (scripts/flash_bwd_shapes.py times another source beside this).
//   Under a causal mask a warp skips the products of a tile that its rows
//   cannot see (it still takes its part in the tile's loads).
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate); every operand
// fragment is read from shared memory by ldmatrix, and the tiles read as B
// of a product along their rows (k for dq; q and dout for dk and dv) by its
// transposing form, so no tile is kept twice.  Rows are padded by 8
// elements, so the 8 rows of one 8 x 8 matrix fall in different banks.
//
// Bound.  The gradient is five products of 2 * D FLOPs per unmasked
// query-key pair and head (s, dp, dq, dk, dv: 10 * D * pairs * B * H), and
// the statistics pass adds one q . k^T (2 * D * pairs * B * H); against 989
// TFLOP/s bf16 dense on an H100 SXM the operations bound it (chip_smoke.py
// states the bound with that pass named).  The kernel also recomputes s and
// dp in both launches, which the bound does not count.  At starcoder2-3b's
// training shape it runs at about 6x SDPA's backward and 16x the bound
// (NVIDIA H100 80GB HBM3, scripts/flash_bwd_shapes.py): mma.sync, no
// overlap of a tile's loads with its products, and 128 dkv blocks, one an
// SM.  The redesign (lse from the forward, wgmma fed by TMA, a pipeline of
// tiles) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define BW_THREADS 128      // the dq kernel's 4 warps
#define BW_BLOCK 64         // queries a dq block owns
#define BW_TILE 32          // keys a step of the dq kernel walks
#define BW_DKV_THREADS 256  // the dkv kernel's 8 warps: BW_SLICES key slices x BW_PARTS query parts
#define BW_KEYS 64          // keys a dkv block owns
#define BW_SLICES 4         // slices of 16 keys
#define BW_PARTS 2          // parts of a query tile, 32 queries each
#define BW_QTILE 64         // queries a step of the dkv kernel walks
#define BW_PAD 8            // elements of padding of a shared-memory row

static constexpr float BW_NEG = -2.0e38f;

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16 x 16, row-major) . B (16 x 8, column-major) + D, in f32.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major tile M (row stride ld): four 8 x 8 matrices, lanes 0-15 giving
// the rows of the left two and lanes 16-31 those of the right two.
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* M, int ld, int r0, int c0, int lane) {
    const uint32_t at = smem_addr(M + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(at));
}

// The B fragment (16 x 8) whose column n is row n0 + n of the row-major tile
// N, over N's columns [c0, c0 + 16): B = N[n0 : n0 + 8, c0 : c0 + 16]^T.
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* N, int ld, int n0, int c0, int lane) {
    const uint32_t at = smem_addr(N + (n0 + (lane & 7)) * ld + c0 + ((lane >> 3) & 1) * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0]), "=r"(b[1]) : "r"(at));
}

// The B fragment (16 x 8) of rows [k0, k0 + 16) and columns [n0, n0 + 8)
// of the row-major tile M itself (B = M[k0 : k0 + 16, n0 : n0 + 8]): the
// transposing load, so no transposed copy of M is kept.
__device__ __forceinline__ void frag_bt(uint32_t b[2], const bf16* M, int ld, int k0, int n0, int lane) {
    const uint32_t at = smem_addr(M + (k0 + (lane & 15)) * ld + n0);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0]), "=r"(b[1]) : "r"(at));
}

// The A fragment of a 16 x 16 block held as two 16 x 8 accumulators
// (columns 0-7 in c0, 8-15 in c1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float bf16_residue(float x) {
    return x - __bfloat162float(__float2bfloat16_rn(x));
}

// The same block's second bf16 part: what its rounding to bf16 left out.
__device__ __forceinline__ void acc_to_a_residue(uint32_t a[4], const float c0[4], const float c1[4]) {
    a[0] = pack_bf16(bf16_residue(c0[0]), bf16_residue(c0[1]));
    a[1] = pack_bf16(bf16_residue(c0[2]), bf16_residue(c0[3]));
    a[2] = pack_bf16(bf16_residue(c1[0]), bf16_residue(c1[1]));
    a[3] = pack_bf16(bf16_residue(c1[2]), bf16_residue(c1[3]));
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal, int window) {
    return qi < S && kj < S && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// The score of an accumulated q . k, scaled and softcapped; *th is
// tanh(s / c) (s / c after the cap), which the cap's derivative reads.
__device__ __forceinline__ float score(float acc, float scale, float softcap, float* th) {
    const float s = acc * scale;
    if (softcap > 0.f) {
        *th = tanhf(s / softcap);
        return softcap * *th;
    }
    *th = 0.f;
    return s;
}

// rows x D of src (row stride `stride` elements) into the row-major tile
// dst (row stride ld), 16 bytes a thread; rows at or past `valid` read
// zeros.
template <int D, int THREADS = BW_THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int64_t stride, int rows,
                                          int valid) {
    constexpr int V = D / 8;
    for (int i = threadIdx.x; i < rows * V; i += THREADS) {
        const int r = i / V, c = (i - r * V) * 8;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid) x = *reinterpret_cast<const uint4*>(src + (int64_t)r * stride + c);
        *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
}

template <int D>
struct BwdSmem {
    static constexpr int LD = D + BW_PAD;  // a tile's row stride
    // dq: q, dout and out (64 rows), k and v (32 rows)
    static constexpr size_t DQ = sizeof(bf16) * ((size_t)3 * BW_BLOCK * LD + (size_t)2 * BW_TILE * LD);
    // dkv: k and v (BW_KEYS rows), q and dout (64 rows), whose room a query
    // part's dk and dv sums take at the end; then lse and delta of the 64
    // queries
    static constexpr size_t KV = sizeof(bf16) * (size_t)2 * BW_KEYS * LD;
    static constexpr size_t QTILES = sizeof(bf16) * (size_t)2 * BW_QTILE * LD;
    static constexpr size_t DKV = KV + QTILES + sizeof(float) * 2 * BW_QTILE;
    static_assert(KV + QTILES >= sizeof(float) * 2 * BW_KEYS * D, "a part's dk and dv sums fit in the tiles");
};

template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ out, const bf16* __restrict__ dout, float* __restrict__ delta,
                    float* __restrict__ lse, bf16* __restrict__ dq, int S, int H, int Hkv, int causal, int window,
                    float scale, float softcap) {
    using L = BwdSmem<D>;
    constexpr int LD = L::LD, NT = BW_TILE / 8, ND = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + BW_BLOCK * LD;
    bf16* Os = dOs + BW_BLOCK * LD;
    bf16* Ks = Os + BW_BLOCK * LD;
    bf16* Vs = Ks + BW_TILE * LD;

    const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int q0 = blockIdx.x * BW_BLOCK;
    const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;
    const bf16* kb = k + ((int64_t)b * S * Hkv + hk) * D;
    const bf16* vb = v + ((int64_t)b * S * Hkv + hk) * D;
    const int64_t row0 = ((int64_t)b * S + q0) * H + h;  // (b, q0, h) in (B, S, H)

    load_rows<D>(Qs, LD, q + row0 * D, qs, BW_BLOCK, S - q0);
    load_rows<D>(dOs, LD, dout + row0 * D, qs, BW_BLOCK, S - q0);
    load_rows<D>(Os, LD, out + row0 * D, qs, BW_BLOCK, S - q0);
    __syncthreads();

    // delta of this warp's 16 rows: the diagonal of dout . out^T over them,
    // by the products (and in the order over D) that give dp in pass 2.
    // Row g's and row g + 8's entries sit with lane 4 g + g / 2.
    float dacc[2][4] = {};
#pragma unroll
    for (int c = 0; c < D; c += 16) {
        uint32_t ao[4];
        frag_a(ao, dOs, LD, warp * 16, c, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            uint32_t bb[2];
            frag_b(bb, Os, LD, warp * 16 + j * 8, c, lane);
            mma16816(dacc[j], ao, bb);
        }
    }
    const int diag = g * 4 + (g >> 1);
    float row_delta[2];
    row_delta[0] = __shfl_sync(0xffffffffu, (g & 1) ? dacc[0][1] : dacc[0][0], diag);
    row_delta[1] = __shfl_sync(0xffffffffu, (g & 1) ? dacc[1][3] : dacc[1][2], diag);

    const int k_hi = causal ? min(S, q0 + BW_BLOCK) : S;
    const int k_lo = window > 0 ? (max(0, q0 - window + 1) / BW_TILE) * BW_TILE : 0;
    const int r_base = warp * 16 + g;  // this thread's rows: r_base and r_base + 8 of the block

    // pass 1: each row's max and sum over the keys it sees
    float m[2] = {BW_NEG, BW_NEG}, l[2] = {0.f, 0.f};
    for (int k0 = k_lo; k0 < k_hi; k0 += BW_TILE) {
        __syncthreads();
        load_rows<D>(Ks, LD, kb + (int64_t)k0 * ks, ks, BW_TILE, S - k0);
        __syncthreads();
        // a causal tile whose keys all follow this warp's queries adds nothing
        if (causal && k0 > q0 + warp * 16 + 15) continue;
        float sacc[NT][4] = {};
#pragma unroll
        for (int c = 0; c < D; c += 16) {
            uint32_t a[4];
            frag_a(a, Qs, LD, warp * 16, c, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t bb[2];
                frag_b(bb, Ks, LD, j * 8, c, lane);
                mma16816(sacc[j], a, bb);
            }
        }
        float tmax[2] = {BW_NEG, BW_NEG};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = q0 + r_base + 8 * (e >> 1), kj = k0 + j * 8 + 2 * t + (e & 1);
                float th;
                const float s = score(sacc[j][e], scale, softcap, &th);
                sacc[j][e] = visible(qi, kj, S, causal, window) ? s : BW_NEG;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], sacc[j][e]);
            }
        }
        float tsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
            const float m_new = fmaxf(m[i], tmax[i]);
            l[i] *= __expf(m[i] - m_new);
            m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = q0 + r_base + 8 * (e >> 1), kj = k0 + j * 8 + 2 * t + (e & 1);
                if (visible(qi, kj, S, causal, window)) tsum[e >> 1] += __expf(sacc[j][e] - m[e >> 1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 1);
            tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 2);
            l[i] += tsum[i];
        }
    }
    float row_lse[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + r_base + 8 * i;
        row_lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;  // a row that sees no key: p = 0
        if (qi < S && t == 0) {
            const int64_t at = ((int64_t)b * S + qi) * H + h;
            lse[at] = row_lse[i];
            delta[at] = row_delta[i];
        }
    }

    // pass 2: dq = scale * ds . k, ds in two bf16 parts
    float dqacc[ND][4] = {};
    for (int k0 = k_lo; k0 < k_hi; k0 += BW_TILE) {
        __syncthreads();
        load_rows<D>(Ks, LD, kb + (int64_t)k0 * ks, ks, BW_TILE, S - k0);
        load_rows<D>(Vs, LD, vb + (int64_t)k0 * ks, ks, BW_TILE, S - k0);
        __syncthreads();
        if (causal && k0 > q0 + warp * 16 + 15) continue;
        float sacc[NT][4] = {}, pacc[NT][4] = {};
#pragma unroll
        for (int c = 0; c < D; c += 16) {
            uint32_t a[4], ao[4];
            frag_a(a, Qs, LD, warp * 16, c, lane);
            frag_a(ao, dOs, LD, warp * 16, c, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t bb[2];
                frag_b(bb, Ks, LD, j * 8, c, lane);
                mma16816(sacc[j], a, bb);
                frag_b(bb, Vs, LD, j * 8, c, lane);
                mma16816(pacc[j], ao, bb);
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e >> 1;
                const int qi = q0 + r_base + 8 * i, kj = k0 + j * 8 + 2 * t + (e & 1);
                float th;
                const float s = score(sacc[j][e], scale, softcap, &th);
                float ds = 0.f;
                if (visible(qi, kj, S, causal, window)) {
                    ds = __expf(s - row_lse[i]) * (pacc[j][e] - row_delta[i]);
                    if (softcap > 0.f) ds *= 1.f - th * th;
                }
                sacc[j][e] = ds;
            }
        }
#pragma unroll
        for (int kc = 0; kc < NT / 2; ++kc) {
            uint32_t a[4], ar[4];
            acc_to_a(a, sacc[2 * kc], sacc[2 * kc + 1]);
            acc_to_a_residue(ar, sacc[2 * kc], sacc[2 * kc + 1]);
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                uint32_t bb[2];
                frag_bt(bb, Ks, LD, kc * 16, n * 8, lane);
                mma16816(dqacc[n], a, bb);
                mma16816(dqacc[n], ar, bb);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + r_base + 8 * i;
        if (qi >= S) continue;
        bf16* dst = dq + (((int64_t)b * S + qi) * H + h) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t) =
                pack_bf16(dqacc[n][2 * i] * scale, dqacc[n][2 * i + 1] * scale);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(BW_DKV_THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ delta,
                     const float* __restrict__ lse, bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                     int Hkv, int causal, int window, float scale, float softcap) {
    using L = BwdSmem<D>;
    constexpr int LD = L::LD, QW = BW_QTILE / BW_PARTS, NT = QW / 8, ND = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + BW_KEYS * LD;
    bf16* Qs = Vs + BW_KEYS * LD;
    bf16* dOs = Qs + BW_QTILE * LD;
    float* lse_s = reinterpret_cast<float*>(smem_raw + L::KV + L::QTILES);
    float* del_s = lse_s + BW_QTILE;
    float* sums = reinterpret_cast<float*>(smem_raw);  // a query part's dk and dv, at the end

    const int hk = blockIdx.y, b = blockIdx.z, G = H / Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int slice = warp % BW_SLICES, part = warp / BW_SLICES;  // this warp's 16 keys and 16 queries a tile
    const int k0 = blockIdx.x * BW_KEYS;
    const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;
    const int64_t krow0 = ((int64_t)b * S + k0) * Hkv + hk;

    load_rows<D, BW_DKV_THREADS>(Ks, LD, k + krow0 * D, ks, BW_KEYS, S - k0);
    load_rows<D, BW_DKV_THREADS>(Vs, LD, v + krow0 * D, ks, BW_KEYS, S - k0);

    // the queries that may see a key of [k0, k0 + 32)
    const int q_lo = causal ? (k0 / BW_QTILE) * BW_QTILE : 0;
    const int q_hi = window > 0 ? min(S, k0 + BW_KEYS - 1 + window) : S;
    const int r_base = slice * 16 + g;  // this thread's keys: r_base and r_base + 8 of the block
    const int qoff = part * QW;         // this warp's queries in the tile

    float dkacc[ND][4] = {}, dvacc[ND][4] = {};
    for (int hh = 0; hh < G; ++hh) {
        const int h = hk * G + hh;
        for (int q0 = q_lo; q0 < q_hi; q0 += BW_QTILE) {
            __syncthreads();
            const int64_t row0 = ((int64_t)b * S + q0) * H + h;
            load_rows<D, BW_DKV_THREADS>(Qs, LD, q + row0 * D, qs, BW_QTILE, S - q0);
            load_rows<D, BW_DKV_THREADS>(dOs, LD, dout + row0 * D, qs, BW_QTILE, S - q0);
            if (threadIdx.x < BW_QTILE) {
                const int qi = q0 + threadIdx.x;
                const int64_t at = ((int64_t)b * S + qi) * H + h;
                lse_s[threadIdx.x] = qi < S ? lse[at] : INFINITY;
                del_s[threadIdx.x] = qi < S ? delta[at] : 0.f;
            }
            __syncthreads();
            // a causal tile whose queries all precede this warp's keys adds nothing
            if (causal && q0 + qoff + QW - 1 < k0 + slice * 16) continue;
            // s^T = k . q^T and dp^T = v . dout^T: rows are this warp's keys
            float sacc[NT][4] = {}, pacc[NT][4] = {};
#pragma unroll
            for (int c = 0; c < D; c += 16) {
                uint32_t a[4], av[4];
                frag_a(a, Ks, LD, slice * 16, c, lane);
                frag_a(av, Vs, LD, slice * 16, c, lane);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    uint32_t bb[2];
                    frag_b(bb, Qs, LD, qoff + j * 8, c, lane);
                    mma16816(sacc[j], a, bb);
                    frag_b(bb, dOs, LD, qoff + j * 8, c, lane);
                    mma16816(pacc[j], av, bb);
                }
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kj = k0 + r_base + 8 * (e >> 1), qc = qoff + j * 8 + 2 * t + (e & 1), qi = q0 + qc;
                    float th;
                    const float s = score(sacc[j][e], scale, softcap, &th);
                    float p = 0.f, ds = 0.f;
                    if (visible(qi, kj, S, causal, window)) {
                        p = __expf(s - lse_s[qc]);
                        ds = p * (pacc[j][e] - del_s[qc]);
                        if (softcap > 0.f) ds *= 1.f - th * th;
                    }
                    sacc[j][e] = p;
                    pacc[j][e] = ds;
                }
            }
            // dv += p^T . dout and dk += ds^T . q, 16 queries a step
#pragma unroll
            for (int kc = 0; kc < NT / 2; ++kc) {
                uint32_t ap[4], as[4];
                acc_to_a(ap, sacc[2 * kc], sacc[2 * kc + 1]);
                acc_to_a(as, pacc[2 * kc], pacc[2 * kc + 1]);
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    uint32_t bb[2];
                    frag_bt(bb, dOs, LD, qoff + kc * 16, n * 8, lane);
                    mma16816(dvacc[n], ap, bb);
                    frag_bt(bb, Qs, LD, qoff + kc * 16, n * 8, lane);
                    mma16816(dkacc[n], as, bb);
                }
            }
        }
    }
    // parts 1, 2, 3 in turn hand their sums through shared memory to part
    // 0's warps of the same keys, which add them in that order and write
    constexpr int SLOT = BW_SLICES * 32;  // one accumulator element of every (slice, lane)
    const int me = slice * 32 + lane;
    for (int p = 1; p < BW_PARTS; ++p) {
        __syncthreads();
        if (part == p) {
#pragma unroll
            for (int n = 0; n < ND; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sums[(n * 4 + e) * SLOT + me] = dkacc[n][e];
                    sums[(ND * 4 + n * 4 + e) * SLOT + me] = dvacc[n][e];
                }
            }
        }
        __syncthreads();
        if (part == 0) {
#pragma unroll
            for (int n = 0; n < ND; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    dkacc[n][e] += sums[(n * 4 + e) * SLOT + me];
                    dvacc[n][e] += sums[(ND * 4 + n * 4 + e) * SLOT + me];
                }
            }
        }
    }
    if (part != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kj = k0 + r_base + 8 * i;
        if (kj >= S) continue;
        const int64_t at = (((int64_t)b * S + kj) * Hkv + hk) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<uint32_t*>(dk + at + n * 8 + 2 * t) =
                pack_bf16(dkacc[n][2 * i] * scale, dkacc[n][2 * i + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at + n * 8 + 2 * t) =
                pack_bf16(dvacc[n][2 * i], dvacc[n][2 * i + 1]);
        }
    }
}

template <int D>
static int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* out, const bf16* dout,
                      float* delta, float* lse, bf16* dq, bf16* dk, bf16* dv, int B, int S, int H, int Hkv,
                      int causal, int window, float scale, float softcap, cudaStream_t stream) {
    using L = BwdSmem<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::DQ);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DKV);
    if (err != cudaSuccess) return (int)err;
    const int q_tiles = (S + BW_BLOCK - 1) / BW_BLOCK, k_tiles = (S + BW_KEYS - 1) / BW_KEYS;
    flash_bwd_dq_kernel<D><<<dim3(q_tiles, H, B), BW_THREADS, L::DQ, stream>>>(
        q, k, v, out, dout, delta, lse, dq, S, H, Hkv, causal, window, scale, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<D><<<dim3(k_tiles, Hkv, B), BW_DKV_THREADS, L::DKV, stream>>>(
        q, k, v, dout, delta, lse, dk, dv, S, H, Hkv, causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

// dq, dk, dv (and delta and lse, scratch of B * S * H floats each) from q,
// k, v, out and dout as the header states.  Returns 0, a cudaError_t, or
// cudaErrorInvalidValue for a head dim the library is not built for.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                                const void* dout, void* delta, void* lse, void* dq, void* dk, void* dv, int B,
                                int S, int H, int Hkv, int D, int causal, int window, float scale,
                                float softcap, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0 || H == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BW_ARGS                                                                                             \
    static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),                  \
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),          \
        static_cast<float*>(lse),                                                                            \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, H, Hkv, causal, window, \
        scale, softcap, s
    switch (D) {
        case 16: return launch_bwd<16>(BW_ARGS);
        case 32: return launch_bwd<32>(BW_ARGS);
        case 64: return launch_bwd<64>(BW_ARGS);
        case 128: return launch_bwd<128>(BW_ARGS);
    }
#undef BW_ARGS
    return (int)cudaErrorInvalidValue;
}
