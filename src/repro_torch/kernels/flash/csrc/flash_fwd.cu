// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash/kernel.py::
// flash_attention_pallas (its body _kernel).
//
// What it computes, for q (B, Sq, H, D) and k, v (B, Sk, Hkv, D), all
// contiguous and of one type (f32 or bf16), query head h reading kv head
// h / (H / Hkv) (GQA without repeating k and v):
//   s    = (q . k^T) * scale                    in f32
//   s    = softcap * tanh(s / softcap)          when softcap > 0
//   mask = k < Sk, and k <= q + (Sk - Sq) when causal, and
//          q + (Sk - Sq) - k < window when window > 0
//          (queries align to the end of the keys)
//   out  = sum_k p v / sum_k p with p = exp(s - running max) for unmasked
//          keys and 0 for masked ones; rows with no unmasked key give 0.
// The running max, sum and accumulator are f32; p is rounded to bf16 only as
// the operand of p.v, after its row sum is taken; the output is cast to q's
// type (round to nearest even) once, at the end.  The order is the Pallas
// kernel's: scale, then softcap, then mask.  No sum is split over blocks and
// nothing is atomic, so reruns are bitwise equal.
//
// Bound.  FLOPs = 4 * D * (unmasked query-key pairs) * B * H (two products
// of one multiply-add per pair and feature); bytes = those of q, k, v and o,
// each moved once.  bound = max(FLOPs / 989 TFLOP/s bf16 dense,
// bytes / 3.35 TB/s) on an H100 SXM: at gemma2-9b's prefill shapes (D = 256,
// S >= 2048) the operations bound it by two orders of magnitude.
//
// bf16, the serving path (flash_fwd_wgmma_kernel), built for the tensor
// cores' full rate, which only wgmma reaches:
//   * A block of 384 threads owns 128 queries of one (b, h): warpgroup 0 is
//     the producer, warpgroups 1 and 2 the consumers of 64 query rows each.
//     setmaxnreg gives the producer 24 registers a thread and each consumer
//     240 (24 * 128 + 240 * 256 = 64,512 of the SM's 65,536; at D = 256 the
//     64 x 256 f32 accumulator is 128 of a consumer thread's registers).
//   * One producer thread issues TMA loads: the q tile once, then the k and
//     v tiles of the keys some query of the block may see ([k_lo, k_hi):
//     tiles wholly above the causal diagonal or outside the window are never
//     loaded) into a ring of 2 stages, each with a full and an empty
//     mbarrier.  The tensor maps are 4-D (D, heads, S, B), so a tile past
//     the end of a sequence reads zeros, not the next sequence.  The TMA
//     writes the 128-byte swizzle (64-byte at D = 32) that wgmma reads.
//   * Tiles: 128 queries x 80 keys at D = 256 (q 64 KB + 2 x (40 + 40) KB of
//     k and v = 225 KB of shared memory, one block an SM; 80 keys ran faster
//     than 64 on the card, the fixed cost of a tile's softmax spread over
//     more keys), 128 x 128 at D <= 128.
//   * S = q.k^T is wgmma m64nBKk16 with both operands in shared memory,
//     k-major.  O += p.v is wgmma m64nDk16 with p as the register A operand
//     (S's accumulator fragment, rounded to bf16, is A's fragment) and v as
//     B, MN-major through its descriptor, so v is never transposed.
//   * Overlap.  A consumer issues tile t's S and tile t-1's p.v together,
//     then runs tile t's softmax while p.v runs; the two consumers take
//     turns at issuing (named barriers), so one's softmax runs under the
//     other's products.
//   * Softmax in log2 units on the special-function units: one ex2 per
//     score, and for the softcap one tanh.approx (capped_log2).  Against
//     the plain version it reads as close as 1 - 2 / (1 + 2^(2y log2 e))
//     by ex2 and rcp, with scores below the cap and with scores up to
//     about 3x the cap, where tanh bends (bf16's rounding of p and of the
//     output sets both readings), and costs 10% less.  Full tiles skip the mask arithmetic; a warp whose rows' max did
//     not move skips rescaling its accumulator.  Row max and sum are
//     combined across the quad of lanes that holds a row in a fixed order.
//   * Grid: one block per (b, h, q tile), the tiles of one (b, h) in a row,
//     longest first, so the causal tail is short and k and v stay in L2.
//   * Row statistics for the backward (flash_fwd_lse_launch; the serving
//     path's flash_fwd_launch passes none): the epilogue writes each row's
//     log-sum-exp lse = ln 2 * (m + log2 l) from the log2-unit running max
//     m and sum l it already holds, in natural-log units, (B, H, Sq) f32,
//     +inf for a row that sees no key.  flash_bwd.cu reads it and rescores
//     exactly as this kernel scored (capped_log2 under a softcap).
//   Where the time goes: the products, at 500-560 TFLOP/s of the 989 peak at
//   gemma2-9b's prefill shapes; the rest is each block's start (barriers, the
//   q tile and the first k tile in flight before any product) and its
//   epilogue (stores from registers while the SM's tensor cores idle), which
//   a persistent block per SM would overlap with the next tile.
// f32 (flash_fwd_kernel), outside the serving path: CUDA-core f32 FMA, since
//   TF32 would not hold the 2e-3 tolerance: eight warps of 8 queries, q
//   and k rows padded by 4 floats so that the lanes' 16-byte reads of 32
//   different k rows hit 32 different banks, an 8 x (D / 32) accumulator
//   slice in each lane's registers.
#include "flash_common.cuh"

#define FA_BQ 64                     // query rows of a block
#define FA_BK 64                     // keys of a tile
#define FA_ROWS 8                    // query rows of a warp
#define FA_WARPS (FA_BQ / FA_ROWS)
#define FA_THREADS (FA_WARPS * 32)
#define FA_PAD 4                     // floats of padding of a q or k row

enum { DT_F32 = 0, DT_BF16 = 1 };

static constexpr float FA_NEG = -2.0e38f;  // the Pallas kernel's NEG

// rows x D floats from src (row stride `stride` elements) into shared memory
// with row stride `ld`, 16 bytes a thread; rows at or past `valid` are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t stride,
                                          int rows, int valid) {
    constexpr int PER_ROW = D / 4;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += FA_THREADS) {
        const int r = i / PER_ROW, c = (i - r * PER_ROW) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid) x = *reinterpret_cast<const float4*>(src + r * stride + c);
        *reinterpret_cast<float4*>(dst + r * ld + c) = x;
    }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <int D>
constexpr size_t smem_floats() {
    return (size_t)FA_BQ * (D + FA_PAD) + (size_t)FA_BK * (D + FA_PAD) + (size_t)FA_BK * D
           + (size_t)FA_BQ * FA_BK;
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, int Sq, int Sk, int H, int Hkv, int causal, int window,
                 float scale, float softcap) {
    constexpr int NC = D / 32;       // accumulator columns of a lane: d = lane + 32 c
    constexpr int LD = D + FA_PAD;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // FA_BQ x LD
    float* Ks = Qs + FA_BQ * LD;                  // FA_BK x LD
    float* Vs = Ks + FA_BK * LD;                  // FA_BK x D
    float* Ps = Vs + FA_BK * D;                   // FA_BQ x FA_BK

    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * FA_BQ;
    const int q_valid = min(FA_BQ, Sq - q0);
    const int off = Sk - Sq;
    const int r0 = warp * FA_ROWS;

    const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
    const float* qg = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
    const float* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
    const float* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
    float* og = o + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;

    // the keys some query of this tile may see
    const int first_pos = q0 + off, last_pos = q0 + q_valid - 1 + off;
    const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
    const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;

    float acc[FA_ROWS][NC];
    float m[FA_ROWS], l[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
        m[r] = FA_NEG;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }

    load_tile<D>(Qs, LD, qg, q_stride, FA_BQ, q_valid);

    for (int kt0 = (k_lo / FA_BK) * FA_BK; kt0 < k_hi; kt0 += FA_BK) {
        __syncthreads();  // the last tile's reads are done; the q tile is in
        const int k_valid = min(FA_BK, Sk - kt0);
        load_tile<D>(Ks, LD, kg + kt0 * kv_stride, kv_stride, FA_BK, k_valid);
        load_tile<D>(Vs, D, vg + kt0 * kv_stride, kv_stride, FA_BK, k_valid);
        __syncthreads();

        // scores of keys kt0 + lane and kt0 + lane + 32 for the warp's rows
        float s[FA_ROWS][2];
#pragma unroll
        for (int r = 0; r < FA_ROWS; ++r) s[r][0] = s[r][1] = 0.f;
        const float* ka = Ks + lane * LD;
        const float* kb = Ks + (lane + 32) * LD;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 x0 = *reinterpret_cast<const float4*>(ka + d);
            const float4 x1 = *reinterpret_cast<const float4*>(kb + d);
#pragma unroll
            for (int r = 0; r < FA_ROWS; ++r) {
                const float4 y = *reinterpret_cast<const float4*>(Qs + (r0 + r) * LD + d);
                s[r][0] = fmaf(y.x, x0.x, s[r][0]);
                s[r][0] = fmaf(y.y, x0.y, s[r][0]);
                s[r][0] = fmaf(y.z, x0.z, s[r][0]);
                s[r][0] = fmaf(y.w, x0.w, s[r][0]);
                s[r][1] = fmaf(y.x, x1.x, s[r][1]);
                s[r][1] = fmaf(y.y, x1.y, s[r][1]);
                s[r][1] = fmaf(y.z, x1.z, s[r][1]);
                s[r][1] = fmaf(y.w, x1.w, s[r][1]);
            }
        }

        // online softmax over the tile, one row at a time
#pragma unroll
        for (int r = 0; r < FA_ROWS; ++r) {
            const int pos = q0 + r0 + r + off;
            bool ok[2];
            float mx = FA_NEG;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kk = kt0 + lane + 32 * j;
                float x = s[r][j] * scale;
                if (softcap > 0.f) x = softcap * tanhf(x / softcap);
                bool keep = kk < Sk;
                if (causal) keep = keep && kk <= pos;
                if (window > 0) keep = keep && (pos - kk) < window;
                ok[j] = keep;
                s[r][j] = keep ? x : FA_NEG;
                mx = fmaxf(mx, s[r][j]);
            }
            const float m_new = fmaxf(m[r], warp_max(mx));
            const float corr = expf(m[r] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float p = ok[j] ? expf(s[r][j] - m_new) : 0.f;
                Ps[(r0 + r) * FA_BK + lane + 32 * j] = p;
                psum += p;
            }
            l[r] = l[r] * corr + warp_sum(psum);
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
        }
        __syncwarp();

        // acc += p . v over the tile's keys, four at a time
        for (int j = 0; j < FA_BK; j += 4) {
            float vv[4][NC];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int c = 0; c < NC; ++c) vv[t][c] = Vs[(j + t) * D + lane + 32 * c];
#pragma unroll
            for (int r = 0; r < FA_ROWS; ++r) {
                const float4 p = *reinterpret_cast<const float4*>(Ps + (r0 + r) * FA_BK + j);
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
                    acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
                    acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
                    acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
        const int row = r0 + r;
        if (row >= q_valid) continue;
        const float lsafe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
        for (int c = 0; c < NC; ++c) og[row * q_stride + lane + 32 * c] = acc[r][c] / lsafe;
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA, wgmma, one producer and two consumer
// warpgroups
// ---------------------------------------------------------------------------
//
// Shared memory holds the q tile (BQ x D) and a ring of STAGES k and v tiles
// (BK x D each), every one stored as D / ROWE column chunks of ROWE
// elements a row, in the swizzled layout the TMA writes and wgmma reads
// (128-byte swizzle for ROWE = 64, 64-byte for D = 32).  Barriers follow the
// tiles: q_full, k_full/v_full (the TMA's bytes landed) and k_empty/v_empty
// (every consumer warp is done with the stage).

template <int D>
struct WgCfg {
    static constexpr int BQ = 128;                     // queries of a block: two warpgroups of 64
    static constexpr int BK = D == 256 ? 80 : 128;     // keys of a tile
    static constexpr int STAGES = 2;                   // k and v tiles in flight
    static constexpr int ROWE = D < 64 ? D : 64;       // elements of a swizzled row (a TMA box's width)
    static constexpr int ROWB = ROWE * 2;              // its bytes: the swizzle span
    static constexpr int NCH = D / ROWE;               // column chunks of a row
    static constexpr int LAYOUT = ROWB == 128 ? 1 : 2;  // wgmma descriptor: 128- or 64-byte swizzle
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;        // one k or one v tile
    static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
    static constexpr int N_BARS = 1 + 4 * STAGES;
    static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * N_BARS;  // 1024: the alignment of the base
    static_assert(SMEM <= 232448, "a block's shared memory is at most 227 KB");
};

struct WgParams {
    __nv_bfloat16* o;
    int Sq, Sk, H, Hkv, n_qt, causal, window;
    float scale, softcap;
    float* lse;  // (B, H, Sq) row statistics for the backward, or null (serving)
};


// The online softmax over one key tile of a consumer thread's two rows, in
// log2 units (exp(x - m) = 2^(x log2 e - m log2 e)).  s[4 i + 2 hh + e] is
// row hh (the thread's rows r and r + 8), key kt0 + cq + 8 i + e: scaled,
// then softcapped (CAP), then masked unless every key of the tile is
// visible (FULL): visible where lo[hh] <= 8 i + e < hi[hh].  Masked p is 0.
// m is the running max, l the thread's share of the running sum, corr the
// factor the accumulator's rows take.  `mul` is scale * log2 e without a
// softcap, else capped_log2's.
template <int NS, bool CAP, bool FULL>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             const int (&lo)[2], const int (&hi)[2], float mul, float cap_l2) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float x = s[4 * i + 2 * hh + e];
                x = CAP ? capped_log2(x, mul, cap_l2) : x * mul;
                if (!FULL) x = 8 * i + e >= lo[hh] && 8 * i + e < hi[hh] ? x : -INFINITY;
                s[4 * i + 2 * hh + e] = x;
                mx = fmaxf(mx, x);
            }
        }
        const float m_new = fmaxf(m[hh], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet: every p is 0
        corr[hh] = fast_exp2(m[hh] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float pv = fast_exp2(s[4 * i + 2 * hh + e] - m_use);
                s[4 * i + 2 * hh + e] = pv;
                psum += pv;
            }
        }
        l[hh] = l[hh] * corr[hh] + psum;
        m[hh] = m_new;
    }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const WgParams p) {
    using C = WgCfg<D>;
    constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, ROWB = C::ROWB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base;
    const uint32_t k_s = base + C::Q_BYTES;                    // stage st at k_s + st * KV_BYTES
    const uint32_t v_s = k_s + ST * C::KV_BYTES;
    const uint32_t bars = base + C::BAR_OFF;                   // q_full, k_full[], v_full[], k_empty[], v_empty[]
    const uint32_t q_full = bars;
    auto k_full = [&](int st) { return bars + 8u * (1 + st); };
    auto v_full = [&](int st) { return bars + 8u * (1 + ST + st); };
    auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * ST + st); };
    auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * ST + st); };

    // longest q tile first within each (b, h), so that the causal tail is
    // short; the tiles of one (b, h) run together and share k and v in L2
    const int hb = blockIdx.x / p.n_qt;
    const int qt = p.n_qt - 1 - (int)(blockIdx.x - hb * p.n_qt);
    const int h = hb % p.H, b = hb / p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = qt * BQ;
    const int q_valid = min(BQ, p.Sq - q0);
    const int off = p.Sk - p.Sq;

    // the key tiles some query of the block may see
    const int first_pos = q0 + off, last_pos = q0 + q_valid - 1 + off;
    const int k_hi = p.causal ? min(p.Sk, last_pos + 1) : p.Sk;
    const int k_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
    const int kt_first = (k_lo / BK) * BK;
    const int n_tiles = k_hi > kt_first ? (k_hi - kt_first + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int st = 0; st < ST; ++st) {
            mbar_init(k_full(st), 1);
            mbar_init(v_full(st), 1);
            mbar_init(k_empty(st), 8);  // one arrival per consumer warp
            mbar_init(v_empty(st), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: one thread keeps the TMA loads in flight ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
        if (threadIdx.x == 0 && n_tiles > 0) {
            mbar_expect_tx(q_full, C::Q_BYTES);
            for (int c = 0; c < C::NCH; ++c) tma_load(q_s + c * BQ * ROWB, &tq, q_full, c * C::ROWE, h, q0, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int st = t % ST;
                const uint32_t ph = (t / ST) & 1;
                const int kt0 = kt_first + t * BK;
                mbar_wait(k_empty(st), ph ^ 1);
                mbar_expect_tx(k_full(st), C::KV_BYTES);
                for (int c = 0; c < C::NCH; ++c)
                    tma_load(k_s + st * C::KV_BYTES + c * BK * ROWB, &tk, k_full(st), c * C::ROWE, hk, kt0, b);
                mbar_wait(v_empty(st), ph ^ 1);
                mbar_expect_tx(v_full(st), C::KV_BYTES);
                for (int c = 0; c < C::NCH; ++c)
                    tma_load(v_s + st * C::KV_BYTES + c * BK * ROWB, &tv, v_full(st), c * C::ROWE, hk, kt0, b);
            }
        }
    } else {
        // ---- consumers: warpgroup w owns query rows 64 w .. 64 w + 63 ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
        const int w = wg - 1;
        const int tw = threadIdx.x - 128 * wg;
        const int warp = tw >> 5, lane = tw & 31;
        const int row0 = 64 * w + 16 * warp + (lane >> 2);  // this thread's rows: row0 and row0 + 8
        const int cq = 2 * (lane & 3);
        const int pos0 = q0 + row0 + off;
        const int mine = 1 + w, other = 2 - w;              // named barriers of the turn-taking

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

        if (n_tiles > 0) {
            // every key of a tile is visible to every row of the warpgroup
            const int w_rows = min(64, q_valid - 64 * w);
            const int w_first = q0 + 64 * w + off, w_last = w_first + w_rows - 1;
            auto is_full = [&](int kt0) {
                return w_rows > 0 && kt0 + BK <= p.Sk && (!p.causal || kt0 + BK - 1 <= w_first) &&
                       (p.window <= 0 || w_last - kt0 < p.window);
            };
            // the keys [lo, hi) each of the thread's rows sees
            int lo_row[2], hi_row[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int pos = pos0 + 8 * hh;
                hi_row[hh] = p.causal ? min(p.Sk, pos + 1) : p.Sk;
                lo_row[hh] = p.window > 0 ? pos - p.window + 1 : 0;
            }
            const float mul = !CAP ? p.scale * LOG2E : p.scale / p.softcap;
            const float cap_l2 = p.softcap * LOG2E;
            // S = q . k^T: A is the warpgroup's 64 q rows, B the k tile, both
            // k-major; a 16-deep step moves 32 bytes along a swizzled row, or
            // to the next column chunk.
            const uint32_t qa = q_s + 64 * w * ROWB;
            auto issue_s = [&](float (&s)[BK / 2], int st) {
                const uint32_t kb = k_s + st * C::KV_BYTES;
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                    const uint64_t da = wg_desc(qa + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT);
                    const uint64_t db = wg_desc(kb + chunk * BK * ROWB + step, 16, 8 * ROWB, C::LAYOUT);
                    wgmma_ss(s, da, db, kk > 0);
                }
            };
            // O += p . v: A is p in registers, B the v tile, MN-major (the
            // leading offset steps over column chunks, the stride offset over
            // 8 keys); a 16-deep step moves 16 key rows.
            uint32_t pa[BK / 16][4];
            auto issue_pv = [&](int st) {
                const uint32_t vb = v_s + st * C::KV_BYTES;
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    wgmma_rs(o, pa[kk], wg_desc(vb + kk * 16 * ROWB, BK * ROWB, 8 * ROWB, C::LAYOUT));
            };
            auto pack_p = [&](float (&s)[BK / 2]) {
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
                    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
                    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
                }
            };
            float s[BK / 2];
            auto softmax = [&](int kt0) {
                if (is_full(kt0)) {
                    softmax_tile<BK / 2, CAP, true>(s, m, l, corr, lo_row, hi_row, mul, cap_l2);
                } else {
                    const int lo[2] = {lo_row[0] - kt0 - cq, lo_row[1] - kt0 - cq};
                    const int hi[2] = {hi_row[0] - kt0 - cq, hi_row[1] - kt0 - cq};
                    softmax_tile<BK / 2, CAP, false>(s, m, l, corr, lo, hi, mul, cap_l2);
                }
            };
            auto release = [&](uint32_t bar) {
                __syncwarp();
                if (lane == 0) mbar_arrive(bar);
            };

            mbar_wait(q_full, 0);
            if (w == 1) named_arrive(1);  // warpgroup 0 takes the first turn

            // tile 0: S only
            mbar_wait(k_full(0), 0);
            named_sync(mine);
            wgmma_fence();
            issue_s(s, 0);
            wgmma_commit();
            named_arrive(other);
            wgmma_wait<0>();
            fence_regs(s);
            release(k_empty(0));
            softmax(kt_first);
            pack_p(s);

            // tiles 1 .. n - 1: S of this tile and p . v of the last in one
            // turn; this tile's softmax runs while p . v runs
            for (int t = 1; t < n_tiles; ++t) {
                const int sk = t % ST, sv = (t - 1) % ST;
                const int kt0 = kt_first + t * BK;
                mbar_wait(k_full(sk), (t / ST) & 1);
                mbar_wait(v_full(sv), ((t - 1) / ST) & 1);
                named_sync(mine);
                wgmma_fence();
                issue_s(s, sk);
                wgmma_commit();
                issue_pv(sv);
                wgmma_commit();
                named_arrive(other);
                wgmma_wait<1>();
                fence_regs(s);
                release(k_empty(sk));
                softmax(kt0);
                wgmma_wait<0>();
                fence_regs(o);
                fence_regs(pa);
                release(v_empty(sv));
                // a row whose max did not move takes corr = 1 exactly: skip the
                // multiplies when no row of the warp moved
                if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f))
#pragma unroll
                for (int i = 0; i < D / 8; ++i) {
                    o[4 * i + 0] *= corr[0];
                    o[4 * i + 1] *= corr[0];
                    o[4 * i + 2] *= corr[1];
                    o[4 * i + 3] *= corr[1];
                }
                pack_p(s);
            }

            // the last p . v
            const int sv = (n_tiles - 1) % ST;
            mbar_wait(v_full(sv), ((n_tiles - 1) / ST) & 1);
            named_sync(mine);
            wgmma_fence();
            issue_pv(sv);
            wgmma_commit();
            if (w == 0) named_arrive(other);  // warpgroup 1's last turn needs no successor
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
        }

        // out = o / l, rounded to bf16 once; rows with no visible key give 0.
        // With p.lse, each row's log-sum-exp of its scaled (and capped)
        // scores in natural-log units, ln 2 * (m + log2 l) from the log2
        // running max m and sum l; +inf for a row with no visible key.
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            const float lsum = quad_sum(l[hh]);
            if (row >= q_valid) continue;
            if (p.lse != nullptr && cq == 0)
                p.lse[((int64_t)b * p.H + h) * p.Sq + q0 + row] = lsum == 0.f ? INFINITY : (m[hh] + log2f(lsum)) * LN2;
            const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
            __nv_bfloat16* out = p.o + (((int64_t)b * p.Sq + q0 + row) * p.H + h) * D + cq;
#pragma unroll
            for (int i = 0; i < D / 8; ++i)
                *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
                    __floats2bfloat162_rn(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
        }
    }
}


template <int D, bool CAP>
static int launch_wgmma_cap(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            const WgParams& p, int grid, cudaStream_t stream) {
    constexpr size_t smem = WgCfg<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wgmma_kernel<D, CAP><<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}

__global__ void fill_inf(float* x, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) x[i] = INFINITY;
}

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
                        int H, int Hkv, int causal, int window, float scale, float softcap, cudaStream_t stream) {
    if (Sk == 0) {  // no row sees a key
        cudaError_t err = cudaMemsetAsync(o, 0, (size_t)B * Sq * H * D * 2, stream);
        if (err != cudaSuccess || lse == nullptr) return (int)err;
        const int64_t n = (int64_t)B * H * Sq;
        fill_inf<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(lse, n);
        return (int)cudaGetLastError();
    }
    CUtensorMap tq, tk, tv;
    using C = WgCfg<D>;
    int rc = make_map(&tq, q, B, Sq, H, D, C::ROWE, C::BQ);
    if (rc == 0) rc = make_map(&tk, k, B, Sk, Hkv, D, C::ROWE, C::BK);
    if (rc == 0) rc = make_map(&tv, v, B, Sk, Hkv, D, C::ROWE, C::BK);
    if (rc != 0) return rc;
    WgParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.Sq = Sq, p.Sk = Sk, p.H = H, p.Hkv = Hkv, p.causal = causal, p.window = window;
    p.n_qt = (Sq + WgCfg<D>::BQ - 1) / WgCfg<D>::BQ;
    p.scale = scale, p.softcap = softcap;
    p.lse = lse;
    const int grid = p.n_qt * H * B;
    return softcap > 0.f ? launch_wgmma_cap<D, true>(tq, tk, tv, p, grid, stream)
                         : launch_wgmma_cap<D, false>(tq, tk, tv, p, grid, stream);
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, int window, float scale, float softcap,
                      cudaStream_t stream) {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
    flash_fwd_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Sq, Sk, H, Hkv, causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

// One launch on `stream` of the device `device` (this library carries its
// own CUDA runtime, so the launch names its device).  D is one of 32, 64,
// 128, 256; dtype is DT_F32 or DT_BF16.  lse, when not null, takes each
// row's log-sum-exp (B, H, Sq) f32 for the backward; only the bf16 kernel
// writes it.  Returns 0 on success, a cudaError_t, or FA_MAP_ERROR + the
// CUresult of a tensor map's encoding.
static int launch_any(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B, int Sq,
                      int Sk, int H, int Hkv, int D, int causal, int window, float scale, float softcap, int device,
                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    if (lse != nullptr && dtype != DT_BF16) return (int)cudaErrorInvalidValue;
    if (B == 0 || Sq == 0 || H == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, softcap, s
    if (dtype == DT_F32) {
        switch (D) {
            case 32: return launch_f32<32>(FA_ARGS);
            case 64: return launch_f32<64>(FA_ARGS);
            case 128: return launch_f32<128>(FA_ARGS);
            case 256: return launch_f32<256>(FA_ARGS);
        }
    }
#undef FA_ARGS
#define FA_ARGS q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, softcap, s
    if (dtype == DT_BF16) {
        switch (D) {
            case 32: return launch_wgmma<32>(FA_ARGS);
            case 64: return launch_wgmma<64>(FA_ARGS);
            case 128: return launch_wgmma<128>(FA_ARGS);
            case 256: return launch_wgmma<256>(FA_ARGS);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}

// The serving path's launch: no row statistics.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                                int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                                int window, float scale, float softcap, int device, void* stream) {
    return launch_any(q, k, v, o, nullptr, dtype, B, Sq, Sk, H, Hkv, D, causal, window, scale, softcap, device,
                      stream);
}

// The training path's launch (bf16 only): the output and each row's
// log-sum-exp, which the backward (flash_bwd.cu) reads.
extern "C" int flash_fwd_lse_launch(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                    int B, int Sq, int Sk, int H, int Hkv, int D, int causal, int window,
                                    float scale, float softcap, int device, void* stream) {
    if (lse == nullptr) return (int)cudaErrorInvalidValue;
    return launch_any(q, k, v, o, static_cast<float*>(lse), dtype, B, Sq, Sk, H, Hkv, D, causal, window, scale,
                      softcap, device, stream);
}

template <int D>
static void config_of(int* out) {
    using C = WgCfg<D>;
    out[0] = C::BQ, out[1] = C::BK, out[2] = C::STAGES, out[3] = (int)C::SMEM;
    out[4] = WG_THREADS, out[5] = WG_PRODUCER_REGS, out[6] = WG_CONSUMER_REGS;
}

// The bf16 kernel's configuration at head dim D, as kernel.py's TILES
// states it: q block, key block, stages, shared-memory bytes, threads,
// producer and consumer registers a thread.  Returns 0, or
// cudaErrorInvalidValue for a head dim the library is not built for.
extern "C" int flash_fwd_config(int D, int* out) {
    switch (D) {
        case 32: config_of<32>(out); return 0;
        case 64: config_of<64>(out); return 0;
        case 128: config_of<128>(out); return 0;
        case 256: config_of<256>(out); return 0;
    }
    return (int)cudaErrorInvalidValue;
}
