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
// forward's output out, its row statistics lse and the output's gradient
// dout (B, S, H, D) bf16:
//   s     = (q . k^T) * scale;  s = c * tanh(s / c) when softcap c > 0
//   mask  = the forward's (causal, and q - k < window when window > 0;
//           queries and keys of one length S)
//   lse   = log(sum over unmasked keys of exp(s)) per (b, h, query), in
//           natural-log units, as flash_fwd_wgmma_kernel writes it
//   p     = exp(s - lse) for unmasked keys, 0 for masked ones
//   delta = rowsum(dout * out);  dp = dout . v^T
//   ds    = p * (dp - delta);  ds *= 1 - (s / c)^2 (softcap)
//   dq    = scale * ds . k;  dk = scale * sum over the G heads of ds^T . q;
//   dv    = sum over the G heads of p^T . dout
// Scores are recomputed exactly as the forward took them: the same wgmma
// products over D in the same order, then in log2 units scale * log2 e * s,
// or under a softcap th = tanh.approx(s * scale / c) and c * log2 e * th
// (capped_log2), so that exp(s - lse) reads the same function the forward
// normalised and the cap's derivative 1 - th^2 the same th; p = 2^(s2 -
// lse * log2 e) by ex2.approx.  p and ds are rounded to bf16 only as
// operands of the products; the outputs are cast to bf16 once, at the end.
//
// Rows whose gradient cancels.  In a trained model's layers the keys of a
// head are close to one vector, so dq = ds . k sums terms that cancel
// while sum over keys of ds is 0; and a row whose output is one key's value
// (query 0 under a causal mask; a saturated softmax) has dp - delta = 0 for
// that key in exact arithmetic.  So delta is taken by the same wgmma as dp
// (m64n64k16, both operands from shared memory, D in the same 16-wide
// steps: dout times out's rows where dp is dout times v's), which makes dp
// - delta exactly 0 there, as in the float64 plain version; and ds enters
// dq's product as two bf16 parts (its rounding and the rounding's residue),
// so its rounding does not swamp what survives the cancellation.  (With ds
// rounded once and delta a separate f32 sum, an earlier form read up to
// 2.2x the per-element limit of ref.BWD_TOL on starcoder2-3b's layers in
// chip_smoke.py's phase 15, and SDPA's backward up to 1.9x on the same
// calls.)  The dq launch takes delta and writes it; the dkv launch reads
// it, and its dp^T = v . dout^T runs the same instruction over the same
// products (each a product of two bf16 values, exact in f32) in the same
// order, so there too dp - delta is 0 where out is one key's value.
//
// Design: two launches of one producer and two consumer warpgroups (as the
// forward: setmaxnreg 24 / 240, tiles brought by TMA through 4-D tensor
// maps into a ring of stages with full and empty mbarriers, the 128-byte
// swizzle, 64-byte at D = 32), and for G > 1 a small third launch; none
// uses atomics, so reruns are bitwise equal.
//   1. flash_bwd_dq_kernel: one block per (b, h, 128 queries), a consumer
//      warpgroup per 64 of them.  It loads the block's q, dout and out
//      tiles once and takes each row's delta (the diagonal of dout . out^T
//      over the warpgroup's rows); then walks 64-key tiles of k and v
//      (3 stages): s = q . k^T and dp = dout . v^T are wgmma with both
//      operands in shared memory, k-major; ds from s, lse and delta; dq +=
//      ds . k is wgmma with ds as the register A operand (its accumulator
//      fragment, rounded, is A's fragment) and k as B, MN-major through the
//      descriptor, issued twice (ds's two bf16 parts).  A tile's s and dp
//      are issued while the previous tile's dq products run.
//   2. flash_bwd_dkv_kernel: one block per (b, query head, 128 keys), a
//      consumer warpgroup per 64 keys, in the transposed form: s^T = k .
//      q^T and dp^T = v . dout^T (shared-memory operands, k-major on both
//      sides), then dv += p^T . dout and dk += ds^T . q with p^T and ds^T
//      from the accumulator as the register A operand and dout and q as B,
//      MN-major (the forward's p . v).  The k and v tiles load once; the
//      query tiles (64 queries of q and dout, 3 stages) and their lse and
//      delta (the producer warp's lanes copy them into the stage) stream
//      through.  With G > 1 each block writes f32 partial dk and dv for
//      its query head (B, S, H, D); with G = 1 it writes bf16 dk and dv.
//   3. flash_bwd_dkv_sum_kernel (G > 1): per kv head, the G partials summed
//      in head order, dk scaled, each cast to bf16 once.
//   At D = 256 (BwCfg::SPLIT) the tiles above do not fit (the dq launch's
//   would take ~393 KB of shared memory, the dkv launch's ~327 KB, and one
//   warpgroup's dk and dv for 64 keys 256 registers a thread), so a block
//   owns 64 rows and its two consumer warpgroups split the work: in the dq
//   launch (64 queries, 2 stages of 64-key tiles: 96 KB + 128 KB) both form
//   the block's s and dp and each accumulates half of dq's columns (64
//   registers); in the dkv launch (64 keys, 2 stages of 64-query tiles) both
//   form s^T, warpgroup 0 accumulates dv (128 registers) and warpgroup 1
//   forms dp^T and accumulates dk.  The products are those of D <= 128 (the
//   same instructions, operands and order), so delta and dp still come
//   from one wgmma and ds still enters dq's product in two bf16 parts; s
//   (twice in each launch) and dp (twice in the dq launch) are issued more
//   than at D <= 128.
//   The grids run longest first: dq's last query tiles (which see the most
//   keys under the causal mask) of every (b, h) first, dkv's first key
//   tiles first.  A warpgroup skips the products of a tile none of its rows
//   sees (it still waits for the tile and releases it); tiles every pair of
//   which is visible skip the mask arithmetic.
//   Splitting dkv by query head (one head a block, rather than the G = 12
//   heads of a kv head a block) makes 768 blocks at starcoder2-3b's
//   training shape rather than 64 (with 128-key blocks), so the causal tail
//   is one short block; its price is the partials, 2 x B S H D x 4 bytes
//   (100 MB a call there) written and read once.  Groups of 2-6 heads a
//   block would cut that traffic by their size, but at 4 or more the
//   longest block (key tile 0's, G / 4 heads x 32 query tiles) outlasts the
//   card's mean share of the work, and 2-3 heads save at most the ~0.03 ms
//   of half the partials' traffic.
//
// Bound.  The gradient is five products of 2 * D FLOPs per unmasked
// query-key pair and head (s, dp, dq, dk, dv: 10 * D * pairs * B * H)
// against 989 TFLOP/s bf16 dense on an H100 SXM; the operations bound it
// (chip_smoke.py's flash_bwd_bound).  The two launches recompute s and dp
// (2 * 2 * D a pair), and dq's product runs twice (ds's two parts): 16 * D
// FLOPs a pair issued, which the bound does not count.
//
// Where the time goes (NVIDIA H100 80GB HBM3, scripts/flash_bwd_shapes.py
// and chip_smoke.py phase 14 at starcoder2-3b's training shape, 2 x 2048,
// 24 heads over 2 kv heads of 128, causal): 0.475 ms against a bound of
// 0.130 ms and SDPA's backward at 0.42 ms: the dq launch 0.220 ms and the
// dkv launch 0.208 ms, each issuing its products at 470-500 TFLOP/s, and
// the sum of the 12 heads' partials 0.041 ms (100 MB read at about 2.5
// TB/s).  The gap to the bound is the work issued beyond it.
// Forms tried: the first kernel (mma.sync m16n8k16 fed by ldmatrix from
// tiles loaded between __syncthreads, its own statistics pass in the dq
// launch, one dkv block of 64 keys walking all 12 query heads of its kv
// head: 128 blocks) took 2.432 ms, and 2.5-5.7 ms in its earlier variants
// (4 warps a dkv block; 32-key blocks).
#include <type_traits>

#include "flash_common.cuh"

typedef __nv_bfloat16 bf16;

template <int D>
struct BwCfg {
    static constexpr int ROWE = D < 64 ? D : 64;        // elements of a swizzled row (a TMA box's width)
    static constexpr int ROWB = ROWE * 2;               // its bytes: the swizzle span
    static constexpr int NCH = D / ROWE;                // column chunks of a row
    static constexpr int LAYOUT = ROWB == 128 ? 1 : 2;  // wgmma descriptor: 128- or 64-byte swizzle
    // D = 256: the two consumer warpgroups of a block share its 64 rows
    // (queries in the dq launch, keys in the dkv launch) and split the work
    // (dq's columns; dv and dk), since one warpgroup's accumulators for 64
    // rows at D = 256 would take 128 registers a thread and both launches'
    // tiles at D <= 128's sizes would pass the 227 KB a block may use
    static constexpr bool SPLIT = D > 128;
    // dq launch: the block's q, dout and out tiles, a ring of k and v tiles
    static constexpr int DQ_Q = SPLIT ? 64 : 128;       // queries of a block: two warpgroups of 64, or one shared
    static constexpr int DQ_K = 64;                     // keys of a tile
    static constexpr int DQ_ST = SPLIT ? 2 : 3;         // k and v tiles in flight
    static constexpr int DQ_N = SPLIT ? D / 2 : D;      // dq's columns a warpgroup accumulates
    static constexpr int DQ_QBYTES = DQ_Q * D * 2;
    static constexpr int DQ_KBYTES = DQ_K * D * 2;
    static constexpr int DQ_BAR = 3 * DQ_QBYTES + 2 * DQ_ST * DQ_KBYTES;
    static constexpr size_t DQ_SMEM = 1024 + DQ_BAR + 8 * (1 + 4 * DQ_ST);
    // dkv launch: the block's k and v tiles, a ring of q and dout tiles with
    // their queries' lse (log2 units) and delta
    static constexpr int KV_K = SPLIT ? 64 : 128;       // keys of a block: two warpgroups of 64, or one shared
    static constexpr int KV_Q = 64;                     // queries of a tile
    static constexpr int KV_ST = SPLIT ? 2 : 3;         // q and dout tiles in flight
    static constexpr int KV_KBYTES = KV_K * D * 2;
    static constexpr int KV_QBYTES = KV_Q * D * 2;
    static constexpr int KV_STAT = 2 * KV_KBYTES + 2 * KV_ST * KV_QBYTES;
    static constexpr int KV_BAR = KV_STAT + KV_ST * 2 * KV_Q * 4;
    static constexpr size_t KV_SMEM = 1024 + KV_BAR + 8 * (1 + 2 * KV_ST);
    static_assert(DQ_SMEM <= 232448 && KV_SMEM <= 232448, "a block's shared memory is at most 227 KB");
    static_assert(KV_K % KV_Q == 0, "a causal dkv block's first query tile starts at its first key");
};

struct BwParams {
    const float* lse;      // (B, H, S), natural log, from the forward
    float* delta;          // (B, H, S): written by the dq launch, read by the dkv launch
    bf16* dq;              // (B, S, H, D)
    bf16* dk;              // (B, S, Hkv, D)
    bf16* dv;
    float* dk_part;        // (B, S, H, D) f32 partials when G > 1, else null
    float* dv_part;
    int B, S, H, Hkv, causal, window;
    int n_t;               // the launch's tiles of S: query tiles (dq) or key tiles (dkv)
    float scale, softcap;
};

__device__ __forceinline__ bool visible(int qi, int kj, const BwParams& p) {
    return qi < p.S && kj < p.S && (!p.causal || kj <= qi) && (p.window <= 0 || qi - kj < p.window);
}

// A score accumulator in the forward's log2 units; *th is tanh.approx of
// the scaled score over the cap (CAP), which the cap's derivative reads.
template <bool CAP>
__device__ __forceinline__ float score_log2(float s, float mul, float cap_l2, float* th) {
    if (CAP) {
        *th = tanh_approx(s * mul);
        return *th * cap_l2;
    }
    return s * mul;
}

__device__ __forceinline__ float bf16_residue(float x) {
    return x - __bfloat162float(__float2bfloat16_rn(x));
}

// An m64n64 accumulator fragment (x[4 i + 2 hh + e]: row r or r + 8,
// column 8 i + 2 (lane % 4) + e) as the A fragments of four 16-deep steps,
// rounded to bf16; RESIDUE: what that rounding left out, rounded.
template <bool RESIDUE>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float lo = x[8 * kk + 2 * j], hi = x[8 * kk + 2 * j + 1];
            a[kk][j] = RESIDUE ? pack_bf16(bf16_residue(lo), bf16_residue(hi)) : pack_bf16(lo, hi);
        }
}

// dq's ds over a 64 x 64 tile, in place of s: rows q_row + 8 hh, keys
// k_col + 8 i + e.  Every pair visible when FULL.
template <bool CAP, bool FULL>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32], const float (&lse2)[2],
                                        const float (&dlt)[2], int q_row, int k_col, const BwParams& p, float mul,
                                        float cap_l2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = 4 * i + 2 * hh + e;
                float th;
                const float x = score_log2<CAP>(s[j], mul, cap_l2, &th);
                float ds = fast_exp2(x - lse2[hh]) * (dp[j] - dlt[hh]);
                if (CAP) ds *= 1.f - th * th;
                if (!FULL && !visible(q_row + 8 * hh, k_col + 8 * i + e, p)) ds = 0.f;
                s[j] = ds;
            }
}

// dkv's p^T (in place of s^T) and, with DS, ds^T (in place of dp^T) over a
// 64 x 64 tile: keys k_row + 8 hh, queries q_col + 8 i + e, whose lse (log2
// units) and delta are lse2[c] and dlt[c] at the tile's column c = q_col -
// q0.
template <bool CAP, bool FULL, bool DS>
__device__ __forceinline__ void p_ds_cols(float (&s)[32], float (&dp)[32], const float* lse2, const float* dlt,
                                          int k_row, int q0, int cq, const BwParams& p, float mul, float cap_l2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * i + cq);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * i + cq);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = 4 * i + 2 * hh + e;
                float th;
                const float x = score_log2<CAP>(s[j], mul, cap_l2, &th);
                float pv = fast_exp2(x - (e ? l2.y : l2.x));
                float ds = DS ? pv * (dp[j] - (e ? dl.y : dl.x)) : 0.f;
                if (CAP) ds *= 1.f - th * th;
                if (!FULL && !visible(q0 + 8 * i + cq + e, k_row + 8 * hh, p)) pv = ds = 0.f;
                s[j] = pv;
                if (DS) dp[j] = ds;
            }
    }
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const BwParams p) {
    using C = BwCfg<D>;
    constexpr int BQ = C::DQ_Q, BK = C::DQ_K, ST = C::DQ_ST, ROWB = C::ROWB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base, do_s = q_s + C::DQ_QBYTES, o_s = do_s + C::DQ_QBYTES;
    const uint32_t k_s = o_s + C::DQ_QBYTES;  // stage st at k_s + st * DQ_KBYTES
    const uint32_t v_s = k_s + ST * C::DQ_KBYTES;
    const uint32_t bars = base + C::DQ_BAR;   // q_full, k_full[], v_full[], k_empty[], v_empty[]
    const uint32_t q_full = bars;
    auto k_full = [&](int st) { return bars + 8u * (1 + st); };
    auto v_full = [&](int st) { return bars + 8u * (1 + ST + st); };
    auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * ST + st); };
    auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * ST + st); };

    // longest first: the last query tile of every (b, h), then the one before
    const int bh = blockIdx.x % (p.B * p.H);
    const int qt = p.n_t - 1 - (int)(blockIdx.x / (p.B * p.H));
    const int h = bh % p.H, b = bh / p.H, hk = h / (p.H / p.Hkv);
    const int q0 = qt * BQ;
    const int q_valid = min(BQ, p.S - q0);
    // the key tiles some query of the block may see
    const int k_hi = p.causal ? min(p.S, q0 + q_valid) : p.S;
    const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
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
            mbar_expect_tx(q_full, 3 * C::DQ_QBYTES);
            for (int c = 0; c < C::NCH; ++c) {
                tma_load(q_s + c * BQ * ROWB, &tq, q_full, c * C::ROWE, h, q0, b);
                tma_load(do_s + c * BQ * ROWB, &tdo, q_full, c * C::ROWE, h, q0, b);
                tma_load(o_s + c * BQ * ROWB, &to, q_full, c * C::ROWE, h, q0, b);
            }
            for (int t = 0; t < n_tiles; ++t) {
                const int st = t % ST;
                const uint32_t ph = (t / ST) & 1;
                const int kt0 = kt_first + t * BK;
                mbar_wait(k_empty(st), ph ^ 1);
                mbar_expect_tx(k_full(st), C::DQ_KBYTES);
                for (int c = 0; c < C::NCH; ++c)
                    tma_load(k_s + st * C::DQ_KBYTES + c * BK * ROWB, &tk, k_full(st), c * C::ROWE, hk, kt0, b);
                mbar_wait(v_empty(st), ph ^ 1);
                mbar_expect_tx(v_full(st), C::DQ_KBYTES);
                for (int c = 0; c < C::NCH; ++c)
                    tma_load(v_s + st * C::DQ_KBYTES + c * BK * ROWB, &tv, v_full(st), c * C::ROWE, hk, kt0, b);
            }
        }
        return;
    }
    // ---- consumers: warpgroup w owns query rows 64 w .. 64 w + 63, or
    // (SPLIT) both own the block's 64 rows and w dq's columns DQ_N w ..
    // DQ_N w + DQ_N - 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int w = wg - 1;
    const int tw = threadIdx.x - 128 * wg;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2;
    const int cq = 2 * (lane & 3);
    const int rw = C::SPLIT ? 0 : 64 * w;     // the warpgroup's first row in the block
    const int row0 = rw + 16 * warp + g;      // this thread's rows: row0 and row0 + 8
    const int qrow = q0 + row0;
    constexpr int DN = C::DQ_N;

    float dq[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
    if (n_tiles > 0) {
        const uint32_t qa = q_s + rw * ROWB, da = do_s + rw * ROWB;
        mbar_wait(q_full, 0);

        // delta: the diagonal of dout . out^T over the warpgroup's rows, by
        // the instruction (and the steps over D) that gives dp below.  Row
        // r's entry sits with lane 4 (r % 8) + (r % 8) / 2 of warp r / 16.
        float dlt[2], lse2[2];
        {
            float dd[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                wgmma_ss(dd, wg_desc(da + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT),
                         wg_desc(o_s + chunk * BQ * ROWB + rw * ROWB + step, 16, 8 * ROWB, C::LAYOUT), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dd);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float x = 0.f;
#pragma unroll
                for (int wv = 0; wv < 4; ++wv)
                    if (warp == wv) x = (g & 1) ? dd[4 * (2 * wv + hh) + 2 * hh + 1] : dd[4 * (2 * wv + hh) + 2 * hh];
                dlt[hh] = __shfl_sync(0xffffffffu, x, 4 * g + (g >> 1));
            }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int qi = qrow + 8 * hh;
            const int64_t at = ((int64_t)b * p.H + h) * p.S + qi;
            lse2[hh] = qi < p.S ? p.lse[at] * LOG2E : 0.f;
            if (qi < p.S && cq == 0 && (!C::SPLIT || w == 0)) p.delta[at] = dlt[hh];
        }

        const float mul = CAP ? p.scale / p.softcap : p.scale * LOG2E;
        const float cap_l2 = p.softcap * LOG2E;
        const int w_first = q0 + rw, w_last = min(q0 + rw + 63, p.S - 1);
        // the k tile's columns this warpgroup's dq reads (SPLIT: its half)
        const uint32_t kcol = C::SPLIT ? w * (DN / C::ROWE) * BK * ROWB : 0;
        float s[32], dp[32];
        uint32_t hi[4][4], lo[4][4];
        int pend = -1;  // the stage whose k tile the last dq products read
        for (int t = 0; t < n_tiles; ++t) {
            const int st = t % ST;
            const uint32_t ph = (t / ST) & 1;
            const int kt0 = kt_first + t * BK;
            mbar_wait(k_full(st), ph);
            mbar_wait(v_full(st), ph);
            if (w_first > w_last || (p.causal && kt0 > w_last) ||
                (p.window > 0 && w_first - (kt0 + BK - 1) >= p.window)) {  // no row of the warpgroup sees a key
                if (pend >= 0) {
                    wgmma_wait<0>();
                    fence_regs(dq);
                    fence_regs(hi);
                    fence_regs(lo);
                    release(k_empty(pend), lane);
                    pend = -1;
                }
                release(v_empty(st), lane);
                release(k_empty(st), lane);
                continue;
            }
            // s = q . k^T and dp = dout . v^T, both operands k-major; a
            // 16-deep step moves 32 bytes along a swizzled row, or to the
            // next column chunk
            const uint32_t kb = k_s + st * C::DQ_KBYTES, vb = v_s + st * C::DQ_KBYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                wgmma_ss(s, wg_desc(qa + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT),
                         wg_desc(kb + chunk * BK * ROWB + step, 16, 8 * ROWB, C::LAYOUT), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                wgmma_ss(dp, wg_desc(da + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT),
                         wg_desc(vb + chunk * BK * ROWB + step, 16, 8 * ROWB, C::LAYOUT), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();  // also the last tile's dq products
            fence_regs(s);
            fence_regs(dp);
            fence_regs(dq);
            fence_regs(hi);
            fence_regs(lo);
            release(v_empty(st), lane);
            if (pend >= 0) release(k_empty(pend), lane);
            const bool full = kt0 + BK <= p.S && w_last - w_first == 63 && (!p.causal || kt0 + BK - 1 <= w_first) &&
                              (p.window <= 0 || w_last - kt0 < p.window);
            if (full)
                ds_rows<CAP, true>(s, dp, lse2, dlt, qrow, kt0 + cq, p, mul, cap_l2);
            else
                ds_rows<CAP, false>(s, dp, lse2, dlt, qrow, kt0 + cq, p, mul, cap_l2);
            pack_a<false>(hi, s);
            pack_a<true>(lo, s);
            // dq += ds . k: A is ds in registers (two bf16 parts), B the k
            // tile's DN columns, MN-major (the leading offset steps over
            // column chunks, the stride offset over 8 keys); a 16-deep step
            // moves 16 keys
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t db = wg_desc(kb + kcol + kk * 16 * ROWB, BK * ROWB, 8 * ROWB, C::LAYOUT);
                wgmma_rs(dq, hi[kk], db);
                wgmma_rs(dq, lo[kk], db);
            }
            wgmma_commit();
            pend = st;
        }
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(hi);
        fence_regs(lo);
    }
    // dq = scale * (ds . k), rounded to bf16 once
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int qi = qrow + 8 * hh;
        if (qi >= p.S) continue;
        bf16* dst = p.dq + (((int64_t)b * p.S + qi) * p.H + h) * D + (C::SPLIT ? w * DN : 0) + cq;
#pragma unroll
        for (int i = 0; i < DN / 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
                __floats2bfloat162_rn(dq[4 * i + 2 * hh] * p.scale, dq[4 * i + 2 * hh + 1] * p.scale);
    }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const BwParams p) {
    using C = BwCfg<D>;
    constexpr int BK = C::KV_K, BQ = C::KV_Q, ST = C::KV_ST, ROWB = C::ROWB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t k_s = base, v_s = k_s + C::KV_KBYTES;
    const uint32_t q_s = v_s + C::KV_KBYTES;  // stage st at q_s + st * KV_QBYTES
    const uint32_t do_s = q_s + ST * C::KV_QBYTES;
    // stage st's lse (log2 units) at stats + 2 st BQ, its delta BQ floats on
    float* stats = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + C::KV_STAT);
    const uint32_t bars = base + C::KV_BAR;   // kv_full, full[], empty[]
    const uint32_t kv_full = bars;
    auto full = [&](int st) { return bars + 8u * (1 + st); };
    auto empty = [&](int st) { return bars + 8u * (1 + ST + st); };

    // longest first: the first key tile of every (b, h), then the next
    const int bh = blockIdx.x % (p.B * p.H);
    const int kt = blockIdx.x / (p.B * p.H);
    const int h = bh % p.H, b = bh / p.H, hk = h / (p.H / p.Hkv);
    const int k0 = kt * BK;
    // the query tiles that may see a key of the block
    const int q_lo = p.causal ? k0 : 0;
    const int q_hi = p.window > 0 ? min(p.S, k0 + BK - 1 + p.window) : p.S;
    const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int st = 0; st < ST; ++st) {
            mbar_init(full(st), 32);  // the producer warp's lanes, one with the TMA's bytes
            mbar_init(empty(st), 8);  // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: warp 0 copies each query tile's lse and delta, its
        // lane 0 keeps the TMA loads in flight ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
        if (threadIdx.x < 32 && n_tiles > 0) {
            const int lane = threadIdx.x;
            if (lane == 0) {
                mbar_expect_tx(kv_full, 2 * C::KV_KBYTES);
                for (int c = 0; c < C::NCH; ++c) {
                    tma_load(k_s + c * BK * ROWB, &tk, kv_full, c * C::ROWE, hk, k0, b);
                    tma_load(v_s + c * BK * ROWB, &tv, kv_full, c * C::ROWE, hk, k0, b);
                }
            }
            const int64_t row = ((int64_t)b * p.H + h) * p.S;
            for (int t = 0; t < n_tiles; ++t) {
                const int st = t % ST;
                const uint32_t ph = (t / ST) & 1;
                const int q0 = q_lo + t * BQ;
                mbar_wait(empty(st), ph ^ 1);
                float* l2 = stats + 2 * st * BQ;
                for (int i = lane; i < BQ; i += 32) {
                    const int qi = q0 + i;
                    l2[i] = qi < p.S ? p.lse[row + qi] * LOG2E : 0.f;
                    l2[BQ + i] = qi < p.S ? p.delta[row + qi] : 0.f;
                }
                if (lane == 0) {
                    mbar_expect_tx(full(st), 2 * C::KV_QBYTES);
                    for (int c = 0; c < C::NCH; ++c) {
                        tma_load(q_s + st * C::KV_QBYTES + c * BQ * ROWB, &tq, full(st), c * C::ROWE, h, q0, b);
                        tma_load(do_s + st * C::KV_QBYTES + c * BQ * ROWB, &tdo, full(st), c * C::ROWE, h, q0, b);
                    }
                } else {
                    mbar_arrive(full(st));
                }
            }
        }
        return;
    }
    // ---- consumers: warpgroup w owns keys 64 w .. 64 w + 63 and both dk
    // and dv, or (SPLIT) both own the block's 64 keys, warpgroup 0 dv and
    // warpgroup 1 dk ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int w = wg - 1;
    const int tw = threadIdx.x - 128 * wg;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2;
    const int cq = 2 * (lane & 3);
    const int rw = C::SPLIT ? 0 : 64 * w;      // the warpgroup's first key in the block
    const int krow = k0 + rw + 16 * warp + g;  // this thread's keys: krow and krow + 8

    // the loop over query tiles and the epilogue, for the gradients a
    // warpgroup owns (dk_tag, dv_tag: std::integral_constant<bool, ...>)
    auto consume = [&](auto dk_tag, auto dv_tag) {
        constexpr bool DK = decltype(dk_tag)::value, DV = decltype(dv_tag)::value;
        float dk[DK ? D / 2 : 1], dv[DV ? D / 2 : 1];
#pragma unroll
        for (int i = 0; i < (DK ? D / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
        for (int i = 0; i < (DV ? D / 2 : 1); ++i) dv[i] = 0.f;
        if (n_tiles > 0) {
            const float mul = CAP ? p.scale / p.softcap : p.scale * LOG2E;
            const float cap_l2 = p.softcap * LOG2E;
            const int w_first = k0 + rw, w_last = min(k0 + rw + 63, p.S - 1);
            const uint32_t ka = k_s + rw * ROWB, va = v_s + rw * ROWB;
            mbar_wait(kv_full, 0);
            float s[32], dp[32];
            uint32_t pa[4][4], dsa[4][4];
            for (int t = 0; t < n_tiles; ++t) {
                const int st = t % ST;
                const uint32_t ph = (t / ST) & 1;
                const int q0 = q_lo + t * BQ;
                const int q_last = min(q0 + BQ - 1, p.S - 1);
                mbar_wait(full(st), ph);
                if (w_first > w_last || (p.causal && q_last < w_first) ||
                    (p.window > 0 && q0 - w_last >= p.window)) {  // no key of the warpgroup is seen
                    release(empty(st), lane);
                    continue;
                }
                // s^T = k . q^T and (for ds) dp^T = v . dout^T, both operands k-major
                const uint32_t qb = q_s + st * C::KV_QBYTES, dob = do_s + st * C::KV_QBYTES;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                    wgmma_ss(s, wg_desc(ka + chunk * BK * ROWB + step, 16, 8 * ROWB, C::LAYOUT),
                             wg_desc(qb + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT), kk > 0);
                }
                if constexpr (DK) {
#pragma unroll
                    for (int kk = 0; kk < D / 16; ++kk) {
                        const uint32_t chunk = kk / (C::ROWE / 16), step = (kk % (C::ROWE / 16)) * 32;
                        wgmma_ss(dp, wg_desc(va + chunk * BK * ROWB + step, 16, 8 * ROWB, C::LAYOUT),
                                 wg_desc(dob + chunk * BQ * ROWB + step, 16, 8 * ROWB, C::LAYOUT), kk > 0);
                    }
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(s);
                if constexpr (DK) fence_regs(dp);
                fence_regs(dk);
                fence_regs(dv);
                const float* l2 = stats + 2 * st * BQ;
                const bool all = w_last - w_first == 63 && q_last - q0 == BQ - 1 && (!p.causal || q0 >= w_last) &&
                                 (p.window <= 0 || q_last - w_first < p.window);
                if (all)
                    p_ds_cols<CAP, true, DK>(s, dp, l2, l2 + BQ, krow, q0, cq, p, mul, cap_l2);
                else
                    p_ds_cols<CAP, false, DK>(s, dp, l2, l2 + BQ, krow, q0, cq, p, mul, cap_l2);
                if constexpr (DV) pack_a<false>(pa, s);
                if constexpr (DK) pack_a<false>(dsa, dp);
                // dv += p^T . dout and dk += ds^T . q: A in registers, B the
                // query tile, MN-major; a 16-deep step moves 16 queries
                wgmma_fence();
                if constexpr (DV) {
#pragma unroll
                    for (int kk = 0; kk < BQ / 16; ++kk)
                        wgmma_rs(dv, pa[kk], wg_desc(dob + kk * 16 * ROWB, BQ * ROWB, 8 * ROWB, C::LAYOUT));
                }
                if constexpr (DK) {
#pragma unroll
                    for (int kk = 0; kk < BQ / 16; ++kk)
                        wgmma_rs(dk, dsa[kk], wg_desc(qb + kk * 16 * ROWB, BQ * ROWB, 8 * ROWB, C::LAYOUT));
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dk);
                fence_regs(dv);
                if constexpr (DV) fence_regs(pa);
                if constexpr (DK) fence_regs(dsa);
                release(empty(st), lane);
            }
        }
        // G = 1: dk = scale * (ds^T . q) and dv in bf16; else this head's
        // f32 partials, which flash_bwd_dkv_sum_kernel adds
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int kj = krow + 8 * hh;
            if (kj >= p.S) continue;
            if (p.dk_part == nullptr) {
                const int64_t at = (((int64_t)b * p.S + kj) * p.Hkv + hk) * D + cq;
#pragma unroll
                for (int i = 0; i < D / 8; ++i) {
                    if constexpr (DK)
                        *reinterpret_cast<__nv_bfloat162*>(p.dk + at + 8 * i) =
                            __floats2bfloat162_rn(dk[4 * i + 2 * hh] * p.scale, dk[4 * i + 2 * hh + 1] * p.scale);
                    if constexpr (DV)
                        *reinterpret_cast<__nv_bfloat162*>(p.dv + at + 8 * i) =
                            __floats2bfloat162_rn(dv[4 * i + 2 * hh], dv[4 * i + 2 * hh + 1]);
                }
            } else {
                const int64_t at = (((int64_t)b * p.S + kj) * p.H + h) * D + cq;
#pragma unroll
                for (int i = 0; i < D / 8; ++i) {
                    if constexpr (DK)
                        *reinterpret_cast<float2*>(p.dk_part + at + 8 * i) =
                            make_float2(dk[4 * i + 2 * hh], dk[4 * i + 2 * hh + 1]);
                    if constexpr (DV)
                        *reinterpret_cast<float2*>(p.dv_part + at + 8 * i) =
                            make_float2(dv[4 * i + 2 * hh], dv[4 * i + 2 * hh + 1]);
                }
            }
        }
    };
    using yes = std::integral_constant<bool, true>;
    using no = std::integral_constant<bool, false>;
    if constexpr (!C::SPLIT)
        consume(yes{}, yes{});
    else if (w == 0)
        consume(no{}, yes{});
    else
        consume(yes{}, no{});
}

// dk and dv of each (b, key, kv head): the partials of its G query heads
// summed in head order, dk scaled, each cast to bf16 once; four features a
// thread.
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                                         bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t n4, int G, int D,
                                         float scale) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n4) return;
    const int64_t row = i * 4 / D;  // (b S + key) Hkv + kv head
    const int d = (int)(i * 4 - row * D);
    const int64_t src = row * G * D + d;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int j = 0; j < G; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(dk_part + src + (int64_t)j * D);
        const float4 c = *reinterpret_cast<const float4*>(dv_part + src + (int64_t)j * D);
        sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
        sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
    }
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i * 4);
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i * 4);
    k2[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    k2[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
    v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// floats of the work buffer before the partials: delta, rounded up to 16 bytes
static int64_t delta_floats(int B, int S, int H) { return ((int64_t)B * H * S + 3) / 4 * 4; }

template <int D, bool CAP>
static int launch_cap(const CUtensorMap (&m)[9], BwParams p, int n_qt, int n_kt, cudaStream_t stream) {
    using C = BwCfg<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::KV_SMEM);
    if (err != cudaSuccess) return (int)err;
    p.n_t = n_qt;
    flash_bwd_dq_kernel<D, CAP><<<n_qt * p.B * p.H, WG_THREADS, C::DQ_SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    p.n_t = n_kt;
    flash_bwd_dkv_kernel<D, CAP><<<n_kt * p.B * p.H, WG_THREADS, C::KV_SMEM, stream>>>(m[5], m[6], m[7], m[8], p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.dk_part == nullptr) return (int)err;
    const int64_t n4 = (int64_t)p.B * p.S * p.Hkv * D / 4;
    flash_bwd_dkv_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        p.dk_part, p.dv_part, p.dk, p.dv, n4, p.H / p.Hkv, D, p.scale);
    return (int)cudaGetLastError();
}

template <int D>
static int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout, float* work,
                      const float* lse, void* dq, void* dk, void* dv, int B, int S, int H, int Hkv, int causal,
                      int window, float scale, float softcap, cudaStream_t stream) {
    using C = BwCfg<D>;
    // dq launch: q, dout, out (128-query boxes), k, v (64-key boxes); dkv
    // launch: k, v (128-key boxes), q, dout (64-query boxes)
    CUtensorMap m[9];
    int rc = make_map(&m[0], q, B, S, H, D, C::ROWE, C::DQ_Q);
    if (rc == 0) rc = make_map(&m[1], dout, B, S, H, D, C::ROWE, C::DQ_Q);
    if (rc == 0) rc = make_map(&m[2], out, B, S, H, D, C::ROWE, C::DQ_Q);
    if (rc == 0) rc = make_map(&m[3], k, B, S, Hkv, D, C::ROWE, C::DQ_K);
    if (rc == 0) rc = make_map(&m[4], v, B, S, Hkv, D, C::ROWE, C::DQ_K);
    if (rc == 0) rc = make_map(&m[5], k, B, S, Hkv, D, C::ROWE, C::KV_K);
    if (rc == 0) rc = make_map(&m[6], v, B, S, Hkv, D, C::ROWE, C::KV_K);
    if (rc == 0) rc = make_map(&m[7], q, B, S, H, D, C::ROWE, C::KV_Q);
    if (rc == 0) rc = make_map(&m[8], dout, B, S, H, D, C::ROWE, C::KV_Q);
    if (rc != 0) return rc;
    BwParams p;
    p.lse = lse;
    p.delta = work;
    p.dq = static_cast<bf16*>(dq), p.dk = static_cast<bf16*>(dk), p.dv = static_cast<bf16*>(dv);
    const int64_t part = (int64_t)B * S * H * D;
    p.dk_part = H == Hkv ? nullptr : work + delta_floats(B, S, H);
    p.dv_part = H == Hkv ? nullptr : p.dk_part + part;
    p.B = B, p.S = S, p.H = H, p.Hkv = Hkv, p.causal = causal, p.window = window;
    p.scale = scale, p.softcap = softcap;
    const int n_qt = (S + C::DQ_Q - 1) / C::DQ_Q, n_kt = (S + C::KV_K - 1) / C::KV_K;
    return softcap > 0.f ? launch_cap<D, true>(m, p, n_qt, n_kt, stream)
                         : launch_cap<D, false>(m, p, n_qt, n_kt, stream);
}

// dq, dk, dv from q, k, v, out, dout and the forward's lse (B, H, S f32,
// natural log: flash_fwd_lse_launch's) as the header states.  `work` is f32
// scratch: delta (B * H * S floats, rounded up to a multiple of 4), then,
// when H > Hkv, the partial dk and dv (B * S * H * D floats each).  D is
// 32, 64, 128 or 256 (the wrapper pads 16 to 32, and 80 and 112 to 128).  Returns 0, a cudaError_t,
// FA_MAP_ERROR + the CUresult of a tensor map's encoding, or
// cudaErrorInvalidValue for a head dim the library is not built for.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                                const void* dout, void* work, void* lse, void* dq, void* dk, void* dv, int B,
                                int S, int H, int Hkv, int D, int causal, int window, float scale,
                                float softcap, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0 || H == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BW_ARGS q, k, v, out, dout, static_cast<float*>(work), static_cast<const float*>(lse), dq, dk, dv, B, S, H, \
                Hkv, causal, window, scale, softcap, s
    switch (D) {
        case 32: return launch_bwd<32>(BW_ARGS);
        case 64: return launch_bwd<64>(BW_ARGS);
        case 128: return launch_bwd<128>(BW_ARGS);
        case 256: return launch_bwd<256>(BW_ARGS);
    }
#undef BW_ARGS
    return (int)cudaErrorInvalidValue;
}
