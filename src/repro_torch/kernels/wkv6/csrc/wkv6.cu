// WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper (sm_90a), as the
// chunked recurrence with its state products on the tensor cores.
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
// Outputs: y (B, S, H, K) f32 and the final S (B, H, K, K) f32.
//
// The chunked form (the Pallas kernel's algebra, and ref.wkv6_plain's).  Per
// chunk of L = 16 tokens, with cum the inclusive running sum of log_w inside
// the chunk, cumq the exclusive one and tot its last value:
//   A[i][j] = sum_k r_i[k] k_j[k] e^{cumq_i[k] - cum_j[k]}   (j < i)
//   A[i][i] = sum_k r_i[k] u[k] k_i[k]                        (the bonus)
//   y       = A v + (r . e^{cumq}) S
//   S      <- e^{tot} . S + (k . e^{tot - cum})^T v
// Every exponent is <= 0, so a strong decay underflows to an exact 0 and
// nothing overflows: no factor e^{-cum} is ever formed.  Exponents are taken
// in log2 units (log_w * log2(e), summed), by ex2.approx.
//
// Bound.  The function needs, per token and head, two K x V products (the
// state's contribution to y and the state's update: 4 K V FLOPs), which run
// on the tensor cores in split TF32 (three products each, at 495 / 3
// TFLOP/s), and the within-chunk weights on the CUDA cores (about L K / 2
// exps and a few f32 operations each).  The bytes: r, k, v, log_w and y
// each moved once, S0 and S_out, over 3.35 TB/s.  At rwkv6-3b's shapes
// (K = 64, r/k/v in bf16) the bytes bound it: 0.175 ms at 8 x 2048 x 40
// heads against about 0.1 ms of operations (chip_smoke.wkv6_bound).  The
// per-token scan this kernel replaced was bound by its 5 K V f32 operations
// a token on the CUDA cores (0.200 ms) and took 1.25-1.29 ms.
//
// Measured on an H100 (scripts/wkv6_splits.py, in turns with the per-token
// scan; PERF.md §6): 0.42 ms at 8 x 2048 x 40 heads against the scan's
// 1.27, 0.54 ms at 1 x 16384 (27 segments) against 1.02.  What decided the
// design, one step at a time at 8 x 2048: split TF32 held the tolerance
// (worst/limit 0.027 where the scan read 0.026); L = 32 lost to L = 16
// (1.65 against 1.03 ms, then 1.13 against 0.69); masking the split where
// cvt.rna stood took 0.65 to 0.53 ms; wgmma in place of mma.sync cut the
// products' cycles a chunk from 2,620 to 1,620 once the registers were cut
// back to three blocks an SM; factoring A's off-diagonal block took 0.54
// to 0.44 ms; the backwards states pass took 0.196 to 0.116 ms at 1 x
// 16384.
//
// Design, and what it does about that bound.
//   * One block of four warps (one warpgroup) walks the chunks of one
//     (b, h), or of one segment of it, in order.  What the block issues a
//     chunk is what bounds it: at 8 x 2048 three blocks share an SM and its
//     issue slots are nearly full, so the design counts instructions.
//   * Split TF32.  A TF32 product keeps 11 significant bits, which fails the
//     kernel's tolerance; x = hi + lo with hi = x's top 19 bits (what the
//     tensor cores read of x) and lo = x - hi (exact; the MMA reads its top
//     19 bits), and a b ~ hi hi + hi lo + lo hi, each an MMA with f32
//     accumulation, comes within about 2^-20 of a b (ref.
//     wkv6_chunked_split_plain is this arithmetic on the CPU).  Masking
//     takes two instructions where cvt.rna.tf32.f32 took several.  bf16 r,
//     k and v are exact in TF32, so a product with v as a factor takes two
//     MMAs.
//   * The products are wgmma m64nNk8 .tf32 on the warpgroup, all of a chunk
//     in flight at once: y^T = S^T (r . 2^{cumq})^T + v^T A^T and the
//     chunk's state product from zero, E^T = v^T (k . 2^{tot - cum}).  The
//     state is held in registers as its two TF32 parts, which are the A
//     operands as they stand: an accumulator fragment of S^T holds keys 2q
//     and 2q + 1 of its 8-wide tile where the A operand wants columns q and
//     q + 4, and summing over the keys in another order is the same sum, so
//     the B operand (r . 2^{cumq}) is laid out in that order.  The decayed
//     state is added on the CUDA cores, S = 2^{tot} S + E, so the tensor
//     cores never round the carried state.  (mma.sync m16n8k8 took 88
//     instructions a warp a chunk, with every B fragment loaded and split
//     by every warp.)
//   * The within-chunk weights: the two diagonal 8 x 8 blocks of A
//     directly (28 pairs of K exps each), the rows of each pair of a block
//     (p, 7 - p) in one thread so that all do the same work, the slices'
//     partials meeting in a reduce-scatter of shuffles; the block below them
//     factored at its corner m = 7, 2^{cumq_i - cum_j} = 2^{cumq_i - cum_m}
//     2^{cum_m - cum_j} with both exponents <= 0 (a term lost to underflow is
//     below 2^-126), as a small product on the CUDA cores.  That halves the
//     per-element work the direct form took.
//   * Inputs come through a two-stage ring in shared memory filled by
//     cp.async (16-byte pieces, zero-filled past the segment's end, which
//     leaves the state as it is: k = v = 0, log_w = 0), one chunk ahead of
//     the chunk being computed; nothing is prefetched into registers.
//   * Every phase issues its shared-memory loads before its stores: a load
//     after a store to shared memory waits for it (the compiler cannot tell
//     the arrays apart), and chains of such pairs are what the first version
//     of this kernel spent most of its time on.
//   * One long prompt (B * H too small to fill the card) is cut into
//     segments: wkv6_states gives each segment's state from zero, E = sum_j
//     (k_j . 2^{tot - cum_j}) v_j^T with cum running over the segment, and
//     its decay, walking the segment backwards so that the decay of a chunk
//     is the sum of the chunks after it, with E accumulated by the tensor
//     cores over the whole segment (no state to carry, so only the next
//     chunk's stores wait on the products); wkv6_carry chains them; and
//     wkv6_chunks runs each segment from its start.
#include "wkv6_common.cuh"

#define WKV_CARRY_STEP 8

// The layout of the scan's block: a two-stage ring of raw inputs (r, k, v
// of type T and log_w, L rows of K each), then the chunk's operands.  The
// three that wgmma reads as B are split into TF32 parts (hi, lo) and laid
// out as its core matrices (8 rows of 16 bytes, K-major, no swizzle):
//   q~ = r . 2^{cumq}: rows the chunk's tokens, K the keys, each 8 keys in
//        the order 0 2 4 6 1 3 5 7 (the order in which the state's
//        accumulators hold them, so that they are its A operand as they
//        stand);
//   k~ = k . 2^{tot - cum}: rows the keys, K the tokens;
//   A: rows i, K the j (zero above the diagonal);
// core matrices Q_LBO / K_LBO / A_LBO bytes apart along K and Q_SBO /
// K_SBO / A_SBO along the rows, spaced so that the threads' stores fall
// on different banks.  Then v (hi; lo for f32 inputs) in [token][key] rows
// K + 8 floats apart, which each warp reads as its A operand, cum for A,
// the factors of A's off-diagonal block (R~, K~; see wkv6_chunks), and
// 2^{tot}.
template <typename T, int K, int L>
struct Wkv {
    static constexpr int PAD = K + 8;
    static constexpr int HALF = L / 2;                     // A's diagonal blocks
    static constexpr int NSL = WKV_THREADS / HALF;         // key slices of a row pair of a diagonal block
    static constexpr int CW = K / NSL;                     // keys of a slice
    static constexpr int CWO = K / 8;                      // keys of a slice of the off-diagonal block
    static constexpr int MW = K / 16;                      // warps that hold state columns
    static constexpr int NK = K / 8;                       // 8-wide tiles of the key index
    static constexpr int NL = L / 8;                       // 8-wide tiles of the chunk's tokens
    static constexpr bool EXACT_V = sizeof(T) == 2;        // bf16 is exact in TF32
    static constexpr int STAGE = 3 * L * K * (int)sizeof(T) + L * K * 4;
    static constexpr int Q_LBO = 144, Q_SBO = (K / 4) * Q_LBO, Q_BYTES = (L / 8) * Q_SBO;
    static constexpr int K_LBO = 128, K_SBO = (L / 4) * K_LBO + 16, K_BYTES = (K / 8) * K_SBO;
    static constexpr int A_LBO = 128, A_SBO = (L / 4) * A_LBO, A_BYTES = (L / 8) * A_SBO;
    static constexpr int ROWS = L * PAD * 4;               // bytes of v's [token][key] array
    static constexpr int OFF_QH = WKV_STAGES * STAGE;
    static constexpr int OFF_QL = OFF_QH + Q_BYTES;
    static constexpr int OFF_KH = OFF_QL + Q_BYTES;
    static constexpr int OFF_KL = OFF_KH + K_BYTES;
    static constexpr int OFF_AH = OFF_KL + K_BYTES;
    static constexpr int OFF_AL = OFF_AH + A_BYTES;
    static constexpr int OFF_VH = OFF_AL + A_BYTES;
    static constexpr int OFF_VL = OFF_VH + ROWS;
    static constexpr int OFF_CUM = OFF_VL + (EXACT_V ? 0 : ROWS);
    static constexpr int OFF_X = OFF_CUM + L * K * 4;      // R~, then K~: HALF rows of K each
    static constexpr int OFF_E = OFF_X + 2 * HALF * K * 4;
    static constexpr int SMEM = OFF_E + K * 4;
    static_assert(L == 16 && K % 16 == 0 && K <= 64, "chunks of 16 tokens, tiles of 16 state columns");
    static_assert(NSL == 16 && CW * NSL == K && CWO * 8 == K, "the weights' threads tile the keys");
    static_assert(2 * K <= WKV_THREADS, "the operand pass takes two threads a key");
    static_assert(STAGE % 16 == 0 && ROWS % 16 == 0 && Q_BYTES % 16 == 0 && K_BYTES % 16 == 0, "16-byte aligned");

    // byte offsets of one element in the wgmma operands
    __device__ static int q_at(int t, int key) {  // key 8 b + e sits at position e / 2 of quad 2 b + (e & 1)
        return (t / 8) * Q_SBO + (2 * (key / 8) + (key & 1)) * Q_LBO + (t % 8) * 16 + ((key % 8) / 2) * 4;
    }
    __device__ static int k_at(int key, int t) { return (key / 8) * K_SBO + (t / 4) * K_LBO + (key % 8) * 16 + (t % 4) * 4; }
    __device__ static int a_at(int i, int j) { return (i / 8) * A_SBO + (j / 4) * A_LBO + (i % 8) * 16 + (j % 4) * 4; }
};

// The states pass's block: a two-stage ring of k, v and log_w, then k~
// (as the scan's) and v.
template <typename T, int K, int L>
struct WkvStates {
    using W = Wkv<T, K, L>;
    static constexpr int STAGE = 2 * L * K * (int)sizeof(T) + L * K * 4;
    static constexpr int OFF_KH = WKV_STAGES * STAGE;
    static constexpr int OFF_KL = OFF_KH + W::K_BYTES;
    static constexpr int OFF_VH = OFF_KL + W::K_BYTES;
    static constexpr int OFF_VL = OFF_VH + W::ROWS;
    static constexpr int SMEM = OFF_VL + (W::EXACT_V ? 0 : W::ROWS);
};

// Issue the cp.async copies of the chunk whose first token is at element
// offset row0 (tokens stride_t apart) into one ring stage: r (when WITH_R),
// k, v, log_w, L rows each.  Rows past the n_in tokens of the chunk inside
// its segment are zero-filled (their source address is the chunk's first
// row, which is never read for them).
template <typename T, int K, int L, bool WITH_R>
__device__ __forceinline__ void stage_chunk(char* stage, const T* r, const T* k, const T* v, const float* lw,
                                            int64_t row0, int64_t stride_t, int n_in) {
    constexpr int TP = K * (int)sizeof(T) / 16;   // 16-byte pieces of a row of T
    constexpr int WP = K / 4;                     // of a row of log_w
    constexpr int TE = 16 / (int)sizeof(T);       // elements of T in a piece
    T* sr = reinterpret_cast<T*>(stage);
    T* sk = sr + (WITH_R ? L * K : 0);
    T* sv = sk + L * K;
    float* sw = reinterpret_cast<float*>(sv + L * K);
#pragma unroll
    for (int m = 0; m < (L * TP + WKV_THREADS - 1) / WKV_THREADS; ++m) {
        const int idx = threadIdx.x + m * WKV_THREADS;
        if ((L * TP) % WKV_THREADS == 0 || idx < L * TP) {
            const int t = idx / TP, e = (idx % TP) * TE;
            const bool in = t < n_in;
            const int64_t o = row0 + (in ? t : 0) * stride_t + e;
            if constexpr (WITH_R) cp_async16(sr + t * K + e, r + o, in);
            cp_async16(sk + t * K + e, k + o, in);
            cp_async16(sv + t * K + e, v + o, in);
        }
    }
#pragma unroll
    for (int m = 0; m < (L * WP + WKV_THREADS - 1) / WKV_THREADS; ++m) {
        const int idx = threadIdx.x + m * WKV_THREADS;
        if ((L * WP) % WKV_THREADS == 0 || idx < L * WP) {
            const int t = idx / WP, e = (idx % WP) * 4;
            const bool in = t < n_in;
            cp_async16(sw + t * K + e, lw + row0 + (in ? t : 0) * stride_t + e, in);
        }
    }
}

// One block per (segment, h, b): y over the segment from the state `start`
// (its segment's, (B, H, n_seg, K, K), or S0 when n_seg is 1; zeros when
// null), and the last segment writes the final state to s_out (B, H, K, K).
template <typename T, int K, int L>
__global__ void __launch_bounds__(WKV_THREADS, sizeof(T) == 2 ? 3 : 2)
wkv6_chunks(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ log_w, const float* __restrict__ u, const float* __restrict__ start,
            float* __restrict__ y, float* __restrict__ s_out, int S, int H, int n_seg, int seg_len) {
    using W = Wkv<T, K, L>;
    constexpr int PAD = W::PAD, HALF = W::HALF, NSL = W::NSL, CW = W::CW, CWO = W::CWO, NK = W::NK, NL = W::NL;
    extern __shared__ __align__(128) char smem[];
    char* qh = smem + W::OFF_QH;
    char* ql = smem + W::OFF_QL;
    char* kh = smem + W::OFF_KH;
    char* kl = smem + W::OFF_KL;
    char* ah = smem + W::OFF_AH;
    char* al = smem + W::OFF_AL;
    float* vh = reinterpret_cast<float*>(smem + W::OFF_VH);
    float* vl = reinterpret_cast<float*>(smem + W::OFF_VL);
    float* cs = reinterpret_cast<float*>(smem + W::OFF_CUM);
    float* xr = reinterpret_cast<float*>(smem + W::OFF_X);   // R~ (rows i = HALF + x)
    float* xk = xr + HALF * K;                                 // K~ (rows j)
    float* es = reinterpret_cast<float*>(smem + W::OFF_E);
    auto at = [](char* base, int off) -> float* { return reinterpret_cast<float*>(base + off); };

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int n_chunks = t_end > t_begin ? (t_end - t_begin + L - 1) / L : 0;
    const int64_t stride_t = (int64_t)H * K;                  // one token of (B, S, H, K)
    const int64_t base = ((int64_t)b * S * H + h) * K;        // token 0 of (b, h)
    const int64_t cell = ((int64_t)b * H + h) * n_seg + seg;  // this segment's state
    const int v0 = 16 * warp + g;                             // the thread's first state column
    const bool holds = warp < W::MW;

    // The state in its TF32 parts, as the A operands of y's product:
    // sh[n][x], sl[n][x] hold S[8 n + 2 q + (x >> 1)][v0 + 8 (x & 1)] (the
    // accumulator of tile n with its two middle values swapped); zeros in
    // warps without state columns (K = 16).
    uint32_t sh[NK][4], sl[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int kk = 8 * n + 2 * q + (x >> 1), vv = v0 + 8 * (x & 1);
            split((start && holds) ? start[cell * K * K + (int64_t)kk * K + vv] : 0.f, sh[n][x], sl[n][x]);
        }

    // the operand pass: key pc, all tokens; k~, v, cum and K~ by the first K
    // threads, q~ and R~ by the next K
    const int pc = tid % K;
    const bool role_k = tid < K, role_q = tid >= K && tid < 2 * K;
    // A's diagonal blocks: rows ra_i and rb_i of block blk, keys [c0, c0 + CW)
    const int unit = tid / NSL, sl_ = tid % NSL, c0 = sl_ * CW;
    const int blk = unit / (HALF / 2), pp = unit % (HALF / 2);
    const int ra_i = HALF * blk + pp, rb_i = HALF * blk + HALF - 1 - pp;
    // A's off-diagonal block: rows HALF + oi, HALF + oi + 1, columns oj, oj + 1, keys [co, co + CWO)
    const int tile = tid / 8, s8 = tid % 8, oi = 2 * (tile / 4), oj = 2 * (tile % 4), co = s8 * CWO;
    float uu[CW];
#pragma unroll
    for (int x = 0; x < CW; ++x) uu[x] = u[h * K + c0 + x];
    // A above the diagonal stays 0
    for (int idx = tid; idx < W::A_BYTES / 4; idx += WKV_THREADS)
        reinterpret_cast<float*>(ah)[idx] = reinterpret_cast<float*>(al)[idx] = 0.f;
    // the wgmma descriptors of the first k-step of each operand; a later step
    // adds its byte offset / 16 to the start address field (no carry: shared
    // addresses are below 2^18)
    const uint64_t d_qh = smem_desc(qh, W::Q_LBO, W::Q_SBO), d_ql = smem_desc(ql, W::Q_LBO, W::Q_SBO);
    const uint64_t d_ah = smem_desc(ah, W::A_LBO, W::A_SBO), d_al = smem_desc(al, W::A_LBO, W::A_SBO);
    const uint64_t d_kh = smem_desc(kh, W::K_LBO, W::K_SBO), d_kl = smem_desc(kl, W::K_LBO, W::K_SBO);

    if (n_chunks > 0)
        stage_chunk<T, K, L, true>(smem, r, k, v, log_w, base + t_begin * stride_t, stride_t, t_end - t_begin);
    cp_async_commit();
    for (int ci = 0; ci < n_chunks; ++ci) {
        const int tc = t_begin + ci * L;
        cp_async_wait_all();
        __syncthreads();  // this chunk has landed, and the last chunk's products are done
        if (ci + 1 < n_chunks)
            stage_chunk<T, K, L, true>(smem + ((ci + 1) % WKV_STAGES) * W::STAGE, r, k, v, log_w,
                                       base + (tc + L) * stride_t, stride_t, t_end - tc - L);
        cp_async_commit();
        const char* stage = smem + (ci % WKV_STAGES) * W::STAGE;
        const T* rr = reinterpret_cast<const T*>(stage);
        const T* kr = rr + L * K;
        const T* vr = kr + L * K;
        const float* lwr = reinterpret_cast<const float*>(vr + L * K);

        // 1. the decayed operands, split: each of the first 2 K threads sums
        //    the log2 decays of its key over the chunk (cum, inclusive) and
        //    writes its half of the key's operands
        if (role_k || role_q) {
            float cum[L];
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                acc = fmaf(lwr[t * K + pc], WKV_LOG2E, acc);
                cum[t] = acc;
            }
            if (role_k) {
                float kv[L], vv[L];
#pragma unroll
                for (int t = 0; t < L; ++t) {
                    kv[t] = widen(kr[t * K + pc]);
                    vv[t] = widen(vr[t * K + pc]);
                }
#pragma unroll
                for (int t = 0; t < L; t += 4) {  // 4 tokens of a key are one 16-byte row of k~
                    float4 hi, lo;
                    split_to(kv[t] * ex2(acc - cum[t]), &hi.x, &lo.x);
                    split_to(kv[t + 1] * ex2(acc - cum[t + 1]), &hi.y, &lo.y);
                    split_to(kv[t + 2] * ex2(acc - cum[t + 2]), &hi.z, &lo.z);
                    split_to(kv[t + 3] * ex2(acc - cum[t + 3]), &hi.w, &lo.w);
                    *reinterpret_cast<float4*>(at(kh, W::k_at(pc, t))) = hi;
                    *reinterpret_cast<float4*>(at(kl, W::k_at(pc, t))) = lo;
                }
#pragma unroll
                for (int t = 0; t < L; ++t) {
                    if constexpr (W::EXACT_V) {
                        vh[t * PAD + pc] = vv[t];
                    } else {
                        split_to(vv[t], vh + t * PAD + pc, vl + t * PAD + pc);
                    }
                }
#pragma unroll
                for (int j = 0; j < HALF; ++j) xk[j * K + pc] = kv[j] * ex2(cum[HALF - 1] - cum[j]);
#pragma unroll
                for (int t = 0; t < L; ++t) cs[t * K + pc] = cum[t];
                es[pc] = ex2(acc);
            } else {
                float rv[L];
#pragma unroll
                for (int t = 0; t < L; ++t) rv[t] = widen(rr[t * K + pc]);
#pragma unroll
                for (int t = 0; t < L; ++t)
                    split_to(rv[t] * ex2(t > 0 ? cum[t - 1] : 0.f), at(qh, W::q_at(t, pc)), at(ql, W::q_at(t, pc)));
#pragma unroll
                for (int i = HALF; i < L; ++i) xr[(i - HALF) * K + pc] = rv[i] * ex2(cum[i - 1] - cum[HALF - 1]);
            }
        }
        __syncthreads();  // cum and R~, K~, for A

        // 2. A.  Its diagonal blocks (HALF x HALF) directly: rows ra_i
        //    (entries j < ra_i in the block) and rb_i, HALF - 1 entries and
        //    two diagonals a thread over its CW keys, the 16 slices' partials
        //    meeting in a reduce-scatter over 8 lanes (lane sl_ % 8 ends with
        //    value sl_ % 8) and one more level.  Its off-diagonal block,
        //    A[i][j] for i >= HALF > j, factored at the block's corner m =
        //    HALF - 1: 2^{cumq_i - cum_j} = 2^{cumq_i - cum_m} 2^{cum_m - cum_j},
        //    both exponents <= 0, so A_off = R~ K~^T with R~_i = r_i .
        //    2^{cumq_i - cum_m} and K~_j = k_j . 2^{cum_m - cum_j} (a term
        //    lost to underflow is below 2^-126): 2 x 2 entries a thread over
        //    CWO keys, 8 slices.  Every sum has one order.
        {
            float ra[CW], rb[CW], qa[CW], qb[CW], ka[CW], kb[CW];
            load_row(rr + ra_i * K + c0, ra);
            load_row(rr + rb_i * K + c0, rb);
            load_row(kr + ra_i * K + c0, ka);
            load_row(kr + rb_i * K + c0, kb);
            load_row(cs + (rb_i - 1) * K + c0, qb);
            if (ra_i > 0) {
                load_row(cs + (ra_i - 1) * K + c0, qa);
            } else {
#pragma unroll
                for (int x = 0; x < CW; ++x) qa[x] = 0.f;
            }
            float ri[2][CWO], kj2[2][CWO];
            load_row(xr + oi * K + co, ri[0]);
            load_row(xr + (oi + 1) * K + co, ri[1]);
            load_row(xk + oj * K + co, kj2[0]);
            load_row(xk + (oj + 1) * K + co, kj2[1]);
            float part[HALF];  // [s < HALF - 1]: the step's entry; [HALF - 1]: row ra_i's diagonal
            float diag_b = 0.f;
            part[HALF - 1] = 0.f;
#pragma unroll
            for (int x = 0; x < CW; ++x) {
                part[HALF - 1] = fmaf(ra[x] * uu[x], ka[x], part[HALF - 1]);
                diag_b = fmaf(rb[x] * uu[x], kb[x], diag_b);
            }
#pragma unroll
            for (int st = 0; st < HALF - 1; ++st) {
                const bool first = st < pp;
                const int j = HALF * blk + (first ? st : st - pp);
                float kj[CW], cj[CW];
                load_row(kr + j * K + c0, kj);
                load_row(cs + j * K + c0, cj);
                float a = 0.f;
#pragma unroll
                for (int x = 0; x < CW; ++x)
                    a = fmaf((first ? ra[x] : rb[x]) * kj[x], ex2((first ? qa[x] : qb[x]) - cj[x]), a);
                part[st] = a;
            }
            float off[4] = {0.f, 0.f, 0.f, 0.f};  // (oi, oj), (oi, oj + 1), (oi + 1, oj), (oi + 1, oj + 1)
#pragma unroll
            for (int x = 0; x < CWO; ++x) {
                off[0] = fmaf(ri[0][x], kj2[0][x], off[0]);
                off[1] = fmaf(ri[0][x], kj2[1][x], off[1]);
                off[2] = fmaf(ri[1][x], kj2[0][x], off[2]);
                off[3] = fmaf(ri[1][x], kj2[1][x], off[3]);
            }
            reduce_scatter<HALF>(part, sl_ % HALF);
            part[0] += __shfl_xor_sync(0xffffffffu, part[0], HALF);
#pragma unroll
            for (int o = NSL / 2; o >= 1; o /= 2) diag_b += __shfl_xor_sync(0xffffffffu, diag_b, o);
            reduce_scatter<4>(off, s8 % 4);
            off[0] += __shfl_xor_sync(0xffffffffu, off[0], 4);
            if (sl_ < HALF) {
                const bool first = sl_ < pp;
                const int o = sl_ == HALF - 1 ? W::a_at(ra_i, ra_i)
                                               : W::a_at(first ? ra_i : rb_i, HALF * blk + (first ? sl_ : sl_ - pp));
                split_to(part[0], at(ah, o), at(al, o));
            }
            if (sl_ == 0) split_to(diag_b, at(ah, W::a_at(rb_i, rb_i)), at(al, W::a_at(rb_i, rb_i)));
            if (s8 < 4) {
                const int o = W::a_at(HALF + oi + (s8 >> 1), oj + (s8 & 1));
                split_to(off[0], at(ah, o), at(al, o));
            }
        }
        fence_async_smem();
        __syncthreads();

        // 3. the products, one warpgroup, all in flight at once: y^T = S^T
        //    q~^T + v^T A^T (rows v, columns the chunk's tokens) and the
        //    chunk's state product from zero, E^T = v^T k~; then S <- 2^{tot}
        //    . S + E on the CUDA cores.  The three products of a split take
        //    two accumulators (hi hi; hi lo + lo hi).  v^T as A operands:
        //    vf[kt][x] is v[8 kt + q + 4 (x >> 1)][v0 + 8 (x & 1)].
        {
            uint32_t vfh[NL][4], vfl[NL][4];
#pragma unroll
            for (int kt = 0; kt < NL; ++kt)
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const int o = (8 * kt + q + 4 * (x >> 1)) * PAD + v0 + 8 * (x & 1);
                    vfh[kt][x] = holds ? __float_as_uint(vh[o]) : 0u;
                    vfl[kt][x] = (W::EXACT_V || !holds) ? 0u : __float_as_uint(vl[o]);
                }
            float yhh[8], ylo[8], ex[NK * 4];
            wgmma_fence();
#pragma unroll
            for (int kb2 = 0; kb2 < NK; ++kb2) {
                const uint64_t dh = d_qh + 2 * kb2 * W::Q_LBO / 16, dl = d_ql + 2 * kb2 * W::Q_LBO / 16;
                if (kb2 == 0) {
                    wgmma_tf32<false>(yhh, sh[kb2], dh);
                    wgmma_tf32<false>(ylo, sh[kb2], dl);
                } else {
                    wgmma_tf32<true>(yhh, sh[kb2], dh);
                    wgmma_tf32<true>(ylo, sh[kb2], dl);
                }
                wgmma_tf32<true>(ylo, sl[kb2], dh);
            }
#pragma unroll
            for (int kt = 0; kt < NL; ++kt) {
                const uint64_t dh = d_ah + 2 * kt * W::A_LBO / 16, dl = d_al + 2 * kt * W::A_LBO / 16;
                wgmma_tf32<true>(yhh, vfh[kt], dh);
                wgmma_tf32<true>(ylo, vfh[kt], dl);
                if constexpr (!W::EXACT_V) wgmma_tf32<true>(ylo, vfl[kt], dh);
            }
#pragma unroll
            for (int kt = 0; kt < NL; ++kt) {
                const uint64_t dh = d_kh + 2 * kt * W::K_LBO / 16, dl = d_kl + 2 * kt * W::K_LBO / 16;
                if (kt == 0)
                    wgmma_tf32<false>(ex, vfh[kt], dh);
                else
                    wgmma_tf32<true>(ex, vfh[kt], dh);
                wgmma_tf32<true>(ex, vfh[kt], dl);
                if constexpr (!W::EXACT_V) wgmma_tf32<true>(ex, vfl[kt], dh);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(yhh);
            fence_regs(ylo);
            fence_regs(ex);
            fence_regs(vfh);
            if constexpr (!W::EXACT_V) fence_regs(vfl);
            fence_regs(sh);
            fence_regs(sl);
            if (holds) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int t = 8 * (i >> 2) + 2 * q + (i & 1);
                    if (tc + t < t_end)
                        y[base + (int64_t)(tc + t) * stride_t + v0 + 8 * ((i >> 1) & 1)] = yhh[i] + ylo[i];
                }
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    const float2 d = *reinterpret_cast<const float2*>(es + 8 * n + 2 * q);
#pragma unroll
                    for (int x = 0; x < 4; ++x) {  // ex[4 n + e] is S[8 n + 2 q + (e & 1)][v0 + 8 (e >> 1)]
                        const float s_old = __uint_as_float(sh[n][x]) + __uint_as_float(sl[n][x]);
                        split(fmaf(s_old, (x >> 1) ? d.y : d.x, ex[4 * n + ((x & 1) << 1) + (x >> 1)]), sh[n][x], sl[n][x]);
                    }
                }
            }
        }
    }

    if (holds && seg == n_seg - 1) {
        const int64_t out = ((int64_t)b * H + h) * K * K;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                s_out[out + (int64_t)(8 * n + 2 * q + (x >> 1)) * K + v0 + 8 * (x & 1)] =
                    __uint_as_float(sh[n][x]) + __uint_as_float(sl[n][x]);
    }
}

// One block per (segment but the last, h, b): the state the segment leaves
// from zero, E = sum_j (k_j . 2^{tot - cum_j}) v_j^T with cum the running
// sum of the log2 decays over the segment and tot its total, to e_out (B,
// H, n_seg, K, K), and its decay 2^{tot} to d_out (B, H, n_seg, K).  The
// chunks are walked from the last: suf, the log2 decay of the chunks after
// the current one, makes a token's factor 2^{suf + tot_c - cum_c} (c the
// chunk's own sums; every exponent <= 0), and the tensor cores add each
// chunk's v^T k~ to E^T over the whole segment.  A chunk waits for the last
// chunk's products (every warp's share, behind a barrier) only before it
// overwrites their operands; the first K threads take the first half of a
// chunk's tokens, the next K the second.
template <typename T, int K, int L>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_states(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ log_w,
            float* __restrict__ e_out, float* __restrict__ d_out, int S, int H, int n_seg, int seg_len) {
    using W = Wkv<T, K, L>;
    using SL = WkvStates<T, K, L>;
    constexpr int PAD = W::PAD, NK = W::NK, NL = W::NL, HT = L / 2;
    extern __shared__ __align__(128) char smem[];
    char* kh = smem + SL::OFF_KH;
    char* kl = smem + SL::OFF_KL;
    float* vh = reinterpret_cast<float*>(smem + SL::OFF_VH);
    float* vl = reinterpret_cast<float*>(smem + SL::OFF_VL);
    auto at = [](char* base, int off) -> float* { return reinterpret_cast<float*>(base + off); };

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int n_chunks = t_end > t_begin ? (t_end - t_begin + L - 1) / L : 0;
    const int64_t stride_t = (int64_t)H * K;
    const int64_t base = ((int64_t)b * S * H + h) * K;
    const int64_t cell = ((int64_t)b * H + h) * n_seg + seg;
    const int v0 = 16 * warp + g;
    const bool holds = warp < W::MW;
    const int pc = tid % K, half = tid / K, t0 = half * HT;  // half 0 or 1: tokens [t0, t0 + HT)
    const uint64_t d_kh = smem_desc(kh, W::K_LBO, W::K_SBO), d_kl = smem_desc(kl, W::K_LBO, W::K_SBO);

    float ex[NK * 4];
#pragma unroll
    for (int i = 0; i < NK * 4; ++i) ex[i] = 0.f;
    uint32_t vfh[NL][4] = {}, vfl[NL][4] = {};
    float suf = 0.f;
    if (n_chunks > 0)
        stage_chunk<T, K, L, false>(smem, nullptr, k, v, log_w, base + (t_begin + (n_chunks - 1) * L) * stride_t,
                                    stride_t, t_end - t_begin - (n_chunks - 1) * L);
    cp_async_commit();
    for (int ci = n_chunks - 1; ci >= 0; --ci) {
        const int slot = (n_chunks - 1 - ci) % WKV_STAGES;
        cp_async_wait_all();
        __syncthreads();  // this chunk has landed
        if (ci > 0)
            stage_chunk<T, K, L, false>(smem + (1 - slot) * SL::STAGE, nullptr, k, v, log_w,
                                        base + (t_begin + (ci - 1) * L) * stride_t, stride_t, L);
        cp_async_commit();
        const char* stage = smem + slot * SL::STAGE;
        const T* kr = reinterpret_cast<const T*>(stage);
        const T* vr = kr + L * K;
        const float* lwr = reinterpret_cast<const float*>(vr + L * K);
        float kd[HT], vv[HT];
        if (half < 2) {
            float cum[L];
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                acc = fmaf(lwr[t * K + pc], WKV_LOG2E, acc);
                cum[t] = acc;
            }
#pragma unroll
            for (int m = 0; m < HT; ++m) {
                // cum[t0 + m] for the thread's half, without indexing registers by t0
                const float c = half ? cum[HT + m] : cum[m];
                kd[m] = widen(kr[(t0 + m) * K + pc]) * ex2(suf + (acc - c));
                vv[m] = widen(vr[(t0 + m) * K + pc]);
            }
            suf += acc;
        }
        wgmma_wait_all();
        fence_regs(ex);
        fence_regs(vfh);
        if constexpr (!W::EXACT_V) fence_regs(vfl);
        __syncthreads();  // every warp's share of the last chunk's products has read k~ and v
        if (half < 2) {
#pragma unroll
            for (int m = 0; m < HT; m += 4) {
                float4 hi, lo;
                split_to(kd[m], &hi.x, &lo.x);
                split_to(kd[m + 1], &hi.y, &lo.y);
                split_to(kd[m + 2], &hi.z, &lo.z);
                split_to(kd[m + 3], &hi.w, &lo.w);
                *reinterpret_cast<float4*>(at(kh, W::k_at(pc, t0 + m))) = hi;
                *reinterpret_cast<float4*>(at(kl, W::k_at(pc, t0 + m))) = lo;
            }
#pragma unroll
            for (int m = 0; m < HT; ++m) {
                const int o = (t0 + m) * PAD + pc;
                if constexpr (W::EXACT_V) {
                    vh[o] = vv[m];
                } else {
                    split_to(vv[m], vh + o, vl + o);
                }
            }
        }
        fence_async_smem();
        __syncthreads();
#pragma unroll
        for (int kt = 0; kt < NL; ++kt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int o = (8 * kt + q + 4 * (x >> 1)) * PAD + v0 + 8 * (x & 1);
                vfh[kt][x] = holds ? __float_as_uint(vh[o]) : 0u;
                vfl[kt][x] = (W::EXACT_V || !holds) ? 0u : __float_as_uint(vl[o]);
            }
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < NL; ++kt) {
            const uint64_t dh = d_kh + 2 * kt * W::K_LBO / 16, dl = d_kl + 2 * kt * W::K_LBO / 16;
            wgmma_tf32<true>(ex, vfh[kt], dh);
            wgmma_tf32<true>(ex, vfh[kt], dl);
            if constexpr (!W::EXACT_V) wgmma_tf32<true>(ex, vfl[kt], dh);
        }
        wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(ex);
    if (holds) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                e_out[cell * K * K + (int64_t)(8 * n + 2 * q + (e & 1)) * K + v0 + 8 * (e >> 1)] = ex[4 * n + e];
    }
    if (half == 0) d_out[cell * K + pc] = ex2(suf);
}

// One thread per (b, h, row, column) of the state: the segments' first
// states, in place of their E (the last segment's E is never made):
// start[0] = S0 (or 0), start[s + 1] = D_s . start[s] + E_s.
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

template <typename T, int K, int L>
static int launch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                  const float* s0, float* y, float* s_out, int B, int S, int H, int n_seg, int seg_len,
                  float* states, float* decay, cudaStream_t stream) {
    const T* rt = static_cast<const T*>(r);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const float* starts = s0;
    if (n_seg > 1) {
        constexpr int smem = WkvStates<T, K, L>::SMEM;
        cudaError_t e = cudaFuncSetAttribute(wkv6_states<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        wkv6_states<T, K, L><<<dim3(n_seg - 1, H, B), WKV_THREADS, smem, stream>>>(kt, vt, log_w, states, decay, S, H,
                                                                                   n_seg, seg_len);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int64_t cells = (int64_t)B * H * K * K;
        wkv6_carry<<<(int)((cells + 255) / 256), 256, 0, stream>>>(states, decay, s0, B * H, K, n_seg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        starts = states;
    }
    constexpr int smem = Wkv<T, K, L>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(wkv6_chunks<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    wkv6_chunks<T, K, L><<<dim3(n_seg, H, B), WKV_THREADS, smem, stream>>>(rt, kt, vt, log_w, u, starts, y, s_out, S,
                                                                           H, n_seg, seg_len);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                    const float* s0, float* y, float* s_out, int B, int S, int H, int K, int chunk, int n_seg,
                    int seg_len, float* states, float* decay, cudaStream_t stream) {
#define WKV_ARGS r, k, v, log_w, u, s0, y, s_out, B, S, H, n_seg, seg_len, states, decay, stream
    if (K == 16 && chunk == 16) return launch<T, 16, 16>(WKV_ARGS);
    if (K == 64 && chunk == 16) return launch<T, 64, 16>(WKV_ARGS);
#undef WKV_ARGS
    return (int)cudaErrorInvalidValue;
}

static int run(const void* r, const void* k, const void* v, const void* log_w, const void* u,
               const void* s0, void* y, void* s_out, int dtype, int B, int S, int H, int K, int chunk,
               int n_seg, int seg_len, void* states, void* decay, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || H == 0) return 0;
    if (n_seg < 1 || (n_seg > 1 && (states == nullptr || decay == nullptr || seg_len % chunk != 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* lw = static_cast<const float*>(log_w);
    const float* uu = static_cast<const float*>(u);
    const float* st = static_cast<const float*>(s0);
    float* yo = static_cast<float*>(y);
    float* so = static_cast<float*>(s_out);
    float* ws = static_cast<float*>(states);
    float* wd = static_cast<float*>(decay);
    if (dtype == DT_F32)
        return dispatch<float>(r, k, v, lw, uu, st, yo, so, B, S, H, K, chunk, n_seg, seg_len, ws, wd, s);
    if (dtype == DT_BF16)
        return dispatch<__nv_bfloat16>(r, k, v, lw, uu, st, yo, so, B, S, H, K, chunk, n_seg, seg_len, ws, wd, s);
    return (int)cudaErrorInvalidValue;
}

// One launch on `stream` of the device `device` (this library carries its
// own CUDA runtime, so the launch names its device), in one pass over the
// sequence, in chunks of `chunk` tokens.  (K, chunk) is (16, 16) or (64,
// 16); dtype is DT_F32 or DT_BF16 for r, k and v; s0 may be null; every
// pointer 16-byte aligned.  Returns a cudaError_t, 0 on success.  (An
// earlier version of this source took a row split where `chunk` is; the C
// signature is the same.)
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* log_w,
                           const void* u, const void* s0, void* y, void* s_out, int dtype, int B,
                           int S, int H, int K, int chunk, int device, void* stream) {
    return run(r, k, v, log_w, u, s0, y, s_out, dtype, B, S, H, K, chunk, 1, S, nullptr, nullptr, device, stream);
}

// The same over n_seg segments of seg_len tokens (a multiple of chunk; the
// last segment may be shorter; none empty), with workspace states (B, H,
// n_seg, K, K) and decay (B, H, n_seg, K), both f32.
extern "C" int wkv6_launch_segmented(const void* r, const void* k, const void* v, const void* log_w,
                                     const void* u, const void* s0, void* y, void* s_out, int dtype,
                                     int B, int S, int H, int K, int chunk, int n_seg, int seg_len,
                                     void* states, void* decay, int device, void* stream) {
    return run(r, k, v, log_w, u, s0, y, s_out, dtype, B, S, H, K, chunk, n_seg, seg_len, states, decay,
               device, stream);
}

template <typename F>
static int info_of(F fn, int smem, int* out) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, WKV_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = smem;
    out[2] = blocks;
    out[3] = (int)a.localSizeBytes;
    return 0;
}

template <typename T, int K, int L>
static int info_kernel(int with_y, int* out) {
    return with_y ? info_of(wkv6_chunks<T, K, L>, Wkv<T, K, L>::SMEM, out)
                  : info_of(wkv6_states<T, K, L>, WkvStates<T, K, L>::SMEM, out);
}

// What one kernel takes on `device`: out[0] registers a thread, out[1]
// dynamic shared bytes a block, out[2] blocks resident on an SM, out[3]
// local (spilled) bytes a thread; with_y 1 is the scan (wkv6_chunks), 0 the
// states pass.
extern "C" int wkv6_info(int dtype, int K, int chunk, int with_y, int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (chunk != 16) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32 && K == 16) return info_kernel<float, 16, 16>(with_y, out);
    if (dtype == DT_F32 && K == 64) return info_kernel<float, 64, 16>(with_y, out);
    if (dtype == DT_BF16 && K == 16) return info_kernel<__nv_bfloat16, 16, 16>(with_y, out);
    if (dtype == DT_BF16 && K == 64) return info_kernel<__nv_bfloat16, 64, 16>(with_y, out);
    return (int)cudaErrorInvalidValue;
}
