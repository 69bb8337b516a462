// The gradient of the WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper
// (sm_90a), as the chunked gradient with its state products on the tensor
// cores in split TF32.
//
// Replaces no TPU kernel: the JAX package trains rwkv6 by autodiff of its
// plain chunked form (src/repro/models/rwkv6.py:148, _wkv_chunked), which
// XLA differentiates.  The port's forward is a hand-written kernel
// (csrc/wkv6.cu), so its gradient is one too (ops.WKV6); ref.wkv6_bwd_plain
// is its plain version and ref.wkv6_bwd_chunked_split_plain this source's
// arithmetic on the CPU.
//
// What it computes, per batch row b and head h, for r, k, v (B, S, H, K) of
// one type (f32 or bf16, widened to f32 on load), log_w (B, S, H, K) f32,
// u (H, K) f32, an optional S0 (B, H, K, K) f32, dy (B, S, H, K) f32 and an
// optional dS_out (B, H, K, K) f32 (zeros when null): the gradient of
//   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,  S_t = diag(e^{log_w_t}) S_{t-1} + k_t v_t^T,
// dr, dk, dv in r's type, dlog_w f32, du in u's type (f32 or bf16), dS0 f32.
//
// The chunked gradient.  Per chunk of L = 16 tokens, in log2 units as the
// forward (cum the inclusive running sum of log_w log2(e), cumq the
// exclusive one, tot the last; r~ = r . 2^{cumq}, k~ = k . 2^{tot - cum};
// A the forward's within-chunk weights), with S the state before the chunk
// and dS' the gradient after it:
//   dA[i][j] = dy_i . v_j (j <= i)
//   dv  = A^T dy + k~ dS'        dr~ = dy S^T        dk~ = v dS'^T
//   dr_i = dr~_i 2^{cumq_i} + sum_{j<i} dA[i][j] k_j 2^{cumq_i - cum_j} + dA[i][i] u k_i
//   dk_j = dk~_j 2^{tot - cum_j} + sum_{i>j} dA[i][j] r_i 2^{cumq_i - cum_j} + dA[j][j] u r_j
//   du  += sum_i dA[i][i] r_i k_i;   the gradient before the chunk: 2^{tot} . dS' + r~^T dy
//   dlog_w_t = (a) 2^{tot} sum_v S[., v] dS'[., v]     (the same for every t of the chunk)
//            + (b) sum_{s>t} r~_s dr~_s + (c) sum_{s<t} k~_s dk~_s
//            + (d) sum_{s<t<s'} dA[s'][s] r_s' k_s 2^{cumq_s' - cum_s}   (A's pairs that straddle t)
// Every exponent is <= 0: a strong decay underflows to an exact 0 and
// nothing overflows; dlog_w is taken directly, never by the reverse-cumsum
// identity (a difference of two sums that grow with S).
//
// Bound.  At rwkv6-3b's training microbatch (2 x 2048, 40 heads of 64, r/k/v
// bf16): the bytes, r, k, v in bf16 and log_w, dy in f32 read, dr, dk, dv in
// bf16 and dlog_w in f32 written (24 bytes an element of 10,485,760), take
// 0.075 ms at 3.35 TB/s; the operations, five K x V products a token and
// head in split TF32 (0.041 ms) and the within-chunk sums on the CUDA cores
// (~0.025 ms), less: the bytes bound it (chip_smoke.wkv6_bwd_bound).  The
// token-by-token walk this kernel replaced (an f32 walk of 12 K^2 FLOPs a
// token, bound 0.120 ms) took 2.48 ms.
//
// Measured on an H100 (scripts/wkv6_bwd_shapes.py, in turns with the walk;
// PERF.md §6): 0.616-0.621 ms a call at rwkv6-3b's training microbatch
// (2 x 2048, 40 heads of 64, bf16) against the walk's 2.470-2.475 in turns,
// 8.2x the bytes bound; the states pass 0.076, the carries 0.032, the chunk
// pass 0.481, du 0.003.  Phase 18: 128 calls a rwkv6-3b step, 4.1-4.2% of
// its device time (the walk: 15%).
//
// Design, and what each step gave (device ms at the training microbatch,
// whole call or one launch, on an H100; the walk read 2.46-2.48 a call).
//   * The sequence is cut into segments of at most BWD_GROUPS x BWD_NC
//     chunks (kernel.BWD_SEGMENT tokens), so that the B * H heads of a
//     training microbatch fill the card: wkv6_bwd_states gives each
//     segment's state from zero and its decay (as the forward's states
//     pass) and the gradient it sends back from a zero gradient after it,
//     G = sum_t (r_t . 2^{pre + cumq_t})^T dy_t; wkv6_bwd_carry chains both,
//     forward from S0 and back from dS_out; wkv6_bwd_chunks runs each
//     segment; wkv6_bwd_du sums du's (b, segment) partials in a fixed
//     order.  No float atomics: two runs on the same inputs give the same
//     bits.  The carries walk both chains at once, loads of 16 segments in
//     flight (0.162 to 0.064 ms).  Segments of 128 tokens (two groups)
//     rather than 64 took the call 0.630 to 0.602: the carries halve, the
//     second group's rebuild costs 0.016 ms.
//   * wkv6_bwd_chunks: one block of two warpgroups a (segment, h, b).  For
//     each group of BWD_NC chunks from the last, it rebuilds the states
//     before them forward from the segment's first state (E = k~^T v on
//     wgmma, S <- 2^{tot} . S + E on the CUDA cores) into shared memory,
//     then walks them back.  Its inputs come through a two-stage ring filled
//     by cp.async, one chunk ahead.  (One warpgroup a block: 0.659 ms for
//     this pass; two, the second taking dv and the carried gradient:
//     0.634, then 0.536 once it also took A and dv's A^T dy went to the
//     tensor cores.)
//   * The four K x V products of a chunk walked back are wgmma m64nNk8 .tf32
//     in split TF32 (ref.split_tf32: three products, two where v is bf16),
//     each warpgroup's in flight at once.  The first warpgroup: dr~^T = S
//     dy^T and dk~^T = dS' v^T, S and dS' as register A operands (fragments,
//     the B operand's keys in the order the fragments hold them, as the
//     forward's).  The second: G^T = dy^T r~ and dv^T = dS'^T k~^T + dy^T
//     A^T, dS'^T from its registers and the rest from shared memory.  The
//     carried S and dS' are decayed and added on the CUDA cores, so the
//     tensor cores never round a carried state; dS' passes between the
//     warpgroups through shared memory in f32, in two buffers, so that they
//     meet only twice a chunk.  (The warpgroup read through a shuffle, so
//     that the compiler sees wgmma under a uniform branch: 0.536 to 0.505
//     ms; the two buffers and barriers of one warpgroup: 0.457.)
//   * A and dA as the forward takes A: the two diagonal 8 x 8 blocks
//     directly, the block below them factored at its corner (R~, K~), the
//     first warpgroup's dA while its products run.  The per-key sums (dr,
//     dk, dlog_w's terms) take one thread of the first warpgroup a key and
//     half chunk: the pairs of its diagonal block directly, the block below
//     as prefix sums of K~ (dA^T R~) over the first half and suffix sums of
//     R~ (dA K~) over the second.  dr, dk, dv and dlog_w are written once,
//     in their final form.
//   * Tried and dropped: dS' as an A operand from shared memory for dk~
//     (0.748), products of twice the width over a hi part and its lo part
//     (0.654), dA moved to the second warpgroup (0.681), a rebuild whose
//     product runs over the next chunk's preparation (0.783), one walk for
//     the states pass's two sums (0.094 against 0.076 ms for that pass):
//     each took registers the compiler then spilled, or serialized its
//     wgmma.  At K = 64 the chunk pass takes all 255 registers and spills
//     24 bytes (bf16); the tensor products, all m64n16 or m64n64 with K = 8,
//     run at a small share of the TF32 peak, and four warps a warpgroup at
//     one block an SM leave most latency exposed.
#include "wkv6_common.cuh"

#define BWD_NC 4         // the states the chunk pass keeps: chunks walked back a group
#define BWD_GROUPS 2     // groups a segment at most
#define BWD_THREADS 256  // the chunk pass's block: two warpgroups

template <typename O> __device__ __forceinline__ O narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// The layouts of the backward's chunk pass.  The wgmma operands are TF32
// core matrices (8 rows of 16 bytes, K-major, no swizzle), in three layouts:
//   KT: rows keys or values, K the chunk's tokens (k_at) -- k~^T and dy^T as
//       A (64 rows, those past K zero), r~ and v as B;
//   NT: rows the chunk's tokens, K the keys or values, each 8 in the order
//       0 2 4 6 1 3 5 7 of the register fragments that meet them (q_at) --
//       dy, v and k~ as B of dr~, dk~ and dv;
//   AT: rows j, K the i (at) -- A as B of dv's A^T dy.
// Then dS' in f32 (rows keys, DS_P floats apart), the one after this chunk
// and the one before it, and f32 arrays [token][key].  Offsets are spaced so that the threads'
// stores fall on different banks.
template <typename T, int K, int L>
struct Bwd {
    static constexpr int HALF = L / 2;
    static constexpr int NK = K / 8;
    static constexpr int NL = L / 8;
    static constexpr int MW = K / 16;                // warps of a warpgroup that hold rows
    static constexpr bool EXACT_V = sizeof(T) == 2;
    static constexpr int STAGE = 3 * L * K * (int)sizeof(T) + 2 * L * K * 4;   // r, k, v; log_w, dy
    static constexpr int KT_LBO = 128, KT_SBO = (L / 4) * KT_LBO + 16, KT_BYTES = 8 * KT_SBO;
    static constexpr int NT_LBO = 144, NT_SBO = (K / 4) * NT_LBO, NT_BYTES = (L / 8) * NT_SBO;
    static constexpr int AT_LBO = 128, AT_SBO = (L / 4) * AT_LBO, AT_BYTES = (L / 8) * AT_SBO;
    static constexpr int DS_P = K + 4;
    static constexpr int STATE = WKV_THREADS * NK * 16;                           // one state's fragments
    static constexpr int OFF_STATES = WKV_STAGES * STAGE;
    static constexpr int OFF_A1H = OFF_STATES + BWD_NC * STATE;  // zeroed once: k~^T (rebuild), r~ (back)
    static constexpr int OFF_A1L = OFF_A1H + KT_BYTES;
    static constexpr int OFF_B1H = OFF_A1L + KT_BYTES;           // v (rebuild), dy^T (back)
    static constexpr int OFF_B1L = OFF_B1H + KT_BYTES;
    static constexpr int OFF_ATH = OFF_B1L + KT_BYTES;           // A (its upper triangle stays 0)
    static constexpr int OFF_ATL = OFF_ATH + AT_BYTES;
    static constexpr int ZERO_END = OFF_ATL + AT_BYTES;
    static constexpr int OFF_DS = ZERO_END;                      // dS', [key][value], two buffers
    static constexpr int OFF_NKH = OFF_DS + 2 * K * DS_P * 4;    // k~ (B of dv)
    static constexpr int OFF_NKL = OFF_NKH + NT_BYTES;
    static constexpr int OFF_NVH = OFF_NKL + NT_BYTES;           // v (B of dk~)
    static constexpr int OFF_NVL = OFF_NVH + NT_BYTES;
    static constexpr int OFF_NDH = OFF_NVL + NT_BYTES;           // dy (B of dr~)
    static constexpr int OFF_NDL = OFF_NDH + NT_BYTES;
    static constexpr int OFF_CUM = OFF_NDL + NT_BYTES;           // [t][key] f32 arrays
    static constexpr int OFF_RT = OFF_CUM + L * K * 4;           // r~
    static constexpr int OFF_KT = OFF_RT + L * K * 4;            // k~
    static constexpr int OFF_DRT = OFF_KT + L * K * 4;           // dr~
    static constexpr int OFF_DKT = OFF_DRT + L * K * 4;          // dk~
    static constexpr int OFF_XR = OFF_DKT + L * K * 4;           // R~ (rows HALF..L-1)
    static constexpr int OFF_XK = OFF_XR + HALF * K * 4;         // K~ (rows 0..HALF-1)
    static constexpr int OFF_DA = OFF_XK + HALF * K * 4;         // dA, [i][j]
    static constexpr int OFF_ES = OFF_DA + L * L * 4;            // 2^{tot} a key
    static constexpr int OFF_AD = OFF_ES + K * 4;                // term (a) a key
    static constexpr int OFF_DU = OFF_AD + K * 4;                // du of the second half's threads
    static constexpr int SMEM = OFF_DU + K * 4;
    static_assert(L == 16 && K % 16 == 0 && K <= 64, "chunks of 16 tokens, tiles of 16 state rows");
    static_assert(4 * K <= BWD_THREADS, "the operand pass takes four threads a column");
    static_assert(STAGE % 16 == 0 && STATE % 16 == 0 && NT_BYTES % 16 == 0 && (K * DS_P * 4) % 16 == 0,
                  "16-byte aligned");

    __device__ static int k_at(int row, int t) { return (row / 8) * KT_SBO + (t / 4) * KT_LBO + (row % 8) * 16 + (t % 4) * 4; }
    __device__ static int q_at(int t, int col) {
        return (t / 8) * NT_SBO + (2 * (col / 8) + (col & 1)) * NT_LBO + (t % 8) * 16 + ((col % 8) / 2) * 4;
    }
    __device__ static int at(int j, int i) { return (j / 8) * AT_SBO + (i / 4) * AT_LBO + (j % 8) * 16 + (i % 4) * 4; }
};

// The states pass's block: a two-stage ring of (a, b, log_w) rows (k, v or
// r, dy), then a~^T (KT, as A; rows past K zero) and b (KT, as B), each
// split.
template <int K, int L>
struct BwdStates {
    static constexpr int STAGE = L * K * 12;
    static constexpr int KT_LBO = 128, KT_SBO = (L / 4) * KT_LBO + 16, KT_BYTES = 8 * KT_SBO;
    static constexpr int OFF_AH = WKV_STAGES * STAGE;
    static constexpr int OFF_AL = OFF_AH + KT_BYTES;
    static constexpr int OFF_BH = OFF_AL + KT_BYTES;
    static constexpr int OFF_BL = OFF_BH + KT_BYTES;
    static constexpr int SMEM = OFF_BL + KT_BYTES;
    __device__ static int k_at(int row, int t) { return (row / 8) * KT_SBO + (t / 4) * KT_LBO + (row % 8) * 16 + (t % 4) * 4; }
};

// cp.async copies, by NT threads, of L rows of K elements of `src` into
// `dst` (then advanced past them), rows past n_in zero-filled (their source
// is the first row, never read for them).
template <typename X, int K, int L, int NT>
__device__ __forceinline__ void stage_rows(char*& dst, const X* src, int64_t row0, int64_t stride_t, int n_in) {
    constexpr int TP = K * (int)sizeof(X) / 16, TE = 16 / (int)sizeof(X);
    X* s = reinterpret_cast<X*>(dst);
#pragma unroll
    for (int m = 0; m < (L * TP + NT - 1) / NT; ++m) {
        const int idx = threadIdx.x + m * NT;
        if ((L * TP) % NT == 0 || idx < L * TP) {
            const int t = idx / TP, e = (idx % TP) * TE;
            const bool in = t < n_in;
            cp_async16(s + t * K + e, src + row0 + (in ? t : 0) * stride_t + e, in);
        }
    }
    dst += L * K * (int)sizeof(X);
}

// Split x into TF32 parts at byte offset `o` of hi and lo.
__device__ __forceinline__ void put_split(char* hi, char* lo, int o, float x) {
    split_to(x, reinterpret_cast<float*>(hi + o), reinterpret_cast<float*>(lo + o));
}
// Four consecutive tokens' values of one row of a KT operand, split.
__device__ __forceinline__ void put_split4(char* hi, char* lo, int o, float a, float b, float c, float d) {
    float4 h, l;
    split_to(a, &h.x, &l.x);
    split_to(b, &h.y, &l.y);
    split_to(c, &h.z, &l.z);
    split_to(d, &h.w, &l.w);
    *reinterpret_cast<float4*>(hi + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
}

// The 16 x 16 lower triangle, diagonal included, of M[i][j] = sum over the
// keys of a_i b_j w_ij, each entry to put(i, j, M[i][j]): with DECAY, A (w = 2^{cumq_i -
// cum_j} below the diagonal, u on it), else dA (w = 1).  The forward's
// mapping (csrc/wkv6.cu, its step 2): the diagonal blocks directly, rows
// (p, HALF - 1 - p) of a block in one thread over CW keys, 16 slices meeting
// in a reduce-scatter; the block below them from its factors xa (rows HALF..
// L - 1) and xb (rows 0..HALF - 1), 2 x 2 entries a thread over CWO keys;
// `tid` the thread's index in its warpgroup.  Every sum has one order.
template <int K, int L, bool DECAY, typename TA, typename TB, typename TXA, typename TXB, typename PUT>
__device__ __forceinline__ void pair_sums(int tid, const TA* ar, const TB* br, const float* cs, const TXA* xa,
                                          const TXB* xb, const float* uu, PUT put) {
    constexpr int HALF = L / 2, NSL = WKV_THREADS / HALF, CW = K / NSL, CWO = K / 8;
    const int unit = tid / NSL, sl_ = tid % NSL, c0 = sl_ * CW;
    const int blk = unit / (HALF / 2), pp = unit % (HALF / 2);
    const int ra_i = HALF * blk + pp, rb_i = HALF * blk + HALF - 1 - pp;
    const int tile = tid / 8, s8 = tid % 8, oi = 2 * (tile / 4), oj = 2 * (tile % 4), co = s8 * CWO;
    float ra[CW], rb[CW], ka[CW], kb[CW], qa[CW], qb[CW];
    load_row(ar + ra_i * K + c0, ra);
    load_row(ar + rb_i * K + c0, rb);
    load_row(br + ra_i * K + c0, ka);
    load_row(br + rb_i * K + c0, kb);
    if constexpr (DECAY) {
        load_row(cs + (rb_i - 1) * K + c0, qb);
        if (ra_i > 0) {
            load_row(cs + (ra_i - 1) * K + c0, qa);
        } else {
#pragma unroll
            for (int x = 0; x < CW; ++x) qa[x] = 0.f;
        }
    }
    float ri[2][CWO], kj2[2][CWO];
    load_row(xa + oi * K + co, ri[0]);
    load_row(xa + (oi + 1) * K + co, ri[1]);
    load_row(xb + oj * K + co, kj2[0]);
    load_row(xb + (oj + 1) * K + co, kj2[1]);
    float part[HALF];  // [s < HALF - 1]: the step's entry; [HALF - 1]: row ra_i's diagonal
    float diag_b = 0.f;
    part[HALF - 1] = 0.f;
#pragma unroll
    for (int x = 0; x < CW; ++x) {
        const float wa = DECAY ? ra[x] * uu[c0 + x] : ra[x];
        const float wb = DECAY ? rb[x] * uu[c0 + x] : rb[x];
        part[HALF - 1] = fmaf(wa, ka[x], part[HALF - 1]);
        diag_b = fmaf(wb, kb[x], diag_b);
    }
#pragma unroll
    for (int st = 0; st < HALF - 1; ++st) {
        const bool first = st < pp;
        const int j = HALF * blk + (first ? st : st - pp);
        float kj[CW];
        load_row(br + j * K + c0, kj);
        float a = 0.f;
        if constexpr (DECAY) {
            float cj[CW];
            load_row(cs + j * K + c0, cj);
#pragma unroll
            for (int x = 0; x < CW; ++x)
                a = fmaf((first ? ra[x] : rb[x]) * kj[x], ex2((first ? qa[x] : qb[x]) - cj[x]), a);
        } else {
#pragma unroll
            for (int x = 0; x < CW; ++x) a = fmaf(first ? ra[x] : rb[x], kj[x], a);
        }
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
        const int i = sl_ == HALF - 1 ? ra_i : (first ? ra_i : rb_i);
        const int j = sl_ == HALF - 1 ? ra_i : HALF * blk + (first ? sl_ : sl_ - pp);
        put(i, j, part[0]);
    }
    if (sl_ == 0) put(rb_i, rb_i, diag_b);
    if (s8 < 4) put(HALF + oi + (s8 >> 1), oj + (s8 & 1), off[0]);
}

// dS' for the first warpgroup (f32, rows keys, DS_P floats apart) from the
// second's fragments of dS'^T: d[n][e] is dS'[8 n + 2 q + (e & 1)][r0 + 8
// (e >> 1)] in TF32 parts.
template <int NK, int DS_P>
__device__ __forceinline__ void ds_put(float* dsm, int r0, int q, const uint32_t (&dh)[NK][4],
                                       const uint32_t (&dl)[NK][4]) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            dsm[(8 * n + 2 * q + (e & 1)) * DS_P + r0 + 8 * (e >> 1)] = __uint_as_float(dh[n][e]) + __uint_as_float(dl[n][e]);
}

// the fragments of a state into a slot of the kept states
template <int NK>
__device__ __forceinline__ void save_state(float4* saved, int slot, int wt, const float (&st)[NK * 4]) {
#pragma unroll
    for (int i = 0; i < NK; ++i)
        saved[(slot * NK + i) * WKV_THREADS + wt] = make_float4(st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]);
}

// The chunk pass's steps over a segment of nc chunks: its groups of BWD_NC
// chunks from the last; for each, the rebuild of chunks 0 .. g1 - 2 from the
// segment's first state (keeping the states of the group's chunks), then
// the group's chunks g1 - 1 .. g0 walked back.  Step s's chunk, and whether
// it is walked back (all five inputs) or rebuilt (k, v, log_w).
__device__ __forceinline__ int2 step_of(int s, int nc) {
    for (int g0 = ((nc - 1) / BWD_NC) * BWD_NC; g0 >= 0; g0 -= BWD_NC) {
        const int g1 = min(nc, g0 + BWD_NC);
        if (s < g1 - 1) return make_int2(s, 0);
        s -= g1 - 1;
        if (s < g1 - g0) return make_int2(g1 - 1 - s, 1);
        s -= g1 - g0;
    }
    return make_int2(0, 0);
}

// a[N / 2 + m] when `upper`, else a[m] (no register array indexed at run time)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], bool upper, int m) {
    return upper ? a[N / 2 + m] : a[m];
}

// The barrier of one warpgroup alone.
__device__ __forceinline__ void sync_warpgroup(int wg) { asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory"); }

// One block of two warpgroups per (segment, h, b): the segment's gradient
// (see the header), from the state before it (`starts`, (B, H, n_seg, K,
// K); S0 or null when n_seg is 1) and the gradient after it (`ends`; dS_out
// or null when n_seg is 1).  dr, dk, dv, dlog_w written in place; du's (b,
// segment) partial to du_part (B, n_seg, H, K); segment 0 writes dS0.  The
// first warpgroup holds the state (rows keys), takes dr~ and dk~, dA and
// the per-key sums; the second holds the gradient dS'^T (rows values),
// takes A, G^T and dv, and leaves dS' in shared memory for the first.
template <typename T, int K, int L>
__global__ void __launch_bounds__(BWD_THREADS, 1)
wkv6_bwd_chunks(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ log_w, const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ starts, const float* __restrict__ ends, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dlog_w, float* __restrict__ du_part,
                float* __restrict__ ds0, int S, int H, int n_seg, int seg_len) {
    using W = Bwd<T, K, L>;
    constexpr int HALF = W::HALF, NK = W::NK, NL = W::NL, DS_P = W::DS_P;
    extern __shared__ __align__(128) char smem[];
    char* a1h = smem + W::OFF_A1H;
    char* a1l = smem + W::OFF_A1L;
    char* b1h = smem + W::OFF_B1H;
    char* b1l = smem + W::OFF_B1L;
    char* ath = smem + W::OFF_ATH;
    char* atl = smem + W::OFF_ATL;
    char* nkh = smem + W::OFF_NKH;
    char* nkl = smem + W::OFF_NKL;
    char* nvh = smem + W::OFF_NVH;
    char* nvl = smem + W::OFF_NVL;
    char* ndh = smem + W::OFF_NDH;
    char* ndl = smem + W::OFF_NDL;
    float* dsm = reinterpret_cast<float*>(smem + W::OFF_DS);
    float* cs = reinterpret_cast<float*>(smem + W::OFF_CUM);
    float* rtp = reinterpret_cast<float*>(smem + W::OFF_RT);
    float* ktp = reinterpret_cast<float*>(smem + W::OFF_KT);
    float* drs = reinterpret_cast<float*>(smem + W::OFF_DRT);
    float* dks = reinterpret_cast<float*>(smem + W::OFF_DKT);
    float* xr = reinterpret_cast<float*>(smem + W::OFF_XR);
    float* xk = reinterpret_cast<float*>(smem + W::OFF_XK);
    float* da = reinterpret_cast<float*>(smem + W::OFF_DA);
    float* es = reinterpret_cast<float*>(smem + W::OFF_ES);
    float* ad = reinterpret_cast<float*>(smem + W::OFF_AD);
    float* dus = reinterpret_cast<float*>(smem + W::OFF_DU);
    float4* saved = reinterpret_cast<float4*>(smem + W::OFF_STATES);

    // the warpgroup, read from lane 0 so that the compiler knows it is the
    // same across each warp (wgmma under a branch it cannot see as uniform
    // is serialized)
    const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WKV_THREADS, 0), wt = tid % WKV_THREADS;
    const int warp = wt / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int nc = t_end > t_begin ? (t_end - t_begin + L - 1) / L : 0;
    const int64_t stride_t = (int64_t)H * K;
    const int64_t base = ((int64_t)b * S * H + h) * K;
    const int64_t cell = ((int64_t)b * H + h) * n_seg + seg;
    const int r0 = 16 * warp + g;  // the thread's first row of a 64-row tile: a key (first), a value (second)
    const bool holds = warp < W::MW;
    // the operand passes: column pc; roles 0 and 1 the k side, 2 and 3 the
    // r side, each over the tokens of one half of the chunk
    const int pc = tid % K, role = tid / K;
    const bool upper = role & 1;
    const int th = HALF * (role & 1);
    // the first warpgroup's per-key pass: key pk, tokens of half ph
    const int pk = wt % K, ph = wt / K;

    // steps (step_of), one ring between them
    int n_steps = 0;
    for (int g0 = ((nc - 1) / BWD_NC) * BWD_NC; nc > 0 && g0 >= 0; g0 -= BWD_NC)
        n_steps += 2 * (min(nc, g0 + BWD_NC) - 1) + 1 - g0;
    auto stage = [&](int s) {
        const int2 sc = step_of(s, nc);
        const int c = sc.x, tc = t_begin + c * L;
        const bool full = sc.y;
        char* p = smem + (s % WKV_STAGES) * W::STAGE;
        const int64_t row0 = base + tc * stride_t;
        const int n_in = t_end - tc;
        if (full) {
            stage_rows<T, K, L, BWD_THREADS>(p, r, row0, stride_t, n_in);
        } else {
            p += L * K * (int)sizeof(T);
        }
        stage_rows<T, K, L, BWD_THREADS>(p, k, row0, stride_t, n_in);
        stage_rows<T, K, L, BWD_THREADS>(p, v, row0, stride_t, n_in);
        stage_rows<float, K, L, BWD_THREADS>(p, log_w, row0, stride_t, n_in);
        if (full) stage_rows<float, K, L, BWD_THREADS>(p, dy, row0, stride_t, n_in);
    };
    if (n_steps > 0) stage(0);
    cp_async_commit();

    for (int idx = tid; idx < (W::ZERO_END - W::OFF_A1H) / 16; idx += BWD_THREADS)
        reinterpret_cast<float4*>(a1h)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);

    // The first warpgroup's state before the chunk, rows keys: st[4 n + e]
    // = S[r0 + 8 (e >> 1)][8 n + 2 q + (e & 1)] (an m64nK accumulator).
    // The gradient after it, dS', in shared memory (dsm, two buffers: the
    // chunk's and the one before it), which the second warpgroup takes as
    // dS'^T, rows values, in TF32 parts: dth[n][e] + dtl[n][e] = dS'[8 n +
    // 2 q + (e & 1)][r0 + 8 (e >> 1)].
    float st[NK * 4];
    auto load_start = [&]() {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
                const float2 x = (holds && starts) ? *reinterpret_cast<const float2*>(
                                                         starts + cell * K * K + (int64_t)(r0 + 8 * e2) * K + 8 * n + 2 * q)
                                                   : make_float2(0.f, 0.f);
                st[4 * n + 2 * e2] = x.x;
                st[4 * n + 2 * e2 + 1] = x.y;
            }
    };
    if (wg == 1 && holds) {
        uint32_t dth[NK][4], dtl[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kk = 8 * n + 2 * q + (e & 1), vv = r0 + 8 * (e >> 1);
                split(ends ? ends[cell * K * K + (int64_t)kk * K + vv] : 0.f, dth[n][e], dtl[n][e]);
            }
        ds_put<NK, DS_P>(dsm, r0, q, dth, dtl);
    }

    const uint64_t d_a1h = smem_desc(a1h, W::KT_LBO, W::KT_SBO), d_a1l = smem_desc(a1l, W::KT_LBO, W::KT_SBO);
    const uint64_t d_b1h = smem_desc(b1h, W::KT_LBO, W::KT_SBO), d_b1l = smem_desc(b1l, W::KT_LBO, W::KT_SBO);
    const uint64_t d_ath = smem_desc(ath, W::AT_LBO, W::AT_SBO), d_atl = smem_desc(atl, W::AT_LBO, W::AT_SBO);
    const uint64_t d_nkh = smem_desc(nkh, W::NT_LBO, W::NT_SBO), d_nkl = smem_desc(nkl, W::NT_LBO, W::NT_SBO);
    const uint64_t d_nvh = smem_desc(nvh, W::NT_LBO, W::NT_SBO), d_nvl = smem_desc(nvl, W::NT_LBO, W::NT_SBO);
    const uint64_t d_ndh = smem_desc(ndh, W::NT_LBO, W::NT_SBO), d_ndl = smem_desc(ndl, W::NT_LBO, W::NT_SBO);
    const float uu = u[h * K + pk];
    float du_acc = 0.f;

    // the ring: wait for step s's chunk, then start the next step's copies
    auto advance = [&](int s) -> const char* {
        cp_async_wait_all();
        __syncthreads();  // this chunk has landed; the last step is done with shared memory
        if (s + 1 < n_steps) stage(s + 1);
        cp_async_commit();
        return smem + (s % WKV_STAGES) * W::STAGE;
    };

    int s = 0;  // the step
    for (int g0 = ((nc - 1) / BWD_NC) * BWD_NC; nc > 0 && g0 >= 0; g0 -= BWD_NC) {
        const int g1 = min(nc, g0 + BWD_NC);
        if (wg == 0) {
            load_start();
            if (g0 == 0) save_state<NK>(saved, 0, wt, st);
        }
        // ---- the rebuild: S_{c+1} = 2^{tot} . S_c + k~^T v, chunks 0 .. g1 - 2 ----
        for (int c = 0; c < g1 - 1; ++c, ++s) {
            const char* sp = advance(s);
            const T* kr = reinterpret_cast<const T*>(sp) + L * K;
            const T* vr = kr + L * K;
            const float* lwr = reinterpret_cast<const float*>(vr + L * K);
            if (role < 2) {
                float cum[L];
                float acc = 0.f;
#pragma unroll
                for (int t = 0; t < L; ++t) {
                    acc = fmaf(lwr[t * K + pc], WKV_LOG2E, acc);
                    cum[t] = acc;
                }
#pragma unroll
                for (int m = 0; m < HALF; m += 4) {
                    float x[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) x[j] = widen(kr[(th + m + j) * K + pc]) * ex2(acc - pick(cum, upper, m + j));
                    put_split4(a1h, a1l, W::k_at(pc, th + m), x[0], x[1], x[2], x[3]);
                }
                if (role == 0) es[pc] = ex2(acc);
            } else if (role < 4) {
#pragma unroll
                for (int m = 0; m < HALF; m += 4) {
                    const int t = th + m;
                    const float4 x = make_float4(widen(vr[t * K + pc]), widen(vr[(t + 1) * K + pc]),
                                                 widen(vr[(t + 2) * K + pc]), widen(vr[(t + 3) * K + pc]));
                    if constexpr (W::EXACT_V)
                        *reinterpret_cast<float4*>(b1h + W::k_at(pc, t)) = x;
                    else
                        put_split4(b1h, b1l, W::k_at(pc, t), x.x, x.y, x.z, x.w);
                }
            }
            fence_async_smem();
            __syncthreads();
            if (wg == 0) {
                float ex[NK * 4];
                wgmma_fence();
#pragma unroll
                for (int kt = 0; kt < NL; ++kt) {
                    const int o = 2 * kt * W::KT_LBO / 16;
                    if (kt == 0)
                        wgmma_tf32_ss<false>(ex, d_a1h + o, d_b1h + o);
                    else
                        wgmma_tf32_ss<true>(ex, d_a1h + o, d_b1h + o);
                    wgmma_tf32_ss<true>(ex, d_a1l + o, d_b1h + o);
                    if constexpr (!W::EXACT_V) wgmma_tf32_ss<true>(ex, d_a1h + o, d_b1l + o);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(ex);
                if (holds) {
                    const float d0 = es[r0], d1 = es[r0 + 8];
#pragma unroll
                    for (int i = 0; i < NK * 4; ++i) st[i] = fmaf(st[i], (i & 2) ? d1 : d0, ex[i]);
                }
                if (c + 1 >= g0) save_state<NK>(saved, (c + 1) % BWD_NC, wt, st);
            }
        }

        // ---- the group's chunks walked back, g1 - 1 .. g0 ----
        for (int c = g1 - 1; c >= g0; --c, ++s) {
            const int tc = t_begin + c * L;
            const int j = nc - 1 - c;  // chunks walked back before this one
            const char* sp = advance(s);
            const T* rr = reinterpret_cast<const T*>(sp);
            const T* kr = rr + L * K;
            const T* vr = kr + L * K;
            const float* lwr = reinterpret_cast<const float*>(vr + L * K);
            const float* dyr = lwr + L * K;
            const float* ds_c = dsm + (j & 1) * K * DS_P;         // dS' after this chunk
            float* ds_b = dsm + ((j + 1) & 1) * K * DS_P;         // and before it

            // 1. the operands: the k side (cum, k~, v, K~, 2^{tot}) and the r
            //    side (r~, dy, R~), one thread a column and half chunk
            if (role < 4) {
                float cum[L];
                float acc = 0.f;
#pragma unroll
                for (int t = 0; t < L; ++t) {
                    acc = fmaf(lwr[t * K + pc], WKV_LOG2E, acc);
                    cum[t] = acc;
                }
                if (role < 2) {
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = th + m;
                        const float ct = pick(cum, upper, m);
                        const float kv = widen(kr[t * K + pc]), vv = widen(vr[t * K + pc]);
                        const float kt = kv * ex2(acc - ct);
                        cs[t * K + pc] = ct;
                        ktp[t * K + pc] = kt;
                        put_split(nkh, nkl, W::q_at(t, pc), kt);
                        if constexpr (W::EXACT_V)
                            *reinterpret_cast<float*>(nvh + W::q_at(t, pc)) = vv;
                        else
                            put_split(nvh, nvl, W::q_at(t, pc), vv);
                        if (role == 0) xk[m * K + pc] = kv * ex2(cum[HALF - 1] - ct);
                    }
                    if (role == 0) es[pc] = ex2(acc);
                } else {
                    float rt[HALF], gv[HALF];
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = th + m;
                        const float cq = m > 0 ? pick(cum, upper, m - 1) : (upper ? cum[HALF - 1] : 0.f);
                        const float rv = widen(rr[t * K + pc]);
                        rt[m] = rv * ex2(cq);
                        gv[m] = dyr[t * K + pc];
                        rtp[t * K + pc] = rt[m];
                        put_split(ndh, ndl, W::q_at(t, pc), gv[m]);
                        if (role == 3) xr[m * K + pc] = rv * ex2(cq - cum[HALF - 1]);
                    }
#pragma unroll
                    for (int m = 0; m < HALF; m += 4) {
                        put_split4(a1h, a1l, W::k_at(pc, th + m), rt[m], rt[m + 1], rt[m + 2], rt[m + 3]);
                        put_split4(b1h, b1l, W::k_at(pc, th + m), gv[m], gv[m + 1], gv[m + 2], gv[m + 3]);
                    }
                }
            }
            fence_async_smem();
            __syncthreads();

            // 2. the products, each warpgroup's in flight at once; register A
            //    operands are fragments taken as (e 0, 2, 1, 3), the B operands'
            //    keys or values in the order 0 2 4 6 1 3 5 7.  The first
            //    warpgroup: dr~^T = S dy^T and dk~^T = dS' v^T, term (a), then dA
            //    while they run; then dr, dk, dlog_w and du by key.  The second:
            //    A (into AT), then G^T = dy^T r~, dv^T = dS'^T k~^T + dy^T A^T;
            //    then dv and the gradient before the chunk, 2^{tot} . dS' + G.
            //    The two meet again at the next chunk.
            if (wg == 0) {
                uint32_t sh[NK][4], sl[NK][4], dh[NK][4], dl[NK][4];
                float a0 = 0.f, a1 = 0.f;  // S . dS' over the thread's columns, rows r0 and r0 + 8
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    const float4 x = saved[((c % BWD_NC) * NK + n) * WKV_THREADS + wt];
                    const float sv[4] = {x.x, x.y, x.z, x.w};
                    const float2 d0 = *reinterpret_cast<const float2*>(ds_c + r0 * DS_P + 8 * n + 2 * q);
                    const float2 d1 = *reinterpret_cast<const float2*>(ds_c + (r0 + 8) * DS_P + 8 * n + 2 * q);
                    const float dv4[4] = {d0.x, d0.y, d1.x, d1.y};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        split(sv[e], sh[n][e], sl[n][e]);
                        split(dv4[e], dh[n][e], dl[n][e]);
                        if (e < 2)
                            a0 = fmaf(sv[e], dv4[e], a0);
                        else
                            a1 = fmaf(sv[e], dv4[e], a1);
                    }
                }
                float drt[8], dkt[8];
                wgmma_fence();
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    const uint32_t ah[4] = {sh[n][0], sh[n][2], sh[n][1], sh[n][3]};
                    const uint32_t al[4] = {sl[n][0], sl[n][2], sl[n][1], sl[n][3]};
                    const uint32_t gh[4] = {dh[n][0], dh[n][2], dh[n][1], dh[n][3]};
                    const uint32_t gl[4] = {dl[n][0], dl[n][2], dl[n][1], dl[n][3]};
                    const int o = 2 * n * W::NT_LBO / 16;
                    if (n == 0) {
                        wgmma_tf32<false>(drt, ah, d_ndh + o);
                        wgmma_tf32<false>(dkt, gh, d_nvh + o);
                    } else {
                        wgmma_tf32<true>(drt, ah, d_ndh + o);
                        wgmma_tf32<true>(dkt, gh, d_nvh + o);
                    }
                    wgmma_tf32<true>(drt, ah, d_ndl + o);
                    wgmma_tf32<true>(drt, al, d_ndh + o);
                    wgmma_tf32<true>(dkt, gl, d_nvh + o);
                    if constexpr (!W::EXACT_V) wgmma_tf32<true>(dkt, gh, d_nvl + o);
                }
                wgmma_commit();
                a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
                a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
                a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
                a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
                if (holds && q == 0) {
                    ad[r0] = es[r0] * a0;
                    ad[r0 + 8] = es[r0 + 8] * a1;
                }
                pair_sums<K, L, false>(wt, dyr, vr, cs, dyr + HALF * K, vr, u + h * K,
                                       [&](int i, int j, float x) { da[i * L + j] = x; });
                wgmma_wait_all();
                fence_regs(drt);
                fence_regs(dkt);
                fence_regs(sh);
                fence_regs(sl);
                fence_regs(dh);
                fence_regs(dl);
                if (holds) {
#pragma unroll
                    for (int i = 0; i < 8; ++i) {  // (key r0 + 8 (i >> 1 & 1), token 8 (i >> 2) + 2 q + (i & 1))
                        const int o = (8 * (i >> 2) + 2 * q + (i & 1)) * K + r0 + 8 * ((i >> 1) & 1);
                        drs[o] = drt[i];
                        dks[o] = dkt[i];
                    }
                }
                sync_warpgroup(0);  // dr~, dk~, dA and (a) are in place
                if (ph < 2) {
                    // 3a. dr, dk, dlog_w and du by key (the first warpgroup)
                    const int t0 = HALF * ph;
                    float rv[HALF], kv[HALF], cq[HALF], cm[HALF], drv[HALF], dkv[HALF], dlv[HALF];
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = t0 + m;
                        rv[m] = widen(rr[t * K + pk]);
                        kv[m] = widen(kr[t * K + pk]);
                        cm[m] = cs[t * K + pk];
                        cq[m] = t > 0 ? cs[(t - 1) * K + pk] : 0.f;
                    }
                    const float tot = cs[(L - 1) * K + pk], c7 = cs[(HALF - 1) * K + pk];
                    // the state's share and the bonus
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = t0 + m;
                        const float dd = da[t * L + t];
                        drv[m] = fmaf(dd * uu, kv[m], drs[t * K + pk] * ex2(cq[m]));
                        dkv[m] = fmaf(dd * uu, rv[m], dks[t * K + pk] * ex2(tot - cm[m]));
                        du_acc = fmaf(dd * rv[m], kv[m], du_acc);
                    }
                    // the pairs of the thread's diagonal block, and their share
                    // of (d): each pair's term to the tokens between them
#pragma unroll
                    for (int m = 0; m < HALF; ++m) dlv[m] = 0.f;
#pragma unroll
                    for (int s2 = 1; s2 < HALF; ++s2)
#pragma unroll
                        for (int s1 = 0; s1 < s2; ++s1) {
                            const float w = da[(t0 + s2) * L + t0 + s1] * ex2(cq[s2] - cm[s1]);
                            drv[s2] = fmaf(w, kv[s1], drv[s2]);
                            dkv[s1] = fmaf(w, rv[s2], dkv[s1]);
                            const float pair = w * rv[s2] * kv[s1];
#pragma unroll
                            for (int m = s1 + 1; m < s2; ++m) dlv[m] += pair;
                        }
                    // the block below the diagonal blocks, through its factors
                    if (ph == 0) {
                        float pre = 0.f;  // sum over s < t of K~_s (dA^T R~)_s
#pragma unroll
                        for (int m = 0; m < HALF; ++m) {
                            float x = 0.f;
#pragma unroll
                            for (int i = 0; i < HALF; ++i) x = fmaf(da[(HALF + i) * L + m], xr[i * K + pk], x);
                            dkv[m] = fmaf(ex2(c7 - cm[m]), x, dkv[m]);
                            dlv[m] += pre;
                            pre = fmaf(xk[m * K + pk], x, pre);
                        }
                    } else {
                        float suf = 0.f;  // sum over s' > t of R~_s' (dA K~)_s'
#pragma unroll
                        for (int m = HALF - 1; m >= 0; --m) {
                            float y = 0.f;
#pragma unroll
                            for (int j = 0; j < HALF; ++j) y = fmaf(da[(HALF + m) * L + j], xk[j * K + pk], y);
                            drv[m] = fmaf(ex2(cq[m] - c7), y, drv[m]);
                            dlv[m] += suf;
                            suf = fmaf(xr[m * K + pk], y, suf);
                        }
                    }
                    // (b) r~ dr~ after t and (c) k~ dk~ before t; the other half's share first
                    float other = 0.f;
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = HALF * (1 - ph) + m;
                        other = ph == 0 ? fmaf(rtp[t * K + pk], drs[t * K + pk], other)
                                        : fmaf(ktp[t * K + pk], dks[t * K + pk], other);
                    }
                    float bsum = ph == 0 ? other : 0.f;
#pragma unroll
                    for (int m = HALF - 1; m >= 0; --m) {
                        dlv[m] += bsum;
                        bsum = fmaf(rtp[(t0 + m) * K + pk], drs[(t0 + m) * K + pk], bsum);
                    }
                    float csum = ph == 1 ? other : 0.f;
                    const float aa = ad[pk];
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        dlv[m] += csum;
                        csum = fmaf(ktp[(t0 + m) * K + pk], dks[(t0 + m) * K + pk], csum);
                        dlv[m] += aa;
                    }
#pragma unroll
                    for (int m = 0; m < HALF; ++m) {
                        const int t = tc + t0 + m;
                        if (t < t_end) {
                            const int64_t o = base + (int64_t)t * stride_t + pk;
                            dr[o] = narrow<T>(drv[m]);
                            dk[o] = narrow<T>(dkv[m]);
                            dlog_w[o] = dlv[m];
                        }
                    }
                }
            } else {
                float gx[NK * 4], dvw[8];
                uint32_t dth[NK][4], dtl[NK][4];
                pair_sums<K, L, true>(wt, rr, kr, cs, xr, xk, u + h * K,
                                      [&](int i, int j, float x) { put_split(ath, atl, W::at(j, i), x); });
                fence_async_smem();
                sync_warpgroup(1);  // A is in place
#pragma unroll
                for (int n = 0; n < NK; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split(holds ? ds_c[(8 * n + 2 * q + (e & 1)) * DS_P + r0 + 8 * (e >> 1)] : 0.f, dth[n][e], dtl[n][e]);
                wgmma_fence();
#pragma unroll
                for (int kt = 0; kt < NL; ++kt) {
                    const int o = 2 * kt * W::KT_LBO / 16, oa = 2 * kt * W::AT_LBO / 16;
                    if (kt == 0) {
                        wgmma_tf32_ss<false>(gx, d_b1h + o, d_a1h + o);
                        wgmma_tf32_ss<false>(dvw, d_b1h + o, d_ath + oa);
                    } else {
                        wgmma_tf32_ss<true>(gx, d_b1h + o, d_a1h + o);
                        wgmma_tf32_ss<true>(dvw, d_b1h + o, d_ath + oa);
                    }
                    wgmma_tf32_ss<true>(gx, d_b1h + o, d_a1l + o);
                    wgmma_tf32_ss<true>(gx, d_b1l + o, d_a1h + o);
                    wgmma_tf32_ss<true>(dvw, d_b1h + o, d_atl + oa);
                    wgmma_tf32_ss<true>(dvw, d_b1l + o, d_ath + oa);
                }
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    const uint32_t ah[4] = {dth[n][0], dth[n][2], dth[n][1], dth[n][3]};
                    const uint32_t al[4] = {dtl[n][0], dtl[n][2], dtl[n][1], dtl[n][3]};
                    const int o = 2 * n * W::NT_LBO / 16;
                    wgmma_tf32<true>(dvw, ah, d_nkh + o);
                    wgmma_tf32<true>(dvw, ah, d_nkl + o);
                    wgmma_tf32<true>(dvw, al, d_nkh + o);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(gx);
                fence_regs(dvw);
                fence_regs(dth);
                fence_regs(dtl);
                if (holds) {
#pragma unroll
                    for (int i = 0; i < 8; ++i) {  // (value r0 + 8 (i >> 1 & 1), token 8 (i >> 2) + 2 q + (i & 1))
                        const int t = 8 * (i >> 2) + 2 * q + (i & 1);
                        if (tc + t < t_end)
                            dv[base + (int64_t)(tc + t) * stride_t + r0 + 8 * ((i >> 1) & 1)] = narrow<T>(dvw[i]);
                    }
#pragma unroll
                    for (int n = 0; n < NK; ++n) {
                        const float2 d = *reinterpret_cast<const float2*>(es + 8 * n + 2 * q);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float x = __uint_as_float(dth[n][e]) + __uint_as_float(dtl[n][e]);
                            split(fmaf(x, (e & 1) ? d.y : d.x, gx[4 * n + e]), dth[n][e], dtl[n][e]);
                        }
                    }
                    ds_put<NK, DS_P>(ds_b, r0, q, dth, dtl);
                }
            }
        }
    }
    __syncthreads();  // the gradient before the segment is in place
    if (seg == 0) {
        const float* ds_f = dsm + (nc & 1) * K * DS_P;
        const int64_t out = ((int64_t)b * H + h) * K * K;
        for (int i = tid; i < K * K; i += BWD_THREADS) ds0[out + i] = ds_f[(i / K) * DS_P + i % K];
    }
    if (wg == 0 && ph == 1) dus[pk] = du_acc;
    __syncthreads();
    if (wg == 0 && ph == 0) du_part[(((int64_t)b * n_seg + seg) * H + h) * K + pk] = du_acc + dus[pk];
}

// The sum over one segment of (a_t . 2^{x_t})^T b_t into acc (rows keys:
// acc[4 n + e] is [r0 + 8 (e >> 1)][8 n + 2 q + (e & 1)]) on the tensor
// cores in split TF32, walking the chunks back (BACK: x_t = the log2 decay
// after token t within the segment, for the state the segment leaves) or
// forward (x_t = the log2 decay before token t, for the gradient it sends
// back).  Returns the segment's log2 decay.  A chunk waits for the last
// chunk's products only before it overwrites their operands.
template <typename TA, typename TB, int K, int L, bool BACK>
__device__ __forceinline__ float segment_sum(const TA* a, const TB* bsrc, const float* lw, char* smem, int64_t base,
                                             int64_t stride_t, int t_begin, int t_end, float (&acc)[K / 2]) {
    using SL = BwdStates<K, L>;
    constexpr int NL = L / 8;
    constexpr bool EXACT_B = sizeof(TB) == 2;
    char* ah = smem + SL::OFF_AH;
    char* al = smem + SL::OFF_AL;
    char* bh = smem + SL::OFF_BH;
    char* bl = smem + SL::OFF_BL;
    const uint64_t d_ah = smem_desc(ah, SL::KT_LBO, SL::KT_SBO), d_al = smem_desc(al, SL::KT_LBO, SL::KT_SBO);
    const uint64_t d_bh = smem_desc(bh, SL::KT_LBO, SL::KT_SBO), d_bl = smem_desc(bl, SL::KT_LBO, SL::KT_SBO);
    const int tid = threadIdx.x, pc = tid % K, role = tid / K;
    const int nc = (t_end - t_begin + L - 1) / L;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) acc[i] = 0.f;
    auto stage = [&](int i) {
        const int c = BACK ? nc - 1 - i : i, tc = t_begin + c * L;
        char* p = smem + (i % WKV_STAGES) * SL::STAGE;
        const int64_t row0 = base + tc * stride_t;
        stage_rows<TA, K, L, WKV_THREADS>(p, a, row0, stride_t, t_end - tc);
        stage_rows<TB, K, L, WKV_THREADS>(p, bsrc, row0, stride_t, t_end - tc);
        stage_rows<float, K, L, WKV_THREADS>(p, lw, row0, stride_t, t_end - tc);
    };
    float logd = 0.f;  // the log2 decay of the chunks walked
    stage(0);
    cp_async_commit();
    for (int i = 0; i < nc; ++i) {
        cp_async_wait_all();
        __syncthreads();
        if (i + 1 < nc) stage(i + 1);
        cp_async_commit();
        const char* sp = smem + (i % WKV_STAGES) * SL::STAGE;
        const TA* ar = reinterpret_cast<const TA*>(sp);
        const TB* br = reinterpret_cast<const TB*>(sp + L * K * (int)sizeof(TA));
        const float* lwr = reinterpret_cast<const float*>(sp + L * K * ((int)sizeof(TA) + (int)sizeof(TB)));
        float x[L];
        if (role == 0) {
            float cum[L];
            float c = 0.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                c = fmaf(lwr[t * K + pc], WKV_LOG2E, c);
                cum[t] = c;
            }
#pragma unroll
            for (int t = 0; t < L; ++t)
                x[t] = widen(ar[t * K + pc]) * ex2(BACK ? logd + (c - cum[t]) : logd + (t > 0 ? cum[t - 1] : 0.f));
            logd += c;
        } else if (role == 1) {
#pragma unroll
            for (int t = 0; t < L; ++t) x[t] = widen(br[t * K + pc]);
        }
        wgmma_wait_all();
        fence_regs(acc);
        __syncthreads();  // every warp's share of the last chunk's products has read its operands
        if (role == 0) {
#pragma unroll
            for (int t = 0; t < L; t += 4) put_split4(ah, al, SL::k_at(pc, t), x[t], x[t + 1], x[t + 2], x[t + 3]);
        } else if (role == 1) {
#pragma unroll
            for (int t = 0; t < L; t += 4) {
                if constexpr (EXACT_B)
                    *reinterpret_cast<float4*>(bh + SL::k_at(pc, t)) = make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
                else
                    put_split4(bh, bl, SL::k_at(pc, t), x[t], x[t + 1], x[t + 2], x[t + 3]);
            }
        }
        fence_async_smem();
        __syncthreads();
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < NL; ++kt) {
            const int o = 2 * kt * SL::KT_LBO / 16;
            wgmma_tf32_ss<true>(acc, d_ah + o, d_bh + o);
            wgmma_tf32_ss<true>(acc, d_al + o, d_bh + o);
            if constexpr (!EXACT_B) wgmma_tf32_ss<true>(acc, d_ah + o, d_bl + o);
        }
        wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // the next walk's stores wait for every warp's products
    return logd;
}

// One block per (segment, h, b), n_seg > 1: the state the segment leaves
// from zero, E = sum_t (k_t . 2^{tot - cum_t}) v_t^T, to e_out (B, H, n_seg,
// K, K) for every segment but the last, walking its chunks back; the
// gradient it sends back from zero, G = sum_t (r_t . 2^{cumq_t})^T dy_t, to
// g_out for every segment but the first, walking them forward (cum, cumq
// over the segment); its decay 2^{tot} to d_out (B, H, n_seg, K).  (One
// walk taking both, each column's chunk decays summed first, read 0.094
// against the two walks' 0.076 ms at rwkv6-3b's training microbatch: 164
// registers, three blocks an SM against five.)
template <typename T, int K, int L>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_bwd_states(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ log_w, const float* __restrict__ dy, float* __restrict__ e_out,
                float* __restrict__ g_out, float* __restrict__ d_out, int S, int H, int n_seg, int seg_len) {
    using SL = BwdStates<K, L>;
    constexpr int NK = K / 8;
    extern __shared__ __align__(128) char smem[];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_begin = seg * seg_len, t_end = min(S, t_begin + seg_len);
    const int64_t stride_t = (int64_t)H * K;
    const int64_t base = ((int64_t)b * S * H + h) * K;
    const int64_t cell = ((int64_t)b * H + h) * n_seg + seg;
    const int r0 = 16 * warp + g;
    const bool holds = warp < K / 16;
    for (int idx = tid; idx < (SL::OFF_BH - SL::OFF_AH) / 16; idx += WKV_THREADS)  // A's rows past K stay 0
        reinterpret_cast<float4*>(smem + SL::OFF_AH)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    float acc[NK * 4];
    float logd = 0.f;
    auto put = [&](float* out) {
        if (holds) {
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2)
                    *reinterpret_cast<float2*>(out + cell * K * K + (int64_t)(r0 + 8 * e2) * K + 8 * n + 2 * q) =
                        make_float2(acc[4 * n + 2 * e2], acc[4 * n + 2 * e2 + 1]);
        }
    };
    if (seg + 1 < n_seg) {
        logd = segment_sum<T, T, K, L, true>(k, v, log_w, smem, base, stride_t, t_begin, t_end, acc);
        put(e_out);
    }
    if (seg > 0) {
        logd = segment_sum<T, float, K, L, false>(r, dy, log_w, smem, base, stride_t, t_begin, t_end, acc);
        put(g_out);
    }
    if (tid < K) d_out[cell * K + tid] = ex2(logd);
}

// One thread per (b, h, row, column) of the state, in place of the states
// pass's E and G (the last segment's E and the first's G are never made):
// forward, start[0] = S0 (or 0), start[s + 1] = D_s . start[s] + E_s (the
// state before each segment); back, end[n_seg - 1] = dS_out (or 0), end[s -
// 1] = D_s . end[s] + G_s (the gradient after each segment).
__global__ void wkv6_bwd_carry(float* __restrict__ states, float* __restrict__ grads, const float* __restrict__ decay,
                               const float* __restrict__ s0, const float* __restrict__ ds_out, int BH, int K,
                               int n_seg) {
    constexpr int STEP = 16;  // segments of each chain whose loads are in flight at once
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t kk = (int64_t)K * K;
    if (i >= BH * kk) return;
    const int64_t bh = i / kk, cell = i - bh * kk, row = cell / K;
    float* fw = states + bh * n_seg * kk + cell;
    float* bw = grads + bh * n_seg * kk + cell;
    const float* dc = decay + bh * n_seg * K + row;
    float st = s0 ? s0[i] : 0.f;
    float gd = ds_out ? ds_out[i] : 0.f;
    // both chains at once: forward over segments s, back over n_seg - 1 - s
    for (int s0_ = 0; s0_ < n_seg; s0_ += STEP) {
        float e[STEP], df[STEP], gb[STEP], db[STEP];
#pragma unroll
        for (int j = 0; j < STEP; ++j) {
            const int s = s0_ + j, sb = n_seg - 1 - s;
            e[j] = s + 1 < n_seg ? fw[s * kk] : 0.f;
            df[j] = s + 1 < n_seg ? dc[s * K] : 0.f;
            gb[j] = sb > 0 ? bw[sb * kk] : 0.f;
            db[j] = sb > 0 ? dc[sb * K] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < STEP; ++j) {
            const int s = s0_ + j, sb = n_seg - 1 - s;
            if (s < n_seg) {
                fw[s * kk] = st;
                bw[sb * kk] = gd;
            }
            st = fmaf(df[j], st, e[j]);
            gd = fmaf(db[j], gd, gb[j]);
        }
    }
}

// du: the (b, segment) partials summed in that order, in u's type.
template <typename U>
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, int n_parts, int HK, U* __restrict__ du) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= HK) return;
    float sum = 0.f;
    for (int p = 0; p < n_parts; ++p) sum += du_part[(int64_t)p * HK + e];
    du[e] = narrow<U>(sum);
}

namespace {

int64_t work_floats(int B, int H, int K, int n_seg) {
    return 2 * (int64_t)B * H * n_seg * K * K + (int64_t)B * H * n_seg * K + (int64_t)B * n_seg * H * K;
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* log_w, const float* u, const float* s0,
           const float* dy, const float* ds_out, void* dr, void* dk, void* dv, float* dlog_w, void* du, float* ds0,
           float* work, int u_dtype, int B, int S, int H, int n_seg, int seg_len, cudaStream_t stream) {
    constexpr int L = 16;
    const T* rt = static_cast<const T*>(r);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    float* states = work;
    float* grads = states + (int64_t)B * H * n_seg * K * K;
    float* decay = grads + (int64_t)B * H * n_seg * K * K;
    float* du_part = decay + (int64_t)B * H * n_seg * K;
    const float* starts = s0;
    const float* ends = ds_out;
    cudaError_t e;
    if (n_seg > 1) {
        constexpr int smem = BwdStates<K, L>::SMEM;
        e = cudaFuncSetAttribute(wkv6_bwd_states<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        wkv6_bwd_states<T, K, L><<<dim3(n_seg, H, B), WKV_THREADS, smem, stream>>>(
            rt, kt, vt, log_w, dy, states, grads, decay, S, H, n_seg, seg_len);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int64_t cells = (int64_t)B * H * K * K;
        wkv6_bwd_carry<<<(int)((cells + 255) / 256), 256, 0, stream>>>(states, grads, decay, s0, ds_out, B * H, K, n_seg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        starts = states;
        ends = grads;
    }
    constexpr int smem = Bwd<T, K, L>::SMEM;
    e = cudaFuncSetAttribute(wkv6_bwd_chunks<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    wkv6_bwd_chunks<T, K, L><<<dim3(n_seg, H, B), BWD_THREADS, smem, stream>>>(
        rt, kt, vt, log_w, u, dy, starts, ends, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlog_w,
        du_part, ds0, S, H, n_seg, seg_len);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int HK = H * K;
    if (u_dtype == DT_F32)
        wkv6_bwd_du<float><<<(HK + 255) / 256, 256, 0, stream>>>(du_part, B * n_seg, HK, static_cast<float*>(du));
    else
        wkv6_bwd_du<__nv_bfloat16><<<(HK + 255) / 256, 256, 0, stream>>>(du_part, B * n_seg, HK,
                                                                          static_cast<__nv_bfloat16*>(du));
    return (int)cudaGetLastError();
}

template <typename F>
int info_of(F fn, int threads, int smem, int* out) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = smem;
    out[2] = blocks;
    out[3] = (int)a.localSizeBytes;
    return 0;
}

template <typename T, int K>
int info_kernel(int which, int* out) {
    constexpr int L = 16;
    return which ? info_of(wkv6_bwd_chunks<T, K, L>, BWD_THREADS, Bwd<T, K, L>::SMEM, out)
                 : info_of(wkv6_bwd_states<T, K, L>, WKV_THREADS, BwdStates<K, L>::SMEM, out);
}

}  // namespace

// One backward on `stream` of device `device` (this library carries its own
// CUDA runtime, so the launch names its device), over n_seg segments of
// seg_len tokens (a multiple of 16, at most 16 BWD_NC BWD_GROUPS; the last may be
// shorter; none empty; 1 for S = 0): the states pass and the carries (when
// n_seg > 1), the chunk pass and du's sum.  K is 16 or 64; dtype DT_F32 or
// DT_BF16 for r, k, v (and dr, dk, dv), u_dtype for du; s0 and ds_out may be
// null; `work` holds `work_n` floats, at least work_floats() (the segments'
// states, their gradients, their decays and du's partials; Python's
// kernel.bwd_work_floats); every pointer 16-byte aligned.  Returns a
// cudaError_t, 0 on success.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* log_w, const float* u,
                               const float* s0, const float* dy, const float* ds_out, void* dr, void* dk, void* dv,
                               float* dlog_w, void* du, float* ds0, float* work, int64_t work_n, int dtype,
                               int u_dtype, int B, int S, int H, int K, int n_seg, int seg_len, int device,
                               void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if ((K != 16 && K != 64) || (dtype != DT_F32 && dtype != DT_BF16) || (u_dtype != DT_F32 && u_dtype != DT_BF16))
        return (int)cudaErrorInvalidValue;
    if (n_seg < 1 || seg_len < 16 || seg_len % 16 != 0 || seg_len > 16 * BWD_NC * BWD_GROUPS ||
        (int64_t)(n_seg - 1) * seg_len >= (S > 0 ? S : 1) || (int64_t)n_seg * seg_len < S)
        return (int)cudaErrorInvalidValue;
    if (work_n < work_floats(B, H, K, n_seg)) return (int)cudaErrorInvalidValue;
    if (B == 0 || H == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WKV_BWD_ARGS r, k, v, log_w, u, s0, dy, ds_out, dr, dk, dv, dlog_w, du, ds0, work, u_dtype, B, S, H, n_seg, seg_len, s
    if (dtype == DT_F32) return K == 16 ? launch<float, 16>(WKV_BWD_ARGS) : launch<float, 64>(WKV_BWD_ARGS);
    return K == 16 ? launch<__nv_bfloat16, 16>(WKV_BWD_ARGS) : launch<__nv_bfloat16, 64>(WKV_BWD_ARGS);
#undef WKV_BWD_ARGS
}

// What one kernel takes on `device`: out[0] registers a thread, out[1]
// dynamic shared bytes a block, out[2] blocks resident on an SM, out[3]
// local (spilled) bytes a thread; which 1 is the chunk pass
// (wkv6_bwd_chunks), 0 the states pass.
extern "C" int wkv6_bwd_info(int dtype, int K, int which, int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (dtype == DT_F32 && K == 16) return info_kernel<float, 16>(which, out);
    if (dtype == DT_F32 && K == 64) return info_kernel<float, 64>(which, out);
    if (dtype == DT_BF16 && K == 16) return info_kernel<__nv_bfloat16, 16>(which, out);
    if (dtype == DT_BF16 && K == 64) return info_kernel<__nv_bfloat16, 64>(which, out);
    return (int)cudaErrorInvalidValue;
}
