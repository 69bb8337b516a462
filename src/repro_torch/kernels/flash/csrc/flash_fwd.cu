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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

#define WG_THREADS 384        // warpgroup 0 loads, warpgroups 1 and 2 compute
#define WG_PRODUCER_REGS 24   // setmaxnreg: 24 * 128 + 2 * 240 * 128 <= 65,536
#define WG_CONSUMER_REGS 240

static constexpr float LOG2E = 1.4426950408889634f;

struct WgParams {
    __nv_bfloat16* o;
    int Sq, Sk, H, Hkv, n_qt, causal, window;
    float scale, softcap;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of a 4-D tensor map (D, heads, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int h,
                                         int s, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(h), "r"(s), "r"(b)
        : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across the wait that covers it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// A softcapped score in log2 units, softcap * tanh(y / softcap) * log2 e
// for y = s * scale, on the special-function units: `mul` is scale /
// softcap and `cap_l2` softcap * log2 e.  One tanh.approx.f32 (relative
// error at most 2^-11).
__device__ __forceinline__ float capped_log2(float s, float mul, float cap_l2) {
    float t;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(s * mul));
    return t * cap_l2;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma with f32 accumulators: S = A . B from shared memory (m64n80, m64n128),
// and O += A . B with A in registers and B MN-major (m64n{32,64,128,256}).
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

        // out = o / l, rounded to bf16 once; rows with no visible key give 0
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            const float lsum = quad_sum(l[hh]);
            if (row >= q_valid) continue;
            const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
            __nv_bfloat16* out = p.o + (((int64_t)b * p.Sq + q0 + row) * p.H + h) * D + cq;
#pragma unroll
            for (int i = 0; i < D / 8; ++i)
                *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
                    __floats2bfloat162_rn(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
        }
    }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is reached
// through the runtime's entry-point query, so the library links nothing more.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

// The tensor map of a (B, S, heads, D) bf16 tensor as 4-D (D, heads, S, B),
// so that a box never runs from one sequence into the next: rows past S
// read as zeros.  A box is ROWE features of one head over `rows` positions.
// Returns 0, or FA_MAP_ERROR + the CUresult.
#define FA_MAP_ERROR 1000
template <int D>
static int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return FA_MAP_ERROR;
    using C = WgCfg<D>;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2, (cuuint64_t)S * heads * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::ROWE, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : FA_MAP_ERROR + (int)r;
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

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
                        int Hkv, int causal, int window, float scale, float softcap, cudaStream_t stream) {
    if (Sk == 0)  // no row sees a key
        return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * D * 2, stream);
    CUtensorMap tq, tk, tv;
    int rc = make_map<D>(&tq, q, B, Sq, H, WgCfg<D>::BQ);
    if (rc == 0) rc = make_map<D>(&tk, k, B, Sk, Hkv, WgCfg<D>::BK);
    if (rc == 0) rc = make_map<D>(&tv, v, B, Sk, Hkv, WgCfg<D>::BK);
    if (rc != 0) return rc;
    WgParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.Sq = Sq, p.Sk = Sk, p.H = H, p.Hkv = Hkv, p.causal = causal, p.window = window;
    p.n_qt = (Sq + WgCfg<D>::BQ - 1) / WgCfg<D>::BQ;
    p.scale = scale, p.softcap = softcap;
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
// 128, 256; dtype is DT_F32 or DT_BF16.  Returns 0 on success, a
// cudaError_t, or FA_MAP_ERROR + the CUresult of a tensor map's encoding.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                                int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                                int window, float scale, float softcap, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
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
    } else if (dtype == DT_BF16) {
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
