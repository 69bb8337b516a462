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
// The running max, sum and accumulator are f32; the output is cast to q's
// type (round to nearest even) once, at the end.  The order is the Pallas
// kernel's: scale, then softcap, then mask.
//
// Bound.  FLOPs = 4 * D * (unmasked query-key pairs) * B * H (two products
// of one multiply-add per pair and feature); bytes = those of q, k, v and o,
// each moved once.  bound = max(FLOPs / 989 TFLOP/s bf16 dense,
// bytes / 3.35 TB/s) on an H100 SXM: at gemma2-9b's prefill shapes (D = 256,
// S >= 2048) the FLOPs bound it by two orders of magnitude.
//
// Design, and what it does about that bound.  A first kernel: right
// before fast, and no TMA, wgmma or warp specialisation yet.
//   * One block owns one (b, h, tile of 64 queries) and walks the key tiles
//     of 64 that some query of its tile may see.  Key tiles wholly above the
//     causal diagonal or wholly outside the window are never loaded, so a
//     local layer costs what its band costs.  k and v are read from device
//     memory once per query tile; the blocks of one (b, kv head) read the
//     same tiles, which L2 keeps.
//   * bf16 inputs run on the tensor cores (flash_fwd_mma_kernel): four warps
//     of 16 queries each, mma.sync m16n8k16 with f32 accumulation, operands
//     staged in shared memory by cp.async (each copy overlapping a product)
//     and fetched with ldmatrix.  p is rounded to
//     bf16 only as the operand of p.v, after its row sum is taken in f32.
//     This is the path the serving prefill runs.
//   * f32 inputs run on the CUDA cores in f32 FMA (flash_fwd_kernel), since
//     TF32 would not hold the 2e-3 tolerance: eight warps of 8 queries, q
//     and k rows padded by 4 floats so that the lanes' 16-byte reads of 32
//     different k rows hit 32 different banks, an 8 x (D / 32) accumulator
//     slice in each lane's registers.
//   * The softmax statistics are shuffles in a fixed order and every sum has
//     a fixed order, so results are bitwise deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------
//
// One block of 4 warps owns 64 queries; a warp owns 16 of them.  The q, k and
// v tiles sit in shared memory in bf16 (101 KB at D = 256, so two blocks
// share an SM), rows padded by 8 elements so that ldmatrix's eight 16-byte
// rows fall in distinct banks.  cp.async brings v(t) in while q.k(t)^T runs
// and k(t+1) while p.v(t) runs.  S = q.k^T comes
// from ldmatrix'd fragments of q and k; its f32 accumulator fragment is the
// softmax's working set (a row lives in one quad of lanes, so its max and
// sum are two shuffles); p is rounded to bf16 only as the A operand of
// p.v (the row sum l is taken before the rounding), and v's B fragments
// come from ldmatrix.trans.  The output accumulator (16 x D per warp, f32)
// stays in registers.

#define FT_BQ 64
#define FT_BK 64
#define FT_THREADS 128
#define FT_PAD 8  // bf16 elements of padding of a shared row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    // 16 bytes from global to shared memory, or 16 zero bytes when !valid
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// rows x D bf16 from src (row stride `stride` elements) into shared memory
// with row stride D + FT_PAD, 16 bytes a thread, asynchronously; rows at or
// past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t stride, int rows, int valid) {
    constexpr int PER_ROW = D / 8;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += FT_THREADS) {
        const int r = i / PER_ROW, c = (i - r * PER_ROW) * 8;
        const bool ok = r < valid;
        cp_async16(smem_addr(dst + r * (D + FT_PAD) + c), ok ? src + r * stride + c : src, ok);
    }
}

template <int D>
constexpr size_t mma_smem_bytes() {
    return (size_t)(FT_BQ + 2 * FT_BK) * (D + FT_PAD) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(FT_THREADS, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                     int Sk, int H, int Hkv, int causal, int window, float scale, float softcap) {
    constexpr int LD = D + FT_PAD;
    constexpr int NT = FT_BK / 8;  // key n-tiles of S
    constexpr int DT = D / 8;      // feature n-tiles of the output
    extern __shared__ uint4 smem_u4[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
    __nv_bfloat16* Ks = Qs + FT_BQ * LD;
    __nv_bfloat16* Vs = Ks + FT_BK * LD;

    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
    const int q0 = blockIdx.x * FT_BQ;
    const int q_valid = min(FT_BQ, Sq - q0);
    const int off = Sk - Sq;

    const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
    const __nv_bfloat16* qg = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
    const __nv_bfloat16* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
    const __nv_bfloat16* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
    __nv_bfloat16* og = o + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;

    const int first_pos = q0 + off, last_pos = q0 + q_valid - 1 + off;
    const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
    const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;

    float acc[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp

    // the q tile and the first k tile, in flight together
    const int kt_first = (k_lo / FT_BK) * FT_BK;
    load_tile_async<D>(Qs, qg, q_stride, FT_BQ, q_valid);
    if (kt_first < k_hi)
        load_tile_async<D>(Ks, kg + kt_first * kv_stride, kv_stride, FT_BK, min(FT_BK, Sk - kt_first));
    cp_async_commit();
    // this lane's ldmatrix row addresses (see the fragment layouts of mma.m16n8k16)
    const uint32_t q_addr = smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
    const uint32_t k_addr = smem_addr(Ks + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
    const uint32_t v_addr = smem_addr(Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
    constexpr uint32_t ROW16 = 16 * LD * sizeof(__nv_bfloat16);  // 16 rows, in bytes

    // Each tile overlaps a copy with a product: v(t) lands while q.k(t)^T
    // and the softmax run, k(t+1) while p.v(t) runs.
    for (int kt0 = kt_first; kt0 < k_hi; kt0 += FT_BK) {
        load_tile_async<D>(Vs, vg + kt0 * kv_stride, kv_stride, FT_BK, min(FT_BK, Sk - kt0));
        cp_async_commit();
        cp_async_wait<1>();  // q and k(t) are in
        __syncthreads();
        // every key of the tile is visible to every query of the block
        const bool full = kt0 + FT_BK <= Sk && (!causal || kt0 + FT_BK - 1 <= first_pos) &&
                          (window <= 0 || last_pos - kt0 < window);

        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bb[4];
                ldsm_x4(bb, k_addr + np * ROW16 + kk * 32);
                mma_bf16(s[2 * np], a, bb[0], bb[1]);
                mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
            }
        }

        // online softmax; s[t][2 * hh + e] is row g + 8 hh, key kt0 + 8 t + 2 tq + e
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int pos = q0 + warp * 16 + g + 8 * hh + off;
            uint32_t keep = 0;
            float mx = FA_NEG;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kk = kt0 + 8 * t + 2 * tq + e;
                    float x = s[t][2 * hh + e] * scale;
                    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
                    bool ok = full || kk < Sk;
                    if (causal && !full) ok = ok && kk <= pos;
                    if (window > 0 && !full) ok = ok && (pos - kk) < window;
                    keep |= (uint32_t)ok << (2 * t + e);
                    x = ok ? x : FA_NEG;
                    s[t][2 * hh + e] = x;
                    mx = fmaxf(mx, x);
                }
            }
            const float m_new = fmaxf(m[hh], quad_max(mx));
            const float corr = expf(m[hh] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = (keep >> (2 * t + e)) & 1u ? expf(s[t][2 * hh + e] - m_new) : 0.f;
                    s[t][2 * hh + e] = p;
                    psum += p;
                }
            }
            l[hh] = l[hh] * corr + quad_sum(psum);
            m[hh] = m_new;
#pragma unroll
            for (int t = 0; t < DT; ++t) {
                acc[t][2 * hh] *= corr;
                acc[t][2 * hh + 1] *= corr;
            }
        }

        cp_async_wait<0>();  // v(t) is in
        __syncthreads();     // and every warp is done with k(t)
        if (kt0 + FT_BK < k_hi)
            load_tile_async<D>(Ks, kg + (kt0 + FT_BK) * kv_stride, kv_stride, FT_BK,
                               min(FT_BK, Sk - kt0 - FT_BK));
        cp_async_commit();

        // acc += p . v, 16 keys a step; p's A fragment is s's C fragment
#pragma unroll
        for (int kk = 0; kk < FT_BK / 16; ++kk) {
            uint32_t a[4];
            a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                uint32_t bb[4];
                ldsm_x4_trans(bb, v_addr + kk * ROW16 + dp * 32);
                mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
                mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
            }
        }
        __syncthreads();  // every warp is done with v(t)
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = warp * 16 + g + 8 * hh;
        if (row >= q_valid) continue;
        const float lsafe = l[hh] == 0.f ? 1.f : l[hh];
        __nv_bfloat16* out = og + row * q_stride + 2 * tq;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * t) =
                __floats2bfloat162_rn(acc[t][2 * hh] / lsafe, acc[t][2 * hh + 1] / lsafe);
        }
    }
}

template <int D>
static int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, int window, float scale, float softcap,
                      cudaStream_t stream) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + FT_BQ - 1) / FT_BQ, H, B);
    flash_fwd_mma_kernel<D><<<grid, FT_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Hkv,
        causal, window, scale, softcap);
    return (int)cudaGetLastError();
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
// 128, 256; dtype is DT_F32 or DT_BF16.  Returns a cudaError_t, 0 on success.
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
            case 32: return launch_mma<32>(FA_ARGS);
            case 64: return launch_mma<64>(FA_ARGS);
            case 128: return launch_mma<128>(FA_ARGS);
            case 256: return launch_mma<256>(FA_ARGS);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}
