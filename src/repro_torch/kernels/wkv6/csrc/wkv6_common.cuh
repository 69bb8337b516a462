// Device helpers shared by the WKV6 kernels (csrc/wkv6.cu, the forward, and
// csrc/wkv6_bwd.cu, its gradient): loads widened to f32, 2^x, the split of
// an f32 value into TF32 parts, wgmma on TF32 operands (A from registers or
// from shared memory, B from shared memory) with its fences and
// descriptors, cp.async copies, and a reduce-scatter over lanes.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define WKV_THREADS 128
#define WKV_STAGES 2
#define WKV_LOG2E 1.4426950408889634f

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x for x <= 0, flushed to 0 below 2^-126 (whose product with anything
// the kernel adds is far under its tolerance).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Split TF32: x = hi + lo, hi = x with its low 13 bits cleared (the TF32
// value the tensor cores read from x) and lo = x - hi, exact in f32; an MMA
// reads lo to TF32's 10 mantissa bits in turn, so hi + lo stands for x
// within 2^-20 of |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_to(float x, float* hi, float* lo) {
    const float h = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    *hi = h;
    *lo = x - h;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }
// Shared memory written by the threads, read next by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// Keep the compiler from reusing or moving registers that an asynchronous
// wgmma reads or writes before the wait that covers it.
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

// A wgmma shared-memory descriptor without swizzle: the operand is made of
// core matrices of 8 rows of 16 bytes (8 x 4 TF32 values, K-major), `lbo`
// bytes apart along K and `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= a b on one warpgroup: A (64 x 8) from registers, as mma.sync's
// m16n8k8 fragment in each warp's 16 rows; B (8 x N) from shared memory;
// TF32 operands, f32 accumulators laid out as mma.sync's, 8 columns a tile.
// ACC false overwrites d (which is then not read).
#define WKV_D8(o) "=f"(d[o]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]), "=f"(d[o + 5]), "=f"(d[o + 6]), "=f"(d[o + 7])
#define WKV_A8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WKV_N16 "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
                "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, " \
                "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
#define WKV_N64 "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, " \
                "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
                "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
template <bool ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (ACC)
        asm volatile(WKV_N16 : WKV_A8(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    else
        asm volatile(WKV_N16 : WKV_D8(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
template <bool ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (ACC)
        asm volatile(WKV_N64 : WKV_A8(0), WKV_A8(8), WKV_A8(16), WKV_A8(24)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    else
        asm volatile(WKV_N64 : WKV_D8(0), WKV_D8(8), WKV_D8(16), WKV_D8(24)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef WKV_D8
#undef WKV_A8
#undef WKV_N16
#undef WKV_N64

// d (+)= a b on one warpgroup with both operands in shared memory (TF32,
// K-major core matrices as smem_desc describes; A 64 x 8, B 8 x N).
#define WKV_D8(o) "=f"(d[o]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]), "=f"(d[o + 5]), "=f"(d[o + 6]), "=f"(d[o + 7])
#define WKV_A8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WKV_SS16 "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, " \
                 "%8, %9, p, 1, 1;\n}\n"
#define WKV_SS64 "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, " \
                 "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
                 "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
template <bool ACC>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da, uint64_t db) {
    if constexpr (ACC)
        asm volatile(WKV_SS16 : WKV_A8(0) : "l"(da), "l"(db), "r"(1));
    else
        asm volatile(WKV_SS16 : WKV_D8(0) : "l"(da), "l"(db), "r"(0));
}
template <bool ACC>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db) {
    if constexpr (ACC)
        asm volatile(WKV_SS64 : WKV_A8(0), WKV_A8(8), WKV_A8(16), WKV_A8(24) : "l"(da), "l"(db), "r"(1));
    else
        asm volatile(WKV_SS64 : WKV_D8(0), WKV_D8(8), WKV_D8(16), WKV_D8(24) : "l"(da), "l"(db), "r"(0));
}
#undef WKV_D8
#undef WKV_A8
#undef WKV_SS16
#undef WKV_SS64

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// N consecutive values from shared memory, widened to f32 (p aligned to the
// vector it is read as).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&o)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const float4 x = reinterpret_cast<const float4*>(p)[i];
            o[4 * i] = x.x; o[4 * i + 1] = x.y; o[4 * i + 2] = x.z; o[4 * i + 3] = x.w;
        }
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        o[0] = x.x; o[1] = x.y;
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = p[i];
    }
}
__device__ __forceinline__ void unpack2(uint32_t x, float* o) {
    o[0] = __uint_as_float(x << 16);
    o[1] = __uint_as_float(x & 0xffff0000u);
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&o)[N]) {
    if constexpr (N % 8 == 0) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
            const uint4 x = reinterpret_cast<const uint4*>(p)[i];
            unpack2(x.x, o + 8 * i); unpack2(x.y, o + 8 * i + 2); unpack2(x.z, o + 8 * i + 4); unpack2(x.w, o + 8 * i + 6);
        }
    } else if constexpr (N == 4) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        unpack2(x.x, o); unpack2(x.y, o + 2);
    } else if constexpr (N == 2) {
        unpack2(*reinterpret_cast<const uint32_t*>(p), o);
    } else {
        o[0] = __bfloat162float(p[0]);
    }
}

// Lane sl of each group of CNT lanes (CNT <= 32, consecutive) ends with
// part[0] = the group's sum of part[sl]: at each level a lane keeps the half
// of its values its lane bit names and adds its partner's copy of them.
template <int CNT, int N>
__device__ __forceinline__ void reduce_scatter(float (&part)[N], int sl) {
    if constexpr (CNT > 1) {
        constexpr int HALF = CNT / 2;
        const bool upper = sl & HALF;
#pragma unroll
        for (int x = 0; x < HALF; ++x) {
            const float send = upper ? part[x] : part[x + HALF];
            const float keep = upper ? part[x + HALF] : part[x];
            part[x] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
        }
        reduce_scatter<HALF>(part, sl);
    }
}
