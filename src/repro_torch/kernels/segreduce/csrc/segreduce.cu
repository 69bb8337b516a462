// Fused segmented (group-by) reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segreduce/kernel.py::
// fused_segreduce_pallas (its body _fused_kernel) and, through it,
// segreduce_pallas, which is the same kernel with one aggregate, no mask and
// no presence histogram.
//
// What it computes: for A value columns, each under its own op (sum, max or
// min), out_a[k] = op over values_a[i] for every row i with keys[i] == k and
// mask[i] != 0, plus an optional int32 presence histogram (the count of such
// rows per key).  Empty segments hold the op's identity: 0 for sum, the
// int32 extremes for integer max/min, -inf/+inf for float max/min.  int32
// sums wrap like JAX's int32; bf16/f16 values accumulate in f32 and the
// result is rounded back (round to nearest even).  Rows whose key lies
// outside [0, K) are dropped, as XLA's segment ops drop them.
//
// Bound: bytes.  The card must read every row once and write every output
// once: N * (4 key + 1 mask + sum of value bytes) + K * (A + 1) * 4 bytes,
// over 3.35 TB/s on an H100 SXM.  The arithmetic, one add or compare per
// row and aggregate, is far below any peak rate.
//
// Design, and what it does about that bound:
//   * Determinism.  Two runs on one input give bit-identical results.  Float
//     sums are never folded by atomics, not even in shared memory: a warp
//     walks rows 32 at a time in a fixed order; within a step, the lanes
//     holding one key (__match_any_sync) are folded in ascending lane order
//     by warp shuffles and the lowest of them alone updates the warp's
//     private table; tables are then combined in a fixed order.  The order of
//     every float addition is set by the shapes, never by scheduling.
//   * Small K with a float sum (regime 0).  When W per-warp tables of
//     K * (A + presence) words fit in the 227 KB of shared memory a block
//     may use, each warp reduces a contiguous slice of the rows into its
//     table there, the block folds its W tables in warp order into global
//     scratch, and a second kernel folds the blocks' tables, one warp per
//     output cell.  The rows are read once; the scratch is small because K is.
//   * Large K with a float sum (regime 1).  The key space is cut into R
//     ranges whose W per-warp tables fit in shared memory.  The counted rows
//     are first partitioned stably by range (a per-tile histogram, a scan,
//     and a scatter that keeps row order within each range; masked rows are
//     dropped here), then one block per range reduces its rows in shared
//     memory and writes its slice of the outputs.  The bytes moved are a
//     small multiple of the bound instead of tables of all K keys per warp.
//   * No float sum (regimes 2 and 3).  Integer sums (which wrap), min, max
//     and presence give the same bits in any order, so atomics are
//     deterministic too, and rows may be moved in any order.  Float min/max
//     fold as int32 through an order-preserving map of their bits (-0.0
//     below +0.0; a NaN is sent past both ends, so that it wins as it does
//     in torch.maximum/minimum), unmapped when written out.  Int32 columns
//     and presence need no map: the table's bits are the output's, so there
//     is no scratch table.  Every pass loads SEG_ROW_STEP rows a thread
//     before it folds them, aggregate by aggregate.
//     - Regime 2, direct: every block folds a grid-stride share of the rows
//       into one table of all K keys in shared memory when such tables fit
//       a quarter of it (small K), then adds its table into the outputs with
//       global atomics; otherwise straight into the outputs, one L2 atomic a
//       row and table.  The outputs are first filled with their (mapped)
//       identities, and float min/max columns are unmapped in place at the
//       end.  16-bit min/max columns fold into their own outputs by a CAS on
//       the aligned word.
//     - Regime 3, partitioned, for large K with at least two tables and as
//       many rows as keys.  A histogram pass counts the rows of each key
//       range (2^shift keys), a scatter pass moves each counted row's 16-bit
//       key offset and one word a value column (none for presence) into its
//       range's run, in any order (masked rows are dropped there), and one
//       block a range folds its rows into one shared-memory table a column
//       and writes its slice of every output: no fill, and no global atomic
//       on a table.  Those passes cost about what one L2 atomic a row does
//       (measured on an H100), so one table, or fewer rows than keys, take
//       the direct pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#define SEG_MAX_AGGS 16
#define SEG_WARPS_PER_BLOCK 8
#define SEG_TILE_ROWS 8192
#define SEG_SCAN_THREADS 1024

enum { VT_INT32 = 0, VT_F32 = 1, VT_BF16 = 2, VT_F16 = 3 };
enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

// Mirrored field for field by the ctypes.Structure in kernel.py.
struct SegParams {
    const int32_t* keys;
    const uint8_t* mask;              // nullptr: every row counts
    const void* vals[SEG_MAX_AGGS];
    void* out[SEG_MAX_AGGS];          // int32, f32, bf16 or f16, as the value column
    int32_t* presence;                // nullptr unless with_presence
    uint32_t* scratch;                // regime 0: n_warps / W * n_tables * num_keys words
    int32_t* counts;                  // regime 1: n_tiles * n_buckets, tile-major
    int32_t* bucket_start;            // regime 1: n_buckets + 1
    int32_t* part_keys;               // regime 1: n_rows
    uint32_t* part_vals;              // regime 1: n_aggs * n_rows words
    int64_t n_rows;
    int64_t rows_per_warp;            // regime 0; a multiple of 32
    int32_t num_keys;
    int32_t n_aggs;
    int32_t with_presence;
    int32_t n_warps;                  // regime 0; a multiple of W
    int32_t regime;
    int32_t device;
    int32_t n_buckets;                // regime 1
    int32_t keys_per_bucket;          // regime 1
    int32_t n_tiles;                  // regime 1
    int32_t reduce_warps;             // regime 1: warps of a bucket's block
    int32_t n_blocks;                 // regime 2: grid of the row pass; regime 3: of the histogram
    int32_t atomic_smem;              // regime 2: per-block tables in shared memory
    int32_t vtype[SEG_MAX_AGGS];
    int32_t op[SEG_MAX_AGGS];
    // Fields added after the ones above, which keep their order, so that an
    // earlier build of this source reads the same struct.
    uint16_t* part_off;               // regime 3: n_rows key offsets within a range
    int32_t* part_ranges;             // regime 3: 2 * n_buckets + 2 words (see seg_part_histogram)
    int32_t bucket_shift;             // regime 3: a range holds 1 << bucket_shift keys
};

__device__ __forceinline__ bool is_int(int vt) { return vt == VT_INT32; }

__device__ __forceinline__ uint32_t identity_word(int op, int vt) {
    if (op == OP_SUM) return 0u;  // int 0 and float +0.0 share the bits
    if (is_int(vt)) return op == OP_MAX ? (uint32_t)INT32_MIN : (uint32_t)INT32_MAX;
    return op == OP_MAX ? 0xff800000u : 0x7f800000u;  // -inf, +inf
}

// bf16/f16 columns travel as f32 words, so every non-int column folds as f32
__device__ __forceinline__ uint32_t combine(int op, int vt, uint32_t a, uint32_t b) {
    if (is_int(vt)) {
        if (op == OP_SUM) return a + b;  // unsigned add: int32 wraparound
        int32_t x = (int32_t)a, y = (int32_t)b;
        return (uint32_t)(op == OP_MAX ? (y > x ? y : x) : (y < x ? y : x));
    }
    float x = __uint_as_float(a), y = __uint_as_float(b);
    if (op == OP_SUM) return __float_as_uint(x + y);
    return __float_as_uint(op == OP_MAX ? (y > x ? y : x) : (y < x ? y : x));
}

__device__ __forceinline__ uint32_t load_value(const void* base, int vt, int64_t i) {
    switch (vt) {
        case VT_INT32: return (uint32_t)((const int32_t*)base)[i];
        case VT_F32: return __float_as_uint(((const float*)base)[i]);
        case VT_BF16: return __float_as_uint(__bfloat162float(((const __nv_bfloat16*)base)[i]));
        default: return __float_as_uint(__half2float(((const __half*)base)[i]));
    }
}

__device__ __forceinline__ void store_value(void* base, int vt, int64_t i, uint32_t w) {
    switch (vt) {
        case VT_INT32: ((int32_t*)base)[i] = (int32_t)w; break;
        case VT_F32: ((float*)base)[i] = __uint_as_float(w); break;
        case VT_BF16: ((__nv_bfloat16*)base)[i] = __float2bfloat16_rn(__uint_as_float(w)); break;
        default: ((__half*)base)[i] = __float2half_rn(__uint_as_float(w)); break;
    }
}

__device__ __forceinline__ int n_tables(const SegParams& p) {
    return p.n_aggs + (p.with_presence ? 1 : 0);
}

// Key of row r of the input if the row counts (in [r0, r1), unmasked, key in
// range), else -1.
__device__ __forceinline__ int32_t counted_key(const SegParams& p, int64_t r, int64_t r1) {
    if (r >= r1) return -1;
    const int32_t key = p.keys[r];
    if (p.mask != nullptr && p.mask[r] == 0) return -1;
    return (key < 0 || key >= p.num_keys) ? -1 : key;
}

__device__ __forceinline__ void init_table(const SegParams& p, uint32_t* table, int64_t width,
                                           int64_t used, int first, int stride) {
    for (int t = 0; t < n_tables(p); ++t) {
        const uint32_t id = t < p.n_aggs ? identity_word(p.op[t], p.vtype[t]) : 0u;
        for (int64_t k = first; k < used; k += stride) table[t * width + k] = id;
    }
}

// One 32-row step of a warp into its private table of ``width`` keys per
// column: ``key`` is the lane's table index (-1 when its row does not count)
// and ``word(a)`` its value of aggregate a as a 32-bit word.
template <typename Word>
__device__ __forceinline__ void warp_step(const SegParams& p, uint32_t* table, int64_t width,
                                          int32_t key, Word word) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const bool valid = key >= 0;
    const unsigned active = __ballot_sync(FULL, valid);
    if (active == 0u) return;
    // lanes that do not count all carry -1, which no counting lane has
    const unsigned peers = __match_any_sync(FULL, key) & active;
    const bool leader = valid && (peers & ((1u << lane) - 1u)) == 0u;
    // lanes whose key another lane shares: their groups fold in lane order
    const unsigned shared = __ballot_sync(FULL, valid && peers != (1u << lane));
    for (int a = 0; a < p.n_aggs; ++a) {
        const int op = p.op[a], vt = p.vtype[a];
        uint32_t v = valid ? word(a) : identity_word(op, vt);
        if (shared != 0u) {  // warp-uniform: every lane walks the same lanes
            uint32_t acc = identity_word(op, vt);
            for (unsigned todo = shared; todo != 0u; todo &= todo - 1u) {
                const int src = __ffs(todo) - 1;
                const uint32_t x = __shfl_sync(FULL, v, src);
                if ((peers >> src) & 1u) acc = combine(op, vt, acc, x);
            }
            if (peers != (1u << lane)) v = acc;
        }
        if (leader) {
            uint32_t* slot = table + (int64_t)a * width + key;
            *slot = combine(op, vt, *slot, v);
        }
    }
    if (p.with_presence && leader) table[(int64_t)p.n_aggs * width + key] += __popc(peers);
    __syncwarp();  // orders this step's table writes before the next step's reads
}

// Folds the tables of a block's warps, in warp order, for table indices
// [0, used); ``emit(t, k, word)`` receives each result.
template <typename Emit>
__device__ __forceinline__ void fold_block_tables(const SegParams& p, const uint32_t* smem,
                                                  int64_t width, int64_t used, Emit emit) {
    const int n_warps = blockDim.x / 32;
    const int nt = n_tables(p);
    for (int64_t k = threadIdx.x; k < used; k += blockDim.x) {
        for (int t = 0; t < nt; ++t) {
            const bool agg = t < p.n_aggs;
            const int op = agg ? p.op[t] : OP_SUM;
            const int vt = agg ? p.vtype[t] : VT_INT32;
            uint32_t acc = smem[t * width + k];
            for (int w = 1; w < n_warps; ++w)
                acc = combine(op, vt, acc, smem[((int64_t)w * nt + t) * width + k]);
            emit(t, k, acc);
        }
    }
}

__device__ __forceinline__ void emit_output(const SegParams& p, int t, int64_t k, uint32_t acc) {
    if (t < p.n_aggs) store_value(p.out[t], p.vtype[t], k, acc);
    else p.presence[k] = (int32_t)acc;
}

// ---------------------------------------------------------------------------
// Regime 0: small K
// ---------------------------------------------------------------------------

// Every warp reduces its slice of rows into its table in shared memory; the
// block folds its W tables in warp order and writes the result to scratch.
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_accumulate(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31;
    const int gw = blockIdx.x * SEG_WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int64_t K = p.num_keys;
    const int nt = n_tables(p);
    uint32_t* table = smem + (int64_t)(threadIdx.x >> 5) * nt * K;
    init_table(p, table, K, K, lane, 32);
    __syncwarp();
    const int64_t r0 = min(p.n_rows, (int64_t)gw * p.rows_per_warp);
    const int64_t r1 = min(p.n_rows, r0 + p.rows_per_warp);
    for (int64_t base = r0; base < r1; base += 32) {
        const int64_t r = base + lane;
        warp_step(p, table, K, counted_key(p, r, r1),
                  [&](int a) { return load_value(p.vals[a], p.vtype[a], r); });
    }
    __syncthreads();
    uint32_t* scratch = p.scratch + (int64_t)blockIdx.x * nt * K;
    fold_block_tables(p, smem, K, K,
                      [&](int t, int64_t k, uint32_t acc) { scratch[t * K + k] = acc; });
}

// One warp per output cell (column t, key k): lane l folds the partials of
// blocks l, l + 32, ... in order, then a fixed butterfly joins the lanes.
__global__ void seg_combine(const SegParams p) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int64_t K = p.num_keys;
    const int nt = n_tables(p);
    if (cell >= nt * K) return;  // whole warps only
    const int t = (int)(cell / K);
    const int64_t k = cell % K;
    const bool agg = t < p.n_aggs;
    const int op = agg ? p.op[t] : OP_SUM;
    const int vt = agg ? p.vtype[t] : VT_INT32;
    const int n_blocks = p.n_warps / SEG_WARPS_PER_BLOCK;
    uint32_t acc = agg ? identity_word(op, vt) : 0u;
    for (int b = lane; b < n_blocks; b += 32)
        acc = combine(op, vt, acc, p.scratch[((int64_t)b * nt + t) * K + k]);
    for (int d = 16; d > 0; d >>= 1) acc = combine(op, vt, acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) emit_output(p, t, k, acc);
}

// ---------------------------------------------------------------------------
// Regime 1: large K — stable partition by key range, then one block a range
// ---------------------------------------------------------------------------

// Bucket of a counted key, or -1.
__device__ __forceinline__ int32_t bucket_of(const SegParams& p, int32_t key) {
    return key < 0 ? -1 : key / p.keys_per_bucket;
}

// A tile of SEG_TILE_ROWS rows is one block of W warps; warp w takes the
// tile's w-th slice of SEG_TILE_ROWS / W rows, 32 at a time, so walking the
// warps in order walks the tile in row order.
#define SEG_SLICE_ROWS (SEG_TILE_ROWS / SEG_WARPS_PER_BLOCK)

// wcount[w * n_buckets + b] = counted rows of warp w's slice in bucket b.
__device__ void count_slices(const SegParams& p, int32_t* wcount) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int64_t i = threadIdx.x; i < (int64_t)SEG_WARPS_PER_BLOCK * p.n_buckets; i += blockDim.x)
        wcount[i] = 0;
    __syncthreads();
    int32_t* mine = wcount + (int64_t)warp * p.n_buckets;
    const int64_t r0 = min(p.n_rows, (int64_t)blockIdx.x * SEG_TILE_ROWS + warp * SEG_SLICE_ROWS);
    const int64_t r1 = min(p.n_rows, r0 + SEG_SLICE_ROWS);
    for (int64_t base = r0; base < r1; base += 32) {
        const int32_t bucket = bucket_of(p, counted_key(p, base + lane, r1));
        const unsigned active = __ballot_sync(FULL, bucket >= 0);
        if (active == 0u) continue;
        const unsigned peers = __match_any_sync(FULL, bucket) & active;
        if (bucket >= 0 && (peers & ((1u << lane) - 1u)) == 0u) mine[bucket] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
}

// One block a tile: how many of the tile's counted rows fall in each bucket.
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_histogram(const SegParams p) {
    extern __shared__ uint32_t smem[];
    int32_t* wcount = (int32_t*)smem;
    count_slices(p, wcount);
    for (int b = threadIdx.x; b < p.n_buckets; b += blockDim.x) {
        int32_t total = 0;
        for (int w = 0; w < SEG_WARPS_PER_BLOCK; ++w) total += wcount[(int64_t)w * p.n_buckets + b];
        p.counts[(int64_t)blockIdx.x * p.n_buckets + b] = total;
    }
}

// Exclusive scan, in place, of data[0], data[stride], ... data[(n-1)*stride]
// by one whole block (at most 1024 threads); *total receives the sum.
__device__ void block_exclusive_scan(int32_t* data, int64_t n, int64_t stride, int32_t* total) {
    __shared__ int32_t warp_sums[32];
    __shared__ int32_t block_total;
    const unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_warps = blockDim.x / 32;
    const int64_t per = (n + blockDim.x - 1) / blockDim.x;
    const int64_t lo = tid * per, hi = min(n, lo + per);
    int32_t local = 0;
    for (int64_t i = lo; i < hi; ++i) local += data[i * stride];
    int32_t incl = local;
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int32_t v = lane < n_warps ? warp_sums[lane] : 0;
        int32_t vi = v;
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t y = __shfl_up_sync(FULL, vi, d);
            if (lane >= d) vi += y;
        }
        if (lane < n_warps) warp_sums[lane] = vi - v;
        if (lane == 31) block_total = vi;
    }
    __syncthreads();
    int32_t run = warp_sums[warp] + incl - local;
    for (int64_t i = lo; i < hi; ++i) {
        const int32_t c = data[i * stride];
        data[i * stride] = run;
        run += c;
    }
    if (tid == 0) *total = block_total;
    __syncthreads();
}

// One block a bucket: offsets of the bucket's rows within it, tile by tile;
// the bucket's size goes to bucket_start[b].
__global__ void seg_scan_tiles(const SegParams p) {
    const int b = blockIdx.x;
    block_exclusive_scan(p.counts + b, p.n_tiles, p.n_buckets, p.bucket_start + b);
}

// One block: where each bucket starts; bucket_start[n_buckets] = all rows.
__global__ void seg_scan_buckets(const SegParams p) {
    block_exclusive_scan(p.bucket_start, p.n_buckets, 1, p.bucket_start + p.n_buckets);
}

// One block a tile: the tile's counted rows are ordered by bucket in shared
// memory (row order kept within a bucket), then written out so that each
// bucket's run of the tile lands contiguously after the runs of earlier
// tiles — a stable partition, written in coalesced runs.
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_scatter(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int R = p.n_buckets;
    int32_t* wcount = (int32_t*)smem;                        // W * R
    int32_t* local = wcount + (int64_t)SEG_WARPS_PER_BLOCK * R;  // R
    int32_t* delta = local + R;                              // R
    int32_t* n_counted = delta + R;                          // 1
    uint16_t* order = (uint16_t*)(n_counted + 1);             // SEG_TILE_ROWS
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t tile0 = (int64_t)blockIdx.x * SEG_TILE_ROWS;

    count_slices(p, wcount);
    // warp w's first slot in bucket b: the bucket's start in the tile plus
    // the rows of bucket b in warps before w
    for (int b = threadIdx.x; b < R; b += blockDim.x) {
        int32_t run = 0;
        for (int w = 0; w < SEG_WARPS_PER_BLOCK; ++w) {
            const int32_t c = wcount[(int64_t)w * R + b];
            wcount[(int64_t)w * R + b] = run;
            run += c;
        }
        local[b] = run;
    }
    __syncthreads();
    block_exclusive_scan(local, R, 1, n_counted);
    for (int b = threadIdx.x; b < R; b += blockDim.x) {
        delta[b] = p.bucket_start[b] + p.counts[(int64_t)blockIdx.x * R + b] - local[b];
        for (int w = 0; w < SEG_WARPS_PER_BLOCK; ++w) wcount[(int64_t)w * R + b] += local[b];
    }
    __syncthreads();

    int32_t* mine = wcount + (int64_t)warp * R;
    const int64_t r0 = min(p.n_rows, tile0 + warp * SEG_SLICE_ROWS);
    const int64_t r1 = min(p.n_rows, r0 + SEG_SLICE_ROWS);
    for (int64_t base = r0; base < r1; base += 32) {
        const int64_t r = base + lane;
        const int32_t bucket = bucket_of(p, counted_key(p, r, r1));
        const unsigned active = __ballot_sync(FULL, bucket >= 0);
        if (active == 0u) continue;
        const unsigned peers = __match_any_sync(FULL, bucket) & active;
        const unsigned before = peers & ((1u << lane) - 1u);
        if (bucket >= 0) order[mine[bucket] + __popc(before)] = (uint16_t)(r - tile0);
        __syncwarp();
        if (bucket >= 0 && before == 0u) mine[bucket] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    for (int64_t i = threadIdx.x; i < *n_counted; i += blockDim.x) {
        const int64_t r = tile0 + order[i];
        const int32_t key = p.keys[r];
        const int64_t pos = delta[key / p.keys_per_bucket] + i;
        p.part_keys[pos] = key;
        for (int a = 0; a < p.n_aggs; ++a)
            p.part_vals[(int64_t)a * p.n_rows + pos] = load_value(p.vals[a], p.vtype[a], r);
    }
}

// One block a bucket: its warps (reduce_warps of them) reduce contiguous
// slices of the bucket's rows into shared-memory tables, folded in warp
// order into the outputs of the bucket's key range.
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_reduce_buckets(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x / 32;
    const int64_t width = p.keys_per_bucket;
    const int64_t k0 = (int64_t)blockIdx.x * width;
    const int64_t used = min(width, (int64_t)p.num_keys - k0);
    const int64_t start = p.bucket_start[blockIdx.x], end = p.bucket_start[blockIdx.x + 1];
    const int64_t slice = ((end - start + n_warps - 1) / n_warps + 31) / 32 * 32;
    uint32_t* table = smem + (int64_t)warp * n_tables(p) * width;
    init_table(p, table, width, used, lane, 32);
    __syncwarp();
    const int64_t r0 = start + warp * slice;
    const int64_t r1 = min(end, r0 + slice);
    for (int64_t base = r0; base < r1; base += 32) {
        const int64_t r = base + lane;
        const int32_t key = r < r1 ? (int32_t)(p.part_keys[r] - k0) : -1;
        warp_step(p, table, width, key,
                  [&](int a) { return p.part_vals[(int64_t)a * p.n_rows + r]; });
    }
    __syncthreads();
    fold_block_tables(p, smem, width, used,
                      [&](int t, int64_t k, uint32_t acc) { emit_output(p, t, k0 + k, acc); });
}

// ---------------------------------------------------------------------------
// Regimes 2 and 3: no float sum in the group
// ---------------------------------------------------------------------------

#define SEG_PART_THREADS 512
#define SEG_SCATTER_THREADS 1024   // threads of a scatter block: two fill an SM
#define SEG_PART_TILE 8192     // rows of a scatter block (its places are 16-bit)
#define SEG_NO_BUCKET 0xffffu

// Columns that fold through the order-preserving map: float min and max.
__device__ __forceinline__ bool mapped(int op, int vt) { return op != OP_SUM && !is_int(vt); }

// An involution on the bits of an f32 that orders them as int32.
__device__ __forceinline__ uint32_t flip32(uint32_t w) {
    return (int32_t)w >= 0 ? w : w ^ 0x7fffffffu;
}
__device__ __forceinline__ uint16_t flip16(uint16_t h) {
    return (int16_t)h >= 0 ? h : (uint16_t)(h ^ 0x7fffu);
}

// The table word of a value word (an int32, or an f32 for every float type):
// float min/max mapped, a NaN past the end its op moves towards.
__device__ __forceinline__ uint32_t table_word(int op, int vt, uint32_t w) {
    if (!mapped(op, vt)) return w;
    if (isnan(__uint_as_float(w))) return op == OP_MAX ? 0x7fffffffu : 0x80000000u;
    return flip32(w);
}

__device__ __forceinline__ uint32_t table_identity(int op, int vt) {
    return mapped(op, vt) ? flip32(identity_word(op, vt)) : identity_word(op, vt);
}

__device__ __forceinline__ uint32_t table_atomic(uint32_t* slot, int op, uint32_t w) {
    if (op == OP_SUM) return atomicAdd(slot, w);  // int32 sums only here: wraps
    if (op == OP_MAX) return (uint32_t)atomicMax((int*)slot, (int)w);
    return (uint32_t)atomicMin((int*)slot, (int)w);
}

// Rows a lane loads before it folds or places them, so that their loads are
// in flight together.
#define SEG_ROW_STEP 4

// Keys of rows r0 + j * stride (j < STEP) where the row counts, else -1;
// every load is issued before any is used.
template <int STEP>
__device__ __forceinline__ void counted_keys(const SegParams& p, int64_t r0, int64_t stride, int32_t (&key)[STEP]) {
    uint8_t m[STEP];
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
        const int64_t r = r0 + j * stride;
        const bool in = r < p.n_rows;
        key[j] = in ? p.keys[r] : -1;
        m[j] = p.mask != nullptr && in ? p.mask[r] : (uint8_t)1;
    }
#pragma unroll
    for (int j = 0; j < STEP; ++j)
        if (m[j] == 0 || key[j] < 0 || key[j] >= p.num_keys) key[j] = -1;
}

// Table words of aggregate a at rows row[j] (those with row[j] < 0 read
// nothing): the type is switched on once for the STEP loads.
template <int STEP>
__device__ __forceinline__ void table_words(const SegParams& p, int a, const int64_t (&row)[STEP],
                                            uint32_t (&w)[STEP]) {
    const int vt = p.vtype[a], op = p.op[a];
    const void* base = p.vals[a];
#pragma unroll
    for (int j = 0; j < STEP; ++j) w[j] = 0u;
    switch (vt) {
        case VT_INT32:
#pragma unroll
            for (int j = 0; j < STEP; ++j) if (row[j] >= 0) w[j] = (uint32_t)((const int32_t*)base)[row[j]];
            break;
        case VT_F32:
#pragma unroll
            for (int j = 0; j < STEP; ++j) if (row[j] >= 0) w[j] = __float_as_uint(((const float*)base)[row[j]]);
            break;
        case VT_BF16:
#pragma unroll
            for (int j = 0; j < STEP; ++j)
                if (row[j] >= 0) w[j] = __float_as_uint(__bfloat162float(((const __nv_bfloat16*)base)[row[j]]));
            break;
        default:
#pragma unroll
            for (int j = 0; j < STEP; ++j)
                if (row[j] >= 0) w[j] = __float_as_uint(__half2float(((const __half*)base)[row[j]]));
            break;
    }
#pragma unroll
    for (int j = 0; j < STEP; ++j) w[j] = table_word(op, vt, w[j]);
}

// Fills a block's tables of ``used`` keys (``width`` apart) with the mapped
// identities of regimes 2 and 3.
__device__ __forceinline__ void init_mapped_tables(const SegParams& p, uint32_t* table, int width, int used) {
    for (int t = 0; t < n_tables(p); ++t) {
        const uint32_t id = t < p.n_aggs ? table_identity(p.op[t], p.vtype[t]) : 0u;
        for (int k = threadIdx.x; k < used; k += blockDim.x) table[t * width + k] = id;
    }
}

// STEP rows a lane, aggregate by aggregate: ``key[j]`` is the key of row j
// (-1 when it does not count), ``words(a, w)`` fills w with aggregate a's
// table words of the STEP rows (their loads in flight together), and
// ``fold(t, key, w)`` folds word w into column t at key (t = n_aggs:
// presence, w a count).  Lanes of one warp that hit one address are
// serialised by the hardware; folding them by warp reductions first was
// measured slower, even with every lane on one key.  NA is the aggregate
// count, or -1 for one read at run time.
template <int NA, int STEP, typename Words, typename Fold>
__device__ __forceinline__ void fold_rows(const SegParams& p, const int32_t (&key)[STEP], Words words, Fold fold) {
    const int na = NA >= 0 ? NA : p.n_aggs;
    auto column = [&](int a) {
        uint32_t w[STEP];
        words(a, w);
#pragma unroll
        for (int j = 0; j < STEP; ++j)
            if (key[j] >= 0) fold(a, key[j], w[j]);
    };
    if constexpr (NA >= 0) {
#pragma unroll
        for (int a = 0; a < NA; ++a) column(a);
    } else {
        for (int a = 0; a < na; ++a) column(a);
    }
    if (p.with_presence) {
#pragma unroll
        for (int j = 0; j < STEP; ++j)
            if (key[j] >= 0) fold(na, key[j], 1u);
    }
}

// Regime 2: fills the outputs with their identities (mapped where the column
// is mapped; 16-bit columns get the 16-bit map of their own identity).
__global__ void seg_direct_init(const SegParams p) {
    const int64_t K = p.num_keys;
    const int nt = n_tables(p);
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nt * K;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int t = (int)(i / K);
        const int64_t k = i - t * K;
        if (t == p.n_aggs) { p.presence[k] = 0; continue; }
        const int op = p.op[t], vt = p.vtype[t];
        if (vt == VT_BF16 || vt == VT_F16) {
            // only min/max reach here with a 16-bit column: +-inf in either type
            const uint16_t inf = vt == VT_BF16 ? 0x7f80u : 0x7c00u;
            ((uint16_t*)p.out[t])[k] = flip16(op == OP_MAX ? (uint16_t)(inf | 0x8000u) : inf);
        } else {
            ((uint32_t*)p.out[t])[k] = table_identity(op, vt);
        }
    }
}

// Max or min of a 16-bit mapped value into a 16-bit output, by a CAS on the
// aligned word that holds it (the other half is written back unchanged).
__device__ __forceinline__ void atomic_minmax16(uint16_t* addr, int op, uint16_t h) {
    uint32_t* word = (uint32_t*)((uintptr_t)addr & ~(uintptr_t)3);
    const int shift = (int)((uintptr_t)addr & 2) * 8;
    uint32_t old = *word, assumed;
    do {
        assumed = old;
        const int16_t cur = (int16_t)(uint16_t)(assumed >> shift);
        const int16_t want = op == OP_MAX ? max(cur, (int16_t)h) : min(cur, (int16_t)h);
        if (want == cur) return;
        const uint32_t next = (assumed & ~(0xffffu << shift)) | ((uint32_t)(uint16_t)want << shift);
        old = atomicCAS(word, assumed, next);
    } while (old != assumed);
}

// Regime 2: a table word folded into the outputs with a global atomic.
__device__ __forceinline__ void fold_output(const SegParams& p, int t, int64_t k, uint32_t w) {
    if (t == p.n_aggs) {
        atomicAdd((uint32_t*)p.presence + k, w);
        return;
    }
    const int op = p.op[t], vt = p.vtype[t];
    if (vt == VT_BF16 || vt == VT_F16) {
        // the f32 word holds a value of the column's own type: exact
        const float f = __uint_as_float(flip32(w));
        const uint16_t h = vt == VT_BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(f))
                                         : __half_as_ushort(__float2half_rn(f));
        const uint16_t m = isnan(f) ? (op == OP_MAX ? 0x7fffu : 0x8000u) : flip16(h);
        atomic_minmax16((uint16_t*)p.out[t] + k, op, m);
    } else {
        table_atomic((uint32_t*)p.out[t] + k, op, w);
    }
}

// Regime 2: every block folds a grid-stride share of the rows, into one
// table of all K keys a column in shared memory when atomic_smem (then
// added into the outputs), else straight into the outputs.
template <int NA>
__global__ void __launch_bounds__(256)
seg_direct_rows(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int K = p.num_keys;
    const int nt = n_tables(p);
    const bool in_smem = p.atomic_smem != 0;
    if (in_smem) init_mapped_tables(p, smem, K, K);
    __syncthreads();
    const int na = NA >= 0 ? NA : p.n_aggs;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    auto fold = [&](int t, int key, uint32_t w) {
        if (in_smem) {
            if (t == na) atomicAdd(smem + t * K + key, w);
            else table_atomic(smem + t * K + key, p.op[t], w);
        } else {
            fold_output(p, t, key, w);
        }
    };
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < p.n_rows; base += stride * SEG_ROW_STEP) {
        int32_t key[SEG_ROW_STEP];
        int64_t row[SEG_ROW_STEP];
        counted_keys<SEG_ROW_STEP>(p, base + threadIdx.x, stride, key);
#pragma unroll
        for (int j = 0; j < SEG_ROW_STEP; ++j) row[j] = key[j] >= 0 ? base + j * stride + threadIdx.x : -1;
        fold_rows<NA>(p, key, [&](int a, uint32_t (&w)[SEG_ROW_STEP]) { table_words<SEG_ROW_STEP>(p, a, row, w); },
                      fold);
    }
    if (!in_smem) return;
    __syncthreads();
    for (int i = threadIdx.x; i < nt * K; i += blockDim.x) {
        const int t = i / K, k = i - t * K;
        const uint32_t w = smem[i];
        const uint32_t id = t == p.n_aggs ? 0u : table_identity(p.op[t], p.vtype[t]);
        if (w != id) fold_output(p, t, k, w);  // else nothing to add
    }
}

// Regime 2: the mapped columns unmapped in place.
__global__ void seg_direct_finish(const SegParams p) {
    const int64_t K = p.num_keys;
    for (int t = 0; t < p.n_aggs; ++t) {
        const int op = p.op[t], vt = p.vtype[t];
        if (!mapped(op, vt)) continue;
        for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < K;
             k += (int64_t)gridDim.x * blockDim.x) {
            if (vt == VT_F32) ((uint32_t*)p.out[t])[k] = flip32(((uint32_t*)p.out[t])[k]);
            else ((uint16_t*)p.out[t])[k] = flip16(((uint16_t*)p.out[t])[k]);
        }
    }
}

// Adds one to count[b] where b >= 0 and returns the count before it: the
// row's slot among its range's rows.
__device__ __forceinline__ int32_t claim(int32_t* count, int32_t b) {
    return b >= 0 ? atomicAdd(count + b, 1) : 0;
}

// Regime 3, pass 1: rows per key range, counted in shared memory and added
// to part_ranges[0, R) with one global atomic a range and block; the last
// block to finish turns the counts into where each range begins
// (part_ranges[0, R], the last entry all counted rows) and sets each
// range's cursor (part_ranges[R + 1, 2 R + 1)) to its beginning.
__global__ void __launch_bounds__(SEG_PART_THREADS)
seg_part_histogram(const SegParams p) {
    extern __shared__ uint32_t smem[];
    int32_t* count = (int32_t*)smem;
    __shared__ int32_t total;
    __shared__ bool last;
    const int R = p.n_buckets;
    for (int b = threadIdx.x; b < R; b += blockDim.x) count[b] = 0;
    __syncthreads();
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < p.n_rows; base += stride * SEG_ROW_STEP) {
        int32_t key[SEG_ROW_STEP];
        counted_keys<SEG_ROW_STEP>(p, base + threadIdx.x, stride, key);
#pragma unroll
        for (int j = 0; j < SEG_ROW_STEP; ++j) claim(count, key[j] < 0 ? -1 : key[j] >> p.bucket_shift);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < R; b += blockDim.x)
        if (count[b] != 0) atomicAdd(p.part_ranges + b, count[b]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(p.part_ranges + 2 * R + 1, 1) == (int32_t)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int b = threadIdx.x; b < R; b += blockDim.x) count[b] = ((volatile int32_t*)p.part_ranges)[b];
    __syncthreads();
    block_exclusive_scan(count, R, 1, &total);
    for (int b = threadIdx.x; b < R; b += blockDim.x) {
        p.part_ranges[b] = count[b];
        p.part_ranges[R + 1 + b] = count[b];
    }
    if (threadIdx.x == 0) p.part_ranges[R] = total;
}

// Regime 3, pass 2: one block a tile of SEG_PART_TILE rows.  Each counted
// row takes a slot in its range's run of the tile; the runs are laid out by
// range in shared memory (row order within a run is not kept: nothing that
// folds here depends on it); each run is reserved at its range's cursor,
// and the tile writes its key offsets, then each value column, run by run:
// neighbouring threads to neighbouring places.  Values are read in row
// order and staged in run order in shared memory, one column at a time.
__global__ void __launch_bounds__(SEG_SCATTER_THREADS)
seg_part_scatter(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int R = p.n_buckets;
    int32_t* run = (int32_t*)smem;                   // R: the tile's rows a range, then where its run goes
    int32_t* local = run + R;                        // R: where each run begins within the tile
    uint32_t* staged = (uint32_t*)(local + R);       // SEG_PART_TILE: a column in run order; before
    uint16_t* t_range = (uint16_t*)staged;           //   that, each row's range
    uint16_t* t_off = t_range + SEG_PART_TILE;        //   and key offset
    uint16_t* t_place = t_off + SEG_PART_TILE;        // SEG_PART_TILE: a row's slot, then place in the tile
    uint16_t* s_range = t_place + SEG_PART_TILE;      // SEG_PART_TILE: range of each place
    uint16_t* s_off = s_range + SEG_PART_TILE;        // SEG_PART_TILE: key offset of each place
    __shared__ int32_t n_counted;
    const int64_t tile0 = (int64_t)blockIdx.x * SEG_PART_TILE;
    const int rows = (int)min((int64_t)SEG_PART_TILE, p.n_rows - tile0);
    for (int b = threadIdx.x; b < R; b += blockDim.x) run[b] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < rows; i0 += blockDim.x * SEG_ROW_STEP) {
        int32_t key[SEG_ROW_STEP];
        counted_keys<SEG_ROW_STEP>(p, tile0 + i0 + threadIdx.x, blockDim.x, key);  // rows past the tile are
#pragma unroll                                                                  // past n_rows or not read
        for (int j = 0; j < SEG_ROW_STEP; ++j) {
            const int i = i0 + j * blockDim.x + threadIdx.x;
            const int32_t b = key[j] < 0 || i >= rows ? -1 : key[j] >> p.bucket_shift;
            const int32_t slot = claim(run, b);
            if (i < rows) {
                t_range[i] = b < 0 ? (uint16_t)SEG_NO_BUCKET : (uint16_t)b;
                t_off[i] = (uint16_t)(key[j] & ((1 << p.bucket_shift) - 1));
                t_place[i] = (uint16_t)slot;
            }
        }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < R; b += blockDim.x) local[b] = run[b];
    __syncthreads();
    block_exclusive_scan(local, R, 1, &n_counted);
    for (int b = threadIdx.x; b < R; b += blockDim.x) {
        const int32_t c = run[b];
        run[b] = c != 0 ? atomicAdd(p.part_ranges + R + 1 + b, c) - local[b] : 0;
    }
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        const uint32_t b = t_range[i];
        if (b == SEG_NO_BUCKET) {
            t_place[i] = (uint16_t)SEG_NO_BUCKET;
            continue;
        }
        const int q = local[b] + t_place[i];
        t_place[i] = (uint16_t)q;
        s_range[q] = (uint16_t)b;
        s_off[q] = t_off[i];
    }
    __syncthreads();
    const int placed = n_counted;
    for (int q = threadIdx.x; q < placed; q += blockDim.x) p.part_off[run[s_range[q]] + q] = s_off[q];
    for (int a = 0; a < p.n_aggs; ++a) {
        for (int i0 = 0; i0 < rows; i0 += blockDim.x * SEG_ROW_STEP) {
            int64_t row[SEG_ROW_STEP];
            int place[SEG_ROW_STEP];
#pragma unroll
            for (int j = 0; j < SEG_ROW_STEP; ++j) {
                const int i = i0 + j * blockDim.x + threadIdx.x;
                place[j] = i < rows ? t_place[i] : (int)SEG_NO_BUCKET;
                row[j] = place[j] != (int)SEG_NO_BUCKET ? tile0 + i : -1;
            }
            uint32_t w[SEG_ROW_STEP];
            table_words<SEG_ROW_STEP>(p, a, row, w);
#pragma unroll
            for (int j = 0; j < SEG_ROW_STEP; ++j)
                if (row[j] >= 0) staged[place[j]] = w[j];
        }
        __syncthreads();
        for (int q = threadIdx.x; q < placed; q += blockDim.x)
            p.part_vals[(int64_t)a * p.n_rows + run[s_range[q]] + q] = staged[q];
        __syncthreads();
    }
}

// Regime 3, pass 3: one block a key range folds the range's rows into one
// table a column in shared memory and writes its slice of every output.
template <int NA>
__global__ void __launch_bounds__(SEG_PART_THREADS)
seg_part_fold(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int width = 1 << p.bucket_shift;
    const int64_t k0 = (int64_t)b << p.bucket_shift;
    const int used = (int)min((int64_t)width, (int64_t)p.num_keys - k0);
    init_mapped_tables(p, smem, width, used);
    __syncthreads();
    // no rows: the histogram never ran
    const int64_t lo = p.n_rows > 0 ? p.part_ranges[b] : 0, hi = p.n_rows > 0 ? p.part_ranges[b + 1] : 0;
    const int na = NA >= 0 ? NA : p.n_aggs;
    auto fold = [&](int t, int key, uint32_t w) {
        if (t == na) atomicAdd(smem + t * width + key, w);
        else table_atomic(smem + t * width + key, p.op[t], w);
    };
    for (int64_t base = lo; base < hi; base += (int64_t)blockDim.x * SEG_ROW_STEP) {
        int32_t key[SEG_ROW_STEP];
#pragma unroll
        for (int j = 0; j < SEG_ROW_STEP; ++j) {
            const int64_t i = base + j * blockDim.x + threadIdx.x;
            key[j] = i < hi ? (int32_t)p.part_off[i] : -1;
        }
        fold_rows<NA>(p, key, [&](int a, uint32_t (&w)[SEG_ROW_STEP]) {
#pragma unroll
            for (int j = 0; j < SEG_ROW_STEP; ++j) {
                const int64_t i = base + j * blockDim.x + threadIdx.x;
                w[j] = i < hi ? p.part_vals[(int64_t)a * p.n_rows + i] : 0u;
            }
        }, fold);
    }
    __syncthreads();
    const int nt = n_tables(p);
    for (int t = 0; t < nt; ++t) {
        const bool agg = t < p.n_aggs;
        for (int k = threadIdx.x; k < used; k += blockDim.x) {
            const uint32_t w = smem[t * width + k];
            if (!agg) p.presence[k0 + k] = (int32_t)w;
            else store_value(p.out[t], p.vtype[t], k0 + k, mapped(p.op[t], p.vtype[t]) ? flip32(w) : w);
        }
    }
}

// ---------------------------------------------------------------------------

extern "C" int segreduce_smem_limit(int dev) {
    int bytes = 0;
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Asks for the largest shared-memory carveout, so that as many blocks of a
// kernel that needs much of it run on an SM as its shared memory allows.
template <typename Kernel>
static cudaError_t prefer_smem(Kernel kernel) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

#define SEG_CHECK(call)                        \
    do {                                       \
        cudaError_t e_ = (call);               \
        if (e_ != cudaSuccess) return (int)e_; \
    } while (0)

// The row kernels of regimes 2 and 3 are built for 0, 1 and 2 aggregates
// (their loads unrolled over the aggregates) and for any count read at run
// time; these pick the instance and launch it.
struct DirectRows {
    template <int NA> static auto kernel() { return seg_direct_rows<NA>; }
};
struct PartFold {
    template <int NA> static auto kernel() { return seg_part_fold<NA>; }
};

template <int NA, typename Which>
static cudaError_t launch_instance(const SegParams& p, cudaStream_t s, int grid, int threads, size_t smem) {
    auto kernel = Which::template kernel<NA>();
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess) e = prefer_smem(kernel);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, s>>>(p);
    return cudaGetLastError();
}

template <typename Which>
static cudaError_t launch_by_aggs(const SegParams& p, cudaStream_t s, int grid, int threads, size_t smem,
                                  Which) {
    switch (p.n_aggs) {
        case 0: return launch_instance<0, Which>(p, s, grid, threads, smem);
        case 1: return launch_instance<1, Which>(p, s, grid, threads, smem);
        case 2: return launch_instance<2, Which>(p, s, grid, threads, smem);
        default: return launch_instance<-1, Which>(p, s, grid, threads, smem);
    }
}

// Launches the passes of the chosen regime on ``stream``; allocates nothing
// and does not synchronise.  Returns the first cudaError_t met (0 on
// success).
extern "C" int segreduce_launch(const SegParams* hp, void* stream) {
    const SegParams p = *hp;
    cudaStream_t s = (cudaStream_t)stream;
    // this library carries its own runtime, so name the device explicitly
    SEG_CHECK(cudaSetDevice(p.device));
    const int nt = p.n_aggs + (p.with_presence ? 1 : 0);
    const int threads = SEG_WARPS_PER_BLOCK * 32;
    const int64_t cells = (int64_t)nt * p.num_keys;
    if (p.regime == 0) {
        const size_t smem = (size_t)SEG_WARPS_PER_BLOCK * nt * p.num_keys * sizeof(uint32_t);
        SEG_CHECK(allow_smem(seg_accumulate, smem));
        seg_accumulate<<<p.n_warps / SEG_WARPS_PER_BLOCK, threads, smem, s>>>(p);
        SEG_CHECK(cudaGetLastError());
        seg_combine<<<(int)((cells * 32 + 255) / 256), 256, 0, s>>>(p);
        return (int)cudaGetLastError();
    }
    if (p.regime == 2) {
        const int grid = (int)min((cells + 255) / 256, (int64_t)65535);
        const size_t smem = p.atomic_smem ? (size_t)cells * sizeof(uint32_t) : 0;
        seg_direct_init<<<grid, 256, 0, s>>>(p);
        SEG_CHECK(cudaGetLastError());
        SEG_CHECK(launch_by_aggs(p, s, p.n_blocks, 256, smem, DirectRows{}));
        bool any_mapped = false;
        for (int a = 0; a < p.n_aggs; ++a) any_mapped |= p.op[a] != OP_SUM && p.vtype[a] != VT_INT32;
        if (!any_mapped) return 0;
        seg_direct_finish<<<(int)min(((int64_t)p.num_keys + 255) / 256, (int64_t)65535), 256, 0, s>>>(p);
        return (int)cudaGetLastError();
    }
    if (p.regime == 3) {
        const int R = p.n_buckets;
        const size_t hist_smem = (size_t)R * sizeof(int32_t);
        const size_t scatter_smem = 2 * hist_smem + 5 * (size_t)SEG_PART_TILE * sizeof(uint16_t);
        const size_t fold_smem = (size_t)nt * sizeof(uint32_t) << p.bucket_shift;
        SEG_CHECK(allow_smem(seg_part_histogram, hist_smem));
        SEG_CHECK(allow_smem(seg_part_scatter, scatter_smem));
        SEG_CHECK(prefer_smem(seg_part_scatter));
        if (p.n_rows > 0) {
            SEG_CHECK(cudaMemsetAsync(p.part_ranges, 0, (2 * (size_t)R + 2) * sizeof(int32_t), s));
            seg_part_histogram<<<p.n_blocks, SEG_PART_THREADS, hist_smem, s>>>(p);
            SEG_CHECK(cudaGetLastError());
            seg_part_scatter<<<p.n_tiles, SEG_SCATTER_THREADS, scatter_smem, s>>>(p);
            SEG_CHECK(cudaGetLastError());
        }
        return (int)launch_by_aggs(p, s, R, SEG_PART_THREADS, fold_smem, PartFold{});
    }
    const size_t hist_smem = (size_t)SEG_WARPS_PER_BLOCK * p.n_buckets * sizeof(int32_t);
    const size_t scatter_smem = hist_smem + (2 * (size_t)p.n_buckets + 1) * sizeof(int32_t)
                                + SEG_TILE_ROWS * sizeof(uint16_t);
    const size_t table_smem = (size_t)p.reduce_warps * nt * p.keys_per_bucket * sizeof(uint32_t);
    SEG_CHECK(allow_smem(seg_histogram, hist_smem));
    SEG_CHECK(allow_smem(seg_scatter, scatter_smem));
    SEG_CHECK(allow_smem(seg_reduce_buckets, table_smem));
    seg_histogram<<<p.n_tiles, threads, hist_smem, s>>>(p);
    SEG_CHECK(cudaGetLastError());
    seg_scan_tiles<<<p.n_buckets, SEG_SCAN_THREADS, 0, s>>>(p);
    SEG_CHECK(cudaGetLastError());
    seg_scan_buckets<<<1, SEG_SCAN_THREADS, 0, s>>>(p);
    SEG_CHECK(cudaGetLastError());
    seg_scatter<<<p.n_tiles, threads, scatter_smem, s>>>(p);
    SEG_CHECK(cudaGetLastError());
    seg_reduce_buckets<<<p.n_buckets, p.reduce_warps * 32, table_smem, s>>>(p);
    return (int)cudaGetLastError();
}
