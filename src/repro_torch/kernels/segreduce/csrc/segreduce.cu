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
// outside [0, K) are dropped, as XLA's segment ops drop them.  Float max
// and min are IEEE 754-2019's maximum and minimum: a NaN wins (as in the
// reference's jnp.maximum/minimum and in torch.maximum/minimum), and -0.0 is
// below +0.0, so no order of the rows changes their bits (a NaN's payload
// aside).
//
// Bound: bytes.  The card must read every row once and write every output
// once: N * (4 key + 1 mask + sum of value bytes) + K * (A + 1) * 4 bytes,
// over 3.35 TB/s on an H100 SXM.  The arithmetic, one add or compare per
// row and aggregate, is far below any peak rate.
//
// Design, and what it does about that bound:
//   * Determinism.  Two runs on one input give bit-identical results, also
//     on two streams at once and when replayed from a CUDA graph.  Float
//     sums are never folded by atomics, not even in shared memory: a warp
//     walks rows 32 at a time in a fixed order; within a step, the lanes
//     holding one key (__match_any_sync) are folded by warp shuffles over a
//     fixed tree of their ranks among them, and the lowest of them alone
//     updates the warp's private table; tables are then combined in a fixed
//     order.  The order of every float addition is set by the shapes and
//     the keys, never by scheduling.
//   * Small K with a float sum (regime 0).  When W per-warp tables of
//     K * (A + presence) words fit in the 227 KB of shared memory a block
//     may use, each warp reduces a contiguous slice of the rows into its
//     table there, the block folds its W tables in warp order into global
//     scratch, and a second kernel folds the blocks' tables, one warp per
//     output cell.  The rows are read once; the scratch is small because K is.
//   * Large K with a float sum (regime 1).  The key space is cut into R
//     ranges of 2^shift keys whose W per-warp tables fit in shared memory,
//     and the counted rows are partitioned by range, so that one block holds
//     the tables of one range.  What bounds it is reading the keys and the
//     mask, 5 bytes of every row (at TPC-H Q15 the mask keeps 3.6% of the
//     rows, and only those rows' values and partition words move), so each
//     pass reads them at most once and a call twice; three launches:
//     - histogram, one block SEG_HIST_TILES tiles of SEG_ORD_TILE rows, a
//       thread's 16 rows in 16-byte loads, the next tile's in flight while
//       one is counted: rows a range counted by shared-memory integer
//       atomics (a thread adds a run of one range at once) and written as
//       the tile's leaf of a prefix tree over the tiles, 32 children a node;
//       the last block to finish a node's children (a counter) turns their
//       counts into exclusive prefixes in place and counts the node in at
//       its parent, and the last block of all turns the root's totals into
//       where each range starts and cuts each range into pieces of at most
//       piece_rows rows.  Every prefix is fixed by the counts, and no block
//       waits on another.  (A decoupled look-back over the tiles was tried
//       first: with every tile's count published, a tile still walked back
//       over the tiles not yet done with theirs, ~3.6 us a 32-tile window,
//       and the scatter took 1.06 ms at Q15; scripts/segreduce_shapes.py.)
//     - scatter, one block a tile: it loads its keys and mask once, into
//       registers, with where each range's rows of the tile go (the range's
//       start plus the tile's ancestors' prefixes); each warp lists its
//       counted rows and loads their values under a predicate, so that
//       they arrive while the listed rows are ranked by range (a warp match
//       a 32 of them, then the warp's counts a range); the tile's rows are
//       laid out by range in shared memory and written, each one's 16-bit
//       key offset and one word a value column, in coalesced runs.  The
//       scatter is bound by its instructions and barriers a tile, not its
//       bytes: its loops stop at a warp's listed rows.
//     - fold, pieces taken in the order of a ticket: a piece folds its rows
//       into per-warp tables (as many warps as it has SEG_WARP_ROWS rows, a
//       warp's next loads in flight while it folds) and the block folds
//       those in warp order; a range of one piece writes its slice of the
//       outputs, and the pieces of a longer range are joined by a fixed
//       binary tree over their indices, each node by the later of its two
//       children to finish (a counter), the root writing the slice.  No
//       block folds more than piece_rows rows, whatever the key skew.
//     Where N times R is at most kernel.py's SMALL_READS the call is one
//     launch instead: one block a range reads every row (from L2 after the
//     first block), folds its own keys and writes its slice of every
//     output; no scratch.  The counters are the launch's own scratch, zeroed
//     by a captured memset, so two launches on two streams, or two replays
//     of a graph, share nothing.  Float sums add in the order (range, piece
//     tree, warp, row step, key's lanes' rank tree), fixed by the keys.
//   * No float sum (regimes 2 and 3).  Integer sums (which wrap), min, max
//     and presence give the same bits in any order, so atomics are
//     deterministic too, and rows may be moved in any order.  Float min/max
//     fold as int32 through an order-preserving map of their bits (-0.0
//     below +0.0; a NaN is sent past both ends, so that it wins), unmapped
//     when written out.  Int32 columns and presence need no map: the
//     table's bits are the output's, so there is no scratch table.  Every pass loads SEG_ROW_STEP rows a thread
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
// Rows a lane loads before it folds or places them (regime 1: 32-row steps a
// warp loads before it folds them), so that their loads are in flight
// together.
#define SEG_ROW_STEP 4

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
    int32_t* counts;                  // unused since regime 1's redesign (an earlier build reads it)
    int32_t* bucket_start;            // unused since regime 1's redesign
    int32_t* part_keys;               // unused since regime 1's redesign
    uint32_t* part_vals;              // regimes 1 and 3: n_aggs * n_rows words
    int64_t n_rows;
    int64_t rows_per_warp;            // regime 0; a multiple of 32
    int32_t num_keys;
    int32_t n_aggs;
    int32_t with_presence;
    int32_t n_warps;                  // regime 0; a multiple of W
    int32_t regime;
    int32_t device;
    int32_t n_buckets;                // regimes 1 and 3: key ranges
    int32_t keys_per_bucket;          // regimes 1 and 3: 1 << bucket_shift
    int32_t n_tiles;                  // regimes 1 and 3: tiles of the histogram and scatter
    int32_t reduce_warps;             // regime 1: warps of a fold block
    int32_t n_blocks;                 // regime 1: grid of the fold; 2: of the row pass; 3: of the histogram
    int32_t atomic_smem;              // regime 2: per-block tables in shared memory
    int32_t vtype[SEG_MAX_AGGS];
    int32_t op[SEG_MAX_AGGS];
    // Fields added after the ones above, which keep their order, so that an
    // earlier build of this source reads the same struct.
    uint16_t* part_off;               // regimes 1 and 3: n_rows key offsets within a range
    int32_t* part_ranges;             // regime 3: 2 * n_buckets + 2 words (see seg_part_histogram);
                                      // regime 1: its counters (see ord_starts)
    int32_t bucket_shift;             // regimes 1 and 3: a range holds 1 << bucket_shift keys
    int32_t* tile_prefix;             // regime 1: the tiles' prefix tree, a row of n_buckets words a node
    uint32_t* partials;               // regime 1: a folded table a piece, n_pieces * n_tables << bucket_shift words
    int32_t piece_rows;               // regime 1: the most rows a fold block takes at once
    int32_t small_n;                  // regime 1: one launch, one block a range over every row
};

__device__ __forceinline__ bool is_int(int vt) { return vt == VT_INT32; }

// An involution on the bits of an f32 that orders them as int32.
__device__ __forceinline__ uint32_t flip32(uint32_t w) {
    return (int32_t)w >= 0 ? w : w ^ 0x7fffffffu;
}
__device__ __forceinline__ uint16_t flip16(uint16_t h) {
    return (int16_t)h >= 0 ? h : (uint16_t)(h ^ 0x7fffu);
}

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
    if (isnan(x)) return a;  // the NaN met first wins
    if (isnan(y)) return b;
    const int32_t fx = (int32_t)flip32(a), fy = (int32_t)flip32(b);  // -0.0 below +0.0
    return op == OP_MAX ? (fy > fx ? b : a) : (fy < fx ? b : a);
}

__device__ __forceinline__ uint32_t load_value(const void* base, int vt, int64_t i) {
    switch (vt) {
        case VT_INT32: return (uint32_t)((const int32_t*)base)[i];
        case VT_F32: return __float_as_uint(((const float*)base)[i]);
        case VT_BF16: return __float_as_uint(__bfloat162float(((const __nv_bfloat16*)base)[i]));
        default: return __float_as_uint(__half2float(((const __half*)base)[i]));
    }
}

// The 32-bit word of a value loaded as raw bits (the low 16 bits for bf16
// and f16): what load_value returns.
__device__ __forceinline__ uint32_t value_word(int vt, uint32_t raw) {
    switch (vt) {
        case VT_BF16: return __float_as_uint(__bfloat162float(__ushort_as_bfloat16((unsigned short)raw)));
        case VT_F16: return __float_as_uint(__half2float(__ushort_as_half((unsigned short)raw)));
        default: return raw;
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

// The lanes of a warp that share a lane's key (``peers``; none when its key
// is -1), its rank among them, and, for each level l their group sizes
// reach, the lane 2^l ranks above it (``up``, 32 for none), learnt by
// pointer jumping.  ``active``: the lanes whose key counts.
struct Peers {
    unsigned active, peers;
    int rank, levels;
    int up[5];
};

__device__ __forceinline__ Peers find_peers(int32_t key) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    Peers g;
    g.peers = 0u;
    g.rank = g.levels = 0;
#pragma unroll
    for (int l = 0; l < 5; ++l) g.up[l] = 32;
    g.active = __ballot_sync(FULL, key >= 0);
    if (g.active == 0u) return g;
    // lanes that do not count all carry -1, which no counting lane has
    g.peers = __match_any_sync(FULL, key) & g.active;
    g.rank = __popc(g.peers & ((1u << lane) - 1u));
    const unsigned above = lane == 31 ? 0u : g.peers & (0xfffffffeu << lane);
    int cur = above != 0u ? __ffs(above) - 1 : 32;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        if (!__any_sync(FULL, cur < 32)) break;
        g.up[l] = cur;
        g.levels = l + 1;
        const int next = __shfl_sync(FULL, cur, cur < 32 ? cur : lane);
        cur = cur < 32 ? next : 32;
    }
    return g;
}

// A lane's word folded with its peers' over a fixed tree of their ranks: at
// level l the lane of rank r (r a multiple of 2^(l+1)) takes in the lane of
// rank r + 2^l, so the lowest peer ends with the group's fold, in an order
// set by the keys alone, after log2 of the largest group's size shuffles.
__device__ __forceinline__ uint32_t fold_peers(const Peers& g, int op, int vt, uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        if (l >= g.levels) break;
        const uint32_t x = __shfl_sync(0xffffffffu, v, g.up[l] < 32 ? g.up[l] : lane);
        if (g.up[l] < 32 && (g.rank & ((2 << l) - 1)) == 0) v = combine(op, vt, v, x);
    }
    return v;
}

// One 32-row step of a warp into its private table of ``width`` keys per
// column: ``key`` is the lane's table index (-1 when its row does not count)
// and ``word(a)`` its value of aggregate a as a 32-bit word; the lowest lane
// of each key alone updates the table.  NA is the aggregate count, or -1
// for one read at run time.
template <int NA, typename Word>
__device__ __forceinline__ void warp_step(const SegParams& p, uint32_t* table, int64_t width,
                                          int32_t key, Word word) {
    const Peers g = find_peers(key);
    if (g.active == 0u) return;
    const bool valid = key >= 0, leader = valid && g.rank == 0;
    const int na = NA >= 0 ? NA : p.n_aggs;
    auto column = [&](int a) {
        const int op = p.op[a], vt = p.vtype[a];
        const uint32_t v = fold_peers(g, op, vt, valid ? word(a) : identity_word(op, vt));
        if (leader) {
            uint32_t* slot = table + (int64_t)a * width + key;
            *slot = combine(op, vt, *slot, v);
        }
    };
    if constexpr (NA >= 0) {
#pragma unroll
        for (int a = 0; a < NA; ++a) column(a);
    } else {
        for (int a = 0; a < na; ++a) column(a);
    }
    if (p.with_presence && leader) table[(int64_t)na * width + key] += __popc(g.peers);
    __syncwarp();  // orders this step's table writes before the next step's reads
}

// Folds the tables of a block's first ``n_warps`` warps (all by default),
// in warp order, for table indices [0, used); ``emit(t, k, word)``
// receives each result.
template <typename Emit>
__device__ __forceinline__ void fold_block_tables(const SegParams& p, const uint32_t* smem,
                                                  int64_t width, int64_t used, Emit emit, int n_warps = 0) {
    if (n_warps == 0) n_warps = blockDim.x / 32;
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

__device__ __forceinline__ void combine_at(const SegParams& p, int t, uint32_t* acc, uint32_t x, bool x_first) {
    const bool agg = t < p.n_aggs;
    const int op = agg ? p.op[t] : OP_SUM, vt = agg ? p.vtype[t] : VT_INT32;
    *acc = x_first ? combine(op, vt, x, *acc) : combine(op, vt, *acc, x);
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
        warp_step<-1>(p, table, K, counted_key(p, r, r1),
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
// Regime 1: large K with a float sum — partition by key range, then fold
// ---------------------------------------------------------------------------

#define SEG_ORD_THREADS 256                            // threads of a histogram or scatter block
#define SEG_ORD_ROWS 16                                // consecutive rows a thread of those takes
#define SEG_ORD_TILE (SEG_ORD_THREADS * SEG_ORD_ROWS)  // rows of a tile (its places are 16-bit)
#define SEG_HIST_TILES 4                               // tiles a histogram block counts
#define SEG_GROUP 32                                   // nodes a node of the tiles' prefix tree holds
#define SEG_LEVELS 5                                   // the tree's levels above a tile, at most
#define SEG_WARP_ROWS 512                              // rows a fold warp takes at least

// part_ranges for R ranges: [0, R] where each range starts among the counted
// rows (the last entry: all of them); [R + 1, 2 R + 1] where each range's
// pieces start among all pieces (the last entry: all of them); the fold's
// piece ticket; a counter a node of the tiles' prefix tree above its
// leaves (level by level); then a counter a piece for the fold's tree.
// All zero at launch.
__device__ __forceinline__ int32_t* ord_starts(const SegParams& p) { return p.part_ranges; }
__device__ __forceinline__ int32_t* ord_pieces(const SegParams& p) { return p.part_ranges + p.n_buckets + 1; }
__device__ __forceinline__ int32_t* ord_ticket(const SegParams& p) { return p.part_ranges + 2 * p.n_buckets + 2; }
__device__ __forceinline__ int64_t up_nodes(int64_t n) { return (n + SEG_GROUP - 1) / SEG_GROUP; }
__device__ __forceinline__ int32_t* ord_tree_counters(const SegParams& p) {
    int64_t above = 0;  // the prefix tree's nodes above the tiles
    for (int64_t n = p.n_tiles; n > 1; n = up_nodes(n)) above += up_nodes(n);
    return ord_ticket(p) + 1 + above;
}

// Keys of this thread's SEG_ORD_ROWS consecutive rows of the tile at tile0,
// -1 where the row does not count: 16-byte loads of keys and mask where the
// thread's rows are whole and both columns 16-byte aligned, else row by row.
__device__ __forceinline__ void tile_keys(const SegParams& p, int64_t tile0, int32_t (&key)[SEG_ORD_ROWS]) {
    const int64_t r0 = tile0 + (int64_t)threadIdx.x * SEG_ORD_ROWS;
    const bool aligned = (((uintptr_t)p.keys | (uintptr_t)p.mask) & 15u) == 0u;
    if (aligned && r0 + SEG_ORD_ROWS <= p.n_rows) {
        const int4* k4 = reinterpret_cast<const int4*>(p.keys + r0);
#pragma unroll
        for (int i = 0; i < SEG_ORD_ROWS / 4; ++i) {
            const int4 v = k4[i];
            key[4 * i] = v.x;
            key[4 * i + 1] = v.y;
            key[4 * i + 2] = v.z;
            key[4 * i + 3] = v.w;
        }
        if (p.mask != nullptr) {
            const uint4 m = *reinterpret_cast<const uint4*>(p.mask + r0);
            const uint32_t word[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
            for (int j = 0; j < SEG_ORD_ROWS; ++j)
                if (((word[j >> 2] >> (8 * (j & 3))) & 0xffu) == 0u) key[j] = -1;
        }
    } else {
#pragma unroll
        for (int j = 0; j < SEG_ORD_ROWS; ++j) {
            const int64_t r = r0 + j;
            const bool in = r < p.n_rows;
            key[j] = in ? p.keys[r] : -1;
            if (in && p.mask != nullptr && p.mask[r] == 0) key[j] = -1;
        }
    }
#pragma unroll
    for (int j = 0; j < SEG_ORD_ROWS; ++j)
        if (key[j] >= p.num_keys) key[j] = -1;  // negative keys already do not count
}

// Pass 1: one block SEG_HIST_TILES tiles, each tile's loads in flight
// while the one before it is counted.  Rows a range, counted in shared memory
// and written as the tile's leaf of the tiles' prefix tree (tile_prefix,
// level 0: a row of R counts a tile).  Level l + 1 holds a node a group of
// SEG_GROUP nodes of level l; the last block to finish a group (a counter,
// to which a block adds its tiles at once) turns the group's counts into
// exclusive prefixes in place, range by range, writes their total as the
// parent's count and counts in at the parent's group, up to the root,
// which holds each range's rows.  That block, the last of all, turns the
// totals into where each range starts and cuts each range into pieces.
// So a tile's rows of range b begin after the sum over levels of its
// ancestors' prefixes: fixed by the counts, with no block waiting on
// another.
__global__ void __launch_bounds__(SEG_ORD_THREADS, 4)
seg_ordered_histogram(const SegParams p) {
    extern __shared__ uint32_t smem[];
    int32_t* count = (int32_t*)smem;  // R
    __shared__ int32_t total;
    __shared__ bool last;
    const int R = p.n_buckets;
    int32_t* level = p.tile_prefix;
    const int64_t t0 = (int64_t)blockIdx.x * SEG_HIST_TILES, t1 = min((int64_t)p.n_tiles, t0 + SEG_HIST_TILES);
    int32_t key[SEG_ORD_ROWS];
    tile_keys(p, t0 * SEG_ORD_TILE, key);
    for (int64_t t = t0; t < t1; ++t) {
        for (int b = threadIdx.x; b < R; b += blockDim.x) count[b] = 0;
        __syncthreads();
        int32_t next[SEG_ORD_ROWS];
        if (t + 1 < t1) tile_keys(p, (t + 1) * SEG_ORD_TILE, next);
        int32_t run_b = -1, run = 0;  // a run of rows of one range is added at once
#pragma unroll
        for (int j = 0; j < SEG_ORD_ROWS; ++j) {
            const int32_t b = key[j] < 0 ? -1 : key[j] >> p.bucket_shift;
            if (b != run_b) {
                if (run_b >= 0) atomicAdd(count + run_b, run);
                run_b = b;
                run = 0;
            }
            ++run;
        }
        if (run_b >= 0) atomicAdd(count + run_b, run);
        __syncthreads();
        for (int b = threadIdx.x; b < R; b += blockDim.x) level[t * R + b] = count[b];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SEG_ORD_ROWS; ++j) key[j] = next[j];
    }
    int32_t* counters = ord_ticket(p) + 1;
    int64_t node = t0, done = t1 - t0;  // the block's nodes of the level: its tiles, then one group a level
    for (int64_t n = p.n_tiles; n > 1; n = up_nodes(n)) {
        const int64_t group = node / SEG_GROUP, g0 = group * SEG_GROUP, g1 = min(n, g0 + SEG_GROUP);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) last = atomicAdd(counters + group, (int32_t)done) == (int32_t)(g1 - g0 - done);
        __syncthreads();
        if (!last) return;
        __threadfence();
        int32_t* parent = level + n * R;
        for (int b = threadIdx.x; b < R; b += blockDim.x) {
            int32_t sum = 0;
            for (int64_t u0 = g0; u0 < g1; u0 += 8) {  // eight loads in flight at once
                int32_t x[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) x[u] = u0 + u < g1 ? __ldcg(level + (u0 + u) * R + b) : 0;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    if (u0 + u < g1) level[(u0 + u) * R + b] = sum;
                    sum += x[u];
                }
            }
            parent[group * R + b] = sum;
        }
        counters += up_nodes(n);
        level = parent;
        node = group;
        done = 1;
    }
    // the last block of all: the root holds each range's rows
    for (int b = threadIdx.x; b < R; b += blockDim.x) count[b] = level[b];
    __syncthreads();
    block_exclusive_scan(count, R, 1, &total);
    int32_t* starts = ord_starts(p);
    for (int b = threadIdx.x; b < R; b += blockDim.x) starts[b] = count[b];
    if (threadIdx.x == 0) starts[R] = total;
    __syncthreads();
    // a range of c rows is cut into ceil(c / piece_rows) pieces, one if empty
    for (int b = threadIdx.x; b < R; b += blockDim.x) {
        const int64_t c = starts[b + 1] - starts[b];
        count[b] = (int32_t)max((int64_t)1, (c + p.piece_rows - 1) / p.piece_rows);
    }
    __syncthreads();
    block_exclusive_scan(count, R, 1, &total);
    int32_t* pieces = ord_pieces(p);
    for (int b = threadIdx.x; b < R; b += blockDim.x) pieces[b] = count[b];
    if (threadIdx.x == 0) pieces[R] = total;
}

// Pass 2: one block a tile.  Where each range's rows of the tile go (its
// start plus the tile's ancestors' prefixes) is loaded with the tile's
// keys and mask.  Each warp lists its counted rows in the order (row step
// j, lane), and the raw values of the rows it listed are loaded then, under
// a predicate (NA of them known at compile time; else column by column at
// the end), to arrive while the rows are ranked by range in the order
// (warp, list) by a warp match a 32 listed rows and the warp's counts a
// range; the tile's rows are laid out by range in shared memory, and
// written, key offsets then each value column, run by run: neighbouring
// threads to neighbouring places.
template <int NA>
__global__ void __launch_bounds__(SEG_ORD_THREADS, 4)
seg_ordered_scatter(const SegParams p) {
    constexpr int W = SEG_ORD_THREADS / 32, WARP_ROWS = 32 * SEG_ORD_ROWS;
    extern __shared__ uint32_t smem[];
    const int R = p.n_buckets;
    int32_t* wcount = (int32_t*)smem;                       // W * R: a warp's rows a range
    int32_t* local = wcount + W * R;                        // R: where the tile's run of a range begins
    int32_t* dest = local + R;                              // R: where the range's rows of the tile go
    uint32_t* staged = (uint32_t*)(dest + R);               // TILE: a value column in place order; before
    int32_t* listed = (int32_t*)staged;                     //   that, the warps' counted keys
    uint16_t* row_of = (uint16_t*)(staged + SEG_ORD_TILE);  // TILE: the tile's row of each listed key
    uint16_t* place_of = row_of + SEG_ORD_TILE;             // TILE: its rank in its warp and range, then its place
    uint16_t* s_range = place_of + SEG_ORD_TILE;            // TILE: range of each place
    uint16_t* s_off = s_range + SEG_ORD_TILE;               // TILE: key offset of each place
    __shared__ int32_t n_counted;
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t tile = blockIdx.x, tile0 = tile * SEG_ORD_TILE;
    // where range b's rows of the tile go: its start and the tile's
    // ancestors' prefixes, loaded beside the keys (the block's first R
    // ranges; any more once the keys are in)
    auto dest_parts = [&](int b, int32_t (&part)[SEG_LEVELS + 1]) {
        const int32_t* level = p.tile_prefix;
        int64_t node = tile, n = p.n_tiles;
#pragma unroll
        for (int l = 0; l < SEG_LEVELS; ++l) {
            part[l] = n > 1 ? level[node * R + b] : 0;
            level += n * R;
            node /= SEG_GROUP;
            n = up_nodes(n);
        }
        part[SEG_LEVELS] = ord_starts(p)[b];
    };
    auto set_dest = [&](int b, const int32_t (&part)[SEG_LEVELS + 1]) {
        int32_t sum = 0;
#pragma unroll
        for (int l = 0; l <= SEG_LEVELS; ++l) sum += part[l];
        dest[b] = sum;
    };
    int32_t part[SEG_LEVELS + 1];
    if (threadIdx.x < R) dest_parts(threadIdx.x, part);
    int32_t key[SEG_ORD_ROWS];
    tile_keys(p, tile0, key);
    for (int i = threadIdx.x; i < W * R; i += blockDim.x) wcount[i] = 0;
    if (threadIdx.x < R) set_dest(threadIdx.x, part);
    for (int b = threadIdx.x + blockDim.x; b < R; b += blockDim.x) {
        dest_parts(b, part);
        set_dest(b, part);
    }
    // the warp's list of its counted rows
    int32_t* my_keys = listed + warp * WARP_ROWS;
    uint16_t* my_rows = row_of + warp * WARP_ROWS;
    uint16_t* my_places = place_of + warp * WARP_ROWS;
    const unsigned lower = (1u << lane) - 1u;
    int n_mine = 0;
#pragma unroll
    for (int j = 0; j < SEG_ORD_ROWS; ++j) {
        const unsigned m = __ballot_sync(FULL, key[j] >= 0);
        if (key[j] >= 0) {
            const int e = n_mine + __popc(m & lower);
            my_keys[e] = key[j];
            my_rows[e] = (uint16_t)((warp * 32 + lane) * SEG_ORD_ROWS + j);
        }
        n_mine += __popc(m);
    }
    __syncwarp();
    // the raw bits of the values of the lane's listed rows e = lane + 32 u,
    // loaded under a predicate (nothing waits for them until they are staged)
    uint32_t w[NA > 0 ? NA : 1][SEG_ORD_ROWS];
    if constexpr (NA > 0) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
#pragma unroll
            for (int u = 0; u < SEG_ORD_ROWS; ++u) w[a][u] = 0u;
            if (is_int(p.vtype[a]) || p.vtype[a] == VT_F32) {
                const uint32_t* base = (const uint32_t*)p.vals[a] + tile0;
#pragma unroll
                for (int u = 0; u < SEG_ORD_ROWS; ++u) {
                    if (32 * u >= n_mine) break;  // warp-uniform
                    if (lane + 32 * u < n_mine) w[a][u] = base[my_rows[lane + 32 * u]];
                }
            } else {
                const uint16_t* base = (const uint16_t*)p.vals[a] + tile0;
#pragma unroll
                for (int u = 0; u < SEG_ORD_ROWS; ++u) {
                    if (32 * u >= n_mine) break;  // warp-uniform
                    if (lane + 32 * u < n_mine) w[a][u] = base[my_rows[lane + 32 * u]];
                }
            }
        }
    }
    // every step's match first (a step: 32 listed rows), then the warp's
    // counts a range in step order
    const int steps = (n_mine + 31) / 32;
    unsigned peers[SEG_ORD_ROWS];
#pragma unroll
    for (int u = 0; u < SEG_ORD_ROWS; ++u) {
        const int e = lane + 32 * u;
        const int32_t b = e < n_mine ? my_keys[e] >> p.bucket_shift : -1;
        peers[u] = u < steps ? __match_any_sync(FULL, b) & __ballot_sync(FULL, b >= 0) : 0u;
    }
    __syncthreads();  // wcount zeroed
    int32_t* mine = wcount + warp * R;
#pragma unroll
    for (int u = 0; u < SEG_ORD_ROWS; ++u) {
        if (u >= steps) break;  // warp-uniform
        const int e = lane + 32 * u;
        const bool counted = peers[u] != 0u;
        const int32_t b = counted ? my_keys[e] >> p.bucket_shift : 0;
        const unsigned before = peers[u] & lower;
        if (counted) my_places[e] = (uint16_t)(mine[b] + __popc(before));
        __syncwarp();
        if (counted && before == 0u) mine[b] += __popc(peers[u]);
        __syncwarp();
    }
    __syncthreads();
    for (int b = threadIdx.x; b < R; b += blockDim.x) {  // warp w's first rank in range b
        int32_t run = 0;
        for (int v = 0; v < W; ++v) {
            const int32_t c = wcount[v * R + b];
            wcount[v * R + b] = run;
            run += c;
        }
        local[b] = run;
    }
    __syncthreads();
    block_exclusive_scan(local, R, 1, &n_counted);
    for (int b = threadIdx.x; b < R; b += blockDim.x) dest[b] -= local[b];  // a place q of range b goes to dest[b] + q
    for (int e = lane; e < n_mine; e += 32) {
        const int32_t k = my_keys[e], b = k >> p.bucket_shift;
        const int q = local[b] + mine[b] + my_places[e];
        my_places[e] = (uint16_t)q;
        s_range[q] = (uint16_t)b;
        s_off[q] = (uint16_t)(k & ((1 << p.bucket_shift) - 1));
    }
    __syncthreads();
    const int placed = n_counted;
    for (int q = threadIdx.x; q < placed; q += blockDim.x) p.part_off[(int64_t)dest[s_range[q]] + q] = s_off[q];
    const int na = NA >= 0 ? NA : p.n_aggs;
    for (int a = 0; a < na; ++a) {
        if constexpr (NA > 0) {
            const int vt = p.vtype[a];
#pragma unroll
            for (int u = 0; u < SEG_ORD_ROWS; ++u) {
                if (32 * u >= n_mine) break;  // warp-uniform
                const int e = lane + 32 * u;
#pragma unroll
                for (int c = 0; c < NA; ++c)  // a constant index into w
                    if (c == a && e < n_mine) staged[my_places[e]] = value_word(vt, w[c][u]);
            }
        } else {
            for (int e = lane; e < n_mine; e += 32)
                staged[my_places[e]] = load_value(p.vals[a], p.vtype[a], tile0 + my_rows[e]);
        }
        __syncthreads();
        uint32_t* out = p.part_vals + (int64_t)a * p.n_rows;
        for (int q = threadIdx.x; q < placed; q += blockDim.x) out[(int64_t)dest[s_range[q]] + q] = staged[q];
        __syncthreads();
    }
}

// Pass 3: pieces in ticket order.  Piece i of range b's np pieces holds its
// rows [c i / np, c (i + 1) / np) of its c; as many of the block's warps as
// it gives SEG_WARP_ROWS rows each fold contiguous slices of them, step by
// step, the next SEG_ROW_STEP steps' loads in flight while SEG_ROW_STEP
// steps fold, and the block folds their tables in warp order.  Then up the
// range's tree: node (l, j) holds pieces [j 2^l, (j + 1) 2^l); a node
// without a sibling is its own parent; otherwise each child writes its
// table to the slot of its first piece and counts in at the parent, whose
// counter is the slot of the right child's first piece; the second to
// arrive joins left then right and goes on up.  The root writes the
// range's slice of the outputs.
template <int NA>
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_ordered_fold(const SegParams p) {
    extern __shared__ uint32_t smem[];
    __shared__ int32_t s_piece, s_first;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int R = p.n_buckets, nt = n_tables(p);
    const int64_t width = (int64_t)1 << p.bucket_shift;
    int32_t* tree = ord_tree_counters(p);
    uint32_t* table = smem + (int64_t)warp * nt * width;
    int32_t* starts = (int32_t*)(smem + (int64_t)(blockDim.x >> 5) * nt * width);  // R + 1, from part_ranges
    int32_t* pieces = starts + R + 1;                                                // R + 1, from part_ranges
    for (int b = threadIdx.x; b <= R; b += blockDim.x) {
        starts[b] = ord_starts(p)[b];
        pieces[b] = ord_pieces(p)[b];
    }
    for (;;) {
        __syncthreads();  // the last piece's tables are read out
        if (threadIdx.x == 0) s_piece = atomicAdd(ord_ticket(p), 1);
        __syncthreads();
        const int32_t piece = s_piece;
        if (piece >= pieces[R]) return;
        int lo = 0, hi = R - 1;  // the range b with pieces[b] <= piece < pieces[b + 1]
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (pieces[mid] <= piece) lo = mid;
            else hi = mid - 1;
        }
        const int b = lo, first_piece = pieces[b];
        const int np = pieces[b + 1] - first_piece, i = piece - first_piece;
        const int64_t first = starts[b], c = starts[b + 1] - first;
        const int64_t k0 = (int64_t)b << p.bucket_shift;
        const int used = (int)min(width, (int64_t)p.num_keys - k0);
        if (c == 0) {  // no rows (then one piece): the identities
            for (int idx = threadIdx.x; idx < nt * used; idx += blockDim.x) {
                const int t = idx / used;
                emit_output(p, t, k0 + idx - t * used, t < p.n_aggs ? identity_word(p.op[t], p.vtype[t]) : 0u);
            }
            continue;
        }
        const int64_t r_lo = first + c * i / np, r_hi = first + c * (i + 1) / np;
        const int active = (int)min((int64_t)(blockDim.x >> 5), (r_hi - r_lo + SEG_WARP_ROWS - 1) / SEG_WARP_ROWS);
        if (warp < active) {
            init_table(p, table, width, used, lane, 32);
            __syncwarp();
            const int64_t slice = ((r_hi - r_lo + active - 1) / active + 31) / 32 * 32;
            const int64_t r0 = min(r_hi, r_lo + warp * slice), r1 = min(r_hi, r0 + slice);
            if constexpr (NA >= 0) {
                // the next SEG_ROW_STEP steps' offsets and values load while these fold
                int32_t key[SEG_ROW_STEP], next_key[SEG_ROW_STEP];
                uint32_t w[NA > 0 ? NA : 1][SEG_ROW_STEP], next_w[NA > 0 ? NA : 1][SEG_ROW_STEP];
                auto load = [&](int64_t base, int32_t (&k)[SEG_ROW_STEP], uint32_t (&v)[NA > 0 ? NA : 1][SEG_ROW_STEP]) {
#pragma unroll
                    for (int s = 0; s < SEG_ROW_STEP; ++s) {
                        const int64_t r = base + s * 32 + lane;
                        k[s] = r < r1 ? (int32_t)p.part_off[r] : -1;
#pragma unroll
                        for (int a = 0; a < NA; ++a) v[a][s] = r < r1 ? p.part_vals[(int64_t)a * p.n_rows + r] : 0u;
                    }
                };
                load(r0, key, w);
                for (int64_t base = r0; base < r1; base += 32 * SEG_ROW_STEP) {
                    load(base + 32 * SEG_ROW_STEP, next_key, next_w);
#pragma unroll
                    for (int s = 0; s < SEG_ROW_STEP; ++s)
                        warp_step<NA>(p, table, width, key[s], [&](int a) { return w[a][s]; });
#pragma unroll
                    for (int s = 0; s < SEG_ROW_STEP; ++s) {
                        key[s] = next_key[s];
#pragma unroll
                        for (int a = 0; a < NA; ++a) w[a][s] = next_w[a][s];
                    }
                }
            } else {
                for (int64_t base = r0; base < r1; base += 32 * SEG_ROW_STEP) {
                    int32_t key[SEG_ROW_STEP];
#pragma unroll
                    for (int s = 0; s < SEG_ROW_STEP; ++s) {
                        const int64_t r = base + s * 32 + lane;
                        key[s] = r < r1 ? (int32_t)p.part_off[r] : -1;
                    }
#pragma unroll
                    for (int s = 0; s < SEG_ROW_STEP; ++s)
                        warp_step<-1>(p, table, width, key[s], [&](int a) {
                            return p.part_vals[(int64_t)a * p.n_rows + base + s * 32 + lane];
                        });
                }
            }
        }
        __syncthreads();
        // the piece's result in warp 0's tables: each (t, k) read and written by one thread
        fold_block_tables(p, smem, width, used, [&](int t, int64_t k, uint32_t acc) { smem[t * width + k] = acc; },
                          active);
        __syncthreads();
        for (int l = 0, j = i;; ++l, j >>= 1) {
            if (j == 0 && (1 << l) >= np) {  // the root
                for (int idx = threadIdx.x; idx < nt * used; idx += blockDim.x) {
                    const int t = idx / used, k = idx - t * used;
                    emit_output(p, t, k0 + k, smem[t * width + k]);
                }
                break;
            }
            const int sib = j ^ 1;
            if ((sib << l) >= np) continue;  // no sibling: the node is its parent
            uint32_t* slot = p.partials + (int64_t)(first_piece + (j << l)) * nt * width;
            for (int idx = threadIdx.x; idx < nt * used; idx += blockDim.x) {
                const int t = idx / used, k = idx - t * used;
                slot[t * width + k] = smem[t * width + k];
            }
            __threadfence();
            __syncthreads();
            if (threadIdx.x == 0) s_first = atomicAdd(tree + first_piece + ((j | 1) << l), 1) == 0;
            __syncthreads();
            if (s_first) break;  // the sibling, when it arrives, joins the two
            __threadfence();
            const uint32_t* other = p.partials + (int64_t)(first_piece + (sib << l)) * nt * width;
            for (int idx = threadIdx.x; idx < nt * used; idx += blockDim.x) {
                const int t = idx / used, k = idx - t * used;
                combine_at(p, t, smem + t * width + k, __ldcg(other + t * width + k), (j & 1) != 0);
            }
        }
    }
}

// Below the one-launch limit (kernel.py's SMALL_READS), the whole call: one
// block a range; as many of its warps as the rows give SEG_WARP_ROWS each
// fold contiguous slices of all the rows (only its own keys count), the
// block folds their tables in warp order and writes its slice of every
// output.
__global__ void __launch_bounds__(SEG_WARPS_PER_BLOCK * 32)
seg_ordered_small(const SegParams p) {
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = (int)max((int64_t)1, min((int64_t)(blockDim.x >> 5), (p.n_rows + SEG_WARP_ROWS - 1) / SEG_WARP_ROWS));
    const int64_t width = (int64_t)1 << p.bucket_shift;
    const int64_t k0 = (int64_t)blockIdx.x << p.bucket_shift;
    const int used = (int)min(width, (int64_t)p.num_keys - k0);
    uint32_t* table = smem + (int64_t)warp * n_tables(p) * width;
    if (warp < n_warps) init_table(p, table, width, used, lane, 32);
    __syncwarp();
    const int64_t slice = ((p.n_rows + n_warps - 1) / n_warps + 31) / 32 * 32;
    const int64_t r0 = warp < n_warps ? min(p.n_rows, warp * slice) : p.n_rows, r1 = min(p.n_rows, r0 + slice);
    for (int64_t base = r0; base < r1; base += 32 * SEG_ROW_STEP) {
        int32_t key[SEG_ROW_STEP];
        uint8_t m[SEG_ROW_STEP];
#pragma unroll
        for (int s = 0; s < SEG_ROW_STEP; ++s) {  // every load issued before any is used
            const int64_t r = base + s * 32 + lane;
            key[s] = r < r1 ? p.keys[r] : -1;
            m[s] = r < r1 && p.mask != nullptr ? p.mask[r] : (uint8_t)1;
        }
#pragma unroll
        for (int s = 0; s < SEG_ROW_STEP; ++s)
            key[s] = m[s] != 0 && key[s] >= 0 && key[s] < p.num_keys && (key[s] >> p.bucket_shift) == (int32_t)blockIdx.x
                         ? (int32_t)(key[s] - k0) : -1;
#pragma unroll
        for (int s = 0; s < SEG_ROW_STEP; ++s)
            warp_step<-1>(p, table, width, key[s],
                          [&](int a) { return load_value(p.vals[a], p.vtype[a], base + s * 32 + lane); });
    }
    __syncthreads();
    fold_block_tables(p, smem, width, used,
                      [&](int t, int64_t k, uint32_t acc) { emit_output(p, t, k0 + k, acc); }, n_warps);
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

// The row kernels of regimes 1 to 3 are built for 0, 1 and 2 aggregates
// (their loads unrolled over the aggregates) and for any count read at run
// time; these pick the instance and launch it.
struct DirectRows {
    template <int NA> static auto kernel() { return seg_direct_rows<NA>; }
};
struct PartFold {
    template <int NA> static auto kernel() { return seg_part_fold<NA>; }
};
struct OrderedScatter {
    template <int NA> static auto kernel() { return seg_ordered_scatter<NA>; }
};
struct OrderedFold {
    template <int NA> static auto kernel() { return seg_ordered_fold<NA>; }
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
    const int64_t cells = (int64_t)nt * p.num_keys;
    if (p.regime == 0) {
        const int threads = SEG_WARPS_PER_BLOCK * 32;
        const size_t smem = (size_t)SEG_WARPS_PER_BLOCK * nt * p.num_keys * sizeof(uint32_t);
        SEG_CHECK(allow_smem(seg_accumulate, smem));
        seg_accumulate<<<p.n_warps / SEG_WARPS_PER_BLOCK, threads, smem, s>>>(p);
        SEG_CHECK(cudaGetLastError());
        seg_combine<<<(int)((cells * 32 + 255) / 256), 256, 0, s>>>(p);
        return (int)cudaGetLastError();
    }
    if (p.regime == 1) {
        const int R = p.n_buckets;
        const size_t table_smem = ((size_t)p.reduce_warps * nt * sizeof(uint32_t)) << p.bucket_shift;
        if (p.small_n || p.n_rows == 0) {
            SEG_CHECK(allow_smem(seg_ordered_small, table_smem));
            seg_ordered_small<<<R, p.reduce_warps * 32, table_smem, s>>>(p);
            return (int)cudaGetLastError();
        }
        const int64_t n_pieces = (p.n_rows + p.piece_rows - 1) / p.piece_rows + R;
        const size_t hist_smem = (size_t)R * sizeof(int32_t);
        const size_t scatter_smem = (size_t)(SEG_ORD_THREADS / 32 + 2) * R * sizeof(int32_t)
                                    + (size_t)SEG_ORD_TILE * (sizeof(uint32_t) + 4 * sizeof(uint16_t));
        SEG_CHECK(allow_smem(seg_ordered_histogram, hist_smem));
        int64_t counters = 2 * (int64_t)R + 3 + n_pieces;  // see ord_starts
        for (int64_t n = p.n_tiles; n > 1; n = (n + SEG_GROUP - 1) / SEG_GROUP) counters += (n + SEG_GROUP - 1) / SEG_GROUP;
        SEG_CHECK(cudaMemsetAsync(p.part_ranges, 0, (size_t)counters * sizeof(int32_t), s));
        seg_ordered_histogram<<<(p.n_tiles + SEG_HIST_TILES - 1) / SEG_HIST_TILES, SEG_ORD_THREADS, hist_smem, s>>>(p);
        SEG_CHECK(cudaGetLastError());
        SEG_CHECK(launch_by_aggs(p, s, p.n_tiles, SEG_ORD_THREADS, scatter_smem, OrderedScatter{}));
        const size_t fold_smem = table_smem + 2 * ((size_t)R + 1) * sizeof(int32_t);
        return (int)launch_by_aggs(p, s, p.n_blocks, p.reduce_warps * 32, fold_smem, OrderedFold{});
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
    return cudaErrorInvalidValue;  // no such regime
}
