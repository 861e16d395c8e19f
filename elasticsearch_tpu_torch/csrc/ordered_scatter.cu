// Ordered scatter-add for NVIDIA Hopper (sm_90a), and the ordered BM25 tile
// add built on the same passes.
//
//     for s in 0 .. S-1:  acc[r, tgt[r, s]] += src[r, s]     (every row r)
//     and, when cnt is given, cnt[r, tgt[r, s]] += inc[r, s] in the same pass
//
// with each f32 cell receiving its contributions one after another in slot
// order, starting from its current value: the bits of a sequential scatter,
// of `ops/ordered_scatter.py:ordered_scatter_add_plain` on the CPU, of the
// JAX package's `.at[].add` on the CPU and of the numpy oracle's `np.add.at`.
// `scatter_add_` / `index_add_` on the card sum with float atomics instead, so
// a doc's last ulp changed from run to run; this code has no float atomics,
// no atomics at all, and its result does not depend on timing.
//
// Replaces no TPU kernel: the JAX package leaves every BM25 and sparse
// accumulation to XLA's scatter (`.at[].add`). It exists for that order.
//
// Slots whose target lies outside [0, C-1) are not applied: the last column
// C-1 is the callers' overflow column, where padding slots aim with +0.0 and
// inc 0, and it keeps its value.
//
// What bounds it on an H100 SXM (3.35 TB/s, 700 W). The function must read
// the slots (tgt, src and inc) once and read and write each cell it touches:
// at route (f)'s chunk (32 rows, 65,536 slots a row, 1M docs) some 25 MB,
// 8 us, when few slots are valid; almost every slot is padding there. When
// most are valid (a group's later chunks carry whole tiles of frequent
// terms), the touched cells lie scattered over the [R, C] planes, and each
// costs a 32-byte sector read and written on each plane: that traffic bounds
// it then. A row of at most CAP slots (route (a)'s one-query launches) is
// bound by launch latency.
//
// Design: the valid slots grouped by cell range, no block copies a slice of
// acc, every touched cell read and written once.
//  1. chunk_kernel, grid (chunks, rows): a block reads CAP slots of its row's
//     targets (16 bytes a thread), keeps the valid ones and loads their
//     values (and increments) only for the 16-byte groups that hold one.
//     A block-wide prefix sum of the per-thread counts compacts them into
//     shared memory in slot order. The block sorts them stably by bucket (a
//     range of `width` cells of the row), so each bucket's slots stay in slot
//     order. It writes them to its own fixed place in the scratch staging
//     area (chunk c of row r at (r * chunks + c) * CAP) and writes, for each
//     bucket of its row, its start and count (packed) to the count table.
//  2. apply_kernel, grid (rows x buckets): a block owns the cells of one
//     bucket, which no other block touches. A prefix sum over its row's
//     chunks' counts tells where each of its slots lies; blocks whose bucket
//     received nothing exit. It gathers its slots in chunk order, so in slot
//     order, in pieces of CAP, sorts each piece stably by cell, which gives
//     (cell, slot) order, and the first thread of each cell's run loads the
//     cell, adds the run's values left to right with __fadd_rn (no
//     contraction, no reordering, no tree), adds the run's increments to the
//     count cell, and writes both once. A bucket of more than CAP slots takes
//     several pieces, one after another.
// The apply block keeps two ints a chunk in shared memory, so a row of more
// than MAX_CHUNKS chunks is taken in windows of MAX_CHUNKS chunks, one after
// another on the stream, which keeps each cell's additions in slot order.
// Rows of at most CAP slots take one launch instead: row_kernel, grid
// (buckets, rows); a block reads its row's slots, keeps those of its bucket in
// slot order, sorts them by cell and adds the runs. Each block re-reads the
// row's few slots (from L2) so that the card is filled from the buckets.
//
// The BM25 tile add (`es_bm25_tile_add`) is the same function over slots
// that the kernels compute themselves. Row r's slots are the 128 postings
// slots of each tile of its list, in list order; slot (doc, tf) of a tile of
// weight w gives
//     tgt = doc,  src = w - w / (1 + tf * inv_norm[doc]),  inc = 1
// where doc >= 0 (postings padding, doc -1, is not applied). Each step of the
// formula rounds on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsub_rn, so
// nvcc cannot contract `1 + tf * inv` into an FMA), as PyTorch's separate
// elementwise kernels round it (`ops/scoring.py:_chunk_scores`): the
// contributions, their order and so the bits are those of `_chunk_scores` +
// `ordered_scatter_add` over the whole list, in 512-tile chunks or not.
// It replaces no TPU kernel either: the JAX package gathers, scores and
// scatters a pass in 512-tile chunks through XLA (`ops/scoring.py:_chunk_add`),
// and the port did the same with a host step (a plan, an upload, about ten
// PyTorch launches) a chunk; here a pass is one call. What bounds it: the
// pass's postings read once (doc id and tf, 8 bytes a slot) and, for each
// valid slot, its doc's inv_norm read and its cell read and written (a
// 32-byte sector each, on each plane). Design: the chunk stage reads a
// chunk's 16 tiles straight from the postings (16 bytes a thread, a warp a
// tile), computes each valid slot's contribution in registers and stages only
// the valid slots (target and value; the increment is 1); the apply stage is
// the one above. The rows' lists lie end to end, so the chunks of all rows
// form one list (row r holds chunks coff[r] .. coff[r+1]), taken in windows
// of at most MAX_CHUNKS chunks whose scratch the wrapper sizes from the
// pass's own tile counts (`ops/ordered_scatter.py:tile_layout`). A pass whose
// rows hold at most CAP slots each takes row_kernel alone.
//
// Scratch and grids come from the shapes alone (the wrapper's `layout`), the
// worst case of every slot valid; nothing is read back by the host. The
// wrapper also passes its layout constants at build time (ES_TILE, ES_CHUNK,
// ES_MAX_BUCKETS, ES_MAX_WIDTH_BITS, ES_MAX_CHUNKS); the static_asserts below
// hold them to the kernels' shared memory. A sort of up to RANKED keys a
// 4-bit radix pass (at most one key a thread) ranks the keys; a larger one is
// cub's BlockRadixSort over the key's bits only. The kernels use dynamic
// shared memory only, and each kernel's limit is set once per device to the
// card's maximum, never to a launch's own size (which races with another
// thread's larger launch). PERF.md holds the measured times.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#if !defined(ES_TILE) || !defined(ES_CHUNK) || !defined(ES_MAX_BUCKETS) || !defined(ES_MAX_WIDTH_BITS) || \
    !defined(ES_MAX_CHUNKS)
#error "built by ops/ordered_scatter.py, which passes its layout constants"
#endif

namespace {

constexpr int THREADS = 256;
constexpr int CAP = ES_CHUNK;             // slots a chunk = slots a piece
constexpr int ITEMS = CAP / THREADS;      // keys a thread holds in the radix sort
constexpr int RANKED = 64;                // keys a radix pass is worth in ranking (O(n^2))
constexpr int MAX_BUCKETS = ES_MAX_BUCKETS;        // buckets a row
constexpr int MAX_WIDTH_BITS = ES_MAX_WIDTH_BITS;  // cells a bucket <= 2^MAX_WIDTH_BITS
constexpr int MAX_CHUNKS = ES_MAX_CHUNKS;          // chunks a window
constexpr int TILE = ES_TILE;             // postings slots a tile
// the dynamic shared memory a Hopper block may use; each kernel's limit is
// set to it once for all
constexpr int SMEM_MAX = 232448;
static_assert(CAP % THREADS == 0 && CAP <= 65536, "a chunk is whole threads' items, 16-bit positions");
static_assert(CAP % 8 == 0, "a chunk is two rounds of 16 bytes a thread");
static_assert(CAP % TILE == 0, "a chunk is whole tiles");

using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, unsigned>;
using Scan64 = cub::BlockScan<unsigned long long, THREADS>;
using Scan32 = cub::BlockScan<int, THREADS>;

struct ChunkSmem {
  union {
    Sort::TempStorage sort;
    Scan64::TempStorage scan;
  } tmp;
  unsigned key[CAP];  // bucket
  unsigned short pos[CAP];  // after the sort: the key's position before it
  int tgt[CAP];       // the chunk's valid slots in slot order
  float val[CAP];
  int inc[CAP];
  int start[MAX_BUCKETS];
  unsigned packed[MAX_BUCKETS];  // (start << 16) | count, per bucket
};

struct PieceSmem {
  union {
    Sort::TempStorage sort;
    Scan32::TempStorage scan;
    Scan64::TempStorage scan64;
  } tmp;
  unsigned key[CAP];  // cell (- bucket start)
  unsigned short pos[CAP];  // after the sort: the key's position before it
  float val[CAP];     // the piece's slots in slot order
  int inc[CAP];
  float sval[CAP];    // the same in key order
  int sinc[CAP];
};
// apply_kernel's shared memory: PieceSmem, then int pre[chunks + 1] (the
// bucket's slots before each chunk) and int first[chunks] (where they start)
constexpr size_t apply_smem(int chunks) { return sizeof(PieceSmem) + sizeof(int) * (2 * (size_t)chunks + 1); }
static_assert(sizeof(ChunkSmem) <= SMEM_MAX, "chunk_kernel's shared memory");
static_assert(apply_smem(MAX_CHUNKS) <= SMEM_MAX, "apply_kernel's shared memory at MAX_CHUNKS");

__host__ __device__ inline int bits_for(unsigned x) {  // bits to hold 0 .. x, at least 1
  int b = 1;
  while (x >> b) ++b;
  return b;
}

// Sorts key[0..n) (n <= CAP) ascending by their low `nbits` bits, stably:
// equal keys keep their order, so (key, position) order. pos[j] gets the
// position the j-th key had. Ends with the block synchronised.
__device__ void sort_keys(unsigned* key, unsigned short* pos, int n, int nbits,
                          Sort::TempStorage& tmp) {
  const int i = threadIdx.x;
  if (n <= min(THREADS, RANKED * ((nbits + 3) / 4))) {  // rank: keys below, equal ones before
    unsigned k = 0;
    int rank = 0;
    if (i < n) {
      k = key[i];
      for (int j = 0; j < n; ++j) {
        const unsigned kj = key[j];
        rank += kj < k || (kj == k && j < i);
      }
    }
    __syncthreads();
    if (i < n) {
      key[rank] = k;
      pos[rank] = (unsigned short)i;
    }
    __syncthreads();
    return;
  }
  // cub's radix sort is stable; the padding's low bits are all ones and it
  // comes after every key, so it sorts last
  unsigned items[ITEMS], at[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int j = i * ITEMS + u;
    items[u] = j < n ? key[j] : 0xFFFFFFFFu;
    at[u] = j;
  }
  Sort(tmp).Sort(items, at, 0, nbits);
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int j = i * ITEMS + u;
    if (j < n) {
      key[j] = items[u];
      pos[j] = (unsigned short)at[u];
    }
  }
  __syncthreads();
}

// four targets (or values) at p[q .. q+3], -1 / 0 past the row's end
__device__ __forceinline__ int4 load_int4(const int* __restrict__ p, int q, int S, bool vec) {
  if (q >= S) return make_int4(-1, -1, -1, -1);
  if (vec) return __ldg(reinterpret_cast<const int4*>(p + q));
  return make_int4(__ldg(p + q), __ldg(p + q + 1), __ldg(p + q + 2), __ldg(p + q + 3));
}

__device__ __forceinline__ float4 load_float4(const float* __restrict__ p, int q, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + q));
  return make_float4(__ldg(p + q), __ldg(p + q + 1), __ldg(p + q + 2), __ldg(p + q + 3));
}

// Where row r's chunks of the window [g0, g1) sit among the window's chunks:
// the first (counted from the window's start) and how many. R rows of
// `chunks` each (coff null: a plain scatter's window), or the rows of a pass
// laid end to end, row r holding chunks coff[r] .. coff[r+1] of the pass.
__device__ __forceinline__ int2 row_chunks(const int* __restrict__ coff, int r, int chunks, int g0, int g1) {
  if (!coff) return make_int2(r * chunks, chunks);
  const int a = max(__ldg(coff + r), g0), b = min(__ldg(coff + r + 1), g1);
  return make_int2(a - g0, max(b - a, 0));
}

// A chunk_kernel block's chunk: its row, its place among the row's chunks of
// the window, its first slot in the row, and where the row's chunks of the
// window sit (row_chunks).
struct Chunk {
  int r, c, q0;
  int2 span;
};

// The slots of a plain scatter: R rows of S slots, row r at r * ld of the
// target, value and (optional) increment planes.
struct Planes {
  const int* tgt;
  const float* src;
  const int* inc;  // null: increments 0
  int ld, S;
  bool vec;

  // chunk_kernel's grid is (chunks, rows)
  __device__ Chunk chunk(int chunks, int, int) const {
    const int r = blockIdx.y;
    return {r, (int)blockIdx.x, (int)blockIdx.x * CAP, row_chunks(nullptr, r, chunks, 0, 0)};
  }
  // the targets of slots q .. q+3 of row r, -1 past its end
  __device__ int4 targets(int r, int q) const { return load_int4(tgt + (size_t)r * ld, q, S, vec); }
  // their values and increments (read where some target lies in [lo, lo+lim))
  __device__ void values(int r, int q, const int* t, unsigned lo, unsigned lim, float* v, int* in) const {
    const float4 x = load_float4(src + (size_t)r * ld, q, vec);
    const int4 i = inc ? load_int4(inc + (size_t)r * ld, q, S, vec) : make_int4(0, 0, 0, 0);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    in[0] = i.x, in[1] = i.y, in[2] = i.z, in[3] = i.w;
  }
};

// w - w / (1 + tf * inv), each step rounded on its own as PyTorch's
// separate elementwise kernels round it: no FMA
__device__ __forceinline__ float bm25(float w, int tf, float inv) {
  return __fsub_rn(w, __fdiv_rn(w, __fadd_rn(__fmul_rn(__int2float_rn(tf), inv), 1.0f)));
}

// The slots of a BM25 pass: row r's list is tiles[off[r] .. off[r+1]) of the
// postings (doc_ids, tfs: [n_tiles, 128]) with one weight a tile, and its
// chunks (CAP / 128 tiles each) are coff[r] .. coff[r+1] of the pass.
struct Tiles {
  const int* doc_ids;
  const int* tfs;
  const float* inv_norm;
  const int* tiles;
  const float* weights;
  const int* off;
  const int* coff;
  int R;
  bool vec;

  // chunk_kernel's grid is the window's chunks, rows end to end
  __device__ Chunk chunk(int chunks, int g0, int g1) const {
    const int g = g0 + (int)blockIdx.x;
    int a = 0, b = R - 1;  // the last row whose chunks start at or before g
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (__ldg(coff + mid) <= g) a = mid;
      else b = mid - 1;
    }
    const int2 span = row_chunks(coff, a, chunks, g0, g1);
    return {a, (int)blockIdx.x - span.x, (g - __ldg(coff + a)) * CAP, span};
  }
  // the doc ids of slots q .. q+3 of row r (lanes q % 128 .. of its list's
  // tile q / 128), -1 past the list's end
  __device__ int4 targets(int r, int q) const {
    const int j = __ldg(off + r) + q / TILE;
    if (j >= __ldg(off + r + 1)) return make_int4(-1, -1, -1, -1);
    return load_int4(doc_ids + (size_t)__ldg(tiles + j) * TILE, q % TILE, TILE, vec);
  }
  // their contributions where the doc lies in [lo, lo+lim) (inv_norm is read
  // for those alone), and increments of 1
  __device__ void values(int r, int q, const int* t, unsigned lo, unsigned lim, float* v, int* in) const {
    const int j = __ldg(off + r) + q / TILE;
    const float w = __ldg(weights + j);
    const int4 f = load_int4(tfs + (size_t)__ldg(tiles + j) * TILE, q % TILE, TILE, vec);
    const int tf[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = (unsigned)t[e] - lo < lim ? bm25(w, tf[e], __ldg(inv_norm + t[e])) : 0.0f;
      in[e] = 1;
    }
  }
};

// Reads the CAP slots of row r from slot q0 on (16 bytes a thread; slots
// past the row's end are padding), keeps those whose target lies in
// [lo, lo+lim) and writes them in slot order: key = (target - lo) / div, the
// target itself to tgt (if given), the value and the increment. Returns how
// many; the block is synchronised. (lo + lim <= C-1 < 2^31, so no negative
// target passes the unsigned test.)
template <class Src>
__device__ int compact(const Src& src, int r, int q0, unsigned lo, unsigned lim, int div,
                       unsigned* key, int* tgt, float* val, int* inc, Scan64::TempStorage& tmp) {
  // round j holds slots q0 + j*CAP/2 + 4*thread + (0..3)
  int t[2][4];
  int q[2];
  unsigned nvalid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    q[j] = q0 + j * (CAP / 2) + 4 * threadIdx.x;
    const int4 v = src.targets(r, q[j]);
    t[j][0] = v.x, t[j][1] = v.y, t[j][2] = v.z, t[j][3] = v.w;
    nvalid[j] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) nvalid[j] += (unsigned)t[j][e] - lo < lim;
  }
  // both rounds' prefix sums at once, one in each half of a 64-bit word
  unsigned long long before, total;
  Scan64(tmp).ExclusiveSum(nvalid[0] | (unsigned long long)nvalid[1] << 32, before, total);
  const int n0 = (int)(total & 0xFFFFFFFFu);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!nvalid[j]) continue;
    int p = j ? n0 + (int)(before >> 32) : (int)(before & 0xFFFFFFFFu);
    float vs[4];
    int is[4];
    src.values(r, q[j], t[j], lo, lim, vs, is);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((unsigned)t[j][e] - lo < lim) {
        key[p] = ((unsigned)t[j][e] - lo) / (unsigned)div;
        if (tgt) tgt[p] = t[j][e];
        val[p] = vs[e];
        inc[p] = is[e];
        ++p;
      }
    }
  }
  __syncthreads();
  return n0 + (int)(total >> 32);
}

// After sort_keys over the m slots of sm: the head of each cell's run loads
// arow[cell], adds the run's values left to right with __fadd_rn (no
// contraction, no reordering, no tree), adds the run's increments to
// crow[cell] (if given), and writes both once. Ends synchronised.
__device__ void add_runs(PieceSmem& sm, float* arow, int* crow, int m) {
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const int e = sm.pos[j];
    sm.sval[j] = sm.val[e];
    sm.sinc[j] = sm.inc[e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const unsigned cell = sm.key[j];
    if (j > 0 && sm.key[j - 1] == cell) continue;
    float v = arow[cell];
    int ci = 0;
    int x = j;
    do {
      v = __fadd_rn(v, sm.sval[x]);
      ci += sm.sinc[x];
      ++x;
    } while (x < m && sm.key[x] == cell);
    arow[cell] = v;
    if (crow) crow[cell] += ci;
  }
  __syncthreads();
}

template <class Src>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(Src src, int* __restrict__ st_tgt, float* __restrict__ st_val, int* __restrict__ st_inc,
             unsigned* __restrict__ counts, int C, int chunks, int nb, int width, int g0, int g1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const Chunk k = src.chunk(chunks, g0, g1);
  for (int b = threadIdx.x; b < nb; b += THREADS) sm.packed[b] = 0u;
  const int n = compact(src, k.r, k.q0, 0u, (unsigned)(C - 1), width, sm.key, sm.tgt, sm.val, sm.inc,
                        sm.tmp.scan);
  // bucket b of this chunk at crow[b * span.y]: the row's count table is
  // bucket-major over its chunks of the window
  unsigned* crow = counts + (size_t)nb * k.span.x + k.c;
  const size_t stride = (size_t)k.span.y;
  if (n == 0) {
    for (int b = threadIdx.x; b < nb; b += THREADS) crow[b * stride] = 0u;
    return;
  }
  sort_keys(sm.key, sm.pos, n, bits_for(nb - 1), sm.tmp.sort);

  // each bucket's start and count in the sorted chunk
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const unsigned b = sm.key[j];
    if (j == 0 || sm.key[j - 1] != b) sm.start[b] = j;
  }
  __syncthreads();
  const size_t at = (size_t)(k.span.x + k.c) * CAP;  // the chunk's fixed place in the staging area
  int* dt = st_tgt + at;
  float* dv = st_val + at;
  int* di = st_inc ? st_inc + at : nullptr;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const unsigned b = sm.key[j];
    if (j == n - 1 || sm.key[j + 1] != b)
      sm.packed[b] = (unsigned)sm.start[b] << 16 | (unsigned)(j - sm.start[b] + 1);
    const int i = sm.pos[j];
    dt[j] = sm.tgt[i];
    dv[j] = sm.val[i];
    if (di) di[j] = sm.inc[i];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += THREADS) crow[b * stride] = sm.packed[b];
}

// st_inc null: every staged slot's increment is 1 (a BM25 pass)
__global__ void __launch_bounds__(THREADS)
apply_kernel(float* acc, int* cnt, const int* __restrict__ st_tgt,
             const float* __restrict__ st_val, const int* __restrict__ st_inc,
             const unsigned* __restrict__ counts, const int* __restrict__ coff, int C, int chunks,
             int nb, int width, int g0, int g1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PieceSmem& sm = *reinterpret_cast<PieceSmem*>(smem_raw);
  int* pre = reinterpret_cast<int*>(smem_raw + sizeof(PieceSmem));
  int* first = pre + chunks + 1;
  const int k = blockIdx.x;
  const int r = k / nb;
  const int bucket = k - r * nb;
  const int2 span = row_chunks(coff, r, chunks, g0, g1);  // the row's chunks of the window
  if (span.y == 0) return;
  const int lo = bucket * width;
  const unsigned* cc = counts + (size_t)nb * span.x + (size_t)bucket * span.y;

  // the bucket's slots before each chunk of its row, and where they start there
  int n = 0;
  for (int c0 = 0; c0 < span.y; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    const unsigned p = c < span.y ? cc[c] : 0u;
    int ex, agg;
    Scan32(sm.tmp.scan).ExclusiveSum((int)(p & 0xFFFFu), ex, agg);
    if (c < span.y) {
      pre[c] = n + ex;
      first[c] = (int)(p >> 16);
    }
    n += agg;
    __syncthreads();
  }
  if (n == 0) return;
  if (threadIdx.x == 0) pre[span.y] = n;
  __syncthreads();

  float* arow = acc + (size_t)r * C + lo;
  int* crow = cnt ? cnt + (size_t)r * C + lo : nullptr;
  const size_t stage = (size_t)span.x * CAP;
  const int nbits = bits_for(width - 1);
  for (int p0 = 0; p0 < n; p0 += CAP) {
    const int m = min(CAP, n - p0);
    for (int e = threadIdx.x; e < m; e += THREADS) {
      const int g = p0 + e;
      int a = 0, b = span.y - 1;  // the last chunk with pre[c] <= g holds slot g
      while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (pre[mid] <= g) a = mid;
        else b = mid - 1;
      }
      const size_t at = stage + (size_t)a * CAP + first[a] + (g - pre[a]);
      sm.key[e] = (unsigned)(st_tgt[at] - lo);
      sm.val[e] = st_val[at];
      sm.inc[e] = crow ? (st_inc ? st_inc[at] : 1) : 0;
    }
    __syncthreads();
    sort_keys(sm.key, sm.pos, m, nbits, sm.tmp.sort);
    add_runs(sm, arow, crow, m);  // ends synchronised: the next piece reads after these writes
  }
}

template <class Src>
__global__ void __launch_bounds__(THREADS)
row_kernel(float* acc, int* cnt, Src src, int C, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PieceSmem& sm = *reinterpret_cast<PieceSmem*>(smem_raw);
  const int r = blockIdx.y;
  const unsigned lo = (unsigned)blockIdx.x * (unsigned)width;
  const unsigned lim = min((unsigned)width, (unsigned)(C - 1) - lo);
  const int n = compact(src, r, 0, lo, lim, 1, sm.key, nullptr, sm.val, sm.inc, sm.tmp.scan64);
  if (n == 0) return;
  sort_keys(sm.key, sm.pos, n, bits_for(lim - 1), sm.tmp.sort);
  add_runs(sm, acc + (size_t)r * C + lo, cnt ? cnt + (size_t)r * C + lo : nullptr, n);
}

// Sets `fn`'s dynamic shared-memory limit to SMEM_MAX, once per device.
// Every caller sets the same value, so two threads doing it at once agree.
cudaError_t smem_limit_once(const void* fn, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

std::atomic<unsigned long long> chunk_limit_set{0};
std::atomic<unsigned long long> apply_limit_set{0};
std::atomic<unsigned long long> row_limit_set{0};
std::atomic<unsigned long long> tile_chunk_limit_set{0};
std::atomic<unsigned long long> tile_row_limit_set{0};

// the checks both entries make of a layout's buckets
bool buckets_ok(int R, int C, int nb, int width) {
  return R <= 65535 && nb > 0 && nb <= MAX_BUCKETS && width > 0 && width <= (1 << MAX_WIDTH_BITS) &&
         (long long)nb * width >= C - 1 && (long long)(nb - 1) * width < C - 1 &&
         (long long)R * nb <= 0x7FFFFFFFll;
}

}  // namespace

// Launches the kernels on `stream` (PyTorch's current stream): R rows of C
// cells (the last one the overflow column), S slots a row (a multiple of
// 128), cnt/inc optional (both or neither). `chunks`, `nb` and `width` are
// the wrapper's layout (ops/ordered_scatter.py `layout`): CAP-slot chunks a
// window, buckets a row, cells a bucket; chunks == 0 (rows of at most CAP
// slots) takes row_kernel alone and no scratch. Otherwise `scratch` holds
// R*nb*chunks count words and then 2 (3 with cnt) planes of R*chunks*CAP
// staged slots, used by each window in turn. Returns the first
// cudaGetLastError() that is not 0 as an int; 0 means every launch was
// accepted.
extern "C" int es_ordered_scatter_add(void* acc, void* cnt, const void* tgt,
                                      const void* src, const void* inc, void* scratch,
                                      int R, int C, int S, int chunks, int nb,
                                      int width, void* stream) {
  if (R <= 0 || C <= 1 || S <= 0) return 0;
  if (S % 128 || (cnt == nullptr) != (inc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<float*>(acc);
  auto* ci = static_cast<int*>(cnt);
  auto* t = static_cast<const int*>(tgt);
  auto* s = static_cast<const float*>(src);
  auto* i = static_cast<const int*>(inc);
  const bool vec = !((reinterpret_cast<uintptr_t>(tgt) | reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(inc)) & 15);
  auto st = static_cast<cudaStream_t>(stream);
  if (!buckets_ok(R, C, nb, width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (chunks == 0) {
    if (S > CAP) return static_cast<int>(cudaErrorInvalidValue);
    err = smem_limit_once(reinterpret_cast<const void*>(&row_kernel<Planes>), row_limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    row_kernel<Planes><<<dim3(nb, R), THREADS, sizeof(PieceSmem), st>>>(a, ci, Planes{t, s, i, S, S, vec}, C,
                                                                        width);
    return static_cast<int>(cudaGetLastError());
  }
  if (chunks != min((int)(((long long)S + CAP - 1) / CAP), MAX_CHUNKS))
    return static_cast<int>(cudaErrorInvalidValue);
  err = smem_limit_once(reinterpret_cast<const void*>(&chunk_kernel<Planes>), chunk_limit_set);
  if (err == cudaSuccess)
    err = smem_limit_once(reinterpret_cast<const void*>(&apply_kernel), apply_limit_set);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t n_counts = (size_t)R * nb * chunks;
  const size_t n_stage = (size_t)R * chunks * CAP;
  auto* counts = static_cast<unsigned*>(scratch);
  auto* st_tgt = reinterpret_cast<int*>(counts + n_counts);
  auto* st_val = reinterpret_cast<float*>(st_tgt + n_stage);
  auto* st_inc = cnt ? reinterpret_cast<int*>(st_val + n_stage) : nullptr;
  // windows of `chunks` chunks, one after another on the stream: a window's
  // additions all land before the next window's begin
  const int window = chunks * CAP;
  for (int w0 = 0; w0 < S; w0 += window) {
    const int sw = min(window, S - w0);
    const int cw = (sw + CAP - 1) / CAP;
    const Planes planes{t + w0, s + w0, i ? i + w0 : nullptr, S, sw, vec};
    chunk_kernel<Planes><<<dim3(cw, R), THREADS, sizeof(ChunkSmem), st>>>(
        planes, st_tgt, st_val, st_inc, counts, C, cw, nb, width, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    apply_kernel<<<(unsigned)(R * nb), THREADS, apply_smem(cw), st>>>(
        a, ci, st_tgt, st_val, st_inc, counts, nullptr, C, cw, nb, width, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The BM25 tile add of one pass, on `stream`: acc (and cnt, optional) R rows
// of C cells (the last the overflow column); doc_ids and tfs the postings,
// [n_tiles, 128] int32; inv_norm C-1 floats; `plan` the pass, int32 words
// off[R+1] (each row's first tile in the list), coff[R+1] (its first chunk),
// tiles[T], then the tiles' float weights[T]. `window`, `nb` and `width` are
// the wrapper's layout (ops/ordered_scatter.py `tile_layout`): chunks a
// window, buckets a row, cells a bucket. window == 0 (rows of at most CAP
// slots) takes row_kernel alone and no scratch; otherwise the pass's
// `chunks` chunks are taken in windows of `window`, one after another, over
// `scratch`: nb*window count words and 2 planes of window*CAP staged slots.
// Returns the first cudaGetLastError() that is not 0 as an int.
extern "C" int es_bm25_tile_add(void* acc, void* cnt, const void* doc_ids, const void* tfs,
                                const void* inv_norm, const void* plan, void* scratch, int R, int C,
                                int T, int chunks, int window, int nb, int width, void* stream) {
  if (R <= 0 || C <= 1 || T <= 0) return 0;
  if (!buckets_ok(R, C, nb, width) || window < 0 || window > MAX_CHUNKS || (window > 0) != (chunks > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<float*>(acc);
  auto* ci = static_cast<int*>(cnt);
  auto* words = static_cast<const int*>(plan);
  const bool vec = !((reinterpret_cast<uintptr_t>(doc_ids) | reinterpret_cast<uintptr_t>(tfs)) & 15);
  const Tiles src{static_cast<const int*>(doc_ids), static_cast<const int*>(tfs),
                  static_cast<const float*>(inv_norm), words + 2 * (R + 1),
                  reinterpret_cast<const float*>(words + 2 * (R + 1) + T), words, words + R + 1, R, vec};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (window == 0) {
    err = smem_limit_once(reinterpret_cast<const void*>(&row_kernel<Tiles>), tile_row_limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    row_kernel<Tiles><<<dim3(nb, R), THREADS, sizeof(PieceSmem), st>>>(a, ci, src, C, width);
    return static_cast<int>(cudaGetLastError());
  }
  err = smem_limit_once(reinterpret_cast<const void*>(&chunk_kernel<Tiles>), tile_chunk_limit_set);
  if (err == cudaSuccess)
    err = smem_limit_once(reinterpret_cast<const void*>(&apply_kernel), apply_limit_set);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto* counts = static_cast<unsigned*>(scratch);
  auto* st_tgt = reinterpret_cast<int*>(counts + (size_t)nb * window);
  auto* st_val = reinterpret_cast<float*>(st_tgt + (size_t)window * CAP);
  // windows of the pass's chunks, rows end to end, one after another on the
  // stream: a row's chunks keep their order across windows
  for (int g0 = 0; g0 < chunks; g0 += window) {
    const int g1 = min(g0 + window, chunks);
    chunk_kernel<Tiles><<<(unsigned)(g1 - g0), THREADS, sizeof(ChunkSmem), st>>>(
        src, st_tgt, st_val, nullptr, counts, C, g1 - g0, nb, width, g0, g1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    apply_kernel<<<(unsigned)(R * nb), THREADS, apply_smem(g1 - g0), st>>>(
        a, ci, st_tgt, st_val, nullptr, counts, src.coff, C, g1 - g0, nb, width, g0, g1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
