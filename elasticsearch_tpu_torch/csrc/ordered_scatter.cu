// Ordered tile scatter-add for NVIDIA Hopper (sm_90a).
//
//     for s in 0 .. S-1:  acc[r, tgt[r, s]] += src[r, s]     (every row r)
//     and, when cnt is given, cnt[r, tgt[r, s]] += inc[r, s] in the same pass
//
// with each f32 cell receiving its contributions one after another in slot
// order, starting from its current value: the bits of a sequential scatter,
// of `ops/ordered_scatter.py:ordered_scatter_add_plain` on the CPU, of the
// JAX package's `.at[].add` on the CPU and of the numpy oracle's `np.add.at`.
// `scatter_add_` / `index_add_` on the card sum with float atomics instead, so
// a doc's last ulp changed from run to run; this kernel has no float atomics
// and its result does not depend on timing.
//
// Replaces no TPU kernel: the JAX package leaves every BM25 and sparse
// accumulation to XLA's scatter (`.at[].add`). It exists for that order.
//
// The invariant it relies on. The slots come in tiles of 128 (one postings
// tile: `ops/scoring.py` TILE_WIDTH, `ops/impact.py` TILE_WIDTH) and within
// one tile the valid targets are distinct, because a doc occurs at most once
// in a term's postings. Invalid slots target the overflow column C-1 with
// +0.0 and inc 0; they are not applied (the column keeps its value, which
// adding +0.0 to a +0.0 column would not change either). Targets outside
// [0, C-1) are not applied.
//
// Design (a simple kernel that is right):
//  - grid (doc ranges, rows); a block owns the cells [lo, hi) of its row, so
//    no other block ever touches them;
//  - the block copies acc[r, lo:hi) into shared memory (cp.async, 16 bytes a
//    thread where the row is aligned), walks the row's tiles in order, and
//    each of its 128 threads applies the one slot of the tile whose target
//    falls in [lo, hi). Targets are distinct within a tile, so no two threads
//    write one cell; a __syncthreads() between tiles keeps the tile order;
//  - the int32 plane needs no order (integer sums are exact in any order):
//    its adds go straight to global memory as integer atomics on the block's
//    own cells;
//  - the next BATCH tiles' slots are loaded into registers while the current
//    ones are applied, then the block writes its slice back.
//
// What bounds it on an H100 SXM (3.35 TB/s, 700 W). The function must read
// tgt and src (and inc) once and read and write each cell it touches: at
// route (f)'s chunk (32 rows, 65,536 slots a row, 1M docs) that is some
// 25-40 MB, 8-12 us, so it is bound by bytes. This design moves more: every
// range re-reads its row's slots (from L2: R x ranges x S x 8 bytes) and
// copies its whole slice in and out (2 x R x C x 4 bytes, 256 MB at 32 x 1M),
// and a tile costs a barrier. The wrapper sizes the ranges to the largest
// shared slice a block may hold (232,448 bytes), which balances the slice
// copy against the slot re-reads at the main path's shapes. PERF.md holds its
// measured times; making it faster is later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // slots per postings tile = threads per block
constexpr int BATCH = 8;   // tiles whose slots are in flight ahead of their turn
// the dynamic shared memory a Hopper block may use; the kernel's limit is
// set to it once for all, since a limit set to each launch's own size
// would race with another thread's launch of a larger slice
constexpr int SMEM_MAX = 232448;

struct Slots {
  int tgt[BATCH];
  float val[BATCH];
  int inc[BATCH];
};

__device__ __forceinline__ void load_slots(Slots& s, const int* __restrict__ trow,
                                           const float* __restrict__ srow,
                                           const int* __restrict__ irow, int t0,
                                           int n_tiles) {
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int t = t0 + u;
    if (t < n_tiles) {
      const size_t i = (size_t)t * TILE + threadIdx.x;
      s.tgt[u] = __ldg(trow + i);
      s.val[u] = __ldg(srow + i);
      s.inc[u] = irow ? __ldg(irow + i) : 0;
    } else {
      s.tgt[u] = -1;
      s.val[u] = 0.f;
      s.inc[u] = 0;
    }
  }
}

__global__ void __launch_bounds__(TILE)
ordered_scatter_kernel(float* __restrict__ acc, int* __restrict__ cnt,
                       const int* __restrict__ tgt, const float* __restrict__ src,
                       const int* __restrict__ inc, int C, int S, int span) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.y;
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, C - 1);  // the overflow column is never applied
  const int width = hi - lo;
  float* arow = acc + (size_t)row * C + lo;

  // slice[i] holds arow[i]; it starts `mis` floats into smem so that the
  // first 16-byte-aligned element of the row and its shared copy line up
  const int mis = (int)((reinterpret_cast<uintptr_t>(arow) >> 2) & 3);
  const int head = min((4 - mis) & 3, width);
  const int nvec = (width - head) >> 2;
  float* slice = smem + mis;
  const float4* gvec = reinterpret_cast<const float4*>(arow + head);
  float4* svec = reinterpret_cast<float4*>(slice + head);
  for (int i = threadIdx.x; i < nvec; i += TILE) __pipeline_memcpy_async(svec + i, gvec + i, 16);
  __pipeline_commit();
  for (int i = threadIdx.x; i < head; i += TILE) slice[i] = arow[i];
  for (int i = head + 4 * nvec + threadIdx.x; i < width; i += TILE) slice[i] = arow[i];
  __pipeline_wait_prior(0);
  __syncthreads();

  const int* trow = tgt + (size_t)row * S;
  const float* srow = src + (size_t)row * S;
  const int* irow = inc ? inc + (size_t)row * S : nullptr;
  int* crow = cnt ? cnt + (size_t)row * C + lo : nullptr;
  const int n_tiles = S / TILE;
  Slots cur, next;
  load_slots(cur, trow, srow, irow, 0, n_tiles);
  for (int t0 = 0; t0 < n_tiles; t0 += BATCH) {
    load_slots(next, trow, srow, irow, t0 + BATCH, n_tiles);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int d = cur.tgt[u] - lo;
      if ((unsigned)d < (unsigned)width) {
        slice[d] += cur.val[u];
        if (crow) atomicAdd(crow + d, cur.inc[u]);
      }
      __syncthreads();  // tile t's adds land before tile t+1's
    }
    cur = next;
  }

  for (int i = threadIdx.x; i < nvec; i += TILE) reinterpret_cast<float4*>(arow + head)[i] = svec[i];
  for (int i = threadIdx.x; i < head; i += TILE) arow[i] = slice[i];
  for (int i = head + 4 * nvec + threadIdx.x; i < width; i += TILE) arow[i] = slice[i];
}

}  // namespace

// Launches on `stream` (PyTorch's current stream): R rows of C cells (the
// last one the overflow column), S slots a row (a multiple of 128), ranges of
// `span` cells, cnt/inc optional (both or neither). Returns the launch's
// cudaGetLastError() as an int; 0 means the launch was accepted.
extern "C" int es_ordered_scatter_add(void* acc, void* cnt, const void* tgt,
                                      const void* src, const void* inc, int R,
                                      int C, int S, int span, void* stream) {
  if (R <= 0 || C <= 1 || S <= 0) return 0;
  if (S % TILE || span <= 0 || R > 65535 || (cnt == nullptr) != (inc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(span + 4) * sizeof(float);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ordered_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C - 1 + span - 1) / span, R);
  ordered_scatter_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(acc), static_cast<int*>(cnt), static_cast<const int*>(tgt),
      static_cast<const float*>(src), static_cast<const int*>(inc), C, S, span);
  return static_cast<int>(cudaGetLastError());
}
