// int8 brute-force vector scoring for NVIDIA Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel `elasticsearch_tpu/ops/pallas_knn.py:_score_kernel`
// (launched by `int8_dot_scores`): dequantised dot products
//
//     out[b, n] = (sum_d q[b, d] * float(v[n, d])) * scale[n]
//
// with f32 queries, an int8 corpus, f32 accumulation and the per-vector scale
// applied in the epilogue: the function of the Pallas kernel and of the plain
// PyTorch version `int8_dot_scores_plain`.
//
// Why bf16 tensor cores compute it exactly:
//  - every int8 value is exact in bf16 (8 significant bits);
//  - every finite f32 q with |q| <= 3.39e38 (the largest bf16) is the exact
//    sum of three bf16 values: hi = bf16_rn(q), mid = bf16_rn(q - hi),
//    lo = bf16_rn(q - hi - mid). Both subtractions are exact in f32 (each
//    residual fits in the bits that rounding left over), and 8 + 8 + 8
//    significant bits cover f32's 24. Only where the lo part falls below
//    bf16's normal range (|q| under about 2^-110) may it lose bits, at an
//    absolute cost below 2^-133 per element;
//  - a bf16 x bf16 product is exact in f32, so the three passes hi, mid and
//    lo into one f32 accumulator differ from an f32 product only in the order
//    and rounding of the f32 sums (144 accumulator steps per output at d=768).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 700 W):
// at B=32 queries, N=1,000,448 docs, d=768 the function moves 900,501,504
// bytes (queries 98 KB, int8 rows 768 MB, scales 4 MB, f32 output 128 MB):
// 0.269 ms. The three passes are 3 * 2*B*N*d = 147.6 GFLOP of tensor-core
// work, 0.149 ms. So it is bound by bytes: 192 tensor operations per int8
// byte at B=32 sit under the card's bf16 ridge of about 295.
//
// Roles and fragments (PTX ISA, mma.sync.aligned.m16n8k16.row.col f32.bf16):
//  - docs are the M operand: m16 tiles of int8 rows, already K-contiguous;
//  - queries are the N operand: n8 tiles, `col` = [query][k], held in shared
//    memory as three bf16 panels (hi, mid, lo) for a chunk of QB queries;
//  - lane = 4*g + t. A fragment slots: a0 = (row g, k 2t..2t+1), a1 = (row
//    g+8, k 2t..2t+1), a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, k 2t+8..9);
//    B: b0 = (n g, k 2t..2t+1), b1 = (n g, k 2t+8..2t+9); C: c0,c1 = (row g,
//    n 2t..2t+1), c2,c3 = (row g+8, n 2t..2t+1).
//
// The k-permutation. The sum over k does not depend on its order as long as
// A and B use the same one. In k16 step s (0..3) of the 64-wide chunk c,
// thread (g, t) holds the physical k values
//
//     64c + 16t + 4s + {0, 1, 2, 3}   in the slots   {2t, 2t+1, 2t+8, 2t+9}.
//
// So one 16-byte global load of doc row g (bytes 64c + 16t .. +15) feeds all
// four k16 steps of the chunk: its 32-bit word s holds a0 (bytes 0,1) and a2
// (bytes 2,3) of step s; row g+8 gives a1 and a3. A warp load reads 8 rows x
// 64 contiguous bytes, whole sectors, and the corpus never passes through
// shared memory. The B fragment of n-tile j is then 32 contiguous bytes of
// query row 8j+g, read as two 16-byte shared loads (steps 0-1 and 2-3). Each
// query row is padded by 16 bytes so the 8 rows g of a load fall on distinct
// banks (d=768 rows are 1536 bytes, a multiple of 128). A tail chunk (d % 64
// != 0, d % 16 == 0) loads zeros for the missing lanes; the query panels are
// zero up to the padded width, so nothing undefined is multiplied.
//
// Design:
//  - persistent blocks, one per SM (gridDim.x), 8 warps each; gridDim.y walks
//    query chunks of QB (32, 16 or 8: the wrapper picks the one that fits the
//    3 * QB * (d_pad + 8) * 2 bytes of dynamic shared memory). Query rows
//    beyond B are zeros in shared memory and are never stored;
//  - each block splits and stages its query chunk once, then every warp walks
//    its own doc tiles of 64 rows (4 m16 tiles) x QB queries (QB/8 n8 tiles):
//    up to 64 f32 accumulators a thread;
//  - int8 -> bf16 without a conversion unit, two values at a time: a byte
//    permute spreads two bytes into the two 16-bit halves, two logic ops put
//    the low 7 bits under the exponent of 128 and the sign bit under that of
//    -128 / -256, and one bf16x2 FMA adds them (exact): 4 ops per 2 bytes;
//  - the next chunk's 16-byte corpus loads are issued before the current
//    chunk's MMAs (128 bytes a thread, 32 KB a block in flight);
//  - the tensor cores sum each 64-wide chunk (12 MMAs per output) from zero,
//    and the chunk sums are added in f32 registers: chained through all of d
//    inside the tensor cores, the sums drifted past 1e-5 of max|dots| at
//    d=4096 on an H100 (tests/test_torch_cuda.py, B=9, N=700);
//  - the ragged doc tail is masked on load and on store, so N needs no
//    padding; the epilogue multiplies by scale[doc] and stores out[b, doc]:
//    8 consecutive docs of one query per store group, whole 32-byte sectors.
//
// What would come next if it stays under half its bound: `wgmma` with the
// converted corpus tile as A from registers and the query panels as B in
// shared memory (the full tensor-core rate instead of mma.sync's), and TMA
// for the query panel and the corpus stream, freeing the registers that
// double-buffer the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 64;          // k per chunk: one 16-byte load a row a thread
constexpr int MT = 4;           // m16 tiles per warp: 64 docs
constexpr int DOCS_PER_WARP = 16 * MT;
constexpr int ROW_PAD = 8;      // bf16 elements (16 bytes) after each query row

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// Two int8 of `w`, picked by the byte permute `sel` into the low bytes of
// two 16-bit halves, -> one packed bf16x2. With a = x & 127, the half
// 0x4300 | a is the bf16 of 128 + a, and 0xC300 | (x & 128) that of -128, or
// of -256 when x < 0; their sum, x, is exact in bf16.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0u, sel);
  const uint32_t h = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (p & 0x00800080u) | 0xC300C300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(h), "r"(0x3F803F80u), "r"(s));
  return r;  // h * 1.0 + s
}

// Four int8 in `w` (little-endian) -> two packed bf16x2: (b0, b1) and (b2, b3).
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  lo = int8x2_to_bf16x2(w, 0x4140);
  hi = int8x2_to_bf16x2(w, 0x4342);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT n8 tiles of queries: QB = 8 * NT.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
int8_dot_scores_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ scales,
                       float* __restrict__ out,
                       int B, int N, int D) {
  constexpr int QB = 8 * NT;
  extern __shared__ __align__(16) uint16_t qs[];  // [3][QB][stride] bf16 bits

  const int dpad = (D + KC - 1) / KC * KC;
  const int stride = dpad + ROW_PAD;
  const int panel = QB * stride;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);

  // ---- split the query chunk into hi / mid / lo bf16 panels, once ----
  {
    const int quads = dpad / 4;
#pragma unroll 8
    for (int i = threadIdx.x; i < QB * quads; i += THREADS) {
      const int row = i / quads;
      const int k = (i - row * quads) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < nq && k < D)  // D % 16 == 0: a quad is whole or absent
        x = __ldg(reinterpret_cast<const float4*>(q + (size_t)(b0 + row) * D + k));
      float r[4] = {x.x, x.y, x.z, x.w};
      uint32_t part[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          part[p][e] = bf16_bits(r[e]);
          r[e] -= __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(part[p][e])));
        }
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint2 pk;
        pk.x = part[p][0] | (part[p][1] << 16);
        pk.y = part[p][2] | (part[p][3] << 16);
        *reinterpret_cast<uint2*>(qs + p * panel + row * stride + k) = pk;
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntiles = (N + DOCS_PER_WARP - 1) / DOCS_PER_WARP;
  const int nchunks = dpad / KC;
  const int wstride = gridDim.x * WARPS;
  int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= ntiles) return;

  // raw[i][h]: 16 bytes of doc row tile*64 + 16i + g + 8h at k = 64c + 16t
  int4 raw[MT][2];
  float sc[MT][2];
  auto load_chunk = [&](int tl, int c) {
    const int k = c * KC + 16 * t;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int doc = tl * DOCS_PER_WARP + 16 * i + 8 * h + g;
        raw[i][h] = (doc < N && k < D)
            ? __ldg(reinterpret_cast<const int4*>(v + (size_t)doc * D + k))
            : make_int4(0, 0, 0, 0);
      }
    }
  };
  auto load_scales = [&](int tl) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int doc = tl * DOCS_PER_WARP + 16 * i + 8 * h + g;
        sc[i][h] = doc < N ? __ldg(scales + doc) : 0.f;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_chunk(tile, 0);
  int c = 0;
  while (true) {
    // convert this chunk's corpus bytes into A fragments: afr[i][s]
    uint32_t afr[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t w0[4] = {(uint32_t)raw[i][0].x, (uint32_t)raw[i][0].y,
                              (uint32_t)raw[i][0].z, (uint32_t)raw[i][0].w};
      const uint32_t w1[4] = {(uint32_t)raw[i][1].x, (uint32_t)raw[i][1].y,
                              (uint32_t)raw[i][1].z, (uint32_t)raw[i][1].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int8x4_to_bf16(w0[s], afr[i][s][0], afr[i][s][2]);
        int8x4_to_bf16(w1[s], afr[i][s][1], afr[i][s][3]);
      }
    }
    const bool last = c == nchunks - 1;
    if (last) load_scales(tile);
    // issue the next chunk's loads before this chunk's MMAs
    int next_tile = tile, next_c = c + 1;
    if (last) {
      next_tile += wstride;
      next_c = 0;
    }
    const bool more = next_tile < ntiles;
    if (more) load_chunk(next_tile, next_c);

    // the tensor cores sum this chunk's 12 products per output (4 k16 steps
    // x 3 parts) from zero; acc adds the chunk sums in f32 registers
    const uint16_t* qrow = qs + g * stride + c * KC + 16 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float part[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
#pragma unroll
        for (int p = 2; p >= 0; --p) {  // lo, mid, hi: small terms first
          const uint4 bq = *reinterpret_cast<const uint4*>(
              qrow + p * panel + 8 * j * stride + 8 * sp);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(part[i], afr[i][2 * sp], bq.x, bq.y);
            mma_bf16(part[i], afr[i][2 * sp + 1], bq.z, bq.w);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][e];
    }

    if (last) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int doc = tile * DOCS_PER_WARP + 16 * i + 8 * h + g;
          if (doc < N) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int b = 8 * j + 2 * t + e;
                if (b < nq) out[(size_t)(b0 + b) * N + doc] = acc[i][j][2 * h + e] * sc[i][h];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[i][j][2 * h] = 0.f;
            acc[i][j][2 * h + 1] = 0.f;
          }
        }
      }
    }
    if (!more) break;
    tile = next_tile;
    c = next_c;
  }
}

template <int NT>
int launch(const float* q, const int8_t* v, const float* scales, float* out,
           int B, int N, int D, int num_sms, cudaStream_t stream) {
  const int dpad = (D + KC - 1) / KC * KC;
  const size_t smem = (size_t)3 * 8 * NT * (dpad + ROW_PAD) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      int8_dot_scores_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (N + DOCS_PER_WARP - 1) / DOCS_PER_WARP;
  const int blocks = std::min(num_sms, (ntiles + WARPS - 1) / WARPS);
  dim3 grid(blocks, (B + 8 * NT - 1) / (8 * NT));
  int8_dot_scores_kernel<NT><<<grid, THREADS, smem, stream>>>(
      q, v, scales, out, B, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) with `num_sms` persistent
// blocks per query chunk of `qb` (8, 16 or 32) queries, and returns the
// launch's cudaGetLastError() as an int; 0 means the launch was accepted.
extern "C" int es_int8_dot_scores(const void* q, const void* v,
                                  const void* scales, void* out, int B, int N,
                                  int D, int num_sms, int qb, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (num_sms <= 0 || D <= 0 || D % 16) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* vi = static_cast<const int8_t*>(v);
  const auto* sf = static_cast<const float*>(scales);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 32: return launch<4>(qf, vi, sf, of, B, N, D, num_sms, st);
    case 16: return launch<2>(qf, vi, sf, of, B, N, D, num_sms, st);
    case 8: return launch<1>(qf, vi, sf, of, B, N, D, num_sms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
