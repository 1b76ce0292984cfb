// The weight-only int8 product of the decode on Hopper (sm_90a):
//   out[m, n] = bf16(f32(sum_k x[m, k] * q[k, n]) * scale[n])
// with x [M, K] bf16 and the int8 kernel q [K, N] stored column-major (each
// output channel's K values contiguous: ops/quantization.py::
// int8_kernel_layout), read once a call and never copied to bf16.
//
// Replaces the weight-only branch of the JAX package's dense
// (certifiedgpt_tpu/models/layers.py:61-76): einsum(x, kernel_q.astype(bf16),
// preferred_element_type=f32) * scale, where XLA feeds the int8 -> bf16
// convert straight into the matrix unit. Each int8 value becomes bf16 in
// registers (exact: |q| <= 128) and is multiplied on the tensor cores by
// mma.sync.m16n8k16 (bf16 in, f32 accumulation), so the products are exact
// and only the order of the f32 sums differs from the plain version's
// (ops/quantization.py::_int8_weight_forward_plain).
//
// Bound on the H100: bytes at the decode's rows (M <= 96: 202 MB of int8
// weights a decoder layer, 0.06 ms at 3.35 TB/s, against 0.04 ms for its
// 39 GFLOP at the bf16 peak: near the ridge at M = 96); operations at the
// prefill's M = 9216. Design:
// - The product is computed transposed, out^T = q^T x^T: the column-major
//   int8 kernel is the K-major A operand, so output channels fill the
//   instruction's 16 rows and the M rows of x its 8-wide columns, in
//   8-row steps (MT of them: instances for 1, 2, 4, 8, 12 and 16). No
//   warp rows sit idle at M = 96, and M = 1 costs an 8-row column.
// - A block owns 128 channels (four warps of 32: two A fragments against
//   each of the MT x fragments) and walks K in tiles of 64 through a ring
//   of cp.async stages in shared memory, as deep as ~110 KB allows (8
//   stages at M <= 16, 4 at 96, 3 at 128), two blocks an SM;
//   a thread's copy addresses are worked out once, and each weight copy
//   asks the L2 for its whole 128-byte line (the channel's next K tile).
//   Tile rows are padded (weights to 80 bytes, x to 160) so that fragment
//   reads are free of bank conflicts; K is permuted inside each 16-wide
//   step so that a thread reads four weight bytes as one word and four x
//   values as one 8-byte word, the same permutation in A and B.
// - The conversion takes no I2F: a byte, offset to unsigned, becomes the
//   low mantissa byte of the f32 2^23 + u by a byte permute, one f32
//   subtraction of 2^23 + 128 leaves its value, and the bf16 is the f32's
//   upper half (two values a permute): 11 instructions for four bytes.
// - Where the output tiles alone leave the card's blocks idle, K is split
//   over a cluster of 2 or 3 blocks (blockIdx.z, cluster dims (1, 1,
//   splits)): each block leaves its f32 partial tile in its own shared
//   memory, and after a cluster barrier each block sums a share of the
//   tile's outputs over the blocks' partials, read through distributed
//   shared memory in split order, so the result does not depend on the
//   order the blocks ran in. No partials go to device memory and no counter
//   needs zeroing: a launch is one kernel and no memset, on any stream and
//   inside a CUDA graph. Reading partials from other SMs is slow (a tile
//   split 8 ways spent more on the exchange than on its products), so the
//   launcher splits at most 3 ways.
// - The output is staged through shared memory and written 16 bytes a
//   thread (N % 8 == 0).
// What holds it back (scripts/bench_torch_int8_ops.py): the weight stream
// itself, at about half the card's rate with a few blocks an SM, and at
// M = 96 the mma.sync issue and its latency on four warps a block.
//
// The f32 instance (f32 x and output: the tiny and f32 configurations) is
// the same kernel with x as three bf16 terms: hi = x truncated to bf16 (the
// low 16 bits masked off), mid = (x - hi) truncated, lo = x - hi - mid, each
// subtraction exact, so hi + mid + lo = x (8 significant bits a term). An
// int8 weight is exact in bf16, so three mma.sync products with f32
// accumulation give the f32 product; the weight fragment is converted once
// for the three. The tensor cores truncate their sums to the largest
// addend's exponent, so each 16-wide step's three products are summed from
// zero and then added to the accumulator by an IEEE addition (summed into
// the accumulator itself, K = 11008 rows came out 3.3e-5 off cuBLAS's f32
// product, relative Frobenius, H100). x stays f32 in the ring and is split in registers; 64 rows
// a block at most (three stages in ~110 KB). Below |x| = 2^-110, lo lies in
// bf16's subnormals and loses what is under 2^-133; an infinite x is its own
// hi. Bound at [96, 4096] x [4096, 4096]: the three bf16 products' 9.66
// GFLOP at the bf16 peak, 0.0098 ms (f32 FMAs: 3.22 GFLOP, 0.048 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;               // a warp owns 32 output channels
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 32 * kWarps;        // output channels a block (128)
constexpr int kBK = 64;                 // K values a stage
constexpr int kWStride = kBK + 16;      // bytes a channel of the weight tile (80)
constexpr int kPStride = kBN + 4;       // floats a row of the partial tile
// the most K splits (a cluster): beyond 3 the exchange of partials costs
// more than the extra blocks add (scripts/bench_torch_int8_ops.py)
constexpr int kMaxSplits = 3;
constexpr int kRingBytes = 110 * 1024;  // two blocks an SM

// the 8-row steps of the instances, and the most rows a block takes
constexpr int kMTs[] = {1, 2, 4, 8, 12, 16};
constexpr int kInstances = sizeof(kMTs) / sizeof(kMTs[0]);

// x's side of an instance (X: x's and the output's dtype): bf16 terms a
// value, bytes a row of the x tile (padded: fragment reads free of bank
// conflicts), the most rows a block takes.
template <typename X>
struct Side {
  static constexpr bool kF32 = sizeof(X) == 4;
  static constexpr int kTerms = kF32 ? 3 : 1, kXStride = kF32 ? 4 * kBK + 64 : 2 * kBK + 32,
                       kMaxRows = kF32 ? 64 : 128;
};

template <int MT, typename X = __nv_bfloat16>
struct Tile {
  static constexpr int kRows = 8 * MT;
  static constexpr int kWBytes = kBN * kWStride;
  static constexpr int kStageBytes = kWBytes + kRows * Side<X>::kXStride;
  static constexpr int kStages = kRingBytes / kStageBytes > 8 ? 8 : kRingBytes / kStageBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPartial = kRows * kPStride * 4;
  static constexpr int kSmem = kRing > kPartial ? kRing : kPartial;
  static_assert(kStages >= 3, "the ring needs three stages");
};

template <typename X>
struct Args {
  const X* x;
  long long ldx;  // elements
  const int8_t* w;
  long long ldw;  // bytes between channels
  const float* scale;
  X* out;
  long long ldo;  // elements
  int M, N, K;
  int k_per_split;  // a multiple of kBK
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// the same, the L2 fetching the whole 128-byte line around it (a weight
// channel's next K tile, 64 bytes on)
__device__ __forceinline__ void cp_async16_line(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four signed bytes -> two bf16 pairs (bytes 0-1 in `lo`, 2-3 in `hi`, the
// lower byte in the lower half), exact and without I2F: the byte offset to
// unsigned is the low mantissa byte of the f32 2^23 + u, 2^23 + 128 is
// subtracted, and the bf16 is the f32's upper half.
__device__ __forceinline__ void bf16x4_of(uint32_t w, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kOffset = 8388736.f;      // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7440)) - kOffset;
  const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7441)) - kOffset;
  const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7442)) - kOffset;
  const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7443)) - kOffset;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The cluster's barrier: every block's earlier shared-memory writes are
// seen by the others' later reads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// 16 bytes of block `rank`'s shared memory at the offset of `local` in ours
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four x values at K offset 4t of a 16-wide step (a row of the x tile):
// the B fragment's registers of each term, bf16 x as it is, f32 x as its
// three bf16 terms, smallest first (an x with nothing below hi: mid = lo = 0).
template <typename X>
__device__ __forceinline__ void x_frags(const unsigned char* at,
                                        uint32_t (&b)[Side<X>::kTerms][2]) {
  if constexpr (!Side<X>::kF32) {
    const uint2 xb = *reinterpret_cast<const uint2*>(at);
    b[0][0] = xb.x;
    b[0][1] = xb.y;
  } else {
    const float4 xv = *reinterpret_cast<const float4*>(at);
    const float x[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t t[3][4];  // lo, mid and hi of each value
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[2][i] = __float_as_uint(x[i]) & 0xFFFF0000u;
      const float hi = __uint_as_float(t[2][i]);
      const float r = hi == x[i] ? 0.f : __fsub_rn(x[i], hi);
      t[1][i] = __float_as_uint(r) & 0xFFFF0000u;
      t[0][i] = __float_as_uint(__fsub_rn(r, __uint_as_float(t[1][i])));
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      b[e][0] = __byte_perm(t[e][0], t[e][1], 0x7632);
      b[e][1] = __byte_perm(t[e][2], t[e][3], 0x7632);
    }
  }
}

// Eight scaled sums of a row's neighbouring channels stored in x's dtype.
template <typename X>
__device__ __forceinline__ void store8(X* out, const float (&s)[8], const float* scale) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(s[e], scale[e]);
  if constexpr (Side<X>::kF32) {
    reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      o[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// A thread's share of each stage's copies, its addresses worked out once:
// the weight chunks (16 bytes of a channel) and x chunks (16 bytes of a row)
// it copies at every K tile; channels past N and rows past M are not loaded
// (they only reach outputs that are never stored).
template <int MT, typename X>
struct Copies {
  static constexpr int kXChunk = 16 / static_cast<int>(sizeof(X));  // x values a chunk
  static constexpr int kW = kBN * (kBK / 16) / kThreads;
  static constexpr int kX = (Tile<MT, X>::kRows * (kBK / kXChunk) + kThreads - 1) / kThreads;
  const int8_t* w[kW];
  const X* x[kX];
  uint32_t w_dst[kW], x_dst[kX];  // offsets in a stage
  int w_k[kW], x_k[kX];           // K offsets in a tile

  __device__ __forceinline__ Copies(const Args<X>& a, int m0, int n0) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int n = c / (kBK / 16), part = c % (kBK / 16);
      w[i] = n0 + n < a.N ? a.w + (n0 + n) * a.ldw + 16 * part : nullptr;
      w_dst[i] = n * kWStride + 16 * part;
      w_k[i] = 16 * part;
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kBK / kXChunk), part = c % (kBK / kXChunk);
      x[i] = r < Tile<MT, X>::kRows && m0 + r < a.M ? a.x + (m0 + r) * a.ldx + kXChunk * part
                                                     : nullptr;
      x_dst[i] = Tile<MT, X>::kWBytes + r * Side<X>::kXStride + 16 * part;
      x_k[i] = kXChunk * part;
    }
  }

  // Starts the copies of the K tile at k0 (clipped to k_end, the rest
  // zeros) into the stage at shared address `stage`.
  __device__ __forceinline__ void issue(uint32_t stage, int k0, int k_end) const {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if (w[i] == nullptr) continue;
      const bool in = k0 + w_k[i] < k_end;
      cp_async16_line(stage + w_dst[i], w[i] + (in ? k0 : 0), in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      if (x[i] == nullptr) continue;
      const bool in = k0 + x_k[i] < k_end;
      cp_async16(stage + x_dst[i], x[i] + (in ? k0 : 0), in ? 16 : 0);
    }
  }
};

template <int MT, typename X>
__global__ void __launch_bounds__(kThreads, 2) int8_weight_matmul_kernel(const Args<X> a) {
  using T = Tile<MT, X>;
  constexpr int kTerms = Side<X>::kTerms, kXStride = Side<X>::kXStride;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * T::kRows;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;  // at least 1: the plan has no empty split

  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const Copies<MT, X> copies(a, m0, n0);
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < tiles) copies.issue(base + s * T::kStageBytes, k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int next = kt + T::kStages - 1;
    if (next < tiles) {
      copies.issue(base + (next % T::kStages) * T::kStageBytes, k_begin + next * kBK, k_end);
    }
    cp_async_commit();
    const unsigned char* wt = smem + (kt % T::kStages) * T::kStageBytes + (32 * warp) * kWStride;
    const unsigned char* xt = smem + (kt % T::kStages) * T::kStageBytes + T::kWBytes;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      // A: channels g and g + 8 of each 16-channel half, k = 4t .. 4t + 3
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t w_lo =
            *reinterpret_cast<const uint32_t*>(wt + (16 * i + g) * kWStride + k16 + 4 * t);
        const uint32_t w_hi =
            *reinterpret_cast<const uint32_t*>(wt + (16 * i + g + 8) * kWStride + k16 + 4 * t);
        bf16x4_of(w_lo, af[i][0], af[i][2]);
        bf16x4_of(w_hi, af[i][1], af[i][3]);
      }
      // B: row g of each 8-row step of x, the same k, each term in turn
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t xb[kTerms][2];
        x_frags<X>(xt + (8 * j + g) * kXStride + sizeof(X) * (k16 + 4 * t), xb);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (kTerms == 1) {
            mma_bf16(acc[i][j], af[i], xb[0][0], xb[0][1]);
          } else {
            // the step's three products summed apart, then added in IEEE
            // order: the tensor cores truncate a sum to the exponent of
            // its largest addend, which the whole accumulator would be
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int e = 0; e < kTerms; ++e) mma_bf16(part, af[i], xb[e][0], xb[e][1]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = __fadd_rn(acc[i][j][c], part[c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the partial tile takes its place

  // this block's f32 partial tile [rows][channels]: a fragment's rows are
  // channels, its columns rows of x
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ch = 32 * warp + 16 * i + g;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = 8 * j + 2 * t;
      part[m * kPStride + ch] = acc[i][j][0];
      part[(m + 1) * kPStride + ch] = acc[i][j][1];
      part[m * kPStride + ch + 8] = acc[i][j][2];
      part[(m + 1) * kPStride + ch + 8] = acc[i][j][3];
    }
  }
  cluster_sync();  // every split's partial tile is in place

  // block q of the cluster sums the outputs u = q, q + splits, ... of the
  // tile (8 neighbouring channels of one row) over the splits in order
  const int splits = static_cast<int>(cluster_blocks());
  const int units = min(T::kRows, a.M - m0) * (kBN / 8);
  for (int u = static_cast<int>(cluster_rank()) + splits * static_cast<int>(threadIdx.x);
       u < units; u += splits * kThreads) {
    const int r = u / (kBN / 8), c = u % (kBN / 8);
    const int n = n0 + 8 * c;
    if (n >= a.N) continue;  // N % 8 == 0: a unit is whole or out
    // every split's 8 partials read at once (all in flight), then added in
    // split order
    const uint32_t mine = smem_u32(part + r * kPStride + 8 * c);
    float4 v[kMaxSplits][2];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        v[q][0] = ld_cluster_f4(mine, q);
        v[q][1] = ld_cluster_f4(mine + 16, q);
      }
    }
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        s[0] = __fadd_rn(s[0], v[q][0].x);
        s[1] = __fadd_rn(s[1], v[q][0].y);
        s[2] = __fadd_rn(s[2], v[q][0].z);
        s[3] = __fadd_rn(s[3], v[q][0].w);
        s[4] = __fadd_rn(s[4], v[q][1].x);
        s[5] = __fadd_rn(s[5], v[q][1].y);
        s[6] = __fadd_rn(s[6], v[q][1].z);
        s[7] = __fadd_rn(s[7], v[q][1].w);
      }
    }
    store8(a.out + (m0 + r) * a.ldo + n, s, a.scale + n);
  }
  if (splits > 1) cluster_sync();  // a block's partials stay until every peer has read them
}

// The card's SM count, and for each instance (bf16, then f32) how many of
// its blocks the card holds at once in clusters of s blocks (s = 1 ..
// kMaxSplits): read once a device with the instance's shared-memory opt-in,
// so a launch inside a CUDA graph's capture makes no query.
struct Device {
  int sms = 0;
  int resident[2][kInstances][kMaxSplits + 1] = {};
};

cudaError_t device_info(Device** out) {
  static Device devices[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &d;
  return cudaSuccess;
}

// the instance for M rows: the fewest 8-row steps that hold min(M, the
// side's most rows a block) rows
template <typename X>
int instance_for(int M) {
  const int steps = ((M < Side<X>::kMaxRows ? M : Side<X>::kMaxRows) + 7) / 8;
  int i = 0;
  while (kMTs[i] < steps) ++i;
  return i;
}

template <int MT, typename X>
cudaError_t configure(int* resident) {
  using T = Tile<MT, X>;
  if (resident[1] != 0) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(int8_weight_matmul_kernel<MT, X>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  for (int s = 1; s <= kMaxSplits; ++s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, s);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = T::kSmem;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = s;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, int8_weight_matmul_kernel<MT, X>, &cfg);
    if (err != cudaSuccess) return err;
    resident[s] = clusters > 0 ? clusters * s : 1;
  }
  return cudaSuccess;
}

struct Plan {
  int rows = 0, row_tiles = 0, col_tiles = 0, splits = 1, k_per_split = 0, resident = 0;
};

// K is split (at most kMaxSplits ways, each split at least two K tiles)
// only where the output tiles leave the card's blocks idle; the split count
// is the one whose clusters fill the resident blocks' waves best (the
// fewest splits among equals).
Plan plan_for(int M, int N, int K, int rows, const int* resident) {
  Plan p;
  p.rows = rows;
  p.row_tiles = (M + rows - 1) / rows;
  p.col_tiles = (N + kBN - 1) / kBN;
  const long long tiles = static_cast<long long>(p.row_tiles) * p.col_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  int best = 1;
  if (tiles < resident[1]) {
    const int most = k_tiles / 2 < kMaxSplits ? k_tiles / 2 : kMaxSplits;
    // busy share of the resident blocks over the waves: blocks / (waves * resident)
    long long best_blocks = tiles, best_slots = resident[1];
    for (int s = 2; s <= most; ++s) {
      const long long per_wave = resident[s] / s;  // clusters, one a tile
      if (per_wave == 0) continue;
      const long long slots = (tiles + per_wave - 1) / per_wave * resident[s];
      if (tiles * s * best_slots > best_blocks * slots) {
        best = s;
        best_blocks = tiles * s;
        best_slots = slots;
      }
    }
  }
  p.k_per_split = (k_tiles + best - 1) / best * kBK;
  p.splits = (K + p.k_per_split - 1) / p.k_per_split;
  p.resident = resident[p.splits];
  return p;
}

// Calls f(std::integral_constant<int, MT>()) with the 8-row steps of the
// side's instance `index`.
template <typename X, typename F>
auto with_instance(int index, F&& f) {
  if constexpr (!Side<X>::kF32) {
    if (kMTs[index] == 12) return f(std::integral_constant<int, 12>());
    if (kMTs[index] == 16) return f(std::integral_constant<int, 16>());
  }
  switch (kMTs[index]) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 8>());
  }
}

// The instance and plan for an M x K x N product with x of dtype X.
template <typename X>
cudaError_t choose(int M, int N, int K, Device& d, int* index, Plan* plan) {
  const int idx = instance_for<X>(M);
  int* resident = d.resident[Side<X>::kF32][idx];
  const cudaError_t err =
      with_instance<X>(idx, [&](auto mt) { return configure<decltype(mt)::value, X>(resident); });
  if (err != cudaSuccess) return err;
  *index = idx;
  *plan = plan_for(M, N, K, 8 * kMTs[idx], resident);
  return cudaSuccess;
}

template <int MT, typename X>
cudaError_t launch_mt(const Args<X>& base, const Plan& p, cudaStream_t stream) {
  using T = Tile<MT, X>;
  if (p.row_tiles > 65535) return cudaErrorInvalidValue;
  Args<X> a = base;
  a.k_per_split = p.k_per_split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.col_tiles, p.row_tiles, p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_weight_matmul_kernel<MT, X>, a);
}

// One launch of the instance `choose` picks for x of dtype X.
template <typename X>
cudaError_t run(const Args<X>& a, Device& d, cudaStream_t st) {
  int index = 0;
  Plan p;
  const cudaError_t err = choose<X>(a.M, a.N, a.K, d, &index, &p);
  if (err != cudaSuccess) return err;
  return with_instance<X>(index, [&](auto mt) { return launch_mt<decltype(mt)::value>(a, p, st); });
}

// The plan for x of dtype X into out[7] (cgpt_int8_weight_matmul_plan's fields).
template <typename X>
cudaError_t plan_into(int M, int N, int K, Device& d, int* out) {
  int index = 0;
  Plan p;
  const cudaError_t err = choose<X>(M, N, K, d, &index, &p);
  if (err != cudaSuccess) return err;
  const int values[] = {p.rows, p.row_tiles, p.col_tiles, p.splits, p.k_per_split, p.resident,
                        with_instance<X>(index, [](auto mt) {
                          return Tile<decltype(mt)::value, X>::kStages;
                        })};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return cudaSuccess;
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0;
}

}  // namespace

// x [M, K] bf16 (row stride ldx elements), w: channel n's K int8 values at
// w + n * ldw, scale [N] f32, out [M, N] bf16 (row stride ldo); with x_f32,
// x and out are f32. K a multiple of 16, N of 8; x, w, out, and the row
// strides in bytes (ldx and ldo times the element size, ldw) 16-byte
// aligned. One kernel launch, no memset, no workspace.
extern "C" int cgpt_int8_weight_matmul(const void* x, long long ldx, const void* w, long long ldw,
                                       const void* scale, void* out, long long ldo, int M, int N,
                                       int K, int x_f32, void* stream) {
  const long long esize = x_f32 ? 4 : 2;
  if (bad_shape(M, N, K) || ldx < K || ldw < K || ldo < N || (esize * ldx) % 16 != 0 ||
      ldw % 16 != 0 || (esize * ldo) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Device* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one launch of the instance for x's dtype (`typed` carries it)
  const auto launch = [&](auto* typed) {
    using X = std::remove_pointer_t<decltype(typed)>;
    return run(Args<X>{static_cast<const X*>(x), ldx, static_cast<const int8_t*>(w), ldw,
                       static_cast<const float*>(scale), static_cast<X*>(out), ldo, M, N, K, 0},
               *d, static_cast<cudaStream_t>(stream));
  };
  err = x_f32 ? launch(static_cast<float*>(nullptr)) : launch(static_cast<__nv_bfloat16*>(nullptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch's plan for an M x K x N product (x_f32: the f32 instance's),
// into out[7]: rows a block, row tiles, channel tiles, K splits (the
// cluster size), K values a split, blocks the card holds at once in such
// clusters, ring stages.
extern "C" int cgpt_int8_weight_matmul_plan(int M, int N, int K, int x_f32, int* out) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  Device* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(x_f32 ? plan_into<float>(M, N, K, *d, out)
                                : plan_into<__nv_bfloat16>(M, N, K, *d, out));
}
