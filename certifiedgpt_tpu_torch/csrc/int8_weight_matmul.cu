// The weight-only int8 product of the decode on Hopper (sm_90a):
//   out[m, n] = bf16(f32(sum_k x[m, k] * q[k, n]) * scale[n])
// with x [M, K] bf16 and the int8 kernel q [K, N] stored column-major (each
// output channel's K values contiguous: ops/quantization.py::
// int8_kernel_layout), read once a call and never copied to bf16.
//
// Replaces the weight-only branch of the JAX package's dense
// (certifiedgpt_tpu/models/layers.py:62-82): einsum(x, kernel_q.astype(bf16),
// preferred_element_type=f32) * scale, where XLA feeds the int8 -> bf16
// convert straight into the matrix unit. Here each int8 value is converted to
// bf16 in registers (exact: |q| <= 128) and multiplied on the tensor cores by
// mma.sync.m16n8k16 (bf16 in, f32 accumulation), so the products are exact
// and only the order of the f32 sums differs from the plain version's
// (ops/quantization.py::_int8_weight_forward_plain).
//
// Bound on the H100: bytes at the decode's rows (M <= 96: the 6.48 GB of
// int8 weights a step of the 7-billion decoder, 1.93 ms at 3.35 TB/s);
// operations at the prefill's M = 9216. Design, simple first: a block owns a
// 128 x 128 output tile (eight warps, 2 x 4, each 64 rows x 32 columns) and
// walks K in tiles of 64 through a three-stage cp.async ring in shared
// memory (x tile rows padded to 160 bytes, weight tile channels to 80, so
// that the fragment reads are free of bank conflicts). K is permuted inside
// each 16-wide step so that a thread reads four neighbouring weight bytes
// as one word and four neighbouring x values as one 8-byte word: the
// fragment slots (2t, 2t+1, 2t+8, 2t+9) of the m16n8k16 layout hold k = 4t ..
// 4t+3, the same in A and B. Rows past M are neither loaded nor multiplied
// (a warp skips its 16-row slices beyond M), so M = 1 costs the weight read
// and little else. Where the output tiles alone leave SMs idle (M <= 128: one
// row tile), K is split over blockIdx.z: every split writes its f32 partial
// tile to a workspace, and the last split of a tile to arrive (a counter
// per tile) sums the partials in split order, so the
// result does not depend on the order the blocks ran in; it reads the
// partials four columns and up to eight splits at a time. The launcher plans
// the splits from the shape and the card's SM count, and the caller hands it
// one workspace of the size cgpt_int8_weight_matmul_workspace names: the
// partials, then the tile counters, which the launcher zeroes on the call's
// stream before the kernel runs (so launches on several streams never share
// a counter).
//
// An f32 instance (f32 x and output, the tiny and f32 configurations) is a
// plain tiled product on the CUDA cores: each int8 value goes to f32 (exact)
// and is multiplied by f32 FMAs, the sum scaled and stored in f32, as the
// plain version's f32 product of the upcast operands is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kXStride = 2 * kBK + 32;  // bytes a row of the x tile (160)
constexpr int kWStride = kBK + 16;      // bytes a channel of the weight tile (80)
constexpr int kXTile = kBM * kXStride;
constexpr int kWTile = kBN * kWStride;
constexpr int kStageBytes = kXTile + kWTile;
constexpr int kSmemBytes = kStages * kStageBytes;

struct Args {
  const __nv_bfloat16* x;
  long long ldx;  // elements
  const int8_t* w;
  long long ldw;  // bytes between channels
  const float* scale;
  __nv_bfloat16* out;
  long long ldo;  // elements
  int M, N, K;
  int k_per_split;  // a multiple of kBK
  float* workspace;  // [splits, M, N] f32 when splits > 1
  int* counters;     // a zeroed int a (row tile, column tile)
};

// the f32 instance's tile: 32 rows x 64 channels, K in steps of 32; each of
// the 256 threads keeps 2 rows x 4 channels
constexpr int kFBM = 32, kFBN = 64, kFBK = 32;

struct F32Args {
  const float* x;
  long long ldx;  // elements
  const int8_t* w;
  long long ldw;  // bytes between channels
  const float* scale;
  float* out;
  long long ldo;  // elements
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// two signed bytes -> a bf16 pair (exact)
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t w, int shift) {
  const float lo = static_cast<float>(static_cast<int8_t>(w >> shift));
  const float hi = static_cast<float>(static_cast<int8_t>(w >> (shift + 8)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Starts the copies of the K tile at k0 (clipped to k_end) into `stage`.
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* stage, int m0, int n0,
                                          int k0, int k_end) {
  const uint32_t xs = smem_u32(stage), ws = smem_u32(stage + kXTile);
  // x: kBM rows x 8 chunks of 8 values; rows past M are not loaded
  for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
    const int r = c / (kBK / 8), part = c % (kBK / 8);
    if (m0 + r >= a.M) continue;
    const int k = k0 + 8 * part;
    const bool in = k < k_end;
    const __nv_bfloat16* src = a.x + (m0 + r) * a.ldx + (in ? k : 0);
    cp_async16(xs + r * kXStride + 16 * part, src, in ? 16 : 0);
  }
  // weights: kBN channels x 4 chunks of 16 bytes; channels past N are not loaded
  for (int c = threadIdx.x; c < kBN * (kBK / 16); c += kThreads) {
    const int n = c / (kBK / 16), part = c % (kBK / 16);
    if (n0 + n >= a.N) continue;
    const int k = k0 + 16 * part;
    const bool in = k < k_end;
    const int8_t* src = a.w + (n0 + n) * a.ldw + (in ? k : 0);
    cp_async16(ws + n * kWStride + 16 * part, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z),
                     __fadd_rn(x.w, y.w));
}

// The last split of a tile: each thread takes four neighbouring columns of
// the tile at a time, loads up to eight splits' partials at once (they are
// independent loads) and adds them in split order, then scales and rounds.
__device__ __forceinline__ void sum_splits(const Args& a, int m0, int n0, int splits) {
  const int rows = min(kBM, a.M - m0), quads_per_row = min(kBN, a.N - n0) / 4;
  const long long plane = static_cast<long long>(a.M) * a.N / 4;  // float4s a split
  for (int qd = threadIdx.x; qd < rows * quads_per_row; qd += kThreads) {
    const int m = m0 + qd / quads_per_row, n = n0 + 4 * (qd % quads_per_row);
    const float4* p =
        reinterpret_cast<const float4*>(a.workspace + static_cast<long long>(m) * a.N + n);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float4 part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (s0 + i < splits) part[i] = __ldcg(p + (s0 + i) * plane);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (s0 + i < splits) sum = add4(sum, part[i]);
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(__fmul_rn(sum.x, a.scale[n]),
                                                    __fmul_rn(sum.y, a.scale[n + 1]));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(__fmul_rn(sum.z, a.scale[n + 2]),
                                                    __fmul_rn(sum.w, a.scale[n + 3]));
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(a.out + m * a.ldo + n);
    o[0] = lo;
    o[1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads, 1) int8_weight_matmul_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  // 16-row slices of this warp that hold rows below M
  const int row0 = m0 + 64 * wm;
  const int slices = max(0, min(4, (a.M - row0 + 15) / 16));

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(a, smem + s * kStageBytes, m0, n0, k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < tiles) {
      load_tile(a, smem + (next % kStages) * kStageBytes, m0, n0, k_begin + next * kBK, k_end);
    }
    cp_async_commit();
    if (slices == 0) continue;
    const unsigned char* stage = smem + (kt % kStages) * kStageBytes;
    const unsigned char* xt = stage + (64 * wm) * kXStride;
    const unsigned char* wt = stage + kXTile + (32 * wn) * kWStride;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(wt + (8 * j + g) * kWStride + k16 + 4 * t);
        b[j][0] = bf16x2_of(w4, 0);
        b[j][1] = bf16x2_of(w4, 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= slices) break;
        const uint2 lo =
            *reinterpret_cast<const uint2*>(xt + (16 * i + g) * kXStride + 2 * (k16 + 4 * t));
        const uint2 hi =
            *reinterpret_cast<const uint2*>(xt + (16 * i + g + 8) * kXStride + 2 * (k16 + 4 * t));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], lo.x, hi.x, lo.y, hi.y, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  const int splits = gridDim.z;
  if (splits > 1) {
    // this split's partial tile, then the last split of the tile sums them
    float* part = a.workspace + static_cast<long long>(blockIdx.z) * a.M * a.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= slices) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 32 * wn + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 16 * i + g + 8 * h;
          if (m >= a.M) continue;
          if (n < a.N) part[static_cast<long long>(m) * a.N + n] = acc[i][j][2 * h];
          if (n + 1 < a.N) part[static_cast<long long>(m) * a.N + n + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_splits(a, m0, n0, splits);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= slices) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * wn + 8 * j + 2 * t;
      if (n >= a.N) continue;  // N is even: n + 1 < N with n
      const float s0 = a.scale[n], s1 = a.scale[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 16 * i + g + 8 * h;
        if (m >= a.M) continue;
        const __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(acc[i][j][2 * h], s0),
                                                       __fmul_rn(acc[i][j][2 * h + 1], s1));
        *reinterpret_cast<__nv_bfloat162*>(a.out + m * a.ldo + n) = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) int8_weight_matmul_f32_kernel(const F32Args a) {
  __shared__ float xt[kFBK][kFBM + 1];  // the x tile, k-major
  __shared__ float wt[kFBK][kFBN + 1];  // the weight tile, k-major
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += kFBK) {
    for (int i = threadIdx.x; i < kFBM * kFBK; i += kThreads) {
      const int r = i / kFBK, c = i % kFBK, m = m0 + r, k = k0 + c;
      xt[c][r] = m < a.M && k < a.K ? a.x[m * a.ldx + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kFBN * kFBK; i += kThreads) {
      const int n = n0 + i / kFBK, c = i % kFBK, k = k0 + c;
      wt[c][i / kFBK] = n < a.N && k < a.K ? static_cast<float>(a.w[n * a.ldw + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFBK; ++kk) {
      const float x0 = xt[kk][2 * ty], x1 = xt[kk][2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = wt[kk][tx + 16 * j];
        acc[0][j] = fmaf(x0, w, acc[0][j]);
        acc[1][j] = fmaf(x1, w, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 2 * ty + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.N) a.out[m * a.ldo + n] = __fmul_rn(acc[i][j], a.scale[n]);
    }
  }
}

// The card's SM count and the shared-memory opt-in, read and made once a
// device (no query inside a CUDA graph's capture).
struct Device {
  int sms = 0;
  bool configured = false;
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

struct Plan {
  int splits = 1, k_per_split = 0, tiles = 0;
  long long workspace_bytes = 0;  // partials, then a counter a tile
};

// K is split so that the output tiles times the splits give about two
// blocks an SM (M <= 128 leaves one row tile), each split at least four K
// tiles long (shorter splits cost more in partials than they add in blocks).
// The f32 instance does not split.
Plan plan_for(int M, int N, int K, bool x_f32, int sms) {
  Plan p;
  p.tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int k_tiles = (K + kBK - 1) / kBK;
  p.k_per_split = k_tiles * kBK;
  if (x_f32) return p;
  const int want = (2 * sms + p.tiles - 1) / p.tiles;  // at least 1
  const int longest = k_tiles / 4 > 1 ? k_tiles / 4 : 1;
  const int splits = want < longest ? want : longest;
  p.k_per_split = (k_tiles + splits - 1) / splits * kBK;
  p.splits = (K + p.k_per_split - 1) / p.k_per_split;
  if (p.splits > 1) {
    p.workspace_bytes = 4LL * p.splits * M * N + 4LL * p.tiles;
  }
  return p;
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0;
}

}  // namespace

// Bytes of the workspace cgpt_int8_weight_matmul needs at this shape (0:
// none), into *bytes.
extern "C" int cgpt_int8_weight_matmul_workspace(int M, int N, int K, int x_f32,
                                                 long long* bytes) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  Device* d = nullptr;
  const cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = plan_for(M, N, K, x_f32 != 0, d->sms).workspace_bytes;
  return 0;
}

// x [M, K] bf16 (row stride ldx elements), w: channel n's K int8 values at
// w + n * ldw, scale [N] f32, out [M, N] bf16 (row stride ldo); with x_f32,
// x and out are f32. K a multiple of 16, N of 8; x, w, ldx * 2 and ldw
// 16-byte aligned. `workspace` holds workspace_bytes, at least what
// cgpt_int8_weight_matmul_workspace names for the shape (16-byte aligned).
extern "C" int cgpt_int8_weight_matmul(const void* x, long long ldx, const void* w, long long ldw,
                                       const void* scale, void* out, long long ldo, int M, int N,
                                       int K, int x_f32, void* workspace,
                                       long long workspace_bytes, void* stream) {
  if (bad_shape(M, N, K) || ldx < K || ldw < K || ldo < N || (2 * ldx) % 16 != 0 ||
      ldw % 16 != 0 || ldo % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Device* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(M, N, K, x_f32 != 0, d->sms);
  if (p.splits > 65535 || (p.workspace_bytes > 0 &&
                           (workspace == nullptr || workspace_bytes < p.workspace_bytes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    F32Args a{static_cast<const float*>(x), ldx, static_cast<const int8_t*>(w), ldw,
              static_cast<const float*>(scale), static_cast<float*>(out), ldo, M, N, K};
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
    int8_weight_matmul_f32_kernel<<<grid, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (!d->configured) {
    err = cudaFuncSetAttribute(int8_weight_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    d->configured = true;
  }
  float* partials = static_cast<float*>(workspace);
  int* counters = nullptr;
  if (p.splits > 1) {
    counters = reinterpret_cast<int*>(static_cast<char*>(workspace) +
                                      4LL * p.splits * M * N);
    err = cudaMemsetAsync(counters, 0, 4LL * p.tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const int8_t*>(w), ldw,
         static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), ldo, M, N, K,
         p.k_per_split, partials, counters};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, p.splits);
  int8_weight_matmul_kernel<<<grid, kThreads, kSmemBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
