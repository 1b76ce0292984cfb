// Fused row transform + symmetric per-row int8 quantization, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of certifiedgpt_tpu/ops/quantization.py:
//   _ln_quant_kernel   (:208)  LayerNorm with affine -> int8 rows  (ViT qkv / fc1 inputs)
//   _gelu_quant_kernel (:136)  exact GELU            -> int8 rows  (ViT fc2 input)
// Per row: fp32 transform -> round through bf16 (the unfused chain quantizes the
// bf16 activation) -> absmax/127 scale -> rint (half to even) -> clip to +-127.
// GELU uses the native erff; the TPU kernel needed an A-S erf approximation.
//
// Bound on the H100: bytes. Per element the kernel reads 2 bytes and writes 1,
// against ~10-25 fp32 operations, far below the card's ~20 operations per byte
// at 67 TFLOP/s fp32 over 3.35 TB/s. Design: one 256-thread block per row, each
// thread loading 16-byte vectors and keeping its values in registers across the
// three passes (statistics, transform, quantize), so the row is read from device
// memory once and the int8 codes and the f32 scale are written once. Reductions
// are warp shuffles plus one shared-memory step. Any row count M is taken,
// including the 96-row cls stream that the TPU kernel's tiling had to skip.
// K must be a multiple of 8 and at most kThreads * 8 * kMaxChunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;  // 8-element chunks per thread: K <= 8192

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max (of non-negative values); every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.f;
  return kMax ? warp_max(v) : warp_sum(v);
}

// Loads this thread's chunks of one bf16 row into registers (zeros past K).
__device__ __forceinline__ void load_row(const __nv_bfloat16* xr, int K,
                                         float (&v)[kMaxChunks * 8]) {
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = (c * kThreads + threadIdx.x) * 8;
    if (i < K) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        v[c * 8 + 2 * j] = f.x;
        v[c * 8 + 2 * j + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[c * 8 + j] = 0.f;
    }
  }
}

__device__ __forceinline__ signed char quant1(float h, float xs) {
  const float r = fminf(fmaxf(rintf(h / xs), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(r));
}

// Absmax scale and int8 codes of the (already bf16-rounded) values in v.
__device__ __forceinline__ void quantize_row(const float (&v)[kMaxChunks * 8], int K,
                                             int8_t* qr, float* s_out, float* red) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunks * 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  amax = block_reduce<true>(amax, red);
  const float xs = fmaxf(amax, 1e-8f) / 127.f;
  if (threadIdx.x == 0) *s_out = xs;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = (c * kThreads + threadIdx.x) * 8;
    if (i < K) {
      char4 lo, hi;
      lo.x = quant1(v[c * 8 + 0], xs);
      lo.y = quant1(v[c * 8 + 1], xs);
      lo.z = quant1(v[c * 8 + 2], xs);
      lo.w = quant1(v[c * 8 + 3], xs);
      hi.x = quant1(v[c * 8 + 4], xs);
      hi.y = quant1(v[c * 8 + 5], xs);
      hi.z = quant1(v[c * 8 + 6], xs);
      hi.w = quant1(v[c * 8 + 7], xs);
      *reinterpret_cast<char4*>(qr + i) = lo;
      *reinterpret_cast<char4*>(qr + i + 4) = hi;
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ s, int K, float eps) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  float v[kMaxChunks * 8];
  load_row(x + row * K, K, v);

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunks * 8; ++j) sum += v[j];
  const float mean = block_reduce<false>(sum, red) / static_cast<float>(K);

  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if ((c * kThreads + threadIdx.x) * 8 < K) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[c * 8 + j] - mean;
        sq += d * d;
      }
    }
  }
  const float var = block_reduce<false>(sq, red) / static_cast<float>(K);
  const float rs = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = (c * kThreads + threadIdx.x) * 8;
    if (i < K) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // separate roundings, no fused multiply-add: the plain chain rounds
        // after every operation
        const float h = __fmul_rn(__fsub_rn(v[c * 8 + j], mean), rs);
        v[c * 8 + j] = round_bf16(__fadd_rn(__fmul_rn(h, gamma[i + j]), beta[i + j]));
      }
    }
  }
  quantize_row(v, K, q + row * K, s + row, red);
}

__global__ void __launch_bounds__(kThreads)
    gelu_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s, int K) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  float v[kMaxChunks * 8];
  load_row(x + row * K, K, v);
#pragma unroll
  for (int j = 0; j < kMaxChunks * 8; ++j) {
    const float t = v[j];
    v[j] = round_bf16(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
  }
  quantize_row(v, K, q + row * K, s + row, red);
}

bool shape_ok(long long M, int K) {
  return M >= 0 && M < (1ll << 31) && K > 0 && K % 8 == 0 && K <= kThreads * 8 * kMaxChunks;
}

}  // namespace

extern "C" int cgpt_ln_quant(const void* x, const void* gamma, const void* beta, void* q,
                             void* s, long long M, int K, float eps, void* stream) {
  if (!shape_ok(M, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  ln_quant_kernel<<<static_cast<unsigned>(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<int8_t*>(q), static_cast<float*>(s), K, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cgpt_gelu_quant(const void* x, void* q, void* s, long long M, int K,
                               void* stream) {
  if (!shape_ok(M, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  gelu_quant_kernel<<<static_cast<unsigned>(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
