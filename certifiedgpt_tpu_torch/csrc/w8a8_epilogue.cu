// The W8A8 product's epilogue on Hopper (sm_90a): one pass from the int32
// accumulator of the int8 x int8 product to the bf16 output.
//
// Replaces the rescale that XLA fuses into the int8 einsum's epilogue in
// the JAX package (certifiedgpt_tpu/ops/quantization.py::w8a8_matmul :68,
// w8a8_gelu_matmul :308, and the bias add of models/layers.py::dense :50):
//   out[m, n] = bf16(bf16(f32(acc[m, n]) * xs[m] * ws[n]) + bias[n])
// The two products are rounded one at a time in the plain chain's order,
// (acc * xs) * ws, with no fused multiply-add; the bias, when there is one,
// is added in f32 to the bf16-rounded product and rounded again, as the
// plain ``y + bias`` of two bf16 tensors does. The result is the plain
// version's (ops/quantization.py::_w8a8_epilogue_plain) bit for bit.
//
// Bound on the H100: bytes. The plain chain reads and writes [M, N] five
// times (int32 -> f32, * xs, * ws, -> bf16, + bias); this pass reads the
// 4-byte accumulator and writes the 2-byte output once: 6 bytes an element,
// 0.74 ms at the ViT qkv's [98304, 4224] at 3.35 TB/s. Design: a thread
// takes four neighbouring columns of a row (one 16-byte load, one 8-byte
// store), a grid-stride walk over the quads.
//
// An f32 instance (the f32 configurations' output dtype) computes the same
// products and, with a bias, one f32 add: out = f32(acc) * xs * ws + bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ __nv_bfloat16 rescale(int32_t a, float x, float w,
                                                 const __nv_bfloat16* bias, int n) {
  const __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(a), x), w));
  if (bias == nullptr) return y;
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(bias[n])));
}

__device__ __forceinline__ float rescale(int32_t a, float x, float w, const float* bias, int n) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(a), x), w);
  return bias == nullptr ? y : __fadd_rn(y, bias[n]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, __nv_bfloat16 a, __nv_bfloat16 b,
                                       __nv_bfloat16 c, __nv_bfloat16 d) {
  *reinterpret_cast<uint2*>(o) =
      make_uint2(bits(__halves2bfloat162(a, b)), bits(__halves2bfloat162(c, d)));
}

__device__ __forceinline__ void store4(float* o, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}

// T: the output's and the bias's dtype (bf16 or f32)
template <typename T>
__global__ void __launch_bounds__(kThreads) w8a8_epilogue_kernel(
    const int32_t* __restrict__ acc, long long lda, const float* __restrict__ xs,
    const float* __restrict__ ws, const T* __restrict__ bias, T* __restrict__ out, long long M,
    int N) {
  const long long quads_per_row = N / 4;
  const long long quads = M * quads_per_row;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < quads;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / quads_per_row;
    const int n = static_cast<int>(i - m * quads_per_row) * 4;
    const int4 a = *reinterpret_cast<const int4*>(acc + m * lda + n);
    const float x = xs[m];
    const float4 w = *reinterpret_cast<const float4*>(ws + n);
    store4(out + m * N + n, rescale(a.x, x, w.x, bias, n), rescale(a.y, x, w.y, bias, n + 1),
           rescale(a.z, x, w.z, bias, n + 2), rescale(a.w, x, w.w, bias, n + 3));
  }
}

}  // namespace

// acc [M, N] int32 with row stride lda (elements), xs [M] f32, ws [N] f32,
// bias [N] or null, out [M, N] contiguous, the bias and the output bf16 (f32
// with out_f32). N and lda multiples of 4, acc, ws and out 16-byte aligned.
extern "C" int cgpt_w8a8_epilogue(const void* acc, long long lda, const void* xs, const void* ws,
                                  const void* bias, void* out, long long M, int N, int out_f32,
                                  void* stream) {
  if (M < 0 || N <= 0 || N % 4 != 0 || lda % 4 != 0 || lda < N ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  static int sms_of[64] = {};  // SMs a device, read once (no query inside a graph capture)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sms_of[dev];
  const long long quads = M * (N / 4);
  const long long wanted = (quads + kThreads - 1) / kThreads;
  const long long most = 16LL * sms;  // enough blocks to stay resident, the rest walk
  const unsigned grid = static_cast<unsigned>(wanted < most ? wanted : most);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const int32_t*>(acc);
  const auto x = static_cast<const float*>(xs), w = static_cast<const float*>(ws);
  if (out_f32) {
    w8a8_epilogue_kernel<float><<<grid, kThreads, 0, st>>>(
        a, lda, x, w, static_cast<const float*>(bias), static_cast<float*>(out), M, N);
  } else {
    w8a8_epilogue_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        a, lda, x, w, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
        M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
