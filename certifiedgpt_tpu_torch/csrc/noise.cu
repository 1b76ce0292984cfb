// Monte-Carlo noise injection for Hopper (sm_90a): tile one clean image n
// times and add sigma * N(0, 1), in one pass.
//
// Replaces the Pallas TPU kernel _noise_kernel of certifiedgpt_tpu/ops/noise.py
// (:58, called from _noisy_tile_pallas :86; noisy_tile(use_pallas=True)).
// Each image of the batch has its own stream: the TPU kernel seeds its
// hardware generator with (seed word 0, seed word 1, draw). The TPU's bits
// cannot be reproduced, so this kernel carries a counter-based generator
// written out here, Philox4x32-10 (Salmon et al., SC'11; Random123), keyed by
// the two seed words, with the counter (draw, pair index, 0, 0). One call
// gives four 32-bit words: elements 2j and 2j + 1 of an image take words
// (0, 1) and (2, 3) as their two uniforms. Uniforms in (0, 1] come from the
// TPU kernel's mantissa trick (23 random bits under the exponent of 1.0, then
// 2 - x, :35-47), and the normal is sqrt(-2 log u1) * cos(2 pi u2) (:50-55),
// with the full-precision logf/sqrtf/cosf. Every product and sum is rounded
// on its own (__fmul_rn/__fadd_rn, no fused multiply-add), so that the plain
// PyTorch version beside the wrapper (ops/noise.py) gives the same integers
// bit for bit and the same values up to the math library's last ulp. sigma =
// 0 gives x + 0 * g = x exactly.
//
// Unlike the TPU kernel, sigma is a runtime value and the seed words and
// sigma are read from device memory, so a sweep shares one build and the
// caller never waits for the device; any image size is taken.
//
// Bound on the H100: integer operations. Writing the n copies (4 bytes each)
// and reading the image once is 0.070 ms for 96 x 448^2 x 3 at 3.35 TB/s; the
// generator needs 60 integer operations per Philox call (ten rounds of two
// low and two high multiply words and two three-input xors; the key schedule
// is the same for every counter of a launch) for two elements, the uniforms
// two more per element each, and the transform about 50 f32 operations per
// element. Design: one thread per pair
// of elements of one image (grid y = image), no shared memory; the clean image
// (2.4 MB) stays in L2 across the images.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fsub_rn(2.0f, __uint_as_float((bits >> 9) | 0x3F800000u));
}

__device__ __forceinline__ float gaussian(uint32_t bits1, uint32_t bits2) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform_from_bits(bits1))));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, uniform_from_bits(bits2))));
}

__global__ void __launch_bounds__(kThreads)
    noise_kernel(const float* __restrict__ x, const uint32_t* __restrict__ seed,
                 const float* __restrict__ sigma, float* __restrict__ out, long long elems) {
  const long long pair = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long e = 2 * pair;
  if (e >= elems) return;
  const uint32_t draw = blockIdx.y;
  const uint4 r = philox4x32_10(make_uint4(draw, static_cast<uint32_t>(pair), 0u, 0u),
                                make_uint2(seed[0], seed[1]));
  const float s = *sigma;
  float* o = out + static_cast<long long>(draw) * elems;
  o[e] = __fadd_rn(x[e], __fmul_rn(s, gaussian(r.x, r.y)));
  if (e + 1 < elems) o[e + 1] = __fadd_rn(x[e + 1], __fmul_rn(s, gaussian(r.z, r.w)));
}

}  // namespace

// out [n, elems] = x [elems] + sigma * N(0, 1), image i keyed by (seed, i).
// seed: two uint32 words and sigma: one f32, both in device memory.
extern "C" int cgpt_noisy_tile(const void* x, const void* seed, const void* sigma, void* out,
                               long long elems, int n, void* stream) {
  const long long pairs = (elems + 1) / 2;
  if (elems <= 0 || n <= 0 || n > 65535 || pairs > 0xFFFFFFFFLL ||
      (pairs + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((pairs + kThreads - 1) / kThreads), n);
  noise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(seed),
      static_cast<const float*>(sigma), static_cast<float*>(out), elems);
  return static_cast<int>(cudaGetLastError());
}

