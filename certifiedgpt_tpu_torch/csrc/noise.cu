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
// 2 - x, :35-47), and the normal is sqrt(-2 log u1) * cos(2 pi u2) (:50-55).
// The integers equal the plain PyTorch version's (ops/noise.py) bit for bit;
// the transform is computed for the domain its arguments have, so values
// differ from the plain version's exact math by a few 1e-6 (stated in
// _noisy_tile_kernel_plain). sigma = 0 gives x + 0 * g = x exactly: g is
// finite for every input.
//
// Unlike the TPU kernel, sigma is a runtime value and the seed words and
// sigma are read from device memory, so a sweep shares one build and the
// caller never waits for the device; any image size is taken.
//
// What bounds it on the H100, measured (scripts/bench_torch_noise.py at
// 96 x 448 x 448 x 3): the output's bytes, 0.070 ms at the card's rate, and
// the instructions that must hide under them. Computed plainly (a thread a
// pair of one image, the whole key schedule and all ten rounds per pair, the
// library's logf/cosf/sqrtf) an element takes ~120 SASS instructions and the
// kernel is bound by issue. This design takes ~35 and lets the stores stream:
// - Rounds 1-3 of Philox mostly depend on the image or the pair alone: the
//   counter's words 2 and 3 are 0, so round 1 multiplies nothing of the pair,
//   round 2 one word of the pair and one of the image, round 3 one of each
//   again. A block computes each image's words once (shared memory), a thread
//   each pair's once; a (pair, image) then takes one wide multiply in round
//   3 and two in each of rounds 4-10 (IMAD.WIDE.U32: both words at once),
//   with the round keys in (uniform) registers.
// - A thread owns four pairs, two 16-byte quads that lie 32 quads apart, so
//   a warp's loads and stores are 512 contiguous bytes each; it loads x once
//   and walks through kImagesPerBlock images, writing each with two 16-byte
//   streaming stores.
// - -2 log u1 is lg2.approx of u1 (absolute error ~2^-22, so relative error
//   < 2e-4 where u1 <= 1 - 2^-10), and near 1, where that error would
//   dominate, the series 2t + t^2 + 2t^3/3 in t = 1 - u1 (exact; relative
//   error < t^3 / 4 < 3e-10); sqrt.approx; cos(2 pi u2) = -cos(2 pi w) with
//   w = f2 - 3/2 in [-1/2, 1/2) exact, on cos.approx. No special cases:
//   u1 lies in [2^-23, 1], so the log is finite and >= 0 after the sign.
// The stores alone take 0.075 ms (93 % of the byte rate), and so does the
// kernel without its Philox rounds or without its transform; the whole takes
// ~0.099 ms, 70 % of the byte bound: the instructions (0.060 ms at the issue
// rate) do not hide entirely under the stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuadsPerWarp = 64;  // two 16-byte quads a thread, 32 apart
constexpr int kImagesPerBlock = 8;  // images a thread walks through
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMinusTwoLn2 = -1.38629436111989061883f;

__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t a, uint32_t& hi, uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(m) * a;  // one IMAD.WIDE.U32
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_approx(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Words of rounds 1-3 that depend on the image alone (counter word 0 = img).
// Round 1 (key k_0): (pair ^ s0, 0, hi(M0 img) ^ s1, lo(M0 img)).
// Round 2 (key k_1): (hi(M1 c1z) ^ k0_1, lo(M1 c1z), hiA ^ lo(M0 img) ^ k1_1, loA),
//   with (hiA, loA) = M0 (pair ^ s0).
// Round 3 (key k_2): (hiD ^ lo(M1 c1z) ^ k0_2, loD, hiC ^ loA ^ k1_2, loC), with
//   (hiC, loC) = M0 c2x, (hiD, loD) = M1 c2z.
// Returned: (lo(M0 img) ^ k1_1, lo(M1 c1z) ^ k0_2, hiC ^ k1_2, loC).
__device__ __forceinline__ uint4 image_words(uint32_t img, uint32_t s0, uint32_t s1) {
  uint32_t hi_i, lo_i, hi_b, lo_b, hi_c, lo_c;
  mulhilo(kM0, img, hi_i, lo_i);
  mulhilo(kM1, hi_i ^ s1, hi_b, lo_b);
  mulhilo(kM0, hi_b ^ (s0 + kW0), hi_c, lo_c);
  return make_uint4(lo_i ^ (s1 + kW1), lo_b ^ (s0 + 2 * kW0), hi_c ^ (s1 + 2 * kW1), lo_c);
}

// Philox4x32-10 of counter (img, pair, 0, 0) from rounds 3-10: (hi_a, lo_a) =
// M0 (pair ^ s0), w = image_words(img), k0/k1 = the keys of rounds 4-10.
__device__ __forceinline__ uint4 philox_rest(uint32_t hi_a, uint32_t lo_a, uint4 w,
                                             const uint32_t (&k0)[7], const uint32_t (&k1)[7]) {
  uint32_t hi_d, lo_d;
  mulhilo(kM1, hi_a ^ w.x, hi_d, lo_d);
  uint4 c = make_uint4(hi_d ^ w.y, lo_d, w.z ^ lo_a, w.w);
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(kM0, c.x, hi0, lo0);
    mulhilo(kM1, c.z, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k0[r], lo1, hi0 ^ c.w ^ k1[r], lo0);
  }
  return c;
}

// -g for the words (bits1, bits2): sqrt(-2 log u1) * cos(2 pi w), which is
// -sqrt(-2 log u1) * cos(2 pi u2) (u2 = 2 - f2, cos(2 pi u2) = -cos(2 pi w)).
__device__ __forceinline__ float minus_gaussian(uint32_t bits1, uint32_t bits2) {
  const float f1 = __uint_as_float((bits1 >> 9) | 0x3F800000u);  // [1, 2)
  const float f2 = __uint_as_float((bits2 >> 9) | 0x3F800000u);
  const float t = f1 - 1.0f;  // u1 = 1 - t, both exact
  const float near_one = t * fmaf(t, fmaf(t, 2.0f / 3.0f, 1.0f), 2.0f);
  const float far = kMinusTwoLn2 * lg2_approx(2.0f - f1);
  const float r = sqrt_approx(t < 0x1p-10f ? near_one : far);
  return r * cos_approx(kTwoPi * (f2 - 1.5f));
}

template <bool kVec>
__device__ __forceinline__ void load_quad(const float* x, long long e, long long elems, float* v) {
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(x + e);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = e + i < elems ? x[e + i] : 0.0f;
  }
}

// Streaming stores (st.global.cs): the output is written once and read by
// the next kernel, not by this one; with them the loads and stores alone run
// at 93 % of the byte rate, without them at 82 %.
template <bool kVec>
__device__ __forceinline__ void store_quad(float* o, long long e, long long elems, const float* v) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(o + e), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e + i < elems) __stcs(o + e + i, v[i]);
  }
}

// Block (bx, by): images [by * kImagesPerBlock, ...), quads of warp w =
// bx * 8 + warp: lane l owns quads w * 64 + l and w * 64 + 32 + l. kVec: the
// image size is a multiple of 4 and x, out are 16-byte aligned (every quad
// full and aligned); otherwise the same mapping with element loads and stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    noise_kernel(const float* __restrict__ x, const uint32_t* __restrict__ seed,
                 const float* __restrict__ sigma, float* __restrict__ out, long long elems, int n) {
  __shared__ uint4 words[kImagesPerBlock];
  const int img0 = blockIdx.y * kImagesPerBlock;
  const int imgs = min(kImagesPerBlock, n - img0);
  const uint32_t s0 = seed[0], s1 = seed[1];
  if (threadIdx.x < imgs) words[threadIdx.x] = image_words(img0 + threadIdx.x, s0, s1);
  uint32_t k0[7], k1[7];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    k0[r] = s0 + (r + 3) * kW0;
    k1[r] = s1 + (r + 3) * kW1;
  }
  const float neg_s = -*sigma;
  const long long quads = (elems + 3) / 4;
  const long long q0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
                           kQuadsPerWarp + threadIdx.x % 32;
  const long long q1 = q0 + 32;
  __syncthreads();
  if (q0 >= quads) return;
  const bool has_q1 = q1 < quads;
  float xv[8];
  load_quad<kVec>(x, 4 * q0, elems, xv);
  if (has_q1) load_quad<kVec>(x, 4 * q1, elems, xv + 4);
  uint32_t hi_a[4], lo_a[4];  // per pair: M0 (pair ^ s0), round 2
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t pair = static_cast<uint32_t>(2 * (p < 2 ? q0 : q1) + (p & 1));
    mulhilo(kM0, pair ^ s0, hi_a[p], lo_a[p]);
  }
  float* o = out + img0 * elems;
#pragma unroll 1
  for (int i = 0; i < imgs; ++i, o += elems) {
    const uint4 w = words[i];
    float v[8];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint4 c = philox_rest(hi_a[p], lo_a[p], w, k0, k1);
      v[2 * p] = fmaf(neg_s, minus_gaussian(c.x, c.y), xv[2 * p]);
      v[2 * p + 1] = fmaf(neg_s, minus_gaussian(c.z, c.w), xv[2 * p + 1]);
    }
    store_quad<kVec>(o, 4 * q0, elems, v);
    if (has_q1) store_quad<kVec>(o, 4 * q1, elems, v + 4);
  }
}

}  // namespace

// out [n, elems] = x [elems] + sigma * N(0, 1), image i keyed by (seed, i).
// seed: two uint32 words and sigma: one f32, both in device memory.
extern "C" int cgpt_noisy_tile(const void* x, const void* seed, const void* sigma, void* out,
                               long long elems, int n, void* stream) {
  const long long quads = (elems + 3) / 4;
  const long long blocks = (quads + kThreads / 32 * kQuadsPerWarp - 1) / (kThreads / 32 * kQuadsPerWarp);
  if (elems <= 0 || n <= 0 || n > 65535 || (elems + 1) / 2 > 0xFFFFFFFFLL || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (n + kImagesPerBlock - 1) / kImagesPerBlock);
  const bool vec = elems % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel = vec ? noise_kernel<true> : noise_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(seed),
      static_cast<const float*>(sigma), static_cast<float*>(out), elems, n);
  return static_cast<int>(cudaGetLastError());
}
