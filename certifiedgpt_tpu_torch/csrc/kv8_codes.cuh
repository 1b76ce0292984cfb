// The int8 codes of quantize_rows (certifiedgpt_tpu/ops/quantization.py:52-65)
// from reciprocal products, bit for bit the IEEE divisions: shared by the
// int8-KV kernels that quantize new K/V rows (csrc/attention_kv8_prefill.cu,
// csrc/attention_kv8.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cgpt_kv8 {

// rint(x / xs) for N values of a row, x / xs an IEEE division, bit for
// bit (the clip to +-127 of the plain version never acts: |x| <= amax, so
// |x / xs| <= 127 (1 + 2^-24)), from the products y = x * rcp (rcp = 1 / xs
// correctly rounded): y is within 2^-16 of the exact quotient and the IEEE
// quotient within 2^-18 of it, so rint(y) is rint(x / xs) unless y lies
// within 2^-15 of a half-integer; only when one of the lane's values does
// (rare: mostly exact ties of bf16 values) is the division made, for those
// values. rint(y) is 1.5 * 2^23 + y rounded, less
// 1.5 * 2^23; the low byte of that sum is the code's two's complement byte.
// Returns the codes as f32 and as int8 bytes, four a word. rcp = 1 / xs
// correctly rounded (__frcp_rn).
template <int N>
__device__ __forceinline__ void codes_of(const float (&x)[N], float xs, float rcp, float (&q)[N],
                                         uint32_t (&bytes)[N / 4]) {
  constexpr float kMagic = 12582912.f;          // 1.5 * 2^23
  constexpr float kNear = 0.49993896484375f;    // 0.5 - 2^-14
  uint32_t u[N];
  float far = 0.f;  // the largest |y - rint(y)|
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float y = __fmul_rn(x[j], rcp);
    const float r = __fadd_rn(y, kMagic);
    u[j] = __float_as_uint(r);
    q[j] = __fsub_rn(r, kMagic);
    far = fmaxf(far, fabsf(__fsub_rn(y, q[j])));
  }
  if (far > kNear) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (fabsf(__fsub_rn(__fmul_rn(x[j], rcp), q[j])) > kNear) {
        q[j] = rintf(__fdiv_rn(x[j], xs));
        u[j] = __float_as_uint(__fadd_rn(q[j], kMagic));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    bytes[k] = __byte_perm(__byte_perm(u[4 * k], u[4 * k + 1], 0x0040),
                           __byte_perm(u[4 * k + 2], u[4 * k + 3], 0x0040), 0x5410);
  }
}

}  // namespace cgpt_kv8
