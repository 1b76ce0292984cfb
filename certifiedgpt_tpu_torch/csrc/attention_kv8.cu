// Attention over the decoder's int8 KV cache on Hopper (sm_90a), the cache
// dequantized inside the kernel: no dequantized copy is made.
//
// Replaces the JAX package's multi_head_attention_kv8
// (certifiedgpt_tpu/ops/attention.py:76-135), which XLA fuses so that the
// int8 -> bf16 convert rides the matrix unit's feed and the per-row scales
// multiply the small score and weight tensors. The arithmetic is the plain
// version's (ops/attention.py::_multi_head_attention_kv8_plain), in order:
//   logits[t] = (sum_d q[d] * kq8[t, d]) * ks[t] * scale     (f32 sums)
//   where(mask, logits, f32_min), minus the row max, exp, where(mask, w, 0),
//   divided by max(sum, f32_tiny)    (a fully masked row gives zeros)
//   p[t] = bf16(w[t] * vs[t])
//   out[d] = bf16(sum_t p[t] * vq8[t, d])                       (f32 sums)
// The products are exact in f32 (bf16 times int8, and int8 -> bf16 is
// exact), so only the order of the f32 sums and the exponential's last bits
// differ from the plain version.
//
// This is the warp-a-row instance, which serves f32 queries (the tiny and
// f32 configurations; p is then not rounded to bf16, as in the plain
// version), a lone query row outside the decoder's decode step, and bf16
// queries of another head_dim than 128. bf16 queries of several rows at
// head_dim 128 (the prefill) take csrc/attention_kv8_prefill.cu, and the
// decode step csrc/attention_kv8_decode.cu; the wrapper
// (ops/attention.py::multi_head_attention_kv8) dispatches on dtype and shape.
//
// Bound on the H100: bytes (the cache; at one query row the 0.1 GFLOP of
// the two contractions are nothing). f32 FMAs on the CUDA cores. The warp
// keeps the row's q in f32 and its T logits in shared memory: the logits
// pass gives each lane whole keys (positions lane, lane + 32, ...; 16 cache
// bytes a load, L1 serving the other rows of the block), the softmax runs
// two passes over the row, and the output pass gives each lane four
// neighbouring dimensions and walks the positions, skipping those whose
// weight is 0 (masked: exact). Masked positions compute no logit. Shared
// memory is (Dh + T) floats a warp, so T is bounded by 227 KB, not by the
// cache's size; the launcher returns kCacheTooLong for a T that does not
// fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxHeadDim = 256;
// the launcher's code for a cache whose rows of logits do not fit in shared memory
constexpr int kCacheTooLong = -1;

template <typename E>
struct Args {
  const E* q;  // [B, Sq, H, Dh], strides in elements
  long long q_b, q_s, q_h;
  const int8_t* k;  // [B, T, Hkv, Dh] (k and v share the strides)
  const int8_t* v;
  long long c_b, c_t, c_h;
  const float* ks;  // [B, T, Hkv] (ks and vs share the strides)
  const float* vs;
  long long s_b, s_t, s_h;
  const uint8_t* mask;  // bool [B, Sq, T] by strides (0 for broadcast), or null
  long long m_b, m_s, m_t;
  E* out;  // [B, Sq, H, Dh] contiguous
  int B, Sq, H, Hkv, T, Dh;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

template <typename E>
__device__ __forceinline__ bool keep(const Args<E>& a, int b, int s, int t) {
  return a.mask == nullptr || a.mask[b * a.m_b + s * a.m_s + t * a.m_t] != 0;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// p in q's dtype, back in f32: rounded to bf16 for bf16 q, kept for f32
__device__ __forceinline__ float in_dtype(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float in_dtype(float v, const float*) { return v; }

__device__ __forceinline__ void store4(__nv_bfloat16* o, float o0, float o1, float o2, float o3) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(o0, o1);
  *reinterpret_cast<__nv_bfloat162*>(o + 2) = __floats2bfloat162_rn(o2, o3);
}
__device__ __forceinline__ void store4(float* o, float o0, float o1, float o2, float o3) {
  *reinterpret_cast<float4*>(o) = make_float4(o0, o1, o2, o3);
}

// E: q's and the output's dtype (bf16 or f32)
template <typename E>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_kv8_kernel(const Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int g = a.H / a.Hkv, rows = g * a.Sq, T = a.T, Dh = a.Dh;
  float* qf = smem + warp * (Dh + T);
  float* lg = qf + Dh;
  const int8_t* kb = a.k + b * a.c_b + hk * a.c_h;
  const int8_t* vb = a.v + b * a.c_b + hk * a.c_h;
  const float* ksb = a.ks + b * a.s_b + hk * a.s_h;
  const float* vsb = a.vs + b * a.s_b + hk * a.s_h;

  for (int r = warp; r < rows; r += warps) {
    const int gi = r / a.Sq, s = r % a.Sq, h = hk * g + gi;
    const E* qrow = a.q + b * a.q_b + s * a.q_s + h * a.q_h;
    for (int d = lane; d < Dh; d += 32) qf[d] = to_f32(qrow[d]);
    __syncwarp();
    // logits: a lane a key
    float mx = -FLT_MAX;
    for (int t = lane; t < T; t += 32) {
      float l = -FLT_MAX;
      if (keep(a, b, s, t)) {
        const int8_t* krow = kb + t * a.c_t;
        float dot = 0.f;
        for (int d0 = 0; d0 < Dh; d0 += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(krow + d0);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) dot = fmaf(qf[d0 + 4 * j + i], byte_f(ws[j], i), dot);
          }
        }
        l = __fmul_rn(__fmul_rn(dot, ksb[t * a.s_t]), a.scale);
      }
      lg[t] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    // the masked softmax's numerators and their sum
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float w = keep(a, b, s, t) ? expf(__fsub_rn(lg[t], mx)) : 0.f;
      lg[t] = w;
      sum = __fadd_rn(sum, w);
    }
    const float den = fmaxf(warp_sum(sum), FLT_MIN);
    for (int t = lane; t < T; t += 32) {
      lg[t] = in_dtype(__fmul_rn(__fdiv_rn(lg[t], den), vsb[t * a.s_t]), a.q);
    }
    __syncwarp();
    // out: a lane four neighbouring dimensions
    E* orow =
        a.out + ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * static_cast<long long>(Dh);
    for (int d0 = 4 * lane; d0 < Dh; d0 += 128) {
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
      for (int t = 0; t < T; ++t) {
        const float p = lg[t];
        if (p == 0.f) continue;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vb + t * a.c_t + d0);
        o0 = fmaf(p, byte_f(w, 0), o0);
        o1 = fmaf(p, byte_f(w, 1), o1);
        o2 = fmaf(p, byte_f(w, 2), o2);
        o3 = fmaf(p, byte_f(w, 3), o3);
      }
      store4(orow + d0, o0, o1, o2, o3);
    }
    __syncwarp();  // the row's q and weights are read before the next row's writes
  }
}

template <typename E>
void launch(const Args<E>& a, int warps, long long smem, cudaStream_t stream) {
  attention_kv8_kernel<E><<<a.B * a.Hkv, warps * 32, static_cast<size_t>(smem), stream>>>(a);
}

}  // namespace

// q [B, Sq, H, Dh] bf16 (f32 with q_f32) by strides (last dim contiguous);
// k, v int8 cache [B, T, Hkv, Dh] by strides (last dim contiguous, a 16-byte
// aligned row);
// ks, vs f32 [B, T, Hkv] by strides; mask bool [B, Sq, T] by strides or null;
// out [B, Sq, H, Dh] in q's dtype, contiguous. H a multiple of Hkv, Dh a
// multiple of 16 up to 256; `warps` warps a block. Returns kCacheTooLong when
// the warps' rows of Dh + T floats exceed the card's shared memory.
extern "C" int cgpt_attention_kv8(const void* q, long long q_b, long long q_s, long long q_h,
                                  const void* k, const void* v, long long c_b, long long c_t,
                                  long long c_h, const void* ks, const void* vs, long long s_b,
                                  long long s_t, long long s_h, const void* mask, long long m_b,
                                  long long m_s, long long m_t, void* out, int B, int Sq, int H,
                                  int Hkv, int T, int Dh, float scale, int warps, int q_f32,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh % 16 != 0 || Dh <= 0 ||
      Dh > kMaxHeadDim || warps < 1 || warps > kMaxWarps || c_t % 16 != 0 || c_h % 16 != 0 ||
      c_b % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || static_cast<long long>(B) * Hkv > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = 4LL * warps * (Dh + T);
  // a device's shared-memory limit, read and granted to both instances at
  // its first call: a launch captured in a CUDA graph makes no query
  static int most_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (most_of[dev] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* rows[] = {reinterpret_cast<const void*>(attention_kv8_kernel<__nv_bfloat16>),
                          reinterpret_cast<const void*>(attention_kv8_kernel<float>)};
    for (const void* fn : rows) {  // the L1 keeps what it has: it serves the block's rows
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    most_of[dev] = most;
  }
  if (smem > most_of[dev]) return kCacheTooLong;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k8 = static_cast<const int8_t*>(k), v8 = static_cast<const int8_t*>(v);
  const auto ksf = static_cast<const float*>(ks), vsf = static_cast<const float*>(vs);
  const auto m8 = static_cast<const uint8_t*>(mask);
  if (q_f32) {
    launch(Args<float>{static_cast<const float*>(q), q_b, q_s, q_h, k8, v8, c_b, c_t, c_h, ksf,
                       vsf, s_b, s_t, s_h, m8, m_b, m_s, m_t, static_cast<float*>(out), B, Sq, H,
                       Hkv, T, Dh, scale},
           warps, smem, st);
  } else {
    launch(Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(q), q_b, q_s, q_h, k8, v8, c_b,
                               c_t, c_h, ksf, vsf, s_b, s_t, s_h, m8, m_b, m_s, m_t,
                               static_cast<__nv_bfloat16*>(out), B, Sq, H, Hkv, T, Dh, scale},
           warps, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
