// The decoder block's elementwise chains on Hopper (sm_90a): three kernels,
// each with a bf16 and an f32 instance.
//
// They replace no Pallas kernel: the JAX package's decoder block is XLA code
// (certifiedgpt_tpu/models/llama.py:214-287), and XLA fuses these chains into
// a few passes over device memory. Run as eager PyTorch, each chain is a row
// of separate launches with f32 intermediates written and read back.
//
//   add_rms_norm_kernel  the residual add (llama.py:281, :286) into the RMSNorm
//                        that follows it (models/layers.py:110, llama.py:230,
//                        :283, :418), and optionally the W8A8 input's
//                        quantize_rows (ops/quantization.py:52-65):
//                          s = dtype(x + y);  h = dtype(s * rsqrt(mean(s^2) + eps) * g)
//                        writes s (when there is a y) and either h or h's int8
//                        codes and per-row f32 scale.
//   rotary_kernel        apply_rotary of q and k (layers.py:150, llama.py:235-236),
//                        rotate-half in f32 from the f32 cos/sin tables gathered
//                        by each token's position on the device, in place:
//                          out = dtype(x * cos + rotate_half(x) * sin)
//   silu_mul_kernel      silu(gate) * up (llama.py:284-286, layers.py:220) and
//                        optionally the down_proj input's quantize_rows:
//                          a = dtype(dtype(silu(g)) * u)
//
// and the three backward kernels of the training step, where the JAX package
// lets autodiff differentiate the same chains and XLA fuses the backward:
//
//   add_rms_norm_grad_kernel  the gradient of s = x + y through the norm, from the
//                        saved s and the norm's output gradient g (and the
//                        gradient gs that later uses of s hand back):
//                          r = rsqrt(mean(s^2) + eps);  gw = g * w
//                          gx = dtype(dtype(gw r + ((-0.5 sum(gw s)) r^3 / K) 2s) + gs)
//   rotary_grad_kernel   the rotary's transpose, the rotation by -theta, of q's and
//                        k's gradients in one launch, into new tensors:
//                          g1' = g1 cos + g2 sin;  g2' = g2 cos - g1 sin
//   silu_mul_grad_kernel the gradients of a = dtype(dtype(silu(g)) * u):
//                          gu = dtype(ga * dtype(silu(g)));  t = dtype(ga * u)
//                          gg = dtype(t * sig(g) * (1 + g (1 - sig(g))))
//
// Every step rounds as the plain chain does (ops/elementwise.py: the plain
// versions): f32 products and sums one at a time with no fused multiply-add,
// rounded to the activation dtype where the chain rounds. rsqrt is rsqrtf and
// the SiLU is g / (1 + expf(-g)), the functions PyTorch's CUDA kernels call.
// The only step whose order differs is the RMSNorm's sum of squares (a fixed
// per-thread, warp, then block order here), so the normalized rows agree
// with the plain version's to an ulp of the sum and may differ by one bf16
// ulp in rare elements; the residual sum, the rotary and the SiLU product
// are the plain version's bit for bit. The codes are rint(h / xs) with one
// IEEE division an element, xs = max(absmax, 1e-8) / 127, as quantize_rows.
// The backward kernels repeat the steps of autograd's backward of the plain
// chains in order (PyTorch's silu_backward, whose 1 + g (1 - sig) is one
// fused multiply-add on the card, included); the norm's two row sums (of s^2
// and of gw s) run in the kernel's order, so its gradient agrees with the
// plain version's to a few f32 ulps of |gw r| + |the second term|, the rotary's
// and the SiLU's are the plain version's bit for bit.
//
// Bound on the H100: bytes. A prefill layer at the certify chunk (9216 rows):
// add + RMSNorm + quant reads x, y (2 x 75.5 MB) and writes the sum and the
// codes (75.5 + 37.7 MB); the rotary reads and writes q and k (4 x 75.5 MB);
// SiLU x up + quant reads gate and up (2 x 203 MB) and writes the codes
// (101 MB): 0.079, 0.090 and 0.151 ms at 3.35 TB/s. At a decode step (96
// rows, or 1) each is one launch of a few microseconds: there the launch
// count is what counts. Measured alone (H100 80GB HBM3, 700 W, chip_smoke.py
// phase 20): 0.102, 0.164 and 0.277 ms at the prefill's shapes; 0.004,
// 0.004 and 0.011 ms at the decode's.
//
// Design: simple and right first. add_rms_norm and silu_mul give a block of
// up to 256 threads one row; a thread takes quads i, i + 4 x threads, ...
// (one 8- or 16-byte load each), keeps its values in a row buffer in shared
// memory that only it reads back (no barrier on the buffer), and the block
// reduces its sums and maxima through shared memory. The rotary walks
// (token, head, pair) units with a grid-stride loop: a thread reads two
// neighbouring values of the first half of a head and the two that face
// them in the second half, so it can write all four in place (or, for the
// training forward, into new tensors). The rotary's backward gives a block
// a token: the token's cos and sin rows staged in shared memory once, the
// 16-byte chunks of each head's two halves on neighbouring threads (the
// forward's unit-a-thread form, 4-byte accesses and 64-bit index divisions,
// ran at 48 % of this bound on an H100). The norm's backward gives a block a
// row, keeps s and gw in shared memory between its two
// passes and reduces both row sums at once; the SiLU's backward walks quads
// of the [M, N] operands with a grid-stride loop.
//
// Bounds at a train step's shapes (16 x 256 = 4096 rows): the norm's
// backward reads s, g, gs and writes gx, [4096, 4096] (134 MB, 0.040 ms); the
// rotary's reads and writes q's and k's gradients (134 MB, 0.040 ms); the
// SiLU's reads g, gate, up and writes two gradients, [4096, 11008] (451 MB,
// 0.135 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRotaryThreads = 256;
constexpr int kMaxRowWidth = 32768;  // a row buffer of f32 values in shared memory
constexpr int kMaxGradRowWidth = 16384;  // the norm's backward: two f32 rows in shared memory
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// v rounded to T and back to f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// four neighbouring values (8 bytes of bf16, 16 of f32)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &w.x, 4);
  memcpy(&b, &w.y, 4);
  v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  memcpy(&w.x, &a, 4);
  memcpy(&w.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// two neighbouring values (4 bytes of bf16, 8 of f32)
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(w), b = __high2float(w);
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  a = w.x, b = w.y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum (or max) of v, every thread's, in a fixed order: the warp
// butterfly, then the warps in order. `red` holds 32 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // the previous reduction's reads of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) r = kMax ? fmaxf(r, red[w]) : __fadd_rn(r, red[w]);
  return r;
}

// The row's scale and codes from the dtype-rounded values in `row` (each
// thread reads back the quads it wrote), `amax` this thread's |max| of them.
__device__ __forceinline__ void quantize_tail(const float* row, int K, float amax, int8_t* q,
                                              float* qs, float* red) {
  const float xs = __fdiv_rn(fmaxf(block_reduce<true>(amax, red), 1e-8f), 127.f);
  if (threadIdx.x == 0) *qs = xs;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * blockDim.x) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c = fminf(fmaxf(rintf(__fdiv_rn(row[i + j], xs)), -127.f), 127.f);
      w |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xffu) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(q + i) = w;
  }
}

struct NormArgs {
  const void* x;
  const void* y;  // the residual rows added into x, or null
  void* sum;      // x + y (written when y is not null)
  const void* scale;
  int scale_f32;
  void* out;  // the normalized rows (no quantization)
  int8_t* q;  // or their codes
  float* qs;  // and per-row scales
  int K;
  float eps;
};

// One block a row: s = dtype(x + y) and the sum of s^2; rs = rsqrt(mean + eps);
// h = dtype((s * rs) * g), written out or quantized.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kRowThreads) add_rms_norm_kernel(const NormArgs a) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[32];
  const int K = a.K;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* y = a.y == nullptr ? nullptr : static_cast<const T*>(a.y) + base;
  float ss = 0.f;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * blockDim.x) {
    float v[4];
    load4(x + i, v);
    if (y != nullptr) {
      float w[4];
      load4(y + i, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = round_to<T>(__fadd_rn(v[j], w[j]));
      store4(static_cast<T*>(a.sum) + base + i, v);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[i + j] = v[j];
      ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  }
  const float var = __fdiv_rn(block_reduce<false>(ss, red), static_cast<float>(K));
  const float rs = rsqrtf(__fadd_rn(var, a.eps));
  float amax = 0.f;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * blockDim.x) {
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = a.scale_f32 ? static_cast<const float*>(a.scale)[i + j]
                                  : __bfloat162float(static_cast<const __nv_bfloat16*>(a.scale)[i + j]);
      h[j] = round_to<T>(__fmul_rn(__fmul_rn(row[i + j], rs), g));
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row[i + j] = h[j];
        amax = fmaxf(amax, fabsf(h[j]));
      }
    } else {
      store4(static_cast<T*>(a.out) + base + i, h);
    }
  }
  if constexpr (kQuant) quantize_tail(row, K, amax, a.q + base, a.qs + blockIdx.x, red);
}

struct SiluArgs {
  const void* gate;
  const void* up;
  void* out;
  int8_t* q;
  float* qs;
  int N;
};

// One block a row: a = dtype(dtype(g / (1 + exp(-g))) * u), written out or quantized.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kRowThreads) silu_mul_kernel(const SiluArgs a) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[32];
  const int N = a.N;
  const long long base = static_cast<long long>(blockIdx.x) * N;
  float amax = 0.f;
  for (int i = 4 * threadIdx.x; i < N; i += 4 * blockDim.x) {
    float g[4], u[4];
    load4(static_cast<const T*>(a.gate) + base + i, g);
    load4(static_cast<const T*>(a.up) + base + i, u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = round_to<T>(__fdiv_rn(g[j], __fadd_rn(1.f, expf(-g[j]))));
      g[j] = round_to<T>(__fmul_rn(s, u[j]));
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row[i + j] = g[j];
        amax = fmaxf(amax, fabsf(g[j]));
      }
    } else {
      store4(static_cast<T*>(a.out) + base + i, g);
    }
  }
  if constexpr (kQuant) quantize_tail(row, N, amax, a.q + base, a.qs + blockIdx.x, red);
}

struct RotaryArgs {
  const void* q;  // the rows read
  long long q_b, q_s, q_h;  // strides in elements
  const void* k;
  long long k_b, k_s, k_h;
  void* oq;  // the rows written (q itself in place)
  long long oq_b, oq_s, oq_h;
  void* ok;
  long long ok_b, ok_s, ok_h;
  const float* cos;  // [max_len, Dh]
  const float* sin;
  const void* pos;  // [B, S] int32 or int64
  long long p_b, p_s;
  int pos_i64;
  int S, Hq, Hk, Dh, max_len;
  long long units;  // B * S * (Hq + Hk) * Dh / 4
};

// Unit u: pair j of a head (values 2j, 2j + 1 and Dh/2 + 2j, Dh/2 + 2j + 1)
// of q's or k's heads of token (b, s), rotated by theta. In place
// (kInPlace) the rows are written where they were read, with no address of
// their own to compute.
template <typename T, bool kInPlace>
__device__ __forceinline__ void rotate(const RotaryArgs& a) {
  const int pairs = a.Dh / 4, half = a.Dh / 2, heads = a.Hq + a.Hk;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < a.units;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(u % pairs);
    const long long r = u / pairs;
    const int head = static_cast<int>(r % heads);
    const long long tok = r / heads;
    const long long s = tok % a.S, b = tok / a.S;
    const long long at = b * a.p_b + s * a.p_s;
    const long long p = a.pos_i64 ? static_cast<const long long*>(a.pos)[at]
                                  : static_cast<long long>(static_cast<const int*>(a.pos)[at]);
    if (p < 0 || p >= a.max_len) __trap();  // a position outside the tables
    const bool isq = head < a.Hq;
    const int h = isq ? head : head - a.Hq;
    T* o = isq ? static_cast<T*>(a.oq) + b * a.oq_b + s * a.oq_s + h * a.oq_h
               : static_cast<T*>(a.ok) + b * a.ok_b + s * a.ok_s + h * a.ok_h;
    const T* v = kInPlace ? o
                          : isq ? static_cast<const T*>(a.q) + b * a.q_b + s * a.q_s + h * a.q_h
                                : static_cast<const T*>(a.k) + b * a.k_b + s * a.k_s + h * a.k_h;
    const float* c = a.cos + p * a.Dh;
    const float* sn = a.sin + p * a.Dh;
    const int lo = 2 * j, hi = half + 2 * j;
    float x0, x1, x2, x3;
    load2(v + lo, x0, x1);
    load2(v + hi, x2, x3);
    // x * cos + rotate_half(x) * sin; rotate_half is (-x[half:], x[:half])
    const float o0 = __fadd_rn(__fmul_rn(x0, c[lo]), __fmul_rn(-x2, sn[lo]));
    const float o1 = __fadd_rn(__fmul_rn(x1, c[lo + 1]), __fmul_rn(-x3, sn[lo + 1]));
    const float o2 = __fadd_rn(__fmul_rn(x2, c[hi]), __fmul_rn(x0, sn[hi]));
    const float o3 = __fadd_rn(__fmul_rn(x3, c[hi + 1]), __fmul_rn(x1, sn[hi + 1]));
    store2(o + lo, o0, o1);
    store2(o + hi, o2, o3);
  }
}

template <typename T, bool kInPlace>
__global__ void __launch_bounds__(kRotaryThreads) rotary_kernel(const RotaryArgs a) {
  rotate<T, kInPlace>(a);
}

// kV neighbouring values from p (16 bytes at kV = 16 / sizeof(T))
template <int kV>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kV]) {
  if constexpr (kV == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &u[i], 4);
      v[2 * i] = __low2float(h), v[2 * i + 1] = __high2float(h);
    }
  } else {
    static_assert(kV == 2, "bf16 pairs or 16-byte vectors");
    load2(p, v[0], v[1]);
  }
}

template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    load4(p, v);
  } else {
    static_assert(kV == 2, "f32 pairs or 16-byte vectors");
    load2(p, v[0], v[1]);
  }
}

template <int kV>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[kV]) {
  if constexpr (kV == 8) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&u[i], &h, 4);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    store2(p, v[0], v[1]);
  }
}

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    store4(p, v);
  } else {
    store2(p, v[0], v[1]);
  }
}

// The rotary's transpose, one block a token (b, s): the token's cos and sin
// rows are staged in shared memory once, then each thread takes chunks of
// kV neighbouring values of a head's first half and the kV facing them in
// the second, chunks of a head on neighbouring threads (16-byte accesses at
// kV = 16 / sizeof(T)):
//   o1 = g1 cos1 + g2 sin2;  o2 = g2 cos2 + (-g1) sin1
// the table entries autograd's backward of the plain chain multiplies by,
// each product and sum rounded in f32 (no fused multiply-add).
template <typename T, int kV>
__global__ void __launch_bounds__(kRotaryThreads) rotary_grad_kernel(const RotaryArgs a) {
  extern __shared__ float table[];  // cos row, then sin row
  const int half = a.Dh / 2, chunks = half / kV, heads = a.Hq + a.Hk;
  const long long tok = blockIdx.x;
  const long long s = tok % a.S, b = tok / a.S;
  const long long at = b * a.p_b + s * a.p_s;
  const long long p = a.pos_i64 ? static_cast<const long long*>(a.pos)[at]
                                : static_cast<long long>(static_cast<const int*>(a.pos)[at]);
  if (p < 0 || p >= a.max_len) __trap();  // a position outside the tables
  for (int i = threadIdx.x; i < a.Dh; i += blockDim.x) {
    table[i] = a.cos[p * a.Dh + i];
    table[a.Dh + i] = a.sin[p * a.Dh + i];
  }
  __syncthreads();
  const float* c = table;
  const float* sn = table + a.Dh;
  for (int u = threadIdx.x; u < heads * chunks; u += blockDim.x) {
    const int head = u / chunks, lo = (u - head * chunks) * kV, hi = half + lo;
    const bool isq = head < a.Hq;
    const int h = isq ? head : head - a.Hq;
    const T* v = isq ? static_cast<const T*>(a.q) + b * a.q_b + s * a.q_s + h * a.q_h
                     : static_cast<const T*>(a.k) + b * a.k_b + s * a.k_s + h * a.k_h;
    T* o = isq ? static_cast<T*>(a.oq) + b * a.oq_b + s * a.oq_s + h * a.oq_h
               : static_cast<T*>(a.ok) + b * a.ok_b + s * a.ok_s + h * a.ok_h;
    float x1[kV], x2[kV], o1[kV], o2[kV];
    load_vec<kV>(v + lo, x1);
    load_vec<kV>(v + hi, x2);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      // g * cos + rotate_half^T(g * sin); rotate_half^T(t) is (t[half:], -t[:half])
      o1[e] = __fadd_rn(__fmul_rn(x1[e], c[lo + e]), __fmul_rn(x2[e], sn[hi + e]));
      o2[e] = __fadd_rn(__fmul_rn(x2[e], c[hi + e]), __fmul_rn(-x1[e], sn[lo + e]));
    }
    store_vec<kV>(o + lo, o1);
    store_vec<kV>(o + hi, o2);
  }
}


struct NormGradArgs {
  const void* s;   // the saved residual stream x + y
  const void* g;   // the gradient of the norm's output
  const void* gs;  // the gradient of s from its other uses, or null
  const void* scale;
  int scale_f32;
  void* gx;  // the gradient of x (and of y)
  int K;
  float eps;
};

// One block a row, the steps of autograd's backward of rms_norm_plain:
// gw = g * w; r = rsqrt(mean(s^2) + eps); gr = sum(gw * s);
// gx = dtype(gw * r + (((-0.5 * gr) * r^3) / K) * (2 * s)), plus gs in the dtype
// (in f32, where no rounding separates them, gs + gw * r first, as autograd).
template <typename T>
__global__ void __launch_bounds__(kRowThreads) add_rms_norm_grad_kernel(const NormGradArgs a) {
  extern __shared__ __align__(16) float buf[];  // s, then gw: 2 K floats
  __shared__ float red[32];
  const int K = a.K;
  float* sv = buf;
  float* gwv = buf + K;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  const T* s = static_cast<const T*>(a.s) + base;
  const T* g = static_cast<const T*>(a.g) + base;
  float ss = 0.f, gr = 0.f;
  for (int i = 4 * threadIdx.x; i < K; i += 4 * blockDim.x) {
    float v[4], d[4];
    load4(s + i, v);
    load4(g + i, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = a.scale_f32 ? static_cast<const float*>(a.scale)[i + j]
                                  : __bfloat162float(static_cast<const __nv_bfloat16*>(a.scale)[i + j]);
      const float gw = __fmul_rn(d[j], w);
      sv[i + j] = v[j];
      gwv[i + j] = gw;
      ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
      gr = __fadd_rn(gr, __fmul_rn(gw, v[j]));
    }
  }
  const float var = __fdiv_rn(block_reduce<false>(ss, red), static_cast<float>(K));
  const float r = rsqrtf(__fadd_rn(var, a.eps));
  const float r3 = __fmul_rn(__fmul_rn(r, r), r);
  const float coef = __fdiv_rn(__fmul_rn(__fmul_rn(-0.5f, block_reduce<false>(gr, red)), r3),
                               static_cast<float>(K));
  const T* gs = a.gs == nullptr ? nullptr : static_cast<const T*>(a.gs) + base;
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  for (int i = 4 * threadIdx.x; i < K; i += 4 * blockDim.x) {
    float o[4], e[4];
    if (gs != nullptr) load4(gs + i, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t1 = __fmul_rn(gwv[i + j], r);
      const float t2 = __fmul_rn(coef, __fmul_rn(2.f, sv[i + j]));
      if constexpr (kF32) {  // no rounding between the terms: autograd adds gs first
        o[j] = gs != nullptr ? __fadd_rn(__fadd_rn(e[j], t1), t2) : __fadd_rn(t1, t2);
      } else {
        o[j] = round_to<T>(__fadd_rn(t1, t2));
        if (gs != nullptr) o[j] = __fadd_rn(o[j], e[j]);
      }
    }
    store4(static_cast<T*>(a.gx) + base + i, o);
  }
}

struct SiluGradArgs {
  const void* g;  // the gradient of silu(gate) * up
  const void* gate;
  const void* up;
  void* g_gate;
  void* g_up;
  long long quads;  // M * N / 4
};

// Quads of the operands with a grid-stride loop: gu = dtype(g * a) with a =
// dtype(silu(gate)); ga = dtype(g * up); gg = dtype(silu_backward(ga, gate)) as
// PyTorch's CUDA kernel computes it: (ga * sig) * fma(gate, 1 - sig, 1).
template <typename T>
__global__ void __launch_bounds__(kRotaryThreads) silu_mul_grad_kernel(const SiluGradArgs a) {
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < a.quads;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = 4 * u;
    float d[4], x[4], up[4], gg[4], gu[4];
    load4(static_cast<const T*>(a.g) + i, d);
    load4(static_cast<const T*>(a.gate) + i, x);
    load4(static_cast<const T*>(a.up) + i, up);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = __fadd_rn(1.f, expf(-x[j]));
      gu[j] = __fmul_rn(d[j], round_to<T>(__fdiv_rn(x[j], e)));
      const float ga = round_to<T>(__fmul_rn(d[j], up[j]));
      const float sig = __fdiv_rn(1.f, e);
      gg[j] = __fmul_rn(__fmul_rn(ga, sig), __fmaf_rn(x[j], __fsub_rn(1.f, sig), 1.f));
    }
    store4(static_cast<T*>(a.g_gate) + i, gg);
    store4(static_cast<T*>(a.g_up) + i, gu);
  }
}

// The current device's SM count, queried once a device (a launch inside a
// CUDA graph capture then makes no device query).
cudaError_t multiprocessors(int* sms) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) known[dev] = *sms;
  return err;
}

bool misaligned(const void* p, int bytes) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

int row_threads(int K) {
  const int quads = K / 4;
  const int warps = (quads + 31) / 32;
  return warps * 32 < kRowThreads ? warps * 32 : kRowThreads;
}

// Dynamic shared memory above the default needs the kernel's attribute set.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, bool kQuant>
int launch_norm(const NormArgs& a, long long M, cudaStream_t st) {
  const size_t smem = 4 * static_cast<size_t>(a.K);
  const void* kernel = reinterpret_cast<const void*>(add_rms_norm_kernel<T, kQuant>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_rms_norm_kernel<T, kQuant><<<static_cast<unsigned>(M), row_threads(a.K), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kQuant>
int launch_silu(const SiluArgs& a, long long M, cudaStream_t st) {
  const size_t smem = kQuant ? 4 * static_cast<size_t>(a.N) : 0;
  const void* kernel = reinterpret_cast<const void*>(silu_mul_kernel<T, kQuant>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  silu_mul_kernel<T, kQuant><<<static_cast<unsigned>(M), row_threads(a.N), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A grid-stride launch of `units` over at most 8 blocks an SM.
cudaError_t stride_grid(long long units, unsigned* grid) {
  int sms = 0;
  const cudaError_t err = multiprocessors(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks = (units + kRotaryThreads - 1) / kRotaryThreads;
  const long long most = 8LL * sms;
  *grid = static_cast<unsigned>(blocks < most ? blocks : most);
  return cudaSuccess;
}

template <typename T>
int launch_norm_grad(const NormGradArgs& a, long long M, cudaStream_t st) {
  const size_t smem = 8 * static_cast<size_t>(a.K);
  const void* kernel = reinterpret_cast<const void*>(add_rms_norm_grad_kernel<T>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_rms_norm_grad_kernel<T><<<static_cast<unsigned>(M), row_threads(a.K), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] (+ y) -> sum, and out [M, K] or q [M, K] int8 + qs [M] f32. bf16
// (f32 = 0) or f32 rows; the scale [K] bf16 or f32.
extern "C" int cgpt_add_rms_norm(const void* x, const void* y, void* sum, const void* scale,
                                 int scale_f32, void* out, void* q, void* qs, long long M, int K,
                                 float eps, int f32, int quant, void* stream) {
  const int vec = f32 ? 16 : 8;
  if (M < 0 || M > 0x7fffffffLL || K <= 0 || K % 4 != 0 || K > kMaxRowWidth ||
      misaligned(x, vec) || misaligned(y, vec) || misaligned(sum, vec) ||
      misaligned(out, vec) || misaligned(q, 4) || (y != nullptr && sum == nullptr) ||
      (quant ? (q == nullptr || qs == nullptr) : out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const NormArgs a{x, y, sum, scale, scale_f32, out, static_cast<int8_t*>(q),
                   static_cast<float*>(qs), K, eps};
  auto st = static_cast<cudaStream_t>(stream);
  if (f32) return quant ? launch_norm<float, true>(a, M, st) : launch_norm<float, false>(a, M, st);
  return quant ? launch_norm<__nv_bfloat16, true>(a, M, st)
               : launch_norm<__nv_bfloat16, false>(a, M, st);
}

// gate, up [M, N] -> out [M, N] or q [M, N] int8 + qs [M] f32.
extern "C" int cgpt_silu_mul(const void* gate, const void* up, void* out, void* q, void* qs,
                             long long M, int N, int f32, int quant, void* stream) {
  const int vec = f32 ? 16 : 8;
  if (M < 0 || M > 0x7fffffffLL || N <= 0 || N % 4 != 0 || (quant && N > kMaxRowWidth) ||
      misaligned(gate, vec) || misaligned(up, vec) || misaligned(out, vec) || misaligned(q, 4) ||
      (quant ? (q == nullptr || qs == nullptr) : out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const SiluArgs a{gate, up, out, static_cast<int8_t*>(q), static_cast<float*>(qs), N};
  auto st = static_cast<cudaStream_t>(stream);
  if (f32) return quant ? launch_silu<float, true>(a, M, st) : launch_silu<float, false>(a, M, st);
  return quant ? launch_silu<__nv_bfloat16, true>(a, M, st)
               : launch_silu<__nv_bfloat16, false>(a, M, st);
}

template <typename T, int kV>
int launch_rotary_grad(const RotaryArgs& a, long long tokens, cudaStream_t st) {
  const long long units = static_cast<long long>(a.Hq + a.Hk) * (a.Dh / 2 / kV);
  const int threads = static_cast<int>(units < kRotaryThreads ? (units + 31) / 32 * 32
                                                              : kRotaryThreads);
  if (tokens > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rotary_grad_kernel<T, kV><<<static_cast<unsigned>(tokens), threads,
                              2 * a.Dh * sizeof(float), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// whether every row of the rotary's operands starts on a 16-byte boundary
bool rows16(const RotaryArgs& a, int size) {
  const int v = 16 / size;
  return !misaligned(a.q, 16) && !misaligned(a.k, 16) && !misaligned(a.oq, 16) &&
         !misaligned(a.ok, 16) && (a.Dh / 2) % v == 0 &&
         (a.q_b | a.q_s | a.q_h | a.k_b | a.k_s | a.k_h | a.oq_b | a.oq_s | a.oq_h | a.ok_b |
          a.ok_s | a.ok_h) % v == 0;
}

// q [B, S, Hq, Dh] and k [B, S, Hk, Dh] (strided, Dh contiguous) rotated by
// the tables' rows at positions [B, S] into oq and ok (q and k themselves in
// place), or with `inverse` the gradients q and k rotated back (the backward).
extern "C" int cgpt_rotary(const void* q, long long q_b, long long q_s, long long q_h,
                           const void* k, long long k_b, long long k_s, long long k_h, void* oq,
                           long long oq_b, long long oq_s, long long oq_h, void* ok,
                           long long ok_b, long long ok_s, long long ok_h, const void* cos,
                           const void* sin, const void* pos, long long p_b, long long p_s,
                           int pos_i64, int B, int S, int Hq, int Hk, int Dh, int max_len,
                           int f32, int inverse, void* stream) {
  const int pair = f32 ? 8 : 4;
  if (B < 0 || S < 0 || Hq < 0 || Hk < 0 || Dh <= 0 || Dh % 4 != 0 || max_len <= 0 ||
      misaligned(q, pair) || misaligned(k, pair) || misaligned(oq, pair) ||
      misaligned(ok, pair) ||
      (q_b | q_s | q_h | k_b | k_s | k_h | oq_b | oq_s | oq_h | ok_b | ok_s | ok_h) % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = static_cast<long long>(B) * S * (Hq + Hk) * (Dh / 4);
  if (units == 0) return 0;
  unsigned grid = 0;
  const cudaError_t err = stride_grid(units, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RotaryArgs a{q, q_b, q_s, q_h, k, k_b, k_s, k_h, oq, oq_b, oq_s, oq_h, ok, ok_b, ok_s,
                     ok_h, static_cast<const float*>(cos), static_cast<const float*>(sin), pos,
                     p_b, p_s, pos_i64, S, Hq, Hk, Dh, max_len, units};
  auto st = static_cast<cudaStream_t>(stream);
  const bool in_place = oq == q && ok == k && oq_b == q_b && oq_s == q_s && oq_h == q_h &&
                        ok_b == k_b && ok_s == k_s && ok_h == k_h;
  if (inverse) {
    const long long tokens = static_cast<long long>(B) * S;
    const bool wide = rows16(a, f32 ? 4 : 2);
    if (f32) {
      return wide ? launch_rotary_grad<float, 4>(a, tokens, st)
                  : launch_rotary_grad<float, 2>(a, tokens, st);
    }
    return wide ? launch_rotary_grad<__nv_bfloat16, 8>(a, tokens, st)
                : launch_rotary_grad<__nv_bfloat16, 2>(a, tokens, st);
  }
  if (f32) {
    if (in_place) {
      rotary_kernel<float, true><<<grid, kRotaryThreads, 0, st>>>(a);
    } else {
      rotary_kernel<float, false><<<grid, kRotaryThreads, 0, st>>>(a);
    }
  } else if (in_place) {
    rotary_kernel<__nv_bfloat16, true><<<grid, kRotaryThreads, 0, st>>>(a);
  } else {
    rotary_kernel<__nv_bfloat16, false><<<grid, kRotaryThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// s, g [M, K] (+ gs) -> gx [M, K]: the gradient of x (and y) through
// s = x + y and its RMSNorm with the scale [K] (bf16 or f32).
extern "C" int cgpt_add_rms_norm_grad(const void* s, const void* g, const void* gs,
                                      const void* scale, int scale_f32, void* gx, long long M,
                                      int K, float eps, int f32, void* stream) {
  const int vec = f32 ? 16 : 8;
  if (M < 0 || M > 0x7fffffffLL || K <= 0 || K % 4 != 0 || K > kMaxGradRowWidth ||
      misaligned(s, vec) || misaligned(g, vec) || misaligned(gs, vec) || misaligned(gx, vec) ||
      s == nullptr || g == nullptr || gx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const NormGradArgs a{s, g, gs, scale, scale_f32, gx, K, eps};
  auto st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_norm_grad<float>(a, M, st) : launch_norm_grad<__nv_bfloat16>(a, M, st);
}

// g, gate, up [elems] -> g_gate, g_up: the gradients of silu(gate) * up.
extern "C" int cgpt_silu_mul_grad(const void* g, const void* gate, const void* up, void* g_gate,
                                  void* g_up, long long elems, int f32, void* stream) {
  const int vec = f32 ? 16 : 8;
  if (elems < 0 || elems % 4 != 0 || misaligned(g, vec) || misaligned(gate, vec) ||
      misaligned(up, vec) || misaligned(g_gate, vec) || misaligned(g_up, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (elems == 0) return 0;
  unsigned grid = 0;
  const cudaError_t err = stride_grid(elems / 4, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SiluGradArgs a{g, gate, up, g_gate, g_up, elems / 4};
  auto st = static_cast<cudaStream_t>(stream);
  if (f32) {
    silu_mul_grad_kernel<float><<<grid, kRotaryThreads, 0, st>>>(a);
  } else {
    silu_mul_grad_kernel<__nv_bfloat16><<<grid, kRotaryThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
