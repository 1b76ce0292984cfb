// Fused row transform + symmetric per-row int8 quantization, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of certifiedgpt_tpu/ops/quantization.py:
//   _ln_quant_kernel   (:208)  LayerNorm with affine -> int8 rows  (ViT qkv / fc1 inputs)
//   _gelu_quant_kernel (:136)  GELU, A-S erf (:122)   -> int8 rows  (ViT fc2 input)
// and, with the identity as its transform, the XLA-fused quantize_rows (:52-65)
// of bf16 rows (the ViT's proj input, the decoder prefill's product inputs,
// the int8 KV cache's rows of head_dim): quant_rows_kernel, one warp a row as
// the LayerNorm, rows up to kMaxIdentityRowWidth wide (the prefill's
// down_proj input is 11008), fewer teams a block for wider rows. f32 rows
// (the f32 configurations) take quant_rows_f32_kernel, a plain walk of a warp
// a row with an IEEE division an element.
// Per row: f32 transform -> round through bf16 (the unfused chain quantizes the
// bf16 activation) -> xs = max(absmax, 1e-8) / 127 -> codes rint(h / xs)
// (half to even), clipped to +-127.
//
// Bound on the H100: bytes. Per element the kernels read 2 bytes and write 1:
// 0.124 ms at [98304, 1408] and 0.541 ms at [98304, 6144] at 3.35 TB/s. Both
// come close to the issue rate as well (some 25 instructions an element).
//
// Design (PERF.md holds the breakdowns that led to it). Blocks stay on
// their SM and walk the rows. A team owns a row from start to end: one warp
// for the LayerNorm, whose sums are then warp shuffles in a fixed order, and
// four warps for the GELU, whose only reduction is a max (warp shuffles, then
// one exchange through shared memory under a named barrier of the team). No
// __syncthreads lies on a row's path. Each team keeps a ring of two row
// buffers in shared memory, the next row filled by a 1-D bulk copy
// (cp.async.bulk, TMA without a tensor map) that completes on the buffer's
// mbarrier while the team works on the other: 8 one-warp teams a block at
// 56 KB and several blocks an SM for the LayerNorm at K = 1408, 8 four-warp
// teams and 192 KB, one block an SM, for the GELU at K = 6144; wider rows get
// fewer teams. The row's passes (sums, centred squares, transform, codes)
// read it from shared memory, a thread taking pieces tid, tid + team size, ...
// (4 values a piece for the LayerNorm, 8 for the GELU), and the transform
// writes its bf16 result back into the same buffer for the quantize pass:
// each element is transformed once and no row is held in registers. The
// LayerNorm's gamma and beta, bf16 or f32, are read once a block into f32
// shared memory. Measured (H100 80GB HBM3, 700 W, chip_smoke.py):
// 0.18 ms and 0.66-0.68 ms at the shapes above, on N(0,1) and N(0,3^2) data.
//
// No division per element: t = h * (1 / xs), rounded with the 1.5 * 2^23 trick
// (the code is then the low byte of t + 1.5 * 2^23). Where t lies within 2^-14
// of a half-integer, which the two roundings of t could put on the other side,
// the piece's codes are taken from the exact quotient. The codes equal
// rint(h / xs) bit for bit (tests/test_torch_row_quant.py holds a CPU twin of
// this arithmetic against the exact quotient over every finite bf16 value).
//
// The GELU computes the TPU kernel's Abramowitz-Stegun 7.1.26 erf: one
// rcp.approx and one ex2.approx on the special-function unit and five fused
// multiply-adds, no branch (erff branches on |x|). Its approximate steps only
// touch poly * exp(-z^2); the steps after them round as the plain version's
// (ops/quantization.py::_gelu_quant_rows_as_plain) do. The LayerNorm sums in
// a fixed order (per lane, per position in a piece, then a butterfly) that
// its plain version repeats, and takes 1 / sqrt(var + eps) correctly rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A team (the warps that own one row) keeps a ring of row buffers; a block
// holds up to kMaxTeams teams.
constexpr int kMaxTeams = 8;
constexpr int kLnStages = 2;       // row buffers of a LayerNorm team (one warp)
constexpr int kGeluStages = 2;     // row buffers of a GELU team
constexpr int kGeluTeamWarps = 4;  // warps of a GELU team
constexpr int kMaxStages = 4;
constexpr int kMaxTeamWarps = 4;
constexpr int kBarBytes = kMaxTeams * kMaxStages * 8;       // an mbarrier a buffer
constexpr int kRedBytes = kMaxTeams * kMaxTeamWarps * 4;    // a team's per-warp partials
constexpr int kMaxRowWidth = 8192;
constexpr int kMaxIdentityRowWidth = 32768;

// the row transform before the quantization
enum Mode { kLnMode, kGeluMode, kIdentityMode };

constexpr float kRoundMagic = 12582912.f;     // 1.5 * 2^23
constexpr float kNearHalf = 0.5f - 0x1p-14f;  // |t - rint(t)| above this: exact quotient

// Abramowitz-Stegun 7.1.26 (certifiedgpt_tpu/ops/quantization.py:122-133)
constexpr float kAsP = 0.3275911f;
constexpr float kAsA1 = 0.254829592f, kAsA2 = -0.284496736f, kAsA3 = 1.421413741f,
                kAsA4 = -1.453152027f, kAsA5 = 1.061405429f;
constexpr float kRsqrt2 = 0.70710678118654752f;
constexpr float kNegHalfLog2e = -0.72134752044448170f;  // exp(-x^2 / 2) = 2^(x^2 * this)

struct RowQuantArgs {
  const __nv_bfloat16* x;
  int8_t* q;
  float* s;
  const void* gamma;  // LayerNorm only: [K] bf16 or f32
  const void* beta;
  int gamma_f32, beta_f32;
  float eps;
  long long M;
  int K;
  int stages;
};

__host__ __device__ constexpr int slot_offset(int K, bool ln) {
  return (kBarBytes + kRedBytes + (ln ? 8 * K : 0) + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- bf16 pairs ----
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// running max of |bf16| over packed pairs
__device__ __forceinline__ __nv_bfloat162 absmax2(__nv_bfloat162 m, uint32_t w) {
  return __hmax2(m, __habs2(*reinterpret_cast<const __nv_bfloat162*>(&w)));
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

// ---- mbarriers and bulk copies ----
__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Arms the barrier for `bytes` and starts the bulk copy of one row into `dst`.
__device__ __forceinline__ void load_row_async(unsigned char* dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits until the barrier's phase of the given parity is complete; a wait
// that never ends traps instead of hanging the card. The poll loop is one asm
// block: the compiler sees no branch in it, so it cannot move the warp-wide
// (.aligned) instructions that follow a wait into code that the warp's lanes
// reach at different times.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.lt.u32 p, polls, %2;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "n"(1 << 26)
      : "memory");
}

// ---- quantization ----
// rint(h * inv) as the low byte of the returned word (t + 1.5 * 2^23 rounds
// t to an integer, half to even, for |t| < 2^22). Sets `near` where t lies
// within 2^-14 of a half-integer: |h / xs| <= 127 and the two roundings of t
// put it within 1.5 * 2^-16 of the exact quotient's rounding, so elsewhere
// both round to the same integer.
__device__ __forceinline__ uint32_t code_fast(float h, float inv, bool& near) {
  const float t = __fmul_rn(h, inv);
  const float u = __fadd_rn(t, kRoundMagic);
  near |= fabsf(__fsub_rn(t, __fsub_rn(u, kRoundMagic))) > kNearHalf;
  return __float_as_uint(u);
}

// clip(rint(h / xs), -127, 127) as the low byte of the returned word
__device__ __forceinline__ uint32_t code_exact(float h, float xs) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(rintf(__fdiv_rn(h, xs)), -127.f), 127.f), kRoundMagic));
}

// four codes (low bytes) -> one little-endian word
__device__ __forceinline__ uint32_t pack_codes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The codes of a piece of kPairs bf16 pairs, four to a word. One branch a
// piece: where any value is near a half-integer (about 1e-3 of the pieces of
// 8), every code of the piece is taken from the exact quotient.
template <int kPairs>
__device__ __forceinline__ void piece_codes(const uint32_t (&w)[kPairs], float xs, float inv,
                                            uint32_t (&out)[kPairs / 2]) {
  uint32_t c[2 * kPairs];
  bool near = false;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    c[2 * i] = code_fast(lo_f(w[i]), inv, near);
    c[2 * i + 1] = code_fast(hi_f(w[i]), inv, near);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      c[2 * i] = code_exact(lo_f(w[i]), xs);
      c[2 * i + 1] = code_exact(hi_f(w[i]), xs);
    }
  }
#pragma unroll
  for (int i = 0; i < kPairs / 2; ++i) {
    out[i] = pack_codes(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]);
  }
}

__device__ __forceinline__ void store_codes(int8_t* dst, const uint32_t (&v)[1]) {
  *reinterpret_cast<uint32_t*>(dst) = v[0];
}

__device__ __forceinline__ void store_codes(int8_t* dst, const uint32_t (&v)[2]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
}

// A team of kWarps warps owns a row: thread `tid` of the team takes the
// pieces tid, tid + 32 kWarps, ...; `red` holds the team's per-warp partials.
template <int kWarps>
struct Team {
  static constexpr int kThreads = 32 * kWarps;
  int tid, id;
  float* red;

  // all threads of the team (a warp: __syncwarp)
  __device__ __forceinline__ void sync() const {
    if constexpr (kWarps == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + id), "n"(kThreads) : "memory");
    }
  }

  // the row's max over the team (the partials are not read again before the
  // team's next sync, which ends the row)
  __device__ __forceinline__ float max(float v) const {
    v = warp_max(v);
    if constexpr (kWarps > 1) {
      if ((tid & 31) == 0) red[tid >> 5] = v;
      sync();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v = fmaxf(v, red[w]);
    }
    return v;
  }
};

// Scale and codes of the bf16 row in `slot`, pieces of 2 kPairs values.
template <int kPairs, int kWarps>
__device__ __forceinline__ void quantize_row(const unsigned char* slot, int K, float amax,
                                             int8_t* qrow, float* srow, const Team<kWarps>& team) {
  const float xs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  const float inv = __fdiv_rn(1.f, xs);
  if (team.tid == 0) *srow = xs;
  const int pieces = K / (2 * kPairs);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(slot);
#pragma unroll 2
  for (int p = team.tid; p < pieces; p += Team<kWarps>::kThreads) {
    uint32_t w[kPairs], out[kPairs / 2];
    if constexpr (kPairs == 2) {
      const uint2 v = reinterpret_cast<const uint2*>(words)[p];
      w[0] = v.x, w[1] = v.y;
    } else {
      const uint4 v = reinterpret_cast<const uint4*>(words)[p];
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
    piece_codes(w, xs, inv, out);
    store_codes(qrow + 2 * kPairs * p, out);
  }
}

// ---- LayerNorm ----
// ((x - mean) * rs) * gamma + beta, each step rounded (the plain chain's order)
__device__ __forceinline__ float ln_affine(float x, float mean, float rs, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rs), g), b);
}

// One warp a row (the sums' order is the plain version's), pieces of 4.
__device__ __forceinline__ void ln_row(unsigned char* slot, const float* gamma, const float* beta,
                                       int K, float eps, int8_t* qrow, float* srow,
                                       const Team<1>& team) {
  uint2* piece = reinterpret_cast<uint2*>(slot);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  const int pieces = K / 4, lane = team.tid;
  const float k = static_cast<float>(K);
  // mean: one sum per position in a piece, in piece order, then a butterfly
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int p = lane; p < pieces; p += 32) {
    const uint2 w = piece[p];
    a0 = __fadd_rn(a0, lo_f(w.x));
    a1 = __fadd_rn(a1, hi_f(w.x));
    a2 = __fadd_rn(a2, lo_f(w.y));
    a3 = __fadd_rn(a3, hi_f(w.y));
  }
  const float mean = __fdiv_rn(warp_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3))), k);
  // variance of the centred values, in the same order
  a0 = a1 = a2 = a3 = 0.f;
#pragma unroll 4
  for (int p = lane; p < pieces; p += 32) {
    const uint2 w = piece[p];
    const float d0 = __fsub_rn(lo_f(w.x), mean), d1 = __fsub_rn(hi_f(w.x), mean);
    const float d2 = __fsub_rn(lo_f(w.y), mean), d3 = __fsub_rn(hi_f(w.y), mean);
    a0 = __fadd_rn(a0, __fmul_rn(d0, d0));
    a1 = __fadd_rn(a1, __fmul_rn(d1, d1));
    a2 = __fadd_rn(a2, __fmul_rn(d2, d2));
    a3 = __fadd_rn(a3, __fmul_rn(d3, d3));
  }
  const float var = __fdiv_rn(warp_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3))), k);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  // transform, rounded to bf16 in place, and its absmax
  __nv_bfloat162 m = __float2bfloat162_rn(0.f);
#pragma unroll 4
  for (int p = lane; p < pieces; p += 32) {
    const uint2 w = piece[p];
    const float4 g = g4[p], b = b4[p];
    uint2 o;
    o.x = pack_bf16(ln_affine(lo_f(w.x), mean, rs, g.x, b.x),
                    ln_affine(hi_f(w.x), mean, rs, g.y, b.y));
    o.y = pack_bf16(ln_affine(lo_f(w.y), mean, rs, g.z, b.z),
                    ln_affine(hi_f(w.y), mean, rs, g.w, b.w));
    piece[p] = o;
    m = absmax2(absmax2(m, o.x), o.y);
  }
  const float amax = team.max(fmaxf(__low2float(m), __high2float(m)));
  quantize_row<2>(slot, K, amax, qrow, srow, team);
}

// ---- GELU ----
// 0.5 x (1 + erf(x / sqrt 2)) with the A-S erf. Only the approximate steps
// (the reciprocal, the polynomial, the exponential) differ from the plain
// version's rounding; they move poly * exp(-z^2), which is small wherever
// the result is large.
__device__ __forceinline__ float gelu_as(float x) {
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(fmaf(fabsf(x), kAsP * kRsqrt2, 1.f)));
  float poly = fmaf(fmaf(fmaf(fmaf(kAsA5, t, kAsA4), t, kAsA3), t, kAsA2), t, kAsA1);
  poly = __fmul_rn(poly, t);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(__fmul_rn(__fmul_rn(x, x), kNegHalfLog2e)));
  const float erf = copysignf(fmaf(-poly, e, 1.f), x);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

__device__ __forceinline__ uint32_t gelu2(uint32_t w) {
  return pack_bf16(gelu_as(lo_f(w)), gelu_as(hi_f(w)));
}

// A team of kWarps warps a row, pieces of 8.
template <int kWarps>
__device__ __forceinline__ void gelu_row(unsigned char* slot, int K, int8_t* qrow, float* srow,
                                         const Team<kWarps>& team) {
  uint4* piece = reinterpret_cast<uint4*>(slot);
  const int pieces = K / 8;
  __nv_bfloat162 m = __float2bfloat162_rn(0.f);
#pragma unroll 2
  for (int p = team.tid; p < pieces; p += Team<kWarps>::kThreads) {
    uint4 w = piece[p];
    w.x = gelu2(w.x);
    w.y = gelu2(w.y);
    w.z = gelu2(w.z);
    w.w = gelu2(w.w);
    piece[p] = w;
    m = absmax2(absmax2(absmax2(absmax2(m, w.x), w.y), w.z), w.w);
  }
  const float amax = team.max(fmaxf(__low2float(m), __high2float(m)));
  quantize_row<4>(slot, K, amax, qrow, srow, team);
}

// ---- identity ----
// One warp a row, pieces of 4: the row's absmax, then its codes.
__device__ __forceinline__ void identity_row(const unsigned char* slot, int K, int8_t* qrow,
                                             float* srow, const Team<1>& team) {
  const uint2* piece = reinterpret_cast<const uint2*>(slot);
  __nv_bfloat162 m = __float2bfloat162_rn(0.f);
#pragma unroll 4
  for (int p = team.tid; p < K / 4; p += 32) {
    const uint2 w = piece[p];
    m = absmax2(absmax2(m, w.x), w.y);
  }
  const float amax = team.max(fmaxf(__low2float(m), __high2float(m)));
  quantize_row<2>(slot, K, amax, qrow, srow, team);
}

// ---- the persistent walk over rows ----
__device__ __forceinline__ float load_param(const void* p, int is_f32, int k) {
  return is_f32 ? static_cast<const float*>(p)[k]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[k]);
}

// Each team of the block walks rows team, team + teams a grid, ...; its ring
// of `stages` row buffers is filled `stages` rows ahead.
template <int kMode, int kWarps>
__device__ __forceinline__ void walk_rows(const RowQuantArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = Team<kWarps>;
  const int teams = blockDim.x / T::kThreads;
  const int K = a.K, stages = a.stages;
  const uint32_t row_bytes = 2u * static_cast<uint32_t>(K);
  constexpr bool kLn = kMode == kLnMode;
  float* gamma = reinterpret_cast<float*>(smem + kBarBytes + kRedBytes);
  float* beta = gamma + K;
  if constexpr (kLn) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      gamma[k] = load_param(a.gamma, a.gamma_f32, k);
      beta[k] = load_param(a.beta, a.beta_f32, k);
    }
    __syncthreads();
  }
  const int id = threadIdx.x / T::kThreads;
  const T team{static_cast<int>(threadIdx.x % T::kThreads), id,
               reinterpret_cast<float*>(smem + kBarBytes) + kMaxTeamWarps * id};
  unsigned char* ring = smem + slot_offset(K, kLn) + static_cast<size_t>(id) * stages * row_bytes;
  const uint32_t bar0 = smem_u32(smem) + 8u * id * kMaxStages;
  const long long first = static_cast<long long>(blockIdx.x) * teams + id;
  const long long step = static_cast<long long>(gridDim.x) * teams;

  if (team.tid == 0) {
    for (int i = 0; i < stages; ++i) mbarrier_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < stages; ++i) {
      const long long row = first + i * step;
      if (row < a.M) load_row_async(ring + i * row_bytes, a.x + row * K, row_bytes, bar0 + 8 * i);
    }
  }
  team.sync();

  int slot = 0;
  uint32_t parity = 0;
  for (long long row = first; row < a.M; row += step) {
    unsigned char* buf = ring + slot * row_bytes;
    mbarrier_wait(bar0 + 8 * slot, parity);
    __syncwarp();  // the row's shuffles and team barriers are warp-aligned
    if constexpr (kLn) {
      ln_row(buf, gamma, beta, K, a.eps, a.q + row * K, a.s + row, team);
    } else if constexpr (kMode == kGeluMode) {
      gelu_row(buf, K, a.q + row * K, a.s + row, team);
    } else {
      identity_row(buf, K, a.q + row * K, a.s + row, team);
    }
    // this thread's reads and writes of the buffer come before the copy that
    // refills it (the copy writes through the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    team.sync();
    const long long next = row + stages * step;
    if (team.tid == 0 && next < a.M) {
      load_row_async(buf, a.x + next * K, row_bytes, bar0 + 8 * slot);
    }
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
}

__global__ void __launch_bounds__(kMaxTeams * 32, 3) ln_quant_kernel(const RowQuantArgs a) {
  walk_rows<kLnMode, 1>(a);
}

__global__ void __launch_bounds__(kMaxTeams * 32 * kGeluTeamWarps, 1)
    gelu_quant_kernel(const RowQuantArgs a) {
  walk_rows<kGeluMode, kGeluTeamWarps>(a);
}

__global__ void __launch_bounds__(kMaxTeams * 32, 3) quant_rows_kernel(const RowQuantArgs a) {
  walk_rows<kIdentityMode, 1>(a);
}

// the kernel of each mode and its threads a team
constexpr int team_threads(int mode) { return 32 * (mode == kGeluMode ? kGeluTeamWarps : 1); }

template <int kMode>
const void* kernel_of() {
  if constexpr (kMode == kLnMode) return reinterpret_cast<const void*>(ln_quant_kernel);
  if constexpr (kMode == kGeluMode) return reinterpret_cast<const void*>(gelu_quant_kernel);
  return reinterpret_cast<const void*>(quant_rows_kernel);
}

struct Plan {
  int dev = -1, K = 0, teams = 0, stages = 0, grid = 0;
  size_t smem = 0;
};

// The launch shape for rows of width K on the current device (cached): the
// ring depth of the kernel, or less, down to 2, then the most teams up to
// kMaxTeams, that fit in a block's shared memory, and as many blocks as stay
// resident.
template <int kMode>
cudaError_t plan_for(int K, Plan* out) {
  constexpr bool kLn = kMode == kLnMode;
  constexpr int kPlans = 16;
  static Plan plans[kPlans];
  static int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const Plan& p : plans) {
    if (p.dev == dev && p.K == K) {
      *out = p;
      return cudaSuccess;
    }
  }
  const void* kernel = kernel_of<kMode>();
  const int threads_per_team = team_threads(kMode);
  int sms = 0, max_smem = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  }
  if (err != cudaSuccess) return err;
  Plan p;
  p.dev = dev;
  p.K = K;
  p.teams = kMaxTeams;
  p.stages = kMode == kGeluMode ? kGeluStages : kLnStages;
  const size_t row_bytes = 2 * static_cast<size_t>(K);
  auto bytes = [&](int teams, int stages) {
    return slot_offset(K, kLn) + teams * stages * row_bytes;
  };
  while (p.stages > 2 && bytes(p.teams, p.stages) > static_cast<size_t>(max_smem)) --p.stages;
  while (p.teams > 1 && bytes(p.teams, p.stages) > static_cast<size_t>(max_smem)) --p.teams;
  p.smem = bytes(p.teams, p.stages);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      p.teams * threads_per_team, p.smem);
  if (err != cudaSuccess) return err;
  p.grid = (per_sm > 0 ? per_sm : 1) * sms;
  plans[next] = p;
  next = (next + 1) % kPlans;
  *out = p;
  return cudaSuccess;
}

template <int kMode>
int launch(RowQuantArgs a, void* stream) {
  const int widest = kMode == kIdentityMode ? kMaxIdentityRowWidth : kMaxRowWidth;
  if (a.M < 0 || a.K <= 0 || a.K % 8 != 0 || a.K > widest ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.M == 0) return 0;
  Plan p;
  const cudaError_t err = plan_for<kMode>(a.K, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.M + p.teams - 1) / p.teams;
  const unsigned grid = static_cast<unsigned>(blocks < p.grid ? blocks : p.grid);
  a.stages = p.stages;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned threads = p.teams * team_threads(kMode);
  if constexpr (kMode == kLnMode) {
    ln_quant_kernel<<<grid, threads, p.smem, st>>>(a);
  } else if constexpr (kMode == kGeluMode) {
    gelu_quant_kernel<<<grid, threads, p.smem, st>>>(a);
  } else {
    quant_rows_kernel<<<grid, threads, p.smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cgpt_ln_quant(const void* x, const void* gamma, int gamma_f32, const void* beta,
                             int beta_f32, void* q, void* s, long long M, int K, float eps,
                             void* stream) {
  RowQuantArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
                 static_cast<float*>(s), gamma, beta, gamma_f32, beta_f32, eps, M, K, 0};
  return launch<kLnMode>(a, stream);
}

extern "C" int cgpt_gelu_quant(const void* x, void* q, void* s, long long M, int K,
                               void* stream) {
  RowQuantArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
                 static_cast<float*>(s), nullptr, nullptr, 0, 0, 0.f, M, K, 0};
  return launch<kGeluMode>(a, stream);
}

extern "C" int cgpt_quant_rows(const void* x, void* q, void* s, long long M, int K, void* stream) {
  RowQuantArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
                 static_cast<float*>(s), nullptr, nullptr, 0, 0, 0.f, M, K, 0};
  return launch<kIdentityMode>(a, stream);
}

namespace {

// ---- f32 rows ----
// quantize_rows of f32 rows [M, K], any K: one warp a row (8 a block, the
// blocks walking the rows), the absmax, then the codes rint(x / xs), each an
// IEEE division, clipped to +-127.
constexpr int kF32RowWarps = 8;
constexpr long long kF32MaxBlocks = 4096;

__global__ void __launch_bounds__(kF32RowWarps * 32)
    quant_rows_f32_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ s, long long M, int K) {
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * kF32RowWarps;
  for (long long row = blockIdx.x * static_cast<long long>(kF32RowWarps) + threadIdx.x / 32;
       row < M; row += stride) {
    const float* xr = x + row * K;
    float amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(xr[k]));
    const float xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.f);
    if (lane == 0) s[row] = xs;
    for (int k = lane; k < K; k += 32) {
      const float t = fminf(fmaxf(rintf(__fdiv_rn(xr[k], xs)), -127.f), 127.f);
      q[row * K + k] = static_cast<int8_t>(t);
    }
  }
}

}  // namespace

extern "C" int cgpt_quant_rows_f32(const void* x, void* q, void* s, long long M, int K,
                                   void* stream) {
  if (M < 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long blocks = (M + kF32RowWarps - 1) / kF32RowWarps;
  const unsigned grid = static_cast<unsigned>(blocks < kF32MaxBlocks ? blocks : kF32MaxBlocks);
  quant_rows_f32_kernel<<<grid, kF32RowWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), M, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
