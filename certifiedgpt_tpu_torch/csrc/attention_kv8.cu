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
// exact), so only the order of the f32 sums and a few f32 ulps of the
// exponential (and, in the tensor-core instance, of the division) differ
// from the plain version.
//
// Bound on the H100: bytes. At the certify prefill (q [96, 96, 32, 128]
// over a [96, 106, 32, 128] cache) the q and output tensors (75 MB each)
// and the cache (83 MB) take 0.07 ms at 3.35 TB/s, and the 16 GFLOP of the
// two contractions 0.016 ms on the tensor cores; at the decode (one query
// row) the cache alone. Two instances:
//
// - The tensor-core one (bf16 q, more than one query row, head_dim 128, up
//   to 256 cached positions: the prefill). A block owns one (batch row, kv
//   head) and its g * Sq query rows (g query heads a kv head), a warp 16 of
//   them at a time (up to six warps, two blocks an SM). Everything a block
//   reads arrives by cp.async at once: the int8 K and V rows (into the upper
//   halves of their bf16 rows' slots), the row scales, the batch row's
//   [Sq, T] mask bytes (rows contiguous) and the warps' q rows; each thread
//   then converts whole K and V rows to bf16 in place with byte permutes and
//   one f32 subtraction (no I2F), into rows padded to 272 bytes so that
//   ldmatrix is free of bank conflicts. Both contractions run on
//   mma.sync.m16n8k16 (bf16 in, f32 out): q K^T into the warp's whole row
//   of logits, kept in registers (8 to 32 tiles of 8 keys: an instance for
//   T up to 64, 112, 128 and 256), then P V with P taken straight from the
//   logits' registers. The softmax is the plain version's two passes over
//   the row (no online rescale), each row's max and sum across the four
//   lanes that hold it; the exponential is ex2.approx of x log2 e, and
//   w / den is w times 1 / den (a reciprocal a row), each within a few f32
//   ulps before p's bf16 rounding. An 8-key tile that no row of the warp
//   keeps (the causal future, the left padding) is neither multiplied nor
//   exponentiated: the warp's live tiles are one warp reduction into a
//   uniform register, and the products are guarded by it, not branched on.
//   The output is staged in the warp's q rows and written 16 bytes a lane.
//
// - The warp-a-row one: the decode (one query row), the f32 instance (f32 q
//   and output, the tiny and f32 configurations; p is then not rounded to
//   bf16, as in the plain version) and longer caches; f32 FMAs on the CUDA
//   cores. The warp keeps the row's q in f32 and its T logits in shared
//   memory: the logits pass gives each lane whole keys (positions lane,
//   lane + 32, ...; 16 cache bytes a load, L1 serving the other rows of the
//   block), the softmax runs two passes over the row, and the output pass
//   gives each lane four neighbouring dimensions and walks the positions,
//   skipping those whose weight is 0 (masked: exact). Masked positions
//   compute no logit. Shared memory is (Dh + T) floats a warp, so T is
//   bounded by 227 KB, not by the cache's size; the launcher returns
//   kCacheTooLong for a T that does not fit.

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


// ---------------------------------------------------------------------------
// The prefill's instance: both contractions on mma.sync

constexpr int kMmaDh = 128;                       // the head_dim it takes
constexpr int kMmaMaxKeys = 256;                  // the most cached positions
constexpr int kMmaMaxWarps = 6;
constexpr int kMmaRowBytes = 2 * (kMmaDh + 8);    // a bf16 row of K, V, q (272)
constexpr int kMmaQTile = 16 * kMmaRowBytes;      // a warp's 16 query rows
constexpr int kMaxMaskSlab = 24 * 1024;           // the most mask bytes a block stages

// Where each part lives in the block's shared memory, in bytes: the bf16 K
// and V tiles (positions padded to 16, the pad rows zero), their f32 row
// scales, each warp's q rows, then the batch row's mask bytes (`slab`
// bytes: 0 when the mask is not staged).
struct MmaLayout {
  int tp, k, v, ks, vs, q, mask, bytes;
};

__host__ __device__ inline MmaLayout mma_layout(int T, int warps, int slab) {
  MmaLayout l;
  l.tp = (T + 15) / 16 * 16;
  l.k = 0;
  l.v = l.tp * kMmaRowBytes;
  l.ks = 2 * l.tp * kMmaRowBytes;
  l.vs = l.ks + 4 * l.tp;
  l.q = l.vs + 4 * l.tp;
  l.mask = l.q + warps * kMmaQTile;
  l.bytes = l.mask + slab;
  return l;
}

// The mask bytes a block stages: its batch row's [Sq, T] when the rows are
// contiguous (m_t 1, m_s T) and small enough, read as 16-byte chunks from
// the aligned address at or below it, with room for a row's reads past T
// (masked off); 0 otherwise (the mask is then read from device memory).
__host__ __device__ inline int mask_slab_bytes(const void* mask, long long m_s, long long m_t,
                                              int Sq, int T) {
  const long long n = (static_cast<long long>(Sq) * T + kMmaMaxKeys + 16 + 15) / 16 * 16;
  return mask != nullptr && m_t == 1 && m_s == T && n <= kMaxMaskSlab ? static_cast<int>(n)
                                                                       : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` 0 fills the destination with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ldmatrix and mma where `on` holds (the same in every lane of the warp):
// guarded instructions, not branches, so no lane waits on a divergence
// point; with `on` false the registers keep their values.
__device__ __forceinline__ void ldsm_x4_if(bool on, uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
      : "r"(addr), "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans_if(bool on, uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
      : "r"(addr), "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ void mma_bf16_if(bool on, float (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "@p mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(static_cast<int>(on)));
}

// e^x as 2^(x log2 e) on the special-function unit (a few ulps of f32)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four signed bytes -> two bf16 pairs (bytes 0-1 in `lo`, 2-3 in `hi`),
// exact and without I2F: the byte offset to unsigned is the low mantissa
// byte of the f32 2^23 + u, 2^23 + 128 is subtracted, and the bf16 is the
// f32's upper half.
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

// Row R = gi * Sq + s of a block's g * Sq query rows (gi: the query head
// in the kv head's group, s: the query position), stepped along without a
// division a row.
struct RowPos {
  int gi, s;
};

__device__ __forceinline__ RowPos row_pos(int R, int Sq) { return {R / Sq, R % Sq}; }

__device__ __forceinline__ RowPos advance(RowPos p, int by, int Sq) {
  p.s += by;
  while (p.s >= Sq) {
    p.s -= Sq;
    ++p.gi;
  }
  return p;
}

// Starts the copies of row tile `rt`'s q rows into the warp's q tile (a
// lane copies 16 bytes of rows lane / 16, + 2, ...); rows past the last are
// zeros.
__device__ __forceinline__ void load_q_rows(const Args<__nv_bfloat16>& a, unsigned char* qt,
                                            int b, int hk, int rows, int rt, int lane) {
  const int group = a.H / a.Hkv, part = lane & 15;
  RowPos p = row_pos(16 * rt + (lane >> 4), a.Sq);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (lane >> 4) + 2 * i;
    const bool in = 16 * rt + r < rows;
    const __nv_bfloat16* src = a.q + b * a.q_b + (in ? p.s * a.q_s + (hk * group + p.gi) * a.q_h
                                                     : 0) + 8 * part;
    cp_async16(smem_u32(qt + r * kMmaRowBytes + 16 * part), src, in ? 16 : 0);
    p = advance(p, 2, a.Sq);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The mask of query position s at the lane's keys 8 nt + 2 tq + e as bits
// 8 (nt % 4) + e of word nt / 4 (1 = kept; positions past T are 0; all 0 for
// a row past the last), from the staged bytes (read past T and masked off,
// no branch) or from device memory.
template <int NT>
__device__ __forceinline__ void row_bits(const Args<__nv_bfloat16>& a,
                                         const unsigned char* slab, int b, bool valid, int s,
                                         int tq, uint32_t (&bits)[(NT + 3) / 4]) {
#pragma unroll
  for (int w = 0; w < (NT + 3) / 4; ++w) bits[w] = 0u;
  if (!valid) return;
  const int lim = a.T - 2 * tq;  // the key 8 nt + 2 tq + e exists while 8 nt + e < lim
  if (slab != nullptr) {
    const unsigned char* srow = slab + s * a.T + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool kept = (8 * nt + e < lim) & (srow[8 * nt + e] != 0);
        bits[nt / 4] |= static_cast<uint32_t>(kept) << (8 * (nt % 4) + e);
      }
    }
  } else {
    const uint8_t* grow =
        a.mask == nullptr ? nullptr : a.mask + b * a.m_b + s * a.m_s + 2 * tq * a.m_t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool kept = 8 * nt + e < lim;
        if (kept && grow != nullptr) kept = __ldg(grow + (8 * nt + e) * a.m_t) != 0;
        bits[nt / 4] |= static_cast<uint32_t>(kept) << (8 * (nt % 4) + e);
      }
    }
  }
}

// NT: 8-key tiles of a row of logits held in registers (T <= 8 NT)
template <int NT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, NT <= 16 ? 2 : 1)
    attention_kv8_mma_kernel(const Args<__nv_bfloat16> a) {
  extern __shared__ __align__(128) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;  // a fragment's row and column pair
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int rows = a.H / a.Hkv * a.Sq, T = a.T;
  const int row_tiles = (rows + 15) / 16;
  const int slab_bytes = mask_slab_bytes(a.mask, a.m_s, a.m_t, a.Sq, T);
  const MmaLayout L = mma_layout(T, warps, slab_bytes);
  const uint32_t base = smem_u32(smem);
  const float* kss = reinterpret_cast<const float*>(smem + L.ks);
  const float* vss = reinterpret_cast<const float*>(smem + L.vs);
  unsigned char* qt = smem + L.q + warp * kMmaQTile;

  load_q_rows(a, qt, b, hk, rows, warp, lane);  // lands while the cache converts

  // the cache of (b, hk), its scales and the batch row's mask arrive by
  // cp.async, the int8 rows in the upper halves of the bf16 rows' slots; then
  // each thread converts whole rows in place
  const int8_t* kb = a.k + b * a.c_b + hk * a.c_h;
  const int8_t* vb = a.v + b * a.c_b + hk * a.c_h;
  const int per_tile = T * (kMmaDh / 16);
  for (int c = threadIdx.x; c < 2 * per_tile; c += blockDim.x) {
    const int is_v = c >= per_tile, rem = c - is_v * per_tile;
    cp_async16(base + (is_v ? L.v : L.k) + (rem >> 3) * kMmaRowBytes + kMmaDh + 16 * (rem & 7),
               (is_v ? vb : kb) + (rem >> 3) * a.c_t + 16 * (rem & 7), 16);
  }
  for (int t = threadIdx.x; t < L.tp; t += blockDim.x) {
    const int in = t < T ? 4 : 0;  // pad positions' scales are zeros
    const long long at = in ? b * a.s_b + t * a.s_t + hk * a.s_h : 0;
    cp_async4(base + L.ks + 4 * t, a.ks + at, in);
    cp_async4(base + L.vs + 4 * t, a.vs + at, in);
  }
  // pad positions: zero K and V rows (P V reads them, times p = 0)
  const int pad_chunks = (L.tp - T) * (kMmaDh / 8);
  for (int c = threadIdx.x; c < 2 * pad_chunks; c += blockDim.x) {
    const int is_v = c >= pad_chunks, rem = c - is_v * pad_chunks;
    *reinterpret_cast<uint4*>(smem + (is_v ? L.v : L.k) + (T + rem / 16) * kMmaRowBytes +
                              16 * (rem % 16)) = make_uint4(0u, 0u, 0u, 0u);
  }
  const unsigned char* slab = nullptr;
  if (slab_bytes) {
    // 16-byte chunks from the aligned address at or below the batch row's
    // first byte (inside the mask) to the last whole chunk, then the last
    // few bytes one at a time: nothing past the mask is read
    const uintptr_t at = reinterpret_cast<uintptr_t>(a.mask + b * a.m_b);
    const uintptr_t end = at + static_cast<uintptr_t>(a.Sq) * T;
    const uintptr_t lo = at & ~static_cast<uintptr_t>(15), hi = end & ~static_cast<uintptr_t>(15);
    const int chunks = static_cast<int>((hi - lo) / 16);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      cp_async16(base + L.mask + 16 * c, reinterpret_cast<const void*>(lo + 16 * c), 16);
    }
    for (int c = threadIdx.x; c < static_cast<int>(end - hi); c += blockDim.x) {
      smem[L.mask + (hi - lo) + c] = *reinterpret_cast<const unsigned char*>(hi + c);
    }
    slab = smem + L.mask + (at - lo);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the int8 rows and the scales are in place
  for (int r = threadIdx.x; r < 2 * T; r += blockDim.x) {
    unsigned char* row = smem + (r < T ? L.k + r * kMmaRowBytes : L.v + (r - T) * kMmaRowBytes);
    uint4 w[kMmaDh / 16];
#pragma unroll
    for (int i = 0; i < kMmaDh / 16; ++i) w[i] = reinterpret_cast<const uint4*>(row + kMmaDh)[i];
#pragma unroll
    for (int i = 0; i < kMmaDh / 16; ++i) {
      uint32_t h[8];
      bf16x4_of(w[i].x, h[0], h[1]);
      bf16x4_of(w[i].y, h[2], h[3]);
      bf16x4_of(w[i].z, h[4], h[5]);
      bf16x4_of(w[i].w, h[6], h[7]);
      reinterpret_cast<uint4*>(row)[2 * i] = make_uint4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<uint4*>(row)[2 * i + 1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
  __syncthreads();  // the bf16 tiles are in place

  // a lane's ldmatrix rows: q (A: rows 0-15, dims +0/+8), K (B: keys +0/+8,
  // dims +0/+8) and V (B, transposed: keys +0/+8, dims +0/+8)
  const uint32_t q_at = smem_u32(qt) + (lane & 15) * kMmaRowBytes + (lane >> 4) * 16;
  const uint32_t k_at =
      base + L.k + ((lane & 7) + ((lane >> 4) << 3)) * kMmaRowBytes + ((lane >> 3) & 1) * 16;
  const uint32_t v_at = base + L.v + (lane & 15) * kMmaRowBytes + (lane >> 4) * 16;
  const float scale = a.scale;

  for (int rt = warp; rt < row_tiles; rt += warps) {
    if (rt != warp) load_q_rows(a, qt, b, hk, rows, rt, lane);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();  // the warp's q rows are in place

    // the lane's mask bits of rows gr (lo) and gr + 8 (hi): bit 8 (nt % 4)
    // + e of word nt / 4 is its key 8 nt + 2 tq + e; and the 8-key tiles
    // that some row of the warp keeps (the same in every lane)
    const RowPos first = row_pos(16 * rt, a.Sq);
    uint32_t keep_lo[(NT + 3) / 4], keep_hi[(NT + 3) / 4];
    const RowPos lo = advance(first, gr, a.Sq), hi = advance(lo, 8, a.Sq);
    row_bits<NT>(a, slab, b, 16 * rt + gr < rows, lo.s, tq, keep_lo);
    row_bits<NT>(a, slab, b, 16 * rt + gr + 8 < rows, hi.s, tq, keep_hi);
    uint32_t mine = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mine |= ((keep_lo[nt / 4] | keep_hi[nt / 4]) >> (8 * (nt % 4))) & 3u ? 1u << nt : 0u;
    }
    // a warp reduction into a uniform register: the guards below are known
    // to agree across the warp
    const uint32_t live = __reduce_or_sync(0xffffffffu, mine);

    // logits: q K^T on the live tiles
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    uint32_t kf[4] = {0u, 0u, 0u, 0u};  // a pair's K fragments (kept when it is dead)
#pragma unroll
    for (int kk = 0; kk < kMmaDh / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(q_at + 32 * kk, qa);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        ldsm_x4_if((live >> (2 * p)) & 3u, k_at + p * 16 * kMmaRowBytes + 32 * kk, kf);
        mma_bf16_if((live >> (2 * p)) & 1u, s[2 * p], qa, kf[0], kf[1]);
        mma_bf16_if((live >> (2 * p + 1)) & 1u, s[2 * p + 1], qa, kf[2], kf[3]);
      }
    }

    // the masked softmax of rows gr (e = 0, 1) and gr + 8 (e = 2, 3), two
    // passes as the plain version: scaled logits and the row max, then the
    // numerators and their sum; a masked logit counts as f32_min, its
    // numerator as 0
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (!((live >> nt) & 1u)) continue;
      const float2 ks2 = *reinterpret_cast<const float2*>(kss + 8 * nt + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t word = e < 2 ? keep_lo[nt / 4] : keep_hi[nt / 4];
        const bool kept = (word >> (8 * (nt % 4) + (e & 1))) & 1u;
        const float l = __fmul_rn(__fmul_rn(s[nt][e], e & 1 ? ks2.y : ks2.x), scale);
        s[nt][e] = kept ? l : -FLT_MAX;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (!((live >> nt) & 1u)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t word = e < 2 ? keep_lo[nt / 4] : keep_hi[nt / 4];
        const bool kept = (word >> (8 * (nt % 4) + (e & 1))) & 1u;
        const float w = exp_sfu(__fsub_rn(s[nt][e], mx[e >> 1]));
        s[nt][e] = kept ? w : 0.f;
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[nt][e]);
      }
    }
    // 1 / max(sum, f32_tiny) once a row: w / den as w * (1 / den)
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
      inv[h] = __frcp_rn(fmaxf(sum[h], FLT_MIN));
    }
    // p = bf16((w / den) * vs), packed as the A fragments of P V (a dead
    // tile's p is 0)
    uint32_t pk[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pk[nt][0] = pk[nt][1] = 0u;
      if (!((live >> nt) & 1u)) continue;
      const float2 vs2 = *reinterpret_cast<const float2*>(vss + 8 * nt + 2 * tq);
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = __fmul_rn(__fmul_rn(s[nt][e], inv[e >> 1]), e & 1 ? vs2.y : vs2.x);
      }
      pk[nt][0] = bf16x2(pv[0], pv[1]);
      pk[nt][1] = bf16x2(pv[2], pv[3]);
    }

    // out: P V over the live 16-key steps
    float o[kMmaDh / 8][4];
#pragma unroll
    for (int dt = 0; dt < kMmaDh / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    uint32_t vf[4] = {0u, 0u, 0u, 0u};  // a step's V fragments (kept when it is dead)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const bool on = (live >> (2 * p)) & 3u;
      const uint32_t pa[4] = {pk[2 * p][0], pk[2 * p][1], pk[2 * p + 1][0], pk[2 * p + 1][1]};
#pragma unroll
      for (int dp = 0; dp < kMmaDh / 16; ++dp) {
        ldsm_x4_trans_if(on, v_at + p * 16 * kMmaRowBytes + 32 * dp, vf);
        mma_bf16_if(on, o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_if(on, o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }

    // the output rows, staged in the warp's q tile, 16 bytes a lane
    __syncwarp();  // every lane is done with q
#pragma unroll
    for (int dt = 0; dt < kMmaDh / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(qt + gr * kMmaRowBytes + 2 * (8 * dt + 2 * tq)) =
          bf16x2(o[dt][0], o[dt][1]);
      *reinterpret_cast<uint32_t*>(qt + (gr + 8) * kMmaRowBytes + 2 * (8 * dt + 2 * tq)) =
          bf16x2(o[dt][2], o[dt][3]);
    }
    __syncwarp();
    RowPos p = advance(first, lane >> 4, a.Sq);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (lane >> 4) + 2 * i, part = lane & 15;
      if (16 * rt + r < rows) {
        __nv_bfloat16* dst =
            a.out + ((static_cast<long long>(b) * a.Sq + p.s) * a.H + hk * (a.H / a.Hkv) + p.gi) *
                        kMmaDh + 8 * part;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(qt + r * kMmaRowBytes + 16 * part);
      }
      p = advance(p, 2, a.Sq);
    }
    __syncwarp();  // the tile is out before the next row tile's q lands
  }
}

template <typename E>
void launch(const Args<E>& a, int warps, long long smem, cudaStream_t stream) {
  attention_kv8_kernel<E><<<a.B * a.Hkv, warps * 32, static_cast<size_t>(smem), stream>>>(a);
}

template <int NT>
void launch_mma(const Args<__nv_bfloat16>& a, int warps, long long smem, cudaStream_t stream) {
  attention_kv8_mma_kernel<NT>
      <<<a.B * a.Hkv, warps * 32, static_cast<size_t>(smem), stream>>>(a);
}

}  // namespace

// q [B, Sq, H, Dh] bf16 (f32 with q_f32) by strides (last dim contiguous);
// k, v int8 cache [B, T, Hkv, Dh] by strides (last dim contiguous, a 16-byte
// aligned row);
// ks, vs f32 [B, T, Hkv] by strides; mask bool [B, Sq, T] by strides or null;
// out [B, Sq, H, Dh] in q's dtype, contiguous. H a multiple of Hkv, Dh a
// multiple of 16 up to 256. With `tensor_cores`, the mma.sync instance runs
// (its warps from the rows; `warps` is not read): it takes bf16 q with
// Sq > 1, Dh 128, T <= 256, q 16-byte aligned with strides that are
// multiples of 8. Otherwise the warp-a-row instance runs with `warps` warps
// a block; it returns kCacheTooLong when the warps' rows of Dh + T floats
// exceed the card's shared memory.
extern "C" int cgpt_attention_kv8(const void* q, long long q_b, long long q_s, long long q_h,
                                  const void* k, const void* v, long long c_b, long long c_t,
                                  long long c_h, const void* ks, const void* vs, long long s_b,
                                  long long s_t, long long s_h, const void* mask, long long m_b,
                                  long long m_s, long long m_t, void* out, int B, int Sq, int H,
                                  int Hkv, int T, int Dh, float scale, int warps, int q_f32,
                                  int tensor_cores, void* stream) {
  if (B <= 0 || Sq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh % 16 != 0 || Dh <= 0 ||
      Dh > kMaxHeadDim || warps < 1 || warps > kMaxWarps || c_t % 16 != 0 || c_h % 16 != 0 ||
      c_b % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || static_cast<long long>(B) * Hkv > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool mma = tensor_cores != 0;
  if (mma) {
    if (q_f32 || Sq < 2 || Dh != kMmaDh || T > kMmaMaxKeys || q_b % 8 != 0 || q_s % 8 != 0 ||
        q_h % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long tiles = (static_cast<long long>(H / Hkv) * Sq + 15) / 16;
    warps = static_cast<int>(tiles < kMmaMaxWarps ? tiles : kMmaMaxWarps);
  }
  const long long smem =
      mma ? mma_layout(T, warps, mask_slab_bytes(mask, m_s, m_t, Sq, T)).bytes
          : 4LL * warps * (Dh + T);
  // a device's shared-memory limit, read and granted to every instance
  // (with the most shared memory an SM can give) at its first call: a
  // decode step captured in a CUDA graph makes no query
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
    const void* tensor_core[] = {reinterpret_cast<const void*>(attention_kv8_mma_kernel<8>),
                                 reinterpret_cast<const void*>(attention_kv8_mma_kernel<14>),
                                 reinterpret_cast<const void*>(attention_kv8_mma_kernel<16>),
                                 reinterpret_cast<const void*>(attention_kv8_mma_kernel<32>)};
    for (const void* fn : rows) {  // the L1 keeps what it has: it serves the block's rows
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (const void* fn : tensor_core) {  // two blocks an SM need most of its memory
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
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
    return static_cast<int>(cudaGetLastError());
  }
  const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(q), q_b, q_s, q_h, k8, v8, c_b,
                              c_t, c_h, ksf, vsf, s_b, s_t, s_h, m8, m_b, m_s, m_t,
                              static_cast<__nv_bfloat16*>(out), B, Sq, H, Hkv, T, Dh, scale};
  if (!mma) {
    launch(a, warps, smem, st);
  } else if (T <= 64) {
    launch_mma<8>(a, warps, smem, st);
  } else if (T <= 112) {
    launch_mma<14>(a, warps, smem, st);
  } else if (T <= 128) {
    launch_mma<16>(a, warps, smem, st);
  } else {
    launch_mma<32>(a, warps, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
