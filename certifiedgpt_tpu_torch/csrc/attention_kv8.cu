// Attention over the decoder's int8 KV cache on Hopper (sm_90a), the cache
// dequantized inside the kernel, with new k and v rows quantized into the
// cache in the same launch: the tiled int8-KV kernel.
//
// Replaces the JAX package's multi_head_attention_kv8
// (certifiedgpt_tpu/ops/attention.py:76) and, with new rows, the cached
// block's quantize_rows of k and v, its four dynamic_update_slice writes and
// that attention (certifiedgpt_tpu/models/llama.py:243-270), for the shapes
// the two fused kernels do not take (ops/attention.py::kv8_kernel routes):
// f32 queries (the tiny and f32 configurations), bf16 queries at another
// head_dim than 128, and lone query rows at a group size the decode kernel
// has no instance for. What it computes, in the plain version's order
// (ops/attention.py::_prefill_attention_kv8_plain):
//   the cache write: xs = max(amax_d |x|, 1e-8) / 127 (an IEEE division),
//     codes clip(rint(x / xs), -127, 127) (an IEEE division, half to even),
//     for the Sn new k and v rows, written to slots [offset, offset + Sn):
//     bit for bit quantize_rows;
//   logits[t] = (sum_d q[d] * kq8[t, d]) * ks[t] * scale     (f32 sums)
//   where(mask, logits, f32_min), minus the row max, exp, where(mask, w, 0),
//   divided by max(sum, f32_tiny)    (a fully masked row gives zeros)
//   p[t] = (w[t] * vs[t]) in q's dtype (bf16 rounding for bf16 q)
//   out[d] = sum_t p[t] * vq8[t, d]   (f32 sums, stored in q's dtype)
// The products are exact in f32, so only the order of the f32 sums, the
// exponential's last bits and the softmax's sum (rescaled as its max grows)
// differ from the plain version.
//
// Design:
// - A block takes one (batch row, kv head) item and a tile of 16 W of its
//   g Sq query rows (rows gi Sq + s; W = 1..6 warps, a warp 16 rows). The
//   launcher picks the W whose blocks keep the most warps on an SM and cuts
//   an item's rows into as few tiles as that holds, evenly.
// - The new rows first: an item's row tiles form a cluster (up to 8
//   blocks; more tiles, more clusters), whose blocks quantize a share each
//   of the Sn new k and v rows into the cache (a warp eight rows at a
//   time, a lane four values; the divisions by reciprocal products where
//   that is exact, as csrc/attention_kv8_prefill.cu does), fence, and meet at the
//   cluster's barrier. Every block then reads all T positions from the
//   cache, the new rows among them: each row is quantized once a cluster.
// - The positions stream in tiles of 32 through a two-stage ring of int8
//   rows in shared memory (cp.async, 16 bytes a copy; the row scales 4),
//   read by every warp of the block: a cache byte crosses the L2 once a row
//   tile. Each landed tile is converted once into bf16 rows (byte permutes
//   and an f32 subtraction, no I2F; rows padded to 2 Dh + 16 bytes, so
//   ldmatrix is free of bank conflicts).
// - Products on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//   accumulation): q's fragments by ldmatrix from the block's staged q rows,
//   K's and V's from the converted tile. f32 q is staged as three bf16
//   terms (hi = q truncated to bf16, mid = the rest truncated, lo = what is
//   left: exact, as in csrc/int8_weight_matmul.cu) and p too, so an f32
//   product is three bf16 products of exact terms; bf16 q and its bf16 p
//   are one term.
// - Two passes over the tiles, the row of logits never stored, so the cache
//   may be of any length: pass 1 computes q K^T and each row's max and sum
//   of exponentials (the sum rescaled as the max grows); pass 2 computes q
//   K^T again, p from the final max and sum, and P V with P straight from
//   the registers. The output's registers cover the head_dim instance (64,
//   128 or 256 values a row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <initializer_list>

#include "kv8_codes.cuh"

namespace {

constexpr int kKeys = 32;        // positions a tile
constexpr int kMaxWarps = 6;     // row tiles of 16 a block
constexpr int kMaxHeadDim = 256;
constexpr int kMaxCluster = 8;   // blocks of one item that share its new rows

template <typename E>
struct Args {
  const E* q;  // [B, Sq, H, Dh], strides in elements, dim contiguous
  long long q_b, q_s, q_h;
  const E* kn;  // the Sn new k rows [B, Sn, Hkv, Dh] (null: nothing written)
  long long kn_b, kn_s, kn_h;
  const E* vn;  // the new v rows, by their own strides
  long long vn_b, vn_s, vn_h;
  int8_t* k;  // the int8 cache [B, T, Hkv, Dh] (k and v share the strides)
  int8_t* v;
  long long c_b, c_t, c_h;
  float* ks;  // the row scales [B, T, Hkv] (ks and vs share the strides)
  float* vs;
  long long s_b, s_t, s_h;
  const uint8_t* mask;  // bool [B, Sq, T] by strides (0 for broadcast), or null
  long long m_b, m_s, m_t;
  E* out;  // [B, Sq, H, Dh] contiguous
  int Sq, H, Hkv, T, Dh, offset, Sn;
  float scale;
};

// bf16 terms a value of q (and of p) in each dtype
template <typename E>
__host__ __device__ constexpr int terms() {
  return sizeof(E) == 4 ? 3 : 1;
}

// Where each part lives in the block's shared memory, in bytes: the ring
// (each stage: K rows, V rows, K scales, V scales), the converted tile (K
// and V bf16 rows of `row` bytes, then their scales) and the q terms (16 W
// rows each).
struct Layout {
  int row, stage, ring, tile, q, bytes;
};

__host__ __device__ inline Layout layout(int Dh, int warps, int nterms) {
  Layout l;
  l.row = 2 * Dh + 16;
  l.stage = 2 * kKeys * Dh + 2 * 4 * kKeys;
  l.ring = 0;
  l.tile = 2 * l.stage;
  l.q = l.tile + 2 * kKeys * l.row + 2 * 4 * kKeys;
  l.bytes = l.q + nterms * 16 * warps * l.row;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four signed bytes -> four exact bf16 (two pairs, the lower byte in the
// lower half), without I2F: the byte offset to unsigned is the low mantissa
// byte of the f32 2^23 + u, 2^23 + 128 is subtracted, and the bf16 is the
// f32's upper half.
__device__ __forceinline__ uint2 bf16x4_of(uint32_t w) {
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kOffset = 8388736.f;      // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7440)), kOffset);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7441)), kOffset);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7442)), kOffset);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7443)), kOffset);
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// The bf16 terms of an f32 value, largest first, as their f32 bit patterns
// (the upper halves are the bf16 values): hi = x truncated to bf16, mid =
// (x - hi) truncated, lo = x - hi - mid; an infinite x is its own hi.
__device__ __forceinline__ void split3(float x, uint32_t (&t)[3]) {
  t[0] = __float_as_uint(x) & 0xFFFF0000u;
  const float hi = __uint_as_float(t[0]);
  const float r = hi == x ? 0.f : __fsub_rn(x, hi);
  t[1] = __float_as_uint(r) & 0xFFFF0000u;
  t[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(t[1])));
}

// Two values as bf16 pairs, one a term (the lower value in the lower half):
// bf16 p is already bf16 (exact), f32 p is split.
template <int N>
__device__ __forceinline__ void pair_terms(float x0, float x1, uint32_t (&out)[N]) {
  if constexpr (N == 1) {
    out[0] = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  } else {
    uint32_t a[3], b[3];
    split3(x0, a);
    split3(x1, b);
#pragma unroll
    for (int e = 0; e < 3; ++e) out[e] = __byte_perm(a[e], b[e], 0x7632);
  }
}

// four values (8- or 16-byte aligned) -> f32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// p in q's dtype, back in f32: rounded to bf16 for bf16 q, kept for f32
__device__ __forceinline__ float in_dtype(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float in_dtype(float v, const float*) { return v; }

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// The block's view of its item: batch row, kv head, the cache's and the new
// rows' bases.
struct Item {
  int b, hk;
  const int8_t* kc;
  const int8_t* vc;
  const float* ksc;
  const float* vsc;
};

// Starts the copies of the tile at t0 into ring stage `st` (K rows, and V
// rows with `with_v`) from the cache by cp.async (16 bytes a copy, the
// scales 4), positions past T as zeros.
template <typename E>
__device__ __forceinline__ void issue_tile(const Args<E>& a, const Item& it, unsigned char* st,
                                           int t0, bool with_v) {
  const int per_row = a.Dh / 16, n = kKeys * per_row, sets = with_v ? 2 : 1;
  for (int i = threadIdx.x; i < sets * n; i += blockDim.x) {
    const int set = i >= n, j = i - set * n;
    const int r = j / per_row, c = j - r * per_row, t = t0 + r;
    const bool in = t < a.T;
    cp_async16(smem_u32(st + set * kKeys * a.Dh + r * a.Dh + 16 * c),
               (set ? it.vc : it.kc) + (in ? t * a.c_t + 16 * c : 0), in ? 16 : 0);
  }
  float* scales = reinterpret_cast<float*>(st + 2 * kKeys * a.Dh);
  for (int i = threadIdx.x; i < sets * kKeys; i += blockDim.x) {
    const int set = i >= kKeys, r = i - set * kKeys, t = t0 + r;
    if (t < a.T) {
      cp_async4(smem_u32(scales + set * kKeys + r), (set ? it.vsc : it.ksc) + t * a.s_t);
    } else {
      scales[set * kKeys + r] = 0.f;
    }
  }
}

// This block's share (`share` of `shares`) of the item's Sn new k and v rows
// quantized into the cache at slots [offset, offset + Sn), codes and scales
// bit for bit quantize_rows': a warp eight rows at a time (their loads in
// flight together), a lane four neighbouring values (16 or 8 bytes a load,
// four codes a store).
template <typename E>
__device__ __forceinline__ void write_new_rows(const Args<E>& a, const Item& it, int share,
                                               int shares) {
  constexpr int kRows = 8, kGroups = kMaxHeadDim / 128;  // four-value groups a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int n = 2 * a.Sn;  // the K rows, then the V rows
  for (int i0 = kRows * (warp + warps * share); i0 < n; i0 += kRows * warps * shares) {
    float4 xv[kRows][kGroups];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = min(i0 + u, n - 1), set = i >= a.Sn, sn = i - set * a.Sn;
      const E* x = set ? a.vn + it.b * a.vn_b + sn * a.vn_s + it.hk * a.vn_h
                       : a.kn + it.b * a.kn_b + sn * a.kn_s + it.hk * a.kn_h;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int d = 4 * lane + 128 * j;
        xv[u][j] = d < a.Dh ? load4(x + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (i0 + u >= n) break;
      const int set = i0 + u >= a.Sn, t = a.offset + i0 + u - set * a.Sn;
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(xv[u][j].x), fabsf(xv[u][j].y)),
                                 fmaxf(fabsf(xv[u][j].z), fabsf(xv[u][j].w))));
      }
      const float xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.f), rcp = __frcp_rn(xs);
      int8_t* crow = (set ? a.v : a.k) + it.b * a.c_b + t * a.c_t + it.hk * a.c_h;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int d = 4 * lane + 128 * j;
        if (d >= a.Dh) continue;
        const float v[4] = {xv[u][j].x, xv[u][j].y, xv[u][j].z, xv[u][j].w};
        float q[4];
        uint32_t codes[1];
        cgpt_kv8::codes_of(v, xs, rcp, q, codes);
        *reinterpret_cast<uint32_t*>(crow + d) = codes[0];
      }
      if (lane == 0) (set ? a.vs : a.ks)[it.b * a.s_b + t * a.s_t + it.hk * a.s_h] = xs;
    }
  }
}

// The cluster's barrier: every block's earlier memory operations (this
// thread fenced its global writes) are seen by the others' later ones.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Ring stage `st` -> the converted tile: bf16 K (and V) rows of codes and
// their scales.
__device__ __forceinline__ void convert_tile(const unsigned char* st, unsigned char* tile, int Dh,
                                             int row_bytes, bool with_v) {
  const int pieces = Dh / 16, n = kKeys * pieces, sets = with_v ? 2 : 1;
  for (int i = threadIdx.x; i < sets * n; i += blockDim.x) {
    const int set = i >= n, j = i - set * n;
    const int r = j / pieces, c = j - r * pieces;
    const uint4 w = *reinterpret_cast<const uint4*>(st + set * kKeys * Dh + r * Dh + 16 * c);
    const uint2 p0 = bf16x4_of(w.x), p1 = bf16x4_of(w.y), p2 = bf16x4_of(w.z),
                p3 = bf16x4_of(w.w);
    uint4* dst = reinterpret_cast<uint4*>(tile + (set * kKeys + r) * row_bytes + 32 * c);
    dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
  const float* from = reinterpret_cast<const float*>(st + 2 * kKeys * Dh);
  float* to = reinterpret_cast<float*>(tile + 2 * kKeys * row_bytes);
  for (int i = threadIdx.x; i < sets * kKeys; i += blockDim.x) to[i] = from[i];
}

// E: q's, the new rows' and the output's dtype; DH: the head_dim instance
// (Dh <= DH values a row in the output's registers).
template <typename E, int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, DH <= 128 ? 2 : 1)
    attention_kv8_kernel(const Args<E> a) {
  constexpr int kTerms = terms<E>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int Dh = a.Dh, gq = a.H / a.Hkv, rows = gq * a.Sq;
  const Layout L = layout(Dh, warps, kTerms);
  const int r0 = blockIdx.x * 16 * warps;
  Item it;
  it.b = blockIdx.z;
  it.hk = blockIdx.y;
  it.kc = a.k + it.b * a.c_b + it.hk * a.c_h;
  it.vc = a.v + it.b * a.c_b + it.hk * a.c_h;
  it.ksc = a.ks + it.b * a.s_b + it.hk * a.s_h;
  it.vsc = a.vs + it.b * a.s_b + it.hk * a.s_h;
  const int tiles = (a.T + kKeys - 1) / kKeys;

  // the new rows: the cluster's blocks (an item's row tiles) quantize a
  // share each into the cache; after the cluster's barrier every block
  // reads them from there (a block past the item's rows then leaves)
  if (a.kn != nullptr) {
    write_new_rows(a, it, cluster_rank(), cluster_blocks());
    __threadfence();
    cluster_sync();
  }
  if (r0 >= rows) return;

  // the block's q rows as bf16 terms, four values a thread at a time
  for (int i = threadIdx.x; i < 4 * warps * Dh; i += blockDim.x) {
    const int rr = i / (Dh / 4), d = 4 * (i - rr * (Dh / 4)), r = r0 + rr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int gi = r / a.Sq, s = r - gi * a.Sq;
      x = load4(a.q + it.b * a.q_b + s * a.q_s + (it.hk * gq + gi) * a.q_h + d);
    }
    unsigned char* qs = smem + L.q + rr * L.row + 2 * d;
    if constexpr (kTerms == 1) {
      *reinterpret_cast<uint2*>(qs) =  // exact: x is bf16
          make_uint2(__byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632),
                     __byte_perm(__float_as_uint(x.z), __float_as_uint(x.w), 0x7632));
    } else {
      uint32_t t[4][3];
      split3(x.x, t[0]);
      split3(x.y, t[1]);
      split3(x.z, t[2]);
      split3(x.w, t[3]);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        *reinterpret_cast<uint2*>(qs + e * 16 * warps * L.row) =
            make_uint2(__byte_perm(t[0][e], t[1][e], 0x7632), __byte_perm(t[2][e], t[3][e], 0x7632));
      }
    }
  }

  // this thread's two rows (g and g + 8 of the warp's 16): their mask rows
  const int ra = r0 + 16 * warp + g, rb = ra + 8;
  const bool va = ra < rows, vb = rb < rows;
  const int sa = va ? ra % a.Sq : 0, sb = vb ? rb % a.Sq : 0;
  const uint8_t* ma = a.mask == nullptr ? nullptr : a.mask + it.b * a.m_b + sa * a.m_s;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + it.b * a.m_b + sb * a.m_s;
  // the positions of the tile at t0 that rows g (bits 0-7) and g + 8 (bits
  // 8-15) keep, bit 2 nf + e for key 8 nf + 2 t4 + e: the mask bytes loaded
  // all at once (no branch between them)
  const auto keep_bits = [&](int t0) {
    uint32_t bits = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* m = h ? mb : ma;
      const bool valid = h ? vb : va;
      uint8_t byte[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int t = min(t0 + 8 * (c >> 1) + 2 * t4 + (c & 1), a.T - 1);
        byte[c] = m == nullptr ? 1 : __ldg(m + t * a.m_t);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int t = t0 + 8 * (c >> 1) + 2 * t4 + (c & 1);
        bits |= static_cast<uint32_t>(valid && t < a.T && byte[c] != 0) << (8 * h + c);
      }
    }
    return bits;
  };

  // q K^T of the converted tile at `tile` for the warp's 16 rows: s[nf] holds
  // keys 8 nf + 2 t4, + 1 of rows g (0, 1) and g + 8 (2, 3)
  const uint32_t q_base = smem_u32(smem + L.q + (16 * warp + (lane & 15)) * L.row + 16 * (lane >> 4));
  const auto logits = [&](const unsigned char* tile, float (&s)[4][4]) {
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
    // K's x4: keys (j >> 1) 8 + lane % 8, dims (j & 1) 8 of each 16-key half
    const uint32_t k_base =
        smem_u32(tile + (((lane >> 4) << 3) + (lane & 7)) * L.row + 16 * ((lane >> 3) & 1));
    for (int kc = 0; kc < Dh / 16; ++kc) {
      uint32_t kb[2][4];
      ldmatrix_x4(kb[0], k_base + 32 * kc);
      ldmatrix_x4(kb[1], k_base + 16 * L.row + 32 * kc);
#pragma unroll
      for (int e = kTerms - 1; e >= 0; --e) {  // smallest term first
        uint32_t qa[4];
        ldmatrix_x4(qa, q_base + e * 16 * warps * L.row + 32 * kc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(s[2 * h], qa, kb[h][0], kb[h][1]);
          mma_bf16(s[2 * h + 1], qa, kb[h][2], kb[h][3]);
        }
      }
    }
  };
  // the logits of the tile at t0 (scaled), -FLT_MAX where not kept
  const auto scaled = [&](const unsigned char* tile, int t0, float (&s)[4][4]) {
    const float* ksc = reinterpret_cast<const float*>(tile + 2 * kKeys * L.row);
    const uint32_t bits = keep_bits(t0);
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nf + 2 * t4 + (e & 1);
        const bool on = (bits >> (8 * (e >> 1) + 2 * nf + (e & 1))) & 1;
        s[nf][e] = on ? __fmul_rn(__fmul_rn(s[nf][e], ksc[c]), a.scale) : -FLT_MAX;
      }
  };

  // The tile loop of a pass: stage K (and V) tiles, convert, then `body` on
  // the converted tile.
  const auto pass = [&](bool with_v, auto&& body) {
    issue_tile(a, it, smem + L.ring, 0, with_v);
    cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
      unsigned char* st = smem + L.ring + (i & 1) * L.stage;
      if (i + 1 < tiles) {
        issue_tile(a, it, smem + L.ring + ((i + 1) & 1) * L.stage, (i + 1) * kKeys, with_v);
      }
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();  // tile i has landed; every warp is done with tile i - 1
      convert_tile(st, smem + L.tile, Dh, L.row, with_v);
      __syncthreads();  // the converted tile is in place
      body(smem + L.tile, i * kKeys);
    }
  };

  // pass 1: each row's max and sum of exponentials
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  pass(false, [&](const unsigned char* tile, int t0) {
    float s[4][4];
    logits(tile, s);
    scaled(tile, t0, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) mx = fmaxf(mx, fmaxf(s[nf][2 * h], s[nf][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = m[h] == mx ? l[h] : __fmul_rn(l[h], expf(__fsub_rn(m[h], mx)));
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nf][2 * h + e];
          if (x != -FLT_MAX) sum = __fadd_rn(sum, expf(__fsub_rn(x, mx)));
        }
      m[h] = mx;
      l[h] = sum;
    }
  });
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    den[h] = fmaxf(sum, FLT_MIN);
  }

  // pass 2: p and P V
  float o[DH / 8][4];
#pragma unroll
  for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
  pass(true, [&](const unsigned char* tile, int t0) {
    float s[4][4];
    logits(tile, s);
    scaled(tile, t0, s);
    const float* vsc = reinterpret_cast<const float*>(tile + 2 * kKeys * L.row) + kKeys;
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = s[nf][e];
        s[nf][e] = x == -FLT_MAX ? 0.f
                                 : in_dtype(__fmul_rn(__fdiv_rn(expf(__fsub_rn(x, m[h])), den[h]),
                                                      vsc[8 * nf + 2 * t4 + (e & 1)]),
                                            a.q);
      }
    // V's x4 (transposed): keys (j & 1) 8 + lane % 8, dims (j >> 1) 8
    const uint32_t v_base = smem_u32(tile + (kKeys + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.row +
                                     16 * (lane >> 4));
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // keys 16 kk .. 16 kk + 15
      uint32_t pa[4][kTerms];
      pair_terms(s[2 * kk][0], s[2 * kk][1], pa[0]);
      pair_terms(s[2 * kk][2], s[2 * kk][3], pa[1]);
      pair_terms(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
      pair_terms(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        if (16 * np >= Dh) break;
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, v_base + 16 * kk * L.row + 32 * np);
#pragma unroll
        for (int e = kTerms - 1; e >= 0; --e) {
          const uint32_t pe[4] = {pa[0][e], pa[1][e], pa[2][e], pa[3][e]};
          mma_bf16(o[2 * np], pe, vb4[0], vb4[1]);
          mma_bf16(o[2 * np + 1], pe, vb4[2], vb4[3]);
        }
      }
    }
  });

  // the output rows g and g + 8 of the warp's tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (!(h ? vb : va)) continue;
    const int gi = r / a.Sq, s = r - gi * a.Sq;
    E* orow = a.out + ((static_cast<long long>(it.b) * a.Sq + s) * a.H + it.hk * gq + gi) * Dh;
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf) {
      if (8 * nf < Dh) store2(orow + 8 * nf + 2 * t4, o[nf][2 * h], o[nf][2 * h + 1]);
    }
  }
}

// The instance for x of dtype E at head_dim Dh.
template <typename E>
const void* instance(int Dh) {
  if (Dh <= 64) return reinterpret_cast<const void*>(attention_kv8_kernel<E, 64>);
  if (Dh <= 128) return reinterpret_cast<const void*>(attention_kv8_kernel<E, 128>);
  return reinterpret_cast<const void*>(attention_kv8_kernel<E, 256>);
}

// Warps a block and row tiles an item for items of `rows` query rows: the
// block width whose blocks keep the most warps on an SM (by shared memory
// and registers, the wider among equals), then the rows cut evenly into as
// few tiles of that width as hold them. Grants every instance the card's
// shared memory at a device's first call (a host query: a launch captured in
// a CUDA graph makes none on the stream).
template <typename E>
cudaError_t choose(long long rows, int Dh, int* warps, long long* tiles) {
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!granted[dev]) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    for (const int dh : {64, 128, 256}) {
      for (const void* fn : {instance<__nv_bfloat16>(dh), instance<float>(dh)}) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
      }
    }
    granted[dev] = true;
  }
  int best = 1, best_warps = 0;
  for (int w = 1; w <= kMaxWarps; ++w) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, instance<E>(Dh), 32 * w, static_cast<size_t>(layout(Dh, w, terms<E>()).bytes));
    if (err != cudaSuccess) return err;
    if (per_sm * w >= best_warps) best = w, best_warps = per_sm * w;
  }
  if (best_warps == 0) return cudaErrorInvalidValue;
  *tiles = (rows + 16 * best - 1) / (16 * best);
  *warps = static_cast<int>(((rows + *tiles - 1) / *tiles + 15) / 16);
  return cudaSuccess;
}

// With new rows, an item's row tiles form clusters of up to kMaxCluster
// blocks (the grid's x padded to whole clusters).
template <typename E, int DH>
cudaError_t launch(const Args<E>& a, int B, int tiles, int warps, cudaStream_t st) {
  const int cluster = a.kn == nullptr ? 1 : (tiles < kMaxCluster ? tiles : kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + cluster - 1) / cluster * cluster, a.Hkv, B);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = static_cast<size_t>(layout(a.Dh, warps, terms<E>()).bytes);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, attention_kv8_kernel<E, DH>, a);
}

template <typename E>
cudaError_t launch_dh(const Args<E>& a, int B, cudaStream_t st) {
  int warps = 0;
  long long tiles = 0;
  const cudaError_t err = choose<E>(static_cast<long long>(a.H / a.Hkv) * a.Sq, a.Dh, &warps,
                                    &tiles);
  if (err != cudaSuccess) return err;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int n = static_cast<int>(tiles);
  if (a.Dh <= 64) return launch<E, 64>(a, B, n, warps, st);
  if (a.Dh <= 128) return launch<E, 128>(a, B, n, warps, st);
  return launch<E, 256>(a, B, n, warps, st);
}

}  // namespace

// q [B, Sq, H, Dh] bf16 (f32 with q_f32) by strides (dim contiguous, 16-byte
// aligned rows); the Sn new k and v rows [B, Sn, Hkv, Dh] in q's dtype by
// their strides (dim contiguous, 16-byte aligned rows), or null (Sn 0: nothing
// written); the int8 cache k, v [B, T, Hkv, Dh] by shared strides (16-byte
// aligned rows), written at slots [offset, offset + Sn); the f32 scales ks,
// vs [B, T, Hkv] by shared strides; mask bool [B, Sq, T] by strides or null;
// out [B, Sq, H, Dh] in q's dtype, contiguous. H a multiple of Hkv, Dh a
// multiple of 16 up to 256, B at most 65535; any T.
extern "C" int cgpt_attention_kv8(
    const void* q, long long q_b, long long q_s, long long q_h, const void* kn, long long kn_b,
    long long kn_s, long long kn_h, const void* vn, long long vn_b, long long vn_s,
    long long vn_h, void* k, void* v, long long c_b, long long c_t, long long c_h, void* ks,
    void* vs, long long s_b, long long s_t, long long s_h, const void* mask, long long m_b,
    long long m_s, long long m_t, void* out, int B, int Sq, int H, int Hkv, int T, int Dh,
    int offset, int Sn, float scale, int q_f32, void* stream) {
  const int esize = q_f32 ? 4 : 2;
  const auto aligned = [esize](const void* p, long long b, long long s, long long h) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (esize * b) % 16 == 0 &&
           (esize * s) % 16 == 0 && (esize * h) % 16 == 0;
  };
  if (B <= 0 || B > 65535 || Sq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || Hkv > 65535 ||
      Dh % 16 != 0 || Dh <= 0 || Dh > kMaxHeadDim || c_t % 16 != 0 || c_h % 16 != 0 ||
      c_b % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || !aligned(q, q_b, q_s, q_h) ||
      (kn == nullptr) != (vn == nullptr) ||
      (kn == nullptr ? Sn != 0
                     : (Sn <= 0 || offset < 0 || offset + Sn > T ||
                        !aligned(kn, kn_b, kn_s, kn_h) || !aligned(vn, vn_b, vn_s, vn_h)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int off = kn == nullptr ? T : offset;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k8 = static_cast<int8_t*>(k), v8 = static_cast<int8_t*>(v);
  const auto ksf = static_cast<float*>(ks), vsf = static_cast<float*>(vs);
  const auto m8 = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if (q_f32) {
    const Args<float> a{static_cast<const float*>(q), q_b, q_s, q_h,
                        static_cast<const float*>(kn), kn_b, kn_s, kn_h,
                        static_cast<const float*>(vn), vn_b, vn_s, vn_h,
                        k8, v8, c_b, c_t, c_h, ksf, vsf, s_b, s_t, s_h, m8, m_b, m_s, m_t,
                        static_cast<float*>(out), Sq, H, Hkv, T, Dh, off, Sn, scale};
    err = launch_dh(a, B, st);
  } else {
    const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(q), q_b, q_s, q_h,
                                static_cast<const __nv_bfloat16*>(kn), kn_b, kn_s, kn_h,
                                static_cast<const __nv_bfloat16*>(vn), vn_b, vn_s, vn_h,
                                k8, v8, c_b, c_t, c_h, ksf, vsf, s_b, s_t, s_h, m8, m_b, m_s, m_t,
                                static_cast<__nv_bfloat16*>(out), Sq, H, Hkv, T, Dh, off, Sn,
                                scale};
    err = launch_dh(a, B, st);
  }
  return static_cast<int>(err);
}

// The launch plan for items of g Sq rows at head_dim Dh (q_f32: the f32
// instance's), into out[3]: warps a block, row tiles an item, shared bytes a
// block.
extern "C" int cgpt_attention_kv8_plan(int Sq, int g, int Dh, int q_f32, int* out) {
  if (Sq <= 0 || g <= 0 || Dh % 16 != 0 || Dh <= 0 || Dh > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = 0;
  long long tiles = 0;
  const long long rows = static_cast<long long>(g) * Sq;
  const cudaError_t err = q_f32 ? choose<float>(rows, Dh, &warps, &tiles)
                                : choose<__nv_bfloat16>(rows, Dh, &warps, &tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = warps;
  out[1] = static_cast<int>(tiles);
  out[2] = layout(Dh, warps, q_f32 ? 3 : 1).bytes;
  return 0;
}
