// The decoder's training attention on Hopper (sm_90a): packed causal
// self-attention without a cache, forward and backward, bf16 at head_dim 128
// (Vicuna-7B; instances at 16, 32 and 64 serve the narrow test models).
//
// Replaces the XLA fusion of the JAX package's `multi_head_attention`
// (certifiedgpt_tpu/ops/attention.py:23-73) under the training mask
// (certifiedgpt_tpu/models/llama.py:323-331) and its autodiff:
//   l[i, j] = f32(q_i . k_j) * scale                  (bf16 operands, f32 sums)
//   key j visible to query i iff j <= i, key j valid, and seg[i] == seg[j]
//   P = exp(l - max) / max(sum exp(l - max), tiny) over visible keys (f32),
//       0 elsewhere: a fully masked row (a pad slot) gives zeros, not NaN
//   out_i = bf16(sum_j bf16(P[i, j]) v_j)              (f32 sums)
// and the steps of jax.vjp of it, given the output's gradient g:
//   dP = bf16(g . v_j)  dv_j = bf16(sum_i bf16(P[i, j]) g_i)
//   dS = P (dP - D_i) scale, D_i = sum_j P[i, j] dP[i, j]   (f32, unrounded P)
//   dq_i = bf16(sum_j dS[i, j] k_j)  dk_j = bf16(sum_i dS[i, j] q_i)
// dS is f32 and the reference multiplies it by k and q in f32: here it is
// the sum of three exact bf16 terms (hi = bf16(dS), mid = bf16(dS - hi), lo =
// bf16(dS - hi - mid): 24 bits, the whole f32 significand), each multiplied
// on the tensor cores, three products where one would round dS to 8 bits
// (csrc/int8_weight_matmul.cu's f32 instance splits its rows the same way).
// The weights are normalized before they are rounded to bf16, as the
// reference does, so the forward takes each row's max and sum before it
// forms P: an online softmax, which divides at the end, would round
// elsewhere. Rounding differs from the reference only in the order of f32
// sums (the tensor cores', the row reductions').
//
// Kernels (mma.sync m16n8k16 bf16 -> f32, tiles of 64 queries x 64 keys
// in shared memory, 16-byte chunks swizzled so that ldmatrix reads without
// bank conflicts; four warps, 16 rows each):
//   train_attention_fwd_kernel  a block a (row, head, 64 queries): pass 1
//       the row max and the sum of exp(l - max) (each thread's partial sum
//       rescaled when its max rises, the row's four threads combined at the
//       end), pass 2 P, rounded, times v. Writes out and the row statistics
//       (max, sum) [B, H, S] f32, which the backward reads: no [S, S] tensor
//       is saved.
//   train_attention_dq_kernel   a block a (row, head, 64 queries): pass 1
//       D_i from P and dP, pass 2 dS and dq; writes dq and D [B, H, S].
//   train_attention_dkv_kernel  a block a (row, kv head, 64 keys), over the
//       query tiles that see them (and the group's query heads): P^T and
//       dP^T recomputed from the statistics, dv and dk summed in registers.
// Whole key tiles that no query of the tile can see are skipped: past the
// causal diagonal, and tiles whose valid keys carry no segment id of the
// query tile's range. The tiles a block walks come in by cp.async into two
// buffers, the next visible tile's copies in flight while it works on one.
//
// Bound on the H100 at a train step's layer (q, k, v [16, 256, 32, 128]
// bf16, causal, three packed segments a row): bytes, the forward reading q,
// k, v and writing out (134 MB, 0.040 ms at 3.35 TB/s), the backward
// reading q, k, v, g and writing dq, dk, dv (235 MB, 0.070 ms); its products
// are a fraction of a millisecond at 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kMaxD = 128;    // the widest head_dim (Vicuna-7B's); 16, 32 and 64 too
constexpr int kTile = 64;     // queries or keys a tile
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kTileBytes = kTile * kMaxD * 2;  // 16384: 64 rows of 256 bytes at any width
constexpr float kTiny = 1.17549435e-38f;   // finfo(float32).tiny

struct Args {
  const __nv_bfloat16* q;  // [B, S, H, D] contiguous
  const __nv_bfloat16* k;  // [B, S, Hkv, D]
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;  // the output's gradient [B, S, H, D] (backward)
  __nv_bfloat16* out;      // forward: out; dq kernel: dq
  __nv_bfloat16* dk;       // [B, S, Hkv, D]
  __nv_bfloat16* dv;
  float* mx;    // [B, H, S] the rows' max
  float* sum;   // [B, H, S] the rows' sum of exp(l - max)
  float* dsum;  // [B, H, S] D_i
  const int* valid;  // [B, S]
  const int* seg;    // [B, S] or null
  int S, H, Hkv;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ch (of 16) of row r in a swizzled tile (a
// narrower head leaves the row's last chunks unused)
__device__ __forceinline__ uint32_t chunk_at(int r, int ch) {
  return r * 256 + (((ch & 8) | ((ch & 7) ^ (r & 7))) << 4);
}

// rows [r0, r0 + 64) of head h of row b of x [B, S, heads, kD] into a tile;
// rows past S zero-filled
template <int kD>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* x, int b, int r0,
                                          int h, int heads, int S) {
#pragma unroll
  for (int i = 0; i < kTile * (kD / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (kD / 8), ch = c % (kD / 8);
    const bool in = r0 + r < S;
    const __nv_bfloat16* src =
        x + ((static_cast<long long>(b) * S + (in ? r0 + r : 0)) * heads + h) * kD + ch * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tile + chunk_at(r, ch)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void loads_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void commit_loads() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Runs body(i, buf) for each index i of [0, n) that visible(i) accepts, in
// order, after load(i, buf) has brought its tiles into buffer buf (0 or 1);
// the next accepted index's copies are in flight while body works. Every
// thread calls visible (it may synchronize the block) and gets the same
// answer.
template <typename Visible, typename Load, typename Body>
__device__ __forceinline__ void over_tiles(int n, Visible visible, Load load, Body body) {
  int i = 0;
  while (i < n && !visible(i)) ++i;
  if (i < n) load(i, 0);
  commit_loads();
  for (int buf = 0; i < n; buf ^= 1) {
    int next = i + 1;
    while (next < n && !visible(next)) ++next;
    if (next < n) load(next, buf ^ 1);
    commit_loads();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but the newest: tile i's
    __syncthreads();
    body(i, buf);
    __syncthreads();  // buffer buf is free for the tile after next
    i = next;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the warp's 16 rows x 64 columns of A B^T, A's rows (16 w on) and B's rows
// (the columns) both tiles in shared memory, the depth kD
template <int kD>
__device__ __forceinline__ void rows_times_rows(float (&acc)[8][4], uint32_t a_tile,
                                                uint32_t b_tile, int row0) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a_tile + chunk_at(row0 + (l & 7) + ((l >> 3) & 1) * 8, 2 * ks + (l >> 4)), a);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b_tile + chunk_at(16 * np + (l & 7) + ((l >> 4) & 1) * 8, 2 * ks + ((l >> 3) & 1)),
              b);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// the same with 32 columns (B's rows c0 .. c0 + 31)
template <int kD>
__device__ __forceinline__ void rows_times_rows32(float (&acc)[4][4], uint32_t a_tile,
                                                  uint32_t b_tile, int row0, int c0) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a_tile + chunk_at(row0 + (l & 7) + ((l >> 3) & 1) * 8, 2 * ks + (l >> 4)), a);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b_tile +
                  chunk_at(c0 + 16 * np + (l & 7) + ((l >> 4) & 1) * 8, 2 * ks + ((l >> 3) & 1)),
              b);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x kD) += a (16 x 16: the A fragment of columns 16 kt .. of the
// left operand) times rows 16 kt .. 16 kt + 15 of the tile (k = the tile's
// rows, n = its kD columns)
template <int kD>
__device__ __forceinline__ void times_tile(float (&acc)[kD / 8][4], const uint32_t (&a)[4],
                                           uint32_t tile, int kt) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(tile + chunk_at(16 * kt + (l & 7) + ((l >> 3) & 1) * 8, 2 * dp + (l >> 4)), b);
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// the A fragment of accumulator columns 16 kt .. 16 kt + 15 (n-tiles 2 kt,
// 2 kt + 1) rounded to bf16
template <int kN>
__device__ __forceinline__ void a_fragment(const float (&acc)[kN][4], int kt, uint32_t (&a)[4]) {
  a[0] = pack(acc[2 * kt][0], acc[2 * kt][1]);
  a[1] = pack(acc[2 * kt][2], acc[2 * kt][3]);
  a[2] = pack(acc[2 * kt + 1][0], acc[2 * kt + 1][1]);
  a[3] = pack(acc[2 * kt + 1][2], acc[2 * kt + 1][3]);
}

// the three exact bf16 terms of f32 values, in place: x becomes x - bf16(x)
template <int kN>
__device__ __forceinline__ void split_off(float (&acc)[kN][4], float (&hi)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[n][e] = bf16_round(acc[n][e]);
      acc[n][e] = __fsub_rn(acc[n][e], hi[n][e]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// query i sees key j
__device__ __forceinline__ bool sees(int i, int j, int S, const int* valid, const int* seg) {
  return i < S && j < S && j <= i && valid[j] != 0 && (seg == nullptr || seg[i] == seg[j]);
}

// Whether any query of [q0, q0 + 64) may see a key of [k0, k0 + 64): a key
// at or before the tile's last query, valid, whose segment id lies in the
// query tile's range (a superset of the pairs that see each other). All
// threads of the block call it.
__device__ __forceinline__ bool tile_visible(int q0, int k0, int S, const int* valid,
                                             const int* seg, int seg_lo, int seg_hi) {
  bool any = false;
  const int last = min(q0 + kTile, S) - 1;
  for (int j = k0 + static_cast<int>(threadIdx.x); j < k0 + kTile; j += kThreads) {
    if (j <= last && j < S && valid[j] != 0 &&
        (seg == nullptr || (seg[j] >= seg_lo && seg[j] <= seg_hi))) {
      any = true;
    }
  }
  return __syncthreads_or(any) != 0;
}

// the range of segment ids of queries [q0, q0 + 64)
__device__ __forceinline__ void seg_range(const int* seg, int q0, int S, int* lo, int* hi,
                                          int* red) {
  int a = 0x7fffffff, b = -0x7fffffff - 1;
  if (seg != nullptr) {
    for (int i = q0 + static_cast<int>(threadIdx.x); i < min(q0 + kTile, S); i += kThreads) {
      a = min(a, seg[i]);
      b = max(b, seg[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = max(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = a;
    red[4 + threadIdx.x / 32] = b;
  }
  __syncthreads();
  *lo = min(min(red[0], red[1]), min(red[2], red[3]));
  *hi = max(max(red[4], red[5]), max(red[6], red[7]));
  __syncthreads();
}

// the weight of a visible pair from its product, the row's max and sum
__device__ __forceinline__ float weight(float s, float scale, float mx, float sum) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(s, scale), mx)), fmaxf(sum, kTiny));
}

template <int kD>
__global__ void __launch_bounds__(kThreads) train_attention_fwd_kernel(const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int red[8];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  // q, then two buffers each of k and v
  const uint32_t qt = smem_u32(smem), kt0 = qt + kTileBytes, vt0 = kt0 + 2 * kTileBytes;
  const int* valid = p.valid + static_cast<long long>(b) * S;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long long>(b) * S;
  int seg_lo, seg_hi;
  seg_range(seg, q0, S, &seg_lo, &seg_hi, red);
  load_tile<kD>(qt, p.q, b, q0, h, p.H, S);
  loads_done();
  const int rows[2] = {q0 + 16 * warp + l / 4, q0 + 16 * warp + l / 4 + 8};
  const int tiles = min((q0 + kTile - 1) / kTile + 1, (S + kTile - 1) / kTile);
  auto visible = [&](int t) {
    return tile_visible(q0, t * kTile, S, valid, seg, seg_lo, seg_hi);
  };
  auto load_k = [&](int t, int buf) {
    load_tile<kD>(kt0 + buf * kTileBytes, p.k, b, t * kTile, hk, p.Hkv, S);
  };
  auto load_kv = [&](int t, int buf) {
    load_k(t, buf);
    load_tile<kD>(vt0 + buf * kTileBytes, p.v, b, t * kTile, hk, p.Hkv, S);
  };

  // pass 1: each row's max and sum of exp(l - max), over its visible
  // logits: each thread keeps its own (max, sum) of a row, rescaled when a
  // tile raises its max, and the row's four threads combine theirs
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  over_tiles(tiles, visible, load_k, [&](int t, int buf) {
    float acc[8][4];
    rows_times_rows<kD>(acc, qt, kt0 + buf * kTileBytes, 16 * warp);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t * kTile + 8 * n + 2 * (l % 4) + (e & 1);
        acc[n][e] = sees(rows[e >> 1], j, S, valid, seg) ? __fmul_rn(acc[n][e], p.scale)
                                                         : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], acc[n][e]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m = fmaxf(mx[half], tmax[half]);
      if (m != -INFINITY && mx[half] != m) {
        sum[half] = __fmul_rn(sum[half], expf(__fsub_rn(mx[half], m)));
      }
      mx[half] = m;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (acc[n][e] != -INFINITY) {
          sum[e >> 1] = __fadd_rn(sum[e >> 1], expf(__fsub_rn(acc[n][e], mx[e >> 1])));
        }
      }
    }
  });
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float m = quad_max(mx[half]);
    sum[half] = quad_sum(m == -INFINITY ? 0.f : __fmul_rn(sum[half], expf(__fsub_rn(mx[half], m))));
    mx[half] = m;
  }

  // pass 2: P rounded to bf16, times v
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  over_tiles(tiles, visible, load_kv, [&](int t, int buf) {
    float acc[8][4];
    rows_times_rows<kD>(acc, qt, kt0 + buf * kTileBytes, 16 * warp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t * kTile + 8 * n + 2 * (l % 4) + (e & 1);
        acc[n][e] = sees(rows[e >> 1], j, S, valid, seg)
                        ? weight(acc[n][e], p.scale, mx[e >> 1], sum[e >> 1])
                        : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a_fragment(acc, kk, a);
      times_tile<kD>(o, a, vt0 + buf * kTileBytes, kk);
    }
  });

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = rows[half];
    if (i >= S) continue;
    __nv_bfloat16* dst = p.out + ((static_cast<long long>(b) * S + i) * p.H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * (l % 4)) =
          pack(o[n][2 * half], o[n][2 * half + 1]);
    }
    if (l % 4 == 0) {
      const long long at = (static_cast<long long>(b) * p.H + h) * S + i;
      p.mx[at] = mx[half];
      p.sum[at] = sum[half];
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) train_attention_dq_kernel(const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int red[8];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  // q, g, then two buffers each of k and v
  const uint32_t qt = smem_u32(smem), gt = qt + kTileBytes, kt0 = gt + kTileBytes,
                 vt0 = kt0 + 2 * kTileBytes;
  const int* valid = p.valid + static_cast<long long>(b) * S;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long long>(b) * S;
  int seg_lo, seg_hi;
  seg_range(seg, q0, S, &seg_lo, &seg_hi, red);
  load_tile<kD>(qt, p.q, b, q0, h, p.H, S);
  load_tile<kD>(gt, p.g, b, q0, h, p.H, S);
  loads_done();
  const int rows[2] = {q0 + 16 * warp + l / 4, q0 + 16 * warp + l / 4 + 8};
  float mx[2], sum[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long at = (static_cast<long long>(b) * p.H + h) * S + min(rows[half], S - 1);
    mx[half] = p.mx[at];
    sum[half] = p.sum[at];
  }
  const int tiles = min((q0 + kTile - 1) / kTile + 1, (S + kTile - 1) / kTile);

  auto visible = [&](int t) {
    return tile_visible(q0, t * kTile, S, valid, seg, seg_lo, seg_hi);
  };
  auto load_kv = [&](int t, int buf) {
    load_tile<kD>(kt0 + buf * kTileBytes, p.k, b, t * kTile, hk, p.Hkv, S);
    load_tile<kD>(vt0 + buf * kTileBytes, p.v, b, t * kTile, hk, p.Hkv, S);
  };
  // P and dP = bf16(g v^T) of key tile t (in buffer buf), P in acc and dP in dp
  auto weights = [&](int t, int buf, float (&acc)[8][4], float (&dp)[8][4]) {
    rows_times_rows<kD>(acc, qt, kt0 + buf * kTileBytes, 16 * warp);
    rows_times_rows<kD>(dp, gt, vt0 + buf * kTileBytes, 16 * warp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t * kTile + 8 * n + 2 * (l % 4) + (e & 1);
        acc[n][e] = sees(rows[e >> 1], j, S, valid, seg)
                        ? weight(acc[n][e], p.scale, mx[e >> 1], sum[e >> 1])
                        : 0.f;
        dp[n][e] = bf16_round(dp[n][e]);
      }
    }
  };

  // pass 1: D_i = sum_j P dP
  float dsum[2] = {0.f, 0.f};
  over_tiles(tiles, visible, load_kv, [&](int t, int buf) {
    float acc[8][4], dp[8][4];
    weights(t, buf, acc, dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dsum[e >> 1] = __fadd_rn(dsum[e >> 1], __fmul_rn(acc[n][e], dp[n][e]));
      }
    }
  });
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);

  // pass 2: dS = P (dP - D) scale, dq = dS k in three bf16 terms
  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  over_tiles(tiles, visible, load_kv, [&](int t, int buf) {
    float acc[8][4], dp[8][4];
    weights(t, buf, acc, dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = __fmul_rn(__fmul_rn(acc[n][e], __fsub_rn(dp[n][e], dsum[e >> 1])), p.scale);
      }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      split_off(acc, dp);  // dp: this term; acc: what is left
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a_fragment(dp, kk, a);
        times_tile<kD>(dq, a, kt0 + buf * kTileBytes, kk);
      }
    }
  });

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = rows[half];
    if (i >= S) continue;
    __nv_bfloat16* dst = p.out + ((static_cast<long long>(b) * S + i) * p.H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * (l % 4)) =
          pack(dq[n][2 * half], dq[n][2 * half + 1]);
    }
    if (l % 4 == 0) p.dsum[(static_cast<long long>(b) * p.H + h) * S + i] = dsum[half];
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) train_attention_dkv_kernel(const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int red[8];
  __shared__ float stats[2][3][kTile];  // a query tile's max, sum and D, in each buffer
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int S = p.S, group = p.H / p.Hkv;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  // k, v, then two buffers each of q and g
  const uint32_t kt_ = smem_u32(smem), vt = kt_ + kTileBytes, qt0 = vt + kTileBytes,
                 gt0 = qt0 + 2 * kTileBytes;
  const int* valid = p.valid + static_cast<long long>(b) * S;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long long>(b) * S;
  load_tile<kD>(kt_, p.k, b, k0, hk, p.Hkv, S);
  load_tile<kD>(vt, p.v, b, k0, hk, p.Hkv, S);
  loads_done();
  const int keys[2] = {k0 + 16 * warp + l / 4, k0 + 16 * warp + l / 4 + 8};
  // the query tiles from this key tile's on, for each query head of the group
  const int first = k0 / kTile, per_head = (S + kTile - 1) / kTile - first;
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  auto visible = [&](int i) {
    const int q0 = (first + i % per_head) * kTile;
    int seg_lo, seg_hi;
    seg_range(seg, q0, S, &seg_lo, &seg_hi, red);
    return tile_visible(q0, k0, S, valid, seg, seg_lo, seg_hi);
  };
  auto load_qg = [&](int i, int buf) {
    const int q0 = (first + i % per_head) * kTile, h = hk * group + i / per_head;
    load_tile<kD>(qt0 + buf * kTileBytes, p.q, b, q0, h, p.H, S);
    load_tile<kD>(gt0 + buf * kTileBytes, p.g, b, q0, h, p.H, S);
    if (threadIdx.x < kTile) {
      const int q = min(q0 + static_cast<int>(threadIdx.x), S - 1);
      const long long at = (static_cast<long long>(b) * p.H + h) * S + q;
      stats[buf][0][threadIdx.x] = p.mx[at];
      stats[buf][1][threadIdx.x] = p.sum[at];
      stats[buf][2][threadIdx.x] = p.dsum[at];
    }
  };

  over_tiles(group * per_head, visible, load_qg, [&](int i, int buf) {
    const int q0 = (first + i % per_head) * kTile;
    const uint32_t qt = qt0 + buf * kTileBytes, gt = gt0 + buf * kTileBytes;
    const float(&st)[3][kTile] = stats[buf];
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 32) {
      float acc[4][4], dp[4][4];
      rows_times_rows32<kD>(acc, kt_, qt, 16 * warp, c0);  // S^T: keys x queries
      rows_times_rows32<kD>(dp, vt, gt, 16 * warp, c0);    // dP^T
      float pb[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * n + 2 * (l % 4) + (e & 1);
          const float pw = sees(q0 + c, keys[e >> 1], S, valid, seg)
                               ? weight(acc[n][e], p.scale, st[0][c], st[1][c])
                               : 0.f;
          pb[n][e] = pw;
          acc[n][e] =
              __fmul_rn(__fmul_rn(pw, __fsub_rn(bf16_round(dp[n][e]), st[2][c])), p.scale);
        }
      }
      // dv += bf16(P^T) g over these 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        a_fragment(pb, kk, a);
        times_tile<kD>(dv, a, gt, c0 / 16 + kk);
      }
      // dk += dS^T q in three bf16 terms
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        split_off(acc, pb);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          a_fragment(pb, kk, a);
          times_tile<kD>(dk, a, qt, c0 / 16 + kk);
        }
      }
    }
  });

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = keys[half];
    if (j >= S) continue;
    const long long row = (static_cast<long long>(b) * S + j) * p.Hkv + hk;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(p.dk + row * kD + 8 * n + 2 * (l % 4)) =
          pack(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + row * kD + 8 * n + 2 * (l % 4)) =
          pack(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// the launch of `kernel`, its shared memory opted in at the first call on
// each device (`opted`: that kernel's flags), so that a launch being
// captured into a CUDA graph calls no attribute function
template <typename Kernel>
int launch(Kernel kernel, bool* opted, int tiles, int heads, int B, int smem, const Args& p,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  kernel<<<dim3(tiles, heads, B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kernel 0 the forward, 1 dq, 2 dk and dv, at head_dim kD
template <int kD>
int launch_width(int which, int B, const Args& p, cudaStream_t st) {
  static bool opted[3][64] = {};
  const int tiles = (p.S + kTile - 1) / kTile;
  if (which == 0) {
    return launch(train_attention_fwd_kernel<kD>, opted[0], tiles, p.H, B, 5 * kTileBytes, p, st);
  }
  if (which == 1) {
    return launch(train_attention_dq_kernel<kD>, opted[1], tiles, p.H, B, 6 * kTileBytes, p, st);
  }
  return launch(train_attention_dkv_kernel<kD>, opted[2], tiles, p.Hkv, B, 6 * kTileBytes, p, st);
}

int launch_any(int which, int B, int D, const Args& p, cudaStream_t st) {
  switch (D) {
    case 128: return launch_width<128>(which, B, p, st);
    case 64: return launch_width<64>(which, B, p, st);
    case 32: return launch_width<32>(which, B, p, st);
    case 16: return launch_width<16>(which, B, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad(int B, int S, int H, int Hkv, int D, const void* q, const void* k, const void* v,
         const void* valid) {
  return B < 0 || S < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
         (D != 16 && D != 32 && D != 64 && D != 128) || q == nullptr || k == nullptr ||
         v == nullptr || valid == nullptr || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0;
}

}  // namespace

// q [B, S, H, D], k, v [B, S, Hkv, D] bf16 contiguous (D 16, 32, 64 or 128),
// valid [B, S] and seg [B, S] (or null) int32 -> out [B, S, H, D] bf16 and
// each row's max and sum [B, H, S] f32.
extern "C" int cgpt_train_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* valid, const void* seg, void* out, void* mx,
                                        void* sum, int B, int S, int H, int Hkv, int D,
                                        float scale, void* stream) {
  if (bad(B, S, H, Hkv, D, q, k, v, valid) || out == nullptr || mx == nullptr ||
      sum == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.mx = static_cast<float*>(mx);
  p.sum = static_cast<float*>(sum);
  p.valid = static_cast<const int*>(valid);
  p.seg = static_cast<const int*>(seg);
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale = scale;
  return launch_any(0, B, D, p, static_cast<cudaStream_t>(stream));
}

// The backward of cgpt_train_attention_fwd from its saved statistics and the
// output's gradient g [B, S, H, D] bf16: part 0 writes dq [B, S, H, D] and
// dsum [B, H, S] f32 (D_i), part 1 reads dsum and writes dk, dv [B, S, Hkv,
// D] bf16: two launches.
extern "C" int cgpt_train_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* valid, const void* seg, const void* g,
                                        const void* mx, const void* sum, void* dsum, void* dq,
                                        void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                                        float scale, int part, void* stream) {
  if (bad(B, S, H, Hkv, D, q, k, v, valid) || g == nullptr || mx == nullptr || sum == nullptr ||
      dsum == nullptr || dq == nullptr || dk == nullptr || dv == nullptr ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 || reinterpret_cast<uintptr_t>(dq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dk) % 16 != 0 || reinterpret_cast<uintptr_t>(dv) % 16 != 0 ||
      part < 0 || part > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.mx = const_cast<float*>(static_cast<const float*>(mx));
  p.sum = const_cast<float*>(static_cast<const float*>(sum));
  p.dsum = static_cast<float*>(dsum);
  p.valid = static_cast<const int*>(valid);
  p.seg = static_cast<const int*>(seg);
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale = scale;
  return launch_any(1 + part, B, D, p, static_cast<cudaStream_t>(stream));
}
