// The decode step's attention over the decoder's int8 KV cache on Hopper
// (sm_90a), with the step's cache write in the same launch.
//
// Replaces, for one query row, the sequence the JAX package runs inside one
// XLA program (certifiedgpt_tpu/models/llama.py:243-270): quantize_rows of
// the step's k and v (certifiedgpt_tpu/ops/quantization.py:52-65), four
// dynamic_update_slice writes at the cache offset, then
// multi_head_attention_kv8 (certifiedgpt_tpu/ops/attention.py:76) over the
// whole cache. The port's plain version is
// ops/attention.py::_decode_attention_kv8_plain.
//
// An item is one (batch row, kv head) with its g query heads (g = H / Hkv,
// a template parameter: 1, 2, 4 or 8); one block computes it, so no other
// block reads or writes its cache rows. What it computes, in the plain
// version's order:
//   the cache write: xs = max(amax_d |x|, 1e-8) / 127 (an IEEE division),
//     codes clip(rint(x / xs), -127, 127) (an IEEE division, half to even),
//     for the step's k and v rows, written to slot `offset` of the cache:
//     bit for bit quantize_rows;
//   logits[h, t] = (sum_d q[h, d] * kq8[t, d]) * ks[t] * scale  (f32 sums)
//   where(mask, logits, f32_min), minus the row max, exp, where(mask, w, 0),
//   divided by max(sum, f32_tiny)    (a fully masked row gives zeros)
//   p[h, t] = bf16(w * vs[t]) for bf16 q (kept in f32 for f32 q)
//   out[h, d] = sum_t p[h, t] * vq8[t, d]                      (f32 sums)
// The products are exact in f32, so only the order of the f32 sums and the
// exponential's last bits differ from the plain version.
//
// Bound on the H100: bytes. At the certify decode (q [96, 1, 32, 128] over
// a [96, 106, 32, 128] int8 cache) the cache's 83 MB take 0.025 ms at
// 3.35 TB/s; the two contractions are 0.1 GFLOP. The design keeps the
// memory busy and the blocks' own work off its path:
//
// - Blocks walk items: block (hk, y) takes kv head hk of batch rows y, y +
//   gridDim.y, ..., gridDim.y chosen so that the grid fills the card once.
//   The positions are cut into tiles of up to 128; each item's K tiles then
//   its V tiles stream through a two-stage ring in shared memory, each tile
//   one tensor copy of the TMA ([tile, Dh] bytes at the cache's strides,
//   rows past T zeros) completing on the stage's mbarrier. A stage is
//   refilled with the next tile, of this item or the next, as soon as it is
//   read: the item's V tile lands under its logits, the next item's K tile
//   under its output. With an item's first tile, cp.async brings its q rows,
//   the step's k and v rows and its K and V row scales (two item slots each);
//   its mask bytes are loaded into registers an item ahead.
// - With no step rows (k and v null, offset T) it writes nothing and is
//   multi_head_attention_kv8 of a lone query row (ops/attention.py routes
//   such rows here): the cache comes out bit for bit as it went in.
// - The slot can come from the device (`offset_dev`, an int32 that the
//   decode loop advances on the card), so one captured launch serves every
//   step of a CUDA graph's replays: each thread reads it once, before the
//   tile plan and the copies that depend on it, and a slot outside
//   [0, T) traps instead of writing outside the cache.
// - The cache write rides along: warps 0 and 1 quantize the step's k and v
//   rows (from shared memory) and write codes and scales to the cache in
//   device memory; the staged tile's copy of slot `offset`, read before or
//   after that write, is overwritten with the codes once it has landed.
// - Logits: a group of Dh / 16 lanes (8 at head_dim 128) takes one position,
//   a lane 16 bytes of the key row; each warp takes four positions at a
//   time, the warps interleaved over the tile. q sits in registers (16
//   values a lane for each of the g heads): one read of a key row serves
//   every query head of the group. The group's partial dots meet in a xor
//   butterfly. The row of logits (g x T floats) stays in shared memory.
// - Softmax: the plain version's two passes over the row, the block's max
//   and sum reduced across warps in a fixed order.
// - Output: the same position split over the V tiles; each lane keeps 16
//   f32 partial outputs for each head in registers, summed over the warp's
//   position groups by a xor butterfly and then across warps in warp order
//   through shared memory: deterministic, no atomics.
// - int8 -> f32 without I2F: a byte permute builds the f32 2^23 + (byte ^
//   0x80), one f32 subtraction of 2^23 + 128 leaves the signed value, exact;
//   no integer division either (its SASS holds I2F).
// - Blocks of 4 warps (6 an SM at 106 positions) when one tile holds the
//   cache and the items are many; 8 (more warps on each item) otherwise.
// On one H100 80GB HBM3 at 700 W, scripts/bench_torch_int8_ops.py measured
// 0.050 ms alone at the certify decode, its copies alone 0.039.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kMaxWarps = 8;
constexpr int kTileShift = 7;
constexpr int kTile = 1 << kTileShift;  // the most positions a stage of the ring holds
constexpr int kStages = 2;   // the ring's stages (at most 3: see the scale slots)
constexpr int kMaskRegs = 2;  // mask bytes a thread loads an item ahead
// blocks of 8 warps an SM the instances for 1 and 2 query heads a kv head
// must fit by their registers (at most 85 a thread; blocks of 4 warps then
// fit 6 an SM, as their shared memory does at 106 positions)
constexpr int kMinBlocks = 3;
// the launcher's code for a cache whose scales and logits do not fit in
// shared memory (at head_dim 128: past ~9000 positions at g = 1, ~3300 at
// g = 8)
constexpr int kCacheTooLong = -1;

template <typename E>
struct DecodeArgs {
  const E* q;  // [B, 1, H, Dh], dim contiguous, rows 16-byte aligned
  long long q_b, q_h;
  const E* kn;  // the step's k and v [B, 1, Hkv, Dh] (shared strides), dim contiguous
  const E* vn;
  long long n_b, n_h;
  int8_t* k;  // the int8 cache [B, T, Hkv, Dh] (k and v share the strides)
  int8_t* v;
  long long c_b, c_t, c_h;
  float* ks;  // the row scales [B, T, Hkv] (ks and vs share the strides)
  float* vs;
  long long s_b, s_t, s_h;
  const uint8_t* mask;  // bool [B, T] by strides (0 for broadcast), or null
  long long m_b, m_t;
  E* out;  // [B, 1, H, Dh] contiguous
  int B, H, Hkv, T, Dh, offset;
  const int* offset_dev;  // the slot on the device (read in place of `offset`), or null
  float scale;
};

// Where each part lives in the block's shared memory, in bytes: the ring of
// int8 tiles, the warps' partial outputs, the item's q rows and the step's k
// and v rows (in q's dtype, `esize` bytes a value) and its K and V row
// scales (two item slots each), the rows of logits (g rows of `ts` floats),
// the mask bytes, the step's quantized k and v rows, the reductions' slots
// and the ring's mbarriers.
struct Layout {
  int tile, ring, partials, q, x, ks, vs, lg, ts, mask, newrow, red, bars, bytes;
};

__host__ __device__ inline Layout layout(int T, int Dh, int G, int warps, int esize) {
  Layout l;
  l.tile = (T + 15) / 16 * 16 < kTile ? (T + 15) / 16 * 16 : kTile;
  l.ts = (T + 3) / 4 * 4;
  l.ring = 0;
  int at = kStages * l.tile * Dh;
  l.partials = at;
  at += warps * G * Dh * 4;
  l.q = at;
  at += 2 * G * Dh * esize;
  l.x = at;
  at += 2 * 2 * Dh * esize;
  l.ks = at;
  at += 2 * 4 * l.ts;
  l.vs = at;
  at += 2 * 4 * l.ts;
  l.lg = at;
  at += 4 * G * l.ts;
  l.mask = at;
  at += (T + 15) / 16 * 16;
  l.newrow = at;
  at += 2 * Dh;
  l.red = at;
  at += 2 * warps * G * 4;
  l.bars = (at + 7) / 8 * 8;  // an mbarrier a stage of the ring
  l.bytes = l.bars + 8 * kStages;
  return l;
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// a tile of the cache, box [1, tile, 1, Dh] at (b, t0, hk), by the tensor
// memory accelerator; arms the stage's barrier for the box's bytes (rows past
// T arrive as zeros and count)
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int hk, int t0,
                                          int b, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(hk), "r"(t0), "r"(b), "r"(bar)
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

// this thread's accesses of the ring come before the tensor copies that
// refill it (they write through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group but the newest `kStages - 1` has landed (this
// thread's copies): an item's scales, q, k and v rows, committed with its
// first tile
__device__ __forceinline__ void wait_item_rows() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// 16 signed bytes -> 16 exact f32, without I2F: the byte offset to unsigned
// is the low mantissa byte of the f32 2^23 + u, and 2^23 + 128 is subtracted
__device__ __forceinline__ void bytes_f32(uint4 w, float (&f)[16]) {
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kOffset = 8388736.f;      // 2^23 + 128
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[4 * j + 0] = __fsub_rn(__uint_as_float(__byte_perm(u[j], kMagic, 0x7440)), kOffset);
    f[4 * j + 1] = __fsub_rn(__uint_as_float(__byte_perm(u[j], kMagic, 0x7441)), kOffset);
    f[4 * j + 2] = __fsub_rn(__uint_as_float(__byte_perm(u[j], kMagic, 0x7442)), kOffset);
    f[4 * j + 3] = __fsub_rn(__uint_as_float(__byte_perm(u[j], kMagic, 0x7443)), kOffset);
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }

// p in q's dtype, back in f32: rounded to bf16 for bf16 q, kept for f32
__device__ __forceinline__ float in_dtype(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float in_dtype(float v, const float*) { return v; }

// 16 values of a q row (16-byte aligned) -> f32
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 w = reinterpret_cast<const uint4*>(src)[j];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[8 * j + 2 * i] = __uint_as_float(ws[i] << 16);
      f[8 * j + 2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
    }
  }
}
__device__ __forceinline__ void load16(const float* src, float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 w = reinterpret_cast<const float4*>(src)[j];
    f[4 * j] = w.x, f[4 * j + 1] = w.y, f[4 * j + 2] = w.z, f[4 * j + 3] = w.w;
  }
}

// The next chunk a block stages: chunk c of its k-th item (batch row b, the
// block's kv head); c < n: K tile c, n <= c < 2n: V tile c - n; `stage`: its
// stage of the ring.
struct Cursor {
  int b, c, k, stage;
};

// Starts the copy of the cursor's chunk into its stage of the ring (one
// tensor copy, on the stage's mbarrier), then moves the cursor on; with an
// item's first chunk, every thread also copies the item's K and V row scales
// (into its slot, k & 1), its q rows and the step's k and v rows by
// cp.async, committed as one group (an empty group for any other chunk keeps
// the count). Past the block's last item nothing is copied. The staged
// tile's slot `offset` holds whatever the cache held when the copy read it:
// the consumer overwrites it with the block's quantized row; its scales are
// never copied (the quantizing warps write them).
template <typename E, int G>
__device__ __forceinline__ void stage_next(const DecodeArgs<E>& a, const CUtensorMap* tk,
                                           const CUtensorMap* tv, const Layout& L,
                                           unsigned char* smem, int hk, int n, int offset,
                                           Cursor& cur) {
  if (cur.b < a.B) {
    const bool is_v = cur.c >= n;
    const int t0 = (is_v ? cur.c - n : cur.c) << kTileShift;  // n == 1: tile 0
    if (cur.c == 0) {
      const long long sb = cur.b * a.s_b + hk * a.s_h;
      float* ks = reinterpret_cast<float*>(smem + L.ks) + (cur.k & 1) * L.ts;
      float* vs = reinterpret_cast<float*>(smem + L.vs) + (cur.k & 1) * L.ts;
      for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
        if (t == offset) continue;
        cp_async4(smem_u32(ks + t), a.ks + sb + t * a.s_t);
        cp_async4(smem_u32(vs + t), a.vs + sb + t * a.s_t);
      }
      // the item's G q rows, then the step's k and v rows, 16 bytes a copy
      const int row_pieces = a.Dh * static_cast<int>(sizeof(E)) / 16;
      constexpr int g = G;
      unsigned char* qd = smem + L.q + (cur.k & 1) * g * row_pieces * 16;
      unsigned char* xd = smem + L.x + (cur.k & 1) * 2 * row_pieces * 16;
      const int rows = a.kn != nullptr ? g + 2 : g;  // no new rows: q alone
      for (int i = threadIdx.x; i < rows * row_pieces; i += blockDim.x) {
        int row = 0, r = i;  // row: q rows 0..g-1, then k and v (no division: no I2F)
        while (r >= row_pieces) {
          r -= row_pieces;
          ++row;
        }
        const E* src = row < g ? a.q + cur.b * a.q_b + (hk * g + row) * a.q_h
                               : (row == g ? a.kn : a.vn) + cur.b * a.n_b + hk * a.n_h;
        unsigned char* dst =
            row < g ? qd + row * row_pieces * 16 : xd + (row - g) * row_pieces * 16;
        cp_async16(smem_u32(dst + 16 * r), reinterpret_cast<const unsigned char*>(src) + 16 * r);
      }
    }
    if (threadIdx.x == 0) {
      load_tile(smem_u32(smem + L.ring + cur.stage * L.tile * a.Dh), is_v ? tv : tk, hk, t0,
                cur.b, L.tile * a.Dh, smem_u32(smem + L.bars) + 8 * cur.stage);
    }
  }
  commit_group();
  cur.stage = cur.stage + 1 == kStages ? 0 : cur.stage + 1;
  if (++cur.c == 2 * n) {
    cur.c = 0;
    cur.b += gridDim.y;
    ++cur.k;
  }
}

// The quantized row (after the barrier of the item's start) over the staged
// tile's slot `offset`, once the tile has landed (this thread waited on it).
__device__ __forceinline__ void patch_slot(unsigned char* tile, const unsigned char* row,
                                           int offset, int Dh) {
  unsigned char* dst = tile + (offset & (kTile - 1)) * Dh;
  for (int i = threadIdx.x; i < Dh / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(row)[i];
  }
}

// E: q's, the step's k/v and the output's dtype (bf16 or f32); G: query
// heads a kv head. Block (hk, y) takes the items (batch rows) y, y +
// gridDim.y, ... of kv head hk, one after another, the ring always holding
// the next chunks: the current item's V tiles and the next item's K tiles
// stream in while it computes.
template <typename E, int G>
__global__ void __launch_bounds__(kMaxWarps * 32, G <= 2 ? kMinBlocks : 1)
    kv8_decode_kernel(const DecodeArgs<E> a, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x;
  const int T = a.T, Dh = a.Dh, pieces = Dh / 16;
  int shift = 0;  // lanes a position, 1 << shift: the power of two at or above `pieces`
  while ((1 << shift) < pieces) ++shift;
  const int gl = 1 << shift, per_step = 32 >> shift;  // per_step: positions a warp takes at a time
  const int grp = lane >> shift, piece = lane & (gl - 1);
  const bool on = piece < pieces;
  const Layout L = layout(T, Dh, G, warps, sizeof(E));
  // the slot of the step's row: read once, before anything that uses it
  const int offset = a.offset_dev != nullptr ? *a.offset_dev : a.offset;
  if (a.kn != nullptr && (offset < 0 || offset >= T)) __trap();
  // tiles (chunks: n K tiles, then n V tiles); no integer division: the
  // SASS holds no I2F
  const int n = L.tile < kTile ? 1 : (T + kTile - 1) >> kTileShift;
  const int offset_tile = L.tile < kTile ? 0 : offset >> kTileShift;
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  unsigned char* smask = smem + L.mask;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* partials = reinterpret_cast<float*>(smem + L.partials);

  const uint32_t bars = smem_u32(smem + L.bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbarrier_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Cursor cur{static_cast<int>(blockIdx.y), 0, 0, 0};
  for (int s = 0; s < kStages; ++s) stage_next<E, G>(a, &tk, &tv, L, smem, hk, n, offset, cur);
  int stage = 0;        // the stage of the next chunk to compute on
  uint32_t phases = 0;  // each stage's mbarrier parity, a bit a stage

  // the mask bytes of positions threadIdx.x + i blockDim.x, i < kMaskRegs,
  // are loaded an item ahead into registers (the rest when the item starts)
  uint8_t mask_next[kMaskRegs];
  const auto load_mask = [&](int bb, uint8_t (&m)[kMaskRegs]) {
#pragma unroll
    for (int i = 0; i < kMaskRegs; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      m[i] = t < T && (a.mask == nullptr || a.mask[bb * a.m_b + t * a.m_t] != 0);
    }
  };
  load_mask(blockIdx.y, mask_next);

  int k = 0;
  for (int b = blockIdx.y; b < a.B; b += gridDim.y, ++k) {
    float* sks = reinterpret_cast<float*>(smem + L.ks) + (k & 1) * L.ts;
    float* svs = reinterpret_cast<float*>(smem + L.vs) + (k & 1) * L.ts;
#pragma unroll
    for (int i = 0; i < kMaskRegs; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      if (t < T) smask[t] = mask_next[i];
    }
    for (int t = threadIdx.x + kMaskRegs * blockDim.x; t < T; t += blockDim.x) {
      smask[t] = a.mask == nullptr || a.mask[b * a.m_b + t * a.m_t] != 0;
    }
    if (b + gridDim.y < a.B) load_mask(b + gridDim.y, mask_next);
    wait_item_rows();
    __syncthreads();  // the item's q, k and v rows, its scales and first K tile are in place
    const E* qs = reinterpret_cast<const E*>(smem + L.q) + (k & 1) * G * Dh;
    const E* xs_rows = reinterpret_cast<const E*>(smem + L.x) + (k & 1) * 2 * Dh;
    float qr[G][16];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (on) {
        load16(qs + h * Dh + 16 * piece, qr[h]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) qr[h][i] = 0.f;
      }
    }

    // the cache write: warp 0 quantizes the step's k row, warp 1 its v row
    if (warp < 2 && a.kn != nullptr) {
      const bool is_v = warp == 1;
      const E* x = xs_rows + is_v * Dh;
      float xv[kMaxHeadDim / 32];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / 32; ++i) {
        const int d = lane + 32 * i;
        xv[i] = d < Dh ? to_f32(x[d]) : 0.f;
        amax = fmaxf(amax, fabsf(xv[i]));
      }
      const float xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.f);
      int8_t* crow = (is_v ? a.v : a.k) + b * a.c_b + offset * a.c_t + hk * a.c_h;
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          const int8_t code = static_cast<int8_t>(
              static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(xv[i], xs)), -127.f), 127.f)));
          crow[d] = code;
          smem[L.newrow + is_v * Dh + d] = static_cast<unsigned char>(code);
        }
      }
      if (lane == 0) {
        (is_v ? a.vs : a.ks)[b * a.s_b + offset * a.s_t + hk * a.s_h] = xs;
        (is_v ? svs : sks)[offset] = xs;
      }
      __syncwarp();  // warp 0's row is in place for the lanes that patch the K tile
    }

    // logits: q K^T a K tile at a time, a lane group a position
    float mx[G];
#pragma unroll
    for (int h = 0; h < G; ++h) mx[h] = -FLT_MAX;
    for (int c = 0; c < n; ++c) {
      mbarrier_wait(bars + 8 * stage, (phases >> stage) & 1);
      __syncwarp();  // the lanes converged before the warp-aligned barrier
      if (a.kn != nullptr && c == offset_tile) {
        patch_slot(smem + L.ring + stage * L.tile * Dh, smem + L.newrow, offset, Dh);
      }
      __syncthreads();  // the tile, the scales, the mask and the quantized rows are in place
      const unsigned char* tile = smem + L.ring + stage * L.tile * Dh;
      const int t0 = c << kTileShift, rows = T - t0 < L.tile ? T - t0 : L.tile;
      for (int r0 = warp * per_step; r0 < rows; r0 += warps * per_step) {
        const int r = r0 + grp;
        float part[G];
#pragma unroll
        for (int h = 0; h < G; ++h) part[h] = 0.f;
        if (on && r < rows) {
          float f[16];
          bytes_f32(*reinterpret_cast<const uint4*>(tile + r * Dh + 16 * piece), f);
#pragma unroll
          for (int h = 0; h < G; ++h) {
#pragma unroll
            for (int i = 0; i < 16; ++i) part[h] = fmaf(qr[h][i], f[i], part[h]);
          }
        }
        for (int o = 1; o < gl; o <<= 1) {
#pragma unroll
          for (int h = 0; h < G; ++h) {
            part[h] = __fadd_rn(part[h], __shfl_xor_sync(0xffffffffu, part[h], o));
          }
        }
        if (piece == 0 && r < rows) {
          const int t = t0 + r;
          const bool kept = smask[t] != 0;
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const float l = kept ? __fmul_rn(__fmul_rn(part[h], sks[t]), a.scale) : -FLT_MAX;
            lg[h * L.ts + t] = l;
            mx[h] = fmaxf(mx[h], l);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();  // the stage is read
      stage_next<E, G>(a, &tk, &tv, L, smem, hk, n, offset, cur);
      phases ^= 1u << stage;
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }
    // the row max of each head across the block (warp order)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      mx[h] = warp_max(mx[h]);
      if (lane == 0) red[warp * G + h] = mx[h];
    }
    __syncthreads();
    {
      float m[G], sum[G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        m[h] = -FLT_MAX;
        for (int w = 0; w < warps; ++w) m[h] = fmaxf(m[h], red[w * G + h]);
        sum[h] = 0.f;
      }
      // the masked softmax's numerators and their sum
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const bool kept = smask[t] != 0;
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float w = kept ? expf(__fsub_rn(lg[h * L.ts + t], m[h])) : 0.f;
          lg[h * L.ts + t] = w;
          sum[h] = __fadd_rn(sum[h], w);
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        sum[h] = warp_sum(sum[h]);
        if (lane == 0) red[(warps + warp) * G + h] = sum[h];
      }
      __syncthreads();
      float den[G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        den[h] = 0.f;
        for (int w = 0; w < warps; ++w) den[h] = __fadd_rn(den[h], red[(warps + w) * G + h]);
        den[h] = fmaxf(den[h], FLT_MIN);
      }
      // p = (w / den) * vs in q's dtype (the same positions this thread summed)
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const float vsv = svs[t];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          lg[h * L.ts + t] =
              in_dtype(__fmul_rn(__fdiv_rn(lg[h * L.ts + t], den[h]), vsv), a.q);
        }
      }
    }

    // out: P V a V tile at a time, the same lane groups; 16 dims a lane
    float acc[G][16];
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
    for (int c = 0; c < n; ++c) {
      mbarrier_wait(bars + 8 * stage, (phases >> stage) & 1);
      __syncwarp();  // the lanes converged before the warp-aligned barrier
      if (a.kn != nullptr && c == offset_tile) {
        patch_slot(smem + L.ring + stage * L.tile * Dh, smem + L.newrow + Dh, offset, Dh);
      }
      __syncthreads();  // the tile and the weights are in place
      const unsigned char* tile = smem + L.ring + stage * L.tile * Dh;
      const int t0 = c << kTileShift, rows = T - t0 < L.tile ? T - t0 : L.tile;
      for (int r0 = warp * per_step; r0 < rows; r0 += warps * per_step) {
        const int r = r0 + grp;
        if (on && r < rows) {
          float f[16];
          bytes_f32(*reinterpret_cast<const uint4*>(tile + r * Dh + 16 * piece), f);
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const float p = lg[h * L.ts + t0 + r];
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[h][i] = fmaf(p, f[i], acc[h][i]);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();  // the stage is read
      stage_next<E, G>(a, &tk, &tv, L, smem, hk, n, offset, cur);
      phases ^= 1u << stage;
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }

    // the warp's position groups summed (xor butterfly), then the warps in
    // order through shared memory
    for (int o = gl; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          acc[h][i] = __fadd_rn(acc[h][i], __shfl_xor_sync(0xffffffffu, acc[h][i], o));
        }
    }
    if (grp == 0 && on) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float4* dst = reinterpret_cast<float4*>(partials + (warp * G + h) * Dh + 16 * piece);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[j] = make_float4(acc[h][4 * j], acc[h][4 * j + 1], acc[h][4 * j + 2],
                               acc[h][4 * j + 3]);
        }
      }
    }
    __syncthreads();
    E* orow = a.out + (static_cast<long long>(b) * a.H + hk * G) * Dh;
    for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s = __fadd_rn(s, partials[w * G * Dh + i]);
      store(orow + i, s);
    }
  }
}

template <typename E>
const void* instance(int g) {
  switch (g) {
    case 1: return reinterpret_cast<const void*>(kv8_decode_kernel<E, 1>);
    case 2: return reinterpret_cast<const void*>(kv8_decode_kernel<E, 2>);
    case 4: return reinterpret_cast<const void*>(kv8_decode_kernel<E, 4>);
    case 8: return reinterpret_cast<const void*>(kv8_decode_kernel<E, 8>);
    default: return nullptr;
  }
}

template <typename E>
void launch(const DecodeArgs<E>& a, const CUtensorMap& tk, const CUtensorMap& tv, int g,
            int rows_blocks, int warps, long long smem, cudaStream_t st) {
  const dim3 grid(a.Hkv, rows_blocks), block(warps * 32);
  const size_t bytes = static_cast<size_t>(smem);
  switch (g) {
    case 1: kv8_decode_kernel<E, 1><<<grid, block, bytes, st>>>(a, tk, tv); break;
    case 2: kv8_decode_kernel<E, 2><<<grid, block, bytes, st>>>(a, tk, tv); break;
    case 4: kv8_decode_kernel<E, 4><<<grid, block, bytes, st>>>(a, tk, tv); break;
    default: kv8_decode_kernel<E, 8><<<grid, block, bytes, st>>>(a, tk, tv); break;
  }
}

// The tensor map of an int8 cache [B, T, Hkv, Dh] by strides whose box is
// one kv head's `tile` positions [1, tile, 1, Dh]; the encoder,
// cuTensorMapEncodeTiled, is looked up once through the runtime (no link
// against libcuda).
int encode_cache_map(CUtensorMap* map, void* base, int B, int T, int Hkv, int Dh, long long c_b,
                     long long c_t, long long c_h, int tile) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c_h), static_cast<cuuint64_t>(c_t),
                                 static_cast<cuuint64_t>(c_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Dh), 1, static_cast<cuuint32_t>(tile), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box,
                              steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, 1, H, Dh] (bf16, f32 with q_f32) by its (b, h) strides, dim
// contiguous, 16-byte aligned rows; the step's k and v [B, 1, Hkv, Dh] in
// q's dtype by shared (b, h) strides, dim contiguous, 16-byte aligned rows;
// the int8 cache k, v
// [B, T, Hkv, Dh] by shared strides (16-byte aligned rows), written at slot
// `offset`; the f32 scales ks, vs [B, T, Hkv] by shared strides, written
// at `offset`; mask bool [B, T] by strides or null; out [B, 1, H, Dh] in q's
// dtype, contiguous. H / Hkv in {1, 2, 4, 8}, Dh a multiple of 16 up to 256,
// 0 <= offset < T, B at most 65535; kn and vn null with offset T: nothing is
// written (the cache is only read). offset_dev, when not null (with kn and
// vn), points at the slot as an int32 on the device, which the kernel reads
// in place of `offset` (then unchecked here) and traps on outside [0, T). Returns kCacheTooLong when the block's shared memory exceeds
// the card's. The grid is the kv heads times as many blocks of batch rows as
// fill the card once (its SMs times the blocks an SM holds at this width and
// shared memory), at most B: each block then walks its batch rows.
extern "C" int cgpt_attention_kv8_decode(
    const void* q, long long q_b, long long q_h, const void* kn, const void* vn, long long n_b,
    long long n_h, void* k, void* v, long long c_b, long long c_t, long long c_h, void* ks,
    void* vs, long long s_b, long long s_t, long long s_h, const void* mask, long long m_b,
    long long m_t, void* out, int B, int H, int Hkv, int T, int Dh, int offset,
    const void* offset_dev, float scale, int q_f32, void* stream) {
  const int g = Hkv > 0 ? H / Hkv : 0;
  if (offset_dev != nullptr) offset = 0;  // the kernel reads the slot from the device
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || instance<float>(g) == nullptr ||
      Dh <= 0 || Dh % 16 != 0 || Dh > kMaxHeadDim || offset < 0 ||
      (kn == nullptr) != (vn == nullptr) || offset > T || (kn != nullptr && offset == T) ||
      (offset_dev != nullptr && kn == nullptr) ||
      reinterpret_cast<uintptr_t>(offset_dev) % 4 != 0 ||
      c_t % 16 != 0 || c_h % 16 != 0 || c_b % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || q_b % (q_f32 ? 4 : 8) != 0 ||
      q_h % (q_f32 ? 4 : 8) != 0 || reinterpret_cast<uintptr_t>(kn) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vn) % 16 != 0 || n_b % (q_f32 ? 4 : 8) != 0 ||
      n_h % (q_f32 ? 4 : 8) != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a device's shared-memory limit and SM count, read and the limit granted
  // to every instance at its first call
  static int most_of[64] = {}, sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (most_of[dev] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int groups[] = {1, 2, 4, 8};
    for (const int gi : groups) {
      const void* fns[] = {instance<__nv_bfloat16>(gi), instance<float>(gi)};
      for (const void* fn : fns) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    most_of[dev] = most;
  }
  // 4 warps a block when one tile holds the cache and the (batch row, kv
  // head) items are many (more blocks an SM, each walking its rows); 8 for
  // few items or longer caches (more warps on each item)
  const int warps =
      T <= kTile && static_cast<long long>(B) * Hkv >= 4LL * sms_of[dev] ? 4 : kMaxWarps;
  const long long smem = layout(T, Dh, g, warps, q_f32 ? 4 : 2).bytes;
  if (smem > most_of[dev]) return kCacheTooLong;
  // blocks an SM holds at this width and shared memory (a host query: no
  // work on the stream, so a CUDA graph may capture the launch)
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, q_f32 ? instance<float>(g) : instance<__nv_bfloat16>(g), warps * 32,
      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kCacheTooLong;
  long long rows_blocks = static_cast<long long>(sms_of[dev]) * per_sm / Hkv;
  rows_blocks = rows_blocks < 1 ? 1 : (rows_blocks > B ? B : rows_blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tile = layout(T, Dh, g, warps, q_f32 ? 4 : 2).tile;
  CUtensorMap tk, tv;
  int code = encode_cache_map(&tk, k, B, T, Hkv, Dh, c_b, c_t, c_h, tile);
  if (code != 0) return code;
  code = encode_cache_map(&tv, v, B, T, Hkv, Dh, c_b, c_t, c_h, tile);
  if (code != 0) return code;
  const auto k8 = static_cast<int8_t*>(k), v8 = static_cast<int8_t*>(v);
  const auto ksf = static_cast<float*>(ks), vsf = static_cast<float*>(vs);
  const auto m8 = static_cast<const uint8_t*>(mask);
  const auto od = static_cast<const int*>(offset_dev);
  if (q_f32) {
    const DecodeArgs<float> a{static_cast<const float*>(q), q_b, q_h,
                              static_cast<const float*>(kn), static_cast<const float*>(vn), n_b,
                              n_h, k8, v8, c_b, c_t, c_h, ksf, vsf, s_b, s_t, s_h, m8, m_b, m_t,
                              static_cast<float*>(out), B, H, Hkv, T, Dh, offset, od, scale};
    launch(a, tk, tv, g, static_cast<int>(rows_blocks), warps, smem, st);
  } else {
    const DecodeArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(q), q_b, q_h, static_cast<const __nv_bfloat16*>(kn),
        static_cast<const __nv_bfloat16*>(vn), n_b, n_h, k8, v8, c_b, c_t, c_h, ksf, vsf, s_b,
        s_t, s_h, m8, m_b, m_t, static_cast<__nv_bfloat16*>(out), B, H, Hkv, T, Dh, offset, od,
        scale};
    launch(a, tk, tv, g, static_cast<int>(rows_blocks), warps, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
