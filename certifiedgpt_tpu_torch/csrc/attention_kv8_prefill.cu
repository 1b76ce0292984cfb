// The prefill's attention over the decoder's int8 KV cache on Hopper
// (sm_90a), with the prefill's cache write in the same launch, at any cache
// length.
//
// Replaces, for several query rows, the sequence the JAX package runs inside
// one XLA program (certifiedgpt_tpu/models/llama.py:243-270): quantize_rows
// of the S new k and v rows (certifiedgpt_tpu/ops/quantization.py:52-65),
// four dynamic_update_slice writes at the cache offset, then
// multi_head_attention_kv8 (certifiedgpt_tpu/ops/attention.py:76) over the
// whole cache. The port's plain version is
// ops/attention.py::_prefill_attention_kv8_plain. With no new rows (Sn = 0)
// it is multi_head_attention_kv8 alone, for bf16 queries of several rows.
//
// What it computes, in the plain version's order:
//   the cache write: xs = max(amax_d |x|, 1e-8) / 127 (an IEEE division),
//     codes clip(rint(x / xs), -127, 127) (an IEEE division, half to even),
//     for the new k and v rows, written to slots [offset, offset + Sn):
//     bit for bit quantize_rows;
//   logits[t] = (sum_d q[d] * kq8[t, d]) * ks[t] * scale     (f32 sums)
//   where(mask, logits, f32_min), minus the row max, exp, where(mask, w, 0),
//   divided by max(sum, f32_tiny)    (a fully masked row gives zeros)
//   p[t] = bf16(w[t] * vs[t])        (w already divided by the sum)
//   out[d] = bf16(sum_t p[t] * vq8[t, d])                       (f32 sums)
// The products are exact in f32 (bf16 times int8), so only the order of the
// f32 sums, a few f32 ulps of the exponential (ex2.approx), of the softmax's
// sum (rescaled as its max grows) and of w / sum (w times 1 / sum) differ
// from the plain version, each before p's bf16 rounding.
//
// Bound on the H100: bytes. At the certify prefill (q [96, 96, 32, 128] and
// 96 new rows a head into a [96, 106, 32, 128] cache) q, the new k and v
// (bf16), the output and the codes move ~0.38 GB: 0.11 ms at 3.35 TB/s; the
// three contractions (q K^T twice, P V) 24 GFLOP, 0.025 ms on the tensor
// cores. The design:
//
// - A unit is one (batch row, kv head) item and up to 8 row tiles of 16 of
//   its g * Sq query rows (g = H / Hkv query heads a kv head, rows gi * Sq +
//   s), a warp a row tile; two blocks share an SM (128 registers a thread).
//   The launcher splits an item's rows over as many units (blockIdx.z) as it
//   takes to fill the card (eval's 256 items of 320 rows: three units each,
//   a caption's 32 items: three), an item's last unit scheduled first.
// - The keys are three segments: the cache's old slots before the offset,
//   the Sn new rows, the old slots after them. Each segment is cut into
//   tiles of 32 positions; a tile of old slots is one tensor copy of the
//   int8 cache, a tile of new rows one tensor copy of the bf16 k (or v)
//   input, each from a tensor map that ends where its segment ends (rows
//   past it arrive as zeros), so no block reads the slots the launch writes.
//   Tiles stream through a two-stage ring on mbarriers.
// - The unit's mask rows are staged by 16-byte cp.async and folded into
//   bits in shared memory (4 positions a lane, 8 lanes a word), or read from
//   device memory when they do not fit; the last kept position ends the
//   walk, so the causal future is not loaded. The first tile's copy starts
//   before the scan.
// - Each landed tile is converted once for the block into a bf16 tile of
//   codes (rows padded to 272 bytes, so ldmatrix is free of bank
//   conflicts): old int8 rows by byte permutes and one f32 subtraction (no
//   I2F), new rows quantized (16 lanes a row: the amax by shuffles, the codes
//   by reciprocal products, bit for bit the divisions) with their scales. The
//   unit that takes an item's last rows writes the new rows' codes and scales
//   to the cache, from registers, once; its second pass covers every new
//   tile for that.
// - Two passes over the tiles, the row of logits never stored: pass 1
//   computes q K^T (mma.sync.m16n8k16, bf16 in, f32 out; q's fragments by
//   ldmatrix from the unit's staged q rows) and each row's max and its sum
//   of exponentials, the sum rescaled when the max grows; pass 2 computes q
//   K^T again, p = bf16((w / sum) * vs) from the final max and sum (the plain
//   version's rounding of p), and P V on the tensor cores with P straight
//   from the registers. When every K tile fits beside two blocks an SM
//   (the certify prefill, a caption's), pass 1 keeps its K tiles of codes and
//   pass 2 copies and converts only V; otherwise pass 2 quantizes K again
//   with the row scales pass 1 kept.
// - An 8-key tile that no row of a warp keeps is neither multiplied nor
//   exponentiated: its guards come from a warp reduction into a uniform
//   register, guarded instructions rather than branches.
// - One __syncthreads a tile: the tiles of codes are double-buffered, so a
//   warp done with its products converts the next tile while others finish.
//
// On one H100 80GB HBM3 at 700 W (chip_smoke.py): 0.37 ms alone at the
// certify prefill, 0.22 at eval's; its time is the warps' own latency and
// shared-memory traffic (every warp reads each K and V tile by ldmatrix).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "kv8_codes.cuh"

namespace {

constexpr int kDh = 128;                     // the head_dim it takes
constexpr int kKeysShift = 5;
constexpr int kKeys = 1 << kKeysShift;       // positions a tile holds
constexpr int kStages = 2;                   // the ring's stages
constexpr int kMaxWarps = 8;                 // row tiles a unit
constexpr int kMinBlocks = 2;                // blocks of kMaxWarps an SM holds by registers
constexpr int kRowBytes = 2 * (kDh + 8);     // a bf16 row of codes, padded (272)
constexpr int kWideRow = 2 * kDh;            // a bf16 new row as its copy lands (256)
constexpr int kNarrowRow = kDh;              // an int8 cache row (128)
// the launcher's code for a cache whose mask bits do not fit in shared memory
constexpr int kCacheTooLong = -1;

struct Args {
  const __nv_bfloat16* q;  // [B, Sq, H, Dh] by strides (elements), dim contiguous
  long long q_b, q_s, q_h;
  int8_t* k;  // the int8 cache [B, T, Hkv, Dh] (k and v share the strides)
  int8_t* v;
  long long c_b, c_t, c_h;
  float* ks;  // the row scales [B, T, Hkv] (ks and vs share the strides)
  float* vs;
  long long s_b, s_t, s_h;
  const uint8_t* mask;  // bool [B, Sq, T] by strides (0 for broadcast), or null
  long long m_b, m_s, m_t;
  __nv_bfloat16* out;  // [B, Sq, H, Dh] contiguous
  int Sq, H, g, T, offset, Sn;
  int cache;  // pass 1's K tiles a unit may keep for pass 2
  float scale;
};

// Where each part lives in the block's shared memory, in bytes: the ring
// (each stage: a K and a V slot of kKeys wide rows, then the old rows' K and
// V scales), the tiles of codes (a K or V tile's rows, then its scales: 4,
// or the cached K tiles and two), the
// unit's q rows (16 a warp, padded as the codes), each K tile's row scales
// and their reciprocals (pass 1 keeps them for pass 2 when it keeps no K
// tile; the plan keeps every tile or none), the mask bits (a row of
// `stride` words for each of the unit's rows), the last kept position and
// the ring's mbarriers. Before the first tile, stage 1 onwards and the codes
// hold the unit's mask bytes.
struct Layout {
  int stage, ring, codes, slot, q, kscale, bits, words, stride, range, bars, bytes;
};

__host__ __device__ inline Layout layout(int T, int warps, int cache) {
  Layout l;
  l.stage = 2 * kKeys * kWideRow + 2 * 4 * kKeys;
  l.ring = 0;
  l.slot = kKeys * kRowBytes + 4 * kKeys;
  l.codes = kStages * l.stage;
  l.q = l.codes + (cache + 2 > 4 ? cache + 2 : 4) * l.slot;
  l.kscale = l.q + warps * 16 * kRowBytes;  // none when the K tiles are kept
  l.bits = l.kscale + (cache ? 0 : 2 * 4 * kKeys * (((T + kKeys - 1) >> kKeysShift) + 2));
  l.words = (T + 31) >> 5;
  l.stride = l.words + 1;  // a zero word past the last: a window reads two
  l.range = l.bits + 4 * 16 * warps * l.stride;
  l.bars = (l.range + 4 + 7) / 8 * 8;
  l.bytes = l.bars + 8 * kStages;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// a tile, box [1, kKeys, 1, Dh] at (b, t, hk) of the map, by the tensor
// memory accelerator, completing on the stage's barrier
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int hk, int t,
                                          int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(hk), "r"(t), "r"(b), "r"(bar)
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

// this thread's reads of the ring come before the tensor copies that refill
// it (they write through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group but the newest kStages - 1 has landed (this thread's
// copies: a tile's old scales, committed with its tile)
__device__ __forceinline__ void wait_tile_scales() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// ldmatrix and mma where `on` holds (the same in every lane of the warp):
// guarded instructions, not branches; with `on` false the registers keep
// their values.
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

// Row R = gi * Sq + s of an item's g * Sq query rows (gi: the query head in
// the kv head's group, s: the query position); found and stepped by
// subtraction (an integer division's SASS holds I2F).
struct RowPos {
  int gi, s;
};

__device__ __forceinline__ RowPos advance(RowPos p, int by, int Sq) {
  p.s += by;
  while (p.s >= Sq) {
    p.s -= Sq;
    ++p.gi;
  }
  return p;
}

// A tile of the key sequence: its segment (0: old slots before the offset,
// 1: new rows, 2: old slots after them), its first position in the cache,
// the positions it holds and its first row in the segment's tensor map.
struct Tile {
  int seg, t0, count, at;
};

struct Segments {
  int before, fresh, after;  // tiles in each
};

__device__ __forceinline__ Tile tile_at(const Args& a, const Segments& n, int i) {
  Tile t;
  if (i < n.before) {
    t.seg = 0;
    t.at = i << kKeysShift;
    t.t0 = t.at;
    t.count = a.offset - t.at;
  } else if (i < n.before + n.fresh) {
    t.seg = 1;
    t.at = (i - n.before) << kKeysShift;
    t.t0 = a.offset + t.at;
    t.count = a.Sn - t.at;
  } else {
    t.seg = 2;
    t.at = (i - n.before - n.fresh) << kKeysShift;
    t.t0 = a.offset + a.Sn + t.at;
    t.count = a.T - t.t0;
  }
  t.count = t.count < kKeys ? t.count : kKeys;
  return t;
}

// the tile that holds cache position t
__device__ __forceinline__ int tile_of(const Args& a, const Segments& n, int t) {
  if (t < a.offset) return t >> kKeysShift;
  if (t < a.offset + a.Sn) return n.before + ((t - a.offset) >> kKeysShift);
  return n.before + n.fresh + ((t - a.offset - a.Sn) >> kKeysShift);
}

struct Maps {
  CUtensorMap kb, vb, kn, vn, ka, va;  // old before, new, old after; K and V
};

// The block's walk over the tiles: pass 1's tiles [0, n1) (K), then pass
// 2's [0, n2) (K and V). With `cached` (n1 <= Args::cache), pass 1 keeps its
// K tiles of codes in slots 0 to n1 - 1 and pass 2 copies and converts only
// V, in slots cache and cache + 1 by turns; otherwise each step converts
// into slots 0-1 or 2-3 by turns.
struct Walk {
  int n1, n2;
  bool cached;
};

// What step e copies, converts and reads: its tile; the tensors, K (0)
// and/or V (1), `count` of them from `first`; the slots of its K and V codes
// (kslot -1: a tile past the unit's kept positions, converted for the cache
// write only, its K codes not stored); and whether it is in pass 2.
struct Step {
  Tile t;
  int tile, first, count, kslot, vslot;
  bool pass2;
};

__device__ __forceinline__ Step step_of(const Args& a, const Segments& n, const Walk& w, int e) {
  Step s;
  s.pass2 = e >= w.n1;
  const int i = s.pass2 ? e - w.n1 : e;
  s.tile = i;
  s.t = tile_at(a, n, i);
  s.first = 0;
  s.count = s.pass2 ? 2 : 1;
  if (!w.cached) {
    s.kslot = 2 * (e & 1);
    s.vslot = s.kslot + 1;
  } else {
    s.kslot = i < w.n1 ? i : -1;
    s.vslot = a.cache + (e & 1);
    if (s.pass2 && i < w.n1) s.first = s.count = 1;  // K is in its slot already
  }
  return s;
}

// Starts step e's copies into its stage (past the last step nothing is
// copied): thread 0 arms the stage's barrier and starts the tensor copies;
// for a tile of old slots, the threads that convert its rows' first chunks
// copy those rows' scales by cp.async. Every thread commits one group.
__device__ __forceinline__ void stage_step(const Args& a, const Maps& m, const Segments& n,
                                           const Walk& w, const Layout& L, unsigned char* smem,
                                           int b, int hk, int e, int stage) {
  if (e < w.n1 + w.n2) {
    const Step s = step_of(a, n, w, e);
    const Tile& t = s.t;
    unsigned char* st = smem + L.ring + stage * L.stage;
    if (threadIdx.x == 0) {
      const uint32_t bar = smem_u32(smem + L.bars) + 8 * stage;
      const uint32_t row = t.seg == 1 ? kWideRow : kNarrowRow;
      expect_bytes(bar, static_cast<uint32_t>(s.count) * kKeys * row);
      if (s.first == 0) {
        load_tile(smem_u32(st), t.seg == 0 ? &m.kb : (t.seg == 1 ? &m.kn : &m.ka), hk, t.at, b,
                  bar);
      }
      if (s.first + s.count == 2) {
        load_tile(smem_u32(st + kKeys * kWideRow),
                  t.seg == 0 ? &m.vb : (t.seg == 1 ? &m.vn : &m.va), hk, t.at, b, bar);
      }
    }
    if (t.seg != 1) {
      float* sc = reinterpret_cast<float*>(st + 2 * kKeys * kWideRow);
      for (int i = threadIdx.x; i < s.count * kKeys * 8; i += blockDim.x) {
        const int r = (i >> 3) & (kKeys - 1);
        if ((i & 7) != 0 || r >= t.count) continue;
        const bool is_v = s.first + (i >= kKeys * 8) == 1;
        cp_async4(smem_u32(sc + is_v * kKeys + r),
                  (is_v ? a.vs : a.ks) + b * a.s_b + (t.t0 + r) * a.s_t + hk * a.s_h);
      }
    }
  }
  commit_group();
}

// Converts step s's landed tensors into their slots of codes: old int8 rows
// to bf16 (8 threads a row), new bf16 rows quantized (16 lanes a row; with
// `write` their codes and scales also go to the cache; pass 1 keeps K's row
// scales in `kscale` when it is given, and with `reuse` pass 2 takes them
// from there). Rows past the tile's count are zeros with scale 0.
__device__ __forceinline__ void convert(const Args& a, const Step& s, bool write, bool reuse,
                                        const unsigned char* st, unsigned char* codes,
                                        float* kscale, const Layout& L, int b, int hk) {
  const Tile& t = s.t;
  if (t.seg != 1) {
    const float* sc = reinterpret_cast<const float*>(st + 2 * kKeys * kWideRow);
    for (int i = threadIdx.x; i < s.count * kKeys * 8; i += blockDim.x) {
      const int is_v = s.first + (i >= kKeys * 8), r = (i >> 3) & (kKeys - 1), c = i & 7;
      const int slot = is_v ? s.vslot : s.kslot;
      if (slot < 0) continue;  // old rows are never written
      const uint4 w = *reinterpret_cast<const uint4*>(st + is_v * kKeys * kWideRow +
                                                      r * kNarrowRow + 16 * c);
      uint32_t h[8];
      bf16x4_of(w.x, h[0], h[1]);
      bf16x4_of(w.y, h[2], h[3]);
      bf16x4_of(w.z, h[4], h[5]);
      bf16x4_of(w.w, h[6], h[7]);
      unsigned char* cb = codes + slot * L.slot;
      uint4* dst = reinterpret_cast<uint4*>(cb + r * kRowBytes + 32 * c);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
      if (c == 0) {
        reinterpret_cast<float*>(cb + kKeys * kRowBytes)[r] =
            r < t.count ? sc[is_v * kKeys + r] : 0.f;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < s.count * kKeys * 16; i += blockDim.x) {  // whole warps
    const int is_v = s.first + (i >= kKeys * 16), r = (i >> 4) & (kKeys - 1), c = i & 15;
    const uint4 w =
        *reinterpret_cast<const uint4*>(st + is_v * kKeys * kWideRow + r * kWideRow + 16 * c);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    float x[8];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(ws[j] << 16);
      x[2 * j + 1] = __uint_as_float(ws[j] & 0xFFFF0000u);
      amax = fmaxf(amax, fmaxf(fabsf(x[2 * j]), fabsf(x[2 * j + 1])));
    }
    // a K row's scale and its reciprocal, kept by pass 1 for pass 2 when
    // `kscale` is given (a warp's lanes all take K or all V)
    float* kept = kscale + 2 * kKeys * s.tile + r;
    float xs, rcp;
    if (reuse && !is_v) {
      xs = kept[0];
      rcp = kept[kKeys];
    } else {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      xs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
      rcp = __frcp_rn(xs);
      if (kscale != nullptr && !is_v && !s.pass2 && c == 0) {
        kept[0] = xs;
        kept[kKeys] = rcp;
      }
    }
    float qf[8];
    uint32_t bytes[2];  // the int8 codes, four a word
    cgpt_kv8::codes_of(x, xs, rcp, qf, bytes);
    const bool in = r < t.count;
    const int slot = is_v ? s.vslot : s.kslot;
    if (slot >= 0) {
      unsigned char* cb = codes + slot * L.slot;
      *reinterpret_cast<uint4*>(cb + r * kRowBytes + 16 * c) =
          make_uint4(bf16x2(qf[0], qf[1]), bf16x2(qf[2], qf[3]), bf16x2(qf[4], qf[5]),
                     bf16x2(qf[6], qf[7]));
      if (c == 0) reinterpret_cast<float*>(cb + kKeys * kRowBytes)[r] = in ? xs : 0.f;
    }
    if (write && in) {
      int8_t* row = (is_v ? a.v : a.k) + b * a.c_b + static_cast<long long>(t.t0 + r) * a.c_t +
                    hk * a.c_h;
      *reinterpret_cast<uint2*>(row + 8 * c) = make_uint2(bytes[0], bytes[1]);
      if (c == 0) (is_v ? a.vs : a.ks)[b * a.s_b + (t.t0 + r) * a.s_t + hk * a.s_h] = xs;
    }
  }
}

// The unit's mask rows as bits (bit j of word w: position 32 w + j kept,
// then a zero word) from device memory (no mask: every position kept), four
// rows of a warp and four words of each at a time, every read issued before
// any is used (positions past T read the last one's byte and are dropped).
// Returns the last kept position the warp saw (-1: none).
__device__ __forceinline__ int scan_mask(const Args& a, uint32_t* bits, const Layout& L, int b,
                                         int row0, int rows, int warps, int warp, int lane) {
  constexpr int kRowsAtOnce = 4;
  int hi = -1;
  RowPos p = advance({0, 0}, row0 + warp, a.Sq);
  for (int r = warp; r < 16 * warps; r += kRowsAtOnce * warps) {
    const uint8_t* mrow[kRowsAtOnce];
    bool valid[kRowsAtOnce];
#pragma unroll
    for (int k = 0; k < kRowsAtOnce; ++k) {
      valid[k] = r + k * warps < 16 * warps && row0 + r + k * warps < rows;
      mrow[k] = a.mask + b * a.m_b + p.s * a.m_s;
      p = advance(p, warps, a.Sq);
    }
    for (int w0 = 0; w0 < L.words; w0 += 4) {
      bool kept[kRowsAtOnce][4];
      if (a.mask == nullptr) {
#pragma unroll
        for (int k = 0; k < kRowsAtOnce; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) kept[k][j] = valid[k] && 32 * (w0 + j) + lane < a.T;
      } else {
        uint8_t mb[kRowsAtOnce][4];
#pragma unroll
        for (int k = 0; k < kRowsAtOnce; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mb[k][j] = __ldg(mrow[k] + min(32 * (w0 + j) + lane, a.T - 1) * a.m_t);
          }
#pragma unroll
        for (int k = 0; k < kRowsAtOnce; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            kept[k][j] = valid[k] && 32 * (w0 + j) + lane < a.T && mb[k][j] != 0;
          }
      }
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = __ballot_sync(0xffffffffu, kept[k][j]);
          const int w = w0 + j, row = r + k * warps;
          if (w < L.words && row < 16 * warps) {
            if (lane == 0) bits[row * L.stride + w] = word;
            if (word) hi = max(hi, 32 * w + 31 - __clz(word));
          }
        }
    }
#pragma unroll
    for (int k = 0; k < kRowsAtOnce; ++k) {
      if (lane == 0 && r + k * warps < 16 * warps) bits[(r + k * warps) * L.stride + L.words] = 0u;
    }
  }
  return hi;
}

// scan_mask for rows of contiguous positions (m_t 1) staged at `base` (query
// position s_lo first): a lane folds 4 bytes (one 4-byte read, shifted into
// place) into 4 bits, and 8 lanes' bits make a word by 3 shuffles: 128
// positions of a row a warp instruction stream, four rows at a time.
__device__ __forceinline__ int scan_mask_staged(const Args& a, const unsigned char* smem,
                                                uint32_t* bits, const Layout& L, int row0,
                                                int rows, int warps, int warp, int lane,
                                                int base, int s_lo) {
  constexpr int kRowsAtOnce = 4;
  int hi = -1;
  RowPos p = advance({0, 0}, row0 + warp, a.Sq);
  const int m_s = static_cast<int>(a.m_s);
  for (int r = warp; r < 16 * warps; r += kRowsAtOnce * warps) {
    int off[kRowsAtOnce];
    bool valid[kRowsAtOnce];
#pragma unroll
    for (int k = 0; k < kRowsAtOnce; ++k) {
      valid[k] = r + k * warps < 16 * warps && row0 + r + k * warps < rows;
      off[k] = valid[k] ? base + (p.s - s_lo) * m_s : base;
      p = advance(p, warps, a.Sq);
    }
    for (int c = 0; 128 * c < a.T; ++c) {
      const int t = 128 * c + 4 * lane;  // the lane's first position
      // the positions past T of the lane's four: none, some or all
      const uint32_t in = t >= a.T ? 0u : (a.T - t >= 4 ? 0xFu : (1u << (a.T - t)) - 1u);
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k) {
        const int at = off[k] + t;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + (at & ~3));
        uint32_t v = __funnelshift_r(w[0], w[1], 8 * (at & 3));
        v |= v >> 4;  // any bit of a byte set -> its bit 0
        v |= v >> 2;
        v |= v >> 1;
        v &= 0x01010101u;
        // byte i's bit 0 to bit 28 + i (the cross terms fall below bit 28
        // on distinct bits, or past bit 31)
        uint32_t x = valid[k] ? ((v * 0x10204080u) >> 28) & in : 0u;
        x <<= 4 * (lane & 7);
        x |= __shfl_xor_sync(0xffffffffu, x, 1);
        x |= __shfl_xor_sync(0xffffffffu, x, 2);
        x |= __shfl_xor_sync(0xffffffffu, x, 4);
        const int word = 4 * c + (lane >> 3);
        if ((lane & 7) == 0 && word < L.words && r + k * warps < 16 * warps) {
          bits[(r + k * warps) * L.stride + word] = x;
        }
        if (x) hi = max(hi, 32 * word + 31 - __clz(x));
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsAtOnce; ++k) {
      if (lane == 0 && r + k * warps < 16 * warps) bits[(r + k * warps) * L.stride + L.words] = 0u;
    }
  }
  return hi;
}

// Block (hk, b, z) takes unit u = units - 1 - z of item (b, hk): row tiles u
// * warps to u * warps + warps - 1 of its g * Sq rows, a warp a tile. The
// last unit of an item writes its new rows to the cache.
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    kv8_prefill_kernel(const Args a, const __grid_constant__ Maps m) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // a fragment's row and column pair
  // an item's last unit (the most keys under a causal mask) is scheduled
  // first, so that the long blocks do not make the grid's tail
  const int hk = blockIdx.x, b = blockIdx.y, unit = gridDim.z - 1 - blockIdx.z;
  const int rows = a.g * a.Sq, row0 = unit * warps * 16;
  const bool writer = unit == gridDim.z - 1 && a.Sn > 0;
  const Layout L = layout(a.T, warps, a.cache);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  int* range = reinterpret_cast<int*>(smem + L.range);
  const uint32_t bars = smem_u32(smem + L.bars);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbarrier_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    range[0] = -1;
  }

  // the unit's q rows into the warps' q tiles by cp.async (a lane 16 bytes of
  // rows lane / 16, + 2, ...; rows past the last are zeros), one group that
  // lands while the mask is read
  unsigned char* qt = smem + L.q + warp * 16 * kRowBytes;
  {
    RowPos p = advance({0, 0}, row0 + 16 * warp + (lane >> 4), a.Sq);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (lane >> 4) + 2 * i;
      const bool in = row0 + 16 * warp + r < rows;
      const __nv_bfloat16* src =
          a.q + (in ? b * a.q_b + p.s * a.q_s + (hk * a.g + p.gi) * a.q_h : 0) + 8 * (lane & 15);
      cp_async16(smem_u32(qt + r * kRowBytes + 16 * (lane & 15)), src, in ? 16 : 0);
      p = advance(p, 2, a.Sq);
    }
    commit_group();
  }
  const int rlo = row0 + 16 * warp + gr;
  const RowPos plo = advance({0, 0}, rlo, a.Sq);
  const RowPos phi = advance(plo, 8, a.Sq);

  // the mask bytes of the unit's query positions [s_lo, s_hi] (all of them
  // when its rows span two query heads), staged into the ring's later stages
  // and the buffers of codes by 16-byte cp.async when a row's positions are
  // contiguous and they fit (the last few bytes one at a time: nothing past
  // the mask is read); else read from device memory by the scan
  const int last = min(row0 + 16 * warps, rows) - 1;
  const RowPos pf = advance({0, 0}, row0, a.Sq), pl = advance(pf, last - row0, a.Sq);
  const int s_lo = pf.gi == pl.gi ? pf.s : 0, s_hi = pf.gi == pl.gi ? pl.s : a.Sq - 1;
  const uintptr_t first = reinterpret_cast<uintptr_t>(a.mask + b * a.m_b + s_lo * a.m_s);
  const uintptr_t end = first + (s_hi - s_lo) * a.m_s + (a.T - 1) * a.m_t + 1;
  const uintptr_t lo16 = first & ~static_cast<uintptr_t>(15), hi16 = end & ~static_cast<uintptr_t>(15);
  const int staging = L.ring + L.stage;  // stage 1 onwards, then the codes
  const bool staged = a.mask != nullptr && a.m_t == 1 &&
                      end - lo16 <= static_cast<uintptr_t>(L.q - staging);
  if (staged) {
    const int chunks = static_cast<int>((hi16 - lo16) >> 4);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      cp_async16(smem_u32(smem + staging + 16 * c), reinterpret_cast<const void*>(lo16 + 16 * c),
                 16);
    }
    for (int c = threadIdx.x; c < static_cast<int>(end - hi16); c += blockDim.x) {
      smem[staging + (hi16 - lo16) + c] = *reinterpret_cast<const unsigned char*>(hi16 + c);
    }
  }
  commit_group();
  __syncthreads();  // the barriers and the last kept position are set

  // pass 1 walks from tile 0 (a tile before the first kept position is
  // dead, not skipped), so its first copy starts before the scan
  const Segments n{(a.offset + kKeys - 1) >> kKeysShift, (a.Sn + kKeys - 1) >> kKeysShift,
                   (a.T - a.offset - a.Sn + kKeys - 1) >> kKeysShift};
  stage_step(a, m, n, Walk{1, 0, false}, L, smem, b, hk, 0, 0);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // q and the staged mask
  __syncthreads();  // the staged mask bytes are in place

  // the unit's mask rows as bits; the last kept position
  {
    const int hi =
        staged ? scan_mask_staged(a, smem, bits, L, row0, rows, warps, warp, lane,
                                  staging + static_cast<int>(first - lo16), s_lo)
               : scan_mask(a, bits, L, b, row0, rows, warps, warp, lane);
    const int warp_hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) atomicMax(range, warp_hi);
  }
  fence_proxy_async();  // the staged bytes are read before copies refill their stages
  __syncthreads();  // the bits and the last kept position are in place

  // pass 1: tiles [0, the tile of the last kept position] (at least tile 0,
  // already on its way); pass 2 the same, and the writer unit every new tile
  Walk walk{1, 0, true};
  if (range[0] >= 0) walk.n1 = walk.n2 = tile_of(a, n, range[0]) + 1;
  if (writer) walk.n2 = max(walk.n2, n.before + n.fresh);
  walk.cached = walk.n1 <= a.cache;
  const int steps = walk.n1 + walk.n2;
  for (int s = 1; s < kStages; ++s) stage_step(a, m, n, walk, L, smem, b, hk, s, s);

  // a lane's ldmatrix rows: of a buffer of codes, K (B of q K^T: keys +0/+8,
  // dims +0/+8) and V (B of P V, transposed: keys +0/+8, dims +0/+8); of the
  // warp's q tile (A of q K^T: rows +0/+8, dims +0/+8)
  const uint32_t codes = smem_u32(smem + L.codes);
  const uint32_t k_at =
      ((lane & 7) + ((lane >> 4) << 3)) * kRowBytes + ((lane >> 3) & 1) * 16;
  const uint32_t v_at = (lane & 15) * kRowBytes + (lane >> 4) * 16;
  const uint32_t q_at = smem_u32(qt) + (lane & 15) * kRowBytes + (lane >> 4) * 16;
  const uint32_t* mybits = bits + (16 * warp + gr) * L.stride;
  const bool has_rows = row0 + 16 * warp < rows;
  const float scale = a.scale;

  float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[kDh / 8][4];
#pragma unroll
  for (int dt = 0; dt < kDh / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  uint32_t phases = 0;  // each stage's mbarrier parity, a bit a stage

  for (int e = 0, stage = 0; e < steps; ++e) {
    const Step sp = step_of(a, n, walk, e);
    const Tile& t = sp.t;
    const bool two = sp.pass2;
    unsigned char* st = smem + L.ring + stage * L.stage;
    mbarrier_wait(bars + 8 * stage, (phases >> stage) & 1);
    __syncwarp();  // the lanes converged before the warp-aligned barriers and shuffles
    wait_tile_scales();
    // the writer unit stores each new tensor's codes once: K in pass 1 when
    // pass 2 reads it from its slot, else in pass 2
    convert(a, sp, writer && (two || walk.cached), two && !walk.cached && sp.tile < walk.n1, st,
            smem + L.codes,
            walk.cached ? nullptr : reinterpret_cast<float*>(smem + L.kscale), L, b, hk);
    fence_proxy_async();
    __syncthreads();  // the codes are in place, the stage is read
    stage_step(a, m, n, walk, L, smem, b, hk, e + kStages, stage);
    phases ^= 1u << stage;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (e == walk.n1) {
      // pass 1 is over: each row's sum across its four lanes, 1 / max(sum,
      // f32_tiny) (w / sum as w * (1 / sum))
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
        inv[h] = __frcp_rn(fmaxf(sum[h], FLT_MIN));
      }
    }
    if (!has_rows) continue;

    // the lane's kept bits of rows gr (lo) and gr + 8 (hi) at the tile's
    // positions (bit j: position t0 + j), and the 8-key tiles some row of
    // the warp keeps (a uniform register)
    const int wi = t.t0 >> 5, sh = t.t0 & 31;
    const uint32_t cut = t.count >= 32 ? 0xffffffffu : (1u << t.count) - 1u;
    const uint32_t klo = __funnelshift_r(mybits[wi], mybits[wi + 1], sh) & cut;
    const uint32_t khi =
        __funnelshift_r(mybits[8 * L.stride + wi], mybits[8 * L.stride + wi + 1], sh) & cut;
    const uint32_t any = __reduce_or_sync(0xffffffffu, klo | khi);
    uint32_t live = 0;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) live |= ((any >> (8 * nt)) & 0xFFu) ? 1u << nt : 0u;
    if (!live) continue;

    // logits: q K^T on the live 8-key tiles
    const uint32_t kbase = codes + sp.kslot * L.slot, vbase = codes + sp.vslot * L.slot;
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    uint32_t kf[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(q_at + 32 * kk, qa);
#pragma unroll
      for (int p = 0; p < kKeys / 16; ++p) {
        ldsm_x4_if((live >> (2 * p)) & 3u, kbase + k_at + p * 16 * kRowBytes + 32 * kk, kf);
        mma_bf16_if((live >> (2 * p)) & 1u, s[2 * p], qa, kf[0], kf[1]);
        mma_bf16_if((live >> (2 * p + 1)) & 1u, s[2 * p + 1], qa, kf[2], kf[3]);
      }
    }
    const float* cks =
        reinterpret_cast<const float*>(smem + L.codes + sp.kslot * L.slot + kKeys * kRowBytes);
    // scaled logits of rows gr (i = 0, 1) and gr + 8 (i = 2, 3); a masked
    // logit counts as f32_min
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      if (!((live >> nt) & 1u)) continue;
      const float2 ks2 = *reinterpret_cast<const float2*>(cks + 8 * nt + 2 * tq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool kept = ((i < 2 ? klo : khi) >> (8 * nt + 2 * tq + (i & 1))) & 1u;
        const float l = __fmul_rn(__fmul_rn(s[nt][i], i & 1 ? ks2.y : ks2.x), scale);
        s[nt][i] = kept ? l : -FLT_MAX;
      }
    }

    if (!two) {
      // pass 1: the rows' max so far, the sum rescaled to it, this tile's
      // numerators added
      float tmax[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        if (!((live >> nt) & 1u)) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) tmax[i >> 1] = fmaxf(tmax[i >> 1], s[nt][i]);
      }
      float mnew[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        mnew[h] = fmaxf(mx[h], tmax[h]);
        sum[h] = __fmul_rn(sum[h], exp_sfu(__fsub_rn(mx[h], mnew[h])));
        mx[h] = mnew[h];
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        if (!((live >> nt) & 1u)) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool kept = ((i < 2 ? klo : khi) >> (8 * nt + 2 * tq + (i & 1))) & 1u;
          sum[i >> 1] = __fadd_rn(sum[i >> 1], kept ? exp_sfu(__fsub_rn(s[nt][i], mx[i >> 1]))
                                                    : 0.f);
        }
      }
      continue;
    }

    // pass 2: p = bf16((w / sum) * vs), packed as the A fragments of P V (a
    // dead tile's p is 0), then P V over the live 16-key steps
    const float* cvs =
        reinterpret_cast<const float*>(smem + L.codes + sp.vslot * L.slot + kKeys * kRowBytes);
    uint32_t pk[kKeys / 8][2];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      pk[nt][0] = pk[nt][1] = 0u;
      if (!((live >> nt) & 1u)) continue;
      const float2 vs2 = *reinterpret_cast<const float2*>(cvs + 8 * nt + 2 * tq);
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool kept = ((i < 2 ? klo : khi) >> (8 * nt + 2 * tq + (i & 1))) & 1u;
        const float w = kept ? exp_sfu(__fsub_rn(s[nt][i], mx[i >> 1])) : 0.f;
        pv[i] = __fmul_rn(__fmul_rn(w, inv[i >> 1]), i & 1 ? vs2.y : vs2.x);
      }
      pk[nt][0] = bf16x2(pv[0], pv[1]);
      pk[nt][1] = bf16x2(pv[2], pv[3]);
    }
    uint32_t vf[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < kKeys / 16; ++p) {
      const bool on = (live >> (2 * p)) & 3u;
      const uint32_t pa[4] = {pk[2 * p][0], pk[2 * p][1], pk[2 * p + 1][0], pk[2 * p + 1][1]};
#pragma unroll
      for (int dp = 0; dp < kDh / 16; ++dp) {
        ldsm_x4_trans_if(on, vbase + v_at + p * 16 * kRowBytes + 32 * dp, vf);
        mma_bf16_if(on, o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_if(on, o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");  // q's copies, when no tile ran
  // the output rows gr and gr + 8 of the warp's tile, 4 bytes a lane a
  // dimension pair
  if (!has_rows) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const RowPos p = h ? phi : plo;
    if (rlo + 8 * h >= rows) continue;
    __nv_bfloat16* orow =
        a.out + ((static_cast<long long>(b) * a.Sq + p.s) * a.H + hk * a.g + p.gi) * kDh;
#pragma unroll
    for (int dt = 0; dt < kDh / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + 8 * dt + 2 * tq) =
          bf16x2(o[dt][2 * h], o[dt][2 * h + 1]);
    }
  }
}

// The tensor map of a [B, rows, Hkv, Dh] tensor (int8 or bf16) by strides in
// bytes whose box is one head's kKeys rows [1, kKeys, 1, Dh]; the encoder,
// cuTensorMapEncodeTiled, is looked up once through the runtime (no link
// against libcuda). A segment of no rows gets no map (never read).
int encode_map(CUtensorMap* map, const void* base, bool wide, int B, int rows, int Hkv,
               long long s_b, long long s_t, long long s_h) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  *map = CUtensorMap{};
  if (rows <= 0) return 0;
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
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kDh), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h), static_cast<cuuint64_t>(s_t),
                                 static_cast<cuuint64_t>(s_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kDh), 1, static_cast<cuuint32_t>(kKeys), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, wide ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
      const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a device's SM count, a block's and an SM's shared-memory limits, read (and
// the block's limit granted to the kernel) at its first call: a launch
// captured in a CUDA graph makes no query
int device_limits(int* sms, int* most, int* per_sm) {
  static int most_of[64] = {}, sms_of[64] = {}, per_sm_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (most_of[dev] == 0) {
    int most_here = 0;
    err = cudaDeviceGetAttribute(&most_here, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&per_sm_of[dev], cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kv8_prefill_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most_here);
    if (err != cudaSuccess) return static_cast<int>(err);
    most_of[dev] = most_here;
  }
  *sms = sms_of[dev];
  *most = most_of[dev];
  *per_sm = per_sm_of[dev];
  return 0;
}

// The launch's plan: row tiles a unit (warps a block), units an item, the K
// tiles a unit may keep and the block's shared memory. The most warps (8)
// unless the items times the units then leave SMs idle; then fewer warps and
// more units, down to 2; the item's row tiles spread evenly over its units;
// fewer warps while the mask bits do not fit. The K tiles are kept (every
// tile of the key sequence) when the block's shared memory then still lets
// two blocks share an SM, or when it cannot anyway; else none.
struct Plan {
  int warps, units, cache;
  long long smem;
};

int plan_of(int B, int Sq, int H, int Hkv, int T, int offset, int Sn, Plan* p) {
  int sms = 0, most = 0, per_sm = 0;
  const int code = device_limits(&sms, &most, &per_sm);
  if (code != 0) return code;
  const long long tiles = (static_cast<long long>(H / Hkv) * Sq + 15) / 16;
  const long long items = static_cast<long long>(B) * Hkv;
  const int keys = (offset + kKeys - 1) / kKeys + (Sn + kKeys - 1) / kKeys +
                   (T - offset - Sn + kKeys - 1) / kKeys;
  long long w = tiles < kMaxWarps ? tiles : kMaxWarps;
  while (w > 2 && items * ((tiles + w - 1) / w) < sms) --w;
  long long units = (tiles + w - 1) / w;
  w = (tiles + units - 1) / units;
  while (w > 1 && layout(T, static_cast<int>(w), 0).bytes > most) {
    --w;
    units = (tiles + w - 1) / w;
  }
  p->warps = static_cast<int>(w);
  p->units = static_cast<int>(units);
  const int two = per_sm / 2 - 1024;  // a block's share when two share an SM
  const int bare = layout(T, p->warps, 0).bytes, full = layout(T, p->warps, keys).bytes;
  p->cache = full <= two || (bare > two && full <= most) ? keys : 0;
  p->smem = layout(T, p->warps, p->cache).bytes;
  return p->smem > most ? kCacheTooLong : 0;
}

}  // namespace

// The launch plan for q [B, Sq, H, 128] over T positions, Sn new rows at
// `offset`: out[0] warps a block, out[1] units an item (blocks: Hkv x B x
// units), out[2] shared bytes a block, out[3] blocks an SM holds, out[4] the
// K tiles a unit may keep.
extern "C" int cgpt_attention_kv8_prefill_plan(int B, int Sq, int H, int Hkv, int T, int offset,
                                               int Sn, int* out) {
  if (B <= 0 || Sq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || offset < 0 || Sn < 0 ||
      offset + Sn > T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  const int code = plan_of(B, Sq, H, Hkv, T, offset, Sn, &p);
  if (code != 0) return code;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kv8_prefill_kernel), p.warps * 32,
      static_cast<size_t>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.warps;
  out[1] = p.units;
  out[2] = static_cast<int>(p.smem);
  out[3] = per_sm;
  out[4] = p.cache;
  return 0;
}

// q [B, Sq, H, 128] bf16 by strides (dim contiguous, 16-byte aligned rows:
// strides multiples of 8); the new rows k, v [B, Sn, Hkv, 128] bf16, each by its own
// strides (dim contiguous, 16-byte aligned base, strides multiples of 8),
// quantized into the cache at slots [offset, offset + Sn) (Sn = 0: nothing
// is written, k and v are not read); the int8 cache k, v [B, T, Hkv, 128] by
// shared strides (multiples of 16, 16-byte aligned); the f32 scales ks, vs
// [B, T, Hkv] by shared strides; mask bool [B, Sq, T] by strides or null;
// out [B, Sq, H, 128] bf16, contiguous. H a multiple of Hkv, offset + Sn <=
// T, B and the units an item at most 65535. Returns kCacheTooLong when even
// one warp's mask bits exceed the card's shared memory.
extern "C" int cgpt_attention_kv8_prefill(
    const void* q, long long q_b, long long q_s, long long q_h, const void* kn, long long kn_b,
    long long kn_s, long long kn_h, const void* vn, long long vn_b, long long vn_s,
    long long vn_h, void* k, void* v, long long c_b, long long c_t, long long c_h, void* ks,
    void* vs, long long s_b, long long s_t, long long s_h, const void* mask, long long m_b,
    long long m_s, long long m_t, void* out, int B, int Sq, int H, int Hkv, int T, int Dh,
    int offset, int Sn, float scale, void* stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (B <= 0 || B > 65535 || Sq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh != kDh ||
      offset < 0 || Sn < 0 || offset + Sn > T || c_t % 16 != 0 || c_h % 16 != 0 ||
      c_b % 16 != 0 || !aligned(k, 16) || !aligned(v, 16) || !aligned(q, 16) || q_b % 8 != 0 ||
      q_s % 8 != 0 || q_h % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sn > 0 && (!aligned(kn, 16) || !aligned(vn, 16) || kn_b % 8 != 0 || kn_s % 8 != 0 ||
                 kn_h % 8 != 0 || vn_b % 8 != 0 || vn_s % 8 != 0 || vn_h % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  int code = plan_of(B, Sq, H, Hkv, T, offset, Sn, &p);
  if (code != 0) return code;
  if (p.units > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const int after = T - offset - Sn;
  const auto k8 = static_cast<int8_t*>(k), v8 = static_cast<int8_t*>(v);
  if ((code = encode_map(&maps.kb, k8, false, B, offset, Hkv, c_b, c_t, c_h)) != 0 ||
      (code = encode_map(&maps.vb, v8, false, B, offset, Hkv, c_b, c_t, c_h)) != 0 ||
      (code = encode_map(&maps.kn, kn, true, B, Sn, Hkv, 2 * kn_b, 2 * kn_s, 2 * kn_h)) != 0 ||
      (code = encode_map(&maps.vn, vn, true, B, Sn, Hkv, 2 * vn_b, 2 * vn_s, 2 * vn_h)) != 0 ||
      (code = encode_map(&maps.ka, k8 + (offset + Sn) * c_t, false, B, after, Hkv, c_b, c_t,
                         c_h)) != 0 ||
      (code = encode_map(&maps.va, v8 + (offset + Sn) * c_t, false, B, after, Hkv, c_b, c_t,
                         c_h)) != 0) {
    return code;
  }
  const Args a{static_cast<const __nv_bfloat16*>(q), q_b, q_s, q_h, k8, v8, c_b, c_t, c_h,
               static_cast<float*>(ks), static_cast<float*>(vs), s_b, s_t, s_h,
               static_cast<const uint8_t*>(mask), m_b, m_s, m_t,
               static_cast<__nv_bfloat16*>(out), Sq, H, H / Hkv, T, offset, Sn, p.cache,
               scale};
  const dim3 grid(Hkv, B, p.units), block(p.warps * 32);
  kv8_prefill_kernel<<<grid, block, static_cast<size_t>(p.smem),
                       static_cast<cudaStream_t>(stream)>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}
