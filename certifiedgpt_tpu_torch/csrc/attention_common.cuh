// The attention kernel of this directory, written for Hopper's warpgroup
// matrix multiply: cls_split_attention.cu and flash_attention.cu instantiate
// it and hold the C entry points.
//
// What bounds it on an H100: by the count of operations it is the tensor
// cores (about S / 2 FLOP per byte of q, k, v and out), but at a head dim of
// 88 three things weigh about the same and have to overlap: the products,
// the exp2 of the softmax (one per 368 FLOP, on the 16-lane special function
// unit) and the K/V tiles that every query tile of a (b, h) reads again
// through the L2 cache. The design answers each in turn.
//
// Work: one item is 256 queries of one (b, h), so K and V of a (b, h) pass
// through L2 four times at 1024 tokens, not sixteen. A block of 12 warps
// stays on its SM and walks over items (blockIdx.x, then every
// gridDim.x-th), so that one item's stores and the next item's first copies
// overlap. Warps 8-11 are the producer: they copy Q and the K/V tiles of 64
// keys into shared memory with cp.async, each copy completing on an
// mbarrier, and give most of their registers away (setmaxnreg). Warps 0-7
// are two consumer warpgroups of 128 queries each. Three K buffers and three
// V buffers form the ring; full/empty mbarrier pairs hand a buffer to the
// consumers and back, so copies run up to three tiles ahead and the two
// warpgroups are not held to one pace.
//
// Every tile is kept in the 128-byte-swizzled layout that wgmma's
// shared-memory descriptors read: rows of 64 bf16 (128 bytes), the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8). A head dim of up to 96 is
// two such column boxes (columns 0-63, 64-127) of which only the first 96
// columns are ever read; columns [D, 96) are zeroed once. Rows past the end
// of the sequence are zero-filled by the copy itself (a cp.async of source
// size 0).
//
// A consumer warpgroup owns two row blocks of 64 queries, A and B. S = Q K^T
// of a block and a key tile is wgmma m64n64k16 over six depth steps, Q and K
// both read from shared memory (K-major). The weights P stay in registers as
// the A operand of O += P V (m64n88k16, or n96 for a head dim of 96), with V
// read as the MN-major B operand, i.e. transposed by its descriptor. For key
// tile t the warpgroup starts S_A(t + 1), O_A += P_A V(t), S_B(t + 1),
// O_B += P_B V(t) as four asynchronous groups and takes them up in that
// order, so the softmax of one block (exp2 on the special function unit, the
// score scale folded into one fused multiply-add) runs while the other
// block's products are on the tensor cores.
//
// With kCls the keys and queries are the N patch tokens, and one more key,
// the cls token, seeds every row's online softmax (m = s_c, l = 1, o = v_c).
// The single cls query row of each (b, h) is computed in the same launch by
// the producer warpgroup on the CUDA cores, once its copies are under way and
// while the consumers finish their last items.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgpt_attn {

constexpr int kBlockM = 256;  // queries per work item: 2 warpgroups x 2 row blocks of 64
constexpr int kBlockN = 64;   // keys per tile
constexpr int kDp = 96;       // head dim as the depth of Q K^T (zero-padded)
constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kProducerThreads = 128;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kConsumerRegs = 216;  // setmaxnreg: 2 * 128 * 216 + 128 * 72 <= 65536
constexpr int kProducerRegs = 72;
constexpr int kStages = 3;           // K tiles, and V tiles, in the ring
constexpr int kKSteps = kDp / 16;    // wgmma depth steps of Q K^T
constexpr int kSlots = kDp / 8;      // 16-byte chunks of a padded row
constexpr int kSRegs = kBlockN / 2;  // f32 score registers of a thread and row block
// A tile is two column boxes of 64 bf16 (128-byte rows): columns 0-63, 64-127.
constexpr int kQBoxBytes = kBlockM * 128;
constexpr int kKVBoxBytes = kBlockN * 128;
constexpr int kQBytes = 2 * kQBoxBytes;
constexpr int kKVBytes = 2 * kKVBoxBytes;
// shared memory, from a 1024-byte aligned base: Q, K[kStages], V[kStages],
// the mbarriers, the cls row's scratch
constexpr int kQOffset = 0;
constexpr int kKOffset = kQBytes;
constexpr int kVOffset = kKOffset + kStages * kKVBytes;
constexpr int kBarrierOffset = kVOffset + kStages * kKVBytes;
constexpr int kScratchOffset = kBarrierOffset + 128;
constexpr int kAlignSlack = 1024;
// mbarriers (8 bytes each) at kBarrierOffset
constexpr int kQFull = 0, kQEmpty = 1, kKFull = 2, kKEmpty = kKFull + kStages,
              kVFull = kKEmpty + kStages, kVEmpty = kVFull + kStages;
static_assert(8 * (kVEmpty + kStages) <= 128, "the barriers' room");

// The cls query rows (kCls), computed by the producer warpgroup once its
// copies are under way: keys of a chunk scored at once, one key per thread and
// pass, and the P.V partial sums of kClsSlices key slices for each of the
// kSlots 8-wide column groups.
constexpr int kClsChunk = 1024;
constexpr int kClsSlices = kProducerThreads / kSlots;
constexpr int kScratchBytes = (kClsChunk + kClsSlices * kDp + 2 * kDp + 2 * 4) * 4;

constexpr int smem_bytes(bool cls) {
  return kScratchOffset + (cls ? kScratchBytes : 0) + kAlignSlack;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long qb, qh, qs;  // element strides over (b, h, s)
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  // kCls only: the cls query, key and value [B, H, 1, D] and the cls output
  const __nv_bfloat16* qc;
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  __nv_bfloat16* out_c;
  long long cb, ch;    // qc/kc/vc strides over (b, h)
  long long ocb, och;  // out_c strides
  int B, H, S, D;      // S queries and S keys (kCls: the N patch tokens)
  float scale_log2;    // multiplies every score (kScaled only)
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory, rounded up to the 1024 bytes over which
// the 128-byte swizzle repeats.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlignSlack - (smem_u32(raw) & (kAlignSlack - 1))) & (kAlignSlack - 1));
}

// Copies 16 bytes asynchronously, or (bytes = 0) writes 16 zero bytes without
// reading the source.
__device__ __forceinline__ void cp_async16(unsigned char* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

// ---- mbarriers: `bar` is the shared-memory address of one ----
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives on the barrier once all cp.async copies that this thread has started
// so far have landed (the arrival is one of those the barrier was set up to
// expect).
__device__ __forceinline__ void mbarrier_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// Makes shared-memory writes (cp.async, plain stores) that this thread has
// observed visible to wgmma, which reads shared memory through the async
// proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the producer warps alone.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending of the warpgroup's wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving uses of an accumulator across the wait that
// completes the wgmma writing it.
template <int kN>
__device__ __forceinline__ void fence_registers(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: the start
// address, the leading and the stride byte offsets in 16-byte units, and
// layout type 1 (128-byte swizzle) in the top bits.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q, K: the depth runs along the 128-byte row): groups of 8
// rows lie 1024 bytes apart; the leading offset is not used.
__device__ __forceinline__ uint64_t make_desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// MN-major operand (V as B: the output column runs along the 128-byte row):
// the next 64 columns lie a box further, groups of 8 keys 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc_mn_major(uint32_t addr) {
  return make_desc(addr, kKVBoxBytes, 1024);
}

__device__ __forceinline__ uint64_t advance_desc(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}

// d (64 x 64, f32) = a (64 x 16, shared, K-major) * b (64 x 16, shared, K-major) + d;
// scale_d = 0 starts the sum at zero.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 88, f32) += a (64 x 16, registers) * b (16 x 88, shared, MN-major: the
// descriptor transposes it).
__device__ __forceinline__ void wgmma_m64n88k16_rs(float (&d)[44], uint32_t a0,
                                                    uint32_t a1, uint32_t a2, uint32_t a3,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b));
}

// d (64 x 96, f32) += a (64 x 16, registers) * b (16 x 96, shared, MN-major: the
// descriptor transposes it).
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], uint32_t a0,
                                                    uint32_t a1, uint32_t a2, uint32_t a3,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b));
}

template <int kOutN>
__device__ __forceinline__ void wgmma_pv(float (&d)[kOutN / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b) {
  static_assert(kOutN == 88 || kOutN == 96, "the two widths of P V that are compiled");
  if constexpr (kOutN == 88) {
    wgmma_m64n88k16_rs(d, a0, a1, a2, a3, desc_b);
  } else {
    wgmma_m64n96k16_rs(d, a0, a1, a2, a3, desc_b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special function unit (one instruction; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of the 16-byte chunk `slot` (8 columns) of row r in a tile
// whose column boxes are box_bytes apart.
__device__ __forceinline__ int tile_offset(int r, int slot, int box_bytes) {
  return (slot >> 3) * box_bytes + r * 128 + (((slot & 7) ^ (r & 7)) << 4);
}

// The producer's copy of the kRows rows from row r0 on, D bf16 values each,
// into a swizzled tile; every producer thread takes the same share. Rows at
// or past `rows` are zero-filled, so that masked keys contribute 0 * 0 and
// never a stale or undefined value. Columns [D, 96) are never written.
template <int kRows>
__device__ __forceinline__ void load_rows(unsigned char* tile, const __nv_bfloat16* g,
                                          long long row_stride, int r0, int rows, int D,
                                          int ptid) {
  static_assert(kRows * kSlots % kProducerThreads == 0, "an equal share for every thread");
#pragma unroll 6
  for (int i = 0; i < kRows * kSlots / kProducerThreads; ++i) {
    const int c = ptid + i * kProducerThreads;
    const int r = c / kSlots, slot = c - r * kSlots;
    if (slot * 8 < D) {
      const bool in = r0 + r < rows;
      cp_async16(tile + tile_offset(r, slot, kRows * 128),
                 g + (in ? (r0 + r) * row_stride + slot * 8 : 0), in ? 16 : 0);
    }
  }
}

// Zeroes columns [D, 96) of every tile once: tile loads only ever write
// columns [0, D), and Q K^T runs over a depth of 96.
__device__ __forceinline__ void zero_head_padding(unsigned char* smem, int D) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < kBlockM * kSlots; c += kThreads) {
    const int row = c / kSlots, slot = c - row * kSlots;
    if (slot * 8 >= D)
      *reinterpret_cast<uint4*>(smem + kQOffset + tile_offset(row, slot, kQBoxBytes)) = zero;
  }
  for (int c = threadIdx.x; c < 2 * kStages * kBlockN * kSlots; c += kThreads) {
    const int row = c / kSlots, slot = c - row * kSlots;
    if (slot * 8 >= D)
      *reinterpret_cast<uint4*>(smem + kKOffset + (row / kBlockN) * kKVBytes +
                                tile_offset(row % kBlockN, slot, kKVBoxBytes)) = zero;
  }
}

// The index of the thread's warpgroup, in a form that the compiler knows to
// be the same in every thread of a warp: a branch on it does not diverge.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The wgmma accumulator layout: warp w of the block owns rows 16 w .. 16 w +
// 15 (warps 4 g .. 4 g + 3 are warpgroup g), a thread the rows lane / 4 and
// lane / 4 + 8 of them; register 4 j + e holds column 8 j + 2 (lane % 4) +
// (e & 1) of the first row (e < 2) or the second. A quad shares its rows.

// One online-softmax step (log2 domain) for the thread's two rows on raw
// scores s. The running maxima m0, m1 live in the scaled domain: with kScaled
// the weights are exp2(s * c - m), one fused multiply-add before the
// exponential (c > 0, so the maximum of the scaled scores is c times the raw
// maximum); without it c is 1 and no multiply is made. Raises the maxima to
// the tile's, rescales the partial row sums l, turns the scores into weights
// added to l, and returns in corr0, corr1 the factors that the output rows
// are to be multiplied by before this tile's P V is added. kGuard: a row
// whose every score so far is masked to -inf keeps weights of 0 (its maximum
// is taken as 0 so that no inf - inf arises); rows seeded with a finite
// maximum need no guard.
template <bool kScaled, bool kGuard>
__device__ __forceinline__ void online_softmax_step(float (&s)[kSRegs], float c, float& m0,
                                                    float& m1, float& l0, float& l1,
                                                    float& corr0, float& corr1) {
  const float neg_inf = __uint_as_float(0xff800000u);
  float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
  for (int j = 0; j < kSRegs / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (kScaled) {
    mx0 *= c;
    mx1 *= c;
  }
  mx0 = fmaxf(mx0, m0);
  mx1 = fmaxf(mx1, m1);
  const float u0 = kGuard && mx0 == neg_inf ? 0.f : mx0;
  const float u1 = kGuard && mx1 == neg_inf ? 0.f : mx1;
  corr0 = fast_exp2(m0 - u0);
  corr1 = fast_exp2(m1 - u1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kSRegs / 4; ++j) {
    if (kScaled) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], c, -u0));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], c, -u0));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], c, -u1));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], c, -u1));
    } else {
      s[4 * j] = fast_exp2(s[4 * j] - u0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - u0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - u1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - u1);
    }
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// Scores of keys at or past S, and (causal) of keys after the query, become
// -inf. Only a tail tile and the causal diagonal tile come here.
__device__ __forceinline__ void mask_scores(float (&s)[kSRegs], int kt, int S, bool causal,
                                            int qrow0, int lane) {
  const float neg_inf = __uint_as_float(0xff800000u);
#pragma unroll
  for (int i = 0; i < kSRegs; ++i) {
    const int key = kt + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
    const int qrow = (i & 2) ? qrow0 + 8 : qrow0;
    if (key >= S || (causal && key > qrow)) s[i] = neg_inf;
  }
}

// One work item: 256 queries from q0 on of one (b, h), over `tiles` key
// tiles.
struct Item {
  int b, h, q0, tiles;
};

__device__ __forceinline__ Item make_item(const Params& p, int index, int qtiles) {
  Item it;
  const int bh = index / qtiles;
  it.q0 = (index - bh * qtiles) * kBlockM;
  it.b = bh / p.H;
  it.h = bh - it.b * p.H;
  const int k_end = p.causal ? min(p.S, it.q0 + kBlockM) : p.S;
  it.tiles = (k_end + kBlockN - 1) / kBlockN;
  return it;
}

// The place in a ring of kStages buffers, walked in step by the producer and
// the consumers: the buffer and the parity of its present use.
struct Ring {
  int buf = 0, parity = 0;
  __device__ __forceinline__ void advance() {
    if (++buf == kStages) {
      buf = 0;
      parity ^= 1;
    }
  }
};

// The producer warpgroup: for every item Q, K of tile 0, then K of tile
// t + 1 and V of tile t in the order the consumers take them. Before a copy
// into a buffer it waits for the consumers to have left it.
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, int items,
                                        int qtiles) {
  const int ptid = threadIdx.x - kConsumerThreads;
  const uint32_t bars = smem_u32(smem + kBarrierOffset);
  Ring kr, vr;
  int done = 0;  // items so far
  auto load_k = [&](const __nv_bfloat16* kg, int t) {
    mbarrier_wait(bars + 8 * (kKEmpty + kr.buf), kr.parity ^ 1);
    load_rows<kBlockN>(smem + kKOffset + kr.buf * kKVBytes, kg, p.ks, t * kBlockN,
                                 p.S, p.D, ptid);
    mbarrier_arrive_on_copies(bars + 8 * (kKFull + kr.buf));
    kr.advance();
  };
  for (int index = blockIdx.x; index < items; index += gridDim.x, ++done) {
    const Item it = make_item(p, index, qtiles);
    const long long b64 = it.b, h64 = it.h;
    const __nv_bfloat16* kg = p.k + b64 * p.kb + h64 * p.kh;
    const __nv_bfloat16* vg = p.v + b64 * p.vb + h64 * p.vh;
    mbarrier_wait(bars + 8 * kQEmpty, (done & 1) ^ 1);
    load_rows<kBlockM>(smem + kQOffset, p.q + b64 * p.qb + h64 * p.qh, p.qs, it.q0,
                                 p.S, p.D, ptid);
    mbarrier_arrive_on_copies(bars + 8 * kQFull);
    load_k(kg, 0);
    for (int t = 0; t < it.tiles; ++t) {
      if (t + 1 < it.tiles) load_k(kg, t + 1);
      mbarrier_wait(bars + 8 * (kVEmpty + vr.buf), vr.parity ^ 1);
      load_rows<kBlockN>(smem + kVOffset + vr.buf * kKVBytes, vg, p.vs, t * kBlockN,
                                   p.S, p.D, ptid);
      mbarrier_arrive_on_copies(bars + 8 * (kVFull + vr.buf));
      vr.advance();
    }
  }
}

// The single cls query of one (b, h) over the S patch keys and the cls key
// (kCls), by the 128 producer threads on the CUDA cores: 2 * (S + 1) * D
// multiply-adds, nothing beside the patch rows' 2 * S * (S + 1) * D. bf16
// operands, f32 scores and sums; the weights are rounded to bf16 before P.V
// while l sums them unrounded, as in the patch rows. The same online softmax,
// seeded with the cls key (m = s_cc, l = 1, acc = v_c), runs over chunks of
// kClsChunk keys.
template <bool kScaled>
__device__ __forceinline__ void cls_query_row(const Params& p, float* scratch, int b, int h) {
  constexpr int kWarpsHere = kProducerThreads / 32;
  float* sS = scratch;                    // [kClsChunk] scores, then weights
  float* sPart = sS + kClsChunk;          // [kClsSlices][kDp] P.V partial sums
  float* sQc = sPart + kClsSlices * kDp;  // [kDp] the cls query
  float* sAcc = sQc + kDp;                // [kDp] the running output row
  float* sRed = sAcc + kDp;               // [2][kWarpsHere] reductions over the warps
  const int tid = threadIdx.x - kConsumerThreads, warp = tid >> 5, lane = tid & 31;
  const int chunks = p.D >> 3;
  const long long b64 = b, h64 = h;
  const long long cbh = b64 * p.cb + h64 * p.ch;
  const __nv_bfloat16* kg = p.k + b64 * p.kb + h64 * p.kh;
  const __nv_bfloat16* vg = p.v + b64 * p.vb + h64 * p.vh;

  producer_sync();   // the previous row's scratch is consumed
  float part = 0.f;  // this thread's share of q_c . k_c
  if (tid < kDp) {
    const bool in = tid < p.D;
    const float qv = in ? __bfloat162float(p.qc[cbh + tid]) : 0.f;
    sQc[tid] = qv;
    sAcc[tid] = in ? __bfloat162float(p.vc[cbh + tid]) : 0.f;
    part = in ? qv * __bfloat162float(p.kc[cbh + tid]) : 0.f;
  }
  part = warp_sum(part);
  if (lane == 0) sRed[warp] = part;
  producer_sync();
  float m_run = 0.f;
#pragma unroll
  for (int i = 0; i < kWarpsHere; ++i) m_run += sRed[i];
  if (kScaled) m_run *= p.scale_log2;
  float l_run = 1.f;

  for (int c0 = 0; c0 < p.S; c0 += kClsChunk) {
    const int cn = min(kClsChunk, p.S - c0);
    producer_sync();  // the previous chunk's weights and sums are consumed
    // scores: a key per thread
    float mx = __uint_as_float(0xff800000u);
    for (int j = tid; j < cn; j += kProducerThreads) {
      const __nv_bfloat16* row = kg + (c0 + j) * p.ks;
      float dot = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < chunks; ++cc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + cc * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          dot = fmaf(f.x, sQc[cc * 8 + 2 * e], dot);
          dot = fmaf(f.y, sQc[cc * 8 + 2 * e + 1], dot);
        }
      }
      if (kScaled) dot *= p.scale_log2;
      sS[j] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = warp_max(mx);
    if (lane == 0) sRed[warp] = mx;
    producer_sync();
    float m_new = m_run;
#pragma unroll
    for (int i = 0; i < kWarpsHere; ++i) m_new = fmaxf(m_new, sRed[i]);
    // weights: summed unrounded, stored rounded to bf16
    float lsum = 0.f;
    for (int j = tid; j < cn; j += kProducerThreads) {
      const float wt = fast_exp2(sS[j] - m_new);
      lsum += wt;
      sS[j] = __bfloat162float(__float2bfloat16(wt));
    }
    lsum = warp_sum(lsum);
    if (lane == 0) sRed[kWarpsHere + warp] = lsum;
    producer_sync();
    // P.V: thread (slice, column group) sums its keys for 8 columns
    const int slice = tid / kSlots, cc = tid - slice * kSlots;
    if (slice < kClsSlices && cc < chunks) {
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = slice; j < cn; j += kClsSlices) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vg + (c0 + j) * p.vs + cc * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float wt = sS[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          a[2 * e] = fmaf(wt, f.x, a[2 * e]);
          a[2 * e + 1] = fmaf(wt, f.y, a[2 * e + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sPart[slice * kDp + cc * 8 + e] = a[e];
    }
    producer_sync();
    const float corr = fast_exp2(m_run - m_new);
    float ladd = 0.f;
#pragma unroll
    for (int i = 0; i < kWarpsHere; ++i) ladd += sRed[kWarpsHere + i];
    l_run = l_run * corr + ladd;
    m_run = m_new;
    if (tid < p.D) {
      float sum = 0.f;
      for (int sl = 0; sl < kClsSlices; ++sl) sum += sPart[sl * kDp + tid];
      sAcc[tid] = sAcc[tid] * corr + sum;
    }
  }
  if (tid < p.D) p.out_c[b64 * p.ocb + h64 * p.och + tid] = __float2bfloat16(sAcc[tid] / l_run);
}

// The online-softmax state of a thread's two rows of one row block (l as
// per-thread partials that the quad adds up at the end) and the factors that
// the output rows take before the next P V is added.
struct RowState {
  float m0, m1, l0, l1, corr0, corr1;
};

// The consumer warps: the attention of every item. A warpgroup owns 128
// queries as two row blocks of 64, A and B, and keeps the tensor cores fed
// with one block's products while it runs the other's softmax: for key tile
// t it starts S_A(t + 1), O_A += P_A V(t), S_B(t + 1), O_B += P_B V(t) as
// four groups, then takes them up in that order.
template <int kOutN, bool kScaled, bool kCls>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, int items,
                                        int qtiles) {
  constexpr bool kGuard = !kCls;  // rows seeded from the cls key start finite
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warpgroup_index();
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kBarrierOffset;
  // row block rb of the warpgroup starts (wg * 2 + rb) * 64 rows into each box
  const uint64_t desc_qa = make_desc_k_major(base + kQOffset + (wg * 2) * 64 * 128);
  const uint64_t desc_qb = make_desc_k_major(base + kQOffset + (wg * 2 + 1) * 64 * 128);
  const uint64_t desc_k = make_desc_k_major(base + kKOffset);
  const uint64_t desc_v = make_desc_mn_major(base + kVOffset);
  const float c = p.scale_log2;
  const float neg_inf = __uint_as_float(0xff800000u);
  Ring kr, vr;
  int done = 0;  // items so far

  // one arrival a warp: every warp of a warpgroup reads all of a K or V tile
  auto release = [&](int barrier) {
    if (lane == 0) mbarrier_arrive(bars + 8 * barrier);
  };
  auto await = [&](int barrier, int parity) {
    mbarrier_wait(bars + 8 * barrier, parity);
    __syncwarp();  // wgmma is warp-aligned: the lanes converged after the wait
    fence_proxy_async();
  };

  for (int index = blockIdx.x; index < items; index += gridDim.x, ++done) {
    const Item it = make_item(p, index, qtiles);
    const long long b64 = it.b, h64 = it.h;
    // the thread's rows in the Q tile: ra, ra + 8 (block A), rb, rb + 8 (B)
    const int ra = wg * 128 + (warp & 3) * 16 + (lane >> 2), rb = ra + 64;
    // a warpgroup whose 128 queries do not exist only hands the buffers on
    const bool active = it.q0 + wg * 128 < p.S;

    await(kQFull, done & 1);
    if (!active) {
      // the same waits and releases in the same order, no work
      await(kKFull + kr.buf, kr.parity);
      release(kKEmpty + kr.buf);
      kr.advance();
      for (int t = 0; t < it.tiles; ++t) {
        if (t + 1 < it.tiles) {
          await(kKFull + kr.buf, kr.parity);
          release(kKEmpty + kr.buf);
          kr.advance();
        }
        await(kVFull + vr.buf, vr.parity);
        release(kVEmpty + vr.buf);
        vr.advance();
      }
      release(kQEmpty);
      continue;
    }

    float sa[kSRegs], sb[kSRegs];
    uint32_t wa[kSRegs / 2], wb[kSRegs / 2];
    float oa[kOutN / 2], ob[kOutN / 2];
    RowState xa, xb;

    // S = Q K^T of one key tile: depth steps 0-3 in the first column box,
    // 4-5 in the second, 32 bytes apart along the row.
    auto start_scores = [&](float (&s)[kSRegs], uint64_t desc_q, int buf) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        wgmma_m64n64k16_ss(
            s, advance_desc(desc_q, (kk >> 2) * kQBoxBytes + (kk & 3) * 32),
            advance_desc(desc_k, buf * kKVBytes + (kk >> 2) * kKVBoxBytes + (kk & 3) * 32),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: 16 keys a step, 16 * 128 bytes apart in the V tile
    auto start_output = [&](float (&o)[kOutN / 2], const uint32_t (&w)[kSRegs / 2], int buf) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_pv<kOutN>(o, w[4 * kk], w[4 * kk + 1], w[4 * kk + 2], w[4 * kk + 3],
                        advance_desc(desc_v, buf * kKVBytes + kk * 16 * 128));
      }
      wgmma_commit();
    };
    auto rescale_output = [&](float (&o)[kOutN / 2], const RowState& x) {
#pragma unroll
      for (int j = 0; j < kOutN / 8; ++j) {
        o[4 * j] *= x.corr0;
        o[4 * j + 1] *= x.corr0;
        o[4 * j + 2] *= x.corr1;
        o[4 * j + 3] *= x.corr1;
      }
    };
    // the softmax of a row block's scores of tile t; only a tail tile and
    // (causal) tiles that reach past the block's first query are masked
    auto softmax = [&](float (&s)[kSRegs], RowState& x, int r, int t) {
      const int kt = t * kBlockN;
      if (kt + kBlockN > p.S || (p.causal && kt + kBlockN - 1 > it.q0 + r - (lane >> 2)))
        mask_scores(s, kt, p.S, p.causal != 0, it.q0 + r, lane);
      online_softmax_step<kScaled, kGuard>(s, c, x.m0, x.m1, x.l0, x.l1, x.corr0, x.corr1);
    };
    auto round_weights = [&](uint32_t (&w)[kSRegs / 2], const float (&s)[kSRegs]) {
#pragma unroll
      for (int i = 0; i < kSRegs / 2; ++i) w[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    // the seeds of the online softmax of the row block whose first row is r
    auto seed = [&](float (&o)[kOutN / 2], RowState& x, int r) {
      x.corr0 = x.corr1 = 1.f;
      if constexpr (kCls) {
        // the cls key: m = s_c, l = 1, o = v_c. Each thread of a quad takes
        // every fourth 16-byte chunk of its rows in the swizzled Q tile; l
        // is kept as per-thread partials, so one thread of the quad starts
        // at 1.
        const __nv_bfloat16* kc = p.kc + b64 * p.cb + h64 * p.ch;
        const __nv_bfloat16* vc = p.vc + b64 * p.cb + h64 * p.ch;
        float sc0 = 0.f, sc1 = 0.f;
        for (int slot = lane & 3; slot * 8 < p.D; slot += 4) {
          const uint4 u = *reinterpret_cast<const uint4*>(smem + kQOffset +
                                                          tile_offset(r, slot, kQBoxBytes));
          const uint4 v = *reinterpret_cast<const uint4*>(smem + kQOffset +
                                                          tile_offset(r + 8, slot, kQBoxBytes));
          const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&u);
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fu = __bfloat1622float2(u2[e]), fv = __bfloat1622float2(v2[e]);
            const float k0 = __bfloat162float(kc[slot * 8 + 2 * e]);
            const float k1 = __bfloat162float(kc[slot * 8 + 2 * e + 1]);
            sc0 += fu.x * k0 + fu.y * k1;
            sc1 += fv.x * k0 + fv.y * k1;
          }
        }
        x.m0 = quad_sum(sc0);
        x.m1 = quad_sum(sc1);
        if (kScaled) {
          x.m0 *= c;
          x.m1 *= c;
        }
        x.l0 = x.l1 = (lane & 3) == 0 ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < kOutN / 8; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          o[4 * j] = o[4 * j + 2] = col < p.D ? __bfloat162float(vc[col]) : 0.f;
          o[4 * j + 1] = o[4 * j + 3] = col < p.D ? __bfloat162float(vc[col + 1]) : 0.f;
        }
      } else {
        x.m0 = x.m1 = neg_inf;
        x.l0 = x.l1 = 0.f;
#pragma unroll
        for (int i = 0; i < kOutN / 2; ++i) o[i] = 0.f;
      }
    };
    // o / l as bf16; rows at or past S and columns at or past D are not
    // stored. A fully masked row (l = 0) gives zeros.
    auto store = [&](const float (&o)[kOutN / 2], const RowState& x, int r) {
      const float l0 = quad_sum(x.l0), l1 = quad_sum(x.l1);
      const float inv0 = 1.f / (kGuard ? fmaxf(l0, 1e-30f) : l0);
      const float inv1 = 1.f / (kGuard ? fmaxf(l1, 1e-30f) : l1);
      __nv_bfloat16* og = p.out + b64 * p.ob + h64 * p.oh;
      const int qrow = it.q0 + r;
#pragma unroll
      for (int j = 0; j < kOutN / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < p.D) {
          if (qrow < p.S)
            *reinterpret_cast<__nv_bfloat162*>(og + qrow * p.os + col) =
                __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
          if (qrow + 8 < p.S)
            *reinterpret_cast<__nv_bfloat162*>(og + (qrow + 8) * p.os + col) =
                __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
    };

    seed(oa, xa, ra);
    seed(ob, xb, rb);

    // the scores of tile 0
    await(kKFull + kr.buf, kr.parity);
    wgmma_fence();
    start_scores(sa, desc_qa, kr.buf);
    start_scores(sb, desc_qb, kr.buf);
    wgmma_wait<1>();
    fence_registers(sa);
    softmax(sa, xa, ra, 0);
    round_weights(wa, sa);
    wgmma_wait<0>();
    fence_registers(sb);
    release(kKEmpty + kr.buf);
    kr.advance();
    if (it.tiles == 1) release(kQEmpty);
    softmax(sb, xb, rb, 0);
    round_weights(wb, sb);

    for (int t = 0; t + 1 < it.tiles; ++t) {
      await(kKFull + kr.buf, kr.parity);
      await(kVFull + vr.buf, vr.parity);
      rescale_output(oa, xa);
      rescale_output(ob, xb);
      wgmma_fence();
      start_scores(sa, desc_qa, kr.buf);
      start_output(oa, wa, vr.buf);
      start_scores(sb, desc_qb, kr.buf);
      start_output(ob, wb, vr.buf);
      wgmma_wait<3>();  // S_A of tile t + 1
      fence_registers(sa);
      softmax(sa, xa, ra, t + 1);
      wgmma_wait<2>();  // O_A of tile t: P_A may be overwritten
      fence_registers(oa);
      round_weights(wa, sa);
      wgmma_wait<1>();  // S_B of tile t + 1: K and (on the last tile) Q are read
      fence_registers(sb);
      release(kKEmpty + kr.buf);
      kr.advance();
      if (t + 2 == it.tiles) release(kQEmpty);
      softmax(sb, xb, rb, t + 1);
      wgmma_wait<0>();  // O_B of tile t: V is read
      fence_registers(ob);
      release(kVEmpty + vr.buf);
      vr.advance();
      round_weights(wb, sb);
    }

    await(kVFull + vr.buf, vr.parity);
    rescale_output(oa, xa);
    rescale_output(ob, xb);
    wgmma_fence();
    start_output(oa, wa, vr.buf);
    start_output(ob, wb, vr.buf);
    wgmma_wait<1>();
    fence_registers(oa);
    store(oa, xa, ra);
    wgmma_wait<0>();
    fence_registers(ob);
    release(kVEmpty + vr.buf);
    vr.advance();
    store(ob, xb, rb);
  }
}

// kOutN: the width of the P V product, 88 for head dims up to 88, else 96.
// kScaled: every score is multiplied by p.scale_log2, folded into the
// exponent's multiply-add; without it no multiply is made (q arrives
// pre-scaled). kCls: the cls-split form.
template <int kOutN, bool kScaled, bool kCls>
__global__ void __launch_bounds__(kThreads, 1) attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int qtiles = (p.S + kBlockM - 1) / kBlockM;
  const int items = p.B * p.H * qtiles;

  zero_head_padding(smem, p.D);
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem + kBarrierOffset);
    // full: every producer thread arrives when its copies have landed;
    // empty: one arrival a consumer warp
    mbarrier_init(bars + 8 * kQFull, kProducerThreads);
    mbarrier_init(bars + 8 * kQEmpty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      mbarrier_init(bars + 8 * (kKFull + i), kProducerThreads);
      mbarrier_init(bars + 8 * (kKEmpty + i), kConsumerWarps);
      mbarrier_init(bars + 8 * (kVFull + i), kProducerThreads);
      mbarrier_init(bars + 8 * (kVEmpty + i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // From here on the roles never meet again.
  if (warpgroup_index() == kConsumerThreads / 128) {
    give_registers<kProducerRegs>();
    produce(p, smem, items, qtiles);
    if constexpr (kCls) {
      // the cls rows, while the consumers finish their last items
      float* scratch = reinterpret_cast<float*>(smem + kScratchOffset);
      for (int bh = blockIdx.x; bh < p.B * p.H; bh += gridDim.x)
        cls_query_row<kScaled>(p, scratch, bh / p.H, bh % p.H);
    }
  } else {
    take_registers<kConsumerRegs>();
    consume<kOutN, kScaled, kCls>(p, smem, items, qtiles);
  }
}

// Launches the kernel on as many blocks as the card has multiprocessors (one
// block fills one), or fewer if there is less work.
template <bool kCls>
inline cudaError_t launch_attention(const Params& p, cudaStream_t stream) {
  const bool scaled = !kCls || p.scale_log2 != 1.f;
  const bool wide = p.D > 88;
  auto kernel = attention_kernel<88, true, kCls>;
  if (wide) kernel = attention_kernel<96, true, kCls>;
  if constexpr (kCls) {
    if (!scaled) kernel = wide ? attention_kernel<96, false, true> : attention_kernel<88, false, true>;
  }
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int qtiles = (p.S + kBlockM - 1) / kBlockM;
  const long long items = static_cast<long long>(p.B) * p.H * qtiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(kCls));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem_bytes(kCls), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cgpt_attn
