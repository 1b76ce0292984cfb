// The W8A8 product on Hopper (sm_90a): int8 rows times an int8 kernel, the
// rescale and the bias applied to the int32 sums in registers, one launch.
//
// Replaces the XLA fusion of the JAX package's int8 einsum with its rescale
// (certifiedgpt_tpu/ops/quantization.py::w8a8_matmul :68-94, whose f32
// accumulation exists so that XLA folds `* xs * ws` into the product's
// epilogue; w8a8_gelu_matmul :308) and the bias add of
// models/layers.py::dense :50:
//   out[m, n] = bf16(bf16((f32(sum_k xq[m, k] wq[k, n]) * xs[m]) * ws[n]) + bias[n])
// The sum is exact (int32). The two products round one at a time in that
// order with no fused multiply-add, and the bias is added in f32 to the
// bf16-rounded product and rounded again: csrc/w8a8_epilogue.cu's
// `rescale`, so the output is ops/quantization.py::_w8a8_epilogue_plain of
// the exact sum, bit for bit. An f32 instance (the f32 configurations)
// rounds once, and adds the bias in f32; an int32 instance writes the sums
// themselves (the row-parallel dense, which adds its ranks' sums before
// the rescale).
//
// Bound on the H100: operations, at 1979 dense int8 TOP/s. The main path's
// products (2 M K N operations; bytes at 3.35 TB/s stay below):
//   ViT, M = 98304 (96 images x 1024 patches): qkv (K 1408, N 4224) 0.591 ms,
//   proj (1408, 1408) 0.197, fc1 (1408, 6144) 0.859, fc2 (6144, 1408) 0.859;
//   a layer 2.51 ms, 39 layers 97.7 ms a chunk.
//   prefill, M = 9216 (96 prompts x 96): q/k/v/o (4096, 4096) 0.156 each,
//   gate/up (4096, 11008) and down (11008, 4096) 0.420 each; 60.3 ms for 32
//   layers.
//   the cls stream (96 rows), eval (8), a caption (1): bytes, the weight
//   read once (1.98-8.65 MB, 0.6-2.6 us).
// Only wgmma reaches that rate, and only when its operands come from shared
// memory as fast as it takes them, so the design is the one Hopper was
// built for:
// - One producer warp brings the A tile (128 rows x 128 K bytes) and the B
//   tile (BN channels x 128 K bytes) of each K step into a ring of 4-8
//   shared-memory stages with the tensor memory accelerator (2-D tensor
//   maps, 128-byte swizzle: the layout wgmma's K-major descriptors read),
//   each stage completing on an mbarrier; empty barriers hand it back. Rows
//   and channels past the edge and K past its end are zero-filled by the
//   copy. The consumers hold two stages; the rest are in flight.
// - Two consumer warpgroups (rows 0-63 and 64-127 of a 128 x BN tile) issue
//   wgmma m64nBNk32 s8 x s8 -> s32, four a stage, straight from shared
//   memory into int32 registers, one stage's group in flight while the next
//   is issued; the producer gives its registers to them (setmaxnreg).
// - Persistent blocks: as many as the card holds at once, each walking the
//   tiles with a stride in groups of 8 row tiles, so that the blocks on the
//   card at once share A panels and B's channel tiles in L2. The producer
//   runs from one tile's last K step straight into the next tile's first:
//   the ring's barriers and their phases carry across tiles and the ring
//   never drains.
// - Each consumer thread fetches its tile's channel scales and bias and its
//   rows' scales at the tile's start, so the loads land under the products.
//   The epilogue converts, rescales and rounds in registers and stages the
//   tile outside the ring, in boxes of its own (32-byte rows in the 32-byte
//   swizzle: no bank conflicts), which the first thread of each warp stores
//   with TMA (cp.async.bulk.tensor, clipped at the matrix's edges). The
//   producer fills the ring for the next tile while the consumers rescale,
//   and the stores run while they multiply the next tile. The boxes hold
//   half a tile at BN 256 and 176 (the ring keeps four and five stages), so
//   a tile's epilogue takes two rounds, the second once the first's stores
//   have read the boxes. The int32 sums never reach device memory.
// - BN 256 or 176 runs in clusters of two blocks on neighbouring SMs, which
//   take neighbouring row tiles of one channel tile: each loads half of the
//   B tile with a multicast TMA copy into both blocks' rings, so a block
//   reads 128 + BN / 2 K rows a step from L2 for 2 * 128 * BN operations
//   (209 / 256 operations a byte at BN 176 / 256, against 148 / 171 alone).
//   A stage is refilled once the consumers of both blocks have handed it
//   back. A partner whose row tile lies past the edge loads and multiplies
//   nothing of A, writes nothing, and keeps the handshake.
// - BN 64 (clusters of one) serves a single row tile (the cls stream, eval's
//   8 rows, a caption's 1) and spreads it over more SMs; where K is long
//   enough (ops/quantization.py::w8a8_splits), the launcher splits it over
//   several blocks a tile, so that the SMs stream the weight. Each writes
//   its exact int32 partial sums to a scratch the launcher owns, and the
//   block that arrives last at the tile's counter (an atomic) adds the
//   others' partials to its own, rescales, and sets the counter back to zero
//   for the next call. int32 addition is exact and associative, so the
//   output is the same bits in any order.
// - BN is chosen per launch by the waves of work units the card runs: 176
//   divides 1408 and 4224, 256 divides 6144, 4096 and 11008.
// The maps are built on the host at each call (cuTensorMapEncodeTiled,
// looked up through the runtime: no link against libcuda) and passed as
// __grid_constant__ parameters: nothing is allocated and nothing waits, so
// a launch can be captured in a CUDA graph.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kBlockM = 128;    // rows of a tile: two consumer warpgroups of 64
constexpr int kBlockK = 128;    // K values (bytes) of a stage: one swizzled 128-byte row
constexpr int kThreads = 384;   // the producer warpgroup, then two consumer warpgroups
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have on sm_90
constexpr int kMaxStages = 8;
constexpr int kGroupM = 8;      // row tiles a raster group
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 * 128 * 232 + 128 * 40 <= 65536
constexpr int kAlignSlack = 1024;   // the 128-byte swizzle repeats over 1024 bytes
constexpr int kBoxRows = 64;        // output rows a consumer warpgroup stores
constexpr int kBoxRowBytes = 32;    // a stored box's row: one 32-byte swizzle span
constexpr int kBoxBytes = kBoxRows * kBoxRowBytes;
constexpr int kSplitWidth = 64;     // the tile width of a launch that splits K
// full and empty barriers and the split's flag: in the alignment's slack
// before the aligned base, or after the used bytes when that is short
constexpr int kBarBytes = 2 * kMaxStages * 8 + 16;
constexpr int kClusterWide = 2;  // blocks a cluster at the tile widths above kSplitWidth

enum OutKind { kOutBf16 = 0, kOutF32 = 1, kOutI32 = 2 };
// cgpt_w8a8_gemm_plan's epilogue codes: 1, staged apart from the ring and
// stored by TMA while the next tile's products run
constexpr int kEpilogueTmaStore = 1;

template <int BN>
struct Tile {
  static constexpr int kCluster = BN == kSplitWidth ? 1 : kClusterWide;  // blocks sharing B
  static constexpr int kABytes = kBlockM * kBlockK;
  static constexpr int kBBytes = BN * kBlockK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // staged output boxes a warpgroup holds (of the BN / 16 of its 64 rows in
  // bf16, twice that in 4 bytes): few enough to leave the ring four stages
  // at BN 256 and five at 176, since the consumers hold two of them
  static constexpr int kSlots = BN == 256 ? 8 : BN == 176 ? 6 : 4;
  static constexpr int kOutBytes = 2 * kSlots * kBoxBytes;
  // the tile's channel scales and bias (f32), shared by the warpgroups
  static constexpr int kVecBytes = 2 * BN * 4;
  static constexpr int kRoom = kSmemLimit - kAlignSlack - kOutBytes - kVecBytes;
  static constexpr int kStages =
      kRoom / kStageBytes < kMaxStages ? kRoom / kStageBytes : kMaxStages;
  static constexpr int kOutOffset = kStages * kStageBytes;
  static constexpr int kVecOffset = kOutOffset + kOutBytes;
  static constexpr int kUsedBytes = kVecOffset + kVecBytes;
  static constexpr int kSmemBytes = kUsedBytes + kAlignSlack;
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert((kBBytes / kCluster) % 1024 == 0, "a multicast half keeps the alignment");
  static_assert(kStages >= 4, "a ring of at least four stages");
  static_assert(kAlignSlack - kBarBytes >= kBarBytes, "the barriers fit before or after");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlignSlack - (smem_u32(raw) & (kAlignSlack - 1))) & (kAlignSlack - 1));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// an arrival on the barrier at the same offset in the shared memory of the
// cluster's block `rank`. The consumers' arrivals need no cluster-wide
// release: the wgmma reads of the stage they hand back have completed (a
// cluster-scope fence a stage would stall the warpgroup's next wgmma).
__device__ __forceinline__ void mbarrier_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity is complete; a wait
// that never ends (a fault of the pipeline's order) traps instead of hanging.
// The poll loop is one asm block: the compiler sees no branch in it, so it
// cannot move the warp-wide (.aligned) instructions that follow a wait into
// code that the warp's lanes reach at different times.
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a box of the map at (c0 along K, c1 along rows), by the tensor memory
// accelerator, completing on the barrier
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same box into the shared memory of every block of the cluster in
// `mask`, at the same offset, each completing on its barrier at `bar`'s offset
__device__ __forceinline__ void load_box_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// a box of shared memory to the map at (c0 along columns, c1 along rows),
// clipped at the map's edges, in this thread's bulk group
__device__ __forceinline__ void store_box(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before the tensor memory
// accelerator's reads of them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// a barrier of `count` threads on hardware barrier `id` (0 is __syncthreads'),
// the calling warp's lanes converged first (bar.sync is warp-aligned)
__device__ __forceinline__ void named_sync(int id, int count) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving uses of the sums across the wait that
// completes the wgmma writing them
template <int kN>
__device__ __forceinline__ void fence_registers(int32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma descriptor of a K-major, 128-byte-swizzled operand: rows of 128
// bytes, groups of 8 rows 1024 bytes apart (the leading offset unused),
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, s32) = a (64 x 32, shared, K-major) * b (32 x 256, shared, K-major)
// + d; scale_d = 0 starts the sum at zero
__device__ __forceinline__ void wgmma_n256(int32_t (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 176, s32) = a (64 x 32, shared, K-major) * b (32 x 176, shared, K-major)
// + d; scale_d = 0 starts the sum at zero
__device__ __forceinline__ void wgmma_n176(int32_t (&d)[88], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87}, "
      "%88, %89, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, s32) = a (64 x 32, shared, K-major) * b (32 x 64, shared, K-major)
// + d; scale_d = 0 starts the sum at zero
__device__ __forceinline__ void wgmma_n64(int32_t (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(int32_t (&d)[BN / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  if constexpr (BN == 256) {
    wgmma_n256(d, desc_a, desc_b, scale_d);
  } else if constexpr (BN == 176) {
    wgmma_n176(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(BN == 64, "the tile widths that are compiled");
    wgmma_n64(d, desc_a, desc_b, scale_d);
  }
}

// The epilogue's rounding of a pair of values (columns n, n + 1 of a row),
// each the w8a8_epilogue kernel's: the bits of the bf16 pair, n low.
__device__ __forceinline__ uint32_t rescale_bf16x2(int32_t a0, int32_t a1, float x, float2 w,
                                                   bool has_bias, float2 b) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(__int2float_rn(a0), x), w.x),
                                           __fmul_rn(__fmul_rn(__int2float_rn(a1), x), w.y));
  if (has_bias) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(f.x, b.x), __fadd_rn(f.y, b.y));
  }
  uint32_t u;
  memcpy(&u, &y, sizeof(u));
  return u;
}

__device__ __forceinline__ float rescale_f32(int32_t a, float x, float w, bool has_bias,
                                             float b) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(a), x), w);
  return has_bias ? __fadd_rn(y, b) : y;
}

struct Args {
  const float* xs;    // [M] row scales (kOutI32: unused)
  const float* ws;    // [N] channel scales
  const void* bias;   // [N] in the output's dtype, or null
  int4* partials;     // split K: [units][BN / 8][256] int32 partial sums, 4 a thread
  int* counters;      // split K: [tiles] arrivals, zero between calls
  int M, N, K;
  int tiles_m, tiles_n;  // row tiles, channel tiles
  int units;             // (row tiles over the cluster) x channel tiles x splits
  int splits, k_per_split;  // K steps of a split (the last may take fewer)
};

// The tile (row tile, channel tile) of tile index t: groups of `group` row
// tiles, channel tiles in turn within a group, so that the blocks resident
// at once read few A panels and few B channel tiles.
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n, int group, int* m,
                                        int* n) {
  const int per_group = group * tiles_n;
  const int g = t / per_group;
  const int first = g * group;
  const int rows = tiles_m - first < group ? tiles_m - first : group;
  const int r = t - g * per_group;
  *m = first + r % rows;
  *n = r / rows;
}

// A work unit's row tile (this block's, in its cluster's pair), channel
// tile, tile index and K steps [k0, k1).
struct Unit {
  int m_tile, n_tile, tile, k0, k1;
};

template <int kCluster>
__device__ __forceinline__ Unit unit_of(const Args& p, int u, uint32_t rank) {
  Unit w;
  const int split = u % p.splits;
  w.tile = u / p.splits;
  int mc;
  tile_of(w.tile, (p.tiles_m + kCluster - 1) / kCluster, p.tiles_n, kGroupM / kCluster, &mc,
          &w.n_tile);
  w.m_tile = mc * kCluster + static_cast<int>(rank);
  const int k_steps = (p.K + kBlockK - 1) / kBlockK;
  w.k0 = split * p.k_per_split;
  w.k1 = w.k0 + p.k_per_split < k_steps ? w.k0 + p.k_per_split : k_steps;
  return w;
}

// Split K: writes this block's partial sums, counts its arrival at the
// tile; the last to arrive resets the counter, adds the other splits'
// partials to its own and returns true. All 256 consumer threads call it.
template <int BN>
__device__ __forceinline__ bool gather_splits(const Args& p, int u, int tile,
                                              int32_t (&acc)[BN / 2], volatile int* flag) {
  const int ctid = threadIdx.x - 128;
  int4* mine = p.partials + static_cast<long long>(u) * (BN / 8) * 256;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mine[i * 256 + ctid] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __threadfence();
  named_sync(1, 256);
  if (ctid == 0) {
    const int last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    if (last) atomicExch(&p.counters[tile], 0);
    *flag = last;
  }
  named_sync(1, 256);
  if (!*flag) return false;
  __threadfence();
  const int own = u - tile * p.splits;
  for (int s = 0; s < p.splits; ++s) {
    if (s == own) continue;
    const int4* other = p.partials + static_cast<long long>(tile * p.splits + s) * (BN / 8) * 256;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int4 v = __ldcg(other + i * 256 + ctid);
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
  }
  return true;
}

// The byte of a staged box of 32-byte rows at (row, byte of the row) in the
// 32-byte swizzle: 16-byte halves trade places on rows 4-7 of every 8.
__device__ __forceinline__ int swizzle32(int row, int byte) {
  return row * kBoxRowBytes + (((byte >> 4) ^ ((row >> 2) & 1)) << 4) + (byte & 15);
}

// The tile's channel scale and bias of column t (t the consumer thread, of
// 256) and the scales of this thread's two rows, fetched at the tile's
// start so the loads land under the products.
struct Prefetch {
  float w, b, x[2];
};

template <int BN, int kOut>
__device__ __forceinline__ Prefetch prefetch(const Args& p, int m_tile, int n_tile, int c) {
  Prefetch f = {};
  if constexpr (kOut != kOutI32) {
    const int t = threadIdx.x - 128, n = n_tile * BN + t;
    if (t < BN && n < p.N) {
      f.w = p.ws[n];
      if (p.bias != nullptr) {
        f.b = kOut == kOutBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[n])
                               : static_cast<const float*>(p.bias)[n];
      }
    }
    const int row = m_tile * kBlockM + 64 * c + 16 * ((threadIdx.x / 32) % 4) +
                    (threadIdx.x % 32) / 4;
    f.x[0] = row < p.M ? p.xs[row] : 0.f;
    f.x[1] = row + 8 < p.M ? p.xs[row + 8] : 0.f;
  }
  return f;
}

// Rescales and rounds this thread's sums of 8-column group j in place, as
// the bits of the output, the channel scales and bias read from the
// block's copy in shared memory: a bf16 pair (columns c and c + 1 of a row)
// in acc[4 j] (row r0) and acc[4 j + 2] (row r0 + 8), or f32 values in
// each; the int32 sums stay.
template <int BN, int kOut>
__device__ __forceinline__ void rescale_group(int32_t (&acc)[BN / 2], int j, const float* vec,
                                              bool has_bias, const float (&x)[2]) {
  if constexpr (kOut != kOutI32) {
    const int col = 8 * j + 2 * (threadIdx.x % 4);
    const float2 w = *reinterpret_cast<const float2*>(vec + col);
    const float2 b =
        has_bias ? *reinterpret_cast<const float2*>(vec + BN + col) : make_float2(0.f, 0.f);
    if constexpr (kOut == kOutBf16) {
      acc[4 * j] = static_cast<int32_t>(
          rescale_bf16x2(acc[4 * j], acc[4 * j + 1], x[0], w, has_bias, b));
      acc[4 * j + 2] = static_cast<int32_t>(
          rescale_bf16x2(acc[4 * j + 2], acc[4 * j + 3], x[1], w, has_bias, b));
    } else {
      acc[4 * j] = __float_as_int(rescale_f32(acc[4 * j], x[0], w.x, has_bias, b.x));
      acc[4 * j + 1] = __float_as_int(rescale_f32(acc[4 * j + 1], x[0], w.y, has_bias, b.y));
      acc[4 * j + 2] = __float_as_int(rescale_f32(acc[4 * j + 2], x[1], w.x, has_bias, b.x));
      acc[4 * j + 3] = __float_as_int(rescale_f32(acc[4 * j + 3], x[1], w.y, has_bias, b.y));
    }
  }
}

// One consumer warpgroup's epilogue: its 64 rows of the tile rescaled and
// rounded in registers (the scales and bias from both warpgroups'
// prefetches, through shared memory), staged in its boxes kSlots at a time
// and stored with TMA by the first thread of each of its warps, a quarter
// of the boxes each. A round rescales its columns while the last round's
// stores read the boxes, then waits for them (or for the last tile's).
template <int BN, int kOut>
__device__ __forceinline__ void epilogue(const Args& p, const CUtensorMap* o_map,
                                         int32_t (&acc)[BN / 2], const Prefetch& f, int m_tile,
                                         int n_tile, int c, unsigned char* boxes,
                                         uint32_t boxes_u32, float* vec) {
  using T = Tile<BN>;
  constexpr int kSize = kOut == kOutBf16 ? 2 : 4;
  constexpr int kBoxCols = kBoxRowBytes / kSize;  // columns a box holds
  constexpr int kBoxes = BN / kBoxCols;           // of the warpgroup's 64 rows
  constexpr int kRounds = (kBoxes + T::kSlots - 1) / T::kSlots;
  constexpr int kJs = T::kSlots * kBoxCols / 8;   // 8-column groups a round
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8 of the 64
  const int top = m_tile * kBlockM + 64 * c;
  const bool issuer = lane == 0;
  const bool has_bias = p.bias != nullptr;
  if constexpr (kOut != kOutI32) {
    named_sync(1, 256);  // both warpgroups are done with the last tile's copy
    if (threadIdx.x - 128 < BN) {
      vec[threadIdx.x - 128] = f.w;
      vec[BN + threadIdx.x - 128] = f.b;
    }
    named_sync(1, 256);
  }
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
#pragma unroll
    for (int jj = 0; jj < kJs; ++jj) {
      const int j = round * kJs + jj;
      if (j >= BN / 8) break;  // the last round's boxes may be fewer
      rescale_group<BN, kOut>(acc, j, vec, has_bias, f.x);
    }
    if (issuer) bulk_wait_read();  // this warp's last stores have read the boxes
    named_sync(2 + c, 128);
#pragma unroll
    for (int jj = 0; jj < kJs; ++jj) {
      const int j = round * kJs + jj;
      if (j >= BN / 8) break;
      const int col = 8 * j + 2 * (lane % 4);
      const int box = col / kBoxCols - round * T::kSlots;
      const int byte = (col % kBoxCols) * kSize;
      unsigned char* s0 = boxes + box * kBoxBytes + swizzle32(r0, byte);
      unsigned char* s1 = boxes + box * kBoxBytes + swizzle32(r0 + 8, byte);
      if constexpr (kOut == kOutBf16) {
        *reinterpret_cast<int32_t*>(s0) = acc[4 * j];
        *reinterpret_cast<int32_t*>(s1) = acc[4 * j + 2];
      } else {
        *reinterpret_cast<int2*>(s0) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(s1) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    const int boxes_now =
        kBoxes - round * T::kSlots < T::kSlots ? kBoxes - round * T::kSlots : T::kSlots;
    fence_async_shared();
    named_sync(2 + c, 128);  // this round's boxes are staged
    if (issuer && top < p.M) {
#pragma unroll 1
      for (int box = warp; box < boxes_now; box += 4) {
        const int col = n_tile * BN + (round * T::kSlots + box) * kBoxCols;
        if (col < p.N) store_box(o_map, boxes_u32 + box * kBoxBytes, col, top);
      }
      bulk_commit();
    }
  }
}

template <int BN, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap o_map, const Args p) {
  using T = Tile<BN>;
  constexpr int kCluster = T::kCluster;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  // the barriers where the alignment left room: the same offset in every
  // block of the cluster (the same dynamic shared memory base)
  unsigned char* bars = smem - smem_raw >= kBarBytes ? smem_raw : smem + T::kUsedBytes;
  const uint32_t full = smem_u32(bars);  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kMaxStages;
  volatile int* flag = reinterpret_cast<volatile int*>(bars + 16 * kMaxStages);
  const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbarrier_init(full + 8 * s, 1);
      // one arrival a consumer warpgroup of each block of the cluster
      mbarrier_init(empty + 8 * s, 2 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kCluster > 1) {
    cluster_sync();  // the partner's barriers exist before anything lands there
  } else {
    __syncthreads();
  }

  // From here on the roles never meet again.
  if (wg == 0) {
    give_registers<kProducerRegs>();
    if (threadIdx.x == 0) {
      uint32_t it = 0;  // K steps loaded, over every tile of this block
      for (int u = cluster; u < p.units; u += clusters) {
        const Unit w = unit_of<kCluster>(p, u, rank);
        const bool live = w.m_tile < p.tiles_m;
        for (int k = w.k0; k < w.k1; ++k, ++it) {
          const int s = it % S;
          mbarrier_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
          expect_bytes(full + 8 * s, live ? T::kStageBytes : T::kBBytes);
          const uint32_t dst = base + s * T::kStageBytes;
          if (live) load_box(dst, &a_map, k * kBlockK, w.m_tile * kBlockM, full + 8 * s);
          if constexpr (kCluster == 1) {
            load_box(dst + T::kABytes, &b_map, k * kBlockK, w.n_tile * BN, full + 8 * s);
          } else {
            load_box_multicast(dst + T::kABytes + rank * (T::kBBytes / kCluster), &b_map,
                               k * kBlockK, w.n_tile * BN + rank * (BN / kCluster), full + 8 * s,
                               (1 << kCluster) - 1);
          }
        }
      }
      if constexpr (kCluster > 1) {
        // the partner's consumers hand stages back here until their last:
        // the block stays until they all have
        for (int i = 0; i < S; ++i, ++it) {
          mbarrier_wait(empty + 8 * (it % S), ((it / S) & 1) ^ 1);
        }
      }
    }
    return;
  }

  take_registers<kConsumerRegs>();
  const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
  const bool arriver = threadIdx.x % 128 == 0;
  auto release = [&](uint32_t step) {
    if (arriver) {
      const uint32_t bar = empty + 8 * (step % S);
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        if constexpr (kCluster == 1) {
          mbarrier_arrive(bar);
        } else {
          mbarrier_arrive_cluster(bar, r);
        }
      }
    }
  };
  unsigned char* boxes = smem + T::kOutOffset + c * T::kSlots * kBoxBytes;
  const uint32_t boxes_u32 = base + T::kOutOffset + c * T::kSlots * kBoxBytes;
  float* vec = reinterpret_cast<float*>(smem + T::kVecOffset);
  // the sums start at zero in each tile's first wgmma (scale-d 0): an
  // instruction of another kind writing them would make ptxas serialize the
  // wgmmas
  int32_t acc[BN / 2];
  const uint64_t desc_a = make_desc(base + c * 64 * kBlockK);
  const uint64_t desc_b = make_desc(base + T::kABytes);
  uint32_t it = 0;  // K steps consumed, over every tile of this block
  for (int u = cluster; u < p.units; u += clusters) {
    const Unit w = unit_of<kCluster>(p, u, rank);
    if (w.m_tile >= p.tiles_m) {  // the partner past the edge: keep the handshake
      for (int k = w.k0; k < w.k1; ++k, ++it) {
        mbarrier_wait(full + 8 * (it % S), (it / S) & 1);
        release(it);
      }
      continue;
    }
    const Prefetch f = prefetch<BN, kOut>(p, w.m_tile, w.n_tile, c);
    for (int k = w.k0; k < w.k1; ++k, ++it) {
      const int s = it % S;
      mbarrier_wait(full + 8 * s, (it / S) & 1);
      __syncwarp();  // wgmma is warp-aligned: the lanes converged after the wait
      const uint64_t at = static_cast<uint64_t>((s * T::kStageBytes) >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 32; ++kk) {
        wgmma_tile<BN>(acc, desc_a + at + 2 * kk, desc_b + at + 2 * kk,  // + 32 bytes of K
                       k > w.k0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      fence_registers(acc);
      if (k > w.k0) release(it - 1);
    }
    wgmma_wait<0>();
    fence_registers(acc);
    release(it - 1);
    if constexpr (BN == kSplitWidth) {
      if (p.splits > 1 && !gather_splits<BN>(p, u, w.tile, acc, flag)) continue;
    }
    epilogue<BN, kOut>(p, &o_map, acc, f, w.m_tile, w.n_tile, c, boxes, boxes_u32, vec);
  }
  if (threadIdx.x % 32 == 0) bulk_wait();  // the last stores are done before the block ends
}

// The 2-D tensor map of a matrix of `rows` rows of `cols` elements of
// `type`, row stride `ld` bytes, with the box [box_rows, box_cols] in the
// swizzle; the encoder is looked up once through the runtime.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows,
               long long cols, long long ld, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tile widths, widest first
constexpr int kWidths[3] = {256, 176, 64};

int cluster_of(int bn) { return bn == kSplitWidth ? 1 : kClusterWide; }

int device_sms(int* sms) {
  static int sms_of[64] = {};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = sms_of[dev];
  return 0;
}

// The tile width of an M x N product: 64 for a single row tile (the
// launcher may split its K); otherwise the fewest waves of work units (a
// cluster's pair of row tiles and a channel tile) over the clusters the
// card holds, times a tile's cost, taken as its width plus a fixed 32 for
// its A panel and its epilogue; the wider on a tie.
int width_of(long long M, int N, int sms) {
  const long long tiles_m = (M + kBlockM - 1) / kBlockM;
  if (tiles_m == 1) return kSplitWidth;
  int best = kWidths[0];
  long long best_cost = -1;
  for (int bn : kWidths) {
    const int cl = cluster_of(bn);
    const long long units = (tiles_m + cl - 1) / cl * ((N + bn - 1) / bn);
    const long long slots = sms / cl;
    const long long cost = (units + slots - 1) / slots * (bn + 32);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

// The kernel instance's shared memory opt-in (once a device) and the
// clusters of it the card holds at once (asked once a device).
template <int BN, int kOut>
int prepare(int* resident) {
  using T = Tile<BN>;
  static int resident_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident_of[dev] == 0) {
    const void* fn = reinterpret_cast<const void*>(w8a8_gemm_kernel<BN, kOut>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = T::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(T::kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = T::kSmemBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, w8a8_gemm_kernel<BN, kOut>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident_of[dev] = n;
  }
  *resident = resident_of[dev];
  return 0;
}

// The launch's work: row and channel tiles, work units, K splits and the
// K steps of a split.
struct Work {
  int tiles_m, tiles_n, units, splits, k_per_split;
};

int work_of(long long M, int N, int K, int bn, int splits, Work* w) {
  const int cl = cluster_of(bn);
  const int k_steps = (K + kBlockK - 1) / kBlockK;
  w->tiles_m = static_cast<int>((M + kBlockM - 1) / kBlockM);
  w->tiles_n = (N + bn - 1) / bn;
  w->splits = splits;
  w->k_per_split = (k_steps + splits - 1) / splits;
  // every split has K steps of its own
  if (splits < 1 || (splits - 1) * w->k_per_split >= k_steps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units =
      static_cast<long long>((w->tiles_m + cl - 1) / cl) * w->tiles_n * splits;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  w->units = static_cast<int>(units);
  return 0;
}

template <int BN, int kOut>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const CUtensorMap& o_map,
           const Args& p, cudaStream_t stream) {
  using T = Tile<BN>;
  int resident = 0;
  const int code = prepare<BN, kOut>(&resident);
  if (code != 0) return code;
  const int clusters = p.units < resident ? p.units : resident;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * T::kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, w8a8_gemm_kernel<BN, kOut>, a_map, b_map,
                                             o_map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut>
int launch_width(int bn, const CUtensorMap& a_map, const CUtensorMap& b_map,
                 const CUtensorMap& o_map, const Args& p, cudaStream_t stream) {
  if (bn == 256) return launch<256, kOut>(a_map, b_map, o_map, p, stream);
  if (bn == 176) return launch<176, kOut>(a_map, b_map, o_map, p, stream);
  return launch<64, kOut>(a_map, b_map, o_map, p, stream);
}

template <int BN>
int resident_clusters(int* resident) {
  return prepare<BN, kOutBf16>(resident);
}

}  // namespace

// out [M, N] (row stride ldo elements) = the rescaled product of the int8
// rows a [M, K] (row stride lda bytes) and the int8 kernel b, stored as N
// rows of K (column-major [K, N], channel stride ldb bytes): out_kind 0
// bf16 and 1 f32, each with xs [M] and ws [N] f32 and bias [N] in the
// output's dtype or null; 2 the int32 sums (xs, ws, bias unused). K a
// multiple of 16, N of 8; lda, ldb and the output's row in bytes multiples
// of 16; a, b and out 16-byte aligned. `splits` > 1 splits K over that many
// blocks a tile (M <= 128 only; every split must get K steps of its own);
// `scratch` then holds the partial sums of `scratch_units` work units (128 x
// 64 int32 each), then as many int32 tile counters, zero before the first
// call (each call leaves them zero).
extern "C" int cgpt_w8a8_gemm(const void* a, long long lda, const void* b, long long ldb,
                              const void* xs, const void* ws, const void* bias, void* out,
                              long long ldo, long long M, int N, int K, int out_kind,
                              int splits, void* scratch, int scratch_units, void* stream) {
  const int size = out_kind == kOutBf16 ? 2 : 4;
  if (M < 0 || M > 0x7fffffffLL || N <= 0 || N % 8 != 0 || K <= 0 || K % 16 != 0 || lda < K ||
      lda % 16 != 0 || ldb < K || ldb % 16 != 0 || ldo < N || (ldo * size) % 16 != 0 ||
      out_kind < kOutBf16 || out_kind > kOutI32 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (out_kind != kOutI32 && (xs == nullptr || ws == nullptr)) || splits < 1 ||
      (splits > 1 && (M > kBlockM || scratch == nullptr ||
                      reinterpret_cast<uintptr_t>(scratch) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  int sms = 0;
  int code = device_sms(&sms);
  if (code != 0) return code;
  const int bn = width_of(M, N, sms);
  Work w;
  code = work_of(M, N, K, bn, splits, &w);
  if (code != 0) return code;
  if (splits > 1 && w.units > scratch_units) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map, o_map;
  code = encode_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, M, K, lda, kBlockM, kBlockK,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (code != 0) return code;
  code = encode_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, N, K, ldb, bn / cluster_of(bn),
                    kBlockK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (code != 0) return code;
  const CUtensorMapDataType out_type = out_kind == kOutBf16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : out_kind == kOutF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                             : CU_TENSOR_MAP_DATA_TYPE_INT32;
  code = encode_map(&o_map, out_type, out, M, N, ldo * size, kBoxRows, kBoxRowBytes / size,
                    CU_TENSOR_MAP_SWIZZLE_32B);
  if (code != 0) return code;
  int4* partials = static_cast<int4*>(scratch);
  int* counters = splits > 1 ? reinterpret_cast<int*>(partials + static_cast<long long>(
                                   scratch_units) * (kSplitWidth / 8) * 256)
                             : nullptr;
  const Args p{static_cast<const float*>(xs), static_cast<const float*>(ws), bias,
               splits > 1 ? partials : nullptr, counters, static_cast<int>(M), N, K,
               w.tiles_m, w.tiles_n, w.units, w.splits, w.k_per_split};
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_kind == kOutBf16) return launch_width<kOutBf16>(bn, a_map, b_map, o_map, p, st);
  if (out_kind == kOutF32) return launch_width<kOutF32>(bn, a_map, b_map, o_map, p, st);
  return launch_width<kOutI32>(bn, a_map, b_map, o_map, p, st);
}

// The launch of an M x N x K product split `splits` ways along K: out[0..10]
// = tile width, ring stages, row tiles, channel tiles, tiles (times the
// splits), blocks launched (persistent: at most as many clusters as the
// card holds at once), dynamic shared memory bytes, blocks a cluster
// (sharing B by multicast), K splits, K steps a split, the epilogue (1:
// staged apart from the ring, stored by TMA under the next tile's products).
extern "C" int cgpt_w8a8_gemm_plan(long long M, int N, int K, int splits, int* out) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && M > kBlockM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int code = device_sms(&sms);
  if (code != 0) return code;
  const int bn = width_of(M, N, sms);
  Work w;
  code = work_of(M, N, K, bn, splits, &w);
  if (code != 0) return code;
  int resident = 0;
  code = bn == 256 ? resident_clusters<256>(&resident)
                   : bn == 176 ? resident_clusters<176>(&resident)
                               : resident_clusters<64>(&resident);
  if (code != 0) return code;
  const int cl = cluster_of(bn);
  out[0] = bn;
  out[1] = bn == 256 ? Tile<256>::kStages : bn == 176 ? Tile<176>::kStages : Tile<64>::kStages;
  out[2] = w.tiles_m;
  out[3] = w.tiles_n;
  const long long tiles = static_cast<long long>(w.tiles_m) * w.tiles_n * w.splits;
  out[4] = tiles < 0x7fffffffLL ? static_cast<int>(tiles) : 0x7fffffff;
  out[5] = (w.units < resident ? w.units : resident) * cl;
  out[6] = bn == 256 ? Tile<256>::kSmemBytes
                     : bn == 176 ? Tile<176>::kSmemBytes : Tile<64>::kSmemBytes;
  out[7] = cl;
  out[8] = w.splits;
  out[9] = w.k_per_split;
  out[10] = kEpilogueTmaStore;
  return 0;
}
