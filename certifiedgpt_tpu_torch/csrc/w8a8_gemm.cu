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
// Only wgmma reaches that rate (sm80 mma.sync runs at half of it or less),
// and only when its operands come from shared memory as fast as it takes
// them, so the design is the one Hopper was built for:
// - A block owns a 128 x BN tile of the output. One producer warp brings
//   the A tile (128 rows x 128 K bytes) and the B tile (BN channels x 128 K
//   bytes) of each K step into a ring of 4-8 shared-memory stages with the
//   tensor memory accelerator (2-D tensor maps, 128-byte swizzle: the
//   layout wgmma's K-major descriptors read), each stage completing on an
//   mbarrier; empty barriers hand it back. Rows and channels past the edge
//   and K past its end are zero-filled by the copy.
// - Two consumer warpgroups (rows 0-63 and 64-127) issue wgmma m64nBNk32
//   s8 x s8 -> s32, four a stage, straight from shared memory into int32
//   registers, one stage's group in flight while the next is issued; the
//   producer gives its registers to them (setmaxnreg).
// - BN is 256, 176 or 64 (compiled instances), chosen per launch by the
//   waves of tiles the card runs: 176 divides 1408 and 4224, 256 divides
//   6144, 4096 and 11008, and 64 spreads a single row tile (a cls stream,
//   eval's 8 rows, a caption's 1) over more SMs.
// - Tiles run in groups of 8 row tiles, so the blocks on the card at once
//   share A panels and B's channel tiles in the L2 cache.
// - The epilogue converts, rescales and rounds in registers, stages the
//   tile in the ring's shared memory (padded rows: no bank conflicts) and
//   writes it with 16-byte stores, clipped at the edges. The int32 sums
//   never reach device memory.
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
constexpr int kRingBytes = 196608;
constexpr int kMaxStages = 8;
constexpr int kGroupM = 8;      // row tiles a raster group
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 * 128 * 232 + 128 * 40 <= 65536
constexpr int kAlignSlack = 1024;   // the 128-byte swizzle repeats over 1024 bytes

enum OutKind { kOutBf16 = 0, kOutF32 = 1, kOutI32 = 2 };

template <int BN>
struct Tile {
  static constexpr int kABytes = kBlockM * kBlockK;
  static constexpr int kBBytes = BN * kBlockK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes < kMaxStages ? kRingBytes / kStageBytes : kMaxStages;
  static constexpr int kBarOffset = kStages * kStageBytes;
  // full barriers, then empty barriers, 8 bytes each
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + kAlignSlack;
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
};

// bytes of an output row in the staging area: padded so that the eight rows
// a warp writes at once fall on distinct banks
template <int BN, int kOut>
__host__ __device__ constexpr int stage_pitch() {
  return kOut == kOutBf16 ? BN * 2 + 16 : BN * 4 + 32;
}

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

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity is complete; a wait
// that never ends (a fault of the pipeline's order) traps instead of hanging.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
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

template <int kRegs>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// a barrier of `count` threads on hardware barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
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

// The epilogue's rounding of one value: the w8a8_epilogue kernel's.
__device__ __forceinline__ uint16_t rescale_bf16(int32_t a, float x, float w, bool has_bias,
                                                 float b) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(a), x), w));
  if (has_bias) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
  uint16_t u;
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
  unsigned char* out;  // [M, N] with row stride ldo elements
  long long ldo;
  int M, N, K;
};

// The tile (row tile, channel tile) of block t: groups of kGroupM row
// tiles, channel tiles in turn within a group, so that the blocks resident
// at once read few A panels and few B channel tiles.
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n, int* m, int* n) {
  const int per_group = kGroupM * tiles_n;
  const int g = t / per_group;
  const int first = g * kGroupM;
  const int rows = tiles_m - first < kGroupM ? tiles_m - first : kGroupM;
  const int r = t - g * per_group;
  *m = first + r % rows;
  *n = r / rows;
}

template <int BN, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, const Args p) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + T::kBarOffset;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * T::kStages;
  const int tiles_m = (p.M + kBlockM - 1) / kBlockM;
  const int tiles_n = (p.N + BN - 1) / BN;
  int m_tile, n_tile;
  tile_of(blockIdx.x, tiles_m, tiles_n, &m_tile, &n_tile);
  const int k_steps = (p.K + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      mbarrier_init(full + 8 * s, 1);
      mbarrier_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // From here on the roles never meet again.
  if (wg == 0) {
    give_registers<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int k = 0; k < k_steps; ++k) {
        const int s = k % T::kStages;
        mbarrier_wait(empty + 8 * s, ((k / T::kStages) & 1) ^ 1);
        expect_bytes(full + 8 * s, T::kStageBytes);
        const uint32_t dst = base + s * T::kStageBytes;
        load_box(dst, &a_map, k * kBlockK, m_tile * kBlockM, full + 8 * s);
        load_box(dst + T::kABytes, &b_map, k * kBlockK, n_tile * BN, full + 8 * s);
      }
    }
    return;
  }

  take_registers<kConsumerRegs>();
  const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
  // the sums start at zero in the first wgmma (scale-d 0): an instruction
  // of another kind writing them would make ptxas serialize the wgmmas
  int32_t acc[BN / 2];
  const uint64_t desc_a = make_desc(base + c * 64 * kBlockK);
  const uint64_t desc_b = make_desc(base + T::kABytes);
  for (int k = 0; k < k_steps; ++k) {
    const int s = k % T::kStages;
    mbarrier_wait(full + 8 * s, (k / T::kStages) & 1);
    const uint64_t at = static_cast<uint64_t>((s * T::kStageBytes) >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 32; ++kk) {
      wgmma_tile<BN>(acc, desc_a + at + 2 * kk, desc_b + at + 2 * kk,  // + 32 bytes of K
                     k > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    fence_registers(acc);
    if (k > 0 && threadIdx.x % 128 == 0) mbarrier_arrive(empty + 8 * ((k - 1) % T::kStages));
  }
  wgmma_wait<0>();
  fence_registers(acc);

  // Both warpgroups are done with the ring: it stages the output tile now.
  named_sync(1, 256);
  constexpr int kPitch = stage_pitch<BN, kOut>();
  constexpr int kSize = kOut == kOutBf16 ? 2 : 4;
  static_assert(kBlockM * kPitch <= T::kBarOffset, "the output tile fits the ring");
  unsigned char* stage = smem + c * 64 * kPitch;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8 of the 64
  const int row0 = m_tile * kBlockM + 64 * c + r0;
  const float x0 = (kOut != kOutI32 && row0 < p.M) ? p.xs[row0] : 0.f;
  const float x1 = (kOut != kOutI32 && row0 + 8 < p.M) ? p.xs[row0 + 8] : 0.f;
  const bool has_bias = p.bias != nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const int n = n_tile * BN + col;
    unsigned char* s0 = stage + r0 * kPitch + col * kSize;
    unsigned char* s1 = s0 + 8 * kPitch;
    if constexpr (kOut == kOutI32) {
      *reinterpret_cast<int2*>(s0) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(s1) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      float w0 = 0.f, w1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (n < p.N) {  // N % 8 == 0: a pair is whole or outside
        w0 = p.ws[n];
        w1 = p.ws[n + 1];
        if (has_bias) {
          if constexpr (kOut == kOutBf16) {
            const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
            b0 = __bfloat162float(bias[n]);
            b1 = __bfloat162float(bias[n + 1]);
          } else {
            const float* bias = static_cast<const float*>(p.bias);
            b0 = bias[n];
            b1 = bias[n + 1];
          }
        }
      }
      if constexpr (kOut == kOutBf16) {
        *reinterpret_cast<uint32_t*>(s0) =
            rescale_bf16(acc[4 * j], x0, w0, has_bias, b0) |
            (static_cast<uint32_t>(rescale_bf16(acc[4 * j + 1], x0, w1, has_bias, b1)) << 16);
        *reinterpret_cast<uint32_t*>(s1) =
            rescale_bf16(acc[4 * j + 2], x1, w0, has_bias, b0) |
            (static_cast<uint32_t>(rescale_bf16(acc[4 * j + 3], x1, w1, has_bias, b1)) << 16);
      } else {
        *reinterpret_cast<float2*>(s0) =
            make_float2(rescale_f32(acc[4 * j], x0, w0, has_bias, b0),
                        rescale_f32(acc[4 * j + 1], x0, w1, has_bias, b1));
        *reinterpret_cast<float2*>(s1) =
            make_float2(rescale_f32(acc[4 * j + 2], x1, w0, has_bias, b0),
                        rescale_f32(acc[4 * j + 3], x1, w1, has_bias, b1));
      }
    }
  }
  named_sync(2 + c, 128);  // this warpgroup's 64 rows are staged

  // 16-byte pieces of the staged rows, a warp along a row, clipped at the
  // matrix's edges
  constexpr int kPieces = BN * kSize / 16;  // a row's
  const int tid = threadIdx.x % 128;
  for (int i = tid; i < 64 * kPieces; i += 128) {
    const int r = i / kPieces, piece = i - r * kPieces;
    const int row = m_tile * kBlockM + 64 * c + r;
    const int n = n_tile * BN + piece * (16 / kSize);
    if (row < p.M && n < p.N) {
      *reinterpret_cast<int4*>(p.out + (static_cast<long long>(row) * p.ldo + n) * kSize) =
          *reinterpret_cast<const int4*>(stage + r * kPitch + piece * 16);
    }
  }
}

// The 2-D tensor map of an int8 matrix of `rows` rows of `cols` bytes, row
// stride `ld` bytes, whose box is [box_rows, kBlockK] with the 128-byte
// swizzle; the encoder is looked up once through the runtime.
int encode_map(CUtensorMap* map, const void* base, long long rows, int cols, long long ld,
               int box_rows) {
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
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBlockK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tile widths, widest first
constexpr int kWidths[3] = {256, 176, 64};

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

// The tile width of an M x N product: the fewest waves of resident blocks
// times a tile's cost, taken as its width plus a fixed 32 for its A panel
// and its epilogue; the wider on a tie.
int width_of(long long M, int N, int sms) {
  const long long tiles_m = (M + kBlockM - 1) / kBlockM;
  int best = kWidths[0];
  long long best_cost = -1;
  for (int bn : kWidths) {
    const long long tiles = tiles_m * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + 32);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, int kOut>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const Args& p,
           cudaStream_t stream) {
  using T = Tile<BN>;
  static bool granted[64] = {};  // the shared memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(w8a8_gemm_kernel<BN, kOut>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  const long long tiles =
      static_cast<long long>((p.M + kBlockM - 1) / kBlockM) * ((p.N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  w8a8_gemm_kernel<BN, kOut><<<static_cast<unsigned>(tiles), kThreads, T::kSmemBytes, stream>>>(
      a_map, b_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut>
int launch_width(int bn, const CUtensorMap& a_map, const CUtensorMap& b_map, const Args& p,
                 cudaStream_t stream) {
  if (bn == 256) return launch<256, kOut>(a_map, b_map, p, stream);
  if (bn == 176) return launch<176, kOut>(a_map, b_map, p, stream);
  return launch<64, kOut>(a_map, b_map, p, stream);
}

int stages_of(int bn) {
  return bn == 256 ? Tile<256>::kStages : bn == 176 ? Tile<176>::kStages : Tile<64>::kStages;
}

int smem_of(int bn) {
  return bn == 256 ? Tile<256>::kSmemBytes
                   : bn == 176 ? Tile<176>::kSmemBytes : Tile<64>::kSmemBytes;
}

}  // namespace

// out [M, N] (row stride ldo elements) = the rescaled product of the int8
// rows a [M, K] (row stride lda bytes) and the int8 kernel b, stored as N
// rows of K (column-major [K, N], channel stride ldb bytes): out_kind 0
// bf16 and 1 f32, each with xs [M] and ws [N] f32 and bias [N] in the
// output's dtype or null; 2 the int32 sums (xs, ws, bias unused). K a
// multiple of 16, N of 8; lda, ldb and the output's row in bytes multiples
// of 16; a, b and out 16-byte aligned.
extern "C" int cgpt_w8a8_gemm(const void* a, long long lda, const void* b, long long ldb,
                              const void* xs, const void* ws, const void* bias, void* out,
                              long long ldo, long long M, int N, int K, int out_kind,
                              void* stream) {
  const int size = out_kind == kOutBf16 ? 2 : 4;
  if (M < 0 || M > 0x7fffffffLL || N <= 0 || N % 8 != 0 || K <= 0 || K % 16 != 0 || lda < K ||
      lda % 16 != 0 || ldb < K || ldb % 16 != 0 || ldo < N || (ldo * size) % 16 != 0 ||
      out_kind < kOutBf16 || out_kind > kOutI32 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (out_kind != kOutI32 && (xs == nullptr || ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  int sms = 0;
  int code = device_sms(&sms);
  if (code != 0) return code;
  const int bn = width_of(M, N, sms);
  CUtensorMap a_map, b_map;
  code = encode_map(&a_map, a, M, K, lda, kBlockM);
  if (code != 0) return code;
  code = encode_map(&b_map, b, N, K, ldb, bn);
  if (code != 0) return code;
  const Args p{static_cast<const float*>(xs), static_cast<const float*>(ws), bias,
               static_cast<unsigned char*>(out), ldo, static_cast<int>(M), N, K};
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_kind == kOutBf16) return launch_width<kOutBf16>(bn, a_map, b_map, p, st);
  if (out_kind == kOutF32) return launch_width<kOutF32>(bn, a_map, b_map, p, st);
  return launch_width<kOutI32>(bn, a_map, b_map, p, st);
}

// The launch of an M x N x K product: out[0..5] = tile width, ring stages,
// row tiles, channel tiles, blocks, dynamic shared memory bytes.
extern "C" int cgpt_w8a8_gemm_plan(long long M, int N, int K, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int code = device_sms(&sms);
  if (code != 0) return code;
  const int bn = width_of(M, N, sms);
  const long long tiles_m = (M + kBlockM - 1) / kBlockM, tiles_n = (N + bn - 1) / bn;
  out[0] = bn;
  out[1] = stages_of(bn);
  out[2] = static_cast<int>(tiles_m);
  out[3] = static_cast<int>(tiles_n);
  out[4] = static_cast<int>(tiles_m * tiles_n);
  out[5] = smem_of(bn);
  return 0;
}
