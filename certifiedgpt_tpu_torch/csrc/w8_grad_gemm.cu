// The straight-through input gradient of the W8A8 product on Hopper
// (sm_90a), reading the int8 kernel itself: one launch, no dequantized
// weight in device memory.
//
// Replaces the XLA fusion of the JAX package's `_w8a8_bwd`
// (certifiedgpt_tpu/ops/quantization.py:102-110), where XLA folds the
// kernel's convert and rescale into the dot:
//   w[k, n]  = bf16(f32(kernel_q[k, n]) * scale[n])
//   gx[m, k] = bf16(sum_n f32(g[m, n]) f32(w[k, n]))
// with g bf16 [M, N], the kernel int8 [K, N] stored column-major (each
// channel n's K values contiguous: ops/quantization.py::int8_kernel_layout),
// f32 sums. Every element of w is rounded exactly as the plain version
// (ops/quantization.py::_dequantized_t) rounds it: the int8 value converted
// exactly, one f32 product, round to nearest even; the scale stays on the
// reduction axis (it cannot be folded into g, which would round otherwise).
// The sums run in the tensor cores' order, so gx agrees with the plain
// product to the order of an f32 sum before its rounding to bf16.
//
// Bound on the H100: operations, 2 M N K at 989 dense bf16 TFLOP/s. A
// `_w8a8` train step (16 packed rows x 256 = 4096 tokens, Vicuna-7B) runs it
// 7 times a layer: q/k/v/o [4096, 4096] x [4096, 4096]^T 0.139 ms each,
// gate/up (N = 11008) and down (K = 11008) 0.373 ms each; bytes (the int8
// kernel 17-45 MB, g and gx) stay below.
//
// Design. The product is computed transposed, gx^T = w g^T, so that the
// int8 operand is wgmma's A, which may come from registers: each thread
// converts its own A fragment from the int8 tile in shared memory, and no
// converted weight is ever stored, in shared or in device memory. This is
// CUTLASS's mixed-input layout for Hopper.
// - A tile is 128 output columns k (two consumer warpgroups of 64, wgmma's
//   M) by 256 rows m of g (wgmma's N), the reduction n in stages of 64.
// - One producer thread keeps a ring of five stages in flight with the
//   tensor memory accelerator: g's [256 rows x 64] bf16 box (128-byte rows,
//   the 128-byte swizzle that wgmma's K-major descriptor reads as B), the
//   kernel's [64 channels x 128 k] int8 box (128-byte swizzle too, which
//   keeps the fragment loads below free of bank conflicts) and the stage's
//   64 channel scales (a bulk copy). Rows past M, k past K and n past N are
//   zero-filled by the copy; zero int8 values give zero weights.
// - Blocks run in clusters of two on neighbouring column tiles of the same
//   rows: each brings half of g's box into both blocks' rings with one
//   multicast copy, so a block reads 16 + 8 KB from L2 a stage for 2 M
//   multiply-adds where alone it would read 40 (g, read again by every
//   column tile, is most of a block's L2 traffic). A stage is refilled once
//   both blocks' consumers have handed it back.
// - A warp's 16 rows of A are the output columns 2r and 2r + 1 of its slab
//   for row pairs (r, r + 8) of the fragment, so one 16-bit load brings a
//   thread both of its rows' int8 values for a channel. The int8 byte
//   becomes an f32 without the quarter-rate I2F: its bits, offset by 128,
//   are placed under the exponent of 2^23 (PRMT) and 2^23 + 128 subtracted,
//   exactly. Then the f32 product with the channel's scale and the packed
//   round to bf16.
// - Each stage's four wgmma m64n256k16 (A from registers, B from shared
//   memory) run asynchronously while the next stage's fragments are
//   converted into the other of two register sets, and are waited for
//   before the next stage's are issued (a wgmma group in flight while
//   registers of the next are written makes ptxas serialize them); the
//   other consumer warpgroup's products fill that gap. The stage goes back
//   to the producer once its products are done.
// - The epilogue rounds the f32 sums to bf16 in registers and stores each
//   thread's pairs of neighbouring output columns (4 bytes) directly.
// A block takes one tile (not persistent): 512 tiles at [4096, 4096], 1376
// at K = 11008, on 132 SMs.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kTileK = 128;     // output columns a tile: two consumer warpgroups of 64
constexpr int kTileM = 256;     // rows of g a tile: wgmma's N
constexpr int kStepN = 64;      // channels (reduction) a stage: one 128-byte bf16 row of g
constexpr int kStages = 5;
constexpr int kThreads = 384;   // the producer warpgroup, then two consumer warpgroups
constexpr int kGBytes = kTileM * kStepN * 2;      // 32768
constexpr int kQBytes = kStepN * kTileK;          // 8192
constexpr int kStageBytes = kGBytes + kQBytes;    // 40960
constexpr int kAlignSlack = 1024;                 // the 128-byte swizzle repeats over 1024 bytes
constexpr int kCluster = 2;   // blocks of neighbouring column tiles sharing g's box
constexpr int kScaleBytes = kStepN * 4;           // a stage's channel scales (f32)
constexpr int kBarBytes = 2 * kStages * 8;
constexpr int kSmemBytes =
    kStages * (kStageBytes + kScaleBytes) + kAlignSlack + kBarBytes;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle's alignment");
static_assert(kSmemBytes <= 232448, "the ring fits a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity is complete; a wait
// that never ends traps. One asm block, so that no warp-aligned instruction
// after it is moved into code the lanes reach apart (csrc/w8a8_gemm.cu).
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

// a box of the map at (c0 along the inner axis, c1 along the outer), by the
// tensor memory accelerator, completing on the barrier
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same box into the shared memory of both blocks of the cluster, at the
// same offset, each completing on its barrier at `bar`'s offset
__device__ __forceinline__ void load_box_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(static_cast<uint16_t>((1 << kCluster) - 1))
      : "memory");
}

// `bytes` (a multiple of 16) from device memory, completing on the barrier
__device__ __forceinline__ void load_bytes(uint32_t dst, const void* src, uint32_t bytes,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// an arrival on the barrier at the same offset in the shared memory of the
// cluster's block `rank`
__device__ __forceinline__ void mbarrier_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both blocks of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving uses (or reuses) of registers that an
// asynchronous wgmma reads or writes across the wait that completes it
template <int kN>
__device__ __forceinline__ void fence_registers(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_registers(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma descriptor of a K-major, 128-byte-swizzled operand: rows of 128
// bytes, groups of 8 rows 1024 bytes apart, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, f32) = a (64 x 16 bf16, registers) * b (16 x 256 bf16, shared,
// K-major) + d; scale_d = 0 starts the sum at zero
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// The 16-bit pair of int8 values at (channel row n, byte kb) of the
// 128-byte-swizzled [64 x 128] int8 tile: 16-byte chunks trade places by
// the row's low three bits.
__device__ __forceinline__ uint32_t load_pair(uint32_t tile, int n, int kb) {
  const uint32_t addr = tile + n * 128 + ((((kb >> 4) ^ (n & 7))) << 4) + (kb & 15);
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// The int8 value in byte `sel` (0 or 1) of `biased` (the pair with each
// byte's sign bit flipped: the value plus 128) as an exact f32: its bits
// placed under the exponent of 2^23, minus 2^23 + 128.
__device__ __forceinline__ float int8_f32(uint32_t biased, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | sel)),
                   8388736.f);
}

// bf16(value * scale) of the two channels n (low half) and n + 1
__device__ __forceinline__ uint32_t weight_pair(float v0, float s0, float v1, float s1) {
  __nv_bfloat162 w = __floats2bfloat162_rn(__fmul_rn(v0, s0), __fmul_rn(v1, s1));
  uint32_t u;
  memcpy(&u, &w, sizeof(u));
  return u;
}

struct Args {
  const float* scale;        // [N] f32
  __nv_bfloat16* out;        // [M, K], row stride ldo elements
  long long ldo;
  int M, N, K;
  int steps;                 // stages of 64 channels
};

__global__ void __launch_bounds__(kThreads, 1)
    w8_grad_gemm_kernel(const __grid_constant__ CUtensorMap g_map,
                        const __grid_constant__ CUtensorMap q_map, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((kAlignSlack - (raw & (kAlignSlack - 1))) & (kAlignSlack - 1));
  const uint32_t scales = base + kStages * kStageBytes;  // scales of stage s at + kScaleBytes s
  const uint32_t full = scales + kStages * kScaleBytes;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const uint32_t rank = cluster_rank();
  const int k0 = blockIdx.x * kTileK;
  const int m0 = blockIdx.y * kTileM;
  const int wg = threadIdx.x / 128;
  // a block past K (the grid's column tiles rounded up to the cluster)
  // brings its half of g for its partner and multiplies nothing
  const bool live = k0 < p.K;

  // the scales' slots zeroed once: a stage's copy past N leaves its tail as
  // it was, a finite value that multiplies the zero-filled int8 codes
  for (int i = threadIdx.x; i < kStages * kStepN; i += kThreads) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(scales + 4 * i), "f"(0.f) : "memory");
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(full + 8 * s, 1);
      // one arrival a consumer warpgroup of each block of the cluster
      mbarrier_init(empty + 8 * s, 2 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the partner's barriers exist before anything lands there

  if (wg == 0) {
    give_registers<kProducerRegs>();
    if (threadIdx.x == 0) {
      int t = 0;
      for (; t < p.steps; ++t) {
        const int s = t % kStages;
        const int n0 = t * kStepN;
        const uint32_t sbytes = 4 * min(kStepN, p.N - n0);
        mbarrier_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        expect_bytes(full + 8 * s, live ? kStageBytes + sbytes : kGBytes);
        const uint32_t dst = base + s * kStageBytes;
        load_box_multicast(dst + rank * (kGBytes / kCluster), &g_map, n0,
                           m0 + static_cast<int>(rank) * (kTileM / kCluster), full + 8 * s);
        if (live) {
          load_box(dst + kGBytes, &q_map, k0, n0, full + 8 * s);
          load_bytes(scales + s * kScaleBytes, p.scale + n0, sbytes, full + 8 * s);
        }
      }
      // the partner's consumers hand stages back here until their last: the
      // block stays until they all have
      for (int i = 0; i < kStages; ++i, ++t) {
        mbarrier_wait(empty + 8 * (t % kStages), ((t / kStages) & 1) ^ 1);
      }
    }
    return;
  }

  take_registers<kConsumerRegs>();
  const int c = wg - 1;                       // output columns 64 c .. 64 c + 63 of the tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = lane / 4, cc = lane % 4;
  const int kb = 64 * c + 16 * warp + 2 * r;  // this thread's pair of output columns (bytes)
  const bool arriver = threadIdx.x % 128 == 0;
  auto release = [&](int s) {
    if (arriver) {
#pragma unroll
      for (uint32_t to = 0; to < kCluster; ++to) mbarrier_arrive_cluster(empty + 8 * s, to);
    }
  };
  if (!live) {  // keep the handshake: wait for each stage and hand it back
    for (int t = 0; t < p.steps; ++t) {
      mbarrier_wait(full + 8 * (t % kStages), (t / kStages) & 1);
      release(t % kStages);
    }
    return;
  }
  const uint64_t desc_g = make_desc(base);
  // the sums start at zero in the first wgmma (scale-d 0): an instruction
  // of another kind writing them would make ptxas serialize the wgmmas
  float acc[128];
  uint32_t frag0[16], frag1[16];

  // stage t's A fragments, converted from its int8 tile into `frag`
  auto convert = [&](int t, uint32_t(&frag)[16]) {
    const int s = t % kStages;
    mbarrier_wait(full + 8 * s, (t / kStages) & 1);
    __syncwarp();
    float sc[16];  // the channels' scales: pairs n, n + 1 at 16 kk + 2 cc (+ 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t at = scales + s * kScaleBytes + 4 * (16 * (i / 2) + 2 * cc + 8 * (i % 2));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(sc[2 * i]), "=f"(sc[2 * i + 1])
                   : "r"(at));
    }
    const uint32_t tile = base + s * kStageBytes + kGBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = load_pair(tile, 16 * kk + 2 * cc + (e & 1) + 8 * (e >> 1), kb) ^ 0x8080u;
      }
      // the fragment as wgmma reads it: a0 row r (column kb), channels n,
      // n + 1; a1 row r + 8 (column kb + 1); a2, a3 the same at n + 8, n + 9
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* s4 = sc + 4 * kk + 2 * h;
        frag[4 * kk + 2 * h] =
            weight_pair(int8_f32(v[2 * h], 0), s4[0], int8_f32(v[2 * h + 1], 0), s4[1]);
        frag[4 * kk + 2 * h + 1] =
            weight_pair(int8_f32(v[2 * h], 1), s4[0], int8_f32(v[2 * h + 1], 1), s4[1]);
      }
    }
  };

  // stage t's four products issued from `frag`; the next stage's fragments
  // are converted into `next` while they run; then they are waited for (so
  // that no register a wgmma in flight reads is written while it runs: ptxas
  // would serialize the wgmmas) and the stage goes back to the producer
  auto step = [&](int t, uint32_t(&frag)[16], uint32_t(&next)[16]) {
    const int s = t % kStages;
    fence_registers(frag);  // every fragment register is written before the products
    wgmma_fence();
    const uint64_t at = static_cast<uint64_t>((s * kStageBytes) >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n256(acc, frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2], frag[4 * kk + 3],
                    desc_g + at + 2 * kk, t > 0 || kk > 0);  // + 32 bytes of channels
    }
    wgmma_commit();
    if (t + 1 < p.steps) convert(t + 1, next);
    wgmma_wait<0>();
    fence_registers(acc);
    fence_registers(frag);
    release(s);
  };

  convert(0, frag0);
  for (int t = 0; t < p.steps; t += 2) {
    step(t, frag0, frag1);
    if (t + 1 < p.steps) step(t + 1, frag1, frag0);
  }

  // row r of the warp's 16 is output column k, row r + 8 column k + 1; the
  // accumulator's columns are rows m of g
  const int k = k0 + kb;
  if (k >= p.K) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * cc + e;
      if (m < p.M) {
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + e], acc[4 * j + 2 + e]);
        uint32_t u;
        memcpy(&u, &v, sizeof(u));
        *reinterpret_cast<uint32_t*>(p.out + m * p.ldo + k) = u;
      }
    }
  }
}

// The 2-D tensor map of a matrix of `rows` rows of `cols` elements of
// `type`, row stride `ld` bytes, with the box [box_rows, box_cols] in the
// 128-byte swizzle; the encoder is looked up once through the runtime.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows,
               long long cols, long long ld, int box_rows, int box_cols) {
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
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// gx [M, K] bf16 (row stride ldo elements) = g [M, N] bf16 (row stride ldg
// elements) times the transpose of the int8 kernel [K, N] stored as N rows
// of K bytes (column-major, channel stride ldq bytes) rescaled by scale [N]
// f32 and rounded to bf16 element by element. N and K multiples of 8; ldg,
// ldq, ldo multiples of 8, 16 and 2; g, the kernel and gx 16-byte aligned.
extern "C" int cgpt_w8_grad_gemm(const void* g, long long ldg, const void* q, long long ldq,
                                 const void* scale, void* out, long long ldo, long long M, int N,
                                 int K, void* stream) {
  if (M < 0 || M > 0x7fffffffLL || N <= 0 || N % 8 != 0 || K <= 0 || K % 8 != 0 || ldg < N ||
      ldg % 8 != 0 || ldq < K || ldq % 16 != 0 || ldo < K || ldo % 2 != 0 || scale == nullptr ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const long long tiles_m = (M + kTileM - 1) / kTileM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(w8_grad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  CUtensorMap g_map, q_map;
  int code = encode_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, ldq, kStepN, kTileK);
  if (code != 0) return code;
  // g's box: half the tile's rows, each half brought by one block of the
  // cluster for both
  code = encode_map(&g_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g, M, N, 2 * ldg,
                    kTileM / kCluster, kStepN);
  if (code != 0) return code;
  const Args p{static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), ldo,
               static_cast<int>(M), N, K, (N + kStepN - 1) / kStepN};
  const int tiles_k = (K + kTileK - 1) / kTileK;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((tiles_k + kCluster - 1) / kCluster * kCluster,
                     static_cast<unsigned>(tiles_m));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8_grad_gemm_kernel, g_map, q_map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
