// Building blocks shared by the attention kernels of this directory
// (cls_split_attention.cu, flash_attention.cu): shared-memory tile loads with
// cp.async, ldmatrix fragments, mma.sync m16n8k16 bf16 with fp32
// accumulation, and the quad reductions of the mma C layout.
//
// Tiles hold rows of kDp = 96 bf16 values (the head dim padded to the next
// multiple of the mma k-step 16 above dh = 88), each row strided by
// kStride = kDp + 8 so that ldmatrix reads are free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgpt_attn {

constexpr int kBlockM = 64;  // queries per block, 16 per warp
constexpr int kBlockN = 64;  // keys per iteration
constexpr int kDp = 96;      // head dim padded in shared memory
constexpr int kStride = kDp + 8;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKSteps = kDp / 16;   // mma k-steps over the head dim
constexpr int kDTiles = kDp / 8;    // n-tiles of the output (head dim)
constexpr int kNTiles = kBlockN / 8;  // n-tiles of the scores (keys)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Asynchronously copies `rows` rows of D bf16 values into a tile. kRagged
// (a sequence tail): only the first `valid` rows are copied and the rest are
// zero-filled, so that masked keys contribute 0 * 0 and never a stale or
// undefined value; without it the compare is compiled out.
template <bool kRagged>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          long long row_stride, int rows, int valid, int D) {
  const int chunks = D >> 3;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, cc = c - r * chunks;
    __nv_bfloat16* dst = smem + r * kStride + cc * 8;
    if (!kRagged || r < valid) {
      cp_async16(dst, g + r * row_stride + cc * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Zeroes the head-dim padding [D, kDp) of `rows` tile rows once: tile loads
// only ever write columns [0, D).
__device__ __forceinline__ void zero_head_padding(__nv_bfloat16* smem, int rows, int D) {
  const int pad = kDp - D;
  if (pad <= 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad, c = D + (i - r * pad);
    smem[r * kStride + c] = __float2bfloat16(0.f);
  }
}

// This warp's 16 query rows of a [kBlockM, kStride] tile as mma A fragments,
// one per k-step.
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[kKSteps][4],
                                                 const __nv_bfloat16* sQ, int warp, int lane) {
  const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[kk], sQ + r * kStride + kk * 16 + c);
}

// s = Q K^T for the warp's 16 rows against a [kBlockN, kStride] key tile.
__device__ __forceinline__ void qk_scores(float (&s)[kNTiles][4],
                                          const uint32_t (&qf)[kKSteps][4],
                                          const __nv_bfloat16* sK, int lane) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int np = 0; np < kNTiles / 2; ++np) {
      const int mi = lane >> 3;
      const int key = np * 16 + (lane & 7) + (mi >> 1) * 8;
      const int d = kk * 16 + (mi & 1) * 8;
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + key * kStride + d);
      mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
    }
  }
}

// acc += P V, with P (rounded to bf16) taken straight from the score
// registers and V from a [kBlockN, kStride] tile (ldmatrix transposed).
__device__ __forceinline__ void pv_accumulate(float (&acc)[kDTiles][4],
                                              const float (&s)[kNTiles][4],
                                              const __nv_bfloat16* sV, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint32_t pf[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kDTiles / 2; ++dp) {
      const int mi = lane >> 3;
      const int key = kk * 16 + (lane & 7) + (mi & 1) * 8;
      const int d = dp * 16 + (mi >> 1) * 8;
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + key * kStride + d);
      mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One online-softmax step (log2 domain) for the thread's rows r0 and r0 + 8:
// raises the running maxima to the tile's, rescales the partial row sums and
// the accumulator, and turns the scores into exp2 weights added to l.
__device__ __forceinline__ void online_softmax_step(float (&s)[kNTiles][4],
                                                    float (&acc)[kDTiles][4], float& m0,
                                                    float& m1, float& l0, float& l1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= corr0;
  l1 *= corr1;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    s[j][0] = exp2f(s[j][0] - m0);
    s[j][1] = exp2f(s[j][1] - m0);
    s[j][2] = exp2f(s[j][2] - m1);
    s[j][3] = exp2f(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    acc[nt][0] *= corr0;
    acc[nt][1] *= corr0;
    acc[nt][2] *= corr1;
    acc[nt][3] *= corr1;
  }
}

}  // namespace cgpt_attn
