// cls-split ViT attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _cls_split_kernel of
// certifiedgpt_tpu/ops/flash_attention.py (:258, called from
// cls_split_attention_parts :346). For each (b, h) it computes non-causal
// attention of the N patch queries over the N patch keys plus the single cls
// key, merged into each row's softmax. q arrives pre-scaled by
// head_dim**-0.5 * log2(e), so the softmax runs on exp2 with no per-score
// multiply. The cls query row stays plain torch (as in the JAX package).
//
// Bound on the H100: operations. 4*B*H*N^2*dh bf16 tensor-core FLOPs against
// 4*B*H*N*dh*2 bytes moved, i.e. about N/2 = 512 FLOP per byte, above the
// card's ~295. Design: the TPU kernel keeps all N keys of a (b, h) resident;
// K plus V at N = 1024 does not fit a block's shared memory, so one block of
// 4 warps takes 64 queries (16 per warp) and loops over K/V tiles of 64 keys
// with an online softmax, seeded from the cls term (m = s_c, l = 1,
// acc = v_c). Products are mma.sync m16n8k16 bf16 with fp32 accumulation;
// fragments come from shared memory through ldmatrix (V transposed).
//
// Head padding: the TPU pads dh = 88 to its 128-lane width in device memory,
// which costs 45 % more bytes and FLOPs. Here operands stay at dh in device
// memory; the kernel zero-pads to kDp = 96 (the next multiple of the mma
// k-step 16 above dh = 88, the one head dim served) inside shared memory only.
// The padded lanes add nothing to q.k, and the padded output lanes are never
// stored. Narrower head dims (multiples of 8) are padded the same way.
//
// Operands are strided views [B, H, N, D] (element strides sb, sh, sn, 1) so
// that q, k and v can be read straight out of the fused qkv matmul output;
// rows must be 16-byte aligned (strides and D multiples of 8). N must be a
// multiple of 64. A simple kernel: no cp.async double buffering, no wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // queries per block, 16 per warp
constexpr int kBlockN = 64;  // keys per iteration
constexpr int kDp = 96;      // head dim padded in shared memory
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  __nv_bfloat16* out;
  long long sb, sh, sn;  // q/k/v strides
  long long cb, ch;      // kc/vc strides
  long long ob, oh, on;  // out strides
  int N, D;
};

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

// Asynchronously copies `rows` rows of D bf16 values into shared memory.
template <int kStride>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          long long row_stride, int rows, int D) {
  const int chunks = D >> 3;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, cc = c - r * chunks;
    cp_async16(smem + r * kStride + cc * 8, g + r * row_stride + cc * 8);
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

constexpr int kSmemBytes = (kBlockM + 2 * kBlockN) * (kDp + 8) * 2 + 2 * kDp * 4;

__global__ void __launch_bounds__(kThreads) cls_split_kernel(const Params p) {
  constexpr int kStride = kDp + 8;  // padded row: conflict-free ldmatrix
  constexpr int kKSteps = kDp / 16;
  constexpr int kDTiles = kDp / 8;
  constexpr int kNTiles = kBlockN / 8;
  static_assert(kBlockM == kBlockN, "the pad-zeroing loop spans Q, K and V alike");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kStride;
  __nv_bfloat16* sV = sK + kBlockN * kStride;
  float* sKc = reinterpret_cast<float*>(sV + kBlockN * kStride);
  float* sVc = sKc + kDp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.sb + static_cast<long long>(h) * p.sh;
  const long long cbh = static_cast<long long>(b) * p.cb + static_cast<long long>(h) * p.ch;

  // Zero the head-dim padding [D, kDp) of the Q, K and V tiles once: the
  // tile loads below only ever write columns [0, D).
  const int pad = kDp - p.D;
  if (pad > 0) {
    for (int i = tid; i < (kBlockM + 2 * kBlockN) * pad; i += kThreads) {
      const int r = i / pad, c = p.D + (i - r * pad);
      sQ[r * kStride + c] = __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < kDp; i += kThreads) {
    sKc[i] = i < p.D ? __bfloat162float(p.kc[cbh + i]) : 0.f;
    sVc[i] = i < p.D ? __bfloat162float(p.vc[cbh + i]) : 0.f;
  }
  load_tile<kStride>(sQ, p.q + bh + static_cast<long long>(qt) * kBlockM * p.sn, p.sn, kBlockM,
                     p.D);
  cp_async_wait_all();
  __syncthreads();

  // This warp's 16 query rows as mma A fragments, for every k-step.
  uint32_t qf[kKSteps][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[kk], sQ + r * kStride + kk * 16 + c);
  }

  // The thread owns rows r0 and r0 + 8 of the warp's slice (mma C layout).
  const int r0 = warp * 16 + (lane >> 2);
  float sc0 = 0.f, sc1 = 0.f;  // cls scores, log2 domain
  for (int d = lane & 3; d < kDp; d += 4) {
    sc0 += __bfloat162float(sQ[r0 * kStride + d]) * sKc[d];
    sc1 += __bfloat162float(sQ[(r0 + 8) * kStride + d]) * sKc[d];
  }
  sc0 = quad_sum(sc0);
  sc1 = quad_sum(sc1);

  // Online softmax seeded with the cls key: m = s_c, l = 1, acc = v_c. The
  // row sum l is kept as per-thread partials (the quad adds up at the end),
  // so only one thread of each quad starts it at 1.
  float m0 = sc0, m1 = sc1;
  float l0 = (lane & 3) == 0 ? 1.f : 0.f, l1 = l0;
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    const int c = nt * 8 + (lane & 3) * 2;
    acc[nt][0] = sVc[c];
    acc[nt][1] = sVc[c + 1];
    acc[nt][2] = sVc[c];
    acc[nt][3] = sVc[c + 1];
  }

  const __nv_bfloat16* kg = p.k + bh;
  const __nv_bfloat16* vg = p.v + bh;
  for (int kt = 0; kt < p.N; kt += kBlockN) {
    __syncthreads();  // every warp is done reading the previous K/V tile
    load_tile<kStride>(sK, kg + static_cast<long long>(kt) * p.sn, p.sn, kBlockN, p.D);
    load_tile<kStride>(sV, vg + static_cast<long long>(kt) * p.sn, p.sn, kBlockN, p.D);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys.
    float s[kNTiles][4];
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

    // acc += P V, with P (rounded to bf16) taken straight from the S registers.
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

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  __nv_bfloat16* og = p.out + static_cast<long long>(b) * p.ob + static_cast<long long>(h) * p.oh;
  const long long row0 = static_cast<long long>(qt) * kBlockM + r0;
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    const int c = nt * 8 + (lane & 3) * 2;
    if (c < p.D) {
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.on + c) =
          __floats2bfloat162_rn(acc[nt][0] / l0, acc[nt][1] / l0);
      *reinterpret_cast<__nv_bfloat162*>(og + (row0 + 8) * p.on + c) =
          __floats2bfloat162_rn(acc[nt][2] / l1, acc[nt][3] / l1);
    }
  }
}

}  // namespace

extern "C" int cgpt_cls_split_attention(const void* q, const void* k, const void* v,
                                        long long sb, long long sh, long long sn,
                                        const void* kc, const void* vc, long long cb,
                                        long long ch, void* out, long long ob, long long oh,
                                        long long on, int B, int H, int N, int D,
                                        void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || N % kBlockM != 0 || D <= 0 || D % 8 != 0 || D > kDp ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kc = static_cast<const __nv_bfloat16*>(kc);
  p.vc = static_cast<const __nv_bfloat16*>(vc);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sb = sb;
  p.sh = sh;
  p.sn = sn;
  p.cb = cb;
  p.ch = ch;
  p.ob = ob;
  p.oh = oh;
  p.on = on;
  p.N = N;
  p.D = D;
  const dim3 grid(N / kBlockM, H, B);
  cudaError_t err = cudaFuncSetAttribute(cls_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cls_split_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
