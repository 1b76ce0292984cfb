// cls-split ViT attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that compute the same function:
// - _cls_split_kernel of certifiedgpt_tpu/ops/flash_attention.py (:258,
//   called from cls_split_attention_parts :346), whose q arrives pre-scaled
//   by head_dim**-0.5 * log2(e) so that the softmax runs on exp2 with no
//   per-score multiply (scale_log2 = 1 here);
// - _cls_kernel of scripts/bench_cls_split_attention.py (:35, called at :74),
//   the experiment before it, which takes raw q, multiplies every score by an
//   explicit softmax scale and runs exp. exp(x * scale - m) equals
//   exp2((x * scale - m) * log2(e)), so that form passes
//   scale_log2 = scale * log2(e): the scores are multiplied by it in f32 and
//   the same exp2 softmax follows (the maximum is taken in the same scaled
//   domain). scale_log2 = 1 (the pre-scaled form) launches an instance of
//   the kernel that has no such multiply.
// For each (b, h) the kernel computes non-causal attention of the N patch
// queries over the N patch keys plus the single cls key, merged into each
// row's softmax. The cls query row stays plain torch (as in the JAX package).
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

#include "attention_common.cuh"

namespace {

using namespace cgpt_attn;

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
  float scale_log2;  // multiplies every score (kScaled only)
};

constexpr int kSmemBytes = (kBlockM + 2 * kBlockN) * kStride * 2 + 2 * kDp * 4;

// kScaled: every score is multiplied by p.scale_log2 (the explicit-scale
// form); the pre-scaled form has no such multiply.
template <bool kScaled>
__global__ void __launch_bounds__(kThreads) cls_split_kernel(const Params p) {
  static_assert(kBlockM == kBlockN, "the pad-zeroing call spans Q, K and V alike");

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

  zero_head_padding(sQ, kBlockM + 2 * kBlockN, p.D);
  for (int i = tid; i < kDp; i += kThreads) {
    sKc[i] = i < p.D ? __bfloat162float(p.kc[cbh + i]) : 0.f;
    sVc[i] = i < p.D ? __bfloat162float(p.vc[cbh + i]) : 0.f;
  }
  load_tile<false>(sQ, p.q + bh + static_cast<long long>(qt) * kBlockM * p.sn, p.sn, kBlockM,
                   kBlockM, p.D);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[kKSteps][4];
  load_q_fragments(qf, sQ, warp, lane);

  // The thread owns rows r0 and r0 + 8 of the warp's slice (mma C layout).
  const int r0 = warp * 16 + (lane >> 2);
  float sc0 = 0.f, sc1 = 0.f;  // cls scores, log2 domain
  for (int d = lane & 3; d < kDp; d += 4) {
    sc0 += __bfloat162float(sQ[r0 * kStride + d]) * sKc[d];
    sc1 += __bfloat162float(sQ[(r0 + 8) * kStride + d]) * sKc[d];
  }
  sc0 = quad_sum(sc0);
  sc1 = quad_sum(sc1);
  if (kScaled) {
    sc0 *= p.scale_log2;
    sc1 *= p.scale_log2;
  }

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
    load_tile<false>(sK, kg + static_cast<long long>(kt) * p.sn, p.sn, kBlockN, kBlockN, p.D);
    load_tile<false>(sV, vg + static_cast<long long>(kt) * p.sn, p.sn, kBlockN, kBlockN, p.D);
    cp_async_wait_all();
    __syncthreads();

    float s[kNTiles][4];
    qk_scores(s, qf, sK, lane);
    if (kScaled) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale_log2;
      }
    }
    online_softmax_step(s, acc, m0, m1, l0, l1);
    pv_accumulate(acc, s, sV, lane);
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
                                        float scale_log2, void* stream) {
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
  p.scale_log2 = scale_log2;
  const dim3 grid(N / kBlockM, H, B);
  const auto kernel = scale_log2 == 1.f ? cls_split_kernel<false> : cls_split_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
