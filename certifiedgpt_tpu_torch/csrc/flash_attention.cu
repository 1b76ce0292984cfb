// Flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// certifiedgpt_tpu/ops/flash_attention.py (:39, called from _flash_bhsd
// :124): tiled online-softmax self-attention over one sequence of S tokens
// per (b, h), with an optional causal mask and a mask on the ragged sequence
// tail, f32 accumulation. On the card it also serves the contract of the JAX
// library kernel behind builtin_flash_attention* (:202, :404): non-causal
// attention with the sequence padding masked.
//
// Bound on the H100: operations at the ViT's shapes. 4*B*H*S^2*dh bf16
// tensor-core FLOPs (half of it, about, when causal) against 4*B*H*S*dh*2
// bytes moved, i.e. about S/2 = 512 FLOP per byte at S = 1025, above the
// card's ~295. Design: as the TPU kernel's grid (bh, q tile, k tile) with the
// k loop sequential, one block of 4 warps takes 64 queries (16 per warp) of
// one (b, h) and loops over K/V tiles of 64 keys in shared memory with the
// online softmax (m = -inf, l = 0, acc = 0); a causal block stops at the
// tile that holds its last query. Products are mma.sync m16n8k16 bf16 with
// fp32 accumulation, fragments through ldmatrix (V transposed). The scores
// are multiplied by scale * log2(e) in f32 and the softmax runs on exp2
// (exp(x * scale - m) = exp2((x * scale - m) * log2(e))).
//
// Precision: the TPU kernel keeps P in f32 for P.V. The tensor cores take P
// rounded to bf16 (relative error 2^-9 on each weight, while l sums the
// unrounded weights), so outputs differ from f32 attention by up to about
// 1e-3 of the value scale, within the bf16 rounding of the output itself.
//
// Masks, as in the TPU kernel: a key at or past S, and a key after the query
// when causal, scores -1e30 (exp2 of it less the row maximum is 0); the
// output divides by max(l, 1e-30), so a fully masked row is finite. Key rows
// at or past S are zero-filled in shared memory, and query rows at or past S
// are never stored.
//
// Layouts: q, k, v and out are strided views [B, H, S, D] with element
// strides (b, h, s) each of their own and 1 along D, so that the ViT's
// [B, S, H, D] views of one fused qkv product (flash_custom) and its
// [B, H, S, D] views (flash) are both read without a copy, and the output can
// be a [B, S, H, D] buffer. Rows must be 16-byte aligned (strides and D
// multiples of 8); D is padded to kDp = 96 in shared memory only. A simple
// kernel: no cp.async double buffering, no wgmma/TMA.

#include "attention_common.cuh"

namespace {

using namespace cgpt_attn;

constexpr float kMasked = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long qb, qh, qs;  // element strides over (b, h, s)
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int S, D;
  float scale_log2;
  int causal;
};

constexpr int kSmemBytes = (kBlockM + 2 * kBlockN) * kStride * 2;

__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  static_assert(kBlockM == kBlockN, "the pad-zeroing call spans Q, K and V alike");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kStride;
  __nv_bfloat16* sV = sK + kBlockN * kStride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const long long b64 = b, h64 = h;

  zero_head_padding(sQ, kBlockM + 2 * kBlockN, p.D);
  load_tile<true>(sQ, p.q + b64 * p.qb + h64 * p.qh + static_cast<long long>(q0) * p.qs, p.qs,
                  kBlockM, p.S - q0, p.D);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[kKSteps][4];
  load_q_fragments(qf, sQ, warp, lane);

  // The thread owns rows r0 and r0 + 8 of the warp's slice (mma C layout);
  // l is kept as per-thread partials that the quad adds up at the end.
  const int r0 = warp * 16 + (lane >> 2);
  const int qrow0 = q0 + r0, qrow1 = qrow0 + 8;
  const float neg_inf = __uint_as_float(0xff800000u);
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const __nv_bfloat16* kg = p.k + b64 * p.kb + h64 * p.kh;
  const __nv_bfloat16* vg = p.v + b64 * p.vb + h64 * p.vh;
  const int k_end = p.causal ? min(p.S, q0 + kBlockM) : p.S;
  for (int kt = 0; kt < k_end; kt += kBlockN) {
    __syncthreads();  // every warp is done reading the previous K/V tile
    load_tile<true>(sK, kg + static_cast<long long>(kt) * p.ks, p.ks, kBlockN, p.S - kt, p.D);
    load_tile<true>(sV, vg + static_cast<long long>(kt) * p.vs, p.vs, kBlockN, p.S - kt, p.D);
    cp_async_wait_all();
    __syncthreads();

    float s[kNTiles][4];
    qk_scores(s, qf, sK, lane);
    const bool tail = kt + kBlockN > p.S;
    const bool diagonal = p.causal && kt + kBlockN - 1 > q0;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (tail || diagonal) {
          const int key = kt + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qrow = e < 2 ? qrow0 : qrow1;
          if (key >= p.S || (p.causal && key > qrow)) x = kMasked;
        }
        s[j][e] = x;
      }
    }
    online_softmax_step(s, acc, m0, m1, l0, l1);
    pv_accumulate(acc, s, sV, lane);
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* og = p.out + b64 * p.ob + h64 * p.oh;
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    const int c = nt * 8 + (lane & 3) * 2;
    if (c < p.D) {
      if (qrow0 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<long long>(qrow0) * p.os + c) =
            __floats2bfloat162_rn(acc[nt][0] / l0, acc[nt][1] / l0);
      if (qrow1 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<long long>(qrow1) * p.os + c) =
            __floats2bfloat162_rn(acc[nt][2] / l1, acc[nt][3] / l1);
    }
  }
}

}  // namespace

extern "C" int cgpt_flash_attention(const void* q, long long qb, long long qh, long long qs,
                                    const void* k, long long kb, long long kh, long long ks,
                                    const void* v, long long vb, long long vh, long long vs,
                                    void* out, long long ob, long long oh, long long os, int B,
                                    int H, int S, int D, float scale_log2, int causal,
                                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || D > kDp || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.qb = qb;
  p.qh = qh;
  p.qs = qs;
  p.kb = kb;
  p.kh = kh;
  p.ks = ks;
  p.vb = vb;
  p.vh = vh;
  p.vs = vs;
  p.ob = ob;
  p.oh = oh;
  p.os = os;
  p.S = S;
  p.D = D;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
