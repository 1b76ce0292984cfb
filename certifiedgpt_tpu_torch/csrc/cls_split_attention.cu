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
//   scale_log2 = scale * log2(e): the running maximum is kept in that scaled
//   domain and every weight is exp2(fma(x, scale_log2, -m)), one fused
//   multiply-add. scale_log2 = 1 (the pre-scaled form) launches an instance
//   of the kernel that has no multiply.
// For each (b, h) the kernel computes non-causal attention of the N patch
// queries over the N patch keys plus the single cls key, merged into each
// row's softmax as its seed, and, in the same launch, the cls query row over
// the same N + 1 keys (the JAX package computes that row in plain XLA).
//
// Bound on the H100: operations. 4*B*H*(N+1)^2*dh bf16 tensor-core FLOPs
// against 4*B*H*(N+1)*dh*2 bytes moved, i.e. about N/2 = 512 FLOP per byte,
// above the card's ~295. What the kernel (attention_common.cuh) does about
// it: wgmma from swizzled shared memory, 256 queries a work item so that K
// and V pass through L2 four times, a producer warpgroup that keeps a ring
// of K/V tiles full, and in each consumer warpgroup one row block's softmax
// under the other's products. The TPU kernel keeps all N keys of a (b, h)
// resident; here they stream through 64-key tiles with an online softmax.
//
// Head padding: the TPU pads dh = 88 to its 128-lane width in device memory,
// which costs 45 % more bytes and FLOPs. Here operands stay at dh in device
// memory; Q K^T runs over a depth of 96 (the next multiple of the wgmma depth
// step 16, zero-padded in shared memory only) and P V over a width of 88.
// Narrower head dims (multiples of 8) are padded the same way; 96 takes an
// instance with a P V width of 96.
//
// Operands are strided views [B, H, N, D] (element strides sb, sh, sn, 1) so
// that q, k and v can be read straight out of the fused qkv matmul output;
// rows must be 16-byte aligned (strides and D multiples of 8). N must be a
// multiple of 64; a last work item of fewer than 256 queries is masked.

#include "attention_common.cuh"

extern "C" int cgpt_cls_split_attention(const void* q, const void* k, const void* v,
                                        long long sb, long long sh, long long sn,
                                        const void* qc, const void* kc, const void* vc,
                                        long long cb, long long ch, void* out, long long ob,
                                        long long oh, long long on, void* out_c,
                                        long long ocb, long long och, int B, int H, int N,
                                        int D, float scale_log2, void* stream) {
  using namespace cgpt_attn;
  if (B <= 0 || H <= 0 || N <= 0 || N % 64 != 0 || D <= 0 || D % 8 != 0 || D > kDp ||
      !(scale_log2 > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.qb = p.kb = p.vb = sb;
  p.qh = p.kh = p.vh = sh;
  p.qs = p.ks = p.vs = sn;
  p.ob = ob;
  p.oh = oh;
  p.os = on;
  p.qc = static_cast<const __nv_bfloat16*>(qc);
  p.kc = static_cast<const __nv_bfloat16*>(kc);
  p.vc = static_cast<const __nv_bfloat16*>(vc);
  p.out_c = static_cast<__nv_bfloat16*>(out_c);
  p.cb = cb;
  p.ch = ch;
  p.ocb = ocb;
  p.och = och;
  p.B = B;
  p.H = H;
  p.S = N;
  p.D = D;
  p.scale_log2 = scale_log2;
  p.causal = 0;
  return static_cast<int>(launch_attention<true>(p, static_cast<cudaStream_t>(stream)));
}
