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
// card's ~295. What the kernel (attention_common.cuh) does about it: wgmma
// from swizzled shared memory, 256 queries a work item so that K and V pass
// through L2 a quarter as often as with 64, a producer warpgroup that keeps
// a ring of 64-key K/V tiles full, and in each consumer warpgroup one row
// block's softmax under the other's products. As the TPU kernel's grid
// (bh, q tile, k tile) with the k loop sequential, an item loops over key
// tiles with the online softmax (m = -inf, l = 0, o = 0); a causal item stops
// at the tile that holds its last query. The scores are multiplied by
// scale * log2(e) inside the exponent's fused multiply-add and the softmax
// runs on exp2 (exp(x * scale - m) = exp2((x * scale - m) * log2(e))).
//
// Precision: the TPU kernel keeps P in f32 for P.V. The tensor cores take P
// rounded to bf16 (relative error 2^-9 on each weight, while l sums the
// unrounded weights), so outputs differ from f32 attention by up to about
// 1e-3 of the value scale, within the bf16 rounding of the output itself.
//
// Masks: a key at or past S, and a key after the query when causal, scores
// -inf (its weight is 0); a row whose every score so far is masked takes 0
// as its maximum, and the output divides by max(l, 1e-30), so a fully masked
// row is finite (zeros). Rows at or past S are zero-filled in shared memory,
// and query rows at or past S are never stored.
//
// Layouts: q, k, v and out are strided views [B, H, S, D] with element
// strides (b, h, s) each of their own and 1 along D, so that the ViT's
// [B, S, H, D] views of one fused qkv product (flash_custom) and its
// [B, H, S, D] views (flash) are both read without a copy, and the output can
// be a [B, S, H, D] buffer. Rows must be 16-byte aligned (strides and D
// multiples of 8); D up to 96 is padded in shared memory only.

#include "attention_common.cuh"

extern "C" int cgpt_flash_attention(const void* q, long long qb, long long qh, long long qs,
                                    const void* k, long long kb, long long kh, long long ks,
                                    const void* v, long long vb, long long vh, long long vs,
                                    void* out, long long ob, long long oh, long long os, int B,
                                    int H, int S, int D, float scale_log2, int causal,
                                    void* stream) {
  using namespace cgpt_attn;
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || D > kDp || !(scale_log2 > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
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
  p.B = B;
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  return static_cast<int>(launch_attention<false>(p, static_cast<cudaStream_t>(stream)));
}
