// Device arithmetic shared by the attention kernels (flash_attention.cu,
// paged_attention.cu), so that every route and variant computes the same
// function: the mask predicate, the logit softcap, the online-softmax
// rescale, the paper's clipped transform, the merge of partial (m, Z)
// states, and the hi/lo split that carries an f32 probability through two
// bf16 tensor-core operands.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace attn {

constexpr float NEG_INF = -1e30f;  // masked logits, as the TPU kernels
constexpr float Z_FLOOR = 1e-30f;  // the softmax denominator's floor

// key position kp is visible from query position qp
__device__ __forceinline__ bool visible(int kp, int qp, bool causal, int window) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window >= 0) ok = ok && kp > qp - window;
  return ok;
}

// cap * tanh(x / cap); cap <= 0 leaves x as it is
__device__ __forceinline__ float softcap(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// One online-softmax step: the row's running max m moves to max(m,
// tile_max); returns the factor exp(m_old - m_new) that rescales the
// running Z and accumulator.
__device__ __forceinline__ float online_rescale(float& m, float tile_max) {
  const float m_new = fmaxf(m, tile_max);
  const float corr = expf(m - m_new);
  m = m_new;
  return corr;
}

// The clipped softmax's probability: clip((zeta - gamma) * p + gamma, 0, 1)
// with p = exp(s - m) / max(Z, 1e-30); zg = zeta - gamma, zc = max(Z, 1e-30).
__device__ __forceinline__ float clipped_prob(float s, float m, float zc, float zg, float gamma) {
  const float p = expf(s - m) / zc;
  return fminf(fmaxf(zg * p + gamma, 0.f), 1.f);
}

// Merge the partial softmax states (m_s, z_s) of n parts (N >= n, a
// compile-time bound, so the arrays stay in registers): M = max m_s,
// Z = sum z_s e^(m_s - M), and w_s = e^(m_s - M), the factor that rescales
// part s's accumulator. A part that saw no live key (m = -1e30, z = 0)
// adds exactly 0; if no part did, Z = 0.
template <int N>
__device__ __forceinline__ void merge_parts(const float* m, const float* z, int n, float& M,
                                            float& Z, float* w) {
  M = NEG_INF;
#pragma unroll
  for (int s = 0; s < N; ++s) M = s < n ? fmaxf(M, m[s]) : M;
  Z = 0.f;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    w[s] = s < n ? expf(m[s] - M) : 0.f;
    Z += s < n ? z[s] * w[s] : 0.f;
  }
}

// p = hi + lo + e with hi = bf16(p), lo = bf16(p - hi), |e| <= 2^-18 |p|:
// two bf16 products against the same bf16 operand carry p at about f32's
// precision (rounding p itself to bf16 errs by up to 2^-9 |p|). Splits two
// probabilities at once, packed as the bf16x2 registers of an mma/wgmma A
// fragment (x in the low half).
__device__ __forceinline__ void split_hi_lo2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  memcpy(&hi, &h, sizeof(hi));
  memcpy(&lo, &l, sizeof(lo));
}

}  // namespace attn
