// Device arithmetic shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, paged_attention.cu), so that every route and
// variant computes the same function: the mask predicate, the logit
// softcap, the online-softmax rescale, the paper's clipped transform, the
// merge of partial (m, Z) states, and the hi/lo split that carries an f32
// probability through two bf16 tensor-core operands. Then the Hopper
// plumbing of the tensor-core routes: mbarriers, TMA tile loads, wgmma
// descriptors and fences, and the host's lookup of cuTensorMapEncodeTiled.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// ---------------------------------------------------------------------------
// Hopper plumbing: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A wait
// that lasts 2^35 cycles (~17 s) traps, so a fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 35)) {
      __trap();
    }
  }
}
// one box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a swizzled tile in shared memory: start address,
// leading and stride byte offsets (16-byte units) and the swizzle's code
// (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of accumulators across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeFn>(p);
    }
  }
  return fn;
}

}  // namespace attn
