// Device arithmetic shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, paged_attention.cu), so that every route and
// variant computes the same function: the mask predicate, the logit
// softcap, the online-softmax rescale, the paper's clipped transform, the
// merge of partial (m, Z) states, and the hi/lo split that carries an f32
// probability through two bf16 tensor-core operands. Then the Hopper
// plumbing of the tensor-core routes: mbarriers, TMA tile loads, wgmma
// descriptors, fences and the bf16 products, the bf16 tiles' swizzled
// layout and tensor maps, and the host's lookup of cuTensorMapEncodeTiled.
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

// The softcap's slope at the capped score sc = cap * tanh(x / cap), given
// icap = 1 / cap (0 without a cap): d sc / dx = 1 - (sc / cap)^2, exactly 1
// without one; the factor that takes a gradient of the capped score back
// to the raw one
__device__ __forceinline__ float softcap_slope(float sc, float icap) {
  const float t = sc * icap;
  return fmaf(-t, t, 1.f);
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

// The bf16 tiles of the tensor-core routes (flash forward and backward):
// 64 token rows x D columns of a (B, T, H, D) tensor, as TMA boxes of 64
// rows x BOX columns: 64 columns (128-byte rows, the 128-byte swizzle) at
// D >= 64, 32 columns (64-byte rows, the 64-byte swizzle) at D 32. The
// swizzle repeats every 8 rows (SBO bytes); LAYOUT is its code in a wgmma
// descriptor (1: 128 bytes, 2: 64 bytes); a tile is NCH boxes.
template <int D>
struct Bf16Tile {
  static constexpr int BOX = D < 64 ? D : 64;  // columns of a box
  static constexpr int ROW = 2 * BOX;          // bytes of a box row
  static constexpr int CHUNK = 64 * ROW;       // bytes of a box
  static constexpr int SBO = 8 * ROW;          // one swizzle atom
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;
  static constexpr int NCH = D / BOX;          // boxes per row of D
  static constexpr int BYTES = NCH * CHUNK;    // a 64-row tile
};

// d (64 x 64 f32 fragment) += A (smem, K-major) * B (smem, K-major), bf16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 f32 fragment) += A (registers, bf16x2 fragment) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32 fragment) += A (registers, bf16x2 fragment) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32 fragment) += A (registers, bf16x2 fragment) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x D f32 fragment) += A (registers) * B (smem, MN-major): the
// product over 16 tokens of a register fragment and a bf16 tile (P.V in
// the forward; dS.K, P~.dO and dS.Q in the backward)
template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a, db);
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

// Tensor map of a bf16 (B, T, H, dh) view with element strides (sb, st,
// sh) and a unit last stride: boxes of Bf16Tile<D>::BOX columns x 64 rows
// of T under the swizzle of that width, zeros outside the view: rows past
// T, and columns dh..D-1 when the Dh-128 body runs Dh 80 or 96.
template <int D>
inline cudaError_t make_bf16_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int dh,
                                 long long sb, long long st, long long sh) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Bf16Tile<D>::BOX, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Bf16Tile<D>::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
