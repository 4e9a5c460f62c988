// Dense flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py : flash_attention
// (bodies _vanilla_kernel, _mz_kernel, _av_kernel; adapter
// src/repro/kernels/ops.py : mha_flash): attention over dense q/k/v with
// a causal mask, a local window, logit softcap and a scalar or per-row
// query offset; the vanilla softmax in one online pass, the paper's
// clipped softmax clip((zeta - gamma) * p + gamma, 0, 1) in two passes
// ((m, Z) first, then the clipped P.V); the gate pi multiplied in the
// epilogue. Masked logits are -1e30 and Z is floored at 1e-30, as in the
// TPU kernel. q is multiplied by Dh^-0.5 and rounded to its own dtype
// before the products, as the model's XLA attention paths (dense and
// chunked) scale it; the TPU kernel scales the f32 scores instead, which
// is the same in f32 up to an ulp and differs by that rounding in bf16.
// The arithmetic shared with the paged kernel is in attn_common.cuh.
//
// Layout: q (B, Tq, Hq, Dh), k and v (B, Tk, Hkv, Dh), out like q, gate
// (B, Tq, Hq) f32, each addressed through element strides with a unit
// stride on the last axis. Query head h reads KV head h / (Hq / Hkv), so
// GQA never materializes repeated K/V; the flattened (BH, T, Dh) layout
// of the TPU kernel is the case Hq = Hkv = 1.
//
// What bounds it on an H100: operations. At qwen3-14b's prefill shape
// (B 1, T 2048, Hq 40, Hkv 8, Dh 128, causal) the products need
// 4 * Hq * Dh * T^2 / 2 = 42.9 GFLOP (vanilla; clipped recomputes QK^T
// in its first pass: 64.4 GFLOP) against ~50 MB of q/k/v/out, far above
// the ~295 flop/byte at which the card turns compute bound.
//
// At BERT-base's and OPT-125m's shapes (Dh 64, 12 heads; BERT T 512
// non-causal, OPT T 2048 causal) and at the paper models' reduced Dh 32
// the same holds: the products still dominate the bytes.
//
// Routes, chosen statically by dtype and head dim in the wrapper
// (kernels/flash_attention.py : route), which passes its choice; this
// file dispatches on it and refuses a route not built for the inputs:
//   * bf16, Dh 32, 64 or 128 -> flash_kernel_tc, the tensor-core route;
//     bf16 Dh 80 and 96 (hubert-xlarge, phi-3-vision) run its Dh-128 body:
//     the TMA boxes of columns 64..127 are zero-filled past Dh (the tensor
//     maps name the true head dim), so QK^T adds exact zeros and P.V
//     writes zero columns that the store drops; q's scale Dh^-0.5 comes
//     from the caller. 1.6x / 1.33x the products of a native width, for
//     no new instantiation;
//   * f32 (Dh 32, 64, 80, 96, 128, 256), bf16 Dh 256 -> flash_kernel_cc,
//     the CUDA-core route.
// f32 inputs stay on CUDA cores because their tolerance (3e-5) rules out
// bf16 products; bf16 Dh 256 (recurrentgemma's cache-free forward, off
// the main path) would need a 64x256 f32 accumulator per warpgroup.
//
// Tensor-core route. One CTA of 384 threads owns one (batch row, query
// head, block of 128 queries): two consumer warpgroups of 64 query rows
// each and one producer warpgroup, of which one thread issues TMA copies
// (the others exit after giving their registers to the consumers with
// setmaxnreg). The producer loads Q once and streams K and V tiles of 64
// keys through a ring of STAGES shared-memory slots (full/empty
// mbarriers), so the next tiles arrive while the consumers multiply. TMA
// reads a tensor map over (B, T, H, Dh) with the caller's strides; each
// box is 64 rows x 64 columns (128 bytes, the 128-byte swizzle's limit),
// so a Dh-128 row is two boxes, and rows past T arrive as zeros (masked
// anyway). At Dh 32 a row is 64 bytes: the box is 64 rows x 32 columns
// under the 64-byte swizzle, and the wgmma descriptors name that swizzle
// (8-row atoms of 512 bytes); QK^T is then two k16 steps, and P.V an
// m64n32k16 product per k16 step. A consumer scales its Q rows in place
// (q * Dh^-0.5 rounded to bf16, elementwise, so the swizzle does not
// matter), then per tile computes S = Q K^T with wgmma m64n64k16 (both
// operands in shared memory, K-major, swizzled), masks, softcaps and
// updates the online softmax in registers, and accumulates O += P V with wgmma
// m64nDk16, P from registers and V from shared memory through the
// MN-major (transposed) descriptor. The walk is pipelined: a step's
// softmax runs while the previous step's P.V is still on the tensor
// cores, and the two warpgroups interleave. P keeps f32 precision: it is
// split into hi = bf16(P) and lo = bf16(P - hi), and both are multiplied
// into O against the same V tile (1.5x the vanilla tensor-core work; P
// rounded to bf16 alone would move about a quarter of the bf16 outputs
// by an ulp). The clipped softmax's second pass splits clip((zeta-gamma)
// p + gamma, 0, 1) the same way. The producer walks the keys the CTA can
// see (cut at the causal edge of its last query and the window's start
// for its first); tiles inside every query's view skip the mask
// arithmetic. Every wgmma is issued unconditionally (at least one tile is
// walked; the last step's look-ahead S repeats a resident tile): a wgmma
// under a branch the compiler cannot prove uniform makes it serialize all
// of them. Both clipped passes run in the one launch: pass 1 streams K
// only, pass 2 K and V.
//
// CUDA-core route. One CTA of 256 threads owns one (batch row, query head,
// block of 64 queries) and walks the KV axis in tiles of 64 keys, with
// (m, Z, acc) in registers for the whole walk; products in f32, each
// thread a 4x4 tile of scores; Q and K staged transposed in shared memory.
// Each thread accumulates 4 query rows x NCG groups of CW consecutive
// output columns (CW 4, NCG Dh/64; at Dh 32 and 96, CW 2; at Dh 80, CW 1).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attn_common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA: 16 x 16
constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 64;   // keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* gate;   // null: no gate
  const int* q_offs;   // (B,) per-row offsets, or null: q_offset for all
  void* out;
  int B, Tq, Tk, Hq, Hkv;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, sgb, sgt, sgh;
  int q_offset, causal, window;  // window < 0: none
  float softcap;                 // <= 0: none
  float zg, gamma;               // zeta - gamma, gamma
  float scale;                   // Dh^-0.5
  // what the backward reads (CUDA-core route; null: not written): each
  // row's (m, max(Z, 1e-30)) as 2 planes of (B, Hq, Tq), and the ungated
  // output u (B, Tq, Hq, Dh) contiguous, written beside out under a gate
  float* stats;
  float* u;
  int dh;  // the head dim of the tensors (the tensor-core body's D may exceed it)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T's precision (round to nearest even), as f32
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T as f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* dst) {
  constexpr int N = Vec<T>::N;
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  T e[N];
  memcpy(e, &raw, sizeof(raw));
#pragma unroll
  for (int x = 0; x < N; ++x) dst[x] = to_f(e[x]);
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat16 e[4] = {__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]),
                        __float2bfloat16_rn(x[2]), __float2bfloat16_rn(x[3])};
  uint2 raw;
  memcpy(&raw, e, sizeof(raw));
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store2(float* p, const float* x) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}

// The CUDA-core route's output columns: each thread owns NCG groups of CW
// consecutive columns, group c starting at column c * 16 * CW + tx * CW.
// CW is the widest of 4, 2, 1 whose 16 threads' span divides D, so a row
// need not be a multiple of 64: Dh 96 takes CW 2 (three groups), Dh 80
// CW 1 (five groups).
template <int D>
struct Cols {
  static_assert(D % 16 == 0, "the CUDA-core route takes Dh a multiple of 16");
  static constexpr int CW = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
  static constexpr int NCG = D / (16 * CW);
};

__device__ __forceinline__ void store1(float* p, const float* x) { *p = x[0]; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, const float* x) {
  *p = __float2bfloat16_rn(x[0]);
}

template <int CW>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (CW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}
template <int CW, typename T>
__device__ __forceinline__ void store_cols(T* p, const float* x) {
  if constexpr (CW == 4) {
    store4(p, x);
  } else if constexpr (CW == 2) {
    store2(p, x);
  } else {
    store1(p, x);
  }
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage ROWS token rows [t0, t0 + ROWS) of one head into shared memory as
// f32, transposed (dst[d * ROWS + row]); rows outside [0, limit) are
// zeros. With mul > 0 each value is first multiplied by mul and rounded
// back to T. Consecutive threads take consecutive rows, so the transposed
// stores hit consecutive banks.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_t(const T* base, long long sb_t, int t0, int limit,
                                        float* dst, float mul = 0.f) {
  constexpr int N = Vec<T>::N;
  constexpr int NV = ROWS * D / N;
  for (int i = threadIdx.x; i < NV; i += NT) {
    const int row = i % ROWS, c = i / ROWS;
    float e[N];
    const int t = t0 + row;
    if (t >= 0 && t < limit) {
      load16(base + (long long)t * sb_t + c * N, e);
    } else {
#pragma unroll
      for (int x = 0; x < N; ++x) e[x] = 0.f;
    }
    if (mul > 0.f) {
#pragma unroll
      for (int x = 0; x < N; ++x) e[x] = round_as(e[x] * mul, base);
    }
#pragma unroll
    for (int x = 0; x < N; ++x) dst[(c * N + x) * ROWS + row] = e[x];
  }
}

// Stage BK value rows row-major (dst[row * D + d]); coalesced reads.
template <typename T, int D>
__device__ __forceinline__ void stage_v(const T* base, long long sb_t, int t0, int limit,
                                        float* dst) {
  constexpr int N = Vec<T>::N;
  constexpr int VR = D / N;
  for (int i = threadIdx.x; i < BK * VR; i += NT) {
    const int row = i / VR, c = i % VR;
    float e[N];
    const int t = t0 + row;
    if (t < limit) {
      load16(base + (long long)t * sb_t + c * N, e);
    } else {
#pragma unroll
      for (int x = 0; x < N; ++x) e[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < N; x += 4) store4(dst + row * D + c * N + x, e + x);
  }
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)D * BQ + (size_t)D * BK + (size_t)BK * D + (size_t)BK * BQ;
}

template <typename T, bool CLIPPED, int D>
__global__ void __launch_bounds__(NT, 2) flash_kernel_cc(Args a) {
  constexpr int CW = Cols<D>::CW, NCG = Cols<D>::NCG;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;            // [D][BQ]
  float* kT = qT + D * BQ;     // [D][BK]
  float* vs = kT + D * BK;     // [BK][D]
  float* pT = vs + BK * D;     // [BK][BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nqb = gridDim.x;
  const int qb = nqb - 1 - blockIdx.x;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qb * BQ;
  const int qoff = a.q_offs != nullptr ? a.q_offs[b] : a.q_offset;

  const T* qg = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kg = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vg = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // keys this block can see: cut at the causal edge of its last query and
  // at the window's start for its first
  const int q_first = qoff + q0;
  const int q_last = qoff + min(q0 + BQ, a.Tq) - 1;
  int k_hi = a.Tk;
  if (a.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (a.window >= 0) k_lo = max(0, q_first - a.window + 1);
  k_lo = (k_lo / BK) * BK;

  // q * scale rounded to q's dtype before the products
  stage_t<T, D, BQ>(qg, a.sqt, q0, a.Tq, qT, a.scale);

  float m[4], z[4], acc[4][NCG][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::NEG_INF;
    z[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][c][e] = 0.f;
  }

  constexpr int NPASS = CLIPPED ? 2 : 1;
#pragma unroll 1
  for (int pass = 0; pass < NPASS; ++pass) {
    // vanilla: one online pass with P.V; clipped: pass 0 builds (m, Z),
    // pass 1 accumulates clip((zeta - gamma) * p + gamma, 0, 1) . V
    const bool need_v = !CLIPPED || pass == 1;
    const bool online = !CLIPPED || pass == 0;
    float zc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zc[i] = fmaxf(z[i], attn::Z_FLOOR);
#pragma unroll 1
    for (int t0 = k_lo; t0 < k_hi; t0 += BK) {
      __syncthreads();  // the previous tile's readers are done
      stage_t<T, D, BK>(kg, a.skt, t0, a.Tk, kT);
      if (need_v) stage_v<T, D>(vg, a.svt, t0, a.Tk, vs);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qT + d * BQ + ty * 4);
        const float4 kv = *reinterpret_cast<const float4*>(kT + d * BK + tx * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }

      bool valid[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = qoff + q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = t0 + tx * 4 + j;
          const bool ok = kp < a.Tk && attn::visible(kp, qp, a.causal, a.window);
          s[i][j] = ok ? attn::softcap(s[i][j], a.softcap) : attn::NEG_INF;
          valid[i][j] = ok;
        }
      }

      float corr[4];
      if (online) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mx = max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
          corr[i] = attn::online_rescale(m[i], mx);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = valid[i][j] ? expf(s[i][j] - m[i]) : 0.f;
            ps += s[i][j];
          }
          ps = sum16(ps);
          z[i] = z[i] * corr[i] + ps;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          corr[i] = 1.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float c = attn::clipped_prob(s[i][j], m[i], zc[i], a.zg, a.gamma);
            s[i][j] = valid[i][j] ? c : 0.f;  // masked entries zeroed after the clip
          }
        }
      }
      if (!need_v) continue;

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float col[4] = {s[0][j], s[1][j], s[2][j], s[3][j]};
        store4(pT + (tx * 4 + j) * BQ + ty * 4, col);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NCG; ++c)
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[i][c][e] *= corr[i];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 pv = *reinterpret_cast<const float4*>(pT + j * BQ + ty * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int c = 0; c < NCG; ++c) {
          float va[CW];
          load_cols<CW>(vs + j * D + c * 16 * CW + tx * CW, va);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < CW; ++e) acc[i][c][e] = fmaf(pa[i], va[e], acc[i][c][e]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.Tq) continue;
    const float zc = fmaxf(z[i], attn::Z_FLOOR);
    const float g = a.gate != nullptr ? a.gate[b * a.sgb + t * a.sgt + h * a.sgh] : 1.f;
    if (a.stats != nullptr && tx == 0) {
      const long long si = ((long long)b * a.Hq + h) * a.Tq + t;
      a.stats[si] = m[i];
      a.stats[(long long)a.B * a.Hq * a.Tq + si] = zc;
    }
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      float o[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) o[e] = CLIPPED ? acc[i][c][e] : acc[i][c][e] / zc;
      if (a.u != nullptr)
        store_cols<CW>(a.u + (((long long)b * a.Tq + t) * a.Hq + h) * D + c * 16 * CW + tx * CW, o);
      if (a.gate != nullptr) {
#pragma unroll
        for (int e = 0; e < CW; ++e) o[e] *= g;
      }
      store_cols<CW>(out + (long long)t * a.sot + c * 16 * CW + tx * CW, o);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, Dh 32 / 64 / 128)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;       // queries per CTA: two consumer warpgroups of 64
constexpr int BK = 64;        // keys per tile
constexpr int STAGES = 3;     // K/V ring slots
constexpr int THREADS = 384;  // two consumer warpgroups, one producer warpgroup

// Shared-memory tiles of head dim D. A TMA box is 64 rows x BOX columns of
// bf16: 64 columns (128-byte rows, the 128-byte swizzle) at Dh >= 64, 32
// columns (64-byte rows, the 64-byte swizzle) at Dh 32. The swizzle
// repeats every 8 rows (SBO bytes); LAYOUT is its code in a wgmma
// descriptor (1: 128 bytes, 2: 64 bytes).
template <int D>
struct Smem {
  static constexpr int BOX = D < 64 ? D : 64;        // columns of a box
  static constexpr int ROW = 2 * BOX;                // bytes of a box row
  static constexpr int CHUNK = 64 * ROW;             // bytes of a box
  static constexpr int SBO = 8 * ROW;                // one swizzle atom
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;
  static constexpr int NCH = D / BOX;                // boxes per row of Dh
  static constexpr int Q_BYTES = 2 * NCH * CHUNK;    // both warpgroups' Q
  static constexpr int KV_BYTES = NCH * CHUNK;       // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;   // K then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // barriers: q_full, full[STAGES], empty[STAGES]; slack to align to 1024
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

using attn::desc;
using attn::mbar_arrive;
using attn::mbar_expect_tx;
using attn::mbar_init;
using attn::mbar_wait;
using attn::reg_fence;
using attn::tma_load;
using attn::wg_commit;
using attn::wg_fence;
using attn::wg_wait;

// d (64 x 64 f32 fragment) += A (smem, K-major) * B (smem, K-major)
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// O += P V over one 64-key tile: P as hi and lo A fragments of four k16
// steps, V (64 keys x D) at vs, read through the MN-major descriptor (16
// keys a step; LBO: the next box along D)
template <int D>
__device__ __forceinline__ void pv(float* o, const uint32_t (*hi)[4], const uint32_t (*lo)[4],
                                   uint32_t vs) {
  using S = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<D>(o, hi[kk], desc(vs + kk * 16 * S::ROW, S::CHUNK, S::SBO, S::LAYOUT));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<D>(o, lo[kk], desc(vs + kk * 16 * S::ROW, S::CHUNK, S::SBO, S::LAYOUT));
}

// The scores of one tile (s[4j + 2i + c]: the thread's row i, key
// t0 + 8j + 2qd + c, rows qp0 and qp0 + 8) turned into probabilities in
// place: masks (MASKED: some key of the tile is hidden from some row) and
// softcap, then the online update (corr: the accumulator's rescale) or the
// clipped transform against the final (m, Z).
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* z, const float* zc,
                                             float* corr, bool online, int qp0, int t0, int qd,
                                             const Args& a) {
  if (a.softcap > 0.f) {  // before the masks, which then set -1e30
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = attn::softcap(s[i], a.softcap);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t valid = 0xffffu;
    float mx = attn::NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        if (MASKED) {
          const int kp = t0 + 8 * j + 2 * qd + c;
          if (!(kp < a.Tk && attn::visible(kp, qp0 + 8 * i, a.causal, a.window))) {
            x = attn::NEG_INF;
            valid &= ~(1u << (2 * j + c));
          }
        }
        mx = fmaxf(mx, x);
      }
    if (online) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = attn::online_rescale(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = (!MASKED || ((valid >> (2 * j + c)) & 1u)) ? expf(x - m[i]) : 0.f;
          ps += x;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      z[i] = z[i] * corr[i] + ps;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          // masked entries zeroed after the clip
          x = (!MASKED || ((valid >> (2 * j + c)) & 1u))
                  ? attn::clipped_prob(x, m[i], zc[i], a.zg, a.gamma)
                  : 0.f;
        }
    }
  }
}

template <bool CLIPPED, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Args a) {
  using S = Smem<D>;
  constexpr int NCH = S::NCH, CHUNK = S::CHUNK;
  constexpr int NPASS = CLIPPED ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + S::Q_BYTES;
  const uint32_t q_full = base + S::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + STAGES);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qb * BQ;
  const int qoff = a.q_offs != nullptr ? a.q_offs[b] : a.q_offset;
  // keys this CTA can see: cut at the causal edge of its last query and at
  // the window's start for its first
  int k_hi = a.Tk;
  if (a.causal) k_hi = min(k_hi, qoff + min(q0 + BQ, a.Tq));
  int k_lo = 0;
  if (a.window >= 0) k_lo = max(0, qoff + q0 - a.window + 1);
  k_lo = (k_lo / BK) * BK;
  // at least one tile, so that every wgmma below is issued unconditionally
  // (a wgmma under a branch the compiler cannot prove uniform serializes
  // them all); a CTA that sees no key walks one tile masked out entirely
  k_hi = max(k_hi, k_lo + 1);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, S::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load(q_s + (w * NCH + c) * CHUNK, &tm_q, q_full, c * S::BOX, h, q0 + w * 64, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int pass = 0; pass < NPASS; ++pass) {
        const bool need_v = !CLIPPED || pass == 1;
        for (int t0 = k_lo; t0 < k_lo + n_tiles * BK; t0 += BK) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t ks = kv_s + stage * S::STAGE_BYTES;
          const uint32_t fb = full0 + 8 * stage;
          mbar_expect_tx(fb, need_v ? 2 * S::KV_BYTES : S::KV_BYTES);
          for (int c = 0; c < NCH; ++c)
            tma_load(ks + c * CHUNK, &tm_k, fb, c * S::BOX, hk, t0, b);
          if (need_v) {
            for (int c = 0; c < NCH; ++c)
              tma_load(ks + S::KV_BYTES + c * CHUNK, &tm_v, fb, c * S::BOX, hk, t0, b);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, qd = lane % 4;
    const uint32_t my_q = q_s + wg * NCH * CHUNK;
    const int row_first = q0 + wg * 64;

    mbar_wait(q_full, 0);
    {  // q * scale rounded to bf16 before the products, in place
      uint4* qv = reinterpret_cast<uint4*>(gbase + wg * NCH * CHUNK);
      for (int i = tw; i < NCH * CHUNK / 16; i += 128) {
        uint4 r = qv[i];
        __nv_bfloat162 e[4];
        memcpy(e, &r, sizeof(r));
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 f = __bfloat1622float2(e[x]);
          e[x] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
        }
        memcpy(&r, e, sizeof(r));
        qv[i] = r;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }

    float o[D / 2], s[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {attn::NEG_INF, attn::NEG_INF}, z[2] = {0.f, 0.f}, zc[2] = {1.f, 1.f};
    uint32_t hi[4][4] = {}, lo[4][4] = {};  // P of the step whose P.V is in flight
    const int n_steps = NPASS * n_tiles;
    const int qp0 = qoff + row_first + warp * 16 + g;  // the thread's rows: qp0, qp0 + 8

    auto wait_tile = [&](int n) { mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1); };
    // S = Q K^T of step n (k16 steps of 32 bytes along a box row, then
    // the next box); past the walk's end, a repeat of the last tile that
    // nobody reads (it keeps the wgmma unconditional)
    auto issue_s = [&](int n) {
      const uint32_t ks = kv_s + (min(n, n_steps - 1) % STAGES) * S::STAGE_BYTES;
      constexpr int KPB = S::ROW / 32;  // k16 steps per box row
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / KPB) * CHUNK + (kk % KPB) * 32;
        wgmma_ss_n64(s, desc(my_q + off, 16, S::SBO, S::LAYOUT),
                     desc(ks + off, 16, S::SBO, S::LAYOUT), kk > 0);
      }
    };
    // step n's scores to probabilities: masks only where some key of the
    // tile is hidden from some query of the CTA (decided for the CTA, not
    // the warpgroup: a branch on the warpgroup would be divergent to the
    // compiler, which then serializes the wgmmas)
    auto probs = [&](int n, bool online, float* corr) {
      const int t0 = k_lo + (n % n_tiles) * BK;
      bool full = t0 + BK <= a.Tk;
      if (a.causal) full = full && t0 + BK - 1 <= qoff + q0;
      if (a.window >= 0) full = full && t0 > qoff + min(q0 + BQ, a.Tq) - 1 - a.window;
      if (full) {
        softmax_tile<false>(s, m, z, zc, corr, online, qp0, t0, qd, a);
      } else {
        softmax_tile<true>(s, m, z, zc, corr, online, qp0, t0, qd, a);
      }
    };

    wait_tile(0);
    wg_fence();
    issue_s(0);
    wg_commit();
    int n = 0;
    if (CLIPPED) {
      // pass 0: (m, Z) of every row; K only
#pragma unroll 1
      for (; n < n_tiles; ++n) {
        wg_wait<0>();
        reg_fence<32>(s);
        float corr[2];
        probs(n, true, corr);
        mbar_arrive(empty0 + 8 * (n % STAGES));
        wait_tile(n + 1);  // n + 1 <= n_tiles < n_steps
        wg_fence();
        issue_s(n + 1);
        wg_commit();
      }
      zc[0] = fmaxf(z[0], attn::Z_FLOOR);
      zc[1] = fmaxf(z[1], attn::Z_FLOOR);
    }
    // The P.V walk (vanilla, or the clipped softmax's pass 1), pipelined:
    // step n finds S_n and P.V_{n-1} in flight, waits for S_n, runs its
    // softmax while P.V_{n-1} runs on the tensor cores, then issues
    // S_{n+1} and P.V_n.
    const int first = n;
    // in place of P.V_{first - 1}: a real product with P = 0 against the
    // first step's (arrived, finite) V, which adds exact zeros; ptxas
    // tracks real groups only, and an empty one made it serialize
    wg_fence();
    pv<D>(o, hi, lo, kv_s + (first % STAGES) * S::STAGE_BYTES + S::KV_BYTES);
    wg_commit();
#pragma unroll 1
    for (; n < n_steps; ++n) {
      wg_wait<1>();
      reg_fence<32>(s);
      float corr[2] = {1.f, 1.f};
      probs(n, !CLIPPED, corr);
      wg_wait<0>();
      reg_fence<D / 2>(o);
      if (n > first) mbar_arrive(empty0 + 8 * ((n - 1) % STAGES));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          attn::split_hi_lo2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      if (n + 1 < n_steps) wait_tile(n + 1);
      wg_fence();
      issue_s(n + 1);
      wg_commit();
      pv<D>(o, hi, lo, kv_s + (n % STAGES) * S::STAGE_BYTES + S::KV_BYTES);
      wg_commit();
    }
    wg_wait<0>();
    reg_fence<D / 2>(o);
    mbar_arrive(empty0 + 8 * ((n_steps - 1) % STAGES));

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row_first + warp * 16 + g + 8 * i;
      if (t >= a.Tq) continue;
      const float zci = fmaxf(z[i], attn::Z_FLOOR);
      const float gt = a.gate != nullptr ? a.gate[b * a.sgb + t * a.sgt + h * a.sgh] : 1.f;
      __nv_bfloat16* orow = out + (long long)t * a.sot;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= a.dh) break;  // the Dh-128 body at Dh 80 / 96: columns past Dh are zeros
        float v0 = o[4 * j + 2 * i], v1 = o[4 * j + 2 * i + 1];
        if (!CLIPPED) {
          v0 = v0 / zci;
          v1 = v1 / zci;
        }
        if (a.gate != nullptr) {
          v0 *= gt;
          v1 *= gt;
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * qd) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace tc
// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <typename T, bool CLIPPED, int D>
cudaError_t launch_cc(const Args& a, cudaStream_t stream) {
  auto kern = flash_kernel_cc<T, CLIPPED, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Tensor map of a bf16 (B, T, H, dh) view with element strides (sb, st,
// sh) and a unit last stride: boxes of Smem<D>::BOX columns x 64 rows of
// T under the swizzle of that width (128 bytes, or 64 at Dh 32), zeros
// outside the view: rows past T, and columns dh..D-1 when the Dh-128 body
// runs Dh 80 or 96.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int dh,
                     long long sb, long long st, long long sh) {
  const attn::EncodeFn enc = attn::encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)tc::Smem<D>::BOX, 1, (cuuint32_t)tc::BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      tc::Smem<D>::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool CLIPPED, int D>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<D>(&mq, a.q, a.B, a.Tq, a.Hq, a.dh, a.sqb, a.sqt, a.sqh);
  if (err == cudaSuccess)
    err = make_map<D>(&mk, a.k, a.B, a.Tk, a.Hkv, a.dh, a.skb, a.skt, a.skh);
  if (err == cudaSuccess)
    err = make_map<D>(&mv, a.v, a.B, a.Tk, a.Hkv, a.dh, a.svb, a.svt, a.svh);
  if (err != cudaSuccess) return err;
  auto kern = tc::flash_kernel_tc<CLIPPED, D>;
  const int smem = tc::Smem<D>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + tc::BQ - 1) / tc::BQ, a.Hq, a.B);
  kern<<<grid, tc::THREADS, smem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_cc(const Args& a, bool clipped, cudaStream_t s) {
  return clipped ? launch_cc<T, true, D>(a, s) : launch_cc<T, false, D>(a, s);
}

template <int D>
cudaError_t dispatch_tc(const Args& a, bool clipped, cudaStream_t s) {
  return clipped ? launch_tc<true, D>(a, s) : launch_tc<false, D>(a, s);
}

// route 1: the tensor-core kernels (bf16, Dh 32/64/128, and Dh 80/96
// through the Dh-128 body); route 0: the CUDA-core kernels (f32 at Dh
// 32/64/80/96/128/256, bf16 at Dh 256)
cudaError_t dispatch(const Args& a, int dtype, int dh, int route, bool clipped,
                     cudaStream_t s) {
  if (route == 1) {
    if (dtype == 1 && dh == 32) return dispatch_tc<32>(a, clipped, s);
    if (dtype == 1 && dh == 64) return dispatch_tc<64>(a, clipped, s);
    if (dtype == 1 && (dh == 80 || dh == 96 || dh == 128)) return dispatch_tc<128>(a, clipped, s);
  } else if (route != 0) {
    return cudaErrorInvalidValue;
  } else if (dtype == 1) {
    if (dh == 256) return dispatch_cc<__nv_bfloat16, 256>(a, clipped, s);
  } else if (dtype == 0) {
    if (dh == 32) return dispatch_cc<float, 32>(a, clipped, s);
    if (dh == 64) return dispatch_cc<float, 64>(a, clipped, s);
    if (dh == 80) return dispatch_cc<float, 80>(a, clipped, s);
    if (dh == 96) return dispatch_cc<float, 96>(a, clipped, s);
    if (dh == 128) return dispatch_cc<float, 128>(a, clipped, s);
    if (dh == 256) return dispatch_cc<float, 256>(a, clipped, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides in
// elements. route: 1 = tensor cores, 0 = CUDA cores, as the note above
// names them; a route not built for (dtype, Dh) is refused. stats and u
// (null: not written; the f32 CUDA-core route only, else refused): what
// the backward kernel reads, see Args. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const float* gate, const int* q_offs,
    void* out, int B, int Tq, int Tk, int Hq, int Hkv, int Dh, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sot, long long soh, long long sgb, long long sgt,
    long long sgh, int q_offset, int causal, int window, float softcap, int clipped,
    float zg, float gamma, float scale, float* stats, float* u, int dtype, int route,
    void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || ((stats != nullptr || u != nullptr) && (dtype != 0 || route != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, gate, q_offs, out, B, Tq, Tk, Hq, Hkv, sqb, sqt, sqh, skb, skt, skh,
         svb, svt, svh, sob, sot, soh, sgb, sgt, sgh, q_offset, causal, window, softcap,
         zg, gamma, scale, stats, u, Dh};
  return (int)dispatch(a, dtype, Dh, route, clipped != 0,
                       static_cast<cudaStream_t>(stream));
}
