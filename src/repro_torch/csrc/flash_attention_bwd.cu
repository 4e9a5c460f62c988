// Flash-attention backward for NVIDIA Hopper (sm_90a), f32 on CUDA cores.
//
// The gradient of csrc/flash_attention.cu's forward. It has no TPU
// counterpart: the JAX package trains through its plain attention
// (src/repro/core/attention.py : attention -> dense_attention /
// chunked_attention) and lets XLA differentiate it; none of its Pallas
// kernels has a custom_vjp. The port's cache-free attention on the card
// is the flash kernel, so its gradient is this kernel.
//
// Scope: f32 q/k/v (the paper models' dtype), Dh 32 and 64, causal or not,
// G = Hq / Hkv >= 1, model layout (B, T, H, Dh) with the forward's stride
// rules, vanilla, clipped (gamma, zeta) and gated; no window, softcap or
// query offset (the wrapper refuses them).
//
// For query row i, s_ij = (q_i Dh^-0.5) . k_j (q scaled in f32 first, as
// the forward), masked p_ij = exp(s_ij - m_i) / Z_i, P~ = p (vanilla) or
// clip((zeta - gamma) p + gamma, 0, 1) masked (clipped), u_i = sum_j P~_ij
// v_j, g_i = gate_i dO_i (gate 1 without gating):
//   dgate_i = dO_i . u_i
//   dv_j    = sum_i P~_ij g_i,     dP~_ij = g_i . v_j
//   dp_ij   = dP~_ij (vanilla), (zeta - gamma) 1[0 < (zeta-gamma) p + gamma < 1] dP~_ij (clipped)
//   ds_ij   = p_ij (dp_ij - D_i),  D_i = sum_l p_il dp_il
//   dq_i    = Dh^-0.5 sum_j ds_ij k_j,   dk_j = sum_i ds_ij (q_i Dh^-0.5)
// Vanilla: D_i = g_i . u_i. Clipped: D_i = (zeta - gamma) g_i . w_i with
// w_i = sum_j p_ij 1[unclipped] v_j, a second accumulator of the pass that
// builds u, after a first pass for (m, Z) (as the forward's pass 0).
//
// Three launches, each one CTA of 256 threads (16 x 16, each thread a 4 x
// 4 tile of scores) on a 64-row tile, products in f32 fmaf chains over d in
// order (so every kernel recomputes bitwise the same s_ij):
//   1. rows (B, Hq, query block): (m, Z) and u (one online pass, or the
//      clipped two passes), then D_i and dgate_i; (m, Z, D) go to a
//      scratch of 3 x (B, Hq, Tq) floats.
//   2. dk/dv (B, Hkv, key block): walks the G query heads of its KV head
//      and the query blocks that see its keys, recomputes S^T and dP~^T,
//      and accumulates dk and dv in registers.
//   3. dq (B, Hq, query block): walks the keys its queries see and
//      accumulates dq in registers.
// Every output element has one owner that sums in a fixed order: no
// atomics, so two calls give bitwise equal gradients.
//
// What bounds it on an H100: operations. Per visible (query, key) pair
// and head column the function needs 10 flops (S, dP~, dv, dq, dk), in
// every variant: D_i = sum_j p_ij dp_ij is a scalar per pair, and u and
// the clipped (m, Z) could come saved from the forward. Against ~10 bytes
// per token and head of inputs and outputs; at BERT-base's shape (8, 512,
// 12/12, 64) that is 16.1 GFLOP (0.24 ms at 67 TFLOP/s f32) against 25 MB
// (0.0075 ms). This first version saves nothing from the forward: it
// recomputes u = P~ V, S in all three kernels (twice in the first when
// clipped, for (m, Z), beside a second accumulator w) and dP~ in two (18 flops per pair and column, 22
// clipped) on CUDA cores, a simple and right kernel; saving O and (m, Z),
// tensor cores and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA: 16 x 16
constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per tile

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* gate;  // null: no gate
  const float* dout;  // (B, Tq, Hq, Dh) contiguous
  float* dq;          // (B, Tq, Hq, Dh) contiguous
  float* dk;          // (B, Tk, Hkv, Dh) contiguous
  float* dv;          // (B, Tk, Hkv, Dh) contiguous
  float* dgate;       // (B, Tq, Hq) contiguous, or null
  float* stats;       // 3 x (B, Hq, Tq): m, max(Z, 1e-30), D
  int B, Tq, Tk, Hq, Hkv;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh;
  int causal, clipped;
  float zg, gamma, scale;  // zeta - gamma, gamma, Dh^-0.5
};

// The output columns of a thread: NCG groups of CW consecutive columns,
// group c starting at column c * 16 * CW + tx * CW (as the forward).
template <int D>
struct Cols {
  static constexpr int CW = D >= 64 ? 4 : D / 16;
  static constexpr int NCG = D / (16 * CW);
};

template <int CW>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

template <int CW>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage ROWS token rows [t0, t0 + ROWS) of one head into shared memory,
// transposed (dst[d * ROWS + row]) when T_LAYOUT, else row-major (dst[row
// * D + d]); rows outside [0, limit) are zeros. Each value is multiplied by
// mul (if mul > 0) and by the row's gate (if gate), in f32.
template <int D, int ROWS, bool T_LAYOUT>
__device__ __forceinline__ void stage(const float* base, long long st, int t0, int limit,
                                      float* dst, float mul = 0.f, const float* gate = nullptr,
                                      long long sgt = 0) {
  constexpr int NV = ROWS * D / 4;
  for (int i = threadIdx.x; i < NV; i += NT) {
    // transposed: consecutive threads take consecutive rows (consecutive
    // banks on the store); row-major: consecutive 16-byte columns
    const int row = T_LAYOUT ? i % ROWS : i / (D / 4);
    const int c = T_LAYOUT ? i / ROWS : i % (D / 4);
    const int t = t0 + row;
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < limit) {
      e = ld4(base + (long long)t * st + c * 4);
      if (mul > 0.f) e.x *= mul, e.y *= mul, e.z *= mul, e.w *= mul;
      if (gate != nullptr) {
        const float g = gate[(long long)t * sgt];
        e.x = g * e.x, e.y = g * e.y, e.z = g * e.z, e.w = g * e.w;
      }
    }
    if (T_LAYOUT) {
      dst[(c * 4 + 0) * ROWS + row] = e.x;
      dst[(c * 4 + 1) * ROWS + row] = e.y;
      dst[(c * 4 + 2) * ROWS + row] = e.z;
      dst[(c * 4 + 3) * ROWS + row] = e.w;
    } else {
      *reinterpret_cast<float4*>(dst + row * D + c * 4) = e;
    }
  }
}

// s[i][j] = sum_d a[d][ra + i] * b[d][rb + j] over transposed tiles of 64
// rows: an fmaf chain over d in order, a's operand first
template <int D>
__device__ __forceinline__ void tile_dot(const float* aT, const float* bT, int ra, int rb,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = ld4(aT + d * 64 + ra);
    const float4 bv = ld4(bT + d * 64 + rb);
    const float aa[4] = {av.x, av.y, av.z, av.w};
    const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(aa[i], ba[j], s[i][j]);
  }
}

// acc[i][c][e] += sum_r P[r][row0 + i] * X[r][col(c, e)] over 64 rows r:
// P a [64][64] tile (r-major), X a [64][D] row-major tile
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* X, int row0, int tx,
                                         float (&acc)[4][Cols<D>::NCG][Cols<D>::CW]) {
  constexpr int CW = Cols<D>::CW, NCG = Cols<D>::NCG;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 pv = ld4(P + r * 64 + row0);
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      float xa[CW];
      load_cols<CW>(X + r * D + c * 16 * CW + tx * CW, xa);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[i][c][e] = fmaf(pa[i], xa[e], acc[i][c][e]);
    }
  }
}

// p, the masked probability, and its two derived values: P~ (what the
// forward multiplies into V) and dp from dP~; then ds = p (dp - D)
struct Grad {
  float pt, ds;
};
__device__ __forceinline__ Grad grad_at(const Args& a, bool valid, float s, float m, float zc,
                                        float dpt, float dsum) {
  const float p = valid ? expf(s - m) / zc : 0.f;
  float pt = p, dp = dpt;
  if (a.clipped) {
    const float x = a.zg * p + a.gamma;
    pt = valid ? fminf(fmaxf(x, 0.f), 1.f) : 0.f;
    dp = (valid && x > 0.f && x < 1.f) ? a.zg * dpt : 0.f;
  }
  return {pt, p * (dp - dsum)};
}

__device__ __forceinline__ long long stat_index(const Args& a, int b, int h, int t) {
  return ((long long)b * a.Hq + h) * a.Tq + t;
}

template <int D>
constexpr size_t rows_smem_floats() {
  return (size_t)D * BQ + (size_t)D * BK + (size_t)BK * D + 2 * (size_t)BK * BQ;
}

// 1. (m, Z), u and, clipped, w for one (b, h, query block); then D and dgate
template <int D>
__global__ void __launch_bounds__(NT, 1) bwd_rows_kernel(Args a) {
  constexpr int CW = Cols<D>::CW, NCG = Cols<D>::NCG;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* kT = qT + D * BQ;                       // [D][BK]
  float* vs = kT + D * BK;                       // [BK][D]
  float* pT = vs + BK * D;                       // [BK][BQ]: P~
  float* wT = pT + BK * BQ;                      // [BK][BQ]: p 1[unclipped]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const float* qg = a.q + b * a.sqb + h * a.sqh;
  const float* kg = a.k + b * a.skb + hk * a.skh;
  const float* vg = a.v + b * a.svb + hk * a.svh;
  const int k_hi = a.causal ? min(a.Tk, min(q0 + BQ, a.Tq)) : a.Tk;

  stage<D, BQ, true>(qg, a.sqt, q0, a.Tq, qT, a.scale);

  float m[4], z[4], acc[4][NCG][CW], accw[4][NCG][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::NEG_INF;
    z[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][c][e] = accw[i][c][e] = 0.f;
  }

  const int npass = a.clipped ? 2 : 1;
#pragma unroll 1
  for (int pass = 0; pass < npass; ++pass) {
    // vanilla: one online pass with P.V; clipped: pass 0 builds (m, Z),
    // pass 1 accumulates u = P~ V and w = (p 1[unclipped]) V
    const bool need_v = !a.clipped || pass == 1;
    const bool online = !a.clipped || pass == 0;
    float zc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zc[i] = fmaxf(z[i], attn::Z_FLOOR);
#pragma unroll 1
    for (int t0 = 0; t0 < k_hi; t0 += BK) {
      __syncthreads();
      stage<D, BK, true>(kg, a.skt, t0, a.Tk, kT);
      if (need_v) stage<D, BK, false>(vg, a.svt, t0, a.Tk, vs);
      __syncthreads();
      float s[4][4];
      tile_dot<D>(qT, kT, ty * 4, tx * 4, s);
      bool valid[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = t0 + tx * 4 + j;
          valid[i][j] = kp < a.Tk && attn::visible(kp, q0 + ty * 4 + i, a.causal, -1);
          s[i][j] = valid[i][j] ? s[i][j] : attn::NEG_INF;
        }
      float corr[4], w[4][4] = {};
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
          z[i] = z[i] * corr[i] + sum16(ps);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          corr[i] = 1.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = valid[i][j] ? expf(s[i][j] - m[i]) / zc[i] : 0.f;
            const float x = a.zg * p + a.gamma;
            s[i][j] = valid[i][j] ? fminf(fmaxf(x, 0.f), 1.f) : 0.f;
            w[i][j] = (valid[i][j] && x > 0.f && x < 1.f) ? p : 0.f;
          }
        }
      }
      if (!need_v) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store4(pT + (tx * 4 + j) * BQ + ty * 4, s[0][j], s[1][j], s[2][j], s[3][j]);
        if (!online) store4(wT + (tx * 4 + j) * BQ + ty * 4, w[0][j], w[1][j], w[2][j], w[3][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NCG; ++c)
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[i][c][e] *= corr[i];
      tile_acc<D>(pT, vs, ty * 4, tx, acc);
      if (!online) tile_acc<D>(wT, vs, ty * 4, tx, accw);
    }
  }

  // u = acc / Z (vanilla) or acc (clipped); dgate = dO . u; D = g . u
  // (vanilla) or zg g . w (clipped)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    const bool live = t < a.Tq;
    const float zc = fmaxf(z[i], attn::Z_FLOOR);
    float du = 0.f, dw = 0.f;
    if (live) {
      const float* dorow = a.dout + (((long long)b * a.Tq + t) * a.Hq + h) * D;
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
        float o[CW];
        load_cols<CW>(dorow + c * 16 * CW + tx * CW, o);
#pragma unroll
        for (int e = 0; e < CW; ++e) {
          du = fmaf(o[e], a.clipped ? acc[i][c][e] : acc[i][c][e] / zc, du);
          dw = fmaf(o[e], accw[i][c][e], dw);
        }
      }
    }
    du = sum16(du);
    dw = sum16(dw);
    if (live && tx == 0) {
      const float g = a.gate != nullptr ? a.gate[b * a.sgb + t * a.sgt + h * a.sgh] : 1.f;
      const long long si = stat_index(a, b, h, t);
      const long long bht = (long long)a.B * a.Hq * a.Tq;
      a.stats[si] = m[i];
      a.stats[bht + si] = zc;
      a.stats[2 * bht + si] = a.clipped ? a.zg * (g * dw) : g * du;
      if (a.dgate != nullptr) a.dgate[((long long)b * a.Tq + t) * a.Hq + h] = du;
    }
  }
}

template <int D>
constexpr size_t kv_smem_floats() {
  return 6 * (size_t)D * 64 + 2 * (size_t)BQ * BK + 3 * (size_t)BQ;
}

// 2. dk and dv of one (b, KV head, key block), over its G query heads
template <int D>
__global__ void __launch_bounds__(NT, 1) bwd_dkdv_kernel(Args a) {
  constexpr int CW = Cols<D>::CW, NCG = Cols<D>::NCG;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][BK]
  float* vT = kT + D * BK;                       // [D][BK]
  float* qT = vT + D * BK;                       // [D][BQ]: q Dh^-0.5
  float* gT = qT + D * BQ;                       // [D][BQ]: gate dO
  float* qr = gT + D * BQ;                       // [BQ][D]
  float* gr = qr + BQ * D;                       // [BQ][D]
  float* pS = gr + BQ * D;                       // [BQ][BK]: P~
  float* dsS = pS + BQ * BK;                     // [BQ][BK]: ds
  float* st = dsS + BQ * BK;                     // m, Z, D of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z, G = a.Hq / a.Hkv;
  stage<D, BK, true>(a.k + b * a.skb + hk * a.skh, a.skt, k0, a.Tk, kT);
  stage<D, BK, true>(a.v + b * a.svb + hk * a.svh, a.svt, k0, a.Tk, vT);

  float dk[4][NCG][CW], dv[4][NCG][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  const long long bht = (long long)a.B * a.Hq * a.Tq;
  const int q_lo = a.causal ? k0 : 0;  // BQ == BK: the tile holding query k0
#pragma unroll 1
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const float* qg = a.q + b * a.sqb + h * a.sqh;
    const float* dog = a.dout + ((long long)b * a.Tq * a.Hq + h) * D;
    const float* gg = a.gate != nullptr ? a.gate + b * a.sgb + h * a.sgh : nullptr;
#pragma unroll 1
    for (int q0 = q_lo; q0 < a.Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage<D, BQ, true>(qg, a.sqt, q0, a.Tq, qT, a.scale);
      stage<D, BQ, false>(qg, a.sqt, q0, a.Tq, qr, a.scale);
      stage<D, BQ, true>(dog, (long long)a.Hq * D, q0, a.Tq, gT, 0.f, gg, a.sgt);
      stage<D, BQ, false>(dog, (long long)a.Hq * D, q0, a.Tq, gr, 0.f, gg, a.sgt);
      if (tid < BQ) {
        const int t = q0 + tid;
        const long long si = stat_index(a, b, h, min(t, a.Tq - 1));
        st[tid] = a.stats[si];
        st[BQ + tid] = a.stats[bht + si];
        st[2 * BQ + tid] = a.stats[2 * bht + si];
      }
      __syncthreads();
      float s[4][4], dpt[4][4];
      tile_dot<D>(kT, qT, ty * 4, tx * 4, s);    // S^T: rows keys, columns queries
      tile_dot<D>(vT, gT, ty * 4, tx * 4, dpt);  // dP~^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j, qp = q0 + r;
        float pt[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + ty * 4 + i;
          const bool valid = kp < a.Tk && qp < a.Tq && attn::visible(kp, qp, a.causal, -1);
          const Grad gr_ = grad_at(a, valid, s[i][j], st[r], st[BQ + r], dpt[i][j], st[2 * BQ + r]);
          pt[i] = gr_.pt;
          ds[i] = gr_.ds;
        }
        store4(pS + r * BK + ty * 4, pt[0], pt[1], pt[2], pt[3]);
        store4(dsS + r * BK + ty * 4, ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      tile_acc<D>(pS, gr, ty * 4, tx, dv);
      tile_acc<D>(dsS, qr, ty * 4, tx, dk);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= a.Tk) continue;
    const long long row = (((long long)b * a.Tk + t) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      store_cols<CW>(a.dk + row + c * 16 * CW + tx * CW, dk[i][c]);
      store_cols<CW>(a.dv + row + c * 16 * CW + tx * CW, dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)D * 64 + (size_t)BK * D + (size_t)BK * BQ;
}

// 3. dq of one (b, h, query block)
template <int D>
__global__ void __launch_bounds__(NT, 1) bwd_dq_kernel(Args a) {
  constexpr int CW = Cols<D>::CW, NCG = Cols<D>::NCG;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]: q Dh^-0.5
  float* gT = qT + D * BQ;                       // [D][BQ]: gate dO
  float* kT = gT + D * BQ;                       // [D][BK]
  float* vT = kT + D * BK;                       // [D][BK]
  float* kr = vT + D * BK;                       // [BK][D]
  float* dsT = kr + BK * D;                      // [BK][BQ]: ds

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const float* kg = a.k + b * a.skb + hk * a.skh;
  const float* vg = a.v + b * a.svb + hk * a.svh;
  const float* dog = a.dout + ((long long)b * a.Tq * a.Hq + h) * D;
  stage<D, BQ, true>(a.q + b * a.sqb + h * a.sqh, a.sqt, q0, a.Tq, qT, a.scale);
  stage<D, BQ, true>(dog, (long long)a.Hq * D, q0, a.Tq, gT, 0.f,
                     a.gate != nullptr ? a.gate + b * a.sgb + h * a.sgh : nullptr, a.sgt);

  const long long bht = (long long)a.B * a.Hq * a.Tq;
  float m[4], zc[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long si = stat_index(a, b, h, min(q0 + ty * 4 + i, a.Tq - 1));
    m[i] = a.stats[si];
    zc[i] = a.stats[bht + si];
    dsum[i] = a.stats[2 * bht + si];
  }
  float dq[4][NCG][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) dq[i][c][e] = 0.f;

  const int k_hi = a.causal ? min(a.Tk, min(q0 + BQ, a.Tq)) : a.Tk;
#pragma unroll 1
  for (int t0 = 0; t0 < k_hi; t0 += BK) {
    __syncthreads();
    stage<D, BK, true>(kg, a.skt, t0, a.Tk, kT);
    stage<D, BK, true>(vg, a.svt, t0, a.Tk, vT);
    stage<D, BK, false>(kg, a.skt, t0, a.Tk, kr);
    __syncthreads();
    float s[4][4], dpt[4][4];
    tile_dot<D>(qT, kT, ty * 4, tx * 4, s);
    tile_dot<D>(gT, vT, ty * 4, tx * 4, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = t0 + tx * 4 + j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + ty * 4 + i;
        const bool valid = kp < a.Tk && qp < a.Tq && attn::visible(kp, qp, a.causal, -1);
        ds[i] = grad_at(a, valid, s[i][j], m[i], zc[i], dpt[i][j], dsum[i]).ds;
      }
      store4(dsT + (tx * 4 + j) * BQ + ty * 4, ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    tile_acc<D>(dsT, kr, ty * 4, tx, dq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.Tq) continue;
    float* row = a.dq + (((long long)b * a.Tq + t) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      float o[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) o[e] = dq[i][c][e] * a.scale;
      store_cols<CW>(row + c * 16 * CW + tx * CW, o);
    }
  }
}

template <typename K>
cudaError_t launch_one(K kern, dim3 grid, size_t smem_floats, const Args& a, cudaStream_t s) {
  const int smem = (int)(smem_floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 qgrid((a.Tq + BQ - 1) / BQ, a.Hq, a.B);
  cudaError_t err = launch_one(bwd_rows_kernel<D>, qgrid, rows_smem_floats<D>(), a, s);
  if (err != cudaSuccess) return err;
  err = launch_one(bwd_dkdv_kernel<D>, dim3((a.Tk + BK - 1) / BK, a.Hkv, a.B),
                   kv_smem_floats<D>(), a, s);
  if (err != cudaSuccess) return err;
  return launch_one(bwd_dq_kernel<D>, qgrid, dq_smem_floats<D>(), a, s);
}

}  // namespace

// f32 only. q, k, v, gate: element strides (unit last stride); dout, dq,
// dk, dv, dgate contiguous; stats: 3 * B * Hq * Tq floats of scratch.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* gate, const float* dout,
    float* dq, float* dk, float* dv, float* dgate, float* stats, int B, int Tq, int Tk, int Hq,
    int Hkv, int Dh, long long sqb, long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, long long sgb, long long sgt,
    long long sgh, int causal, int clipped, float zg, float gamma, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || (gate == nullptr) != (dgate == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, gate, dout, dq, dk, dv, dgate, stats, B, Tq, Tk, Hq, Hkv,
         sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh,
         causal, clipped, zg, gamma, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 32) return (int)launch<32>(a, s);
  if (Dh == 64) return (int)launch<64>(a, s);
  return (int)cudaErrorInvalidValue;
}
