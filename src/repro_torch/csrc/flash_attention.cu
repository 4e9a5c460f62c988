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
// Design. On the TPU the KV axis is a sequential grid dimension carrying
// (m, Z, acc) in VMEM scratch. Here one CTA of 256 threads owns one
// (batch row, query head, block of 64 queries) and walks the KV axis in
// tiles of 64 keys itself, so (m, Z, acc) live in registers for the whole
// walk and both clipped passes run in one launch. The walk stops at the
// causal edge of its last query and starts at the window's first key:
// masked entries add exact zeros, so that is exact. Products run in f32
// on the CUDA cores (f32 inputs must stay within 3e-5 of the plain
// version, which rules out rounding P to bf16): each thread owns a 4x4
// tile of scores and a 4x(4*Dh/64) tile of the output; Q and K are staged
// transposed in shared memory so each inner step reads two float4 (one a
// broadcast) for 16 FMAs. bf16 inputs are widened to f32 on load. Left
// for later work: bf16 tensor-core products (mma/wgmma), cp.async/TMA
// double buffering of K/V, and splitting the KV walk for short queries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;  // threads per CTA: 16 x 16
constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 64;   // keys per tile
constexpr float NEG_INF = -1e30f;

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
__global__ void __launch_bounds__(NT, 2) flash_kernel(Args a) {
  constexpr int NCG = D / 64;  // float4 column groups of the output per thread
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

  float m[4], z[4], acc[4][NCG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    z[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
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
    for (int i = 0; i < 4; ++i) zc[i] = fmaxf(z[i], 1e-30f);
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
          bool ok = kp < a.Tk;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window >= 0) ok = ok && kp > qp - a.window;
          float x = s[i][j];
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          s[i][j] = ok ? x : NEG_INF;
          valid[i][j] = ok;
        }
      }

      float corr[4];
      if (online) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mx = max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
          const float m_new = fmaxf(m[i], mx);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = valid[i][j] ? expf(s[i][j] - m_new) : 0.f;
            ps += s[i][j];
          }
          ps = sum16(ps);
          corr[i] = expf(m[i] - m_new);
          z[i] = z[i] * corr[i] + ps;
          m[i] = m_new;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          corr[i] = 1.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = expf(s[i][j] - m[i]) / zc[i];
            const float c = fminf(fmaxf(a.zg * p + a.gamma, 0.f), 1.f);
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
          for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 pv = *reinterpret_cast<const float4*>(pT + j * BQ + ty * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int c = 0; c < NCG; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + c * 64 + tx * 4);
          const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][c][e] = fmaf(pa[i], va[e], acc[i][c][e]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.Tq) continue;
    const float zc = fmaxf(z[i], 1e-30f);
    const float g = a.gate != nullptr ? a.gate[b * a.sgb + t * a.sgt + h * a.sgh] : 1.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = CLIPPED ? acc[i][c][e] : acc[i][c][e] / zc;
        if (a.gate != nullptr) o[e] *= g;
      }
      store4(out + (long long)t * a.sot + c * 64 + tx * 4, o);
    }
  }
}

template <typename T, bool CLIPPED, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_kernel<T, CLIPPED, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_clip(const Args& a, bool clipped, cudaStream_t s) {
  return clipped ? launch<T, true, D>(a, s) : launch<T, false, D>(a, s);
}

template <typename T>
cudaError_t dispatch(const Args& a, int dh, bool clipped, cudaStream_t s) {
  if (dh == 64) return dispatch_clip<T, 64>(a, clipped, s);
  if (dh == 128) return dispatch_clip<T, 128>(a, clipped, s);
  if (dh == 256) return dispatch_clip<T, 256>(a, clipped, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides in
// elements. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const float* gate, const int* q_offs,
    void* out, int B, int Tq, int Tk, int Hq, int Hkv, int Dh, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sot, long long soh, long long sgb, long long sgt,
    long long sgh, int q_offset, int causal, int window, float softcap, int clipped,
    float zg, float gamma, float scale, int dtype, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, gate, q_offs, out, B, Tq, Tk, Hq, Hkv, sqb, sqt, sqh, skb, skt, skh,
         svb, svt, svh, sob, sot, soh, sgb, sgt, sgh, q_offset, causal, window, softcap,
         zg, gamma, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, Dh, clipped != 0, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, Dh, clipped != 0, s);
  return (int)cudaErrorInvalidValue;
}
