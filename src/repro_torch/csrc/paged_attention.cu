// Paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py : paged_flash_attention
// (bodies _vanilla_kernel, _mz_kernel, _av_kernel): fused attention over a
// paged KV pool, every table entry read in place through a per-row block
// table, with head-packed GQA, causal/window masks over logical
// positions, -1 (unallocated) entries masked, logit softcap, the vanilla
// one-pass online softmax or the paper's two-pass clipped softmax
// clip((zeta - gamma) * p + gamma, 0, 1), the gate pi multiplied in the
// epilogue, and int8 pools dequantized on load by per-slot scales.
//
// Layout (the TPU kernel's): q (B, Hkv, TQG, Dh) with TQG = Tq * G and
// query row r = token r / G, head lane r % G; pools (NB, BS, Hkv, Dh) f32,
// bf16 or int8 (bf16 pools also under f32 q, read into f32); scales (NB, BS) f32; table (B, W) int32; q_off (B,)
// int32; live_widths (B,) int32 or null; gate (B, Hkv, TQG) f32 or null;
// out like q.
//
// What bounds it on an H100: the bytes of K/V it visits. A decode tick
// reads every live K/V token of every row once per layer (2 * Hkv * Dh
// elements per token) and does ~4 * G * Dh flops per element read, far
// below the ~295 flop/byte the card needs to be compute bound, so the
// floor is (K/V bytes visited) / 3.35 TB/s.
//
// Design. On the TPU a sequential grid axis over table entries carries
// the online-softmax state in VMEM. Here one CTA owns one (row b, kv head
// h, tile of ROWS query rows) and walks that row's table itself, KT
// tokens per step, so the state (m, z, the f32 accumulator) lives in the
// CTA for the whole walk and the clipped path's two passes — (m, Z) first,
// then the clipped P.V — run inside ONE launch with no cross-CTA
// reduction. What it does about the byte bound: every K/V element it
// stages is read from device memory once per CTA and then serves all G
// query heads of the KV head (head packing); the walk stops at the row's
// own live block count (live_widths) and at the last causally reachable
// token of the tile, and starts at the first token inside the window, so
// it visits live tokens only, never the table's full width. Masked
// entries contribute exact zeros, so skipping them is exact. K/V are
// staged with 16-byte loads, several in flight per thread. Left for
// later work: splitting the KV walk across CTAs for small batches,
// overlapping the next tile's loads with this tile's math (cp.async/TMA),
// and tensor-core (wgmma) products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 128;   // threads per CTA (4 warps)
constexpr int ROWS = 16;  // query rows per CTA
constexpr int KT = 64;    // KV tokens staged per step
constexpr int RPT = ROWS / (NT / KT);  // score rows per thread
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* q_off;
  const int* live_widths;
  const float* gate;
  void* out;
  int B, Hkv, TQG, Dh, NB, BS, W, G;
  int causal, window;  // window < 0: no window
  float softcap;       // <= 0: no softcap
  float gamma, zeta, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage KT tokens of one pool (K or V, head h) into shared memory as f32,
// dequantized by the per-token scale. Loads are 16-byte vectors, U of them
// issued per thread before any is used, so many loads are in flight: a
// load per element, consumed at once, would serialize on its latency.
// Tokens with row < 0 (masked, unallocated or past the span) stage zeros.
template <typename TKV>
__device__ __forceinline__ void stage(const TKV* __restrict__ pool, float* dst, int dst_stride,
                                      const int* row_s, const float* sc_s, int hkv, int h,
                                      int dh) {
  constexpr int VE = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int U = 8;
  const int vr = dh / VE;  // vectors per token row (dh * sizeof(TKV) % 16 == 0)
  const int nvec = KT * vr;
  for (int base = threadIdx.x; base < nvec; base += NT * U) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec) {
        const int j = i / vr, c = i - j * vr;
        const int row = row_s[j];
        if (row >= 0) {
          raw[u] = *reinterpret_cast<const uint4*>(pool + ((size_t)row * hkv + h) * dh + c * VE);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      if (i < nvec) {
        const int j = i / vr, c = i - j * vr;
        TKV e[VE];
        memcpy(e, &raw[u], sizeof(raw[u]));
        const float sc = sc_s[j];
        float* out = dst + j * dst_stride + c * VE;
#pragma unroll
        for (int x = 0; x < VE; ++x) out[x] = to_f(e[x]) * sc;
      }
    }
  }
}

size_t smem_bytes(int dh) {
  size_t floats = (size_t)ROWS * dh      // q tile
                  + (size_t)KT * (dh + 1)  // K tile (padded: no bank conflicts)
                  + (size_t)KT * dh        // V tile
                  + (size_t)ROWS * KT      // scores, then probabilities
                  + 3 * ROWS               // m, z, correction
                  + 2 * KT;                // per-token k/v scales
  return floats * sizeof(float) + KT * sizeof(int) + ROWS * KT;
}

template <typename TQ, typename TKV, bool CLIPPED, int DCOLS>
__global__ void __launch_bounds__(NT) paged_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int dh = a.Dh;
  const int kst = dh + 1;
  float* q_s = smem;
  float* k_s = q_s + ROWS * dh;
  float* v_s = k_s + KT * kst;
  float* sc_s = v_s + KT * dh;
  float* m_s = sc_s + ROWS * KT;
  float* z_s = m_s + ROWS;
  float* corr_s = z_s + ROWS;
  float* ksc_s = corr_s + ROWS;
  float* vsc_s = ksc_s + KT;
  int* row_s = reinterpret_cast<int*>(vsc_s + KT);
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(row_s + KT);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = min(ROWS, a.TQG - r0);
  const int qoff = a.q_off[b];

  // the span of logical tokens this tile can see: the row's live entries,
  // cut at the last causally reachable token and at the window's start
  int nw = a.W;
  if (a.live_widths != nullptr) nw = min(nw, max(a.live_widths[b], 0));
  int tok_hi = nw * a.BS;
  const int qpos_lo = qoff + r0 / a.G;
  const int qpos_hi = qoff + (r0 + n_rows - 1) / a.G;
  if (a.causal) tok_hi = min(tok_hi, qpos_hi + 1);
  int tok_lo = 0;
  if (a.window >= 0) tok_lo = max(0, qpos_lo - a.window + 1);

  const size_t qbase = ((size_t)(b * a.Hkv + h) * a.TQG + r0) * dh;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
#pragma unroll 8
  for (int i = tid; i < ROWS * dh; i += NT) {
    q_s[i] = (i / dh) < n_rows ? to_f(q[qbase + i]) : 0.f;
  }
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    z_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }

  float acc[DCOLS][ROWS];
#pragma unroll
  for (int c = 0; c < DCOLS; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  constexpr int NPASS = CLIPPED ? 2 : 1;
  for (int pass = 0; pass < NPASS; ++pass) {
    // vanilla: one online pass with P.V; clipped: pass 0 builds (m, z),
    // pass 1 accumulates clip((zeta - gamma) * p + gamma, 0, 1) . V
    const bool need_v = !CLIPPED || pass == 1;
    const bool online = !CLIPPED || pass == 0;
    for (int t0 = tok_lo; t0 < tok_hi; t0 += KT) {
      __syncthreads();  // the previous step's readers are done
      if (tid < KT) {
        const int tok = t0 + tid;
        int row = -1;
        if (tok < tok_hi) {
          const int blk = a.table[(size_t)b * a.W + tok / a.BS];
          if (blk >= 0) row = min(blk, a.NB - 1) * a.BS + tok % a.BS;
        }
        row_s[tid] = row;
        ksc_s[tid] = (a.k_scale != nullptr && row >= 0) ? a.k_scale[row] : 1.f;
        vsc_s[tid] = (a.v_scale != nullptr && row >= 0) ? a.v_scale[row] : 1.f;
      }
      __syncthreads();
      stage(kp, k_s, kst, row_s, ksc_s, a.Hkv, h, dh);
      if (need_v) stage(vp, v_s, dh, row_s, vsc_s, a.Hkv, h, dh);
      __syncthreads();
      {  // masked scores: thread -> (token j, RPT rows)
        const int j = tid % KT;
        const int rg = tid / KT;
        float s[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i] = 0.f;
        const float* kr = k_s + j * kst;
        const float* qr = q_s + rg * RPT * dh;
        for (int d = 0; d < dh; ++d) {
          const float kv = kr[d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) s[i] += qr[i * dh + d] * kv;
        }
        const int tok = t0 + j;
        const bool live = row_s[j] >= 0;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg * RPT + i;
          const int qp = qoff + (r0 + r) / a.G;
          bool m = live && r < n_rows;
          if (a.causal) m = m && tok <= qp;
          if (a.window >= 0) m = m && tok > qp - a.window;
          float x = s[i] * a.scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          sc_s[r * KT + j] = m ? x : NEG_INF;
          msk_s[r * KT + j] = m ? 1 : 0;
        }
      }
      __syncthreads();
      for (int r = warp; r < ROWS; r += NT / 32) {  // one warp per row
        float* sr = sc_s + r * KT;
        const unsigned char* mr = msk_s + r * KT;
        const float x0 = sr[lane], x1 = sr[lane + 32];
        const bool k0 = mr[lane] != 0, k1 = mr[lane + 32] != 0;
        if (online) {
          const float m_prev = m_s[r];
          const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
          const float p0 = k0 ? expf(x0 - m_new) : 0.f;
          const float p1 = k1 ? expf(x1 - m_new) : 0.f;
          const float ps = warp_sum(p0 + p1);
          sr[lane] = p0;
          sr[lane + 32] = p1;
          __syncwarp();
          if (lane == 0) {
            const float c = expf(m_prev - m_new);
            corr_s[r] = c;
            z_s[r] = z_s[r] * c + ps;
            m_s[r] = m_new;
          }
        } else {
          const float m = m_s[r];
          const float z = fmaxf(z_s[r], 1e-30f);
          float p0 = expf(x0 - m) / z, p1 = expf(x1 - m) / z;
          p0 = fminf(fmaxf((a.zeta - a.gamma) * p0 + a.gamma, 0.f), 1.f);
          p1 = fminf(fmaxf((a.zeta - a.gamma) * p1 + a.gamma, 0.f), 1.f);
          sr[lane] = k0 ? p0 : 0.f;  // masked entries zeroed after the clip
          sr[lane + 32] = k1 ? p1 : 0.f;
          if (lane == 0) corr_s[r] = 1.f;
        }
      }
      __syncthreads();
      if (need_v) {  // thread -> head-dim column(s), all ROWS rows
#pragma unroll
        for (int c = 0; c < DCOLS; ++c) {
          const int d = tid + c * NT;
          if (d < dh) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[c][r] *= corr_s[r];
            for (int j = 0; j < KT; ++j) {
              const float vv = v_s[j * dh + d];
#pragma unroll
              for (int r = 0; r < ROWS; ++r) acc[c][r] += sc_s[r * KT + j] * vv;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out);
  const float* gate = a.gate != nullptr ? a.gate + (size_t)(b * a.Hkv + h) * a.TQG + r0 : nullptr;
#pragma unroll
  for (int c = 0; c < DCOLS; ++c) {
    const int d = tid + c * NT;
    if (d >= dh) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= n_rows) continue;
      float o = acc[c][r];
      if (!CLIPPED) o = o / fmaxf(z_s[r], 1e-30f);
      if (gate != nullptr) o *= gate[r];
      store(out + qbase + (size_t)r * dh + d, o);
    }
  }
}

template <typename TQ, typename TKV, bool CLIPPED, int DCOLS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_attn_kernel<TQ, TKV, CLIPPED, DCOLS>;
  const size_t smem = smem_bytes(a.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.TQG + ROWS - 1) / ROWS, a.Hkv, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const Args& a, bool clipped, cudaStream_t stream) {
  if (a.Dh <= NT) {
    return clipped ? launch<TQ, TKV, true, 1>(a, stream) : launch<TQ, TKV, false, 1>(a, stream);
  }
  return clipped ? launch<TQ, TKV, true, 2>(a, stream) : launch<TQ, TKV, false, 2>(a, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* table, const int* q_off, const int* live_widths,
    const float* gate, void* out, int B, int Hkv, int TQG, int Dh, int NB, int BS, int W,
    int G, int causal, int window, float softcap, int clipped, float gamma, float zeta,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  const int kv_bytes = kv_dtype == 0 ? 4 : (kv_dtype == 1 ? 2 : 1);
  if (Dh < 1 || Dh > 2 * NT || (Dh * kv_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0 || B < 1 || Hkv < 1 || TQG < 1 ||
      BS < 1 || W < 1 || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k_pool, v_pool, k_scale, v_scale, table, q_off, live_widths, gate, out,
         B, Hkv, TQG, Dh, NB, BS, W, G, causal, window, softcap, gamma, zeta, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return (int)dispatch<float, float>(a, clipped != 0, s);
  if (q_dtype == 1 && kv_dtype == 1) return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(a, clipped != 0, s);
  if (q_dtype == 0 && kv_dtype == 1) return (int)dispatch<float, __nv_bfloat16>(a, clipped != 0, s);
  if (q_dtype == 0 && kv_dtype == 2) return (int)dispatch<float, int8_t>(a, clipped != 0, s);
  if (q_dtype == 1 && kv_dtype == 2) return (int)dispatch<__nv_bfloat16, int8_t>(a, clipped != 0, s);
  return (int)cudaErrorInvalidValue;
}
