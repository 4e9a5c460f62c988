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
// epilogue, and int8 pools dequantized by per-slot scales. The arithmetic
// shared with the flash kernel is in attn_common.cuh.
//
// Layout (the TPU kernel's): q (B, Hkv, TQG, Dh) with TQG = Tq * G and
// query row r = token r / G, head lane r % G; pools (NB, BS, Hkv, Dh) f32,
// bf16 or int8 (bf16 pools also under f32 q, read into f32); scales (NB,
// BS) f32; table (B, W) int32; q_off (B,) int32; live_widths (B,) int32
// or null; gate (B, Hkv, TQG) f32 or null; out like q.
//
// What bounds it on an H100: the bytes of K/V it visits. A decode tick
// reads every live K/V token of every row once per layer (2 * Hkv * Dh
// elements per token) and does ~4 * G * Dh flops per element read, far
// below the ~295 flop/byte the card needs to be compute bound, so the
// floor is (K/V bytes visited) / 3.35 TB/s. Every route visits live
// tokens only: a CTA's walk stops at the row's own live block count
// (live_widths) and at the last causally reachable token of its rows, and
// starts at the first token inside the window; masked entries contribute
// exact zeros, so skipping them is exact. Every K/V element a CTA stages
// serves all G query heads of its KV head (head packing).
//
// Routes, chosen by the wrapper from dtypes and shape (kernels/
// paged_attention.py : plan), which passes its choice; this file
// dispatches on it and refuses a route not built for the inputs:
//   * tensor cores (bf16 q over a bf16 or int8 pool, TQG > 16, Dh 64 or
//     128: prefill chunks and speculative verification). One CTA of 4
//     warps owns 64 head-packed query rows (16 per warp) of one (row b,
//     kv head h) and walks the row's table in tiles of 64 tokens. Each
//     tile's pages are gathered through the block table with 16-byte
//     cp.async copies into a double-buffered shared-memory tile, so the
//     next tile's pages arrive during this tile's math. S = Q K^T and
//     O += P V run as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     ldmatrix fragments (ldmatrix.trans for V). mma.sync rather than
//     wgmma: the tile is gathered from 16-token pages strided by Hkv * Dh,
//     which suits cp.async better than a TMA box, and Tq is short (at most
//     the 256-token budget). Scores are scaled in f32 after the product, as
//     the plain version does. P keeps f32 precision as a hi/lo pair of bf16
//     operands (attn::split_hi_lo2). int8 codes (-127..127) are exact in
//     bf16, so the products run on the codes: the per-token K scale
//     multiplies the score column after the product and the per-token V
//     scale multiplies P before the split; both equal dequantize-first up
//     to f32 rounding.
//   * CUDA cores (every other case: f32 queries, which are held at the
//     f32 tolerance, and short reads). One CTA of 128 threads owns 16 query
//     rows and walks tiles of 64 tokens staged into shared memory as f32,
//     dequantized on load, 16-byte loads several in flight per thread.
//     When TQG <= 16 (decode) the walk is split: each row's live span is
//     cut into nsplit chunks so that the grid fills the card (a decode
//     tick has only B * Hkv row tiles). Each split writes its partial
//     (m, Z, acc) to an f32 workspace; the last split of a row tile to
//     finish (an atomic ticket on a zeroed counter) merges them, so the
//     vanilla read stays one launch. The clipped softmax needs the global
//     (m, Z) before its P.V pass: a first launch writes each split's
//     (m, Z), a second merges them at its start, accumulates its
//     clip(.) V partial (partials add with no rescale), and the last split
//     sums them. A split that sees no live key contributes m = -1e30,
//     Z = 0, which the merge weighs by exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attn_common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA (4 warps), both routes
constexpr int ROWS = 16;  // query rows per CTA, CUDA-core route
constexpr int KT = 64;    // KV tokens per tile: tensor-core route, CUDA-core unsplit
constexpr int KT_SPLIT = 32;  // KV tokens per tile of a split read
constexpr int MAX_SPLITS = 16;

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
  float* ws;     // split partials: m, z [parts][nsplit][ROWS], acc [parts][nsplit][ROWS][Dh]
  int* tickets;  // [parts], zeroed by the wrapper
  int B, Hkv, TQG, Dh, NB, BS, W, G;
  int causal, window;  // window < 0: no window
  float softcap;       // <= 0: no softcap
  float gamma, zeta, scale;
  int nsplit;
  int clip_phase;      // clipped and split: 1 = (m, Z) partials, 2 = merge + clipped P.V
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

// The span of logical tokens [lo, hi) that query rows [r0, r0 + n_rows)
// of row b can see: the row's live entries, cut at the last causally
// reachable token and at the window's start.
__device__ __forceinline__ int2 token_span(const Args& a, int b, int r0, int n_rows) {
  const int qoff = a.q_off[b];
  int nw = a.W;
  if (a.live_widths != nullptr) nw = min(nw, max(a.live_widths[b], 0));
  int hi = nw * a.BS;
  if (a.causal) hi = min(hi, qoff + (r0 + n_rows - 1) / a.G + 1);
  int lo = 0;
  if (a.window >= 0) lo = max(0, qoff + r0 / a.G - a.window + 1);
  return make_int2(lo, hi);
}

// table entry of logical token tok of row b
__device__ __forceinline__ int table_entry(const Args& a, int b, int tok) {
  return a.table[(size_t)b * a.W + tok / a.BS];
}

// pool row (block * BS + slot) of logical token tok, whose table entry is
// blk, or -1 for an unallocated entry
__device__ __forceinline__ int pool_row(const Args& a, int blk, int tok) {
  return blk >= 0 ? min(blk, a.NB - 1) * a.BS + tok % a.BS : -1;
}

// ---------------------------------------------------------------------------
// CUDA-core route (and the split-KV read)
// ---------------------------------------------------------------------------

// Stage KT tokens of K (and of V when need_v) of head h into shared
// memory as f32, dequantized by the per-token scales. Loads are 16-byte
// vectors, U of them per pool issued per thread before any is used, so
// many loads are in flight: a load per element, consumed at once, would
// serialize on its latency. Tokens with row < 0 (masked, unallocated or
// past the span) stage zeros.
template <int KT, typename TKV>
__device__ __forceinline__ void stage(const TKV* __restrict__ kp, const TKV* __restrict__ vp,
                                      bool need_v, float* k_dst, int k_stride, float* v_dst,
                                      const int* row_s, const float* ksc_s, const float* vsc_s,
                                      int hkv, int h, int dh) {
  constexpr int VE = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int U = 4;                  // per pool: 8 loads in flight per thread
  const int vr = dh / VE;  // vectors per token row (dh * sizeof(TKV) % 16 == 0)
  const int nvec = KT * vr;
  for (int base = threadIdx.x; base < nvec; base += NT * U) {
    uint4 rk[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      rk[u] = rv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec) {
        const int j = i / vr, c = i - j * vr;
        const int row = row_s[j];
        if (row >= 0) {
          const size_t off = ((size_t)row * hkv + h) * dh + c * VE;
          rk[u] = *reinterpret_cast<const uint4*>(kp + off);
          if (need_v) rv[u] = *reinterpret_cast<const uint4*>(vp + off);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT;
      if (i < nvec) {
        const int j = i / vr, c = i - j * vr;
        TKV e[VE];
        memcpy(e, &rk[u], sizeof(rk[u]));
        const float ks = ksc_s[j];
        float* ko = k_dst + j * k_stride + c * VE;
#pragma unroll
        for (int x = 0; x < VE; ++x) ko[x] = to_f(e[x]) * ks;
        if (need_v) {
          memcpy(e, &rv[u], sizeof(rv[u]));
          const float vs = vsc_s[j];
          float* vo = v_dst + j * dh + c * VE;
#pragma unroll
          for (int x = 0; x < VE; ++x) vo[x] = to_f(e[x]) * vs;
        }
      }
    }
  }
}

size_t smem_bytes_cc(int dh, int KT) {
  size_t floats = (size_t)ROWS * dh      // q tile
                  + (size_t)KT * (dh + 1)  // K tile (padded: no bank conflicts)
                  + (size_t)KT * dh        // V tile
                  + (size_t)ROWS * KT      // scores, then probabilities
                  + 3 * ROWS               // m, z, correction
                  + 2 * KT;                // per-token k/v scales
  return floats * sizeof(float) + KT * sizeof(int) + ROWS * KT;
}

template <typename TQ, typename TKV, bool CLIPPED, int DCOLS, int KT>
__global__ void __launch_bounds__(NT) paged_attn_cc(Args a) {
  constexpr int RPT = ROWS / (NT / KT);  // score rows per thread
  constexpr int PL = KT / 32;            // scores per lane in the softmax
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
  const int nsplit = a.nsplit;
  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int r0 = tile * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = min(ROWS, a.TQG - r0);
  const int qoff = a.q_off[b];

  int2 span = token_span(a, b, r0, n_rows);
  int tok_lo = span.x, tok_hi = span.y;
  if (nsplit > 1) {  // this split's chunk of the span, in whole tiles
    const int len = max(tok_hi - tok_lo, 0);
    const int chunk = ((len + nsplit - 1) / nsplit + KT - 1) / KT * KT;
    tok_lo += split * chunk;
    tok_hi = min(tok_hi, tok_lo + chunk);
  }

  const size_t qbase = ((size_t)(b * a.Hkv + h) * a.TQG + r0) * dh;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
#pragma unroll 8
  for (int i = tid; i < ROWS * dh; i += NT) {
    q_s[i] = (i / dh) < n_rows ? to_f(q[qbase + i]) : 0.f;
  }
  if (tid < ROWS) {
    m_s[tid] = attn::NEG_INF;
    z_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }

  // split partials of this (b, h, tile): part p, split s
  const int ntiles = gridDim.x / nsplit;
  const size_t part = ((size_t)b * a.Hkv + h) * ntiles + tile;
  const size_t nparts = (size_t)a.B * a.Hkv * ntiles;
  float* ws_m = a.ws;
  float* ws_z = ws_m + nparts * nsplit * ROWS;
  float* ws_acc = ws_z + nparts * nsplit * ROWS;
  const size_t pm = part * nsplit * ROWS;           // m/z of split 0, row 0
  const size_t pacc = part * nsplit * ROWS * dh;    // acc of split 0, row 0

  int pass_lo = 0, pass_hi = CLIPPED ? 2 : 1;
  if (CLIPPED && a.clip_phase == 1) pass_hi = 1;
  if (CLIPPED && a.clip_phase == 2) {
    // the global (m, Z) of each row, merged from every split's partial
    pass_lo = 1;
    if (tid < n_rows) {
      float ms[MAX_SPLITS], zs[MAX_SPLITS], w[MAX_SPLITS];
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s) {
        ms[s] = s < nsplit ? __ldcg(ws_m + pm + s * ROWS + tid) : attn::NEG_INF;
        zs[s] = s < nsplit ? __ldcg(ws_z + pm + s * ROWS + tid) : 0.f;
      }
      attn::merge_parts<MAX_SPLITS>(ms, zs, nsplit, m_s[tid], z_s[tid], w);
    }
  }

  float acc[DCOLS][ROWS];
#pragma unroll
  for (int c = 0; c < DCOLS; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  // token tid's table entry for the tile at t0 (threads < KT), read one
  // tile ahead so that its latency hides behind the K/V loads
  auto entry = [&](int t0) {
    const int tok = t0 + tid;
    return tid < KT && tok < tok_hi ? table_entry(a, b, tok) : -1;
  };
  int blk = entry(tok_lo);
  for (int pass = pass_lo; pass < pass_hi; ++pass) {
    // vanilla: one online pass with P.V; clipped: pass 0 builds (m, z),
    // pass 1 accumulates clip((zeta - gamma) * p + gamma, 0, 1) . V
    const bool need_v = !CLIPPED || pass == 1;
    const bool online = !CLIPPED || pass == 0;
    for (int t0 = tok_lo; t0 < tok_hi; t0 += KT) {
      __syncthreads();  // the previous step's readers are done
      if (tid < KT) {
        const int row = pool_row(a, blk, t0 + tid);
        row_s[tid] = row;
        ksc_s[tid] = (a.k_scale != nullptr && row >= 0) ? a.k_scale[row] : 1.f;
        vsc_s[tid] = (a.v_scale != nullptr && row >= 0) ? a.v_scale[row] : 1.f;
      }
      __syncthreads();
      blk = entry(t0 + KT < tok_hi ? t0 + KT : tok_lo);  // the next tile (or pass)
      stage<KT>(kp, vp, need_v, k_s, kst, v_s, row_s, ksc_s, vsc_s, a.Hkv, h, dh);
      __syncthreads();
      {  // masked scores: thread -> (token j, RPT rows)
        const int j = tid % KT;
        const int rg = tid / KT;  // rows of this group past TQG are skipped
        float s[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i] = 0.f;
        const float* kr = k_s + j * kst;
        const float* qr = q_s + rg * RPT * dh;
        for (int d = 0; d < (rg * RPT < n_rows ? dh : 0); ++d) {
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
          const bool m = live && r < n_rows && attn::visible(tok, qp, a.causal, a.window);
          sc_s[r * KT + j] = m ? attn::softcap(s[i] * a.scale, a.softcap) : attn::NEG_INF;
          msk_s[r * KT + j] = m ? 1 : 0;
        }
      }
      __syncthreads();
      for (int r = warp; r < ROWS; r += NT / 32) {  // one warp per row
        float* sr = sc_s + r * KT;
        const unsigned char* mr = msk_s + r * KT;
        float x[PL];
        bool k[PL];
        float mx = attn::NEG_INF;
#pragma unroll
        for (int e = 0; e < PL; ++e) {
          x[e] = sr[lane + 32 * e];
          k[e] = mr[lane + 32 * e] != 0;
          mx = fmaxf(mx, x[e]);
        }
        if (online) {
          float m = m_s[r];
          const float c = attn::online_rescale(m, warp_max(mx));
          float ps = 0.f;
#pragma unroll
          for (int e = 0; e < PL; ++e) {
            const float p = k[e] ? expf(x[e] - m) : 0.f;
            sr[lane + 32 * e] = p;
            ps += p;
          }
          ps = warp_sum(ps);
          __syncwarp();
          if (lane == 0) {
            corr_s[r] = c;
            z_s[r] = z_s[r] * c + ps;
            m_s[r] = m;
          }
        } else {
          const float m = m_s[r];
          const float zc = fmaxf(z_s[r], attn::Z_FLOOR);
          const float zg = a.zeta - a.gamma;
          // masked entries zeroed after the clip
#pragma unroll
          for (int e = 0; e < PL; ++e)
            sr[lane + 32 * e] = k[e] ? attn::clipped_prob(x[e], m, zc, zg, a.gamma) : 0.f;
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
              for (int r = 0; r < ROWS; ++r) {
                if (r < n_rows) acc[c][r] += sc_s[r * KT + j] * vv;  // rows past TQG: none
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out);
  const float* gate = a.gate != nullptr ? a.gate + (size_t)(b * a.Hkv + h) * a.TQG + r0 : nullptr;
  if (nsplit == 1) {
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tid + c * NT;
      if (d >= dh) continue;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= n_rows) continue;
        float o = acc[c][r];
        if (!CLIPPED) o = o / fmaxf(z_s[r], attn::Z_FLOOR);
        if (gate != nullptr) o *= gate[r];
        store(out + qbase + (size_t)r * dh + d, o);
      }
    }
    return;
  }

  // split: write this split's partial, then the last split of the tile
  // to finish merges all of them
  if (tid < n_rows && (!CLIPPED || a.clip_phase == 1)) {
    ws_m[pm + split * ROWS + tid] = m_s[tid];
    ws_z[pm + split * ROWS + tid] = z_s[tid];
  }
  if (CLIPPED && a.clip_phase == 1) return;
#pragma unroll
  for (int c = 0; c < DCOLS; ++c) {
    const int d = tid + c * NT;
    if (d >= dh) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < n_rows) ws_acc[pacc + ((size_t)split * ROWS + r) * dh + d] = acc[c][r];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.tickets + part, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* w_s = sc_s;  // [MAX_SPLITS][ROWS]: each split's weight per row
  if (tid < n_rows) {
    float ms[MAX_SPLITS], zs[MAX_SPLITS], w[MAX_SPLITS], zr;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      ms[s] = s < nsplit ? __ldcg(ws_m + pm + s * ROWS + tid) : attn::NEG_INF;
      zs[s] = s < nsplit ? __ldcg(ws_z + pm + s * ROWS + tid) : 0.f;
    }
    float mr;
    attn::merge_parts<MAX_SPLITS>(ms, zs, nsplit, mr, zr, w);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) w_s[s * ROWS + tid] = CLIPPED ? 1.f : w[s];
    z_s[tid] = zr;
  }
  __syncthreads();
  // partials of the clipped P.V add with weight 1 (no rescale)
  for (int i = tid; i < n_rows * dh; i += NT) {
    const int r = i / dh, d = i - r * dh;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < nsplit) o += __ldcg(ws_acc + pacc + ((size_t)s * ROWS + r) * dh + d) * w_s[s * ROWS + r];
    }
    if (!CLIPPED) o = o / fmaxf(z_s[r], attn::Z_FLOOR);
    if (gate != nullptr) o *= gate[r];
    store(out + qbase + (size_t)r * dh + d, o);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 q, bf16 or int8 pool, TQG > 16, Dh 64 / 128)
// ---------------------------------------------------------------------------
namespace mma {

constexpr int ROWS = 64;  // head-packed query rows per CTA, 16 per warp

// Shared memory: Q, two stages of K and V as they arrive (bf16, or int8
// codes), for int8 one bf16 copy of the current K and V, and per stage
// the tokens' pool rows and scales. Row strides carry 16 bytes of pad, so
// the 8 row addresses of an ldmatrix hit 8 distinct bank groups.
template <typename TKV, int D>
struct Smem {
  static constexpr int LD = D + 8;                      // bf16 elements per row
  static constexpr int RAW_LD = D + 16 / sizeof(TKV);   // TKV elements per arriving row
  static constexpr int Q_OFF = 0;
  static constexpr int RAW_OFF = Q_OFF + ROWS * LD * 2;
  static constexpr int RAW_TILE = KT * RAW_LD * (int)sizeof(TKV);
  static constexpr int CVT_OFF = RAW_OFF + 4 * RAW_TILE;  // stages x {K, V}
  static constexpr bool CONVERT = sizeof(TKV) == 1;
  static constexpr int CVT_TILE = KT * LD * 2;
  static constexpr int META_OFF = CVT_OFF + (CONVERT ? 2 * CVT_TILE : 0);
  static constexpr int BYTES = META_OFF + 2 * KT * (4 + 4 + 4);  // row, k scale, v scale
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16) * b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TKV, bool CLIPPED, int D>
__global__ void __launch_bounds__(NT) paged_attn_tc(Args a) {
  using S = Smem<TKV, D>;
  constexpr int LD = S::LD;
  constexpr int CPR = D * (int)sizeof(TKV) / 16;  // 16-byte copies per token row
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + S::Q_OFF);
  int* row_s = reinterpret_cast<int*>(smem_tc + S::META_OFF);  // [2][KT]
  float* ksc_s = reinterpret_cast<float*>(row_s + 2 * KT);  // [2][KT]
  float* vsc_s = ksc_s + 2 * KT;                            // [2][KT]
  auto raw = [&](int st, int kv) {  // arriving tile of stage st, K (0) or V (1)
    return reinterpret_cast<TKV*>(smem_tc + S::RAW_OFF + (2 * st + kv) * S::RAW_TILE);
  };
  // the bf16 operand tile of stage st: the arriving tile itself for bf16
  // pools, the converted copy for int8
  auto opnd = [&](int st, int kv) {
    return S::CONVERT ? reinterpret_cast<__nv_bfloat16*>(smem_tc + S::CVT_OFF + kv * S::CVT_TILE)
                      : reinterpret_cast<__nv_bfloat16*>(raw(st, kv));
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(ROWS, a.TQG - r0);
  const int qoff = a.q_off[b];
  const int2 span = token_span(a, b, r0, n_rows);
  const int tok_lo = span.x, tok_hi = span.y;
  const int ntile = tok_hi > tok_lo ? (tok_hi - tok_lo + KT - 1) / KT : 0;
  constexpr int NPASS = CLIPPED ? 2 : 1;
  const int n_it = NPASS * ntile;

  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const size_t qbase = ((size_t)(b * a.Hkv + h) * a.TQG + r0) * D;

  // step it of the walk: pass it / ntile over tile it % ntile; K always,
  // V when the pass needs it. Each token's pool row is looked up once,
  // then every thread issues its 16-byte copies from the row list.
  auto issue = [&](int it) {
    const int st = it & 1;
    const bool need_v = !CLIPPED || it >= ntile;
    const int t0 = tok_lo + (it % ntile) * KT;
    if (tid < KT) {
      const int tok = t0 + tid;
      const int row = tok < tok_hi ? pool_row(a, table_entry(a, b, tok), tok) : -1;
      row_s[st * KT + tid] = row;
      ksc_s[st * KT + tid] = (a.k_scale != nullptr && row >= 0) ? a.k_scale[row] : 1.f;
      vsc_s[st * KT + tid] = (a.v_scale != nullptr && row >= 0) ? a.v_scale[row] : 1.f;
    }
    __syncthreads();
    TKV* kd = raw(st, 0);
    TKV* vd = raw(st, 1);
    for (int i = tid; i < KT * CPR; i += NT) {
      const int j = i / CPR, c = i - j * CPR;
      const int row = row_s[st * KT + j];
      const size_t off = row >= 0 ? ((size_t)row * a.Hkv + h) * D + c * (16 / sizeof(TKV)) : 0;
      const int n = row >= 0 ? 16 : 0;
      cp_async16(saddr(kd + j * S::RAW_LD + c * (16 / sizeof(TKV))), kp + off, n);
      if (need_v) cp_async16(saddr(vd + j * S::RAW_LD + c * (16 / sizeof(TKV))), vp + off, n);
    }
  };

  // Q rows (zeros past TQG), then the first tile, in one group
  for (int i = tid; i < ROWS * (D / 8); i += NT) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool in = r < n_rows;
    cp_async16(saddr(q_s + r * LD + c * 8), q + qbase + (in ? (size_t)r * D + c * 8 : 0),
               in ? 16 : 0);
  }
  if (n_it > 0) issue(0);
  cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {attn::NEG_INF, attn::NEG_INF}, z[2] = {0.f, 0.f};
  uint32_t qa[D / 16][4];  // this warp's 16 query rows as A fragments

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int pass = it / ntile;
    const bool need_v = !CLIPPED || pass == 1;
    const bool online = !CLIPPED || pass == 0;
    const int t0 = tok_lo + (it % ntile) * KT;
    if (it + 1 < n_it) {  // the next tile's pages arrive during this tile's math
      issue(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (lane % 16), c = kk * 16 + (lane / 16) * 8;
        ldsm_x4(qa[kk], saddr(q_s + r * LD + c));
      }
    }
    if (S::CONVERT) {  // int8 codes -> bf16 (exact), into the operand tiles
      for (int kv = 0; kv < (need_v ? 2 : 1); ++kv) {
        const TKV* src = raw(st, kv);
        __nv_bfloat16* dst = opnd(st, kv);
        for (int i = tid; i < KT * D / 8; i += NT) {  // 8 codes per step
          const int j = i / (D / 8), c = (i % (D / 8)) * 8;
          const uint2 w = *reinterpret_cast<const uint2*>(src + j * S::RAW_LD + c);
          int8_t e[8];
          memcpy(e, &w, sizeof(w));
          __nv_bfloat162 f[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) f[x] = __floats2bfloat162_rn(to_f(e[2 * x]), to_f(e[2 * x + 1]));
          uint4 r;
          memcpy(&r, f, sizeof(r));
          *reinterpret_cast<uint4*>(dst + j * LD + c) = r;
        }
      }
      __syncthreads();
    }
    const __nv_bfloat16* k_t = opnd(st, 0);
    const __nv_bfloat16* v_t = opnd(st, 1);
    const int* rows = row_s + st * KT;
    const float* ksc = ksc_s + st * KT;
    const float* vsc = vsc_s + st * KT;

    // S = Q K^T: s[j] is the 16 x 8 block of tokens 8j..8j+7; a thread
    // holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]), tokens 8j + 2qd + c
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        const int mi = lane / 8;
        const int tok = (2 * jp + mi / 2) * 8 + lane % 8, c = kk * 16 + (mi % 2) * 8;
        ldsm_x4(kb, saddr(k_t + tok * LD + c));
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }

    float corr[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const int qp = qoff + (r0 + r) / a.G;
      uint32_t valid = 0;
      float mx = attn::NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jt = 8 * j + 2 * qd + c;
          const bool ok =
              rows[jt] >= 0 && r < n_rows && attn::visible(t0 + jt, qp, a.causal, a.window);
          float& x = s[j][2 * i + c];
          // scaled in f32 after the product; an int8 pool's K scale first
          x = ok ? attn::softcap(x * ksc[jt] * a.scale, a.softcap) : attn::NEG_INF;
          valid |= (ok ? 1u : 0u) << (2 * j + c);
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
            float& x = s[j][2 * i + c];
            x = (valid >> (2 * j + c)) & 1u ? expf(x - m[i]) : 0.f;
            ps += x;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        z[i] = z[i] * corr[i] + ps;
      } else {
        const float zc = fmaxf(z[i], attn::Z_FLOOR);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * i + c];
            // masked entries zeroed after the clip
            x = (valid >> (2 * j + c)) & 1u
                    ? attn::clipped_prob(x, m[i], zc, a.zeta - a.gamma, a.gamma)
                    : 0.f;
          }
      }
    }

    if (need_v) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // tokens 16kk .. 16kk + 15
        // P (times an int8 pool's V scale) as hi/lo A fragments
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + f / 2, i = f % 2;
          const int jt = 8 * j + 2 * qd;
          attn::split_hi_lo2(s[j][2 * i] * vsc[jt], s[j][2 * i + 1] * vsc[jt + 1], hi[f], lo[f]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          const int mi = lane / 8;
          const int tok = kk * 16 + (mi % 2) * 8 + lane % 8, c = dp * 16 + (mi / 2) * 8;
          ldsm_x4_t(vb, saddr(v_t + tok * LD + c));
          mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
          mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= n_rows) continue;
    const float zc = fmaxf(z[i], attn::Z_FLOOR);
    const float gt = a.gate != nullptr ? a.gate[(size_t)(b * a.Hkv + h) * a.TQG + r0 + r] : 1.f;
    __nv_bfloat16* orow = out + qbase + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float v0 = o[j][2 * i], v1 = o[j][2 * i + 1];
      if (!CLIPPED) {
        v0 = v0 / zc;
        v1 = v1 / zc;
      }
      if (a.gate != nullptr) {
        v0 *= gt;
        v1 *= gt;
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * qd) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <typename TQ, typename TKV, bool CLIPPED, int DCOLS, int KT_>
cudaError_t launch_cc(Args a, cudaStream_t stream) {
  auto kern = paged_attn_cc<TQ, TKV, CLIPPED, DCOLS, KT_>;
  const size_t smem = smem_bytes_cc(a.Dh, KT_);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.TQG + ROWS - 1) / ROWS * a.nsplit, a.Hkv, a.B);
  if (CLIPPED && a.nsplit > 1) {  // (m, Z) partials, then the merged clipped P.V
    a.clip_phase = 1;
    kern<<<grid, NT, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    a.clip_phase = 2;
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DCOLS>
cudaError_t dispatch_cc_clip(const Args& a, bool clipped, cudaStream_t stream) {
  // a split read walks short chunks: smaller tiles fit more CTAs on an SM
  if (a.nsplit > 1) {
    return clipped ? launch_cc<TQ, TKV, true, DCOLS, KT_SPLIT>(a, stream)
                   : launch_cc<TQ, TKV, false, DCOLS, KT_SPLIT>(a, stream);
  }
  return clipped ? launch_cc<TQ, TKV, true, DCOLS, KT>(a, stream)
                 : launch_cc<TQ, TKV, false, DCOLS, KT>(a, stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_cc(const Args& a, bool clipped, cudaStream_t stream) {
  return a.Dh <= NT ? dispatch_cc_clip<TQ, TKV, 1>(a, clipped, stream)
                    : dispatch_cc_clip<TQ, TKV, 2>(a, clipped, stream);
}

template <typename TKV, bool CLIPPED, int D>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kern = mma::paged_attn_tc<TKV, CLIPPED, D>;
  const int smem = mma::Smem<TKV, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.TQG + mma::ROWS - 1) / mma::ROWS, a.Hkv, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TKV, int D>
cudaError_t dispatch_tc_clip(const Args& a, bool clipped, cudaStream_t s) {
  return clipped ? launch_tc<TKV, true, D>(a, s) : launch_tc<TKV, false, D>(a, s);
}

template <typename TKV>
cudaError_t dispatch_tc(const Args& a, bool clipped, cudaStream_t s) {
  return a.Dh == 64 ? dispatch_tc_clip<TKV, 64>(a, clipped, s)
                    : dispatch_tc_clip<TKV, 128>(a, clipped, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only). route:
// 1 = tensor cores (bf16 q over a bf16 or int8 pool at Dh 64 or 128), 0 =
// CUDA cores (every dtype), as the note above names them; a route not
// built for the inputs is refused. nsplit: splits of the KV walk (CUDA
// cores only; > 1 only when TQG <= 16), with ws holding
// B * Hkv * ceil(TQG / 16) * nsplit * 16 * (Dh + 2) floats and tickets
// B * Hkv * ceil(TQG / 16) zeroed ints. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* table, const int* q_off, const int* live_widths,
    const float* gate, void* out, float* ws, int* tickets, int B, int Hkv, int TQG, int Dh,
    int NB, int BS, int W, int G, int causal, int window, float softcap, int clipped,
    float gamma, float zeta, float scale, int q_dtype, int kv_dtype, int route, int nsplit,
    void* stream) {
  const int kv_bytes = kv_dtype == 0 ? 4 : (kv_dtype == 1 ? 2 : 1);
  if (Dh < 1 || Dh > 2 * NT || (Dh * kv_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0 || B < 1 || Hkv < 1 || TQG < 1 ||
      BS < 1 || W < 1 || G < 1 || nsplit < 1 || nsplit > MAX_SPLITS) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tensor_cores = route == 1;
  if ((route != 0 && route != 1) ||
      (tensor_cores && (q_dtype != 1 || kv_dtype == 0 || (Dh != 64 && Dh != 128) ||
                        nsplit > 1)) ||
      (nsplit > 1 && (TQG > ROWS || ws == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k_pool, v_pool, k_scale, v_scale, table, q_off, live_widths, gate, out, ws,
         tickets, B, Hkv, TQG, Dh, NB, BS, W, G, causal, window, softcap, gamma, zeta, scale,
         nsplit, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = clipped != 0;
  if (tensor_cores) {
    return (int)(kv_dtype == 1 ? dispatch_tc<__nv_bfloat16>(a, c, s) : dispatch_tc<int8_t>(a, c, s));
  }
  if (q_dtype == 0 && kv_dtype == 0) return (int)dispatch_cc<float, float>(a, c, s);
  if (q_dtype == 1 && kv_dtype == 1) return (int)dispatch_cc<__nv_bfloat16, __nv_bfloat16>(a, c, s);
  if (q_dtype == 0 && kv_dtype == 1) return (int)dispatch_cc<float, __nv_bfloat16>(a, c, s);
  if (q_dtype == 0 && kv_dtype == 2) return (int)dispatch_cc<float, int8_t>(a, c, s);
  if (q_dtype == 1 && kv_dtype == 2) return (int)dispatch_cc<__nv_bfloat16, int8_t>(a, c, s);
  return (int)cudaErrorInvalidValue;
}
