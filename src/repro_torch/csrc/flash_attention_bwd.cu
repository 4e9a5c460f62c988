// Flash-attention backward for NVIDIA Hopper (sm_90a): f32 gradients from
// products on the tensor cores (3xTF32 wgmma), fed by a TMA ring.
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
//
// What it saves from the forward: the f32 CUDA-core forward writes each
// row's (m_i, max(Z_i, 1e-30)) when asked (FlashAttention.forward asks),
// and FlashAttention keeps u (the output itself without a gate; under a
// gate the forward writes u beside out). So nothing of the forward is
// recomputed but S: vanilla and gated D_i = g_i . u_i = gate_i (dO_i .
// u_i) and dgate_i = dO_i . u_i are dot products of rows (bytes only). The
// clipped D_i = sum_j p_ij dp_ij does not factor through u; dq sums it
// over its walk and, not knowing it before the end, takes dq_i = Dh^-0.5
// (A_i - D_i B_i) with A_i = sum_j p_ij dp_ij k_j and B_i = sum_j p_ij
// k_j (2 flops per visible pair and column more than vanilla, where a
// pass over S and dP~ for D first would take 4). u is
// kept rather than recovered as out / gate: a gate that underflows (a
// sigmoid of a pre-activation below about -87 is subnormal or 0) leaves
// out without u's digits, and 0 / 0 where the gate is 0; with u, D_i and
// dgate_i take one rounding each whatever the gate.
//
// Two launches (three for GQA). Each CTA has two warpgroups taking
// alternate tiles of the CTA's walk (one's softmax runs while the other's
// products do), warpgroup 0 adding warpgroup 1's sums at the end; tiles of
// 64 queries x 64 keys stream through a ring of STAGES TMA slots (one
// mbarrier each), the first filled at the start, each refilled by one
// thread of the warpgroup that read it last, STAGES tiles on. (A producer
// warp would cap the registers at 168 a thread: ptxas sizes 288 threads
// as 384; at 256 threads a thread may hold 255.)
//   1. dq (B, Hq, query block, longest causal walk first): D_i and dgate_i
//      from dO and u (vanilla, gated); g = gate dO to a (B, Tq, Hq, Dh)
//      scratch under a gate. Then per key tile S^T = K Q^T and dP~^T = V
//      G^T (M keys, N queries, K = Dh), ds, and dQ^T += K^T dS^T (M = Dh,
//      N queries, K keys); clipped, A^T += K^T (p dp)^T and B^T += K^T p^T
//      and D's sum, then dq = A - D B. D goes to a (B, Hq, Tq) scratch.
//   2. dk/dv (B, Hq, key block): per query tile S = Q K^T and dP~ = G V^T
//      (M queries, N keys), P~ and ds, then dV^T += G^T P~ and dK^T +=
//      Q^T dS (M = Dh, N keys, K queries), P~ and dS taking turns in one
//      buffer. With G > 1 each query head writes its own partial dk, dv
//      (so GQA fills the card) and
//   3. a sum over the G heads of each KV head, in head order, finishes them.
// 14 flops per visible pair and head column (16 clipped): S twice, dP~
// twice, dv, dk, dq (clipped: A and B).
//
// Where the products run: wgmma m64n64k8 TF32 on the tensor cores, as
// 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (rounded to nearest), and a product is hi.hi + hi.lo + lo.hi summed in f32 (the
// dropped lo.lo is ~2^-22 relative). (bf16 hi/lo, the forward's P split,
// errs by ~2^-17, too near the 1e-5 gradient bound.) The tensor cores
// truncate as they accumulate, so each product sums its small terms (hi.lo
// and lo.hi of every k8 step) first, into a fresh accumulator, then the
// hi.hi terms, and the sums over tiles (dq, dk, dv) are added in registers
// with round-to-nearest, one tile at a time: a chain of small terms added
// into a large running sum on the tensor cores erred by up to 2.2e-5
// (relative RMS, OPT-125m's shape), these by ~1e-6. The clipped softmax's
// indicator 1[0 < (zeta - gamma) p + gamma < 1] has no slope to forgive
// that: an entry within 1e-4 of either edge has its score recomputed in
// f32 on CUDA cores (an fmaf chain over Dh, as the forward) before the
// indicator is read (a flipped entry moved its row's dq by 20 %).
// TF32 wgmma takes shared-memory operands K-major only, and the products
// over tokens (dv, dk, dq) contract the strided axis; so the A operand
// always comes from registers, where a thread gathers its fragment from the
// raw TMA tile of the ring (Q, G in dk/dv; K, V in dq; 128-byte swizzled):
// along rows by ldmatrix (four 8 x 4 f32 blocks a k8 step), across rows by
// single loads (2-way bank conflicts), and splits it; the B operand is a
// tile fixed for the CTA (K, V in dk/dv; Q Dh^-0.5, G in dq: converted
// once in place to hi plus a lo copy) or the computed P~, dS, written hi
// and lo straight from the accumulators in the K-major swizzled layout.
// The M = Dh products leave half the warpgroup's rows zero at Dh 32.
//
// Deterministic: every output element has one owner that sums in a fixed
// order (dq its query block over key tiles, dk/dv its key block over query
// tiles, each warpgroup its own alternate tiles and warpgroup 0 then adding
// warpgroup 1's, the G-head sum in head order); no atomics, so two calls
// give bitwise equal gradients.
//
// What bounds it on an H100: operations. The function needs 10 flops per
// visible pair and column (S, dP~, dv, dq, dk), here each f32 product
// three TF32 ones: 30 at 495 TFLOP/s, i.e. 10 at an effective 165 TFLOP/s
// (0.098 ms at BERT-base's (8, 512, 12/12, 64), 0.195 at OPT-125m's (2,
// 2048, 12/12, 64) causal), against ~10 bytes per token and head of inputs
// and outputs. One CTA a SM, with two warpgroups for the overlap a second
// CTA would give: the hi/lo copies double each B tile, so dk/dv holds 224
// KB of shared memory at Dh 64 (K, V: 64 KB; three ring slots of Q and G:
// 96 KB; each warpgroup's P~/dS buffer: 32 KB) and dq as much (Q, G: 64
// KB; three slots of K and V: 96 KB; dS: 2 x 32 KB).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int BQ = 64;          // queries per tile
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 3;       // ring slots
constexpr int THREADS = 256;    // two warpgroups
constexpr int BOX = 8192;       // one TMA box: 64 rows x 32 f32 (128-byte rows, swizzled)
constexpr int WG_TILE = 4 * BOX;  // a warpgroup's P~ / dS buffer: [64][64] hi, then lo

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* gate;   // null: no gate
  const float* u;      // (B, Tq, Hq, Dh) contiguous: the forward's ungated output
  const float* dout;   // (B, Tq, Hq, Dh) contiguous
  const float* stats;  // 2 x (B, Hq, Tq): m, max(Z, 1e-30), from the forward
  float* dsum;         // (B, Hq, Tq): D, written by dq, read by dk/dv
  float* g;            // (B, Tq, Hq, Dh): gate dO, written by dq under a gate, else null
  float* dq;           // (B, Tq, Hq, Dh) contiguous
  float* dk;           // (B, Tk, Hkv, Dh), or with G > 1 (B, Tk, Hq, Dh) partials
  float* dv;           // as dk
  float* dgate;        // (B, Tq, Hq) contiguous, or null
  int B, Tq, Tk, Hq, Hkv;
  long long sqb, sqt, sqh, skb, skt, skh, sgb, sgt, sgh;  // q, k, gate strides
  int causal, clipped;
  float zg, gamma, scale;  // zeta - gamma, gamma, Dh^-0.5
};

// byte offset of element (r, c) of a swizzled tile: boxes of 32 columns,
// rows of 128 bytes whose 16-byte chunks are XORed with r % 8 (TMA's
// 128-byte swizzle; wgmma's K-major 128-byte layout)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 5) * BOX + (r << 7) + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// p, P~ and dp of one entry of a tile
struct Entry {
  float p, pt, dp;
};

// x rounded to the nearest TF32 value, ties away from zero (cvt.rna's
// rounding, in two integer operations at full rate): its top 19 bits
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + e, hi and lo TF32 values, |e| <= 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d (64 x 64 f32 fragment) += A (registers, tf32 fragment) * B (smem, K-major)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The A operand of one product (K = 64 at most: eight k8 steps): hi of
// every step, lo of the four being issued
struct Frag {
  uint32_t hi[8][4], lo[4][4];
};

// A value the same in every lane of the warp (the warpgroup's or the
// warp's index), made visibly so: the compiler serializes every wgmma of a
// kernel when one sits under a branch it cannot prove uniform, and it takes
// anything computed from threadIdx for divergent.
__device__ __forceinline__ int uniform(int x) { return __shfl_sync(0xffffffffu, x, 0); }

// The thread's place in its warpgroup: warp w (rows 16w..16w+15), lane,
// lane group g = lane / 4 and lane quad qd = lane % 4
struct Lane {
  int w, lane, g, qd;
};

// l with its lane group passed through an empty asm, once a tile: the
// shared-memory offsets computed from it inside the tile loop are then not
// hoisted out of it, where they would take the registers the accumulators
// need (the kernels spilled without it)
__device__ __forceinline__ Lane fresh(Lane l) {
  asm volatile("" : "+r"(l.g));
  return l;
}

// A[m][k] = x(m, k) mul for rows m = 16w + g (+8), k = 8 kk + qd (+4), k8
// steps K0..K0+3, from a swizzled tile at shared address t: one ldmatrix
// per k8 step (four 8 x 4 f32 blocks, each row 16 bytes)
template <int K0>
__device__ __forceinline__ void gather_rows(Frag& f, uint32_t t, float mul, Lane l) {
  const int mi = l.lane >> 3, row = 16 * l.w + (l.lane & 7) + 8 * (mi & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(t + swz(row, 8 * (K0 + kk) + 4 * (mi >> 1))));
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]) * mul, f.hi[K0 + kk][i], f.lo[kk][i]);
  }
}

// A[m][k] = x(k, m) mul (the tile read transposed), k8 steps K0..K0+3;
// zeros where !live (the warps past Dh of an M = Dh product at Dh 32)
template <int K0>
__device__ __forceinline__ void gather_cols(Frag& f, const uint8_t* t, float mul, bool live,
                                            Lane l) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 16 * l.w + l.g + 8 * (r & 1), k = 8 * (K0 + kk) + l.qd + 4 * (r >> 1);
      const float x = live ? *reinterpret_cast<const float*>(t + swz(k, m)) * mul : 0.f;
      split(x, f.hi[K0 + kk][r], f.lo[kk][r]);
    }
}

// The A operand of a product, gathered four k8 steps at a time
struct Rows {  // along the rows of a tile at shared address t, times mul
  uint32_t t;
  float mul;
  Lane l;
  template <int K0>
  __device__ __forceinline__ void fill(Frag& f) const { gather_rows<K0>(f, t, mul, l); }
};
struct Cols {  // across the rows of a tile at t, times mul; zeros where !live
  const uint8_t* t;
  float mul;
  bool live;
  Lane l;
  template <int K0>
  __device__ __forceinline__ void fill(Frag& f) const { gather_cols<K0>(f, t, mul, live, l); }
};

// the small products (lo.hi, hi.lo) of k8 steps K0..K0+3
template <int K0>
__device__ __forceinline__ void mma_small(float* acc, const Frag& f, uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = ((K0 + kk) >> 2) * BOX + ((K0 + kk) & 3) * 32;
    wgmma_tf32(acc, f.lo[kk], attn::desc(b_hi + off, 16, 1024, 1), K0 + kk > 0);
    wgmma_tf32(acc, f.hi[K0 + kk], attn::desc(b_lo + off, 16, 1024, 1), 1);
  }
}

// acc = A B over KS k8 steps (4 or 8) of the B tile (hi at b_hi, lo at
// b_lo), the A operand from gather (Rows or Cols): the small products
// (lo.hi, hi.lo) of every step first, into a fresh accumulator, then the
// hi.hi ones. The tensor cores truncate as they accumulate, so the small
// terms are summed among themselves, not into the large sum.
template <int KS, typename Gather>
__device__ __forceinline__ void product(float* acc, Frag& f, const Gather& gather, uint32_t b_hi,
                                        uint32_t b_lo) {
  gather.template fill<0>(f);
  attn::wg_fence();
  mma_small<0>(acc, f, b_hi, b_lo);
  if constexpr (KS == 8) {
    attn::wg_commit();
    attn::wg_wait<0>();  // the lo registers take steps 4..7
    gather.template fill<4>(f);
    attn::wg_fence();
    mma_small<4>(acc, f, b_hi, b_lo);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
    wgmma_tf32(acc, f.hi[kk], attn::desc(b_hi + off, 16, 1024, 1), 1);
  }
  attn::wg_commit();
}

// Zero an accumulator whose values came out of the clipped entries (a
// lane-dependent branch), before it takes a product: the compiler then
// fences it where all lanes agree, not in that branch, which made it
// serialize every wgmma of the kernel (the product overwrites the zeros)
__device__ __forceinline__ void clear(float* a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
}

__device__ __forceinline__ void wait_acc(float* a) {
  attn::wg_wait<0>();
  attn::reg_fence<32>(a);
}

// sum += x, rounding to nearest (the long sums over tiles stay off the
// tensor cores)
__device__ __forceinline__ void add_to(float* sum, const float* x) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += x[i];
}

__device__ __forceinline__ void wg_sync(int wg) {  // one warpgroup
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void cta_sync() {  // both warpgroups (barrier 0)
  __syncthreads();
}
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic writes -> wgmma
}

// Split a fixed B tile (NB boxes) in place, both warpgroups: x =
// f(row, col, raw) for each 16-byte chunk, hi = tf32(x) where the raw tile
// was, lo = tf32(x - hi) at lo.
template <int NB, typename F>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, F&& f) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int i = threadIdx.x; i < NB * 512; i += THREADS) {
    const int row = (i & 511) >> 3;
    const int col = (i >> 9) * 32 + (((i & 7) ^ (row & 7)) << 2);
    const float4 x = f(row, col, h4[i]);
    uint32_t a[4], b[4];
    split(x.x, a[0], b[0]);
    split(x.y, a[1], b[1]);
    split(x.z, a[2], b[2]);
    split(x.w, a[3], b[3]);
    h4[i] = make_float4(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                        __uint_as_float(a[3]));
    l4[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                        __uint_as_float(b[3]));
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// A row's statistics: c2 = m log2(e) + log2(Z), so that p = 2^(s log2(e) -
// c2) is one fma and one exp2, and the forward's m and Z themselves
__device__ __forceinline__ float row_c2(float m, float zc) { return fmaf(m, LOG2E, log2f(zc)); }

// p, P~ and dp of one visible-or-masked entry; ds = p (dp - D). p =
// exp(s - m) / Z to ~1e-6 (the score's own 3xTF32 error). Clipped, an entry
// within 1e-4 (relative to zg p) of either edge of the clip has its score
// recomputed in f32 (exact(): an fmaf chain over Dh in order) and p taken
// as expf(s - m) / Z, as the forward computes it: the clip's indicator has
// no slope to forgive rounding.
template <typename F>
__device__ __forceinline__ Entry entry(const Args& a, bool valid, float s, float c2, float m,
                                       float zc, float dpt, F&& exact) {
  float p = valid ? exp2f(fmaf(s, LOG2E, -c2)) : 0.f;
  Entry e{p, p, dpt};
  if (a.clipped) {
    float x = a.zg * p + a.gamma;
    const float near = 1e-4f * a.zg * p;
    if (valid && (fabsf(x) <= near || fabsf(x - 1.f) <= near)) {
      p = expf(exact() - m) / zc;
      x = a.zg * p + a.gamma;
      e.p = p;
    }
    e.pt = valid ? fminf(fmaxf(x, 0.f), 1.f) : 0.f;
    e.dp = (valid && x > 0.f && x < 1.f) ? a.zg * dpt : 0.f;
  }
  return e;
}

// the f32 score of query qp of head h and key kp of KV head hk, as the
// forward's CUDA-core route computes it: (q Dh^-0.5) . k, an fmaf chain
template <int D>
__device__ __forceinline__ float exact_score(const Args& a, int b, int h, int hk, int qp, int kp) {
  const float* qr = a.q + b * a.sqb + (long long)qp * a.sqt + h * a.sqh;
  const float* kr = a.k + b * a.skb + (long long)kp * a.skt + hk * a.skh;
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qr + d);
    const float4 y = *reinterpret_cast<const float4*>(kr + d);
    acc = fmaf(x.x * a.scale, y.x, acc);
    acc = fmaf(x.y * a.scale, y.y, acc);
    acc = fmaf(x.z * a.scale, y.z, acc);
    acc = fmaf(x.w * a.scale, y.w, acc);
  }
  return acc;
}

// x hi and lo at byte off of a warpgroup buffer (hi tile, then lo)
__device__ __forceinline__ void store_split(uint8_t* buf, uint32_t off, float x) {
  uint32_t h, l;
  split(x, h, l);
  *reinterpret_cast<uint32_t*>(buf + off) = h;
  *reinterpret_cast<uint32_t*>(buf + 2 * BOX + off) = l;
}

// v[e] summed over the 8 lane groups g of a warp (lanes 4 apart), each
// lane left with the sums of columns cols_of(g) and cols_of(g) + 1 in v[0],
// v[1]: halving exchanges (a reduce-scatter), 14 shuffles for 16 values
__device__ __forceinline__ void reduce_cols(float (&v)[16], int g) {
#pragma unroll
  for (int step = 0, half = 8; step < 3; ++step, half /= 2) {
    const bool up = (g >> step) & 1;  // keep the upper half
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = up ? v[e] : v[e + half];
      const float keep = up ? v[e + half] : v[e];
      v[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << step);
    }
  }
}
__device__ __forceinline__ int cols_of(int g) {
  return 8 * (g & 1) + 4 * ((g >> 1) & 1) + 2 * ((g >> 2) & 1);
}

__device__ __forceinline__ long long stat_index(const Args& a, int b, int h, int t) {
  return ((long long)b * a.Hq + h) * a.Tq + t;
}

// Barriers: fixed (the CTA's fixed tiles), full[STAGES]. A slot of the
// ring is refilled by the warpgroup that read it last, once all its warps
// are past their gathers: with the tile STAGES steps on.
__device__ __forceinline__ void init_barriers(uint32_t fixed) {
  if (threadIdx.x == 0) {
    attn::mbar_init(fixed, 1);
    for (int s = 0; s < STAGES; ++s) attn::mbar_init(fixed + 8 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. dq of one (b, h, query block); D and dgate of its rows first (vanilla,
// gated), or D summed over the walk (clipped). The two warpgroups take
// alternate key tiles; warpgroup 0 adds warpgroup 1's dq at the end.
// ---------------------------------------------------------------------------
template <int D>
struct QLayout {
  static constexpr int NB = D / 32;
  static constexpr int TILE = NB * BOX;                 // 64 rows x D f32
  static constexpr int Q_HI = 0, Q_LO = TILE, G_HI = 2 * TILE, G_LO = 3 * TILE;
  static constexpr int RING = 4 * TILE;                 // slot s: K, then V
  static constexpr int DS = RING + STAGES * 2 * TILE;   // per warpgroup: dS [64 q][64 keys]
  static constexpr int CS = DS + 2 * WG_TILE;           // float4 [64]: c2, D, m, Z
  static constexpr int BAR = CS + 64 * 16;
  static constexpr int BYTES = BAR + (1 + STAGES) * 8 + 1024;
};

template <int D, bool CLIPPED>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                  Args a) {
  using L = QLayout<D>;
  constexpr int NB = L::NB, KS = D / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t qg_full = base + L::BAR, full0 = qg_full + 8;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const int k_hi = a.causal ? min(a.Tk, min(q0 + BQ, a.Tq)) : a.Tk;
  const int n_tiles = (k_hi + BK - 1) / BK;
  init_barriers(qg_full);
  // K and V of key tile n into its slot
  auto load = [&](int n) {
    const int st = n % STAGES;
    const uint32_t slot = base + L::RING + st * 2 * L::TILE, fb = full0 + 8 * st;
    attn::mbar_expect_tx(fb, 2 * L::TILE);
    for (int c = 0; c < NB; ++c) {
      attn::tma_load(slot + c * BOX, &tm_k, fb, 32 * c, hk, n * BK, b);
      attn::tma_load(slot + L::TILE + c * BOX, &tm_v, fb, 32 * c, hk, n * BK, b);
    }
  };
  if (threadIdx.x == 0) {  // Q and dO once, and the ring's first tiles
    attn::mbar_expect_tx(qg_full, 2 * L::TILE);
    for (int c = 0; c < NB; ++c) {
      attn::tma_load(base + L::Q_HI + c * BOX, &tm_q, qg_full, 32 * c, h, q0, b);
      attn::tma_load(base + L::G_HI + c * BOX, &tm_do, qg_full, 32 * c, h, q0, b);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load(n);
  }
  const int wg = uniform(threadIdx.x / 128);

  const int ct = threadIdx.x;  // 0..255 over both warpgroups
  const Lane lane{uniform((ct % 128) / 32), ct % 32, (ct % 32) / 4, ct % 4};
  float4* cs = reinterpret_cast<float4*>(sm + L::CS);
  uint8_t* dsb = sm + L::DS + wg * WG_TILE;
  const uint32_t dsb_s = base + L::DS + wg * WG_TILE;
  const bool gated = a.gate != nullptr;

  {  // the block's rows, four threads a row: c2, m, Z and, vanilla or
     // gated, D = gate (dO . u); dgate = dO . u
    const int row = ct / 4, t = min(q0 + row, a.Tq - 1);
    const long long si = stat_index(a, b, h, t);
    float dot = 0.f;
    if (gated || !CLIPPED) {
      const long long off = (((long long)b * a.Tq + t) * a.Hq + h) * D + (ct & 3) * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 4) {
        const float4 o = *reinterpret_cast<const float4*>(a.dout + off + c);
        const float4 x = *reinterpret_cast<const float4*>(a.u + off + c);
        dot = fmaf(o.x, x.x, dot);
        dot = fmaf(o.y, x.y, dot);
        dot = fmaf(o.z, x.z, dot);
        dot = fmaf(o.w, x.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    }
    if ((ct & 3) == 0) {
      const float gt = gated ? a.gate[b * a.sgb + (long long)t * a.sgt + h * a.sgh] : 1.f;
      const float dsum = CLIPPED ? 0.f : (gated ? gt * dot : dot);
      const long long bht = (long long)a.B * a.Hq * a.Tq;
      const float m = a.stats[si], zc = a.stats[bht + si];
      cs[row] = make_float4(row_c2(m, zc), dsum, m, zc);
      if (q0 + row < a.Tq) {
        if (!CLIPPED) a.dsum[si] = dsum;
        if (gated) a.dgate[((long long)b * a.Tq + t) * a.Hq + h] = dot;
      }
    }
  }

  attn::mbar_wait(qg_full, 0);
  // the fixed B tiles: q Dh^-0.5 and g = gate dO (also written out for dk/dv)
  split_tile<NB>(sm + L::Q_HI, sm + L::Q_LO, [&](int, int, float4 x) {
    return make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
  });
  split_tile<NB>(sm + L::G_HI, sm + L::G_LO, [&](int row, int col, float4 x) {
    if (gated) {
      const int t = q0 + row;
      const float gt = t < a.Tq ? a.gate[b * a.sgb + (long long)t * a.sgt + h * a.sgh] : 0.f;
      x = make_float4(gt * x.x, gt * x.y, gt * x.z, gt * x.w);
      if (t < a.Tq)
        *reinterpret_cast<float4*>(a.g + (((long long)b * a.Tq + t) * a.Hq + h) * D + col) = x;
    }
    return x;
  });
  async_fence();
  cta_sync();

  // dq; clipped, the sums A = sum_j p dp k_j (in dq) and B = sum_j p k_j
  // (in bq), D's partial sums in part, and dq = A - D B at the end
  float dq[32], bq[CLIPPED ? 32 : 1], s[32], dp[32], part[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  if constexpr (CLIPPED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) bq[i] = 0.f;
  }
  Frag f;
  const bool live = lane.w < D / 16;  // rows of an M = Dh product
#pragma unroll 1
  for (int n = wg; n < n_tiles; n += 2) {
    const Lane l = fresh(lane);
    const int t0 = n * BK, st = n % STAGES;
    attn::mbar_wait(full0 + 8 * st, (n / STAGES) & 1);
    const uint32_t kt_s = base + L::RING + st * 2 * L::TILE;
    const uint8_t* kt = sm + L::RING + st * 2 * L::TILE;
    // S^T = K (Q Dh^-0.5)^T, dP~^T = V G^T: M keys, N queries, K = Dh
    product<KS>(s, f, Rows{kt_s, 1.f, l}, base + L::Q_HI, base + L::Q_LO);
    wait_acc(s);
    product<KS>(dp, f, Rows{kt_s + L::TILE, 1.f, l}, base + L::G_HI, base + L::G_LO);
    wait_acc(dp);
    wg_sync(wg);  // every warp's products of the last tile are done: the buffer is free
    // entry (key row, query col) is visible iff lo[i] <= col - 2 qd < hi,
    // col - 2 qd = 8 j + c a constant: a row past Tk sees nothing, causal
    // rows see the queries at or after their key, every row none past Tq
    int lo[2];
    const int hi = a.Tq - q0 - 2 * l.qd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = t0 + 16 * l.w + l.g + 8 * i;
      lo[i] = (kp < a.Tk ? (a.causal ? kp - q0 : -BQ) : BQ) - 2 * l.qd;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * l.qd + c;
        const float4 cst = cs[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = 16 * l.w + l.g + 8 * i, x = 4 * j + 2 * i + c;
          const bool valid = lo[i] <= 8 * j + c && 8 * j + c < hi;
          const Entry e = entry(a, valid, s[x], cst.x, cst.z, cst.w, dp[x],
                                [&] { return exact_score<D>(a, b, h, hk, q0 + col, t0 + row); });
          if constexpr (CLIPPED) {  // p dp into dp, p into s, in place
            dp[x] = e.p * e.dp;
            s[x] = e.p;
          } else {
            store_split(dsb, swz(col, row), e.p * (e.dp - cst.y));
          }
        }
      }
    if constexpr (CLIPPED) {
      // D's sums over the warp's 16 keys of the tile: the thread's 16
      // columns (2 j + c) reduced across its 8 lane groups and scattered, 2
      // columns a lane (reduce_cols), added to part
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = dp[2 * (e & ~1) + (e & 1)] + dp[2 * (e & ~1) + 2 + (e & 1)];
      reduce_cols(v, l.g);
      part[0] += v[0];
      part[1] += v[1];
      // A^T (this tile) = K^T (p dp)^T, then B^T (this tile) = K^T p^T: M =
      // Dh, N queries, K keys, through the one buffer in turn
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            store_split(dsb, swz(8 * j + 2 * l.qd + c, 16 * l.w + l.g + 8 * i), dp[4 * j + 2 * i + c]);
      async_fence();
      wg_sync(wg);
      clear(dp);
      product<8>(dp, f, Cols{kt, 1.f, live, l}, dsb_s, dsb_s + 2 * BOX);
      wait_acc(dp);
      add_to(dq, dp);
      wg_sync(wg);  // every warp's A products are done: the buffer takes p
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            store_split(dsb, swz(8 * j + 2 * l.qd + c, 16 * l.w + l.g + 8 * i), s[4 * j + 2 * i + c]);
      clear(s);
    }
    async_fence();
    wg_sync(wg);
    // dQ^T (this tile) = K^T dS^T, or clipped B^T: M = Dh, N queries, K keys
    product<8>(s, f, Cols{kt, 1.f, live, l}, dsb_s, dsb_s + 2 * BOX);
    wg_sync(wg);
    if ((ct & 127) == 0 && n + STAGES < n_tiles) {  // the slot's last gather is done
      async_fence();
      load(n + STAGES);
    }
    wait_acc(s);
    add_to(CLIPPED ? bq : dq, s);
  }
  if constexpr (CLIPPED) {
    // D of each query: the eight warps' sums over their keys, in order;
    // then dq = A - D B
    cta_sync();  // both warpgroups' products are done with their buffers
    float* red = reinterpret_cast<float*>(sm + L::DS);  // [8 warps][64]
    const int e0 = cols_of(lane.g);
#pragma unroll
    for (int c = 0; c < 2; ++c) red[(ct / 32) * 64 + 8 * (e0 / 2) + 2 * lane.qd + c] = part[c];
    cta_sync();
    if (ct < 64) {
      float dsum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dsum += red[w * 64 + ct];
      cs[ct].y = dsum;
      if (q0 + ct < a.Tq) a.dsum[stat_index(a, b, h, q0 + ct)] = dsum;
    }
    cta_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dsum = cs[8 * j + 2 * lane.qd + c].y;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          dq[x] = fmaf(-dsum, bq[x], dq[x]);
        }
      }
  }

  // warpgroup 1 hands its dq to warpgroup 0, which adds it and stores
  float* xch = reinterpret_cast<float*>(sm + L::DS + WG_TILE) + (ct % 128) * 32;
  if (wg == 1) {
    wg_sync(1);  // its last products are done with its buffer
#pragma unroll
    for (int i = 0; i < 32; i += 4)
      *reinterpret_cast<float4*>(xch + i) = make_float4(dq[i], dq[i + 1], dq[i + 2], dq[i + 3]);
  }
  cta_sync();
  if (wg == 1 || !live) return;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const float4 o = *reinterpret_cast<const float4*>(xch + i);
    dq[i] += o.x, dq[i + 1] += o.y, dq[i + 2] += o.z, dq[i + 3] += o.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = q0 + 8 * j + 2 * lane.qd + c;
      if (t >= a.Tq) continue;
      float* row = a.dq + (((long long)b * a.Tq + t) * a.Hq + h) * D;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        row[16 * lane.w + lane.g + 8 * i] = dq[4 * j + 2 * i + c] * a.scale;
    }
}

// ---------------------------------------------------------------------------
// 2. dk and dv of one (b, query head, key block). The two warpgroups take
// alternate query tiles; warpgroup 0 adds warpgroup 1's dk and dv at the
// end.
// ---------------------------------------------------------------------------
template <int D>
struct KvLayout {
  static constexpr int NB = D / 32;
  static constexpr int TILE = NB * BOX;
  static constexpr int K_HI = 0, K_LO = TILE, V_HI = 2 * TILE, V_LO = 3 * TILE;
  static constexpr int RING = 4 * TILE;                  // slot s: Q, then G
  static constexpr int PB = RING + STAGES * 2 * TILE;    // per warpgroup: P~, then dS [64 keys][64 q]
  static constexpr int BAR = PB + 2 * WG_TILE;
  static constexpr int BYTES = BAR + (1 + STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    Args a) {
  using L = KvLayout<D>;
  constexpr int NB = L::NB, KS = D / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::BAR, full0 = kv_full + 8;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z, G = a.Hq / a.Hkv, hk = h / G;
  const int q_lo = a.causal ? k0 : 0;  // BQ == BK: the tile holding query k0
  const int n_tiles = q_lo < a.Tq ? (a.Tq - q_lo + BQ - 1) / BQ : 0;
  init_barriers(kv_full);
  // Q and G of query tile n into its slot
  auto load = [&](int n) {
    const int st = n % STAGES;
    const uint32_t slot = base + L::RING + st * 2 * L::TILE, fb = full0 + 8 * st;
    attn::mbar_expect_tx(fb, 2 * L::TILE);
    for (int c = 0; c < NB; ++c) {
      attn::tma_load(slot + c * BOX, &tm_q, fb, 32 * c, h, q_lo + n * BQ, b);
      attn::tma_load(slot + L::TILE + c * BOX, &tm_g, fb, 32 * c, h, q_lo + n * BQ, b);
    }
  };
  if (threadIdx.x == 0) {  // K and V once, and the ring's first tiles
    attn::mbar_expect_tx(kv_full, 2 * L::TILE);
    for (int c = 0; c < NB; ++c) {
      attn::tma_load(base + L::K_HI + c * BOX, &tm_k, kv_full, 32 * c, hk, k0, b);
      attn::tma_load(base + L::V_HI + c * BOX, &tm_v, kv_full, 32 * c, hk, k0, b);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load(n);
  }
  const int wg = uniform(threadIdx.x / 128);

  const int ct = threadIdx.x;
  const Lane lane{uniform((ct % 128) / 32), ct % 32, (ct % 32) / 4, ct % 4};
  uint8_t* pb = sm + L::PB + wg * WG_TILE;
  const uint32_t pb_s = base + L::PB + wg * WG_TILE;
  attn::mbar_wait(kv_full, 0);
  auto same = [](int, int, float4 x) { return x; };
  split_tile<NB>(sm + L::K_HI, sm + L::K_LO, same);
  split_tile<NB>(sm + L::V_HI, sm + L::V_LO, same);
  async_fence();
  cta_sync();

  float dk[32], dv[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  Frag f;
  const bool live = lane.w < D / 16;
  const long long bht = (long long)a.B * a.Hq * a.Tq;
#pragma unroll 1
  for (int n = wg; n < n_tiles; n += 2) {
    const Lane l = fresh(lane);
    const int q0 = q_lo + n * BQ, st = n % STAGES;
    float m[2], zc[2], c2[2], dsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long si = stat_index(a, b, h, min(q0 + 16 * l.w + l.g + 8 * i, a.Tq - 1));
      m[i] = a.stats[si];
      zc[i] = a.stats[bht + si];
      c2[i] = row_c2(m[i], zc[i]);
      dsum[i] = a.dsum[si];
    }
    attn::mbar_wait(full0 + 8 * st, (n / STAGES) & 1);
    const uint32_t qt_s = base + L::RING + st * 2 * L::TILE;
    const uint8_t* qt = sm + L::RING + st * 2 * L::TILE;
    const uint8_t* gt = qt + L::TILE;
    // S = (Q Dh^-0.5) K^T, dP~ = G V^T: M queries, N keys, K = Dh
    product<KS>(s, f, Rows{qt_s, a.scale, l},
                base + L::K_HI, base + L::K_LO);
    wait_acc(s);
    product<KS>(dp, f, Rows{qt_s + L::TILE, 1.f, l},
                base + L::V_HI, base + L::V_LO);
    wait_acc(dp);
    // P~ into s, dS into dp, in place. Entry (query row, key col) is
    // visible iff 8 j + c < lim[i] (col - 2 qd = 8 j + c): the keys before
    // Tk and, causal, at or before the row's query; none past Tq
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + 16 * l.w + l.g + 8 * i;
      lim[i] = (qp < a.Tq ? min(a.Tk, a.causal ? qp + 1 : a.Tk) - k0 : 0) - 2 * l.qd;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c;
          const Entry e = entry(a, 8 * j + c < lim[i], s[x], c2[i], m[i], zc[i], dp[x], [&] {
            return exact_score<D>(a, b, h, hk, q0 + 16 * l.w + l.g + 8 * i, k0 + 8 * j + 2 * l.qd + c);
          });
          s[x] = e.pt;
          dp[x] = e.p * (e.dp - dsum[i]);
        }
    wg_sync(wg);  // every warp's dK products of the last tile are done: the buffer is free
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          store_split(pb, swz(8 * j + 2 * l.qd + c, 16 * l.w + l.g + 8 * i), s[4 * j + 2 * i + c]);
    async_fence();
    wg_sync(wg);
    // dV^T (this tile) = G^T P~: M = Dh, N keys, K queries
    product<8>(s, f, Cols{gt, 1.f, live, l}, pb_s,
               pb_s + 2 * BOX);
    wait_acc(s);
    add_to(dv, s);
    wg_sync(wg);  // every warp's dV products are done: the buffer takes dS
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          store_split(pb, swz(8 * j + 2 * l.qd + c, 16 * l.w + l.g + 8 * i), dp[4 * j + 2 * i + c]);
    async_fence();
    wg_sync(wg);
    // dK^T (this tile) = (Q Dh^-0.5)^T dS: M = Dh, N keys, K queries
    product<8>(s, f, Cols{qt, a.scale, live, l}, pb_s,
               pb_s + 2 * BOX);
    wg_sync(wg);
    if ((ct & 127) == 0 && n + STAGES < n_tiles) {  // the slot's last gather is done
      async_fence();
      load(n + STAGES);
    }
    wait_acc(s);
    add_to(dk, s);
  }

  // warpgroup 1 hands its dk, dv to warpgroup 0, which adds them and stores
  float* xch = reinterpret_cast<float*>(sm + L::PB + WG_TILE) + (ct % 128) * 64;
  if (wg == 1) {
    wg_sync(1);  // its last products are done with its buffer
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      *reinterpret_cast<float4*>(xch + i) = make_float4(dk[i], dk[i + 1], dk[i + 2], dk[i + 3]);
      *reinterpret_cast<float4*>(xch + 32 + i) = make_float4(dv[i], dv[i + 1], dv[i + 2], dv[i + 3]);
    }
  }
  cta_sync();
  if (wg == 1 || !live) return;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(xch + i);
    const float4 y = *reinterpret_cast<const float4*>(xch + 32 + i);
    dk[i] += x.x, dk[i + 1] += x.y, dk[i + 2] += x.z, dk[i + 3] += x.w;
    dv[i] += y.x, dv[i + 1] += y.y, dv[i + 2] += y.z, dv[i + 3] += y.w;
  }
  const int hs = G > 1 ? h : hk, hn = G > 1 ? a.Hq : a.Hkv;  // partials per query head
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = k0 + 8 * j + 2 * lane.qd + c;
      if (t >= a.Tk) continue;
      const long long row = (((long long)b * a.Tk + t) * hn + hs) * D;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = 16 * lane.w + lane.g + 8 * i;
        a.dk[row + d] = dk[4 * j + 2 * i + c];
        a.dv[row + d] = dv[4 * j + 2 * i + c];
      }
    }
}

// ---------------------------------------------------------------------------
// 3. GQA: dk, dv of each KV head = the sum of its G query heads' partials,
// in head order
// ---------------------------------------------------------------------------
__global__ void bwd_sum_heads_kernel(const float4* pk, const float4* pv, float4* dk, float4* dv,
                                     long long n, int G, int d4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long src = (i / d4) * G * d4 + i % d4;
    float4 a = pk[src], c = pv[src];
    for (int g = 1; g < G; ++g) {
      const float4 x = pk[src + g * d4], y = pv[src + g * d4];
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
    }
    dk[i] = a;
    dv[i] = c;
  }
}

// Tensor map of an f32 (B, T, H, D) view with element strides (sb, st,
// sh) and a unit last stride: boxes of 32 columns x 64 rows of T under the
// 128-byte swizzle, zeros outside the view.
cudaError_t make_map(CUtensorMap* map, const float* ptr, int B, int T, int H, int D, long long sb,
                     long long st, long long sh) {
  const attn::EncodeFn enc = attn::encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)st * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t launch_one(K kern, dim3 grid, int smem, cudaStream_t s, const CUtensorMap& m0,
                       const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& m3,
                       const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, s>>>(m0, m1, m2, m3, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, long long sq[3], long long sk[3], long long sv[3], float* part_k,
                   float* part_v, cudaStream_t s) {
  const long long so[3] = {(long long)a.Tq * a.Hq * D, (long long)a.Hq * D, D};
  CUtensorMap mq, mdo, mg, mk, mv;
  cudaError_t err = make_map(&mq, a.q, a.B, a.Tq, a.Hq, D, sq[0], sq[1], sq[2]);
  if (err == cudaSuccess) err = make_map(&mdo, a.dout, a.B, a.Tq, a.Hq, D, so[0], so[1], so[2]);
  if (err == cudaSuccess)
    err = make_map(&mg, a.g != nullptr ? a.g : a.dout, a.B, a.Tq, a.Hq, D, so[0], so[1], so[2]);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.B, a.Tk, a.Hkv, D, sk[0], sk[1], sk[2]);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.B, a.Tk, a.Hkv, D, sv[0], sv[1], sv[2]);
  if (err != cudaSuccess) return err;
  err = launch_one(a.clipped ? bwd_dq_kernel<D, true> : bwd_dq_kernel<D, false>,
                   dim3((a.Tq + BQ - 1) / BQ, a.Hq, a.B), QLayout<D>::BYTES, s, mq, mdo, mk, mv, a);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  Args kv = a;
  if (G > 1) kv.dk = part_k, kv.dv = part_v;
  err = launch_one(bwd_dkdv_kernel<D>, dim3((a.Tk + BK - 1) / BK, a.Hq, a.B), KvLayout<D>::BYTES,
                   s, mq, mg, mk, mv, kv);
  if (err != cudaSuccess || G == 1) return err;
  const long long n = (long long)a.B * a.Tk * a.Hkv * D / 4;
  const unsigned blocks = (unsigned)(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
  bwd_sum_heads_kernel<<<blocks, 256, 0, s>>>(
      reinterpret_cast<const float4*>(part_k), reinterpret_cast<const float4*>(part_v),
      reinterpret_cast<float4*>(a.dk), reinterpret_cast<float4*>(a.dv), n, G, D / 4);
  return cudaGetLastError();
}

}  // namespace

// f32 only. q, k, v, gate: element strides (q, k, v 16-byte aligned rows
// and strides); u, dout, dq, dk, dv, dgate contiguous; stats: the
// forward's 2 x (B, Hq, Tq) (m, max(Z, 1e-30)); dsum: B * Hq * Tq floats of
// scratch; g: B * Tq * Hq * Dh floats of scratch under a gate, else null;
// part_k, part_v: B * Tk * Hq * Dh floats each of scratch when Hq > Hkv,
// else null. Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* gate, const float* u,
    const float* dout, const float* stats, float* dsum, float* g, float* dq, float* dk, float* dv,
    float* dgate, float* part_k, float* part_v, int B, int Tq, int Tk, int Hq, int Hkv, int Dh,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sgb, long long sgt, long long sgh,
    int causal, int clipped, float zg, float gamma, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || (gate == nullptr) != (dgate == nullptr) ||
      (gate == nullptr) != (g == nullptr) || (Hq > Hkv && (part_k == nullptr || part_v == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, gate, u, dout, stats, dsum, g, dq, dk, dv, dgate, B, Tq, Tk, Hq, Hkv,
         sqb, sqt, sqh, skb, skt, skh, sgb, sgt, sgh, causal, clipped, zg, gamma, scale};
  long long sq[3] = {sqb, sqt, sqh}, sk[3] = {skb, skt, skh}, sv[3] = {svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 32) return (int)launch<32>(a, sq, sk, sv, part_k, part_v, s);
  if (Dh == 64) return (int)launch<64>(a, sq, sk, sv, part_k, part_v, s);
  return (int)cudaErrorInvalidValue;
}
