// Flash-attention backward for NVIDIA Hopper (sm_90a). Three routes: f32
// 3xTF32 wgmma and bf16 wgmma (f32 accumulation), both fed by a TMA ring,
// and, for f32 at Dh 80 to 256, fmaf chains on CUDA cores (namespace cc),
// below.
//
// The gradient of csrc/flash_attention.cu's forward. It has no TPU
// counterpart: the JAX package trains through its plain attention
// (src/repro/core/attention.py : attention -> dense_attention /
// chunked_attention) and lets XLA differentiate it; none of its Pallas
// kernels has a custom_vjp. The port's cache-free attention on the card
// is the flash kernel, so its gradient is this kernel.
//
// Scope: every (dtype, head dim) the forward takes: f32 and bf16 q/k/v at
// Dh 8, 16, 32, 64, 80, 96, 128 and 256 (f32: 3xTF32 up to Dh 64, CUDA
// cores above; bf16: bf16 wgmma); causal or not, a local window or not, a
// logit softcap or not, a scalar or per-row query offset (query i of row b
// at position i + off, as the forward; Tk may exceed Tq), G = Hq / Hkv >=
// 1, model layout (B, T, H, Dh) with the forward's stride rules, vanilla,
// clipped (gamma, zeta) and gated. Dh 8 and 16 (the registry's smoke
// configs) run the Dh-32 bodies and Dh 80 and 96 the Dh-128 ones: the
// tensor maps (or, on CUDA cores, the staging loads) name the true head
// dim, so columns past Dh arrive as zeros, add exact zeros to S and dP and
// are not stored; q's scale is the true Dh's. A key no query sees (Tk >
// Tq + off, or behind every window) gets dk = dv = 0 written; a query that
// sees no key gets dq = 0 and dgate = dO . u (u = 0 there).
//
// For query row i, s_ij = (q_i Dh^-0.5) . k_j (q scaled in its dtype first,
// as the forward), capped s_ij <- c tanh(s_ij / c) under a softcap c,
// masked (causal, window) p_ij = exp(s_ij - m_i) / Z_i, P~ = p (vanilla) or
// clip((zeta - gamma) p + gamma, 0, 1) masked (clipped), u_i = sum_j P~_ij
// v_j, g_i = gate_i dO_i (gate 1 without gating):
//   dgate_i = dO_i . u_i
//   dv_j    = sum_i P~_ij g_i,     dP~_ij = g_i . v_j
//   dp_ij   = dP~_ij (vanilla), (zeta - gamma) 1[0 < (zeta-gamma) p + gamma < 1] dP~_ij (clipped)
//   ds_ij   = p_ij (dp_ij - D_i) (1 - (s_ij / c)^2),  D_i = sum_l p_il dp_il
//             (the last factor, the softcap's slope at the capped score, 1
//             without one)
//   dq_i    = Dh^-0.5 sum_j ds_ij k_j,   dk_j = sum_i ds_ij (q_i Dh^-0.5)
// A window cuts both walks at its edge: dq walks keys from the block's
// first query's position - window + 1, dk/dv queries up to the key block's
// last key + window - 1 - off; a query offset shifts the causal edge the
// same way (dq walks keys up to the block's last query + off, dk/dv
// queries from its first key - off); the tiles across an edge are masked
// per entry.
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
// Two launches (three for GQA). On the f32 route each CTA has two
// warpgroups taking alternate tiles of the CTA's walk (one's softmax runs
// while the other's products do), warpgroup 0 adding warpgroup 1's sums at
// the end; tiles of 64 queries x 64 keys stream through a ring of STAGES
// TMA slots (one mbarrier each), the first filled at the start, each
// refilled by one thread of the warpgroup that read it last, STAGES tiles
// on. (It has no producer warp: 288 threads cap the registers at 168 a
// thread without setmaxnreg; the bf16 route's producer warpgroup, below,
// hands its registers to the consumers.)
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
// The f32 route. What bounds it on an H100: operations. The function needs
// 10 flops per visible pair and column (S, dP~, dv, dq, dk), here each f32
// product three TF32 ones: 30 at 495 TFLOP/s, i.e. 10 at an effective 165 TFLOP/s
// (0.098 ms at BERT-base's (8, 512, 12/12, 64), 0.195 at OPT-125m's (2,
// 2048, 12/12, 64) causal), against ~10 bytes per token and head of inputs
// and outputs. One CTA a SM, with two warpgroups for the overlap a second
// CTA would give: the hi/lo copies double each B tile, so dk/dv holds 224
// KB of shared memory at Dh 64 (K, V: 64 KB; three ring slots of Q and G:
// 96 KB; each warpgroup's P~/dS buffer: 32 KB) and dq as much (Q, G: 64
// KB; three slots of K and V: 96 KB; dS: 2 x 32 KB).
//
// The bf16 route (namespace bf). The same two launches and GQA head sum,
// the same D_i from the saved f32 u (vanilla, gated) or the A - D B walk
// (clipped), the same determinism (each output has one owner summing in a
// fixed order; GQA's per-query-head partials are f32 and summed in head
// order, so dk and dv round to bf16 once), the same f32 re-check of
// clipped scores within 1e-4 of an edge (from the bf16 data, q Dh^-0.5
// rounded to bf16 as the forward rounds it). What differs:
//   * Products: bf16 wgmma, f32 accumulation. q Dh^-0.5, k, v and dO are
//     bf16 and enter exactly; the products over the head dim (S = Q K^T,
//     dP = dO V^T, and their transposes in dk/dv) read both operands from
//     the raw swizzled TMA tiles (K-major descriptors, as the forward's
//     S); the products over tokens take the f32 factor from registers and
//     the bf16 tile through the MN-major descriptor (as the forward's
//     P.V): dq += dS K, dv += (P~ gate)^T dO, dk += dS^T (Q Dh^-0.5).
//   * The f32 factors P~ and dS go in as hi = bf16(x) and lo = bf16(x -
//     hi), two products against the same tile (the forward's P split): one
//     bf16 operand misses the gradient bound (chip_smoke.py's control).
//     The gate needs no operand of its own: gate_i (dO_i . v_j) is applied
//     to dP in registers after the product, and folded into dV's factor
//     (P~_ij gate_i), so no gated dO is written.
//   * The accumulator's layout is the A fragment's, so the factors go from
//     the S / dP accumulators to the next product without shared memory:
//     dq's CTA owns 64 queries (M = queries), dk/dv's 64 keys (M = keys,
//     S^T = K Q^T).
//   * Roles (384 threads, __launch_bounds__(384, 1): 168 registers a
//     thread at launch). Warpgroup 0 is the producer and gives registers
//     back (setmaxnreg.dec to 24); warpgroups 1 and 2 are the consumers and
//     take them (setmaxnreg.inc to 240). The pool an .inc draws on is what
//     the .dec released, 4 warps x (168 - 24) = 8 warps x (240 - 168)
//     registers: 24 / 240 is the only split with 240 (a 32-register
//     producer left the consumers waiting for registers that never came).
//     The roles split in one branch whose paths never reconverge. One
//     producer thread issues every TMA load. In dq the producer warpgroup
//     also scales Q by Dh^-0.5 in bf16 in place, once (the forward's
//     rounding), while the consumers compute the block's row data (c2, m,
//     Z, the gate; D and dgate from dO and u) and write each row's c2 and
//     gate beside D for dk/dv. In dk/dv the producer's other three warps
//     ready each query tile of the ring: they stage its rows' (c2, D,
//     gate, m, Z) beside the slot (five loads of one index: c2, D and the
//     gate from dq's scratch) and, once the tile lands, scale its Q in
//     place; at Dh 64, where Dh^-0.5 = 1/8 is a power of two, Q stays as
//     it landed and the consumers scale S^T and dK instead (the same bits).
//     Producer values are recomputed where used: held across its loops,
//     they outgrew 24 registers.
//   * The ring: STAGES slots (four up to Dh 128, two at Dh 256, where a
//     slot of K and V, or Q and dO, is 64 KB), each with a full mbarrier
//     (the TMA load's bytes), in dk/dv a ready one (one arrival per
//     readying warp) and an empty one (one arrival per warp of the
//     consumer that read it, once its products are done: 128 lanes
//     arriving one by one serialize). A refill waits on its slot's empty
//     barrier only, never on a warpgroup sync; the producer's waits carry
//     a suspend-time hint.
//   * The consumers take alternate tiles of the walk (consumer w the tiles
//     w, w + 2, ...), each with the whole block's accumulators, consumer 0
//     adding consumer 1's sums at the end. Each runs a section a tile (the
//     products over tokens of its previous tile, then S and dP of this one)
//     and a last one, then the tile's scalar work.
//   * What overlaps with what. LATE, where the registers hold two sets of
//     products' operands beside the next S and dP (the sums' accumulators
//     at most 64 registers a thread: dq vanilla up to Dh 128, dq clipped
//     and dk/dv up to Dh 64) and the ring has more than two slots: a
//     section issues the products and then the next S and dP back to back
//     and waits with wgmma.wait_group 1, so S and dP run while the products
//     finish; the two consumers' sections then alternate on two named
//     barriers (ping-pong), so one's scalar work runs while the other's
//     products and S / dP run. SERIAL otherwise (dk/dv and the clipped dq
//     at Dh 128, everything at Dh 256): a section splits one factor into
//     hi / lo fragments, issues its product, waits, then the other, as the
//     first design did, and the consumers run free (a turn held across
//     those waits chained their latencies: measured slower, PERF.md).
//   * The scalar work. The kernels ran instruction-bound on it, not on
//     the tensor cores: every kernel is built for vanilla or clipped
//     (dq<D, CLIPPED>, dk/dv<D, CLIPPED>), and the clipped re-check (the
//     f32 score, tanh, expf and a division) runs out of the unrolled
//     32-entry loop: the loop marks the entries within 1e-4 of a clip edge
//     in a mask and a second loop redoes those (entry_fast, entry_exact;
//     the vanilla dk/dv loop defers its NaN entries the same way, which
//     keeps ptxas's schedule of it within 240 registers at Dh 128 and 256).
//     The gate's product g dP is rounded before D is subtracted
//     (__fmul_rn), as the first design's code rounded it.
//   * Summation order, unchanged from the first design, so every output is
//     bitwise the first design's (measured: PERF.md): each
//     consumer sums its own tiles in walk order, a tile's hi product before
//     its lo product, into one f32 accumulator (dq; clipped, A and B; dv,
//     dk); consumer 0 then adds consumer 1's sums; D's clipped partial sums
//     likewise (entries in loop order, the re-checked ones after), then the
//     row's four lanes; GQA's partials in head order.
//   * Head dims: 32 (64-byte swizzle), 64 and 128 native; 80 and 96 run
//     the Dh-128 body over TMA boxes zero-filled past Dh (the tensor maps
//     name the true head dim) and store Dh columns. The dk/dv consumers at
//     Dh 128 hold dK and dV (64 f32 registers each a thread) beside S and
//     dP (32 each) or one factor's hi/lo fragments. ptxas: no spill in any
//     instantiation.
//   * Dh 256 (recurrentgemma-9b's local attention, MQA: G 16) splits the
//     head dim (Split<D>): a CTA owns one (block of 64 tokens, half of the
//     256 columns), computes S and dP over all 256 columns and its products
//     over tokens over its 128 (dq or dk and dv; clipped, A and B). Whole,
//     dK and dV would be 128 registers each a thread and the clipped dq's A
//     and B as much, beside S and dP; split, every accumulator is the
//     Dh-128 body's. Shared memory: the fixed tiles (Q and dO, or K and V)
//     take 64 KB and a ring slot 64 KB, so the ring has two slots (197 KB
//     with the row data).
// What bounds it: operations, 10 flops per visible pair and column at 989
// TFLOP/s (0.109 ms at qwen3-14b's (1, 2048, 40/8, 128) causal). It
// issues 20 flops per pair and column (24 clipped; 28 at Dh 256, where
// each column half recomputes S and dP): S and dP in both launches, and
// dq, dv, dk each twice (hi and lo). PERF.md has its times.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
  int window;              // < 0: none
  float softcap;           // <= 0: none
  int dh;                  // the tensors' head dim (the body's D may exceed it: Dh 8, 16 in D 32)
  int q_offset;            // query i sits at position i + offset ...
  const int* q_offs;       // ... or i + q_offs[b] per batch row (null: q_offset)
  long long svb, svt, svh;  // v strides (the CUDA-core route; the 3xTF32 one reads v by TMA)
};

// the query offset of batch row b: query i sits at position i + offset
template <typename A>
__device__ __forceinline__ int qoff_of(const A& a, int b) {
  return a.q_offs != nullptr ? a.q_offs[b] : a.q_offset;
}

// byte offset of element (r, c) of a swizzled tile: boxes of 32 columns,
// rows of 128 bytes whose 16-byte chunks are XORed with r % 8 (TMA's
// 128-byte swizzle; wgmma's K-major 128-byte layout)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 5) * BOX + (r << 7) + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// p, P~ and dp of one entry of a tile, and fac, the softcap's slope at
// its capped score (1 without a softcap): ds = p (dp - D) fac
struct Entry {
  float p, pt, dp, fac;
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
constexpr int FAR = 1 << 30;  // a bound no position reaches

// A row's statistics: c2 = m log2(e) + log2(Z), so that p = 2^(s log2(e) -
// c2) is one fma and one exp2, and the forward's m and Z themselves
__device__ __forceinline__ float row_c2(float m, float zc) { return fmaf(m, LOG2E, log2f(zc)); }

// A tile's scores capped in place (cap <= 0: none), as the forward caps
// them, before the masks; the branch is uniform (a kernel argument), so the
// entries below pay nothing for it without a cap
__device__ __forceinline__ void cap_scores(float* s, float cap) {
  if (cap > 0.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = attn::softcap(s[i], cap);
  }
}

// 1 / cap, or 0 without a cap (attn::softcap_slope's icap)
template <typename A>
__device__ __forceinline__ float inv_cap(const A& a) {
  return a.softcap > 0.f ? 1.f / a.softcap : 0.f;
}

// p, P~, dp and the softcap's slope of one visible-or-masked entry of
// capped score sc (icap: inv_cap); ds = p (dp - D) fac. p = exp(s_c - m)
// / Z to ~1e-6 (the score's own product error). Clipped, an entry within
// 1e-4 (relative to zg p) of either edge of the clip has its score
// recomputed in f32 (exact(): an fmaf chain over Dh in order, then capped)
// and p taken as expf(s_c - m) / Z, as the forward's CUDA-core route
// computes it: the clip's indicator has no slope to forgive rounding.
template <typename A, typename F>
__device__ __forceinline__ Entry entry(const A& a, bool valid, float sc, float icap, float c2,
                                       float m, float zc, float dpt, F&& exact) {
  float p = valid ? exp2f(fmaf(sc, LOG2E, -c2)) : 0.f;
  Entry e{p, p, dpt, 1.f};
  if (a.clipped) {
    float x = a.zg * p + a.gamma;
    const float near = 1e-4f * a.zg * p;
    if (valid && (fabsf(x) <= near || fabsf(x - 1.f) <= near)) {
      sc = attn::softcap(exact(), a.softcap);
      p = expf(sc - m) / zc;
      x = a.zg * p + a.gamma;
      e.p = p;
    }
    e.pt = valid ? fminf(fmaxf(x, 0.f), 1.f) : 0.f;
    e.dp = (valid && x > 0.f && x < 1.f) ? a.zg * dpt : 0.f;
  }
  e.fac = attn::softcap_slope(sc, icap);
  return e;
}

// the f32 score of query row qp of head h and key kp of KV head hk, as the
// forward's CUDA-core route computes it: (q Dh^-0.5) . k, an fmaf chain
// over the true head dim
__device__ __forceinline__ float exact_score(const Args& a, int b, int h, int hk, int qp, int kp) {
  const float* qr = a.q + b * a.sqb + (long long)qp * a.sqt + h * a.sqh;
  const float* kr = a.k + b * a.skb + (long long)kp * a.skt + hk * a.skh;
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < a.dh; d += 4) {
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

template <typename A>
__device__ __forceinline__ long long stat_index(const A& a, int b, int h, int t) {
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
  const int qoff = qoff_of(a, b);
  // keys the block can see: cut at the causal edge of its last query and
  // the window's start for its first (query i at position i + qoff)
  const int k_hi = a.causal ? min(a.Tk, qoff + min(q0 + BQ, a.Tq)) : a.Tk;
  const int k_lo = a.window >= 0 ? max(0, qoff + q0 - a.window + 1) / BK * BK : 0;
  const int n_tiles = max(0, (k_hi - k_lo + BK - 1) / BK);
  init_barriers(qg_full);
  // K and V of key tile n into its slot
  auto load = [&](int n) {
    const int st = n % STAGES;
    const uint32_t slot = base + L::RING + st * 2 * L::TILE, fb = full0 + 8 * st;
    attn::mbar_expect_tx(fb, 2 * L::TILE);
    for (int c = 0; c < NB; ++c) {
      attn::tma_load(slot + c * BOX, &tm_k, fb, 32 * c, hk, k_lo + n * BK, b);
      attn::tma_load(slot + L::TILE + c * BOX, &tm_v, fb, 32 * c, hk, k_lo + n * BK, b);
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
      const int per = a.dh / 4;  // the thread's columns, summed in order
      const long long off = (((long long)b * a.Tq + t) * a.Hq + h) * a.dh + (ct & 3) * per;
      for (int c = 0; c < per; c += 2) {
        const float2 o = *reinterpret_cast<const float2*>(a.dout + off + c);
        const float2 x = *reinterpret_cast<const float2*>(a.u + off + c);
        dot = fmaf(o.x, x.x, dot);
        dot = fmaf(o.y, x.y, dot);
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
      if (t < a.Tq && col < a.dh)
        *reinterpret_cast<float4*>(a.g + (((long long)b * a.Tq + t) * a.Hq + h) * a.dh + col) = x;
    }
    return x;
  });
  async_fence();
  cta_sync();

  // dq; clipped, the sums A = sum_j p dp k_j (in dq) and B = sum_j p k_j
  // (in bq), D's partial sums in part, and dq = A - D B at the end
  float dq[32], bq[CLIPPED ? 32 : 1], s[32], dp[32], part[2] = {0.f, 0.f};
  float v[CLIPPED ? 16 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  if constexpr (CLIPPED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) bq[i] = 0.f;
  }
  Frag f;
  const bool live = lane.w < D / 16;  // rows of an M = Dh product
  const float icap = inv_cap(a);
#pragma unroll 1
  for (int n = wg; n < n_tiles; n += 2) {
    const Lane l = fresh(lane);
    const int t0 = k_lo + n * BK, st = n % STAGES;
    attn::mbar_wait(full0 + 8 * st, (n / STAGES) & 1);
    const uint32_t kt_s = base + L::RING + st * 2 * L::TILE;
    const uint8_t* kt = sm + L::RING + st * 2 * L::TILE;
    // S^T = K (Q Dh^-0.5)^T, dP~^T = V G^T: M keys, N queries, K = Dh
    product<KS>(s, f, Rows{kt_s, 1.f, l}, base + L::Q_HI, base + L::Q_LO);
    wait_acc(s);
    product<KS>(dp, f, Rows{kt_s + L::TILE, 1.f, l}, base + L::G_HI, base + L::G_LO);
    wait_acc(dp);
    cap_scores(s, a.softcap);
    wg_sync(wg);  // every warp's products of the last tile are done: the buffer is free
    // entry (key row, query col) is visible iff lo[i] <= col - 2 qd <
    // hi[i], col - 2 qd = 8 j + c a constant: a row past Tk sees nothing,
    // causal rows see the queries at or after their key (query i at
    // position i + qoff), windowed rows those before key + window, every
    // row none past Tq
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = t0 + 16 * l.w + l.g + 8 * i;
      lo[i] = (kp < a.Tk ? (a.causal ? kp - qoff - q0 : -BQ) : BQ) - 2 * l.qd;
      hi[i] = min(a.Tq, a.window >= 0 ? kp - qoff + a.window : FAR) - q0 - 2 * l.qd;
    }
    if constexpr (CLIPPED) {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0.f;
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
          const bool valid = lo[i] <= 8 * j + c && 8 * j + c < hi[i];
          const Entry e = entry(a, valid, s[x], icap, cst.x, cst.z, cst.w, dp[x],
                                [&] { return exact_score(a, b, h, hk, q0 + col, t0 + row); });
          if constexpr (CLIPPED) {  // p dp fac into dp, p fac into s, in place; p dp into D's sums
            v[2 * j + c] += e.p * e.dp;
            dp[x] = e.p * e.dp * e.fac;
            s[x] = e.p * e.fac;
          } else {
            store_split(dsb, swz(col, row), e.p * (e.dp - cst.y) * e.fac);
          }
        }
      }
    if constexpr (CLIPPED) {
      // D's sums over the warp's 16 keys of the tile: the thread's 16
      // columns (2 j + c, summed over its two rows above) reduced across its
      // 8 lane groups and scattered, 2 columns a lane (reduce_cols), added
      // to part
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
      float* row = a.dq + (((long long)b * a.Tq + t) * a.Hq + h) * a.dh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = 16 * lane.w + lane.g + 8 * i;
        if (d < a.dh) row[d] = dq[4 * j + 2 * i + c] * a.scale;  // past Dh: the Dh-32 body's zeros
      }
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
  const int qoff = qoff_of(a, b);
  // queries that can see the block's keys (query i at position i + qoff):
  // causal, none before key k0's; windowed, none past the window's end for
  // its last key. None (keys no query sees): dk = dv = 0 are written.
  const int q_lo = a.causal ? max(0, k0 - qoff) : 0;
  const int q_hi = a.window >= 0 ? min(a.Tq, k0 + BK + a.window - 1 - qoff) : a.Tq;
  const int n_tiles = q_lo < q_hi ? (q_hi - q_lo + BQ - 1) / BQ : 0;
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
  const float icap = inv_cap(a);
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
    cap_scores(s, a.softcap);
    // P~ into s, dS into dp, in place. Entry (query row, key col) is
    // visible iff from[i] <= 8 j + c < lim[i] (col - 2 qd = 8 j + c): the
    // keys before Tk and, causal, at or before the row's query's position
    // (row + qoff), windowed after that position - window; none past Tq
    int lim[2], from[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + 16 * l.w + l.g + 8 * i;
      lim[i] = (qp < a.Tq ? min(a.Tk, a.causal ? qp + qoff + 1 : a.Tk) - k0 : 0) - 2 * l.qd;
      from[i] = (a.window >= 0 ? qp + qoff - a.window + 1 : -FAR) - k0 - 2 * l.qd;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c;
          const bool valid = from[i] <= 8 * j + c && 8 * j + c < lim[i];
          const Entry e = entry(a, valid, s[x], icap, c2[i], m[i], zc[i], dp[x], [&] {
            return exact_score(a, b, h, hk, q0 + 16 * l.w + l.g + 8 * i, k0 + 8 * j + 2 * l.qd + c);
          });
          s[x] = e.pt;
          dp[x] = e.p * (e.dp - dsum[i]) * e.fac;
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
      const long long row = (((long long)b * a.Tk + t) * hn + hs) * a.dh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = 16 * lane.w + lane.g + 8 * i;
        if (d >= a.dh) continue;  // the Dh-32 body at Dh 8, 16: columns past Dh are zeros
        a.dk[row + d] = dk[4 * j + 2 * i + c];
        a.dv[row + d] = dv[4 * j + 2 * i + c];
      }
    }
}

// ---------------------------------------------------------------------------
// 3. GQA: dk, dv of each KV head = the sum of its G query heads' f32
// partials, in head order, rounded once to the output's type
// ---------------------------------------------------------------------------
__device__ __forceinline__ void put4(float4* p, float4 x) { *p = x; }
__device__ __forceinline__ void put4(uint2* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 r;
  memcpy(&r.x, &lo, 4);
  memcpy(&r.y, &hi, 4);
  *p = r;
}

// TO: float4 (f32 out) or uint2 (four bf16)
template <typename TO>
__global__ void bwd_sum_heads_kernel(const float4* pk, const float4* pv, TO* dk, TO* dv,
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
    put4(dk + i, a);
    put4(dv + i, c);
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

template <typename K, typename A>
cudaError_t launch_one(K kern, dim3 grid, int smem, cudaStream_t s, const CUtensorMap& m0,
                       const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& m3,
                       const A& a, int threads = THREADS) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(m0, m1, m2, m3, a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t sum_heads(const float* part_k, const float* part_v, TO* dk, TO* dv, long long n, int G,
                      int d4, cudaStream_t s) {
  const unsigned blocks = (unsigned)(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
  bwd_sum_heads_kernel<TO><<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(part_k),
                                                  reinterpret_cast<const float4*>(part_v), dk,
                                                  dv, n, G, d4);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, long long sq[3], long long sk[3], long long sv[3], float* part_k,
                   float* part_v, cudaStream_t s) {
  // the maps name the true head dim: a Dh-8 or 16 row's box of 32
  // columns arrives zero-filled past Dh
  const long long so[3] = {(long long)a.Tq * a.Hq * a.dh, (long long)a.Hq * a.dh, a.dh};
  CUtensorMap mq, mdo, mg, mk, mv;
  cudaError_t err = make_map(&mq, a.q, a.B, a.Tq, a.Hq, a.dh, sq[0], sq[1], sq[2]);
  if (err == cudaSuccess)
    err = make_map(&mdo, a.dout, a.B, a.Tq, a.Hq, a.dh, so[0], so[1], so[2]);
  if (err == cudaSuccess)
    err = make_map(&mg, a.g != nullptr ? a.g : a.dout, a.B, a.Tq, a.Hq, a.dh, so[0], so[1], so[2]);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.B, a.Tk, a.Hkv, a.dh, sk[0], sk[1], sk[2]);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.B, a.Tk, a.Hkv, a.dh, sv[0], sv[1], sv[2]);
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
  return sum_heads(part_k, part_v, reinterpret_cast<float4*>(a.dk),
                   reinterpret_cast<float4*>(a.dv), (long long)a.B * a.Tk * a.Hkv * a.dh / 4, G,
                   a.dh / 4, s);
}

// ---------------------------------------------------------------------------
// The bf16 route: bf16 wgmma products with f32 accumulation, Dh 32, 64 and
// 128 native, Dh 80 and 96 through the Dh-128 body.
// ---------------------------------------------------------------------------
namespace bf {

constexpr int BT = 64;  // tokens a tile: queries of dq's block and of dk/dv's walk, keys likewise

// A CTA's share of the head dim D: all of it up to Dh 128; at Dh 256 one
// half of 128 columns (N = 2 CTAs a block of tokens), whose CTA computes S
// and dP over all 256 columns and its products over tokens (dq, dv, dk)
// over its half. The ring's slots: four up to Dh 128, two at Dh 256, where
// a slot (K and V, or Q and dO) is 64 KB.
template <int D>
struct Split {
  static constexpr int DN = D > 128 ? 128 : D;  // output columns a CTA owns
  static constexpr int N = D / DN;              // CTAs a block of tokens
  static constexpr int STAGES = D > 128 ? 2 : 4;
};

using attn::Bf16Tile;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* gate;          // null: no gate
  const float* u;             // (B, Tq, Hq, dh) f32 contiguous: the forward's ungated output
  const __nv_bfloat16* dout;  // (B, Tq, Hq, dh) contiguous
  const float* stats;         // 2 x (B, Hq, Tq): m, max(Z, 1e-30), from the forward
  float* dsum;                // 3 x (B, Hq, Tq): D, c2, gate, written by dq, read by dk/dv
  __nv_bfloat16* dq;          // (B, Tq, Hq, dh) contiguous
  __nv_bfloat16* dk;          // (B, Tk, Hkv, dh) contiguous
  __nv_bfloat16* dv;
  float* dgate;               // (B, Tq, Hq) contiguous, or null
  float* part_k;              // G > 1: (B, Tk, Hq, dh) f32 partials, else null
  float* part_v;
  int B, Tq, Tk, Hq, Hkv, dh;
  long long sqb, sqt, sqh, skb, skt, skh, sgb, sgt, sgh;  // q, k, gate strides
  int causal, clipped;
  float zg, gamma, scale;
  int window;
  float softcap;
  int q_offset;       // query i sits at position i + offset ...
  const int* q_offs;  // ... or i + q_offs[b] per batch row (null: q_offset)
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the f32 score of query qp of head h and key kp of KV head hk from the
// bf16 data, as the reference computes it: (q Dh^-0.5 rounded to bf16) .
// k, an fmaf chain over dh in order
__device__ __forceinline__ float exact_score(const Args& a, int b, int h, int hk, int qp, int kp) {
  const __nv_bfloat16* qr = a.q + b * a.sqb + (long long)qp * a.sqt + h * a.sqh;
  const __nv_bfloat16* kr = a.k + b * a.skb + (long long)kp * a.skt + hk * a.skh;
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < a.dh; d += 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + d));
    acc = fmaf(round_bf16(x.x * a.scale), y.x, acc);
    acc = fmaf(round_bf16(x.y * a.scale), y.y, acc);
  }
  return acc;
}

// Shared-memory stores and loads by 32-bit address (the producer's 24
// registers hold no 64-bit generic pointers; a load in asm volatile is
// also never hoisted out of a loop into a register held across it)
__device__ __forceinline__ int ld_shared_int(uint32_t addr) {
  int x;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y, float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(x), "f"(y), "f"(z),
               "f"(w)
               : "memory");
}

// Row t's c2, D and gate (written by dq into the scratch planes 1, 0 and
// 2), m and Z into slot i of the rows at shared address rows (KvLayout):
// five loads at offsets k B Hq Tq of one index, no strided gate address
__device__ __forceinline__ void stage_row(const Args& a, int b, int h, int t, uint32_t rows,
                                          int i) {
  const long long si = stat_index(a, b, h, t), bht = (long long)a.B * a.Hq * a.Tq;
  const float* d = a.dsum + si;
  st_shared(rows + 16 * i, d[bht], d[0], a.gate != nullptr ? d[2 * bht] : 1.f, a.stats[si]);
  st_shared(rows + 64 * 16 + 4 * i, a.stats[bht + si]);
}

// scale_tile by 32-bit shared address, 16 bytes at a time
__device__ __forceinline__ void scale_words(uint32_t t, int bytes, float scale, int i, int n) {
#pragma unroll 1
  for (int x = 16 * i; x < bytes; x += 16 * n) {
    uint32_t w[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(t + x)
                 : "memory");
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      __nv_bfloat162 e;
      memcpy(&e, &w[y], sizeof(e));
      const float2 f = __bfloat1622float2(e);
      e = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      memcpy(&w[y], &e, sizeof(e));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(t + x), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// entry() of the bf16 kernels, split in two so that the unrolled tile
// loop carries the clipped re-check's code once, not 32 times (it ran
// instruction-bound). entry_fast: p, P~, dp and the slope from the
// product's score; near: clipped and within 1e-4 (relative to zg p) of a
// clip edge, an entry the caller finishes with entry_exact instead.
// CLIPPED: 1 or 0, or -1 to read a.clipped (as entry()'s).
template <int CLIPPED>
__device__ __forceinline__ Entry entry_fast(const Args& a, bool valid, float sc, float icap,
                                            float c2, float dpt, bool& near) {
  const float p = valid ? exp2f(fmaf(sc, LOG2E, -c2)) : 0.f;
  Entry e{p, p, dpt, 1.f};
  near = false;
  if (CLIPPED > 0 || (CLIPPED < 0 && a.clipped)) {
    const float x = a.zg * p + a.gamma;
    const float nr = 1e-4f * a.zg * p;
    near = valid && (fabsf(x) <= nr || fabsf(x - 1.f) <= nr);
    e.pt = valid ? fminf(fmaxf(x, 0.f), 1.f) : 0.f;
    e.dp = (valid && x > 0.f && x < 1.f) ? a.zg * dpt : 0.f;
  }
  e.fac = attn::softcap_slope(sc, icap);
  return e;
}

// A near entry (visible, clipped) of query qp and key kp: its score
// recomputed in f32 (exact_score) and capped, p = expf(s_c - m) / Z as the
// forward's CUDA-core route computes it (entry()'s re-check)
__device__ __forceinline__ Entry entry_exact(const Args& a, int b, int h, int hk, int qp, int kp,
                                             float icap, float m, float zc, float dpt) {
  const float sc = attn::softcap(exact_score(a, b, h, hk, qp, kp), a.softcap);
  const float p = expf(sc - m) / zc;
  const float x = a.zg * p + a.gamma;
  return Entry{p, fminf(fmaxf(x, 0.f), 1.f), (x > 0.f && x < 1.f) ? a.zg * dpt : 0.f,
               attn::softcap_slope(sc, icap)};
}

// v[sel] for a runtime sel, by selects (an indexed register array would
// live in local memory)
__device__ __forceinline__ float pick(const float* v, int sel) {
  float r = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) r = x == sel ? v[x] : r;
  return r;
}
__device__ __forceinline__ void put(float* v, int sel, float y) {
#pragma unroll
  for (int x = 0; x < 32; ++x) v[x] = x == sel ? y : v[x];
}

// q Dh^-0.5 rounded to bf16 in place, over a tile of `bytes` at t, by
// `n` threads (index i), as the forward scales its Q tile
__device__ __forceinline__ void scale_tile(uint8_t* t, int bytes, float scale, int i, int n) {
  uint4* p = reinterpret_cast<uint4*>(t);
  for (int x = i; x < bytes / 16; x += n) {
    uint4 r = p[x];
    __nv_bfloat162 e[4];
    memcpy(e, &r, sizeof(r));
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const float2 f = __bfloat1622float2(e[y]);
      e[y] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    memcpy(&r, e, sizeof(r));
    p[x] = r;
  }
}

// acc (64 x 64) = A B^T over D: A and B 64-row tiles at shared addresses
// a and b, both K-major (the product over the head dim)
template <int D>
__device__ __forceinline__ void product_ss(float* acc, uint32_t a, uint32_t b) {
  using T = Bf16Tile<D>;
  constexpr int KPB = T::ROW / 32;  // k16 steps per box row
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / KPB) * T::CHUNK + (kk % KPB) * 32;
    attn::wgmma_ss_n64(acc, attn::desc(a + off, 16, T::SBO, T::LAYOUT),
                       attn::desc(b + off, 16, T::SBO, T::LAYOUT), kk > 0);
  }
}

// acc (64 x D) += X Y over the 64 tokens of a tile: X an f32 factor carried
// as hi and lo bf16 fragments of four k16 steps, Y the bf16 tile at y read
// through the MN-major descriptor (16 tokens a step)
template <int D>
__device__ __forceinline__ void product_rs(float* acc, const uint32_t (*hi)[4],
                                           const uint32_t (*lo)[4], uint32_t y) {
  using T = Bf16Tile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    attn::wgmma_rs<D>(acc, hi[kk], attn::desc(y + kk * 16 * T::ROW, T::CHUNK, T::SBO, T::LAYOUT));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    attn::wgmma_rs<D>(acc, lo[kk], attn::desc(y + kk * 16 * T::ROW, T::CHUNK, T::SBO, T::LAYOUT));
}

// the 64 x 64 accumulator x (rows of the warpgroup, 64 tokens) as the A
// fragments of four k16 steps, each entry split hi = bf16(x), lo = bf16(x
// - hi)
__device__ __forceinline__ void to_frags(const float* x, uint32_t (*hi)[4], uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      attn::split_hi_lo2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

template <int N>
__device__ __forceinline__ void zero(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// ---------------------------------------------------------------------------
// The roles of a CTA (both launches): warpgroup 0 the producer, warpgroups
// 1 and 2 the consumers, which take alternate tiles of the walk (consumer
// w the tiles w, w + 2, ...), each with the whole block's accumulators,
// consumer 0 adding consumer 1's sums at the end.
// ---------------------------------------------------------------------------
constexpr int THREADS = 384;
// setmaxnreg's budgets: 128 x 32 + 256 x 240 = 65,536, the SM's registers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Named barriers: 1 + w, consumer w's turn at the tensor cores; 3, both
// consumers (barrier 0 is __syncthreads)
__device__ __forceinline__ void turn_sync(int w) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_arrive(int w) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;" ::: "memory"); }

// attn::mbar_wait with a suspend-time hint: a thread whose phase has not
// completed is suspended (woken when it completes, or after ~10 ms at
// most) instead of polling, so waiting producer warps take no issue slots
// from the consumer warps beside them; a 32-bit clock (the producer's 24
// registers) and a trap after 2^31 cycles (~1 s; mbar_wait: 2^35).
__device__ __forceinline__ void mbar_sleep(uint32_t bar, uint32_t parity) {
  uint32_t t0 = 0;
  for (bool first = true;; first = false) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(10000000)
        : "memory");
    if (done) return;
    if (first) {
      t0 = (uint32_t)clock();
    } else if ((uint32_t)clock() - t0 > (1u << 31)) {
      __trap();
    }
  }
}

// One arrival a warp on an mbarrier, once every lane of the warp is past
// this point (128 lanes arriving one by one on one barrier serialize)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) attn::mbar_arrive(bar);
}

// A shared address the compiler cannot see through, once a tile: the wgmma
// descriptors of the fixed tiles are then computed where they are used,
// not hoisted out of the tile loop into registers the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The consumers' turns at the tensor cores (ping-pong). Consumer w runs
// one section for each of its `mine` tiles (the products over tokens of
// its previous tile, then S and dP of this one) and a last one (its last
// tile's products): mine + 1 sections. Its section i is the (2i + w)-th
// of both consumers' sections, which alternate, consumer 0 first: a
// section waits for the other consumer to have issued its previous one,
// and passes the turn on when it has issued its own; the scalar work
// (softmax, ds, the hi/lo split) runs between a consumer's sections,
// while the other's products run. With one tile in all there is no turn.
// Only issue-only sections take turns (a LATE walk, below): a section that
// waits inside it for its products (SERIAL) would chain the two consumers'
// latencies, and those run free (measured: PERF.md).
struct Turns {
  int w, last;  // last: the index of the last section of both, -1: no turns
  __device__ __forceinline__ Turns(int w_, int n_tiles, bool on) : w(w_) {
    const int na = (n_tiles + 1) / 2, nb = n_tiles / 2;
    last = on && nb > 0 ? na + nb + 1 : -1;
  }
  __device__ __forceinline__ void begin(int i) const {
    if (last >= 0 && 2 * i + w > 0) turn_sync(w);
  }
  __device__ __forceinline__ void end(int i) const {
    if (last >= 0 && 2 * i + w < last) turn_arrive(1 - w);
  }
};

// A consumer's walk: sections 0 .. mine (see Turns), each tile's scalar
// work after the section that issued its S and dP. issue(n) issues the
// products over tokens of tile n, retire<N>(n) waits until N wgmma groups
// at most are in flight (its products done) and releases its slot; sdp(n)
// issues S and dP of tile n; scalar(n) waits for them and turns them into
// the products' operands. LATE: a section issues the next S and dP behind
// the products and retires them after (wgmma.wait_group 1), where the
// registers hold both and the next tile's slot is not the last one's;
// else it retires the products before S and dP.
template <bool LATE, typename I, typename R, typename S, typename X>
__device__ __forceinline__ void walk(const Turns& turns, int mine, I&& issue, R&& retire, S&& sdp,
                                     X&& scalar) {
  if (mine <= 0) return;
  const int w = turns.w;
  turns.begin(0);
  sdp(w);
  turns.end(0);
  scalar(w);
#pragma unroll 1
  for (int i = 1; i < mine; ++i) {
    const int n = w + 2 * i;
    turns.begin(i);
    issue(n - 2);
    if constexpr (!LATE) retire(n - 2, 0);
    sdp(n);
    turns.end(i);
    if constexpr (LATE) retire(n - 2, 1);
    scalar(n);
  }
  turns.begin(mine);
  issue(w + 2 * mine - 2);
  turns.end(mine);
  retire(w + 2 * mine - 2, 0);
}

// wgmma.wait_group with a count known at the call: 0 or 1
__device__ __forceinline__ void wg_wait_upto(int n) {
  if (n == 0) attn::wg_wait<0>();
  else attn::wg_wait<1>();
}

// ---------------------------------------------------------------------------
// 1. dq of one (b, h, block of 64 queries, the CTA's columns); D and dgate
// of its rows first (vanilla, gated), or D summed over the walk (clipped).
// The producer loads Q, dO and the ring's K, V tiles and scales Q; the
// consumers compute the rows' statistics, then take alternate key tiles.
// ---------------------------------------------------------------------------
template <int D>
struct QLayout {
  static constexpr int STAGES = Split<D>::STAGES;
  static constexpr int TILE = Bf16Tile<D>::BYTES;
  static constexpr int Q = 0, DO = TILE, RING = 2 * TILE;  // slot s: K, then V
  static constexpr int CS = RING + STAGES * 2 * TILE;       // float4 [64]: c2, D, m, Z
  static constexpr int GT = CS + 64 * 16;                   // float [64]: the gate
  static constexpr int OFF = GT + 64 * 4;                   // int: the row's query offset
  // barriers: Q and dO landed, then Q scaled; per slot full (landed) and
  // empty (released by its reader)
  static constexpr int BAR = OFF + 16;
  static constexpr int BYTES = BAR + (2 + 2 * STAGES) * 8 + 1024;
};

template <int D, bool CLIPPED>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              Args a) {
  using L = QLayout<D>;
  using T = Bf16Tile<D>;
  constexpr int STAGES = L::STAGES, DN = Split<D>::DN, NS = Split<D>::N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t qd_full = base + L::BAR, q_ready = qd_full + 8, full0 = q_ready + 8,
                 empty0 = full0 + 8 * STAGES;

  // longest causal walks first; the NS CTAs of a block (its column parts)
  // side by side, so that they read the same K and V tiles about together
  const int q0 = (gridDim.x / NS - 1 - blockIdx.x / NS) * BT;
  const int part = blockIdx.x % NS, c0 = part * DN;  // the CTA's columns c0 .. c0 + DN - 1
  const uint32_t col_off = part * (DN / T::BOX) * T::CHUNK;  // their boxes in a tile
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  // keys the block can see (query i at position i + qoff; the consumers
  // read qoff back from shared memory where they need it)
  const int qoff = qoff_of(a, b);
  const int k_hi = a.causal ? min(a.Tk, qoff + min(q0 + BT, a.Tq)) : a.Tk;
  const int k_lo = a.window >= 0 ? max(0, qoff + q0 - a.window + 1) / BT * BT : 0;
  const int n_tiles = max(0, (k_hi - k_lo + BT - 1) / BT);
  if (threadIdx.x == 0) {
    *reinterpret_cast<int*>(sm + L::OFF) = qoff;
    attn::mbar_init(qd_full, 1);
    attn::mbar_init(q_ready, 4);
    for (int s = 0; s < STAGES; ++s) {
      attn::mbar_init(full0 + 8 * s, 1);
      attn::mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (uniform(threadIdx.x / 128) == 0) {
    // ---- the producer: loads, and Q Dh^-0.5 in bf16 in place ----
    regs_dec<PRODUCER_REGS>();
    const int tp = threadIdx.x;
    auto load = [&](int n) {  // K and V of key tile n into its slot
      const int st = n % STAGES;
      const uint32_t slot = base + L::RING + st * 2 * L::TILE, fb = full0 + 8 * st;
      attn::mbar_expect_tx(fb, 2 * L::TILE);
      for (int c = 0; c < T::NCH; ++c) {
        attn::tma_load(slot + c * T::CHUNK, &tm_k, fb, c * T::BOX, hk, k_lo + n * BT, b);
        attn::tma_load(slot + L::TILE + c * T::CHUNK, &tm_v, fb, c * T::BOX, hk, k_lo + n * BT, b);
      }
    };
    if (tp == 0) {  // Q and dO once, and the ring's first tiles
      attn::mbar_expect_tx(qd_full, 2 * L::TILE);
      for (int c = 0; c < T::NCH; ++c) {
        attn::tma_load(base + L::Q + c * T::CHUNK, &tm_q, qd_full, c * T::BOX, h, q0, b);
        attn::tma_load(base + L::DO + c * T::CHUNK, &tm_do, qd_full, c * T::BOX, h, q0, b);
      }
      for (int n = 0; n < min(STAGES, n_tiles); ++n) load(n);
    }
    mbar_sleep(qd_full, 0);
    scale_tile(sm + L::Q, L::TILE, a.scale, tp, 128);
    async_fence();
    warp_arrive(q_ready);
    if (tp == 0) {  // the ring: key tile n once its slot's last reader released it
      for (int n = STAGES; n < n_tiles; ++n) {
        mbar_sleep(empty0 + 8 * (n % STAGES), (n / STAGES - 1) & 1);
        load(n);
      }
    }
    return;
  }
  // ---- the consumers ----
  regs_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x - 128, w = uniform(ct / 128), tw = ct % 128;
  const int warp = uniform(tw / 32), g = (tw % 32) / 4, qd = tw % 4;
  float4* cs = reinterpret_cast<float4*>(sm + L::CS);
  float* gs = reinterpret_cast<float*>(sm + L::GT);
  const bool gated = a.gate != nullptr;

  {  // the block's rows, four threads a row: c2, m, Z, the gate and,
     // vanilla or gated, D = gate (dO . u); dgate = dO . u
    const int row = ct / 4, t = min(q0 + row, a.Tq - 1);
    const long long si = stat_index(a, b, h, t);
    float dot = 0.f;
    if (gated || !CLIPPED) {
      const long long off = (((long long)b * a.Tq + t) * a.Hq + h) * a.dh;
      for (int c = 2 * (ct & 3); c < a.dh; c += 8) {
        const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.dout + off + c));
        const float2 x = *reinterpret_cast<const float2*>(a.u + off + c);
        dot = fmaf(o.x, x.x, dot);
        dot = fmaf(o.y, x.y, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    }
    if ((ct & 3) == 0) {
      const float gt = gated ? a.gate[b * a.sgb + (long long)t * a.sgt + h * a.sgh] : 1.f;
      const float dsum = CLIPPED ? 0.f : gt * dot;
      const long long bht = (long long)a.B * a.Hq * a.Tq;
      const float m = a.stats[si], zc = a.stats[bht + si], c2 = row_c2(m, zc);
      cs[row] = make_float4(c2, dsum, m, zc);
      gs[row] = gt;
      if (q0 + row < a.Tq && part == 0) {
        a.dsum[bht + si] = c2;  // for dk/dv's producer, with the gate
        if (gated) a.dsum[2 * bht + si] = gt;
        if (!CLIPPED) a.dsum[si] = dsum;
        if (gated) a.dgate[((long long)b * a.Tq + t) * a.Hq + h] = dot;
      }
    }
  }
  consumers_sync();  // every row's statistics are written
  attn::mbar_wait(q_ready, 0);

  // dq, or clipped A = sum_j (p dp fac) k_j; clipped, B = sum_j (p fac) k_j
  // and D's partial sums, then dq = A - D B
  float acc[DN / 2], bacc[CLIPPED ? DN / 2 : 1], s[32], dp[32], dpart[2] = {0.f, 0.f};
  zero<DN / 2>(acc);
  if constexpr (CLIPPED) zero<DN / 2>(bacc);
  // SERIAL where the sums' accumulators take over 64 registers a thread
  // (the clipped dq at Dh 128 and 256): a section splits each factor into
  // hi and lo fragments just before its product and waits for that product
  // before the next split, so one set of fragments is live beside the
  // accumulators, as in the first design. Else the scalar work leaves
  // every factor split and a section issues the products back to back.
  constexpr bool SERIAL = (CLIPPED ? DN : DN / 2) > 64;
  constexpr bool LATE = !SERIAL && STAGES > 2;
  // the A operands of a tile's products: dS (clipped: p dp fac) and,
  // clipped, p fac, as hi and lo bf16 fragments
  constexpr int F2 = CLIPPED && !SERIAL ? 4 : 1;
  uint32_t hi[4][4], lo[4][4], hi2[F2][4], lo2[F2][4];
  const float icap = inv_cap(a);
  const int r0 = warp * 16 + g;  // the thread's rows r0, r0 + 8 of the block
  float c2[2], dsr[2], mr[2], zr[2], gr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 x = cs[r0 + 8 * i];
    c2[i] = x.x, dsr[i] = x.y, mr[i] = x.z, zr[i] = x.w;
    gr[i] = gs[r0 + 8 * i];
  }
  auto kslot = [&](int n) { return base + L::RING + (n % STAGES) * 2 * L::TILE; };
  // dq += dS K (clipped: A += (p dp fac) K, B += (p fac) K) of tile n: M
  // queries, N = the CTA's DN columns, K keys
  auto issue = [&](int n) {
    if constexpr (SERIAL) {  // clipped: A, then B
      to_frags(dp, hi, lo);
      attn::wg_fence();
      product_rs<DN>(acc, hi, lo, kslot(n) + col_off);
      attn::wg_commit();
      attn::wg_wait<0>();
      to_frags(s, hi, lo);
      attn::wg_fence();
      product_rs<DN>(bacc, hi, lo, kslot(n) + col_off);
      attn::wg_commit();
    } else {
      attn::wg_fence();
      product_rs<DN>(acc, hi, lo, kslot(n) + col_off);
      if constexpr (CLIPPED) product_rs<DN>(bacc, hi2, lo2, kslot(n) + col_off);
      attn::wg_commit();
    }
  };
  auto retire = [&](int n, int groups) {
    wg_wait_upto(groups);
    warp_arrive(empty0 + 8 * (n % STAGES));
  };
  // S = (Q Dh^-0.5) K^T, dP = dO V^T of tile n: M queries, N keys, K = Dh.
  // The accumulators are zeroed first: their values came out of the
  // clipped entries' lane-dependent branch (see clear())
  auto sdp = [&](int n) {
    attn::mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
    const uint32_t qt = opaque(base + L::Q);
    zero<32>(s);
    zero<32>(dp);
    attn::wg_fence();
    product_ss<D>(s, qt, kslot(n));
    product_ss<D>(dp, qt + (L::DO - L::Q), kslot(n) + L::TILE);
    attn::wg_commit();
  };
  auto scalar = [&](int n) {
    attn::wg_wait<0>();
    attn::reg_fence<32>(s);
    attn::reg_fence<32>(dp);
    const int t0 = k_lo + n * BT, qoff = ld_shared_int(base + L::OFF);
    cap_scores(s, a.softcap);
    uint32_t near = 0;  // clipped: the entries to re-check, bit x
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * r + c;
          const int qp = q0 + r0 + 8 * r, kp = t0 + 8 * j + 2 * qd + c;
          const bool valid =
              kp < a.Tk && qp < a.Tq && attn::visible(kp, qp + qoff, a.causal, a.window);
          bool nr;
          const Entry e = entry_fast<CLIPPED>(a, valid, s[x], icap, c2[r],
                                                    __fmul_rn(gr[r], dp[x]), nr);
          if constexpr (CLIPPED) {  // p dp fac into dp, p fac into s; p dp into D's sums
            if (nr) {
              near |= 1u << x;
              continue;
            }
            dpart[r] += e.p * e.dp;
            dp[x] = e.p * e.dp * e.fac;
            s[x] = e.p * e.fac;
          } else {
            s[x] = e.p * (e.dp - dsr[r]) * e.fac;  // dS
          }
        }
    if constexpr (CLIPPED) {
      while (near != 0) {  // rare: the entries near a clip edge, s and dp raw
        const int x = __ffs(near) - 1, r = (x >> 1) & 1;
        near &= near - 1;
        // (the row's values by selects, not a runtime index into registers)
        const Entry e = entry_exact(a, b, h, hk, q0 + r0 + 8 * r, t0 + 8 * (x >> 2) + 2 * qd + (x & 1),
                                    icap, r ? mr[1] : mr[0], r ? zr[1] : zr[0],
                                    __fmul_rn(r ? gr[1] : gr[0], pick(dp, x)));
        if (r) {
          dpart[1] += e.p * e.dp;
        } else {
          dpart[0] += e.p * e.dp;
        }
        put(dp, x, e.p * e.dp * e.fac);
        put(s, x, e.p * e.fac);
      }
      if constexpr (!SERIAL) {
        to_frags(dp, hi, lo);
        to_frags(s, hi2, lo2);
      }
    } else {
      to_frags(s, hi, lo);
    }
  };
  walk<LATE>(Turns(w, n_tiles, LATE), (n_tiles - w + 1) / 2, issue, retire, sdp, scalar);
  attn::reg_fence<DN / 2>(acc);
  if constexpr (CLIPPED) attn::reg_fence<DN / 2>(bacc);

  // consumer 1 hands its sums to consumer 0, which adds them and stores
  constexpr int XN = CLIPPED ? DN + 2 : DN / 2;
  consumers_sync();  // both consumers are done with the ring
  float* xch = reinterpret_cast<float*>(sm + L::RING) + tw * XN;
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) xch[i] = acc[i];
    if constexpr (CLIPPED) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) xch[DN / 2 + i] = bacc[i];
      xch[DN] = dpart[0];
      xch[DN + 1] = dpart[1];
    }
  }
  consumers_sync();
  if (w == 1) return;
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] += xch[i];
  if constexpr (CLIPPED) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) bacc[i] += xch[DN / 2 + i];
    // D of each row: the two consumers' partial sums, then the row's quad
    // (every column part sums the same D; part 0 writes it)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float d = dpart[i] + xch[DN + i];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int t = q0 + r0 + 8 * i;
      if (qd == 0 && t < a.Tq && part == 0) a.dsum[stat_index(a, b, h, t)] = d;
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {
        acc[4 * j + 2 * i] = fmaf(-d, bacc[4 * j + 2 * i], acc[4 * j + 2 * i]);
        acc[4 * j + 2 * i + 1] = fmaf(-d, bacc[4 * j + 2 * i + 1], acc[4 * j + 2 * i + 1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    if (t >= a.Tq) continue;
    __nv_bfloat16* row = a.dq + (((long long)b * a.Tq + t) * a.Hq + h) * a.dh + c0;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      if (c0 + 8 * j >= a.dh) break;  // the Dh-128 body at Dh 80 / 96: columns past Dh are zeros
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * qd) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * a.scale, acc[4 * j + 2 * i + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv of one (b, query head, block of 64 keys, the CTA's columns).
// The producer loads K, V and the ring's Q, dO tiles, then readies each
// tile (its rows' statistics beside it, Q scaled); the consumers take
// alternate query tiles.
// ---------------------------------------------------------------------------
template <int D>
struct KvLayout {
  static constexpr int STAGES = Split<D>::STAGES;
  static constexpr int TILE = Bf16Tile<D>::BYTES;
  static constexpr int K = 0, V = TILE, RING = 2 * TILE;  // slot s: Q, then dO
  // per slot the tile's rows: float4 [64] (c2, D, gate, m), then float
  // [64] (Z)
  static constexpr int ROWS = RING + STAGES * 2 * TILE, ROW_BYTES = 64 * 20;
  // int [2]: the walk's first query q_lo and the row's query offset
  static constexpr int OFF = ROWS + STAGES * ROW_BYTES;
  // barriers: K and V landed; per slot full (landed), ready (Q scaled, the
  // statistics written) and empty (released by its reader)
  static constexpr int BAR = OFF + 16;
  static constexpr int BYTES = BAR + (1 + 3 * STAGES) * 8 + 1024;
};

// the producer threads that ready the ring's tiles (warps 1-3; warp 0's
// first thread issues the loads)
constexpr int READIERS = 96;

template <int D, bool CLIPPED>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                Args a) {
  using L = KvLayout<D>;
  using T = Bf16Tile<D>;
  constexpr int STAGES = L::STAGES, DN = Split<D>::DN, NS = Split<D>::N;
  constexpr int CL = CLIPPED ? 1 : 0;
  // POW2: at Dh 64 Dh^-0.5 = 1/8, a power of two, so q Dh^-0.5 in bf16 is
  // q scaled exactly (bar subnormals), and scaling S^T and dK by it instead
  // gives the same bits: the readiers leave Q as it landed and the
  // consumers wait for the tile themselves. (Dh 256's 1/16 would allow the
  // same, and it ran its clipped rows faster, but its vanilla dk/dv then
  // spilled 8 bytes.)
  constexpr bool POW2 = D == 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::BAR, full0 = kv_full + 8, ready0 = full0 + 8 * STAGES,
                 empty0 = ready0 + 8 * STAGES;

  // the NS CTAs of a key block (its column parts) side by side
  const int k0 = (blockIdx.x / NS) * BT;
  const int part = blockIdx.x % NS, c0 = part * DN;  // the CTA's columns c0 .. c0 + DN - 1
  const uint32_t col_off = part * (DN / T::BOX) * T::CHUNK;  // their boxes in a tile
  const int h = blockIdx.y, b = blockIdx.z, G = a.Hq / a.Hkv, hk = h / G;
  // queries that can see the block's keys (query i at position i + qoff);
  // none: the walk is empty and dk = dv = 0 are written. The readiers and
  // consumers read q_lo and qoff back from shared memory.
  const int qoff = qoff_of(a, b);
  const int q_lo = a.causal ? max(0, k0 - qoff) : 0;
  const int q_hi = a.window >= 0 ? min(a.Tq, k0 + BT + a.window - 1 - qoff) : a.Tq;
  const int n_tiles = q_lo < q_hi ? (q_hi - q_lo + BT - 1) / BT : 0;
  if (threadIdx.x == 0) {
    reinterpret_cast<int*>(sm + L::OFF)[0] = q_lo;
    reinterpret_cast<int*>(sm + L::OFF)[1] = qoff;
    attn::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      attn::mbar_init(full0 + 8 * s, 1);
      attn::mbar_init(ready0 + 8 * s, READIERS / 32);
      attn::mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (uniform(threadIdx.x / 128) == 0) {
    // ---- the producer ----
    regs_dec<PRODUCER_REGS>();
    const int tp = threadIdx.x;
    if (tp == 0) {  // K and V once; query tile n once its slot's last reader released it
      attn::mbar_expect_tx(kv_full, 2 * L::TILE);
      for (int c = 0; c < T::NCH; ++c) {
        attn::tma_load(base + L::K + c * T::CHUNK, &tm_k, kv_full, c * T::BOX, hk, k0, b);
        attn::tma_load(base + L::V + c * T::CHUNK, &tm_v, kv_full, c * T::BOX, hk, k0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        const uint32_t slot = base + L::RING + st * 2 * L::TILE, fb = full0 + 8 * st;
        if (n >= STAGES) mbar_sleep(empty0 + 8 * st, (n / STAGES - 1) & 1);
        attn::mbar_expect_tx(fb, 2 * L::TILE);
        for (int c = 0; c < T::NCH; ++c) {
          attn::tma_load(slot + c * T::CHUNK, &tm_q, fb, c * T::BOX, h, q_lo + n * BT, b);
          attn::tma_load(slot + L::TILE + c * T::CHUNK, &tm_do, fb, c * T::BOX, h, q_lo + n * BT, b);
        }
      }
    } else if (tp >= 32) {  // ready each tile: its rows' c2 (from dq), D, gate, m, Z, then Q Dh^-0.5
      const int tr = tp - 32;
      for (int n = 0; n < n_tiles; ++n) {
        // addresses and bounds recomputed each tile (held across the loop
        // they outgrew the producer's 24 registers)
        const uint32_t bs = opaque(base), bar = bs + L::BAR;
        const int st = n % STAGES;
        if (n >= STAGES) mbar_sleep(bar + 8 * (1 + 2 * STAGES + st), (n / STAGES - 1) & 1);
        if (tr < 64) {
          const int t0 = ld_shared_int(bs + L::OFF);  // q_lo
          stage_row(a, (int)opaque(blockIdx.z), (int)opaque(blockIdx.y),
                    min(t0 + n * BT + tr, (int)opaque(a.Tq) - 1), bs + L::ROWS + st * L::ROW_BYTES,
                    tr);
        }
        if constexpr (!POW2) {
          mbar_sleep(bar + 8 * (1 + st), (n / STAGES) & 1);
          scale_words(bs + L::RING + st * 2 * L::TILE, L::TILE, a.scale, tr, READIERS);
          async_fence();
        }
        warp_arrive(bar + 8 * (1 + STAGES + st));
      }
    }
    return;
  }
  // ---- the consumers ----
  regs_inc<CONSUMER_REGS>();
  const int w = uniform((threadIdx.x - 128) / 128);
  attn::mbar_wait(kv_full, 0);

  float dk[DN / 2], dv[DN / 2], s[32], dp[32];
  zero<DN / 2>(dk);
  zero<DN / 2>(dv);
  // SERIAL where dK and dV take over 64 registers a thread (Dh 128 and
  // 256), as in dq
  constexpr bool SERIAL = DN > 64;
  constexpr bool LATE = !SERIAL && STAGES > 2;
  // the A operands of a tile's products, hi and lo bf16 fragments: P~ gate
  // (dV's) and dS (dK's; SERIAL, dV's arrays take both in turn)
  constexpr int FK = SERIAL ? 1 : 4;
  uint32_t vhi[4][4], vlo[4][4], khi[FK][4], klo[FK][4];
  const float icap = inv_cap(a);
  // The thread's place in its warpgroup (warp, lane group g, lane quad
  // qd): its keys are kr and kr + 8, kr = k0 + 16 warp + g. Recomputed
  // where used (held across the walk, such values took registers the
  // accumulators need at Dh 128 and 256).
  auto place = [&](int& qd, int& kr) {
    const int tl = (int)(opaque(threadIdx.x) % 128);
    qd = tl % 4;
    kr = (int)(opaque(blockIdx.x) / NS) * BT + (tl / 32) * 16 + (tl % 32) / 4;
  };
  auto qslot = [&](int n) { return base + L::RING + (n % STAGES) * 2 * L::TILE; };
  // dV += (P~ gate)^T dO and dK += dS^T (Q Dh^-0.5) of tile n: M keys, N =
  // the CTA's DN columns, K queries
  auto issue = [&](int n) {
    if constexpr (SERIAL) {
      to_frags(s, vhi, vlo);
      attn::wg_fence();
      product_rs<DN>(dv, vhi, vlo, qslot(n) + L::TILE + col_off);
      attn::wg_commit();
      attn::wg_wait<0>();
      to_frags(dp, vhi, vlo);
      attn::wg_fence();
      product_rs<DN>(dk, vhi, vlo, qslot(n) + col_off);
      attn::wg_commit();
    } else {
      attn::wg_fence();
      product_rs<DN>(dv, vhi, vlo, qslot(n) + L::TILE + col_off);
      product_rs<DN>(dk, khi, klo, qslot(n) + col_off);
      attn::wg_commit();
    }
  };
  auto retire = [&](int n, int groups) {
    wg_wait_upto(groups);
    warp_arrive(empty0 + 8 * (n % STAGES));
  };
  // S^T = K (Q Dh^-0.5)^T, dP^T = V dO^T of tile n: M keys, N queries, K = Dh
  auto sdp = [&](int n) {
    attn::mbar_wait(ready0 + 8 * (n % STAGES), (n / STAGES) & 1);
    if constexpr (POW2) attn::mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
    const uint32_t kt = opaque(base + L::K);
    zero<32>(s);  // (see clear(); and the last tile's values die here)
    zero<32>(dp);
    attn::wg_fence();
    product_ss<D>(s, kt, qslot(n));
    product_ss<D>(dp, kt + (L::V - L::K), qslot(n) + L::TILE);
    attn::wg_commit();
  };
  // P~ gate into s (dV's factor), dS into dp, in place, then their fragments
  auto scalar = [&](int n) {
    attn::wg_wait<0>();
    attn::reg_fence<32>(s);
    attn::reg_fence<32>(dp);
    const int q0 = q_lo + n * BT, qoff = ld_shared_int(base + L::OFF + 4);
    int qd, kr;
    place(qd, kr);
    const uint8_t* rows = sm + L::ROWS + (n % STAGES) * L::ROW_BYTES;
    const float4* cst_t = reinterpret_cast<const float4*>(rows);  // c2, D, gate, m
    const float* zs_t = reinterpret_cast<const float*>(rows + 64 * 16);  // Z
    if constexpr (POW2) {
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= a.scale;
    }
    cap_scores(s, a.softcap);
    uint32_t near = 0;  // clipped: the entries to re-check, bit x
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * qd + c;
        const float4 cst = cst_t[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + c;
          const int kp = kr + 8 * r, qp = q0 + col;
          const bool valid =
              kp < a.Tk && qp < a.Tq && attn::visible(kp, qp + qoff, a.causal, a.window);
          bool nr;
          const Entry e = entry_fast<CL>(a, valid, s[x], icap, cst.x,
                                         __fmul_rn(cst.z, dp[x]), nr);
          // deferred to the loop below: clipped, an entry near a clip edge;
          // vanilla, one whose p is NaN (only NaN inputs give one; the loop
          // computes it as here). Without a branch in the vanilla loop
          // ptxas scheduled it past the consumers' 240 registers at Dh 128
          // and 256 (spills); with it, as the clipped loop, it fits.
          if (CL != 0 ? nr : e.p != e.p) {
            near |= 1u << x;
            continue;
          }
          s[x] = e.pt * cst.z;
          dp[x] = e.p * (e.dp - cst.y) * e.fac;
        }
      }
    if constexpr (CL == 0) {
      while (near != 0) {  // the NaN entries, s and dp raw
        const int x = __ffs(near) - 1, col = 8 * (x >> 2) + 2 * qd + (x & 1);
        near &= near - 1;
        const float4 cst = cst_t[col];
        const int kp = kr + 8 * ((x >> 1) & 1), qp = q0 + col;
        const bool valid =
            kp < a.Tk && qp < a.Tq && attn::visible(kp, qp + qoff, a.causal, a.window);
        bool nr;
        const Entry e = entry_fast<0>(a, valid, pick(s, x), icap, cst.x,
                                      __fmul_rn(cst.z, pick(dp, x)), nr);
        put(s, x, e.pt * cst.z);
        put(dp, x, e.p * (e.dp - cst.y) * e.fac);
      }
    } else {
      while (near != 0) {  // rare: the entries near a clip edge, s and dp raw
        const int x = __ffs(near) - 1, col = 8 * (x >> 2) + 2 * qd + (x & 1);
        near &= near - 1;
        const float4 cst = cst_t[col];
        const Entry e = entry_exact(a, blockIdx.z, blockIdx.y, blockIdx.y / G, q0 + col,
                                    kr + 8 * ((x >> 1) & 1), icap,
                                    cst.w, zs_t[col], __fmul_rn(cst.z, pick(dp, x)));
        put(s, x, e.pt * cst.z);
        put(dp, x, e.p * (e.dp - cst.y) * e.fac);
      }
    }
    if constexpr (!SERIAL) {
      to_frags(s, vhi, vlo);
      to_frags(dp, khi, klo);
    }
  };
  walk<LATE>(Turns(w, n_tiles, LATE), (n_tiles - w + 1) / 2, issue, retire, sdp, scalar);
  attn::reg_fence<DN / 2>(dv);
  attn::reg_fence<DN / 2>(dk);

  // consumer 1 hands its dk, dv to consumer 0, which adds them and stores:
  // bf16 at the KV head, or with G > 1 an f32 partial of the query head
  // (the thread's and the CTA's indices recomputed here, see place())
  consumers_sync();
  const int tw = (int)(opaque(threadIdx.x) % 128), qd = tw % 4;
  const int cb = (int)opaque(blockIdx.x), ch = (int)opaque(blockIdx.y), cz = (int)blockIdx.z;
  float* xch = reinterpret_cast<float*>(sm + L::RING) + tw * DN;
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      xch[i] = dk[i];
      xch[DN / 2 + i] = dv[i];
    }
  }
  consumers_sync();
  if (w == 1) return;
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    dk[i] += xch[i];
    dv[i] += xch[DN / 2 + i];
    if constexpr (POW2) dk[i] *= a.scale;
  }
  const int e0 = (cb % NS) * DN;  // the CTA's columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = (cb / NS) * BT + (tw / 32) * 16 + (tw % 32) / 4 + 8 * i;
    if (t >= a.Tk) continue;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      if (e0 + 8 * j >= a.dh) break;
      const int x = 4 * j + 2 * i, d = e0 + 8 * j + 2 * qd;
      if (G > 1) {
        const long long row = (((long long)cz * a.Tk + t) * a.Hq + ch) * a.dh;
        *reinterpret_cast<float2*>(a.part_k + row + d) = make_float2(dk[x], dk[x + 1]);
        *reinterpret_cast<float2*>(a.part_v + row + d) = make_float2(dv[x], dv[x + 1]);
      } else {
        const long long row = (((long long)cz * a.Tk + t) * a.Hkv + ch / G) * a.dh;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + row + d) = __floats2bfloat162_rn(dk[x], dk[x + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + row + d) = __floats2bfloat162_rn(dv[x], dv[x + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, long long sv[3], cudaStream_t s) {
  const long long so[3] = {(long long)a.Tq * a.Hq * a.dh, (long long)a.Hq * a.dh, a.dh};
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err = attn::make_bf16_map<D>(&mq, a.q, a.B, a.Tq, a.Hq, a.dh, a.sqb, a.sqt, a.sqh);
  if (err == cudaSuccess)
    err = attn::make_bf16_map<D>(&mdo, a.dout, a.B, a.Tq, a.Hq, a.dh, so[0], so[1], so[2]);
  if (err == cudaSuccess)
    err = attn::make_bf16_map<D>(&mk, a.k, a.B, a.Tk, a.Hkv, a.dh, a.skb, a.skt, a.skh);
  if (err == cudaSuccess)
    err = attn::make_bf16_map<D>(&mv, a.v, a.B, a.Tk, a.Hkv, a.dh, sv[0], sv[1], sv[2]);
  if (err != cudaSuccess) return err;
  constexpr int NS = Split<D>::N;
  err = launch_one(a.clipped ? bwd_dq_kernel<D, true> : bwd_dq_kernel<D, false>,
                   dim3((a.Tq + BT - 1) / BT * NS, a.Hq, a.B), QLayout<D>::BYTES, s, mq, mdo, mk,
                   mv, a, THREADS);
  if (err != cudaSuccess) return err;
  return launch_one(a.clipped ? bwd_dkdv_kernel<D, true> : bwd_dkdv_kernel<D, false>,
                    dim3((a.Tk + BT - 1) / BT * NS, a.Hq, a.B), KvLayout<D>::BYTES, s, mq, mdo,
                    mk, mv, a, THREADS);
}

}  // namespace bf

// ---------------------------------------------------------------------------
// The CUDA-core route (namespace cc): f32 at Dh 80, 96, 128 and 256, where
// the 3xTF32 route's layout does not fit (its hi/lo copies of the fixed
// tiles and the ring take 384 KB of shared memory at Dh 128). Products as
// fmaf chains on CUDA cores, as the f32 forward's; the same two launches
// (dq with D and dgate, then dk/dv), the same GQA head sum, the same D_i
// from the saved u (vanilla, gated) or the A - D B walk (clipped). The
// scores are the forward's own bits (q Dh^-0.5 rounded in f32, then an
// fmaf chain over the head dim in order), so the clipped re-check near an
// edge (entry()) reads the score the forward read. Deterministic as the
// other routes: every output has one owner summing in a fixed order (dq
// its query block over key tiles, dk/dv its key block over query tiles,
// D's clipped sums over a row's 16 threads by xor halving, GQA's partials
// in head order); no atomics.
// What bounds it: operations, 10 flops per visible pair and column at 67
// TFLOP/s f32 (1.60 ms at qwen3-14b's (1, 2048, 40/8, 128) causal; 3xTF32
// at 495 would be 0.65). It issues 14 (16 clipped): S and dP in both
// launches, dq (clipped: A and B), dv, dk. A simple design, right first:
// one CTA of 256 threads a block (its tiles take 177-225 KB of shared
// memory), each thread an R x R block of the scores, no overlap of loads
// and products; a 3xTF32 design at these widths is later work.
// ---------------------------------------------------------------------------
namespace cc {

constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx)

// A head-dim-D body: tiles of BT tokens (dq's block of queries and its key
// tiles; dk/dv's block of keys and its query tiles), each thread an R x R
// block of scores (rows ty R .., columns tx R ..) and, of the products
// over tokens, R rows x NC columns (columns c 16 + tx: consecutive threads
// on consecutive columns). Dh 80 and 96 run the Dh-128 body: columns at or
// past Dh are staged as zeros and not stored. At Dh 256 the tiles are 32
// tokens, so that the five or six D x BT tiles fit in shared memory.
template <int D>
struct Tile {
  static constexpr int BT = D > 128 ? 32 : 64;
  static constexpr int R = BT / 16;
  static constexpr int NC = D / 16;
};

template <int R>
__device__ __forceinline__ void load_r(const float* p, float* x) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

// Rows [t0, t0 + BT) of one head (row t at base + t st) into shared memory
// transposed (tr[d BT + row]) and, if rm is not null, row-major (rm[row D
// + d]); each value times mul (mul != 0: q Dh^-0.5, one f32 rounding, as
// the forward scales it) and, under a gate (g not null), times the row's
// gate g[t sg] (gate dO, one rounding, as the 3xTF32 route's G). Rows
// outside [0, limit) and columns at or past dh are zeros.
template <int D>
__device__ __forceinline__ void stage(const float* base, long long st, int t0, int limit, int dh,
                                      float mul, const float* g, long long sg, float* tr,
                                      float* rm) {
  constexpr int BT = Tile<D>::BT;
  for (int i = threadIdx.x; i < BT * D / 4; i += THREADS) {
    const int row = i % BT, c = (i / BT) * 4, t = t0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < limit && c < dh) {
      x = *reinterpret_cast<const float4*>(base + t * st + c);
      if (mul != 0.f) x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
      if (g != nullptr) {
        const float gt = g[t * sg];
        x = make_float4(gt * x.x, gt * x.y, gt * x.z, gt * x.w);
      }
    }
    tr[(c + 0) * BT + row] = x.x;
    tr[(c + 1) * BT + row] = x.y;
    tr[(c + 2) * BT + row] = x.z;
    tr[(c + 3) * BT + row] = x.w;
    if (rm != nullptr) *reinterpret_cast<float4*>(rm + row * D + c) = x;
  }
}

// s[i][j] = sum_d a[d][ra + i] b[d][rb + j] over d < dh in order (fmaf
// chains), a and b transposed tiles of BT rows
template <int D>
__device__ __forceinline__ void scores(const float* a, const float* b, int ra, int rb, int dh,
                                       float (*s)[Tile<D>::R]) {
  constexpr int BT = Tile<D>::BT, R = Tile<D>::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < dh; ++d) {
    float x[R], y[R];
    load_r<R>(a + d * BT + ra, x);
    load_r<R>(b + d * BT + rb, y);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes(bool clipped) {
  using T = Tile<D>;
  return 4 * ((size_t)5 * D * T::BT + (clipped ? 2 : 1) * T::BT * T::BT + 4 * T::BT);
}

// 1. dq of one (b, h, block of BT queries); D and dgate of its rows first
// (vanilla, gated), or D summed over the walk (clipped), then dq = A - D B.
template <int D, bool CLIPPED>
__global__ void __launch_bounds__(THREADS, 1) bwd_dq_cc(Args a) {
  using T = Tile<D>;
  constexpr int BT = T::BT, R = T::R, NC = T::NC;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][BT] q Dh^-0.5
  float* gtt = qt + D * BT;                     // [D][BT] gate dO
  float* kt = gtt + D * BT;                     // [D][BT] the key tile
  float* vt = kt + D * BT;                      // [D][BT] the value tile
  float* kr = vt + D * BT;                      // [BT][D] the key tile, row-major
  float* dst = kr + BT * D;                     // [BT keys][BT queries]: dS (clipped: p dp f)
  float* pst = dst + BT * BT;                   // clipped: [BT][BT] p f
  float4* rows = reinterpret_cast<float4*>(pst + (CLIPPED ? BT * BT : 0));  // c2, D, m, Z

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const int qoff = qoff_of(a, b);
  const int k_hi = a.causal ? min(a.Tk, qoff + min(q0 + BT, a.Tq)) : a.Tk;
  const int k_lo = a.window >= 0 ? max(0, qoff + q0 - a.window + 1) / BT * BT : 0;
  const int n_tiles = max(0, (k_hi - k_lo + BT - 1) / BT);
  const bool gated = a.gate != nullptr;
  const long long srow = (long long)a.Hq * a.dh;  // a row of dout, u, dq
  const float* dog = a.dout + (long long)b * a.Tq * srow + (long long)h * a.dh;
  const float* gg = gated ? a.gate + b * a.sgb + h * a.sgh : nullptr;
  stage<D>(a.q + b * a.sqb + h * a.sqh, a.sqt, q0, a.Tq, a.dh, a.scale, nullptr, 0, qt, nullptr);
  stage<D>(dog, srow, q0, a.Tq, a.dh, 0.f, gg, a.sgt, gtt, nullptr);
  {  // the block's rows, P threads a row: c2, m, Z and, vanilla or gated,
     // D = gate (dO . u); dgate = dO . u
    constexpr int P = THREADS / BT;
    const int row = tid / P, part = tid % P, t = min(q0 + row, a.Tq - 1);
    const long long si = stat_index(a, b, h, t);
    float dot = 0.f;
    if (gated || !CLIPPED) {
      const int per = a.dh / P;  // the thread's columns, summed in order
      const long long off = (long long)t * srow + part * per;
      for (int c = 0; c < per; c += 2) {
        const float2 o = *reinterpret_cast<const float2*>(dog + off + c);
        const float2 x = *reinterpret_cast<const float2*>(a.u + (dog - a.dout) + off + c);
        dot = fmaf(o.x, x.x, dot);
        dot = fmaf(o.y, x.y, dot);
      }
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (part == 0) {
      const float gt = gated ? gg[(long long)t * a.sgt] : 1.f;
      const float dsum = CLIPPED ? 0.f : (gated ? gt * dot : dot);
      const long long bht = (long long)a.B * a.Hq * a.Tq;
      const float m = a.stats[si], zc = a.stats[bht + si];
      rows[row] = make_float4(row_c2(m, zc), dsum, m, zc);
      if (q0 + row < a.Tq) {
        if (!CLIPPED) a.dsum[si] = dsum;
        if (gated) a.dgate[((long long)b * a.Tq + t) * a.Hq + h] = dot;
      }
    }
  }

  float acc[R][NC], bacc[CLIPPED ? R : 1][CLIPPED ? NC : 1], dpart[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    dpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c] = 0.f;
      if constexpr (CLIPPED) bacc[i][c] = 0.f;
    }
  }
  const float icap = inv_cap(a);
  const float* kg = a.k + b * a.skb + hk * a.skh;
  const float* vg = a.v + b * a.svb + hk * a.svh;
#pragma unroll 1
  for (int n = 0; n < n_tiles; ++n) {
    const int t0 = k_lo + n * BT;
    __syncthreads();  // the previous tile's readers are done (and the rows written)
    stage<D>(kg, a.skt, t0, a.Tk, a.dh, 0.f, nullptr, 0, kt, kr);
    stage<D>(vg, a.svt, t0, a.Tk, a.dh, 0.f, nullptr, 0, vt, nullptr);
    __syncthreads();
    // S = (Q Dh^-0.5) K^T, dP~ = G V^T: rows queries, columns keys
    float s[R][R], dp[R][R];
    scores<D>(qt, kt, ty * R, tx * R, a.dh, s);
    scores<D>(gtt, vt, ty * R, tx * R, a.dh, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
      const float4 rw = rows[ty * R + i];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = t0 + tx * R + j;
        const bool valid =
            qi < a.Tq && kp < a.Tk && attn::visible(kp, qi + qoff, a.causal, a.window);
        const float raw = s[i][j];
        const Entry e = entry(a, valid, attn::softcap(raw, a.softcap), icap, rw.x, rw.z, rw.w,
                              dp[i][j], [&] { return raw; });
        if constexpr (CLIPPED) {  // p dp f, p f; p dp into D's sums
          dpart[i] += e.p * e.dp;
          dst[(tx * R + j) * BT + ty * R + i] = e.p * e.dp * e.fac;
          pst[(tx * R + j) * BT + ty * R + i] = e.p * e.fac;
        } else {
          dst[(tx * R + j) * BT + ty * R + i] = e.p * (e.dp - rw.y) * e.fac;
        }
      }
    }
    __syncthreads();
    // dq += dS K (clipped: A += (p dp f) K, B += (p f) K) over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float x[R], y[R];
      load_r<R>(dst + j * BT + ty * R, x);
      if constexpr (CLIPPED) load_r<R>(pst + j * BT + ty * R, y);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = kr[j * D + c * 16 + tx];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][c] = fmaf(x[i], kv, acc[i][c]);
          if constexpr (CLIPPED) bacc[i][c] = fmaf(y[i], kv, bacc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    float d = 0.f;
    if constexpr (CLIPPED) {
      // D of the row: the 16 threads' sums over their keys (xor halving,
      // the same sum in every lane), then dq = A - D B
      d = dpart[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (tx == 0 && qi < a.Tq) a.dsum[stat_index(a, b, h, qi)] = d;
    }
    if (qi >= a.Tq) continue;
    float* row = a.dq + (long long)b * a.Tq * srow + (long long)qi * srow + (long long)h * a.dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 16 + tx;
      if (col >= a.dh) continue;  // the Dh-128 body at Dh 80 / 96: columns past Dh are zeros
      float x = acc[i][c];
      if constexpr (CLIPPED) x = fmaf(-d, bacc[i][c], x);
      row[col] = x * a.scale;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  using T = Tile<D>;
  return 4 * ((size_t)6 * D * T::BT + 2 * T::BT * T::BT + 4 * T::BT);
}

// 2. dk and dv of one (b, query head, block of BT keys): per query tile S^T
// = K (Q Dh^-0.5)^T and dP~^T = V G^T (rows keys, columns queries), then
// dV += P~^T G and dK += dS^T (Q Dh^-0.5) over the tile's queries. With G >
// 1 each query head writes its own f32 partial, summed in head order after.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) bwd_dkdv_cc(Args a) {
  using T = Tile<D>;
  constexpr int BT = T::BT, R = T::R, NC = T::NC;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][BT] the block's keys
  float* vt = kt + D * BT;                      // [D][BT] its values
  float* qt = vt + D * BT;                      // [D][BT] the query tile, q Dh^-0.5
  float* gtt = qt + D * BT;                     // [D][BT] gate dO
  float* qr = gtt + D * BT;                     // [BT][D] the query tile, row-major
  float* gr = qr + BT * D;                      // [BT][D] gate dO, row-major
  float* ptt = gr + BT * D;                     // [BT queries][BT keys]: P~
  float* dst = ptt + BT * BT;                   // [BT queries][BT keys]: dS
  float4* rows = reinterpret_cast<float4*>(dst + BT * BT);  // c2, D, m, Z

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z, G = a.Hq / a.Hkv, hk = h / G;
  const int qoff = qoff_of(a, b);
  // the queries that can see the block's keys; none: dk = dv = 0 written
  const int q_lo = a.causal ? max(0, k0 - qoff) : 0;
  const int q_hi = a.window >= 0 ? min(a.Tq, k0 + BT + a.window - 1 - qoff) : a.Tq;
  const int n_tiles = q_lo < q_hi ? (q_hi - q_lo + BT - 1) / BT : 0;
  const bool gated = a.gate != nullptr;
  const long long srow = (long long)a.Hq * a.dh;
  const float* dog = a.dout + (long long)b * a.Tq * srow + (long long)h * a.dh;
  const float* gg = gated ? a.gate + b * a.sgb + h * a.sgh : nullptr;
  const float* qg = a.q + b * a.sqb + h * a.sqh;
  stage<D>(a.k + b * a.skb + hk * a.skh, a.skt, k0, a.Tk, a.dh, 0.f, nullptr, 0, kt, nullptr);
  stage<D>(a.v + b * a.svb + hk * a.svh, a.svt, k0, a.Tk, a.dh, 0.f, nullptr, 0, vt, nullptr);

  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float icap = inv_cap(a);
  const long long bht = (long long)a.B * a.Hq * a.Tq;
#pragma unroll 1
  for (int n = 0; n < n_tiles; ++n) {
    const int q0 = q_lo + n * BT;
    __syncthreads();  // the previous tile's readers are done
    stage<D>(qg, a.sqt, q0, a.Tq, a.dh, a.scale, nullptr, 0, qt, qr);
    stage<D>(dog, srow, q0, a.Tq, a.dh, 0.f, gg, a.sgt, gtt, gr);
    if (tid < BT) {
      const long long si = stat_index(a, b, h, min(q0 + tid, a.Tq - 1));
      const float m = a.stats[si], zc = a.stats[bht + si];
      rows[tid] = make_float4(row_c2(m, zc), a.dsum[si], m, zc);
    }
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<D>(kt, qt, ty * R, tx * R, a.dh, s);
    scores<D>(vt, gtt, ty * R, tx * R, a.dh, dp);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int qi = q0 + tx * R + j;
      const float4 rw = rows[tx * R + j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty * R + i;
        const bool valid =
            qi < a.Tq && kp < a.Tk && attn::visible(kp, qi + qoff, a.causal, a.window);
        const float raw = s[i][j];
        const Entry e = entry(a, valid, attn::softcap(raw, a.softcap), icap, rw.x, rw.z, rw.w,
                              dp[i][j], [&] { return raw; });
        ptt[(tx * R + j) * BT + ty * R + i] = e.pt;
        dst[(tx * R + j) * BT + ty * R + i] = e.p * (e.dp - rw.y) * e.fac;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float x[R], y[R];
      load_r<R>(ptt + j * BT + ty * R, x);
      load_r<R>(dst + j * BT + ty * R, y);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float gv = gr[j * D + c * 16 + tx], qv = qr[j * D + c * 16 + tx];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][c] = fmaf(x[i], gv, dv[i][c]);
          dk[i][c] = fmaf(y[i], qv, dk[i][c]);
        }
      }
    }
  }
  const int hs = G > 1 ? h : hk, hn = G > 1 ? a.Hq : a.Hkv;  // partials per query head
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = k0 + ty * R + i;
    if (t >= a.Tk) continue;
    const long long row = (((long long)b * a.Tk + t) * hn + hs) * a.dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 16 + tx;
      if (col >= a.dh) continue;
      a.dk[row + col] = dk[i][c];
      a.dv[row + col] = dv[i][c];
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, float* part_k, float* part_v, cudaStream_t s) {
  using T = Tile<D>;
  const size_t dq_smem = dq_smem_bytes<D>(a.clipped != 0);
  auto dq = a.clipped ? bwd_dq_cc<D, true> : bwd_dq_cc<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq<<<dim3((a.Tq + T::BT - 1) / T::BT, a.Hq, a.B), THREADS, dq_smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  Args kv = a;
  if (G > 1) kv.dk = part_k, kv.dv = part_v;
  const size_t kv_smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv_cc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_cc<D><<<dim3((a.Tk + T::BT - 1) / T::BT, a.Hq, a.B), THREADS, kv_smem, s>>>(kv);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return err;
  return sum_heads(part_k, part_v, reinterpret_cast<float4*>(a.dk),
                   reinterpret_cast<float4*>(a.dv), (long long)a.B * a.Tk * a.Hkv * a.dh / 4, G,
                   a.dh / 4, s);
}

}  // namespace cc

}  // namespace

// route 0: the f32 3xTF32 route (Dh 32 or 64; Dh 8 and 16 through the
// Dh-32 body); route 1: the bf16 route (Dh 32, 64, 128 or 256; Dh 8 and 16
// through the Dh-32 body, 80 and 96 through the Dh-128 one); route 2: the
// f32 CUDA-core route (Dh 128 or 256; Dh 80 and 96 through the Dh-128
// body); a route not built for (dtype, Dh) is refused. dtype: 0 = f32, 1 =
// bf16 (q, k, v, dout, dq, dk, dv). q, k, v, gate: element strides
// (16-byte aligned rows and strides); u, dout, dq, dk, dv, dgate
// contiguous; u, gate and dgate f32; stats: the forward's 2 x (B, Hq, Tq)
// (m, max(Z, 1e-30)), written with the same query offset; dsum: B * Hq * Tq
// floats of scratch (D), on the bf16 route three times that (D, each row's
// c2 and gate, which dq writes for dk/dv's producer); g: B * Tq * Hq * Dh
// floats of scratch on the 3xTF32 route under a gate, else null; part_k,
// part_v: B * Tk * Hq * Dh floats each of scratch when Hq > Hkv, else null.
// window < 0: none; softcap <= 0: none; query i of batch row b sits at
// position i + q_offs[b] (q_offs not null) or i + q_offset. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const float* gate, const float* u,
    const void* dout, const float* stats, float* dsum, float* g, void* dq, void* dk, void* dv,
    float* dgate, float* part_k, float* part_v, int B, int Tq, int Tk, int Hq, int Hkv, int Dh,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sgb, long long sgt, long long sgh,
    int causal, int clipped, float zg, float gamma, float scale, int window, float softcap,
    int q_offset, const int* q_offs, int route, int dtype, void* stream) {
  const bool f32 = dtype == 0;
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1) || (route == 1) == f32 ||
      (gate == nullptr) != (dgate == nullptr) ||
      (route == 0 && (gate == nullptr) != (g == nullptr)) || (route != 0 && g != nullptr) ||
      (Hq > Hkv && (part_k == nullptr || part_v == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  long long sq[3] = {sqb, sqt, sqh}, sk[3] = {skb, skt, skh}, sv[3] = {svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           gate, u, static_cast<const float*>(dout), stats, dsum, g, static_cast<float*>(dq),
           static_cast<float*>(dk), static_cast<float*>(dv), dgate, B, Tq, Tk, Hq, Hkv,
           sqb, sqt, sqh, skb, skt, skh, sgb, sgt, sgh, causal, clipped, zg, gamma, scale,
           window, softcap, Dh, q_offset, q_offs, svb, svt, svh};
    if (route == 0) {
      if (Dh == 8 || Dh == 16 || Dh == 32) return (int)launch<32>(a, sq, sk, sv, part_k, part_v, s);
      if (Dh == 64) return (int)launch<64>(a, sq, sk, sv, part_k, part_v, s);
    } else if (route == 2) {
      if (Dh == 80 || Dh == 96 || Dh == 128) return (int)cc::launch<128>(a, part_k, part_v, s);
      if (Dh == 256) return (int)cc::launch<256>(a, part_k, part_v, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  bf::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), gate, u,
             static_cast<const __nv_bfloat16*>(dout), stats, dsum,
             static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
             static_cast<__nv_bfloat16*>(dv), dgate, part_k, part_v, B, Tq, Tk, Hq, Hkv, Dh,
             sqb, sqt, sqh, skb, skt, skh, sgb, sgt, sgh, causal, clipped, zg, gamma, scale,
             window, softcap, q_offset, q_offs};
  cudaError_t err = cudaErrorInvalidValue;
  if (Dh == 8 || Dh == 16 || Dh == 32) err = bf::launch<32>(a, sv, s);
  else if (Dh == 64) err = bf::launch<64>(a, sv, s);
  else if (Dh == 80 || Dh == 96 || Dh == 128) err = bf::launch<128>(a, sv, s);
  else if (Dh == 256) err = bf::launch<256>(a, sv, s);
  if (err != cudaSuccess || Hq == Hkv) return (int)err;
  return (int)sum_heads(part_k, part_v, static_cast<uint2*>(dk), static_cast<uint2*>(dv),
                        (long long)B * Tk * Hkv * Dh / 4, Hq / Hkv, Dh / 4, s);
}
