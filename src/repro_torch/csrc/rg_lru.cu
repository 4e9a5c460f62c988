// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rg_lru.py : rglru_pallas
// (body _kernel; oracle src/repro/kernels/ref.py : rglru_ref): the
// diagonal linear recurrence of Griffin's RG-LRU,
//
//   h_t = a_t * h_{t-1} + b_t        over (B, T, D), h_{-1} = h0 (or 0),
//
// writing every h_t (B, T, D) and the last state h_last (B, D), all f32.
// Each step is one IEEE product then one IEEE sum (__fmul_rn, __fadd_rn:
// the compiler may not contract them into an FMA), in time order, one
// lane per (row, channel): the order the plain version
// `a[:, t] * h + b[:, t]` rounds in, so both routes below are bitwise the
// plain version at every shape.
//
// What bounds it on an H100: bytes. Each element of a and b is read once
// and each h_t written once (12 bytes per element against 2 flops). The
// serial chain is cheap (a product and a dependent sum, ~8 cycles a step)
// against one step's bytes at D 4096 (12 * 4096 B / 3.35 TB/s ~ 15 ns),
// so the plain per-channel order can run at the byte bound if enough
// bytes are in flight ahead of the chain: ~3.4 MB on the card (3.35 TB/s
// times ~1 us of latency). A thread that loads for itself keeps only its
// own few loads in flight, and at B 1 there are only D threads.
//
// Route 1 (TMA ring; D % 4 == 0 and a, b, h 16-byte aligned, which the
// tensor maps' row stride and base need). A CTA owns one (row, strip of
// 32 W channels), W consumer warps, lane = channel. One producer thread
// streams tiles of TT = 64 / W steps x 32 W channels of a and b into a
// ring of STAGES slots in shared memory with cp.async.bulk.tensor over
// 3-d tensor maps (D, T, B): a box never crosses rows, and TMA zero-fills
// past T and past D. Each slot has a full mbarrier (the copies' bytes)
// and an empty one (every consumer warp has read it). A slot is 16 KB
// whatever W. Each consumer warp loads its part of a slot into registers
// (128-byte rows, no bank conflicts), releases the slot, walks the chain,
// which stops at T (a zero-filled a = 0 past T would wipe the state),
// writes h into its own shared-memory tile (two, alternating) and sends
// the tile back with a TMA store. Wide strips (W 4, 8) serve large B,
// where the grid already fills the card; narrow ones (W 1) give a single
// long row D / 32 CTAs. `kernels/rg_lru.py:plan` chooses W.
//
// Route 0 (direct loads; any D, any alignment): one thread per (row,
// channel), neighbouring threads on neighbouring channels, so a warp's
// loads and stores are coalesced 128-byte lines. The walk goes U steps
// at a time, and the loads of the next U steps are issued before the
// current U steps' chain, so they are in flight while it runs.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Route 0: direct loads
// ---------------------------------------------------------------------------
constexpr int NT = 128;  // threads per block, all along D
constexpr int U = 16;    // time steps whose loads start together

// the loads of steps t0 .. t0 + U - 1 (those before T) of one channel
__device__ __forceinline__ void load_group(float (&av)[U], float (&bv)[U], const float* a,
                                           const float* b, long long base, int t0, int T,
                                           int D) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (t0 + k < T) {
      const long long off = base + (long long)(t0 + k) * D;
      av[k] = __ldg(a + off);
      bv[k] = __ldg(b + off);
    }
  }
}

__global__ void __launch_bounds__(NT) rglru_direct_kernel(const float* __restrict__ a,
                                                          const float* __restrict__ b,
                                                          const float* __restrict__ h0,
                                                          float* __restrict__ h,
                                                          float* __restrict__ h_last, int T,
                                                          int D, int strips) {
  const long long row = blockIdx.x / strips;
  const int d = (blockIdx.x % strips) * NT + threadIdx.x;
  if (d >= D) return;
  const long long base = row * (long long)T * D + d;
  float hv = h0 != nullptr ? h0[row * D + d] : 0.f;
  float an[U] = {}, bn[U] = {};
  load_group(an, bn, a, b, base, 0, T, D);
  for (int t0 = 0; t0 < T; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      ac[k] = an[k];
      bc[k] = bn[k];
    }
    // the next group's loads, in flight during this group's chain
    if (t0 + U < T) load_group(an, bn, a, b, base, t0 + U, T, D);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (t0 + k < T) {
        hv = __fadd_rn(__fmul_rn(ac[k], hv), bc[k]);
        h[base + (long long)(t0 + k) * D] = hv;
      }
    }
  }
  h_last[row * D + d] = hv;
}

// ---------------------------------------------------------------------------
// Route 1: TMA ring
// ---------------------------------------------------------------------------
template <int W>
struct Tma {
  static constexpr int CH = 32 * W;            // channels of a CTA
  static constexpr int TT = 64 / W;            // time steps of a tile
  static constexpr int TILE = TT * CH * 4;     // bytes of one tensor's tile (8 KB)
  static constexpr int STAGE = 2 * TILE;       // a's tile, then b's
  static constexpr int OUT = TT * 32 * 4;      // one warp's h tile
  static constexpr int THREADS = CH + 32;      // consumer warps + the producer warp
};

// Ring slots of a route-1 CTA. At D 4096 every B gives at least 128 CTAs,
// which keep ~6 MB in flight with 3 slots. On an H100 80GB HBM3 at 700 W,
// (1, 4096, 4096) with 2 / 3 / 4 / 8 slots took 0.0770 / 0.0721 / 0.0788 /
// 0.0824 ms (more bytes in flight than the memory needs only slows it),
// and at (8, 256, 4096) 2 to 8 slots were within 1 % of each other.
constexpr int STAGES = 3;
// dynamic shared memory of a route-1 CTA, whatever W: the ring, two h
// tiles per consumer warp, the full and empty barriers, and slack to
// align to 128 (`kernels/rg_lru.py:TMA_SMEM_BYTES`)
constexpr int TMA_SMEM = STAGES * Tma<1>::STAGE + 2 * 64 * 32 * 4 + 2 * STAGES * 8 + 128;
static_assert(TMA_SMEM <= 227 * 1024, "route 1's shared memory exceeds a CTA's");

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
// one box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// one box from shared memory into a 3-d tensor map (elements outside the
// tensor are not written), in this thread's current bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's bulk groups but the newest have read their shared memory
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
// every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One warp's walk over a ring slot: its TT steps of a and b (lane =
// channel, rows CH floats apart) into registers first, then the slot is
// released (lane 0 arrives on its empty barrier) and the chain runs,
// writing h into the warp's tile (rows 32 floats apart). Loading the
// whole slot before the first product keeps the shared-memory latency
// out of the chain: h's stores could alias the slot for all the compiler
// knows, so loads interleaved with them would wait a round trip each
// step. GUARD: the last tile, whose chain stops after n < TT steps.
template <int TT, int CH, bool GUARD>
__device__ __forceinline__ float walk(const float* as, const float* bs, float* ob, float hv,
                                      int n, uint32_t empty, int lane) {
  float av[TT], bv[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    if (!GUARD || i < n) {
      av[i] = as[i * CH];
      bv[i] = bs[i * CH];
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);  // (release: the loads above come first)
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    if (!GUARD || i < n) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      ob[i * 32] = hv;
    }
  }
  return hv;
}

template <int W>
__global__ void __launch_bounds__(Tma<W>::THREADS)
    rglru_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ h0,
                     float* __restrict__ h_last, int T, int D, int strips) {
  using P = Tma<W>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base;                              // STAGES x (a tile, b tile)
  const uint32_t outs = ring + STAGES * P::STAGE;          // 2 x W warp tiles of h
  const uint32_t full0 = outs + 2 * W * P::OUT;            // full[STAGES]
  const uint32_t empty0 = full0 + 8 * STAGES;              // empty[STAGES]

  const int row = blockIdx.x / strips;
  const int d0 = (blockIdx.x % strips) * P::CH;
  const int n_tiles = (T + P::TT - 1) / P::TT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, W);  // lane 0 of every consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == W) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < n_tiles; ++k) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t dst = ring + stage * P::STAGE;
        const uint32_t fb = full0 + 8 * stage;
        mbar_expect_tx(fb, P::STAGE);
        tma_load(dst, &tm_a, fb, d0, k * P::TT, row);
        tma_load(dst + P::TILE, &tm_b, fb, d0, k * P::TT, row);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp w owns channels d0 + 32 w .. + 31, lane = channel
  const int dw = d0 + warp * 32;
  const int d = dw + lane;
  const bool store = dw < D;  // a warp wholly past D stores nothing
  float hv = (h0 != nullptr && d < D) ? h0[(long long)row * D + d] : 0.f;
  const float* ring_f = reinterpret_cast<const float*>(gbase);
  float* out_f = reinterpret_cast<float*>(gbase + STAGES * P::STAGE);
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * P::TT;
    float* tile = out_f + ((k & 1) * W + warp) * (P::TT * 32);  // this warp's h tile
    float* ob = tile + lane;
    if (k >= 2) {
      // the store of tile k - 2 has read the h tile this one reuses
      if (lane == 0) bulk_wait_read1();
      __syncwarp();
    }
    mbar_wait(full0 + 8 * stage, phase);
    const float* as = ring_f + stage * (P::STAGE / 4) + warp * 32 + lane;
    const float* bs = as + P::TILE / 4;
    const uint32_t empty = empty0 + 8 * stage;
    if (t0 + P::TT <= T) {
      hv = walk<P::TT, P::CH, false>(as, bs, ob, hv, P::TT, empty, lane);
    } else {
      hv = walk<P::TT, P::CH, true>(as, bs, ob, hv, T - t0, empty, lane);  // stops at T
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // h visible to TMA
    __syncwarp();
    if (lane == 0 && store) {
      tma_store(&tm_h, static_cast<uint32_t>(__cvta_generic_to_shared(tile)), dw, t0, row);
      bulk_commit();
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (d < D) h_last[(long long)row * D + d] = hv;
  if (lane == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
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

// Tensor map of a contiguous f32 (B, T, D) tensor as dims (D, T, B):
// boxes of box_d channels x box_t steps of one row, no swizzle, zeros
// outside the tensor.
cudaError_t make_map(CUtensorMap* map, const float* ptr, int B, int T, int D, int box_d,
                     int box_t) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)T * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_d, (cuuint32_t)box_t, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int W>
cudaError_t launch_tma(const float* a, const float* b, const float* h0, float* h,
                       float* h_last, int B, int T, int D, cudaStream_t stream) {
  using P = Tma<W>;
  const int strips = (D + P::CH - 1) / P::CH;
  if ((long long)strips * B > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mh;
  cudaError_t err = make_map(&ma, a, B, T, D, P::CH, P::TT);
  if (err == cudaSuccess) err = make_map(&mb, b, B, T, D, P::CH, P::TT);
  if (err == cudaSuccess) err = make_map(&mh, h, B, T, D, 32, P::TT);
  if (err != cudaSuccess) return err;
  auto kern = rglru_tma_kernel<W>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM);
  if (err != cudaSuccess) return err;
  kern<<<strips * B, P::THREADS, TMA_SMEM, stream>>>(ma, mb, mh, h0, h_last, T, D, strips);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// a, b, h: (B, T, D) f32 contiguous; h0 (B, D) f32 or null (zero state);
// h_last (B, D) f32. route 1: the TMA ring with `warps` consumer warps
// (1, 2, 4 or 8), refused unless D % 4 == 0 and a, b, h are 16-byte
// aligned; route 0: direct loads (warps unused). Returns the cudaError_t
// of the launch (0 = success).
extern "C" int rglru_launch(const float* a, const float* b, const float* h0, float* h,
                            float* h_last, int B, int T, int D, int route, int warps,
                            void* stream) {
  if (B < 1 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const int strips = (D + NT - 1) / NT;
    if ((long long)strips * B > INT_MAX) return (int)cudaErrorInvalidValue;
    rglru_direct_kernel<<<strips * B, NT, 0, s>>>(a, b, h0, h, h_last, T, D, strips);
    return (int)cudaGetLastError();
  }
  if (route != 1 || D % 4 != 0 || !aligned16(a) || !aligned16(b) || !aligned16(h)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (warps) {
    case 1: return (int)launch_tma<1>(a, b, h0, h, h_last, B, T, D, s);
    case 2: return (int)launch_tma<2>(a, b, h0, h, h_last, B, T, D, s);
    case 4: return (int)launch_tma<4>(a, b, h0, h, h_last, B, T, D, s);
    case 8: return (int)launch_tma<8>(a, b, h0, h, h_last, B, T, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
