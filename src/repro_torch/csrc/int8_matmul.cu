// W8A8 matmul for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/int8_matmul.py : int8_matmul (body _kernel)
// out (M, N) f32 = float(codes(x) @ w_q) * (s_x * s_w), where
//   codes(x) = clip(clip(rint(x / s_x) + z_x, 0, 255) - z_x, -127, 127)
// is the per-tensor asymmetric uint8 activation quantization, centred and
// saturated to int8, with a static (s_x, z_x) passed by value or a
// dynamic one read from device pointers (computed on the device by the
// wrapper, with no host sync). w_q is the per-tensor symmetric int8
// weight of shape (K, N), stored K-major: an (N, K) row-major array (the
// wrapper's w_q.t()), which is the layout both tensor-core instructions
// below read without a transpose (wgmma takes 8-bit operands K-major
// only). s_w is read through a device pointer. x is f32 or bf16,
// row-major (M, K).
//
// Bitwise contract with the plain version (kernels/int8_matmul.py:
// int8_matmul_ref): x / s_x is a true f32 division (__fdiv_rn), rounding
// is half to even (rintf), the integer product is exact in int32
// (|acc| <= 127^2 * K < 2^31), and the epilogue is
// float(acc) * (s_x * s_w) with the scale product rounded to f32 first.
// Build without --use_fast_math.
//
// Two kernels make one call, as the TPU kernel's wrapper quantizes x
// once before its pallas_call:
//   1. int8_quant_kernel, the pre-pass: reads x once (16-byte loads, a
//      grid-stride loop) and writes the codes (Mp, K) int8 into scratch
//      (rows M..Mp-1 zero). Every product below reads codes, never x.
//   2. the product, on one of two routes the wrapper chooses
//      (kernels/int8_matmul.py : plan; this file refuses only a route
//      not built for its inputs):
//      * route 0, M <= 16 (decode): int8_gemv_kernel. Bound by bytes:
//        it reads K * N weight bytes for 2 * M * K * N operations, far
//        below the ~600 int8 operations per byte at which the card turns
//        compute bound, so the floor is the weight bytes over 3.35 TB/s.
//        The design keeps many weight bytes in flight on every SM: each
//        warp streams a 16-row strip of W^T with 16-byte loads that skip
//        L1, UNROLL 64-byte steps at once, straight into the registers of
//        mma.sync.m16n8k32 (W^T rows are the A operand, the 8 or 16 code
//        rows the B operand). The dot product is the same under any order
//        of k as long as A and B agree, so each thread's 16 contiguous
//        bytes serve as its fragments of two k32 steps, for W and codes
//        alike: no shared memory, no transpose. The 8 warps of a CTA cut
//        one strip's K range; their partial sums meet in shared memory.
//        At these widths a call costs several microseconds beyond its
//        bytes (about 8.5 us at N 16), so the product is launched as a
//        programmatic dependent of the pre-pass: its CTAs start while the
//        pre-pass finishes and wait for the codes (about 1 us saved a
//        call). Split-K across CTAs measured slower here (its extra
//        launch costs more than the fuller card gains).
//      * route 1, M > 16 (the padded mixed tick, M 2048): int8_gemm_tc.
//        Bound by operations: 2 * M * K * N at the 1979 TOP/s int8
//        tensor-core rate. A persistent CTA per SM walks output tiles of
//        128 x BN (BN 256, or 128 where 256-wide tiles would leave the
//        card's last wave mostly empty); one producer thread keeps a ring
//        of STAGES shared-memory slots full with TMA (a 128 x 128-byte
//        code tile and a BN x 128-byte weight tile per slot, the 128-byte
//        swizzle, completion on mbarriers), and two consumer warpgroups
//        (64 rows each) run wgmma.mma_async m64nBNk32 .s32.s8.s8 on both
//        operands in shared memory, one commit group per slot, one group
//        kept in flight. setmaxnreg gives the consumers the producer's
//        registers (BN/2 int32 accumulators each). TMA fills past the
//        edges of M, N and K with zeros, code 0, which adds nothing to a
//        sum, so ragged shapes need no operand masking. The epilogue
//        stores from registers while the producer already loads the next
//        tile. Each tile walks all of K (split-K measured no faster where
//        the tiles leave SMs idle: 0.0235 against 0.0237 ms at (17,
//        5120, 5120), and slower at M 2048). Launched after the pre-pass
//        in plain stream order: as a programmatic dependent it measured
//        13 % slower at (2048, 5120, 17408).
// Neither route splits K across CTAs, so each output is written once by
// the CTA that summed it, and no call needs a workspace. The wrapper
// counts the call as one launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the reference's activation code, operation for operation in f32
__device__ __forceinline__ uint32_t quant(float v, float s, float z) {
  float q = rintf(__fdiv_rn(v, s)) + z;
  q = fminf(fmaxf(q, 0.f), 255.f) - z;
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

struct Range {
  const float* sx_ptr;  // dynamic range: device scalars, else null
  const float* zx_ptr;
  float sx, zx;         // static range
  __device__ __forceinline__ float s() const { return sx_ptr != nullptr ? *sx_ptr : sx; }
  __device__ __forceinline__ float z() const { return zx_ptr != nullptr ? *zx_ptr : zx; }
};

// ---------------------------------------------------------------------------
// 1. the pre-pass: codes of x, once
// ---------------------------------------------------------------------------
template <typename TX>
__global__ void __launch_bounds__(256) int8_quant_kernel(const TX* __restrict__ x, Range r,
                                                         int8_t* __restrict__ codes, int M,
                                                         int Mp, int K) {
  constexpr int NV = sizeof(TX);  // 16-byte vectors per 16 elements
  // route 0's product (a programmatic dependent) may start now; it waits
  // for this grid's writes before it reads the codes
  asm volatile("griddepcontrol.launch_dependents;");
  const float s = r.s(), z = r.z();
  const long long units = (long long)Mp * K / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long u = first; u < units; u += stride) {
    const long long e0 = u * 16;  // K % 16 == 0: a unit lies in one row
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (e0 / K < M) {
      uint4 raw[NV];
      const uint4* src = reinterpret_cast<const uint4*>(x + e0);
#pragma unroll
      for (int v = 0; v < NV; ++v) raw[v] = __ldcs(src + v);
      TX vals[16];
      memcpy(vals, raw, sizeof(vals));
#pragma unroll
      for (int e = 0; e < 16; ++e) packed[e / 4] |= quant(to_f(vals[e]), s, z) << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(codes + e0) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ---------------------------------------------------------------------------
// 2a. route 0 (M <= 16): weight strips streamed into mma.sync registers
// ---------------------------------------------------------------------------
namespace gemv {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS = 16;   // weight rows (output columns) per CTA: mma's M
constexpr int STEP = 64;   // K bytes per warp step: 16 per thread of a quad
constexpr int UNROLL = 4;  // steps whose loads are issued together

struct Args {
  const int8_t* codes;  // (8 * MT, K), rows >= M zero
  const int8_t* w;      // (N, K): w_q K-major
  const float* w_scale;
  Range r;
  float* out;
  int M, N, K;
};

// 16 weight bytes, read once: not kept in L1, the 256-byte L2 line fetched
__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Does the thread's 16 bytes of K step s lie in its range? (K % 16 == 0:
// they are wholly inside K or outside.)
__device__ __forceinline__ bool in_step(int s, int s_end, int t, int K) {
  return s < s_end && s * STEP + 16 * t < K;
}

// weight steps s .. s + UNROLL - 1 of W^T rows w0 and w1 into registers
__device__ __forceinline__ void load_w(uint4 (&wa)[UNROLL], uint4 (&wb)[UNROLL],
                                       const int8_t* w0, const int8_t* w1, bool row0, bool row1,
                                       int s, int s_end, int t, int K) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool ok = in_step(s + u, s_end, t, K);
    wa[u] = ok && row0 ? ld_stream(w0 + (s + u) * STEP) : zero;
    wb[u] = ok && row1 ? ld_stream(w1 + (s + u) * STEP) : zero;
  }
}

// MT: n8 tiles of code rows, 1 (M <= 8) or 2 (M <= 16)
template <int MT>
__global__ void __launch_bounds__(THREADS) int8_gemv_kernel(Args a) {
  __shared__ int red[WARPS][MT * 8][ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * ROWS;
  // this warp's share of the strip's K steps
  const int steps = (a.K + STEP - 1) / STEP;
  const int s_begin = steps * warp / WARPS, s_end = steps * (warp + 1) / WARPS;
  const bool row0 = n0 + g < a.N, row1 = n0 + g + 8 < a.N;
  const int8_t* w0 = a.w + (size_t)(n0 + g) * a.K + 16 * t;
  const int8_t* w1 = w0 + (size_t)8 * a.K;
  const int8_t* c0 = a.codes + (size_t)g * a.K + 16 * t;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  int acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;

  uint4 wa[UNROLL], wb[UNROLL];
  // launched as a programmatic dependent of the pre-pass: its codes are
  // complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = s_begin; s < s_end; s += UNROLL) {
    load_w(wa, wb, w0, w1, row0, row1, s, s_end, t, a.K);
    uint4 xc[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        xc[u][j] = in_step(s + u, s_end, t, a.K)
                       ? __ldg(reinterpret_cast<const uint4*>(c0 + (size_t)8 * j * a.K +
                                                              (s + u) * STEP))
                       : zero;
    // A rows g / g + 8 are W^T rows n0 + g / n0 + g + 8, B column g is
    // code row g (+ 8 j); the thread's bytes 0-7 are its k32 step's
    // fragments {a0 a2 | b0 b1} of one product, bytes 8-15 of the next
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        mma_s8(acc[j], wa[u].x, wb[u].x, wa[u].y, wb[u].y, xc[u][j].x, xc[u][j].y);
        mma_s8(acc[j], wa[u].z, wb[u].z, wa[u].w, wb[u].w, xc[u][j].z, xc[u][j].w);
      }
  }
  // acc[j]: (W^T row g, code row 8j + 2t), (g, 8j + 2t + 1), (g + 8, ...)
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][8 * j + 2 * t + (c & 1)][g + 8 * (c >> 1)] = acc[j][c];
  __syncthreads();
  const float scale = __fmul_rn(a.r.s(), *a.w_scale);
  for (int i = threadIdx.x; i < MT * 8 * ROWS; i += THREADS) {
    const int m = i / ROWS, n = n0 + i % ROWS;
    if (m >= a.M || n >= a.N) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][m][i % ROWS];
    a.out[(size_t)m * a.N + n] = __int2float_rn(sum) * scale;
  }
}

}  // namespace gemv

// ---------------------------------------------------------------------------
// 2b. route 1 (M > 16): TMA ring and wgmma s8, persistent over tiles
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128, BK = 128, THREADS = 384;

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BM * BK;  // codes, 128 rows x 128 bytes
  static constexpr int B_BYTES = BN * BK;  // W^T, BN rows x 128 bytes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  // barriers full[STAGES], empty[STAGES]; slack to align to 1024
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
};

struct Args {
  float* out;
  const float* w_scale;
  Range r;
  int M, N, K;
  int tiles_m, tiles_n;
};

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
// one box of a 2-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in shared memory with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte
// units; 1024 bytes between 8-row groups), layout 1
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
__device__ __forceinline__ void reg_fence(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db);

// d (64 x 128 int32 fragment) += A (smem, K-major) * B (smem, K-major), k 32
template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256 int32 fragment) += A (smem, K-major) * B (smem, K-major), k 32
template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_tc(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, Args a) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1024 bytes
  const uint32_t full0 = base + C::BAR_OFF, empty0 = full0 + 8 * C::STAGES;
  const int k_steps = (a.K + BK - 1) / BK;
  // tile u: M tile fastest, so the CTAs at work together share weight
  // tiles in L2
  const int tiles = a.tiles_m * a.tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full, across tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const int tm = u % a.tiles_m, tn = u / a.tiles_m;
        for (int s = 0; s < k_steps; ++s) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t st = base + stage * C::STAGE_BYTES, fb = full0 + 8 * stage;
          mbar_expect_tx(fb, C::STAGE_BYTES);
          tma_load(st, &tm_a, fb, s * BK, tm * BM);
          tma_load(st + C::A_BYTES, &tm_b, fb, s * BK, tn * BN);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, t = lane % 4;
    const float scale = __fmul_rn(a.r.s(), *a.w_scale);
    int stage = 0;
    uint32_t phase = 0;
    int acc[BN / 2];
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int tm = u % a.tiles_m, tn = u / a.tiles_m;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int held = 0;  // the slot whose products are still in flight
      for (int s = 0; s < k_steps; ++s) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t st = base + stage * C::STAGE_BYTES;
        const uint32_t as = st + wg * 64 * BK, bs = st + C::A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, desc(as + kk * 32), desc(bs + kk * 32));
        wg_commit();
        // the previous slot's products are done: release it
        wg_wait<1>();
        if (s > 0) mbar_arrive(empty0 + 8 * held);
        held = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      reg_fence<BN / 2>(acc);
      mbar_arrive(empty0 + 8 * held);

      // acc[4j + 2h + c]: row 16 warp + g + 8h, column 8j + 2t + c
      const int row0 = tm * BM + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = tn * BN + 8 * j + 2 * t;  // even; N % 16 == 0
        if (col >= a.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= a.M) continue;
          __stcs(reinterpret_cast<float2*>(a.out + (size_t)row * a.N + col),
                 make_float2(__int2float_rn(acc[4 * j + 2 * h]) * scale,
                             __int2float_rn(acc[4 * j + 2 * h + 1]) * scale));
        }
      }
    }
  }
}

}  // namespace tc

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

// Tensor map of a row-major (rows, K) int8 array: boxes of 128 bytes of K
// x box_rows rows, the 128-byte swizzle, zeros outside the array.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)tc::BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch route 0's product as a programmatic dependent of the pre-pass:
// its CTAs may start while the pre-pass finishes, and wait
// (griddepcontrol.wait) before they read what the pre-pass writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), dim3 grid, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <int BN>
cudaError_t launch_tc(const void* codes, const void* w, const tc::Args& a, int ctas,
                      cudaStream_t stream) {
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, codes, a.M, a.K, tc::BM);
  if (err == cudaSuccess) err = make_map(&mb, w, a.N, a.K, BN);
  if (err != cudaSuccess) return err;
  auto kern = tc::int8_gemm_tc<BN>;
  const int smem = tc::Cfg<BN>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<ctas, tc::THREADS, smem, stream>>>(ma, mb, a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_quant(const void* x, const Range& r, void* codes, int M, int Mp, int K,
                         cudaStream_t stream) {
  const long long units = (long long)Mp * K / 16;
  const int blocks = (int)((units + 255) / 256 < 2048 ? (units + 255) / 256 : 2048);
  int8_quant_kernel<TX><<<blocks, 256, 0, stream>>>(static_cast<const TX*>(x), r,
                                                    static_cast<int8_t*>(codes), M, Mp, K);
  return cudaGetLastError();
}

}  // namespace

// One W8A8 product, on the route the wrapper (kernels/int8_matmul.py :
// plan) chose; which M takes which route is the wrapper's rule alone:
//   route 0: one CTA per 16-row weight strip; the codes scratch holds
//     code_rows = 8 or 16 >= M rows; tile_n and ctas unused;
//   route 1: tile_n 128 or 256, ctas persistent CTAs; the codes scratch
//     holds M rows.
// x_dtype: 0 = float32, 1 = bfloat16. sx_ptr/zx_ptr: device scalars of a
// dynamic range, or null to use sx/zx. Returns the cudaError_t of the
// launches (0 = success); a route the inputs do not fit is refused with
// cudaErrorInvalidValue.
extern "C" int int8_matmul_launch(const void* x, const void* w, const float* w_scale,
                                  const float* sx_ptr, const float* zx_ptr, float sx, float zx,
                                  void* codes, int code_rows, float* out, int M, int N, int K,
                                  int x_dtype, int route, int tile_n, int ctas, void* stream) {
  const bool small = route == 0;
  const bool route_fits =
      small ? (code_rows == 8 || code_rows == 16) && M <= code_rows
            : route == 1 && (tile_n == 128 || tile_n == 256) && ctas >= 1 && code_rows == M;
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 16 != 0 || (x_dtype != 0 && x_dtype != 1) ||
      (sx_ptr == nullptr) != (zx_ptr == nullptr) || !route_fits ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Range r{sx_ptr, zx_ptr, sx, zx};
  cudaError_t err = x_dtype == 0
                        ? launch_quant<float>(x, r, codes, M, code_rows, K, s)
                        : launch_quant<__nv_bfloat16>(x, r, codes, M, code_rows, K, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (small) {
    const gemv::Args a{static_cast<const int8_t*>(codes), wq, w_scale, r, out, M, N, K};
    const dim3 grid((N + gemv::ROWS - 1) / gemv::ROWS);
    err = code_rows == 8
              ? launch_dependent(gemv::int8_gemv_kernel<1>, grid, gemv::THREADS, 0, s, a)
              : launch_dependent(gemv::int8_gemv_kernel<2>, grid, gemv::THREADS, 0, s, a);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  const tc::Args a{out, w_scale, r, M, N, K, (M + tc::BM - 1) / tc::BM, (N + tile_n - 1) / tile_n};
  err = tile_n == 256 ? launch_tc<256>(codes, wq, a, ctas, s) : launch_tc<128>(codes, wq, a, ctas, s);
  return (int)err;
}
