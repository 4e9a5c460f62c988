// W8A8 matmul for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/int8_matmul.py : int8_matmul (body _kernel)
// out (M, N) f32 = (codes(x) @ w_q) * (s_x * s_w), where
//   codes(x) = clip(clip(rint(x / s_x) + z_x, 0, 255) - z_x, -127, 127)
// is the per-tensor asymmetric uint8 activation quantization, centred and
// saturated to int8, with a static (s_x, z_x) passed by value or a
// dynamic one read from device pointers (computed on the device by the
// wrapper, with no host sync); w_q (K, N) int8 is the per-tensor
// symmetric weight in the reference's row-major layout, and s_w is read
// through a device pointer. x is f32 or bf16, row-major (M, K).
//
// Bitwise contract with the plain version (kernels/int8_matmul.py:
// int8_matmul_ref): x / s_x is a true f32 division (__fdiv_rn), rounding
// is half to even (rintf), the integer product is exact in int32
// (|acc| <= 127^2 * K < 2^31), and the epilogue is
// float(acc) * (s_x * s_w) with the scale product rounded to f32 first.
// Build without --use_fast_math.
//
// What bounds it on an H100: decode (M = 8) reads K * N int8 weight bytes
// for 2 * M * K * N operations, far below the ~600 int8 ops per byte the
// card needs to be compute bound, so the floor is the weight bytes over
// 3.35 TB/s; a padded mixed tick (M = 2048) is compute bound at the
// 1979 TOP/s int8 tensor-core rate.
//
// Design. On the TPU the grid walks K sequentially with an int32
// accumulator in VMEM. Here one CTA owns a BM x BN output tile and walks
// its K range itself; the activation tile is quantized on load (the
// prologue), the B tile is transposed in shared memory with byte permutes
// into the K-contiguous columns that the .col operand of
// mma.sync.m16n8k32.s8 needs, and the products run on the tensor cores
// into int32 registers. Global loads of the next K step are started into
// registers before the current step's products, so they are in flight
// while the tensor cores work, and shared memory is double-buffered, so
// a warp quantizes and stores the next step while others still multiply
// (one barrier per K step). Two tile shapes (M x N x K): 16 x 64 x 128
// for decode-sized M (<= 16) and 128 x 256 x 32 otherwise. When the output
// tiles alone cannot fill the SMs (decode, narrow N), K is split across
// CTAs: each adds its int32 partial sums into a zeroed workspace with
// atomics (integer addition is exact in any order) and a second pass
// applies the f32 epilogue. Left for later work: TMA / cp.async
// multi-stage pipelines and wgmma, and quantizing each activation tile
// once rather than once per N tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

template <int BM_, int BN_, int BK_, int WM_, int WN_, int CTAS_PER_SM_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  // shared-memory row stride in bytes: the 16-byte pad makes the
  // fragment loads of a warp (8 rows x 4 words) hit 32 distinct banks
  static constexpr int LDS = BK + 16;
  static constexpr int A_UNITS = BM * BK / 16;           // 16 elements of one row
  static constexpr int B_UNITS = (BK / 4) * (BN / 16);   // 4 rows x 16 bytes
  static constexpr int A_PER_T = (A_UNITS + THREADS - 1) / THREADS;
  static constexpr int B_PER_T = (B_UNITS + THREADS - 1) / THREADS;
  static constexpr int CTAS_PER_SM = CTAS_PER_SM_;       // split-K target
};
using Small = Tile<16, 64, 128, 16, 16, 4>;   // M <= 16: 4 warps along N
// 2 x 8 warps; the wide N tile halves the prologue's work per product,
// since every N tile quantizes its activation rows again
using Large = Tile<128, 256, 32, 64, 32, 1>;

struct Args {
  const void* x;
  const int8_t* w;
  const float* w_scale;
  const float* sx_ptr;  // dynamic range: device scalars, else null
  const float* zx_ptr;
  float sx, zx;         // static range
  float* out;
  int* ws;              // int32 (M, N) split-K workspace, zeroed, or null
  int M, N, K;
  int steps_per_split;  // K steps of BK per CTA along gridDim.z
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the reference's activation code, operation for operation in f32
__device__ __forceinline__ uint32_t quant(float v, float s, float z) {
  float q = rintf(__fdiv_rn(v, s)) + z;
  q = fminf(fmaxf(q, 0.f), 255.f) - z;
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

// 4x4 byte transpose: in r_i holds bytes (row i, cols 0..3); out c_j holds
// bytes (rows 0..3, col j)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t* c) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2b0 r3b0 r2b1 r3b1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);  // r2b2 r3b2 r2b3 r3b3
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, typename TX, bool SPLIT>
__global__ void __launch_bounds__(T::THREADS) int8_gemm_kernel(Args a) {
  constexpr int NV = sizeof(TX);  // 16-byte vectors per 16-element A unit
  // two buffers: step s+1 is stored while other warps still multiply step s
  __shared__ __align__(16) uint8_t As[2][T::BM * T::LDS];  // codes, [m][k]
  __shared__ __align__(16) uint8_t Bs[2][T::BN * T::LDS];  // weights, [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int k_steps = (a.K + T::BK - 1) / T::BK;
  const int s_begin = blockIdx.z * a.steps_per_split;
  const int s_end = min(k_steps, s_begin + a.steps_per_split);
  const float sx = a.sx_ptr != nullptr ? *a.sx_ptr : a.sx;
  const float zx = a.zx_ptr != nullptr ? *a.zx_ptr : a.zx;
  const TX* x = static_cast<const TX*>(a.x);

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  uint4 ra[T::A_PER_T][NV];
  uint4 rb[T::B_PER_T][4];

  // global -> registers: K step s
  auto load = [&](int s) {
    const int k0 = s * T::BK;
#pragma unroll
    for (int i = 0; i < T::A_PER_T; ++i) {
      const int u = tid + i * T::THREADS;
      const int m = u / (T::BK / 16), k = k0 + (u % (T::BK / 16)) * 16;
      const bool ok = u < T::A_UNITS && m0 + m < a.M && k < a.K;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * a.K + k);
#pragma unroll
      for (int v = 0; v < NV; ++v) ra[i][v] = ok ? src[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < T::B_PER_T; ++i) {
      const int u = tid + i * T::THREADS;
      const int k = k0 + (u % (T::BK / 4)) * 4, n = n0 + (u / (T::BK / 4)) * 16;
      const bool ok = u < T::B_UNITS && k < a.K && n < a.N;  // K % 16 == 0: rows k..k+3 in range
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rb[i][r] = ok ? *reinterpret_cast<const uint4*>(a.w + (size_t)(k + r) * a.N + n)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // registers -> shared memory buffer s % 2: quantize A, transpose B
  auto store = [&](int s) {
    const int k0 = s * T::BK;
    uint8_t* as = As[s & 1];
    uint8_t* bs = Bs[s & 1];
#pragma unroll
    for (int i = 0; i < T::A_PER_T; ++i) {
      const int u = tid + i * T::THREADS;
      if (u >= T::A_UNITS) continue;
      const int m = u / (T::BK / 16), kc = u % (T::BK / 16);
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
      if (m0 + m < a.M && k0 + kc * 16 < a.K) {  // padding stays code 0
        TX vals[16];
        memcpy(vals, ra[i], sizeof(vals));
#pragma unroll
        for (int e = 0; e < 16; ++e) packed[e / 4] |= quant(to_f(vals[e]), sx, zx) << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(as + m * T::LDS + kc * 16) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
#pragma unroll
    for (int i = 0; i < T::B_PER_T; ++i) {
      const int u = tid + i * T::THREADS;
      if (u >= T::B_UNITS) continue;
      const int kb = u % (T::BK / 4), nb = u / (T::BK / 4);
      uint32_t rw[4][4];
      memcpy(rw, rb[i], sizeof(rw));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t col[4];
        transpose4(rw[0][c], rw[1][c], rw[2][c], rw[3][c], col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(bs + (nb * 16 + c * 4 + j) * T::LDS + kb * 4) = col[j];
        }
      }
    }
  };

  auto compute = [&](int s) {
    const uint8_t* as = As[s & 1];
    const uint8_t* bs = Bs[s & 1];
#pragma unroll
    for (int ks = 0; ks < T::BK / 32; ++ks) {
      uint32_t af[T::MT][4], bf[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const uint8_t* p = as + (wm * T::WM + i * 16 + g) * T::LDS + ks * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * T::LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * T::LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const uint8_t* p = bs + (wn * T::WN + j * 8 + g) * T::LDS + ks * 32 + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  };

  if (s_begin < s_end) {
    load(s_begin);
    store(s_begin);
    __syncthreads();
    for (int s = s_begin; s < s_end; ++s) {
      const bool more = s + 1 < s_end;
      if (more) load(s + 1);  // in flight during the products below
      compute(s);
      // the other buffer was last read by compute(s - 1), which every
      // warp finished before the previous barrier
      if (more) store(s + 1);
      __syncthreads();
    }
  }

  const float scale = __fmul_rn(sx, *a.w_scale);
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int col = n0 + wn * T::WN + j * 8 + t * 2;  // even; N % 16 == 0
      if (col >= a.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * T::WM + i * 16 + g + h * 8;
        if (row >= a.M) continue;
        const size_t o = (size_t)row * a.N + col;
        if (SPLIT) {
          atomicAdd(a.ws + o, acc[i][j][2 * h]);
          atomicAdd(a.ws + o + 1, acc[i][j][2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(a.out + o) =
              make_float2(__int2float_rn(acc[i][j][2 * h]) * scale,
                          __int2float_rn(acc[i][j][2 * h + 1]) * scale);
        }
      }
    }
  }
}

// split-K epilogue: out = float(sum of partials) * (s_x * s_w)
__global__ void int8_epilogue_kernel(Args a) {
  const float sx = a.sx_ptr != nullptr ? *a.sx_ptr : a.sx;
  const float scale = __fmul_rn(sx, *a.w_scale);
  const size_t n = (size_t)a.M * a.N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    a.out[i] = __int2float_rn(a.ws[i]) * scale;
  }
}

struct Plan {
  bool small;
  int tiles_n, tiles_m, splits, steps_per_split;
};

template <typename T>
Plan plan_for(int M, int N, int K, int sms) {
  Plan p;
  p.tiles_n = (N + T::BN - 1) / T::BN;
  p.tiles_m = (M + T::BM - 1) / T::BM;
  const int k_steps = (K + T::BK - 1) / T::BK;
  const int tiles = p.tiles_n * p.tiles_m;
  const int want = (T::CTAS_PER_SM * sms + tiles - 1) / tiles;
  const int splits = want < k_steps ? want : k_steps;
  p.steps_per_split = splits > 1 ? (k_steps + splits - 1) / splits : k_steps;
  p.splits = (k_steps + p.steps_per_split - 1) / p.steps_per_split;
  return p;
}

Plan make_plan(int M, int N, int K) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Plan p = M <= Small::BM ? plan_for<Small>(M, N, K, sms) : plan_for<Large>(M, N, K, sms);
  p.small = M <= Small::BM;
  return p;
}

template <typename T, typename TX>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.tiles_n, p.tiles_m, p.splits);
  if (p.splits > 1) {
    cudaError_t err = cudaMemsetAsync(a.ws, 0, (size_t)a.M * a.N * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    int8_gemm_kernel<T, TX, true><<<grid, T::THREADS, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)a.M * a.N;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    int8_epilogue_kernel<<<blocks, 256, 0, stream>>>(a);
  } else {
    int8_gemm_kernel<T, TX, false><<<grid, T::THREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Elements of the int32 workspace a launch at (M, N, K) needs (0: none).
extern "C" long long int8_matmul_workspace_elems(int M, int N, int K) {
  if (M < 1 || N < 1 || K < 1) return 0;
  const Plan p = make_plan(M, N, K);
  return p.splits > 1 ? (long long)M * N : 0;
}

// x_dtype: 0 = float32, 1 = bfloat16. sx_ptr/zx_ptr: device scalars of a
// dynamic range, or null to use sx/zx. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int int8_matmul_launch(const void* x, const void* w, const float* w_scale,
                                  const float* sx_ptr, const float* zx_ptr, float sx, float zx,
                                  float* out, int* ws, int M, int N, int K, int x_dtype,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 16 != 0 || (x_dtype != 0 && x_dtype != 1) ||
      (sx_ptr == nullptr) != (zx_ptr == nullptr) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(M, N, K);
  if (p.splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const int8_t*>(w), w_scale, sx_ptr, zx_ptr, sx, zx, out, ws, M, N, K,
         p.steps_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.small) {
    return (int)(x_dtype == 0 ? launch<Small, float>(a, p, s) : launch<Small, __nv_bfloat16>(a, p, s));
  }
  return (int)(x_dtype == 0 ? launch<Large, float>(a, p, s) : launch<Large, __nv_bfloat16>(a, p, s));
}
