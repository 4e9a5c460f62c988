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
// the compiler may not contract them into an FMA), the order the plain
// version `a[:, t] * h + b[:, t]` rounds in, so the result is bitwise
// the plain version's.
//
// What bounds it on an H100: bytes. Each element of a and b is read once
// and each h_t written once (12 bytes per element against 2 flops), far
// below the ~20 flop/byte at which even the f32 CUDA cores would be the
// limit. Design: one thread owns one (row, channel) pair and walks T;
// neighbouring threads own neighbouring channels, so every load and store
// of a warp is one coalesced 128-byte line. The loads of a_t and b_t do
// not depend on h, so the walk goes U steps at a time: the 2U loads of a
// group all start before its first product, keeping 2U loads in flight
// per thread against the memory latency. The TPU kernel's padding of D
// to blocks of 512 is not needed: a thread past D returns at once.
// With B * D threads the card is full only for B * D of about 32k and
// up (B 8 at D 4096); a single long row (B 1) runs 4096 threads and is
// latency bound. A chunked two-pass scan over T would fill the card
// there; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block, all along D
constexpr int U = 16;    // time steps whose loads start together

__global__ void __launch_bounds__(NT) rglru_kernel(const float* __restrict__ a,
                                                   const float* __restrict__ b,
                                                   const float* __restrict__ h0,
                                                   float* __restrict__ h,
                                                   float* __restrict__ h_last, int T,
                                                   int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.y;
  const long long base = row * (long long)T * D + d;
  float hv = h0 != nullptr ? h0[row * D + d] : 0.f;
  int t = 0;
  for (; t + U <= T; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long off = base + (long long)(t + k) * D;
      av[k] = __ldg(a + off);
      bv[k] = __ldg(b + off);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      hv = __fadd_rn(__fmul_rn(av[k], hv), bv[k]);
      h[base + (long long)(t + k) * D] = hv;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + (long long)t * D;
    hv = __fadd_rn(__fmul_rn(__ldg(a + off), hv), __ldg(b + off));
    h[off] = hv;
  }
  h_last[row * D + d] = hv;
}

}  // namespace

// a, b, h: (B, T, D) f32 contiguous; h0 (B, D) f32 or null (zero state);
// h_last (B, D) f32. Returns the cudaError_t of the launch (0 = success).
extern "C" int rglru_launch(const float* a, const float* b, const float* h0, float* h,
                            float* h_last, int B, int T, int D, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h0, h, h_last, T, D);
  return (int)cudaGetLastError();
}
