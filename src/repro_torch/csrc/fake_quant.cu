// Fake quantization (paper Eq. 1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fake_quant.py : fake_quant_pallas
// (body _kernel): one pass over a tensor applying quant-dequant with
// static (s, z) read from device memory, with a channel count C along the
// last axis (C = 1 is per-tensor, as the TPU kernel; C = the last dim is
// per-channel along that axis). Two forms, chosen by `ste`:
//
//   ste 0, the TPU kernel's:  q = clip(rint(x / s + z), 0, n - 1)
//                              out = s * (q - z)
//   ste 1, the model's (repro_torch/quant/quantizer.py : fake_quant,
//   the straight-through form of every 'apply'-mode site):
//                              xc = min(max(x, s * (0 - z)), s * (n - 1 - z))
//                              qd = s * (clip(rint(xc / s + z), 0, n - 1) - z)
//                              out = xc + (qd - xc)
//
// computed in f32 and rounded once to x's dtype. Every step is one IEEE
// operation in the order the plain version takes them: the division is
// __fdiv_rn (not a multiplication by 1/s), rintf rounds half to even like
// torch.round and jnp.round, and the _rn intrinsics keep the compiler
// from contracting a product and a sum into an FMA, so the result is
// bitwise the plain version's.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (~10 flops per element pair, far below the ~295 flop/byte at which
// the card turns compute bound). Design: a grid-stride pass with 16-byte
// vector loads and stores; (s, z) are loaded once per thread for the
// per-tensor form, and per element (from L1) per channel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// NaN-propagating max/min, as torch.maximum / torch.minimum / torch.clamp
// (fmaxf / fminf would turn a NaN code into a bound)
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float fq(float x, float s, float z, float top, int ste) {
  if (ste) {
    const float lo = __fmul_rn(s, __fsub_rn(0.f, z));
    const float hi = __fmul_rn(s, __fsub_rn(top, z));
    const float xc = nmin(nmax(x, lo), hi);
    const float q = nmin(nmax(rintf(__fadd_rn(__fdiv_rn(xc, s), z)), 0.f), top);
    const float qd = __fmul_rn(s, __fsub_rn(q, z));
    return __fadd_rn(xc, __fsub_rn(qd, xc));
  }
  const float q = nmin(nmax(rintf(__fadd_rn(__fdiv_rn(x, s), z)), 0.f), top);
  return __fmul_rn(s, __fsub_rn(q, z));
}

template <typename T>
__global__ void __launch_bounds__(NT) fake_quant_kernel(const T* __restrict__ x,
                                                        T* __restrict__ out,
                                                        const float* __restrict__ s_p,
                                                        const float* __restrict__ z_p,
                                                        long long n, int C, float top,
                                                        int ste) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const long long nvec = n / V;
  const long long stride = (long long)gridDim.x * NT;
  const float s0 = s_p[0], z0 = z_p[0];
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < nvec; i += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    T e[V];
    memcpy(e, &raw, sizeof(raw));
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s = s0, z = z0;
      if (C > 1) {
        const int c = (int)((i * V + k) % C);
        s = s_p[c];
        z = z_p[c];
      }
      from_f(&e[k], fq(to_f(e[k]), s, z, top, ste));
    }
    memcpy(&raw, e, sizeof(raw));
    reinterpret_cast<uint4*>(out)[i] = raw;
  }
  // ragged tail: fewer than V elements
  const long long tail = nvec * V + (long long)blockIdx.x * NT + threadIdx.x;
  if (tail < n) {
    const int c = C > 1 ? (int)(tail % C) : 0;
    from_f(&out[tail], fq(to_f(x[tail]), s_p[c], z_p[c], top, ste));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* s, const float* z, long long n,
                   int C, int bits, int ste, cudaStream_t stream) {
  const int V = 16 / sizeof(T);
  long long blocks = (n / V + NT - 1) / NT;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  const float top = (float)((1 << bits) - 1);
  fake_quant_kernel<T><<<(int)blocks, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), s, z, n, C, top, ste);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out alike). s and z: C f32
// values on the device. Returns the cudaError_t of the launch (0 = success).
extern "C" int fake_quant_launch(const void* x, void* out, const float* s, const float* z,
                                 long long n, int C, int bits, int ste, int dtype,
                                 void* stream) {
  if (n < 1 || C < 1 || bits < 1 || bits > 16 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, out, s, z, n, C, bits, ste, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, out, s, z, n, C, bits, ste, st);
  return (int)cudaErrorInvalidValue;
}
