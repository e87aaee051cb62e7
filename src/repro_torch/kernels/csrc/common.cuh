// Shared helpers for the port's attention kernels (plain C interface,
// no PyTorch headers: built with nvcc into a shared library and loaded
// with ctypes, see kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Dtype codes passed from Python (kernels/_build.py callers).
enum DType : int { F32 = 0, BF16 = 1 };

// Masked-logit marker, as in the Pallas kernels (NEG_INF = -1e30): finite,
// so exp(m_old - m_new) never sees inf - inf.
constexpr float NEG = -1e30f;

// One 16-byte load of T, widened to fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// E (1, 2 or 4) consecutive elements of T in one vector load, widened to
// fp32; p must be aligned to E elements.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* out) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* p, float* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* p, float* out) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(const __nv_bfloat16* p, float* out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = f.x; out[1] = f.y;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// Load rows [0, ROWS) of a (ROWS x D) tile into shared memory as fp32 with
// a row pitch of `pitch` floats, scaled by `mult`.  Row i starts at
// base + i * row_stride elements; rows outside [vlo, vhi) are zero-filled
// (never read from memory).  Needs 16-byte aligned rows (checked by the
// Python wrappers).
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* sm, int pitch, const T* base,
                                          long long row_stride, int vlo, int vhi,
                                          float mult) {
  constexpr int V = Vec<T>::N;
  constexpr int CPR = D / V;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int i = c / CPR;
    const int d0 = (c % CPR) * V;
    float x[V];
    if (i >= vlo && i < vhi) {
      Vec<T>::load(base + (long long)i * row_stride + d0, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) sm[i * pitch + d0 + j] = x[j] * mult;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace rt
