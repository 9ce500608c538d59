// Helpers shared by the port's CUDA sources: element conversion for the two
// dtypes the kernels take (float, __nv_bfloat16), vector loads of 8 elements
// (float, bf16, int8), and block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace asr {

// finite -inf, as in the JAX kernels: exp() and max() stay NaN-free when a
// whole tile is masked
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and held as float: the `.astype(dtype)` casts of the JAX
// kernels between fp32 math and the next product
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// 8 consecutive elements → float; p must be 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// 8 consecutive int8 values → float (exact); p must be 8-byte aligned
__device__ __forceinline__ void load8(const int8_t* p, float (&w)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<float>(static_cast<int8_t>((u.x >> (8 * i)) & 0xffu));
    w[4 + i] = static_cast<float>(static_cast<int8_t>((u.y >> (8 * i)) & 0xffu));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block; every thread gets the result. `buf` holds one
// float per warp. Safe to call back to back: the trailing sync keeps a
// second call from overwriting `buf` before every thread has read it.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float r = MAX ? NEG : 0.f;
  for (int i = 0; i < n_warps; ++i) r = MAX ? fmaxf(r, buf[i]) : r + buf[i];
  __syncthreads();
  return r;
}

}  // namespace asr

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
