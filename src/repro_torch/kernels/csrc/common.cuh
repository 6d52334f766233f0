// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads and writes its tensors in their own dtype (bf16 or
// f32) and computes in f32.  Loads and stores move 16 bytes per thread
// (8 bf16 or 4 f32 values); the Python wrappers guarantee 16-byte aligned
// rows (the head or model width is a multiple of the vector).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;   // finite mask value, as in the reference

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// 16-byte load of Vec<T>::n values, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) out[i] = to_f(e[i]);
}

// 16-byte store of Vec<T>::n f32 values, narrowed to T.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it
// needs it (Hopper allows up to 227 KB per block).
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
