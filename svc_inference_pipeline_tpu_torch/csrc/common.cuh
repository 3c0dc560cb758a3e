// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel in this directory is compiled by nvcc into ONE shared library
// with a plain C interface (see ops/pallas/_build.py) and called through
// ctypes: pointers and the CUDA stream arrive as integers, each entry point
// launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace svc
