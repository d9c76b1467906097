// Shared device helpers for the port's kernels: element conversion,
// vectorised loads and stores of up to 16 bytes, and a block-wide sum.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fedml {

// dtype codes the Python wrappers pass across the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA and PyTorch do
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// VEC consecutive elements in loads of at most 16 bytes; p must be aligned
// to min(VEC * sizeof(T), 16) bytes
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (sizeof(T) * VEC > 16) {
    constexpr int H = 16 / sizeof(T);
#pragma unroll
    for (int h = 0; h < VEC; h += H) {
      float part[H];
      load_vec<T, H>(p + h, part);
#pragma unroll
      for (int i = 0; i < H; ++i) out[h + i] = part[i];
    }
  } else {
    using R = typename Raw<sizeof(T) * VEC>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (sizeof(T) * VEC > 16) {
    constexpr int H = 16 / sizeof(T);
#pragma unroll
    for (int h = 0; h < VEC; h += H) {
      float part[H];
#pragma unroll
      for (int i = 0; i < H; ++i) part[i] = in[h + i];
      store_vec<T, H>(p + h, part);
    }
  } else {
    using R = typename Raw<sizeof(T) * VEC>::type;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(in[i]);
    *reinterpret_cast<R*>(p) = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread of the block must call it and
// every thread gets the result.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float t = lane < n_warps ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();  // part and total are reused by the next call
  return out;
}

}  // namespace fedml
