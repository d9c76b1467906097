// Norm-clipped aggregation over the client axis: the per-client squared
// distance to the global model, and the clipped fold.
//
// Replaces the two Pallas kernels of
// fedml_tpu/ops/aggregate.py::robust_weighted_mean_pallas:
//   _sqnorm_kernel   sq[c] = sum_p (x[c, p] - g[p])^2, accumulated across a
//                    sequential grid of 512-lane tiles into one [C, 1] block;
//   _clip_agg_kernel out = g + sum_c cf[c] * (x[c] - g), cf = w_hat * clip,
//                    whose output aliases the dead g buffer.
// V is bf16 or f32 and enters every sum in f32; g has V's dtype.
//
// sqnorm. Bound on the H100: bytes, (k + 1) * P * sizeof(T) read once
// (20 us for a [2, P] bf16 chunk of ResNet-18-GN, P = 11.17M, at
// 3.35 TB/s). Hopper's blocks run in no order, so nothing carries across a
// grid as the TPU's tiles do. Design: a grid-stride pass with 16-byte
// loads in which each thread loads its g vector once and walks up to
// kRows lane rows, so g is read once per kRows rows; each block writes one
// partial per row, and a second tiny launch of the same entry sums each
// row's partials in a fixed order. There are no float atomics: the same
// inputs give bitwise the same norms on every run, and the clip factor
// depends on them.
//
// clip_agg. out (+)= base * g + sum_k cf[k] * (V[k] - g), in f32, out f32.
// Two forms share the kernel, as the weighted fold's do:
//   in place  (the finalize of norm-clipped FedAvg): out IS the f32 g
//             buffer, base = 1;
//   accumulate (the mesh engine's chunk fold): base = sum(w), cf = w * s,
//             which is sum_k w_k * (g + s_k * (v_k - g)); FedNova's fold is
//             base = 0, cf = -w / max(tau, 1).
// base comes from device memory (or a constant), so the host never waits.
// Bound on the H100: bytes, k * P * sizeof(T) + P * sizeof(T) read, plus
// 4 * P read when accumulating, plus 4 * P written. Design: the weighted
// fold's, with g loaded once per vector beside the k lane rows. In the in-
// place form out and g are one pointer, so neither is __restrict__; each
// thread reads its g elements before it writes the same elements.

#include "common.cuh"

namespace fedml {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;              // lane rows a thread carries per pass
constexpr int kMaxBlocks = 132 * 4;   // sqnorm: four blocks on each SM

int grid_for(long long n_vec, int cap) {
  const long long want = (n_vec + kThreads - 1) / kThreads;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
sqnorm_partial_kernel(float* __restrict__ partial, const T* __restrict__ V,
                      const T* __restrict__ g, int k, long long P,
                      long long ld) {
  const long long n_vec = P / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r0 = 0; r0 < k; r0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_vec; i += stride) {
      float gv[VEC];
      load_vec<T, VEC>(g + i * VEC, gv);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (r0 + j < k) {
          float e[VEC];
          load_vec<T, VEC>(V + (long long)(r0 + j) * ld + i * VEC, e);
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            const float d = e[t] - gv[t];
            acc[j] = fmaf(d, d, acc[j]);
          }
        }
      }
    }
    // r0 + j < k is the same for every thread: block_sum's barriers agree
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j < k) {
        const float s = block_sum(acc[j]);
        if (threadIdx.x == 0)
          partial[(long long)(r0 + j) * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

// one block per row: the row's partials, each thread's share in a fixed
// order, then block_sum's fixed tree
__global__ void __launch_bounds__(kThreads)
sqnorm_finish_kernel(float* __restrict__ out, const float* __restrict__ partial,
                     int n_part) {
  const float* row = partial + (long long)blockIdx.x * n_part;
  float s = 0.f;
  for (int b = threadIdx.x; b < n_part; b += blockDim.x) s += row[b];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T, int VEC>
cudaError_t launch_sqnorm(float* out, float* partial, const void* V,
                          const void* g, int k, long long P, long long ld,
                          cudaStream_t stream) {
  const int blocks = grid_for(P / VEC, kMaxBlocks);
  sqnorm_partial_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      partial, static_cast<const T*>(V), static_cast<const T*>(g), k, P, ld);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  sqnorm_finish_kernel<<<k, kThreads, 0, stream>>>(out, partial, blocks);
  return cudaGetLastError();
}

template <typename T, int VEC, bool ACCUMULATE>
__global__ void __launch_bounds__(kThreads)
clip_agg_kernel(float* out, const T* __restrict__ V, const T* g,
                const float* __restrict__ cf, const float* __restrict__ base_ptr,
                float base_const, int k, long long P, long long ld) {
  const float base = base_ptr ? *base_ptr : base_const;
  const long long n_vec = P / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    float gv[VEC], acc[VEC];
    load_vec<T, VEC>(g + i * VEC, gv);
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int j = 0; j < k; ++j) {
      float e[VEC];
      load_vec<T, VEC>(V + (long long)j * ld + i * VEC, e);
      const float c = cf[j];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = fmaf(c, e[t] - gv[t], acc[t]);
    }
    float* o = out + i * VEC;
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = fmaf(base, gv[t], acc[t]);
    if (ACCUMULATE) {
      float prev[VEC];
      load_vec<float, VEC>(o, prev);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] += prev[t];
    }
    store_vec<float, VEC>(o, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch_clip_agg(float* out, const void* V, const void* g,
                            const float* cf, const float* base_ptr,
                            float base_const, int k, long long P, long long ld,
                            bool accumulate, cudaStream_t stream) {
  const int blocks = grid_for(P / VEC, 132 * 64);   // as the weighted fold
  const T* v = static_cast<const T*>(V);
  const T* gg = static_cast<const T*>(g);
  if (accumulate)
    clip_agg_kernel<T, VEC, true><<<blocks, kThreads, 0, stream>>>(
        out, v, gg, cf, base_ptr, base_const, k, P, ld);
  else
    clip_agg_kernel<T, VEC, false><<<blocks, kThreads, 0, stream>>>(
        out, v, gg, cf, base_ptr, base_const, k, P, ld);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fedml

using namespace fedml;

// the partial buffer holds k * fedml_sqnorm_max_blocks() floats
extern "C" int fedml_sqnorm_max_blocks() { return kMaxBlocks; }

// vec is chosen by the Python wrapper: 16 / sizeof(T) when P and ld are
// multiples of it and the pointers are 16-byte aligned, else 1.
extern "C" int fedml_sqnorm(void* out, void* partial, const void* V,
                            const void* g, int k, long long P, long long ld,
                            int dtype, int vec, void* stream) {
  auto* o = static_cast<float*>(out);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && vec == 8)
    return (int)launch_sqnorm<__nv_bfloat16, 8>(o, part, V, g, k, P, ld, st);
  if (dtype == kBFloat16 && vec == 1)
    return (int)launch_sqnorm<__nv_bfloat16, 1>(o, part, V, g, k, P, ld, st);
  if (dtype == kFloat32 && vec == 4)
    return (int)launch_sqnorm<float, 4>(o, part, V, g, k, P, ld, st);
  if (dtype == kFloat32 && vec == 1)
    return (int)launch_sqnorm<float, 1>(o, part, V, g, k, P, ld, st);
  return (int)cudaErrorInvalidValue;
}

// base_ptr, when not null, points at the f32 base on the device; else
// base_const is used.
extern "C" int fedml_clip_agg(void* out, const void* V, const void* g,
                              const void* cf, const void* base_ptr,
                              float base_const, int k, long long P,
                              long long ld, int accumulate, int dtype, int vec,
                              void* stream) {
  auto* o = static_cast<float*>(out);
  const auto* c = static_cast<const float*>(cf);
  const auto* b = static_cast<const float*>(base_ptr);
  auto st = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  if (dtype == kBFloat16 && vec == 8)
    return (int)launch_clip_agg<__nv_bfloat16, 8>(o, V, g, c, b, base_const, k,
                                                  P, ld, acc, st);
  if (dtype == kBFloat16 && vec == 1)
    return (int)launch_clip_agg<__nv_bfloat16, 1>(o, V, g, c, b, base_const, k,
                                                  P, ld, acc, st);
  if (dtype == kFloat32 && vec == 4)
    return (int)launch_clip_agg<float, 4>(o, V, g, c, b, base_const, k, P, ld,
                                          acc, st);
  if (dtype == kFloat32 && vec == 1)
    return (int)launch_clip_agg<float, 1>(o, V, g, c, b, base_const, k, P, ld,
                                          acc, st);
  return (int)cudaErrorInvalidValue;
}
