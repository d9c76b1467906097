// Weighted fold over the client axis: out[p] (+)= sum_k w[k] * V[k, p].
//
// Replaces the Pallas kernel fedml_tpu/ops/aggregate.py::_wmean_kernel
// (driven by _wmean_flat / weighted_mean_pallas), which computes one
// [1, C] x [C, 512] product per lane tile and scales it by 1 / sum(w).
// Two forms share one kernel:
//   accumulate: acc[p] += sum_k w[k] * V[k, p]        (the chunk fold)
//   finalize:   out[p]  = sum_k w[k] * V[k, p] / max(sum_k w[k], 1e-12)
// V is bf16 or f32 and enters the sum in f32; acc and out are f32.
//
// Bound on the H100: bytes. With k lanes of P elements it reads
// k * P * sizeof(T) bytes of V, reads and writes 4 * P bytes of acc (only
// writes them when finalizing); 2 * k * P flops are nothing beside that.
// At the main path's fold (k = 2, P = 11.17M bf16) that is 134 MB, 40 us
// at 3.35 TB/s; at ResNet-56's row (k = 2, P = 860,160: its parameters,
// its BatchNorm statistics and the pad) 10.3 MB, 3.1 us, so there the
// launch's fixed cost is most of the time (3.9 us measured on an H100
// 80GB HBM3 at 700 W). Design: each thread owns 16 bytes of V per lane row and
// walks the k rows, so every load is a coalesced 16-byte load and each
// accumulator element is read and written once per launch.

#include "common.cuh"

namespace fedml {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC, bool FINALIZE>
__global__ void __launch_bounds__(kThreads)
wsum_kernel(float* __restrict__ out, const T* __restrict__ V,
            const float* __restrict__ w, int k, long long P, long long ld) {
  float scale = 1.f;
  if (FINALIZE) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += w[j];
    scale = 1.f / fmaxf(s, 1e-12f);
  }
  const long long n_vec = P / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    float acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int j = 0; j < k; ++j) {
      float e[VEC];
      load_vec<T, VEC>(V + j * ld + i * VEC, e);
      const float wj = w[j];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] += wj * e[t];
    }
    float* o = out + i * VEC;
    if (FINALIZE) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] *= scale;
    } else {
      float prev[VEC];
      load_vec<float, VEC>(o, prev);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] += prev[t];
    }
    store_vec<float, VEC>(o, acc);
  }
}

template <typename T, int VEC>
void launch(float* out, const void* V, const float* w, int k, long long P,
            long long ld, bool finalize, cudaStream_t stream) {
  const long long n_vec = P / VEC;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 64 ? (want > 0 ? want : 1) : 132 * 64);
  const T* v = static_cast<const T*>(V);
  if (finalize)
    wsum_kernel<T, VEC, true><<<blocks, kThreads, 0, stream>>>(out, v, w, k, P, ld);
  else
    wsum_kernel<T, VEC, false><<<blocks, kThreads, 0, stream>>>(out, v, w, k, P, ld);
}

}  // namespace
}  // namespace fedml

using namespace fedml;

// vec is chosen by the Python wrapper: 16 / sizeof(T) or 4 when P and ld are
// multiples of it and the pointers are 16-byte aligned, else 1.
extern "C" int fedml_wsum(void* out, const void* V, const void* w, int k,
                          long long P, long long ld, int finalize, int dtype,
                          int vec, void* stream) {
  auto* o = static_cast<float*>(out);
  const auto* wt = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && vec == 8)
    launch<__nv_bfloat16, 8>(o, V, wt, k, P, ld, finalize, st);
  else if (dtype == kBFloat16 && vec == 1)
    launch<__nv_bfloat16, 1>(o, V, wt, k, P, ld, finalize, st);
  else if (dtype == kFloat32 && vec == 4)
    launch<float, 4>(o, V, wt, k, P, ld, finalize, st);
  else if (dtype == kFloat32 && vec == 1)
    launch<float, 1>(o, V, wt, k, P, ld, finalize, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
