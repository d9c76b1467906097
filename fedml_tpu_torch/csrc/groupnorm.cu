// GroupNorm forward and backward over trailing-channel activations.
//
// Replaces the Pallas kernels of fedml_tpu/ops/groupnorm.py: _fwd_kernel
// (driven by _pallas_fwd) and _bwd_kernel (driven by _pallas_dx).
//
// Layout: x is [N, S, C] in memory (S = H*W spatial positions, channels
// last), C = G groups of Cg = C/G channels. Statistics are f32; the
// variance is two-pass, as in the reference.
//
// Bound on the H100: bytes. Each element is read once and written once in
// the forward (2 * N*S*C * sizeof(T)), read twice (x, dy) and written once
// in the backward; at 3.35 TB/s the forward of one [32, 32, 32, 64] bf16
// layer is 2.5 us. Design: one block per (sample, group), so the group's
// statistics never leave the block; 16-byte loads along the channels of the
// group; the three passes of the forward (and two of the backward) re-read
// the group from L2 rather than DRAM, since one group is at most a few
// hundred KB. The backward also folds the per-channel partial sums of
// dgamma and dbeta (sum over S of dy*xhat and dy) into its first pass and
// writes them as [N, C]; the wrapper sums those over N.
//
// Known limit, for a later change: at the main path's batch of 32 with
// G = 2 the grid is 64 blocks on 132 SMs.

#include <type_traits>

#include "common.cuh"

namespace fedml {
namespace {

constexpr int kThreads = 512;

// Thread t of a block owns channel vector v = t % vpr of its group (VEC
// channels) and walks the spatial rows r0, r0 + rows, ... with
// r0 = t / vpr. Threads with t >= rows * vpr idle but join the reductions.
struct GroupWalk {
  int vpr, rows, v, r0;
  bool active;
  __device__ GroupWalk(int Cg, int vec) {
    vpr = Cg / vec;
    rows = blockDim.x / vpr;
    v = threadIdx.x % vpr;
    r0 = threadIdx.x / vpr;
    active = r0 < rows;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int S, int C, int G, float eps) {
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const int Cg = C / G;
  const GroupWalk w(Cg, VEC);
  const long long base = (long long)n * S * C + (long long)g * Cg + w.v * VEC;
  const float m = (float)S * (float)Cg;

  float s = 0.f;
  if (w.active)
    for (int r = w.r0; r < S; r += w.rows) {
      float e[VEC];
      load_vec<T, VEC>(x + base + (long long)r * C, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += e[i];
    }
  const float mean = block_sum(s) / m;

  float q = 0.f;
  if (w.active)
    for (int r = w.r0; r < S; r += w.rows) {
      float e[VEC];
      load_vec<T, VEC>(x + base + (long long)r * C, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = e[i] - mean;
        q += d * d;
      }
    }
  const float rstd = rsqrtf(block_sum(q) / m + eps);
  if (threadIdx.x == 0) {
    mean_out[n * G + g] = mean;
    rstd_out[n * G + g] = rstd;
  }
  if (!w.active) return;

  const int c0 = g * Cg + w.v * VEC;
  float a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = rstd * gamma[c0 + i];
    b[i] = beta[c0 + i];
  }
  for (int r = w.r0; r < S; r += w.rows) {
    float e[VEC];
    load_vec<T, VEC>(x + base + (long long)r * C, e);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = (e[i] - mean) * a[i] + b[i];
    store_vec<T, VEC>(y + base + (long long)r * C, e);
  }
}

// dynamic shared memory: 2 * rows * Cg floats (per-row channel partials)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ gamma, const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in, T* __restrict__ dx,
              float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
              int S, int C, int G) {
  extern __shared__ float smem[];
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const int Cg = C / G;
  const GroupWalk w(Cg, VEC);
  const long long base = (long long)n * S * C + (long long)g * Cg + w.v * VEC;
  const float m = (float)S * (float)Cg;
  const float mean = mean_in[n * G + g], rstd = rstd_in[n * G + g];

  // pass 1: per-channel sums over this thread's rows of dy*xhat and dy
  float pg[VEC], pb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) pg[i] = pb[i] = 0.f;
  if (w.active)
    for (int r = w.r0; r < S; r += w.rows) {
      float xe[VEC], de[VEC];
      load_vec<T, VEC>(x + base + (long long)r * C, xe);
      load_vec<T, VEC>(dy + base + (long long)r * C, de);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        pg[i] += de[i] * ((xe[i] - mean) * rstd);
        pb[i] += de[i];
      }
    }
  float* sg = smem;
  float* sb = smem + w.rows * Cg;
  if (w.active)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sg[w.r0 * Cg + w.v * VEC + i] = pg[i];
      sb[w.r0 * Cg + w.v * VEC + i] = pb[i];
    }
  __syncthreads();

  // per channel: dgamma/dbeta partials; per group:
  // s1 = sum(dy*gamma) and s2 = sum(dy*gamma*xhat)
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < Cg; c += blockDim.x) {
    float dg = 0.f, db = 0.f;
    for (int rr = 0; rr < w.rows; ++rr) {
      dg += sg[rr * Cg + c];
      db += sb[rr * Cg + c];
    }
    const int ch = g * Cg + c;
    dgamma_part[(long long)n * C + ch] = dg;
    dbeta_part[(long long)n * C + ch] = db;
    s1 += gamma[ch] * db;
    s2 += gamma[ch] * dg;
  }
  s1 = block_sum(s1);
  s2 = block_sum(s2);
  if (!w.active) return;

  // pass 2: dx = (dy*gamma - (s1 + xhat*s2)/m) * rstd
  const int c0 = g * Cg + w.v * VEC;
  float gm[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) gm[i] = gamma[c0 + i];
  for (int r = w.r0; r < S; r += w.rows) {
    float xe[VEC], de[VEC];
    load_vec<T, VEC>(x + base + (long long)r * C, xe);
    load_vec<T, VEC>(dy + base + (long long)r * C, de);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xh = (xe[i] - mean) * rstd;
      xe[i] = (de[i] * gm[i] - (s1 + xh * s2) / m) * rstd;
    }
    store_vec<T, VEC>(dx + base + (long long)r * C, xe);
  }
}

template <typename T, int VEC>
void launch_fwd(const void* x, const float* gamma, const float* beta, void* y,
                float* mean, float* rstd, int N, int S, int C, int G, float eps,
                cudaStream_t stream) {
  gn_fwd_kernel<T, VEC><<<N * G, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean, rstd,
      S, C, G, eps);
}

template <typename T, int VEC>
void launch_bwd(const void* x, const void* dy, const float* gamma,
                const float* mean, const float* rstd, void* dx, float* dgamma_part,
                float* dbeta_part, int N, int S, int C, int G, cudaStream_t stream) {
  const int Cg = C / G;
  const int rows = kThreads / (Cg / VEC);
  const size_t smem = 2 * sizeof(float) * (size_t)rows * Cg;
  gn_bwd_kernel<T, VEC><<<N * G, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, mean, rstd,
      static_cast<T*>(dx), dgamma_part, dbeta_part, S, C, G);
}

// vec is chosen by the Python wrapper: a power of two that divides Cg, at
// most 16 bytes of T, with every pointer aligned to vec * sizeof(T), and
// Cg / vec <= kThreads.
template <typename T, typename F>
int dispatch_vec(int vec, F&& f) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) <= 2) { f(std::integral_constant<int, 8>{}); return 0; }
      break;
    case 4: f(std::integral_constant<int, 4>{}); return 0;
    case 2: f(std::integral_constant<int, 2>{}); return 0;
    case 1: f(std::integral_constant<int, 1>{}); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fedml

using namespace fedml;

extern "C" int fedml_gn_fwd(const void* x, const void* gamma, const void* beta,
                            void* y, void* mean, void* rstd, int N, int S, int C,
                            int G, float eps, int dtype, int vec, void* stream) {
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto* mu = static_cast<float*>(mean);
  auto* rs = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kBFloat16)
    rc = dispatch_vec<__nv_bfloat16>(vec, [&](auto V) {
      launch_fwd<__nv_bfloat16, decltype(V)::value>(x, ga, be, y, mu, rs, N, S, C, G, eps, st);
    });
  else if (dtype == kFloat32)
    rc = dispatch_vec<float>(vec, [&](auto V) {
      launch_fwd<float, decltype(V)::value>(x, ga, be, y, mu, rs, N, S, C, G, eps, st);
    });
  else
    rc = (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}

extern "C" int fedml_gn_bwd(const void* x, const void* dy, const void* gamma,
                            const void* mean, const void* rstd, void* dx,
                            void* dgamma_part, void* dbeta_part, int N, int S,
                            int C, int G, int dtype, int vec, void* stream) {
  const auto* ga = static_cast<const float*>(gamma);
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  auto* pg = static_cast<float*>(dgamma_part);
  auto* pb = static_cast<float*>(dbeta_part);
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kBFloat16)
    rc = dispatch_vec<__nv_bfloat16>(vec, [&](auto V) {
      launch_bwd<__nv_bfloat16, decltype(V)::value>(x, dy, ga, mu, rs, dx, pg, pb, N, S, C, G, st);
    });
  else if (dtype == kFloat32)
    rc = dispatch_vec<float>(vec, [&](auto V) {
      launch_bwd<float, decltype(V)::value>(x, dy, ga, mu, rs, dx, pg, pb, N, S, C, G, st);
    });
  else
    rc = (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}
